"""The port's plain FastEGNN path (``edge_impl='plain'``: EdgeOps with the
scatter, cumsum and ELL lowerings) against the JAX package's, with the
parameters of a real flax init carried over by ``convert.params_from_jax``;
the plain entry points (serving as published, a two-epoch ``run``) on CPU.

Tolerances (f32, unit-cube scenes, H=32, L=2, C=3):
  forward    1e-5 absolute on real nodes' predicted coordinates and on the
             virtual coordinates (the same arithmetic in another summation
             order; the cumsum lowering's prefix differences round like the
             JAX package's own, at ~|prefix| * eps of a few thousand edges).
  gradients  1e-5 of the largest |jax grad| over the model, per entry.
  bf16       (compute_dtype bf16, or the packed stream in bf16) 2^-9
             absolute on coordinates and 2^-7 of the largest gradient
             (3.2e-4 and 2.6e-3 on the CPU): both round every message-MLP
             product and bias add to bf16, but XLA on the CPU keeps excess
             precision inside fused elementwise chains where PyTorch rounds
             each op, so single bf16 ulps (2^-8 relative) differ and compound
             through the layers.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distegnn_tpu.config import load_config as jax_load_config
from distegnn_tpu.models.fast_egnn import FastEGNN as JaxFastEGNN
from distegnn_tpu.models.registry import get_model as jax_get_model
from distegnn_tpu.ops import graph as jgraph
from distegnn_tpu.serve import engine_from_config as jax_engine_from_config
from distegnn_tpu_torch import config as pconfig
from distegnn_tpu_torch import main as pmain
from distegnn_tpu_torch.convert import params_from_jax
from distegnn_tpu_torch.data.loader import GraphDataset
from distegnn_tpu_torch.models.fast_egnn import FastEGNN
from distegnn_tpu_torch.models.registry import get_model
from distegnn_tpu_torch.ops import cumsum as pcumsum
from distegnn_tpu_torch.ops import graph as pgraph
from distegnn_tpu_torch.serve import engine_with_params_from_config
from test_torch_graph import plain_test_graph
from test_torch_serve import CONFIG as SERVE_CONFIG
from test_torch_serve import scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs", "largefluid_distegnn.yaml")
H, L, C = 32, 2, 3
ATOL = 1e-5
GRAD_TOL = 1e-5
BF16_ATOL, BF16_GRAD_TOL = 2 ** -9, 2 ** -7


def _graphs(node_attr_nf=0):
    return [plain_test_graph(21, n=120, radius=0.3, node_attr_nf=node_attr_nf),
            plain_test_graph(22, n=90, radius=0.3, node_attr_nf=node_attr_nf)]


def _models(kw, node_attr_nf=0, pair=True):
    graphs = _graphs(node_attr_nf)
    jb = jgraph.pad_graphs(graphs, compute_pair=pair)
    pb = pgraph.pad_graphs(graphs, compute_pair=pair)
    common = dict(node_feat_nf=2, node_attr_nf=node_attr_nf, edge_attr_nf=2,
                  hidden_nf=H, virtual_channels=C, n_layers=L, **kw)
    jm = JaxFastEGNN(**common)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(3), jb))
    pm = FastEGNN(**common)
    pm.load_state_dict(params_from_jax(params))
    return jm, jb, params, pm, pb


def _jax_loss(jm, jb):
    mask = jb.node_mask[..., None]

    def loss(p):
        x, X = jm.apply(p, jb)
        return jnp.sum((x - jb.target) ** 2 * mask) + 0.1 * jnp.sum(X ** 2)

    return loss


def _port_loss(pm, pb):
    x, X = pm(pb)
    return (torch.sum((x - pb.target) ** 2 * pb.node_mask[..., None])
            + 0.1 * torch.sum(X ** 2))


def _check(kw, node_attr_nf=0, atol=ATOL, grad_tol=GRAD_TOL):
    jm, jb, params, pm, pb = _models(kw, node_attr_nf)
    jx, jX = jax.jit(jm.apply)(params, jb)
    with torch.no_grad():
        px, pX = pm(pb)
    mask = np.asarray(jb.node_mask) > 0
    assert np.isfinite(px.numpy()).all() and np.isfinite(pX.numpy()).all()
    np.testing.assert_allclose(px.numpy()[mask], np.asarray(jx)[mask],
                               rtol=0, atol=atol)
    np.testing.assert_allclose(pX.numpy(), np.asarray(jX), rtol=0, atol=atol)
    np.testing.assert_array_equal(px.numpy()[~mask], 0.0)

    jl, jg = jax.jit(jax.value_and_grad(_jax_loss(jm, jb)))(params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    pm.zero_grad(set_to_none=True)
    pl = _port_loss(pm, pb)
    pl.backward()
    got = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in pm.named_parameters()}
    assert want.keys() == got.keys()
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
    scale = max(float(np.abs(g.numpy()).max()) for g in want.values())
    for k in want:
        err = float(np.abs(want[k].numpy() - got[k].numpy()).max())
        assert err <= grad_tol * scale, f"{k}: {err:.3e} > " \
            f"{grad_tol * scale:.3e}"
    return pm, pb


@pytest.mark.parametrize("seg_impl", ["scatter", "cumsum", "ell"])
@pytest.mark.parametrize("hoist", [True, False])
def test_plain_model_matches_jax_fwd_and_grad(seg_impl, hoist):
    _check(dict(segment_impl=seg_impl, hoist_edge_mlp=hoist))


@pytest.mark.parametrize("seg_impl", ["scatter", "cumsum", "ell"])
def test_plain_model_heads_match_jax(seg_impl):
    """normalize (the norm under stop_gradient), attention gates att /
    att_v, tanh coordinate heads, node attributes, and the unfused
    aggregations."""
    _check(dict(segment_impl=seg_impl, attention=True, normalize=True,
                tanh=True, fuse_agg=seg_impl != "cumsum",
                hoist_edge_mlp=seg_impl != "ell"), node_attr_nf=2)


def test_plain_model_with_a_bf16_stream_and_remat_matches_jax():
    """agg_dtype bf16 (the packed stream rounded to bf16 on both sides) and
    remat (recomputed layers give the same gradients)."""
    _check(dict(segment_impl="cumsum", agg_dtype="bf16", remat=True),
           atol=BF16_ATOL, grad_tol=BF16_GRAD_TOL)


@pytest.mark.parametrize("seg_impl", ["scatter", "cumsum"])
def test_bf16_plain_model_matches_jax(seg_impl):
    _check(dict(segment_impl=seg_impl, compute_dtype="bf16"),
           atol=BF16_ATOL, grad_tol=BF16_GRAD_TOL)


def test_plain_model_matches_jax_through_the_tpu_scan_kernel(monkeypatch):
    """The JAX model with its Pallas prefix scan forced on (interpret mode),
    against the port's plain version of that scan."""
    monkeypatch.setenv("DISTEGNN_PREFIX_IMPL", "pallas")
    _check(dict(segment_impl="cumsum"))


def test_cumsum_model_without_pairing_matches_jax():
    """No pairing on the batch (serving): the column gathers take the plain
    gather, whose backward is autograd's."""
    jm, jb, params, pm, pb = _models(dict(segment_impl="cumsum"), pair=False)
    assert pb.edge_pair is None
    jx, _ = jax.jit(jm.apply)(params, jb)
    with torch.no_grad():
        px, _ = pm(pb)
    mask = np.asarray(jb.node_mask) > 0
    np.testing.assert_allclose(px.numpy()[mask], np.asarray(jx)[mask],
                               rtol=0, atol=ATOL)


def test_plain_model_launches_no_kernel_on_cpu_and_defaults_to_plain():
    before = (pcumsum.prefix_sum.launches, pcumsum.prefix_sum.suffix_launches)
    pm, _ = _check(dict(segment_impl="cumsum", remat=True))
    assert pm.edge_impl == "plain"
    assert FastEGNN(node_feat_nf=2).edge_impl == "plain"
    assert (pcumsum.prefix_sum.launches,
            pcumsum.prefix_sum.suffix_launches) == before


@pytest.mark.parametrize("hoist", [True, False])
def test_converted_plain_tree_covers_every_parameter(hoist):
    """The flax names of every plain variant (read off a real init) map onto
    the port's state_dict one to one, shapes included."""
    kw = dict(hoist_edge_mlp=hoist, attention=True, tanh=True)
    jm, jb, params, pm, _ = _models(kw)
    sd = params_from_jax(params)
    own = pm.state_dict()
    assert sd.keys() == own.keys()
    for k in own:
        assert sd[k].shape == own[k].shape, k
    g0 = params["params"]["gcl_0"]
    if hoist:
        np.testing.assert_array_equal(sd["gcl.0.phi_e.kernel"].numpy(),
                                      g0["phi_e"]["kernel"])
    else:
        np.testing.assert_array_equal(
            sd["gcl.0.phi_e.layers.1.weight"].numpy(),
            g0["phi_e"]["TorchDense_1"]["Dense_0"]["kernel"].T)


# ------------------------------------------------------- config, registry

def test_config_defaults_and_registry_follow_jax():
    jcfg = jax_load_config(FLAGSHIP)
    pcfg = pconfig.load_config(FLAGSHIP)
    for k in ("segment_impl", "fuse_agg", "agg_dtype", "hoist_edge_mlp",
              "blocked_impl", "edge_impl", "normalize"):
        assert pcfg.model[k] == jcfg.model[k], k
    cfg = pconfig.load_config(FLAGSHIP, {"model.segment_impl": "cumsum",
                                         "model.normalize": True,
                                         "model.fuse_agg": False,
                                         "model.agg_dtype": "bf16",
                                         "model.hoist_edge_mlp": False})
    m = get_model(cfg.model)
    layer = m.gcl[0]
    assert (m.edge_impl, layer.seg_impl, layer.fuse_agg, layer.agg_dtype,
            layer.hoist_edge_mlp, layer.normalize, m.remat) == (
        "plain", "cumsum", False, "bf16", False, True, True)
    with pytest.raises(ValueError, match="normalize"):
        pconfig.load_config(FLAGSHIP, {"model.edge_impl": "fused",
                                       "data.edge_block": 512,
                                       "model.normalize": True})


# ---------------------------------------------------------------- serving

@pytest.mark.parametrize("seg_impl", [None, "cumsum"])
def test_serving_the_published_config_matches_jax(seg_impl):
    """configs/nbody_serve.yaml as published (edge_impl plain, segment_impl
    scatter), then with segment_impl cumsum: serve batches carry no
    pairing, so the cumsum forward runs the scan and the column gathers are
    plain."""
    jcfg = jax_load_config(SERVE_CONFIG)
    ov = {"model.segment_impl": seg_impl} if seg_impl else {}
    for k, v in ov.items():
        jcfg.model[k.split(".")[1]] = v
    jmodel = jax_get_model(jcfg.model, dataset_name=jcfg.data.dataset_name)
    graphs = [scene(700, 1), scene(1100, 2)]
    jeng, _ = jax_engine_from_config(jcfg, jmodel, params=None)
    batch, _ = jeng.ladder.pad_batch(graphs[:1], jeng.ladder.bucket_of_graph(
        graphs[0]), 1, **jeng._layout_opts)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(4), batch))
    jeng.params = params
    want = jeng.predict_batch(graphs)

    cfg = pconfig.load_config(SERVE_CONFIG, ov)
    assert cfg.model.edge_impl == "plain"
    model, eng = engine_with_params_from_config(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    got = eng.predict_batch(graphs)
    for g, a, b in zip(graphs, want, got):
        assert b.shape == (g["loc"].shape[0], 3) and np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)


# ---------------------------------------------------------------- trainer

def test_run_two_epochs_on_the_plain_layout_on_cpu(tmp_path):
    """main.run on the flagship config with edge_block 0 and the cumsum
    lowering: the loader attaches the pairing and the ELL degree, losses
    stay finite, the parameters move, and the CPU runs no kernel."""
    cfg = pconfig.load_config(FLAGSHIP, {
        "data.accelerate_mode": "cutoff_edges",
        "model.segment_impl": "cumsum", "model.hidden_nf": 16,
        "model.n_layers": 2, "train.epochs": 2, "log.test_interval": 1,
        "log.log_dir": str(tmp_path)})
    assert cfg.data.edge_block == 0
    ds = [GraphDataset([plain_test_graph(s, n=150, radius=0.25,
                                         node_feat_nf=3, node_attr_nf=2)
                        for s in range(k, k + n)], node_order="morton")
          for k, n in ((30, 4), (40, 1), (50, 1))]
    loaders = pmain.make_loaders(cfg, *ds)
    assert all(lo.pairing and lo.max_in_degree for lo in loaders)
    batch = next(iter(loaders[0]))
    assert batch.edge_pair is not None and batch.edges_sorted
    init = {k: v.clone() for k, v in get_model(
        cfg.model, generator=torch.Generator().manual_seed(
            int(cfg.seed))).state_dict().items()}
    before = (pcumsum.prefix_sum.launches, pcumsum.prefix_sum.suffix_launches)
    losses = []
    state, best, log = pmain.run(
        cfg, *ds, device="cpu",
        on_step=lambda e, s, m: losses.append(float(m["loss"])))
    assert (pcumsum.prefix_sum.launches,
            pcumsum.prefix_sum.suffix_launches) == before
    assert len(losses) == 8 and all(np.isfinite(v) for v in losses)
    assert state.optimizer.updates == 2
    assert np.isfinite(best["loss_valid"])
    moved = max(float((p.detach() - init[k]).abs().max())
                for k, p in state.model.state_dict().items())
    assert moved > 0


def test_main_cli_trains_the_published_nbody_config_on_cpu(tmp_path):
    """configs/nbody_fastegnn.yaml as published (edge_impl plain, normalize
    true, scatter), only its data location, size and width cut, through
    ``python -m distegnn_tpu_torch.main``."""
    import yaml

    from test_torch_train import _write_nbody

    data_dir = tmp_path / "data"
    _write_nbody(str(data_dir / "nbody_t"), samples=(4, 2, 2))
    with open(os.path.join(REPO, "configs", "nbody_fastegnn.yaml")) as f:
        raw = yaml.safe_load(f)
    assert raw["model"]["normalize"] and "edge_impl" not in raw["model"]
    raw["model"].update(hidden_nf=16, n_layers=2)
    raw["data"].update(data_dir=str(data_dir), dataset_name="nbody_t",
                       max_samples=10, frame_0=2, frame_T=8, batch_size=2)
    raw["log"].update(log_dir=str(tmp_path / "logs"), test_interval=1)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    best = pmain.main(["--config_path", str(cfg_path), "--epochs", "2",
                       "--device", "cpu"])
    assert np.isfinite(best["loss_valid"])
