"""The model families through the port's entry points, on the CPU: the
factory against the JAX package's, the dataset's SchNet cutoff through
``main.run`` and serving, one optimizer update against JAX's
``make_train_step``, a short training run of every family the factory
serves, serving the virtual-node families, FastSchNet over two gloo ranks
against the union graph, and a FastRF run continued from a JAX checkpoint.

Tolerances (f32): the updated parameters 1e-5 of the largest |parameter|
after one update (Adam's first step is lr * g / (|g| + eps) per entry:
gradients held at 1e-5 of scale agree in sign); the losses 1e-5 relative;
the two-rank forward 1e-6 and gradients 1e-5 of scale (the union
invariant's bounds in tests/test_torch_distributed.py); serving
equivariance 1e-4.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from distegnn_tpu.config import ConfigDict as JaxConfigDict
from distegnn_tpu.models.registry import get_model as jax_get_model
from distegnn_tpu.train import TrainState as JaxTrainState
from distegnn_tpu.train import make_optimizer as jax_make_optimizer
from distegnn_tpu.train import step as jstep
from distegnn_tpu.train.checkpoint import save_checkpoint as jax_save
from distegnn_tpu_torch import main as pmain
from distegnn_tpu_torch.config import load_config
from distegnn_tpu_torch.convert import checkpoint_from_jax, params_from_jax
from distegnn_tpu_torch.data.loader import GraphDataset
from distegnn_tpu_torch.data.nbody import build_nbody_graph
from distegnn_tpu_torch.models.registry import get_model
from distegnn_tpu_torch.ops import graph as pgraph
from distegnn_tpu_torch.serve import engine_with_params_from_config
from distegnn_tpu_torch.train.step import (TrainState, make_optimizer,
                                           make_train_step)
from test_torch_serve import CONFIG as SERVE_CONFIG
from test_torch_serve import scene
from torch_model_pair import (flax_tree, rotation, tree_matches_flax_init,
                              twin_graphs, unpadded)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NBODY = os.path.join(REPO, "configs", "nbody_fastegnn.yaml")
SERVED = ("FastEGNN", "FastRF", "FastSchNet", "SchNet", "EGNN", "RF", "TFN",
          "SE3Transformer", "FastTFN", "Linear")
CUTOFFS = {"nbody_100": 1.0, "protein": 10.0, "Water-3D": 0.035}
SMALL = {"model.hidden_nf": 16, "model.n_layers": 2}


def _cfg(name, **over):
    return load_config(NBODY, {"model.model_name": name, **SMALL, **over})


def _jax_model_cfg(cfg):
    return JaxConfigDict(dict(cfg.model))


# ---------------------------------------------------------------- factory

@pytest.mark.parametrize("name", SERVED)
def test_registry_builds_every_family_of_the_jax_factory(name):
    """Each name builds the JAX factory's model: the same flax parameter
    paths and shapes (TFN and SE3Transformer at nf = hidden_nf // 2,
    num_degrees 2; SchNet's cutoff by dataset)."""
    cfg = _cfg(name)
    pm = get_model(cfg.model, dataset_name="nbody_100")
    jm = jax_get_model(_jax_model_cfg(cfg), dataset_name="nbody_100")
    jb, _ = unpadded(twin_graphs())
    tree_matches_flax_init(jm, jb, pm)


def test_unknown_names_and_datasets_raise_as_in_jax():
    for getter, mc in ((get_model, _cfg("FastRF").model),
                       (jax_get_model, _jax_model_cfg(_cfg("FastRF")))):
        mc.model_name = "NoSuchNet"
        with pytest.raises(NotImplementedError, match="NoSuchNet"):
            getter(mc, dataset_name="nbody_100")
        for name in ("SchNet", "FastSchNet"):
            mc.model_name = name
            with pytest.raises(ValueError, match="no SchNet cutoff"):
                getter(mc, dataset_name="LargeFluid")


def _cutoff(model):
    return float(model.smearing.offset[-1]) if hasattr(
        model, "smearing") else float(model.gcl[0].smearing.offset[-1])


@pytest.mark.parametrize("entry", ["main.run", "serve"])
@pytest.mark.parametrize("dataset", sorted(CUTOFFS))
@pytest.mark.parametrize("name", ["SchNet", "FastSchNet"])
def test_schnet_cutoff_follows_the_dataset_at_both_entry_points(
        name, dataset, entry, monkeypatch):
    """``main.run`` and ``serve.engine_with_params_from_config`` pass the
    config's dataset to the factory, as JAX's main.py and serve do: the
    SchNet cutoff (the last Gaussian's centre) is JAX's for the dataset."""
    cfg = _cfg(name, **{"data.dataset_name": dataset, "data.batch_size": 1})
    want = jax_get_model(_jax_model_cfg(cfg), dataset_name=dataset).cutoff
    assert want == CUTOFFS[dataset]
    if entry == "serve":
        model, _ = engine_with_params_from_config(cfg, device="cpu")
    else:
        built = []

        def capture(config, model, loaders, dev, **kw):
            built.append(model)
            return None, None, {}, {}

        monkeypatch.setattr(pmain, "train_model", capture)
        ds = GraphDataset([_nbody_graph(0)])
        with tempfile.TemporaryDirectory() as d:
            cfg.log.log_dir = d
            pmain.run(cfg, ds, ds, ds, device="cpu")
        (model,) = built
    assert _cutoff(model) == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------- one update vs JAX

def _nbody_graph(seed, n=12):
    rng = np.random.default_rng(seed)
    loc = rng.normal(size=(n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    q = rng.choice([-1.0, 1.0], size=(n, 1)).astype(np.float32)
    return build_nbody_graph(loc, vel, q, loc + vel + 0.01 * rng.normal(
        size=(n, 3)).astype(np.float32), radius=-1)


@pytest.mark.parametrize("name, mmd", [("FastSchNet", 0.03), ("EGNN", 0.0)])
def test_first_update_matches_jax_train_step(name, mmd):
    """One update (clip 0.3, weight decay, Adam) from the same weights: the
    losses and the updated parameters. FastSchNet with MMD (its
    deterministic branch: samples * C >= N), EGNN without (no virtual
    nodes: the trainer gives MMD to the Fast* families only)."""
    # one layer: its feature heads reach no loss term (no gradient in the
    # port, a zero one in optax), the case the optimizer must step as optax
    cfg = _cfg(name, **{"model.n_layers": 1})
    graphs = [_nbody_graph(1), _nbody_graph(2)]
    jb, pb = unpadded(graphs)
    pm = get_model(cfg.model, dataset_name="nbody_100",
                   generator=torch.Generator().manual_seed(2))
    jm = jax_get_model(_jax_model_cfg(cfg), dataset_name="nbody_100")
    params = flax_tree(pm)
    hyper = dict(weight_decay=1e-4, clip_norm=0.3)
    mmd_args = (mmd, 1.5, 10)
    tx = jax_make_optimizer(1e-3, **hyper)
    jstate, jm_ = jax.jit(jstep.make_train_step(jm, tx, *mmd_args))(
        JaxTrainState.create(params, tx), jb, jax.random.PRNGKey(0))
    opt = make_optimizer(pm.parameters(), 1e-3, **hyper)
    state, m = make_train_step(pm, opt, *mmd_args)(TrainState(pm, opt), pb)
    for k in ("loss", "loss_with_mmd"):
        assert float(m[k]) == pytest.approx(float(jm_[k]), rel=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), pm)
    scale = max(float(v.abs().max()) for v in want.values())
    err = max(float((p.detach() - want[n]).abs().max())
              for n, p in pm.named_parameters())
    assert err <= 1e-5 * scale, f"{err:.3e} > {1e-5 * scale:.3e}"


# ----------------------------------------------------- training and serving

TRAIN_CASES = [(n, {}) for n in SERVED if n != "FastEGNN"] + [
    ("FastRF", {"model.segment_impl": "cumsum"}),
    ("FastSchNet", {"model.segment_impl": "cumsum"}),
    ("FastRF", {"data.edge_block": 16, "model.blocked_impl": "pallas"}),
    ("FastSchNet", {"data.edge_block": 16, "model.blocked_impl": "pallas"}),
]


@pytest.mark.parametrize("name, over", TRAIN_CASES,
                         ids=[f"{n}-{'-'.join(str(v) for v in o.values())}"
                              if o else n for n, o in TRAIN_CASES])
def test_every_served_family_trains_through_main_run(name, over, tmp_path):
    """One epoch of 2 micro-steps on n-body graphs: finite losses, the
    parameters moved (the Linear baseline's one parameter included), the
    eval losses finite."""
    cfg = _cfg(name, **{"data.batch_size": 2, "train.epochs": 1,
                        "log.test_interval": 1,
                        "log.log_dir": str(tmp_path)}, **over)
    ds = [GraphDataset([_nbody_graph(s) for s in range(k, k + n)])
          for k, n in ((0, 4), (10, 2), (20, 2))]
    init = get_model(cfg.model, dataset_name="nbody_100",
                     generator=torch.Generator().manual_seed(
                         int(cfg.seed))).state_dict()
    losses = []
    state, best, log = pmain.run(
        cfg, *ds, device="cpu",
        on_step=lambda e, s, m: losses.append(float(m["loss_with_mmd"])))
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert np.isfinite(best["loss_valid"]) and np.isfinite(best["loss_test"])
    moved = max(float((p - init[k]).abs().max())
                for k, p in state.model.state_dict().items())
    assert moved > 0


@pytest.mark.parametrize("name", ["FastRF", "FastSchNet", "FastTFN"])
def test_fast_families_serve_a_finite_equivariant_predict(name):
    cfg = load_config(SERVE_CONFIG, {"model.model_name": name, **SMALL})
    _, eng = engine_with_params_from_config(cfg, device="cpu")
    g = scene(90, 3, radius=0.3)
    R, t = rotation(11)
    gr = dict(g, loc=(g["loc"] @ R + t).astype(np.float32),
              vel=(g["vel"] @ R).astype(np.float32))
    out, out_r = eng.predict(g), eng.predict(gr)
    assert out.shape == (90, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(out @ R + t, out_r, rtol=0, atol=1e-4)


# ------------------------------------------------ two ranks, the union graph

def _parts_sharing_the_mean(seed, sizes=(30, 25), radius=0.6):
    """Two parts of one graph, each moved so its coordinate mean is the
    union's: FastSchNet keeps the reference's LOCAL coordinate mean in the
    virtual Gram, so parts and union agree on a layer's input only then
    (one layer: the layer's output moves the parts' means apart)."""
    from distegnn_tpu_torch.ops.radius import radius_graph_np

    rng = np.random.default_rng(seed)
    c = rng.normal(size=3).astype(np.float32)
    parts = []
    for n in sizes:
        loc = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
        loc = (loc - loc.mean(axis=0) + c).astype(np.float32)
        ei = radius_graph_np(loc, radius)
        d = np.linalg.norm(loc[ei[0]] - loc[ei[1]], axis=1)
        vel = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
        parts.append({
            "node_feat": rng.normal(size=(n, 2)).astype(np.float32),
            "node_attr": None, "loc": loc, "vel": vel, "target": loc + vel,
            "loc_mean": c, "edge_index": ei.astype(np.int32),
            "edge_attr": np.repeat(d[:, None], 2, 1).astype(np.float32)})
    return parts


def test_fast_schnet_two_gloo_ranks_match_the_union_graph(tmp_path):
    """FastSchNet under the graph axis (2 gloo ranks, spawned): each rank
    holds one part and the virtual means run over both; the forward, the
    MSE loss and the gradient summed over the ranks equal one process's on
    the union graph."""
    import torch_dist_worker as W
    from test_torch_distributed import _union

    parts = _parts_sharing_the_mean(0)
    kw = dict(node_feat_nf=2, edge_attr_nf=2, hidden_nf=16,
              virtual_channels=2, n_layers=1, cutoff=1.0)
    ref = W.FastSchNet(**kw, generator=torch.Generator().manual_seed(4))
    sd = {k: v.numpy() for k, v in ref.state_dict().items()}
    job = {"kind": "grad", "family": "FastSchNet", "model": kw,
           "state_dict": sd, "shards": [[p] for p in parts],
           "batch_size": 1, "seed": 0, "loader": {}}
    ctx = W.start({"union": job}, 2, str(tmp_path))
    batch = pgraph.pad_graphs([_union(parts)])
    with torch.no_grad():
        x, X = ref(batch)
    loss, _ = W.make_loss_fn(ref, 0.0, 1.5, 3)(batch)
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in ref.named_parameters()
             if p.grad is not None}
    ranks = W.collect(ctx, 2, str(tmp_path))
    off = [0, parts[0]["loc"].shape[0], batch.node_mask.sum().int().item()]
    scale = float(x.abs().max())
    for r, res in enumerate(ranks):
        got = res["union"]
        n = off[r + 1] - off[r]
        assert np.abs(got["x"][0, :n] - x[0, off[r]:off[r + 1]].numpy()
                      ).max() <= 1e-6 * scale
        assert np.abs(got["X"] - X.numpy()).max() <= 1e-6 * float(
            X.abs().max())
        assert got["loss"] == pytest.approx(float(loss.detach()), rel=1e-5)
        gscale = max(float(np.abs(g).max()) for g in grads.values())
        for k, g in grads.items():
            assert np.abs(got["grads"][k] - g).max() <= 1e-5 * gscale, k


# ------------------------------------------------- a JAX checkpoint, resumed

def test_fast_rf_continues_a_jax_checkpoint(tmp_path):
    """The JAX step trains FastRF for 3 micro-steps (an update every 2),
    its checkpoint is taken mid-accumulation, and both packages run the
    last micro-step from it: the parameters, Adam's moments and the
    accumulated gradient load, and the next update agrees."""
    cfg = _cfg("FastRF", **{"model.n_layers": 1})
    graphs = [_nbody_graph(s) for s in range(4)]
    jbatches = [unpadded([g])[0] for g in graphs]
    pbatches = [unpadded([g])[1] for g in graphs]
    pm = get_model(cfg.model, generator=torch.Generator().manual_seed(6))
    jm = jax_get_model(_jax_model_cfg(cfg))
    hyper = dict(weight_decay=1e-2, clip_norm=0.3, accumulation_steps=2)
    mmd = (0.03, 1.5, 10)
    tx = jax_make_optimizer(1e-3, **hyper)
    jstate = JaxTrainState.create(flax_tree(pm), tx)
    step_fn = jax.jit(jstep.make_train_step(jm, tx, *mmd))
    key = jax.random.PRNGKey(0)
    for b in jbatches[:3]:
        jstate, _ = step_fn(jstate, b, key)
    path = str(tmp_path / "state_dict" / "step_0000000003.ckpt")
    jax_save(path, jstate, 1, seed=7, step_in_epoch=1)
    saved = jax.tree.map(np.asarray, jstate)
    jstate, _ = step_fn(jstate, jbatches[3], key)

    opt = make_optimizer(pm.parameters(), 1e-3, **hyper)
    state = TrainState(pm, opt)
    rr = checkpoint_from_jax(path, state)
    assert (rr.epoch, rr.step_in_epoch, rr.seed) == (1, 1, 7)
    assert (opt.micro, opt.updates, state.step) == (1, 1, 3)
    want_p = params_from_jax(saved.params, pm)
    for name, p in pm.named_parameters():
        assert torch.equal(p.detach(), want_p[name]), name
    adam = [s for s in jax.tree.leaves(
        saved.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu")][0]
    mu = params_from_jax(adam.mu, pm)
    for name, p in pm.named_parameters():
        assert torch.equal(opt.adam.state[p]["exp_avg"], mu[name]), name
    make_train_step(pm, opt, *mmd)(state, pbatches[3])
    assert opt.updates == 2 and opt.micro == 0
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), pm)
    scale = max(float(v.abs().max()) for v in want.values())
    err = max(float((p.detach() - want[n]).abs().max())
              for n, p in pm.named_parameters())
    assert err <= 1e-5 * scale, f"{err:.3e} > {1e-5 * scale:.3e}"
