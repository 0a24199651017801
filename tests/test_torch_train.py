"""The port's training path against the JAX package's, on the CPU.

Losses, the optimizer, FastEGNN gradients, the loader, the data builders
and the blocking scans are held against their JAX counterparts on the same
inputs (made with numpy from a seed); the trainer, its checkpoints and the
command-line entry point run end to end at a small size.

Tolerances:
  losses        1e-6 relative (the same f32 formulas; summation order only)
  optimizer     1e-6 absolute on the parameters after every micro-step
                (clip + weight decay + Adam + MultiSteps vs optax)
  gradients     1e-5 * scale, scale = the largest |jax grad| over the model,
                and 1e-4 of each tensor's own max |jax grad| (f32 model: the
                same roundings in the fused layer; the summation order of
                sums and products differs, and the per-edge bf16 payload of
                the backward can flip by one bf16 ulp with it)
  loader, data  bitwise (numpy copies of the same host code)
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from distegnn_tpu.data import fluid113k as jfluid
from distegnn_tpu.data import nbody as jnbody
from distegnn_tpu.data.loader import GraphDataset as JaxGraphDataset
from distegnn_tpu.data.loader import GraphLoader as JaxGraphLoader
from distegnn_tpu.models.fast_egnn import FastEGNN as JaxFastEGNN
from distegnn_tpu.ops import blocked as jblocked
from distegnn_tpu.ops import edge_pipeline as jep
from distegnn_tpu.ops import radius as jradius
from distegnn_tpu.ops.graph import pad_graphs as jax_pad_graphs
from distegnn_tpu.train import loss as jloss
from distegnn_tpu.train import step as jstep
from distegnn_tpu_torch import main as pmain
from distegnn_tpu_torch.config import load_config
from distegnn_tpu_torch.convert import params_from_jax
from distegnn_tpu_torch.data import fluid113k as pfluid
from distegnn_tpu_torch.data import nbody as pnbody
from distegnn_tpu_torch.data.loader import GraphDataset, GraphLoader
from distegnn_tpu_torch.models.fast_egnn import FastEGNN
from distegnn_tpu_torch.ops import blocked as pblocked
from distegnn_tpu_torch.ops import edge_pipeline as pep
from distegnn_tpu_torch.ops.graph import pad_graphs
from distegnn_tpu_torch.train import loss as ploss
from distegnn_tpu_torch.train.checkpoint import (CheckpointCorruptError,
                                                 restore_checkpoint,
                                                 save_checkpoint)
from distegnn_tpu_torch.train.step import (TrainState, make_loss_fn,
                                           make_optimizer, step_generator)
from test_torch_fast_egnn import numpy_params
from torch_dist_worker import one_rank_group
from test_torch_graph import (BLOCK, assert_batches_equal, blocked_test_graph,
                              plain_test_graph)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs", "largefluid_distegnn.yaml")


def train_graph(seed, n_real=4 * BLOCK, node_feat_nf=3):
    """blocked_test_graph plus the 2 node attributes of the fluid model."""
    g = blocked_test_graph(seed, n_real=n_real, node_feat_nf=node_feat_nf)
    rng = np.random.default_rng(seed + 1000)
    g["node_attr"] = rng.normal(size=(n_real, 2)).astype(np.float32)
    return g


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ---------------------------------------------------------------- losses

def _loss_inputs(seed, B=2, N=40, C=3, n_real=(31, 17)):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(B, N, 3)).astype(np.float32)
    target = rng.normal(size=(B, N, 3)).astype(np.float32)
    vloc = rng.normal(size=(B, 3, C)).astype(np.float32)
    mask = np.zeros((B, N), np.float32)
    for b, n in enumerate(n_real):
        mask[b, :n] = 1.0
    return pred, target, vloc, mask


def test_masked_mse_rbf_and_weighted_losses_match_jax(tmp_path):
    pred, target, vloc, mask = _loss_inputs(0)
    t = [torch.from_numpy(a) for a in (pred, target, vloc, mask)]
    a = jloss.masked_mse(pred, target, mask)
    b = ploss.masked_mse(t[0], t[1], t[3])
    assert _rel(b, a) <= 1e-6
    assert _rel(ploss.weighted_local_loss(b, t[3]),
                jloss.weighted_local_loss(a, mask)) <= 1e-6
    assert _rel(ploss.weighted_global_loss(b, t[3]),
                jloss.weighted_global_loss(a, mask)) <= 1e-6
    x, y = target[0], pred[1]
    assert _rel(ploss.rbf_kernel_sum(t[1][0], t[0][1], 1.5, wx=t[3][0]),
                jloss.rbf_kernel_sum(x, y, 1.5, wx=mask[0])) <= 1e-6
    # over a graph axis: a rank of one weights its share by a node count
    # summed over the axis, its own; without a group the axis is refused
    with pytest.raises(RuntimeError, match="init_graph_group"):
        ploss.weighted_local_loss(b, t[3], axis_name="graph")
    with one_rank_group(tmp_path):
        for fn, jfn in ((ploss.weighted_local_loss, jloss.weighted_local_loss),
                        (ploss.weighted_global_loss,
                         jloss.weighted_global_loss)):
            assert _rel(fn(b, t[3], axis_name="graph"), jfn(a, mask)) <= 1e-6


@pytest.mark.parametrize("branch", ["deterministic", "sampling"])
def test_mmd_matches_jax(branch):
    """Deterministic branch (N <= samples * C: every real node once), and
    the sampling branch fed the indices JAX drew from its key."""
    pred, target, vloc, mask = _loss_inputs(1)
    N, C, sigma = target.shape[1], vloc.shape[2], 1.5
    samples = 20 if branch == "deterministic" else 4
    key = jax.random.PRNGKey(7)
    want = jloss.mmd_loss(vloc, target, mask, key, sigma, samples)
    idx = None
    if branch == "sampling":
        assert N > samples * C
        keys = jax.random.split(key, target.shape[0])
        n = mask.sum(axis=1)
        idx = np.stack([
            np.minimum((np.asarray(jax.random.uniform(k, (samples * C,)))
                        * n[b]).astype(np.int32), N - 1)
            for b, k in enumerate(keys)])
        idx = torch.from_numpy(idx)
    got = ploss.mmd_loss(torch.from_numpy(vloc), torch.from_numpy(target),
                         torch.from_numpy(mask), sigma, samples, idx=idx)
    assert _rel(got, want) <= 1e-6


def test_mmd_sampling_draws_from_the_generator():
    _, target, vloc, mask = _loss_inputs(2)
    t = [torch.from_numpy(a) for a in (vloc, target, mask)]

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return float(ploss.mmd_loss(*t, 1.5, 4, generator=g))

    assert draw(3) == draw(3)
    assert draw(3) != draw(4)


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize("clip, wd, k, sched", [
    (None, 0.0, 1, "None"),
    (0.3, 1e-2, 4, "None"),
    (0.3, 1e-2, 4, "cosine"),
])
def test_optimizer_matches_optax(clip, wd, k, sched):
    """Identical gradient sequences through the port's optimizer and the
    JAX package's optax chain: parameters agree after every micro-step."""
    rng = np.random.default_rng(5)
    shapes = [(4, 3), (3,), (2, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    n_micro = 4 * k
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(n_micro)]
    total = n_micro // k
    tx = jstep.make_optimizer(1e-2, weight_decay=wd, clip_norm=clip,
                              accumulation_steps=k, total_steps=total,
                              scheduler=sched)
    jp = [jnp.asarray(p) for p in params]
    ostate = tx.init(jp)
    pp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_optimizer(pp, 1e-2, weight_decay=wd, clip_norm=clip,
                         accumulation_steps=k, total_steps=total,
                         scheduler=sched)
    update = jax.jit(tx.update)
    for i, gs in enumerate(grads):
        upd, ostate = update([jnp.asarray(g) for g in gs], ostate, jp)
        jp = optax.apply_updates(jp, upd)
        # the port back-propagates loss / k into .grad
        for p, g in zip(pp, gs):
            gk = torch.from_numpy(g) / k
            p.grad = gk if p.grad is None else p.grad + gk
        updated = opt.micro_step()
        assert updated == ((i + 1) % k == 0)
        for a, b in zip(jp, pp):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       rtol=0, atol=1e-6)
    assert opt.updates == total
    if clip is not None:
        # the gradients are large enough that every update was clipped
        assert float(opt.last_grad_norm) > clip


# ---------------------------------------------------------------- model

H_SMALL, L_SMALL, C_SMALL = 16, 2, 3


def _small_models(graphs, remat=False):
    jb = jax_pad_graphs(graphs, edge_block=BLOCK, compute_pair=False,
                        split_remote=True)
    jm = JaxFastEGNN(node_feat_nf=3, node_attr_nf=2, edge_attr_nf=2,
                     hidden_nf=H_SMALL, virtual_channels=C_SMALL,
                     n_layers=L_SMALL, edge_impl="fused")
    params = numpy_params(jm, jb, 3)
    pm = FastEGNN(node_feat_nf=3, node_attr_nf=2, edge_attr_nf=2,
                  hidden_nf=H_SMALL, virtual_channels=C_SMALL,
                  n_layers=L_SMALL, remat=remat, edge_impl="fused")
    pm.load_state_dict(params_from_jax(params))
    pb = pad_graphs(graphs, edge_block=BLOCK, split_remote=True)
    return jm, jb, params, pm, pb


def _port_grads(pm, pb, mmd_w, sigma, samples):
    pm.zero_grad(set_to_none=True)
    loss, logged = make_loss_fn(pm, mmd_w, sigma, samples)(pb)
    loss.backward()
    # the last layer's h and Hv updates do not reach the loss: no gradient
    return float(loss.detach()), {k: torch.zeros_like(p) if p.grad is None
                         else p.grad.clone()
                         for k, p in pm.named_parameters()}


def test_model_gradients_match_jax_grad():
    """f32 FastEGNN (H=16, L=2, C=3, node_attr_nf=2) with a remote tail:
    loss (MSE + MMD, deterministic MMD branch) and every parameter's
    gradient against jax.grad of the JAX package's loss."""
    graphs = [train_graph(0)]
    jm, jb, params, pm, pb = _small_models(graphs)
    assert float(pb.remote_edge_mask.sum()) > 0
    N = pb.max_nodes
    samples = -(-N // C_SMALL)            # samples * C >= N: no draw
    mmd_w, sigma = 0.03, 1.5
    loss_fn = jstep.make_loss_fn(jm, mmd_w, sigma, samples)
    (jl, _), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jb, jax.random.PRNGKey(0))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    pl, got = _port_grads(pm, pb, mmd_w, sigma, samples)
    assert _rel(pl, jl) <= 1e-6
    assert want.keys() == got.keys()
    scale = max(float(np.abs(g.numpy()).max()) for g in want.values())
    for k in want:
        a, b = want[k].numpy(), got[k].numpy()
        err = float(np.abs(a - b).max())
        assert err <= 1e-5 * scale, f"{k}: {err:.3e} > {1e-5 * scale:.3e}"
        # tensors whose gradient is 1e-10 of the largest are cancellation
        # noise in both: held to their own scale at 1e-4
        own = float(np.abs(a).max())
        assert err <= 1e-4 * own, f"{k}: {err:.3e} > {1e-4 * own:.3e}"
    # all but the last layer's h/Hv heads are trained
    assert sum(float(np.abs(g.numpy()).max()) > 0 for g in want.values()) \
        >= len(want) - 2 * 2 * 2


def test_remat_gives_the_same_gradients():
    graphs = [train_graph(1)]
    *_, pm, pb = _small_models(graphs)
    _, off = _port_grads(pm, pb, 0.03, 1.5, 1000)
    pm.remat = True
    _, on = _port_grads(pm, pb, 0.03, 1.5, 1000)
    for k in off:
        torch.testing.assert_close(on[k], off[k], rtol=0, atol=0)


def test_params_from_jax_loads_a_flagship_width_flax_init():
    """A real flax init of the flagship tree (configs/largefluid_distegnn
    .yaml: H=64, L=4, C=3, node_feat_nf 3, node_attr_nf 2 widening phi_h)
    converts into the port's model built from the same config."""
    cfg = load_config(FLAGSHIP, {"model.edge_impl": "fused",
                                 "data.edge_block": BLOCK})
    m = cfg.model
    jm = JaxFastEGNN(node_feat_nf=m.node_feat_nf, node_attr_nf=m.node_attr_nf,
                     edge_attr_nf=m.edge_attr_nf, hidden_nf=m.hidden_nf,
                     virtual_channels=m.virtual_channels, n_layers=m.n_layers,
                     edge_impl="fused", remat=True)
    jb = jax_pad_graphs([train_graph(2, n_real=3 * BLOCK)], edge_block=BLOCK,
                        compute_pair=False, split_remote=True)
    flax_params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jb))
    sd = params_from_jax(flax_params)
    from distegnn_tpu_torch.models.registry import get_model
    pm = get_model(cfg.model)
    assert pm.remat
    own = pm.state_dict()
    assert sd.keys() == own.keys()
    for k in own:
        assert sd[k].shape == own[k].shape, k
    H = m.hidden_nf
    assert sd["gcl.0.phi_h.layers.0.weight"].shape == (H, 3 * H + 2)
    pm.load_state_dict(sd)
    np.testing.assert_array_equal(
        pm.gcl[3].phi_e_fused.w2.detach().numpy(),
        flax_params["params"]["gcl_3"]["phi_e_fused"]["w2"])


# ---------------------------------------------------------------- data

def _datasets(node_order):
    graphs = [train_graph(s, n_real=(3 + s % 2) * BLOCK) for s in range(5)]
    return (JaxGraphDataset(graphs, node_order=node_order),
            GraphDataset(graphs, node_order=node_order))


@pytest.mark.parametrize("node_order", ["none", "morton"])
def test_graph_loader_batches_are_bitwise_the_jax_loaders(node_order):
    jd, pd = _datasets(node_order)
    kw = dict(batch_size=2, shuffle=True, seed=43, edge_block=BLOCK,
              split_remote=True)
    jl, pl = JaxGraphLoader(jd, **kw), GraphLoader(pd, **kw)
    assert (pl.max_nodes, pl.edges_per_block, pl.remote_pad) == (
        jl.max_nodes, jl.edges_per_block, jl.remote_pad)
    assert len(pl) == len(jl) == 2
    for epoch in (1, 2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        for jb, pb in zip(jl, pl):
            assert_batches_equal(jb, pb)


def test_graph_loader_plain_layout_names_slice_3():
    """The plain layout (port slice 3) batches bitwise as the JAX loader's
    plain layout, with the reverse-edge pairing and the ELL degree."""
    graphs = [plain_test_graph(s, n=200 + 40 * s, node_feat_nf=3,
                               node_attr_nf=2) for s in range(5)]
    jd = JaxGraphDataset(graphs, node_order="morton")
    pd = GraphDataset(graphs, node_order="morton")
    kw = dict(batch_size=2, shuffle=True, seed=43, edge_block=0,
              pairing=True)
    jl, pl = JaxGraphLoader(jd, **kw), GraphLoader(pd, **kw)
    assert (pl.max_nodes, pl.max_edges, pl.max_in_degree) == (
        jl.max_nodes, jl.max_edges, jl.max_in_degree)
    for epoch in (1, 2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        for jb, pb in zip(jl, pl):
            assert pb.edge_pair is not None and pb.edge_block == 0
            assert_batches_equal(jb, pb, plain_pair=True)


def test_blocking_scans_match_jax():
    loc = np.random.default_rng(8).uniform(0, 1, size=(1200, 3))
    sym = {"edge_index": jradius.radius_graph_np(loc, 0.1)}
    asym = blocked_test_graph(9)
    n_pad = 4 * BLOCK
    for ds in ([sym], [sym, asym]):
        want = jblocked.scan_dataset_for_blocking(ds, n_pad, BLOCK)
        assert pblocked.scan_dataset_for_blocking(ds, n_pad, BLOCK) == want
    for g in (sym, asym):
        assert pep.count_remote_edges(g["edge_index"], block=BLOCK,
                                      n_nodes=n_pad) == \
            jep.count_remote_edges(g["edge_index"], block=BLOCK,
                                   n_nodes=n_pad)


def _assert_graphs_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("radius, cutoff", [(-1.0, 0.0), (0.6, 0.25)])
def test_build_nbody_graph_matches_jax(radius, cutoff):
    rng = np.random.default_rng(10)
    loc, vel, tgt = (rng.normal(size=(12, 3)).astype(np.float32)
                     for _ in range(3))
    q = rng.choice([-1.0, 1.0], size=(12, 1)).astype(np.float32)
    _assert_graphs_equal(
        jnbody.build_nbody_graph(loc, vel, q, tgt, radius, cutoff),
        pnbody.build_nbody_graph(loc, vel, q, tgt, radius, cutoff))


def test_build_fluid_graph_matches_jax():
    rng = np.random.default_rng(11)
    loc, vel, tgt = (rng.normal(size=(50, 3)).astype(np.float32)
                     for _ in range(3))
    _assert_graphs_equal(jfluid.build_fluid_graph(loc, vel, 0.3, 1.2, tgt),
                         pfluid.build_fluid_graph(loc, vel, 0.3, 1.2, tgt))


def _write_nbody(base, n_body=5, frames=12, samples=(4, 1, 1)):
    rng = np.random.default_rng(12)
    os.makedirs(base, exist_ok=True)
    for split, s in zip(("train", "valid", "test"), samples):
        loc = rng.normal(size=(s, frames, n_body, 3)).astype(np.float32)
        np.save(os.path.join(base, f"loc_{split}_t.npy"), loc)
        np.save(os.path.join(base, f"vel_{split}_t.npy"),
                rng.normal(size=loc.shape).astype(np.float32) * 0.1)
        np.save(os.path.join(base, f"charges_{split}_t.npy"),
                rng.choice([-1.0, 1.0], size=(s, n_body, 1)).astype(
                    np.float32))


def test_process_nbody_cutoff_matches_jax(tmp_path):
    import pickle

    for root in ("j", "p"):
        _write_nbody(str(tmp_path / root / "nbody_t"))
    args = ("nbody_t", 10, 1.5, 2, 8, 0.1)
    jp = jnbody.process_nbody_cutoff(str(tmp_path / "j"), *args)
    pp = pnbody.process_nbody_cutoff(str(tmp_path / "p"), *args)
    assert [os.path.basename(p) for p in jp] == [os.path.basename(p)
                                                for p in pp]
    for a, b in zip(jp, pp):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            ga, gb = pickle.load(fa), pickle.load(fb)
        assert len(ga) == len(gb)
        for x, y in zip(ga, gb):
            _assert_graphs_equal(x, y)


# ---------------------------------------------------------------- trainer

def _small_config(log_dir, **extra):
    ov = {"model.edge_impl": "fused", "data.edge_block": BLOCK,
          "data.accelerate_mode": "cutoff_edges", "model.hidden_nf": H_SMALL,
          "model.n_layers": L_SMALL, "train.epochs": 2,
          "log.test_interval": 1, "log.log_dir": str(log_dir)}
    ov.update(extra)
    return load_config(FLAGSHIP, ov)


def test_step_generator_is_a_function_of_seed_epoch_step():
    def draw(*a):
        return torch.rand(4, generator=step_generator(*a, torch.device(
            "cpu"))).tolist()

    assert draw(43, 1, 0) == draw(43, 1, 0)
    assert len({tuple(draw(*a)) for a in ((43, 1, 0), (43, 1, 1),
                                          (43, 2, 0), (44, 1, 0))}) == 4


def test_run_two_epochs_on_cpu_writes_jax_log_layout_and_checkpoints(
        tmp_path):
    cfg = _small_config(tmp_path)
    ds = [GraphDataset([train_graph(s, n_real=3 * BLOCK) for s in
                        range(k, k + n)], node_order="morton")
          for k, n in ((0, 4), (10, 1), (20, 1))]
    steps = []
    before = (pep.fused_edge_layer.launches,
              pep.fused_edge_layer.bwd_launches)
    state, best, log_dict = pmain.run(
        cfg, *ds, device="cpu",
        on_step=lambda e, s, m: steps.append((e, s, float(m["loss"]))))
    # the CPU takes the plain versions: no kernel launch
    assert (pep.fused_edge_layer.launches,
            pep.fused_edge_layer.bwd_launches) == before
    assert [(e, s) for e, s, _ in steps] == [(e, s) for e in (1, 2)
                                             for s in range(4)]
    assert all(np.isfinite(v) for _, _, v in steps)
    # accumulation_steps 4: one update per epoch
    assert state.optimizer.updates == 2 and state.step == 8

    exp = os.path.join(str(tmp_path), cfg.log.exp_name)
    with open(os.path.join(exp, "log", "log.json")) as f:
        logged = json.load(f)
    assert len(logged) == 3
    jbest, jlog, jcfg = logged
    assert set(jlog) == {"epochs", "loss", "loss_train", "epoch_time",
                         "start_epoch", "divergence_events"}
    assert jlog["epochs"] == [1, 2] and len(jlog["loss_train"]) == 2
    assert set(jbest) >= {"epoch_index", "loss_valid", "loss_test",
                          "loss_train", "time_cost"}
    assert jcfg["model"]["hidden_nf"] == H_SMALL
    assert jbest["epoch_index"] == best["epoch_index"]

    ckpt = os.path.join(exp, "state_dict")
    assert {"best_model.ckpt", "last_model.ckpt",
            "manifest.json"} <= set(os.listdir(ckpt))
    fresh = TrainState(*_fresh_model_and_optimizer(cfg))
    fresh, epoch, _ = restore_checkpoint(os.path.join(ckpt,
                                                      "last_model.ckpt"), fresh)
    assert epoch == 2 and fresh.step == state.step
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    assert fresh.optimizer.updates == state.optimizer.updates
    for a, b in zip(fresh.optimizer.adam.state.values(),
                    state.optimizer.adam.state.values()):
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    fresh2 = TrainState(*_fresh_model_and_optimizer(cfg))
    _, bepoch, losses = restore_checkpoint(
        os.path.join(ckpt, "best_model.ckpt"), fresh2)
    assert bepoch == best["epoch_index"]
    assert losses["loss_valid"] == best["loss_valid"]


def test_scan_epochs_false_trains_as_auto(tmp_path):
    """``train.scan_epochs: false`` (JAX: no scan) loads and runs the
    port's eager loop, the same steps as under ``'auto'``."""
    ds = [GraphDataset([train_graph(s, n_real=3 * BLOCK) for s in
                        range(k, k + n)])
          for k, n in ((0, 4), (10, 1), (20, 1))]
    losses = {}
    for scan in ("auto", False):
        cfg = _small_config(tmp_path / str(scan), **{
            "train.scan_epochs": scan, "train.epochs": 1})
        steps = []
        pmain.run(cfg, *ds, device="cpu",
                  on_step=lambda e, s, m: steps.append(float(m["loss"])))
        losses[scan] = steps
    assert len(losses[False]) == 4 and all(np.isfinite(losses[False]))
    assert losses[False] == losses["auto"]


def _fresh_model_and_optimizer(cfg):
    from distegnn_tpu_torch.models.registry import get_model

    model = get_model(cfg.model, generator=torch.Generator().manual_seed(0))
    t = cfg.train
    return model, make_optimizer(model.parameters(), t.learning_rate,
                                 weight_decay=t.weight_decay,
                                 accumulation_steps=t.accumulation_steps)


def test_checkpoint_detects_corruption(tmp_path):
    cfg = _small_config(tmp_path)
    state = TrainState(*_fresh_model_and_optimizer(cfg), step=3)
    path = str(tmp_path / "s" / "m.ckpt")
    save_checkpoint(path, state, 1, losses={"loss_valid": 0.5})
    assert not [f for f in os.listdir(tmp_path / "s") if f.endswith(".tmp")]
    manifest = json.load(open(tmp_path / "s" / "manifest.json"))
    assert manifest["m.ckpt"]["size"] == os.path.getsize(path)
    other = TrainState(*_fresh_model_and_optimizer(cfg))
    _, epoch, losses = restore_checkpoint(path, other)
    assert epoch == 1 and other.step == 3 and losses == {"loss_valid": 0.5}
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(CheckpointCorruptError, match="CRC32"):
        restore_checkpoint(path, other)


def test_main_cli_trains_nbody_on_cpu(tmp_path):
    """python -m distegnn_tpu_torch.main --config_path ... --device cpu on a
    small n-body dataset written to disk."""
    data_dir = tmp_path / "data"
    _write_nbody(str(data_dir / "nbody_t"), samples=(4, 2, 2))
    with open(os.path.join(REPO, "configs", "nbody_fastegnn.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"].update(edge_impl="fused", normalize=False, hidden_nf=H_SMALL,
                        n_layers=L_SMALL)
    raw["data"].update(data_dir=str(data_dir), dataset_name="nbody_t",
                       max_samples=10, frame_0=2, frame_T=8, radius=-1.0,
                       cutoff_rate=0.0, edge_block=BLOCK, batch_size=2,
                       accelerate_mode="cutoff_edges")
    raw["log"].update(log_dir=str(tmp_path / "logs"), test_interval=1)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    best = pmain.main(["--config_path", str(cfg_path), "--epochs", "2",
                       "--device", "cpu"])
    assert best["epoch_index"] in (1, 2)
    assert np.isfinite(best["loss_valid"])
    (exp,) = os.listdir(tmp_path / "logs")
    assert exp.startswith("nbody_t_r-1.0_cut0.0_FastEGNN_ws1_C")
    assert os.path.exists(tmp_path / "logs" / exp / "log" / "log.json")


def test_run_refuses_distribute_mode(tmp_path):
    """``run`` trains whole graphs on one device; graph parts over ranks
    go through run_distributed (main dispatches there:
    tests/test_torch_distributed.py)."""
    cfg = _small_config(tmp_path, **{"data.accelerate_mode": "distribute"})
    with pytest.raises(ValueError, match="run_distributed"):
        pmain.run(cfg, None, None, None, device="cpu")
