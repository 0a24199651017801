"""The port's distributed step (graph parts over torch.distributed) on the
CPU: 4 gloo ranks (tests/torch_dist_worker.py, spawned once for the module)
against the JAX package's ``make_distributed_steps`` on 4 of the 8 virtual
CPU devices, on the same partitioned batches (H=16, L=2, C=3, two 150-node
graphs split by the metis partitioner into 4 parts).

Each of the lowerings plain (scatter), fused (edge_block 512, the kernels'
plain versions on the CPU) and cumsum (plain layout with the pairing)
compares rank r's batch with slice r of JAX's ``ShardedGraphLoader`` stack
(exactly), the forward (positions of real nodes and virtual positions),
the eval loss, one train step (MSE + MMD from the indices JAX drew on each
device, clip 0.3, Adam): its losses and ``batch_consistency``, and the
parameters after the update.

Tolerances (f32), set from the sums' order, the only difference between
the two sides: the forward at 1e-6 of the largest |coordinate|, the losses
at 1e-5 relative (as the JAX package's own distributed test holds them: a
loss is a mean of squared prediction - target differences ~1e-3 of the
coordinates, so the forward's rounding reaches it amplified); the update's
gradient, read as Adam's first moment
(0.1 x the clipped gradient summed over the ranks, + wd x p), at 1e-5 of
its largest entry over all tensors; the parameters after the update at
1e-3 of the learning rate plus 2 ulps of the parameter. Adam's first step
moves each parameter by ~lr x g / (|g| + eps), so a gradient entry whose
|g| is near eps (the phi_X heads' sums cancel over the nodes) carries its
relative difference into the step: measured 1.2e-4 of lr at most.

Also without JAX: the union invariant (the parts' forward and the
gradient summed over the ranks equal one process on the union graph, each
part's local edges only), with a rank whose part is empty; ``fused_stack``
runs the per-layer fused layers under the axis; the replication check;
``python -m distegnn_tpu_torch.main`` on a distribute config at world size
2 (2 epochs through ``run_distributed``); and a preemption drill at 2
ranks: SIGTERM to rank 1 only, both ranks stop after the same micro-step,
rank 0 alone writes, the resume agrees and ends bitwise at the
uninterrupted run's parameters, and disagreeing resume coordinates raise.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import PartitionSpec as P

from distegnn_tpu.data import GraphDataset as JaxGraphDataset
from distegnn_tpu.data import ShardedGraphLoader
from distegnn_tpu.models.fast_egnn import FastEGNN as JaxFastEGNN
from distegnn_tpu.parallel.compat import shard_map
from distegnn_tpu.parallel.launch import make_distributed_steps
from distegnn_tpu.parallel.mesh import GRAPH_AXIS, make_mesh
from distegnn_tpu.train import TrainState, make_eval_step, make_optimizer
from distegnn_tpu_torch import main as pmain
from distegnn_tpu_torch.convert import params_from_jax
from distegnn_tpu_torch.data.partition import split_graph
from distegnn_tpu_torch.models.fast_egnn import FastEGNN
from distegnn_tpu_torch.ops.graph import pad_graphs
from distegnn_tpu_torch.ops.radius import radius_graph_np
from distegnn_tpu_torch.train.step import make_loss_fn
from test_torch_fast_egnn import numpy_params
from test_torch_train import _write_nbody
from torch_dist_worker import collect, start

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPARTS, H, L, C = 4, 16, 2, 3
RADIUS, SEED = 0.45, 5
KEY = jax.random.PRNGKey(7)
HYPER = dict(lr=5e-4, weight_decay=1e-12, clip=0.3, mmd_weight=0.03,
             mmd_sigma=1.5, mmd_samples=3)
MODEL = dict(node_feat_nf=2, edge_attr_nf=2, hidden_nf=H, virtual_channels=C,
             n_layers=L)
# (model kwargs, loader kwargs, graphs a batch): fused at one graph a batch,
# since each part pads to the kernel's 3 blocks of 512 nodes (the costly
# case for JAX's interpret-mode kernels)
LOWERINGS = {
    "plain": ({}, {}, 2),
    "fused": ({"edge_impl": "fused"}, {"edge_block": 512,
                                        "split_remote": True}, 1),
    "cumsum": ({"segment_impl": "cumsum"}, {"pairing": True}, 2),
}
TOL_FWD, TOL_LOSS, TOL_PARAM = 1e-6, 1e-5, 1e-5


def _graph(seed, n=150):
    rng = np.random.default_rng(seed)
    loc = rng.uniform(0, 1.6, size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    feat = np.concatenate([np.linalg.norm(vel, axis=1, keepdims=True),
                           rng.choice([-1.0, 1.0], size=(n, 1))], axis=1)
    return {"node_feat": feat.astype(np.float32), "node_attr": None,
            "loc": loc, "vel": vel, "target": loc + 0.1 * vel,
            "loc_mean": loc.mean(axis=0),
            "edge_index": np.zeros((2, 0), np.int32),
            "edge_attr": np.zeros((0, 2), np.float32)}


def _split_by_labels(g, labels):
    """split_graph's part dicts for given labels (a part may be empty)."""
    parts = []
    for p in range(NPARTS):
        sel = labels == p
        pos = g["loc"][sel]
        ei = radius_graph_np(pos, RADIUS)
        d = np.linalg.norm(pos[ei[0]] - pos[ei[1]], axis=1)
        parts.append({"node_feat": g["node_feat"][sel], "node_attr": None,
                      "loc": pos, "vel": g["vel"][sel],
                      "target": g["target"][sel],
                      "loc_mean": g["loc"].mean(axis=0).astype(np.float32),
                      "edge_index": ei.astype(np.int32),
                      "edge_attr": np.repeat(d[:, None], 2, 1).astype(
                          np.float32)})
    return parts


def _union(parts):
    """One graph of the parts' nodes in order, with their local edges."""
    cat = {k: np.concatenate([p[k] for p in parts])
           for k in ("node_feat", "loc", "vel", "target", "edge_attr")}
    off = np.cumsum([0] + [p["loc"].shape[0] for p in parts])
    cat["edge_index"] = np.concatenate(
        [p["edge_index"] + o for p, o in zip(parts, off)], axis=1)
    cat["loc_mean"] = parts[0]["loc_mean"]
    cat["node_attr"] = None
    return cat


def _jax_mmd_idx(key, batch, num_sample):
    """The indices JAX's mmd_loss draws on each device: the key folded with
    the device's axis index, split per graph, min(floor(u * n), N - 1)."""
    mask = np.asarray(batch.node_mask)                  # [P, B, N]
    out = []
    for r in range(mask.shape[0]):
        keys = jax.random.split(jax.random.fold_in(key, r), mask.shape[1])
        rows = []
        for b in range(mask.shape[1]):
            u = np.asarray(jax.random.uniform(keys[b], (num_sample,)))
            n = mask[r, b].sum()
            rows.append(np.minimum((u * n).astype(np.int32),
                                   mask.shape[2] - 1))
        out.append(np.stack(rows))
    return out


def _jax_batch_params(shards, model_kw, loader_kw, batch_size):
    """JAX's first stacked [P, B, ...] batch of epoch 1 and a parameter
    tree for the model."""
    sl = ShardedGraphLoader([JaxGraphDataset(s) for s in shards], batch_size,
                            shuffle=True, seed=SEED, **loader_kw)
    sl.set_epoch(1)
    batch = next(iter(sl))
    jm = JaxFastEGNN(**MODEL, **model_kw, axis_name=GRAPH_AXIS)
    params = numpy_params(jm.copy(axis_name=None),
                          jax.tree.map(lambda x: x[0], batch), 3)
    return jm, batch, params


def _jax_reference(jm, batch, params, mesh):
    """JAX's forward, eval loss (its make_eval_step, in the forward's
    program: one compile) and one train step on the stacked batch."""
    ev = make_eval_step(jm, axis_name=GRAPH_AXIS)

    def fwd_eval(pr, b):
        b = jax.tree.map(lambda x: x[0], b)
        x, X = jm.apply(pr, b)
        return x, X, ev(pr, b)

    x, X, e = jax.jit(shard_map(
        fwd_eval, mesh=mesh, in_specs=(P(), P(GRAPH_AXIS)),
        out_specs=(P(GRAPH_AXIS), P(), P()), check_vma=False))(params, batch)
    tx = make_optimizer(HYPER["lr"], weight_decay=HYPER["weight_decay"],
                        clip_norm=HYPER["clip"])
    train, _ = make_distributed_steps(
        jm, tx, mesh, mmd_weight=HYPER["mmd_weight"],
        mmd_sigma=HYPER["mmd_sigma"], mmd_samples=HYPER["mmd_samples"])
    state, m = train(TrainState.create(params, tx), batch, KEY)
    (adam,) = [s for s in jax.tree.leaves(
        state.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu")]
    return {
        "batch": batch,
        "params": params_from_jax(jax.tree.map(np.asarray, params)),
        "x": np.asarray(x).reshape((NPARTS, -1) + x.shape[1:]),
        "X": np.asarray(X), "eval": float(e),
        "metrics": {k: float(v) for k, v in m.items()},
        "after": params_from_jax(jax.tree.map(np.asarray, state.params)),
        "mu": params_from_jax(jax.tree.map(np.asarray, adam.mu))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks run (spawned) while JAX computes its side here."""
    graphs = [_graph(s) for s in range(2)]
    parts = [split_graph(g, NPARTS, "metis", RADIUS, outer_radius=RADIUS,
                         seed=i) for i, g in enumerate(graphs)]
    shards = [[parts[i][p] for i in range(2)] for p in range(NPARTS)]
    jobs, ins = {}, {}
    for name, (model_kw, loader_kw, bs) in LOWERINGS.items():
        jm, batch, params = ins[name] = _jax_batch_params(shards, model_kw,
                                                          loader_kw, bs)
        jobs[name] = dict(
            kind="step", shards=shards, batch_size=bs, seed=SEED,
            loader=loader_kw, model=dict(MODEL, **model_kw), hyper=HYPER,
            state_dict={k: v.numpy() for k, v in params_from_jax(
                jax.tree.map(np.asarray, params)).items()},
            mmd_idx=_jax_mmd_idx(KEY, batch, HYPER["mmd_samples"] * C))
    sd = {k: v.numpy() for k, v in FastEGNN(
        **MODEL, generator=torch.Generator().manual_seed(0)).state_dict()
          .items()}
    # a part left empty: labels by x into 3 slabs, part 3 gets no node
    empty = [_split_by_labels(g, np.minimum(
        (g["loc"][:, 0] / 1.6 * 3).astype(np.int32), 2)) for g in graphs]
    union_jobs = {"union": shards,
                  "empty": [[empty[i][p] for i in range(2)]
                            for p in range(NPARTS)]}
    for name, sh in union_jobs.items():
        jobs[name] = dict(kind="grad", shards=sh, batch_size=2, seed=SEED,
                          loader={}, model=MODEL, state_dict=sd)
    jobs["stack"] = dict(kind="stack", shards=shards, batch_size=1,
                         seed=SEED, loader=LOWERINGS["fused"][1],
                         model=MODEL, state_dict=jobs["fused"]["state_dict"])
    jobs["replicated"] = dict(kind="replicated", model=MODEL, state_dict=sd)
    tmp = str(tmp_path_factory.mktemp("ranks"))
    ctx = start(jobs, NPARTS, tmp)
    mesh = make_mesh(n_graph=NPARTS, devices=jax.devices()[:NPARTS])
    jax_out = {name: _jax_reference(*ins[name], mesh) for name in LOWERINGS}
    return jax_out, collect(ctx, NPARTS, tmp), union_jobs, sd


def _order():
    return np.random.default_rng([SEED, 1]).permutation(2)


@pytest.mark.parametrize("name", list(LOWERINGS))
def test_rank_batches_are_the_jax_sharded_stack(runs, name):
    jax_out, ranks, _, _ = runs
    jb = jax_out[name]["batch"]
    for r, res in enumerate(ranks):
        got = res[name]["batch"]
        for field, arr in got.items():
            want = getattr(jb, field)
            assert want is not None, field
            np.testing.assert_array_equal(arr, np.asarray(want)[r],
                                          err_msg=f"rank {r} {field}")
        for field in ("edge_pair", "remote_edge_index"):
            assert (getattr(jb, field) is None) == (field not in got), field


@pytest.mark.parametrize("name", list(LOWERINGS))
def test_forward_matches_jax(runs, name):
    jax_out, ranks, _, _ = runs
    ref = jax_out[name]
    mask = np.asarray(ref["batch"].node_mask) > 0
    scale = float(np.abs(ref["x"][mask]).max())
    for r, res in enumerate(ranks):
        x = res[name]["x"]
        err = float(np.abs(x[mask[r]] - ref["x"][r][mask[r]]).max())
        assert err <= TOL_FWD * scale, (r, err)
        # the virtual coordinates are the same global objects on every rank
        errv = float(np.abs(res[name]["X"] - ref["X"]).max())
        assert errv <= TOL_FWD * float(np.abs(ref["X"]).max()), (r, errv)


@pytest.mark.parametrize("name", list(LOWERINGS))
def test_losses_and_consistency_match_jax(runs, name):
    jax_out, ranks, _, _ = runs
    ref = jax_out[name]
    for res in ranks:
        got = res[name]
        for key in ("loss", "loss_with_mmd"):
            want = ref["metrics"][key]
            assert abs(got[key] - want) <= TOL_LOSS * abs(want), key
        assert abs(got["eval"] - ref["eval"]) <= TOL_LOSS * ref["eval"]
        assert got["batch_consistency"] == 0.0
    assert ref["metrics"]["batch_consistency"] == 0.0


@pytest.mark.parametrize("name", list(LOWERINGS))
def test_first_update_matches_jax_and_is_replicated(runs, name):
    jax_out, ranks, _, _ = runs
    ref = jax_out[name]
    gscale = max(float(np.abs(v.numpy()).max()) for v in ref["mu"].values())
    ulp = 2.0 ** -22
    for k, w in ref["after"].items():
        w = w.numpy()
        for r, res in enumerate(ranks):
            mu = res[name]["mu"][k]
            err = float(np.abs(mu - ref["mu"][k].numpy()).max())
            assert err <= 1e-5 * gscale, (k, r, err, gscale)
            got = res[name]["params"][k]
            bound = 1e-3 * HYPER["lr"] + ulp * np.abs(w)
            assert (np.abs(got - w) <= bound).all(), (k, r)
            np.testing.assert_array_equal(got, ranks[0][name]["params"][k])
        assert not np.array_equal(w, ref["params"][k].numpy()), k


def _union_reference(union_shards, sd):
    """One process, the union of each graph's parts, in the ranks' batch
    order: (per-graph node offsets, x, X, MSE loss, gradients)."""
    order = _order()
    graphs = [[union_shards[p][i] for p in range(NPARTS)] for i in order]
    model = FastEGNN(**MODEL)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    batch = pad_graphs([_union(parts) for parts in graphs])
    with torch.no_grad():
        x, X = model(batch)
    loss, _ = make_loss_fn(model, 0.0, 1.5, 3)(batch)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .numpy() for n, p in model.named_parameters()}
    offs = [np.cumsum([0] + [p["loc"].shape[0] for p in parts])
            for parts in graphs]
    return offs, x.numpy(), X.numpy(), float(loss.detach()), grads


@pytest.mark.parametrize("name", ["union", "empty"])
def test_parts_match_the_union_graph(runs, name):
    """The DistEGNN invariant: disjoint parts with their local edges and
    the virtual nodes over all parts compute what one process computes on
    the union graph: the forward, the loss and the summed gradient (1e-6 /
    1e-5 of scale). 'empty': rank 3's part holds no node."""
    _, ranks, union_jobs, sd = runs
    offs, x, X, loss, grads = _union_reference(union_jobs[name], sd)
    if name == "empty":
        assert ranks[3][name]["n_real"] == 0
    scale = float(np.abs(x).max())
    for r, res in enumerate(ranks):
        got = res[name]
        for b in range(2):
            n = offs[b][r + 1] - offs[b][r]
            err = np.abs(got["x"][b, :n] - x[b, offs[b][r]:offs[b][r + 1]])
            assert float(err.max(initial=0.0)) <= TOL_FWD * scale
        assert float(np.abs(got["X"] - X).max()) <= TOL_FWD * float(
            np.abs(X).max())
        assert abs(got["loss"] - loss) <= TOL_LOSS * loss
        gscale = max(float(np.abs(g).max()) for g in grads.values())
        for k, g in grads.items():
            err = float(np.abs(got["grads"][k] - g).max())
            assert err <= 1e-5 * gscale, (k, err, gscale)


def test_fused_stack_runs_the_fused_layers_under_the_axis(runs):
    _, ranks, _, _ = runs
    assert all(res["stack"]["same"] for res in ranks)


def test_replication_check_raises_on_every_rank(runs):
    _, ranks, _, _ = runs
    for res in ranks:
        assert "differ across ranks at the end" in res["replicated"]["raised"]


def test_collectives_are_counted(runs):
    """Every rank issued the same collectives, by kind."""
    _, ranks, _, _ = runs
    counts = [res["counts"] for res in ranks]
    assert all(c == counts[0] for c in counts)
    # plain + cumsum + fused steps and the union / empty jobs: the model's
    # 3 node means x 2 sums x L per forward
    assert counts[0]["psum"] > 0 and counts[0]["psum_bwd"] > 0
    assert counts[0]["grad"] == len(LOWERINGS) + 2


def _cli_config(tmp_path, **train):
    """configs/nbody_fastegnn.yaml cut to a 40-body toy set in distribute
    mode (metis, 2 parts), written to ``tmp_path``; ``train`` overrides
    its train keys."""
    _write_nbody(str(tmp_path / "data" / "nbody_t"), n_body=40,
                 samples=(4, 2, 2))
    with open(os.path.join(REPO, "configs", "nbody_fastegnn.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"].update(hidden_nf=H, n_layers=L, normalize=False)
    raw["data"].update(data_dir=str(tmp_path / "data"), dataset_name="nbody_t",
                       max_samples=10, frame_0=2, frame_T=8, batch_size=2,
                       accelerate_mode="distribute", outer_radius=1.5,
                       inner_radius=1.5, split_mode="metis")
    raw["train"].update(accumulation_steps=2, **train)
    raw["log"].update(log_dir=str(tmp_path / "logs"), test_interval=1)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


def test_main_cli_trains_distribute_mode_at_world_size_2(tmp_path):
    """main dispatches accelerate_mode: distribute to run_distributed: the
    n-body processor writes metis shards, 2 gloo ranks train 2 epochs (the
    parameters checked bitwise equal across the ranks at the end), rank 0
    writes the log."""
    path = _cli_config(tmp_path)
    best = pmain.main(["--config_path", str(path), "--epochs", "2",
                       "--world_size", "2", "--device", "cpu"])
    assert best["epoch_index"] in (1, 2) and np.isfinite(best["loss_valid"])
    shards = os.listdir(tmp_path / "data" / "nbody_t" / "processed")
    assert len([s for s in shards if s.endswith("-2.pkl")]) == 6
    (exp,) = os.listdir(tmp_path / "logs")
    assert exp.startswith("nbody_t_metis_o1.5_i1.5_FastEGNN_ws2_C")
    with open(tmp_path / "logs" / exp / "log" / "log.json") as f:
        best_logged, log, _ = json.load(f)
    assert len(log["loss_train"]) == 2
    assert best_logged["epoch_index"] == best["epoch_index"]


def test_main_cli_trains_distribute_mode_on_staged_loaders(tmp_path):
    """``train.scan_epochs: true`` in distribute mode: every rank's eager
    loop runs on its staged loaders (``DistributedScanRunner``), the run's
    start event says so, and its best equals the run on the loaders."""
    best, starts = {}, {}
    for scan in (False, True):
        sub = tmp_path / str(scan)
        sub.mkdir()
        path = _cli_config(sub, scan_epochs=scan)
        best[scan] = pmain.main(["--config_path", str(path), "--epochs", "2",
                                 "--world_size", "2", "--device", "cpu"])
        (exp,) = os.listdir(sub / "logs")
        with open(sub / "logs" / exp / "obs" / "events.jsonl") as f:
            starts[scan] = [json.loads(line) for line in f
                            if '"train/run_start"' in line][0]
    assert starts[True]["scan_epochs"] is True
    assert starts[False]["scan_epochs"] is False
    for key in ("epoch_index", "loss_train", "loss_valid", "loss_test"):
        assert best[True][key] == best[False][key], key


class _Batches:
    """A loader of n CPU GraphBatches that fails at ``fail_at``."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at, self.epoch = n, fail_at, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            if i == self.fail_at:
                raise OSError("shard unreadable")
            yield pad_graphs([dict(_graph(i, n=10), edge_index=np.zeros(
                (2, 0), np.int32))])


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_loader_yields_the_loaders_batches_in_order(depth):
    from distegnn_tpu_torch.data.loader import PrefetchLoader, device_put

    want = list(_Batches(5))
    pf = PrefetchLoader(_Batches(5), device_put("cpu"), depth=depth)
    pf.set_epoch(3)
    got = list(pf)
    assert len(pf) == 5 and pf.loader.epoch == 3
    for a, b in zip(got, want):
        assert torch.equal(a.loc, b.loc) and torch.equal(a.node_mask,
                                                         b.node_mask)
    assert len(got) == 5


def test_prefetch_loader_raises_a_producer_failure_and_stops():
    """The thread's error reaches the consumer's next ``__next__`` (not a
    hang), chained; leaving early joins the thread."""
    import threading

    from distegnn_tpu_torch.data.loader import PrefetchLoader

    it = iter(PrefetchLoader(_Batches(5, fail_at=2), depth=2))
    next(it), next(it)
    with pytest.raises(RuntimeError, match="prefetch thread failed") as exc:
        next(it)
    assert isinstance(exc.value.__cause__, OSError)
    it = iter(PrefetchLoader(_Batches(50), depth=2))
    next(it)
    it.close()
    assert not any(t.name == "distegnn-prefetch" and t.is_alive()
                   for t in threading.enumerate())
    with pytest.raises(ValueError, match="depth"):
        PrefetchLoader(_Batches(1), depth=-1)


def test_pweighted_mean_matches_jax(tmp_path):
    """On a rank of one the sums over the axis are the local ones: equal
    to the JAX function without an axis (1e-6)."""
    from distegnn_tpu.parallel import collectives as jcoll
    from distegnn_tpu_torch.parallel import collectives as pcoll
    from torch_dist_worker import one_rank_group

    rng = np.random.default_rng(3)
    data = rng.normal(size=(2, 3, 4)).astype(np.float32)
    w = rng.uniform(1, 5, size=(2, 1, 1)).astype(np.float32)
    want = np.asarray(jcoll.pweighted_mean(data, w))
    with one_rank_group(tmp_path):
        got = pcoll.pweighted_mean(torch.from_numpy(data),
                                   torch.from_numpy(w), "graph").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_water3d_distribute_names_its_roadmap_item(tmp_path):
    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.parallel.launch import _dispatch_preprocess

    cfg = load_config(os.path.join(REPO, "configs",
                                   "simulation_distegnn.yaml"),
                      {"data.data_dir": str(tmp_path)})
    # the Water-3D processor is ported (data/water3d.py): with no raw
    # files it names the one it looked for
    with pytest.raises(FileNotFoundError, match="train.h5"):
        _dispatch_preprocess(cfg, 2)


@pytest.fixture(scope="module")
def preempt_drill(tmp_path_factory):
    """2 gloo ranks, 2 epochs of 4 micro-steps (accumulation 2) over 150-node
    graphs split in 2: uninterrupted (with obs.per_host); SIGTERM to rank 1
    before batch 5
    (epoch 2, step 1); ``resume: auto`` of the preempted run; resume
    coordinates that differ."""
    from distegnn_tpu_torch.config import load_config

    tmp = str(tmp_path_factory.mktemp("preempt"))
    graphs = [_graph(40 + s) for s in range(6)]
    parts = [split_graph(g, 2, "metis", RADIUS, outer_radius=RADIUS, seed=i)
             for i, g in enumerate(graphs)]
    splits = [[[parts[i][r] for i in idx] for r in range(2)]
              for idx in ((0, 1, 2, 3), (4,), (5,))]
    sd = {k: v.numpy() for k, v in FastEGNN(
        **MODEL, generator=torch.Generator().manual_seed(1)).state_dict()
          .items()}

    def cfg(log_dir, name, **over):
        ov = {"model.hidden_nf": H, "model.n_layers": L,
              "model.normalize": False, "data.world_size": 2,
              "train.accumulation_steps": 2, "train.epochs": 2,
              "log.test_interval": 1, "log.log_dir": os.path.join(tmp,
                                                                  log_dir),
              "log.exp_name": name, "seed": SEED,
              "train.checkpoint_interval_s": 1e-9}
        ov.update(over)
        return load_config(os.path.join(REPO, "configs",
                                        "nbody_fastegnn.yaml"),
                           ov).to_dict()

    job = dict(kind="train", splits=splits, model=MODEL, state_dict=sd)
    jobs = {"full": dict(job, config=cfg("full", "full",
                                         **{"obs.per_host": True})),
            "pre": dict(job, config=cfg("run", "pre"), kill=(1,), at=5),
            "res": dict(job, config=cfg("run", "res",
                                        **{"train.resume": "auto"})),
            "consensus": dict(kind="consensus")}
    ctx = start(jobs, 2, tmp)
    return collect(ctx, 2, tmp), tmp


def test_sigterm_to_one_rank_stops_both_after_the_same_micro_step(
        preempt_drill):
    ranks, tmp = preempt_drill
    pre = [r["pre"] for r in ranks]
    assert pre[0]["steps"] == pre[1]["steps"] == [(1, s) for s in range(4)] \
        + [(2, 0), (2, 1)]
    assert pre[0]["preempted"]["epoch"] == pre[1]["preempted"]["epoch"] == 1
    assert pre[0]["preempted"]["step_in_epoch"] == \
        pre[1]["preempted"]["step_in_epoch"] == 2
    # rank 0 alone writes: the cadence, eval and preempt checkpoints and
    # their manifests; rank 1 none
    assert pre[1]["writes"] == [] and ranks[1]["full"]["writes"] == []
    assert "preempt_model.ckpt" in pre[0]["writes"]
    ckpt = os.path.join(tmp, "run", "pre", "state_dict")
    with open(os.path.join(ckpt, "PREEMPTED")) as f:
        marker = json.load(f)
    assert (marker["epoch"], marker["step_in_epoch"]) == (1, 2)
    # the stop agreement: one MAX all-reduce a micro-step on every rank
    assert ranks[0]["counts"]["stop"] == ranks[1]["counts"]["stop"]
    # the event streams: rank 0's alone, or one a rank under obs.per_host
    assert os.listdir(os.path.join(tmp, "run", "pre", "obs")) == \
        ["events.jsonl"]
    assert sorted(os.listdir(os.path.join(tmp, "full", "full", "obs"))) == \
        ["events_p0.jsonl", "events_p1.jsonl"]


def test_resume_agrees_and_ends_at_the_uninterrupted_parameters(
        preempt_drill):
    ranks, _ = preempt_drill
    for r in ranks:
        assert r["res"]["steps"] == [(2, 2), (2, 3)]
        assert r["res"]["preempted"] is None
        for k, v in r["full"]["params"].items():
            np.testing.assert_array_equal(r["res"]["params"][k], v)
    for k, v in ranks[0]["res"]["params"].items():
        np.testing.assert_array_equal(ranks[1]["res"]["params"][k], v)


def test_disagreeing_resume_coordinates_raise_on_every_rank(preempt_drill):
    ranks, _ = preempt_drill
    for r in ranks:
        assert r["consensus"]["lagging"] == [0]
        assert r["consensus"]["coords"] == [(1, 2), (1, 3)]

