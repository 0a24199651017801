"""The port's (data, graph, tensor) mesh on the CPU: one world of 8 gloo
ranks at 2 x 2 x 2 (tests/torch_mesh_worker.py, spawned once for the
module) against the JAX package's distributed step on the 2 x 2 x 2 mesh of
8 virtual CPU devices, on the same partitioned batches: its per-device step
(``make_device_steps``, what ``make_distributed_steps`` shard_maps, with
its batch layout) in one shard_map program with the forward and the eval
loss, one compile a leg. The sizes
are JAX's parity harness's (``__graft_entry__._tensor_parity``): H=16, L=2,
C=3, graphs of 16 nodes split into 2 parts, 2 a data shard (the fused leg 1,
as tests/test_torch_distributed.py runs it: each part pads to the kernel's 3
blocks of 512 nodes, the costly case for JAX's interpret-mode kernels).

For the ``plain`` and ``fused`` legs (the kernels' plain versions on the
CPU) each rank's batch is slice [d, g] of JAX's ``ShardedGraphLoader(
data_parallel=2)`` stack, exactly; the forward, the eval loss, one train
step's losses and ``batch_consistency``, and the parameters after the
update are held at tests/test_torch_distributed.py's tolerances (the same
reasoning: f32, only the sums' order differs; under the tensor axis the
hidden-width partial sums add an order of their own); the parameters after
the update are bitwise the same on all 8 ranks. ``fused_stack`` under the
mesh equals the ``fused`` leg bitwise, with no megakernel launch. Each
``tp_*`` function's forward and backward equals JAX's on random inputs
(1e-6 relative: a sum over 2 ranks), and the collectives are counted by
kind, the same on every rank.

Also without the world: the plain version of the fused edge layer at phi_x
width HX = H/2 (a tensor rank's slice of w3, b3, w4) against JAX's
``fused_edge_layer`` on the same sliced weights (its Pallas kernels in
interpret mode), forward and every gradient, at the tolerances of
tests/test_torch_edge_pipeline.py and tests/test_torch_edge_backward.py.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distegnn_tpu.data import GraphDataset as JaxGraphDataset
from distegnn_tpu.data import ShardedGraphLoader
from distegnn_tpu.models.fast_egnn import FastEGNN as JaxFastEGNN
from distegnn_tpu.ops import edge_pipeline as J
from distegnn_tpu.parallel import collectives as jcoll
from distegnn_tpu.parallel.compat import shard_map
from distegnn_tpu.parallel.launch import batch_layout, make_device_steps
from distegnn_tpu.parallel.mesh import (DATA_AXIS, GRAPH_AXIS, TENSOR_AXIS,
                                        make_mesh)
from distegnn_tpu.train import TrainState, make_optimizer
from distegnn_tpu_torch.convert import params_from_jax
from distegnn_tpu_torch.data.partition import split_graph
from distegnn_tpu_torch.ops import edge_pipeline as PE
from test_torch_fast_egnn import numpy_params
from test_torch_kernels_cuda import T as BLOCK
from test_torch_kernels_cuda import _setup, _t
from torch_mesh_worker import TP_FUNCS, collect, start

MESH = (2, 2, 2)
WORLD = 8
H, L, C, NODES, SEED = 16, 2, 3, 16, 5
KEY = jax.random.PRNGKey(7)
HYPER = dict(lr=5e-4, weight_decay=1e-12, clip=0.3, mmd_weight=0.03,
             mmd_sigma=1.5, mmd_samples=3)
MODEL = dict(node_feat_nf=2, edge_attr_nf=2, hidden_nf=H, virtual_channels=C,
             n_layers=L)
# (model kwargs, loader kwargs, graphs a data shard's batch)
LEGS = {
    "plain": ({}, {}, 2),
    "fused": ({"edge_impl": "fused"}, {"edge_block": 512,
                                        "split_remote": True}, 1),
}
TOL_FWD, TOL_LOSS = 1e-6, 1e-5


def _graph(rng):
    loc = rng.normal(size=(NODES, 3)).astype(np.float32)
    vel = rng.normal(size=(NODES, 3)).astype(np.float32)
    q = rng.choice([1.0, -1.0], size=(NODES, 1))
    feat = np.concatenate([np.linalg.norm(vel, axis=1, keepdims=True), q],
                          axis=1)
    return {"node_feat": feat.astype(np.float32), "node_attr": None,
            "loc": loc, "vel": vel, "target": loc + 0.1 * vel,
            "loc_mean": loc.mean(axis=0),
            "edge_index": np.zeros((2, 0), np.int32),
            "edge_attr": np.zeros((0, 2), np.float32)}


def _shards():
    """[P] shards of 4 part graphs: 2 graphs per data shard, each split
    into 2 parts by the metis partitioner."""
    rng = np.random.default_rng(42)
    parts = [split_graph(_graph(rng), MESH[1], "metis", 2.0,
                         outer_radius=3.0, seed=i) for i in range(4)]
    return [[parts[i][p] for i in range(4)] for p in range(MESH[1])]


def _jax_mmd_idx(batch, num_sample):
    """The indices JAX's mmd_loss draws on device (d, g, .): the key folded
    with the data index, then the graph index, split per graph."""
    mask = np.asarray(batch.node_mask)                  # [D, P, B, N]
    D, Pn, B, N = mask.shape
    out = [[None] * Pn for _ in range(D)]
    for d in range(D):
        for g in range(Pn):
            key = jax.random.fold_in(jax.random.fold_in(KEY, d), g)
            keys = jax.random.split(key, B)
            rows = []
            for b in range(B):
                u = np.asarray(jax.random.uniform(keys[b], (num_sample,)))
                n = mask[d, g, b].sum()
                rows.append(np.minimum((u * n).astype(np.int32), N - 1))
            out[d][g] = np.stack(rows)
    return out


def _jax_reference(jm, batch, params, mesh):
    """JAX's forward, eval loss and one train step on the [D, P, B, ...]
    stack over the 2 x 2 x 2 mesh, in one program."""
    tx = make_optimizer(HYPER["lr"], weight_decay=HYPER["weight_decay"],
                        clip_norm=HYPER["clip"])
    step, ev = make_device_steps(
        jm, tx, mesh, mmd_weight=HYPER["mmd_weight"],
        mmd_sigma=HYPER["mmd_sigma"], mmd_samples=HYPER["mmd_samples"])
    spec, strip = batch_layout(MESH[0])

    def one(pr, st, b, key):
        b = jax.tree.map(strip, b)
        x, X = jm.apply(pr, b)
        st, m = step(st, b, key)
        return x[None, None], X[None], ev(pr, b), st, m

    x, X, e, state, m = jax.jit(shard_map(
        one, mesh=mesh, in_specs=(P(), P(), spec, P()),
        out_specs=(spec, P(DATA_AXIS), P(), P(), P()),
        check_vma=False))(params, TrainState.create(params, tx), batch, KEY)
    (adam,) = [s for s in jax.tree.leaves(
        state.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu")]
    return {
        "batch": batch, "x": np.asarray(x), "X": np.asarray(X),
        "eval": float(e), "metrics": {k: float(v) for k, v in m.items()},
        "params": params_from_jax(jax.tree.map(np.asarray, params)),
        "after": params_from_jax(jax.tree.map(np.asarray, state.params)),
        "mu": params_from_jax(jax.tree.map(np.asarray, adam.mu))}


# each tp_* function's per-rank input and cotangent shapes
TP_SHAPES = {"tp_copy": ((3, 4), (3, 4)), "tp_reduce": ((3, 4), (3, 4)),
             "tp_gather": ((3, 4), (3, 8)), "tp_slice": ((3, 4), (3, 2)),
             "tp_slice_rows": ((4, 3), (2, 3)), "tp_once": ((3, 4), (3, 4))}


def _tp_inputs():
    rng = np.random.default_rng(11)
    return ({k: rng.normal(size=MESH + a).astype(np.float32)
             for k, (a, _) in TP_SHAPES.items()},
            {k: rng.normal(size=MESH + b).astype(np.float32)
             for k, (_, b) in TP_SHAPES.items()})


def _jax_tp(mesh, xs, cts):
    """Each JAX tp_* function's forward and VJP on every device's input (one
    program)."""
    spec = P(DATA_AXIS, GRAPH_AXIS, TENSOR_AXIS)

    def one(x, ct):
        out = {}
        for name in TP_FUNCS:
            fn = getattr(jcoll, name)
            y, vjp = jax.vjp(lambda v, fn=fn: fn(v, TENSOR_AXIS),
                             x[name][0, 0, 0])
            out[name] = (y[None, None, None],
                         vjp(ct[name][0, 0, 0])[0][None, None, None])
        return out

    res = jax.jit(shard_map(one, mesh=mesh, in_specs=(spec, spec),
                            out_specs=spec, check_vma=False))(xs, cts)
    return {k: (np.asarray(y), np.asarray(g)) for k, (y, g) in res.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks run (spawned) while JAX computes its side here."""
    shards = _shards()
    jobs, ins = {}, {}
    for name, (model_kw, loader_kw, bs) in LEGS.items():
        sl = ShardedGraphLoader([JaxGraphDataset(s) for s in shards], bs,
                                shuffle=True, seed=SEED, data_parallel=2,
                                **loader_kw)
        sl.set_epoch(1)
        batch = next(iter(sl))
        jm = JaxFastEGNN(**MODEL, **model_kw, axis_name=GRAPH_AXIS,
                         tensor_axis=TENSOR_AXIS)
        params = numpy_params(jm.copy(axis_name=None, tensor_axis=None),
                              jax.tree.map(lambda x: x[0, 0], batch), 3)
        ins[name] = (jm, batch, params)
        jobs[name] = dict(
            kind="step", mesh=MESH, shards=shards, batch_size=bs, seed=SEED,
            loader=loader_kw, model=dict(MODEL, **model_kw), hyper=HYPER,
            stack=name == "fused",
            state_dict={k: v.numpy() for k, v in params_from_jax(
                jax.tree.map(np.asarray, params)).items()},
            mmd_idx=_jax_mmd_idx(batch, HYPER["mmd_samples"] * C))
    xs, cts = _tp_inputs()
    jobs["tp"] = dict(kind="tp", mesh=MESH, x=xs, ct=cts)
    tmp = str(tmp_path_factory.mktemp("mesh"))
    ctx = start(jobs, MESH, tmp)
    mesh = make_mesh(n_data=2, n_graph=2, n_tensor=2,
                     devices=jax.devices()[:WORLD])
    jax_out = {name: _jax_reference(*ins[name], mesh) for name in LEGS}
    jax_out["tp"] = _jax_tp(mesh, xs, cts)
    return jax_out, collect(ctx, WORLD, tmp)


def _coords(r):
    return r // 4, (r // 2) % 2, r % 2


@pytest.mark.parametrize("name", list(LEGS))
def test_rank_batches_are_the_jax_data_parallel_stack(runs, name):
    jax_out, ranks = runs
    jb = jax_out[name]["batch"]
    for r, res in enumerate(ranks):
        d, g, _ = _coords(r)
        for field, arr in res[name]["batch"].items():
            want = getattr(jb, field)
            assert want is not None, field
            np.testing.assert_array_equal(arr, np.asarray(want)[d, g],
                                          err_msg=f"rank {r} {field}")


@pytest.mark.parametrize("name", list(LEGS))
def test_forward_matches_jax(runs, name):
    jax_out, ranks = runs
    ref = jax_out[name]
    mask = np.asarray(ref["batch"].node_mask) > 0         # [D, P, B, N]
    scale = float(np.abs(ref["x"][mask]).max())
    for r, res in enumerate(ranks):
        d, g, _ = _coords(r)
        err = float(np.abs(res[name]["x"][mask[d, g]]
                           - ref["x"][d, g][mask[d, g]]).max())
        assert err <= TOL_FWD * scale, (r, err)
        errv = float(np.abs(res[name]["X"] - ref["X"][d]).max())
        assert errv <= TOL_FWD * float(np.abs(ref["X"]).max()), (r, errv)


@pytest.mark.parametrize("name", list(LEGS))
def test_losses_and_consistency_match_jax(runs, name):
    jax_out, ranks = runs
    ref = jax_out[name]
    for res in ranks:
        got = res[name]
        for key in ("loss", "loss_with_mmd"):
            want = ref["metrics"][key]
            assert abs(got[key] - want) <= TOL_LOSS * abs(want), key
        assert abs(got["eval"] - ref["eval"]) <= TOL_LOSS * ref["eval"]
        assert got["batch_consistency"] == 0.0
    assert ref["metrics"]["batch_consistency"] == 0.0


@pytest.mark.parametrize("name", list(LEGS))
def test_first_update_matches_jax_and_is_replicated(runs, name):
    """Adam's first moment (0.1 x the clipped gradient summed over (data,
    graph), + wd x p) at 1e-5 of its largest entry; the parameters at 1e-3
    of the learning rate plus 2 ulps; bitwise equal on all 8 ranks."""
    jax_out, ranks = runs
    ref = jax_out[name]
    gscale = max(float(np.abs(v.numpy()).max()) for v in ref["mu"].values())
    ulp = 2.0 ** -22
    for k, w in ref["after"].items():
        w = w.numpy()
        for r, res in enumerate(ranks):
            err = float(np.abs(res[name]["mu"][k]
                               - ref["mu"][k].numpy()).max())
            assert err <= 1e-5 * gscale, (k, r, err, gscale)
            got = res[name]["params"][k]
            assert (np.abs(got - w) <= 1e-3 * HYPER["lr"]
                    + ulp * np.abs(w)).all(), (k, r)
            np.testing.assert_array_equal(got, ranks[0][name]["params"][k])
        assert not np.array_equal(w, ref["params"][k].numpy()), k


def test_fused_stack_runs_the_fused_layers_under_the_mesh(runs):
    _, ranks = runs
    assert all(res["fused"]["stack_same"] for res in ranks)


@pytest.mark.parametrize("name", list(TP_FUNCS))
def test_tp_functions_match_jax(runs, name):
    jax_out, ranks = runs
    y_ref, g_ref = jax_out["tp"][name]
    for r, res in enumerate(ranks):
        d, g, t = _coords(r)
        y, gx = res["tp"][name]
        np.testing.assert_allclose(y, y_ref[d, g, t], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gx, g_ref[d, g, t], rtol=1e-6, atol=1e-6)


def test_collectives_are_counted_by_kind(runs):
    """Every rank issued the same collectives by kind: the graph axis's
    node sums, the tensor axis's (the all-gathers of the hoisted products
    and of the sliced weights' cotangents, the sums of phi_x / phi_h and of
    the copies' cotangents), the (data, graph) loss, gradient and
    consistency reductions, and the whole world's replication check."""
    _, ranks = runs
    counts = [res["counts"] for res in ranks]
    assert all(c == counts[0] for c in counts)
    red, gat = counts[0]["all_reduce"], counts[0]["all_gather"]
    for kind in ("psum", "psum_bwd", "tp_reduce", "tp_copy_bwd", "loss",
                 "grad", "consistency", "replicated", "layout"):
        assert red.get(kind, 0) > 0, kind
    for kind in ("tp_gather", "tp_slice_bwd", "tp_slice_rows_bwd"):
        assert gat.get(kind, 0) > 0, kind
    # one gradient sum a train step (plain, fused); the tp job adds one of
    # each tp kind's collective
    assert red["grad"] == len(LEGS)


def _sliced(w, hx):
    """A tensor rank's EdgeWeights at phi_x width hx: the first hx of w3's
    columns, of b3 and of w4."""
    ws, b1, w2, b2, w3, b3, w4 = w
    return [ws, b1, w2, b2, np.ascontiguousarray(w3[:, :hx]),
            np.ascontiguousarray(b3[:, :hx]), np.ascontiguousarray(w4[:, :hx])]


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_fused_edge_layer_at_half_phi_x_width_matches_jax(dtype_name):
    """w3 [H, H/2]: the plain versions of both kernels (forward, and the
    backward through autograd) against JAX's fused_edge_layer and its VJP
    on the same sliced weights (in one jitted program), at 3 blocks of 512
    nodes, the least the kernels take."""
    row, col, ea, em, n, x, hr, hc, w = _setup(31, nb=3)
    w = _sliced(w, H // 2)
    rng = np.random.default_rng(32)
    gt = rng.normal(size=(n, 3)).astype(np.float32)
    ge = rng.normal(size=(n, H)).astype(np.float32)
    ja = J.build_edge_blocks(jnp.asarray(row), jnp.asarray(col),
                             jnp.asarray(ea), jnp.asarray(em), block=BLOCK,
                             n_nodes=n)

    def f(x_, hr_, hc_, w_):
        return J.fused_edge_layer(x_, hr_, hc_, *ja, J.EdgeWeights(*w_),
                                  BLOCK, dtype_name)

    @jax.jit
    def fwd_vjp(x_, hr_, hc_, w_, gt_, ge_):
        jo, vjp = jax.vjp(f, x_, hr_, hc_, w_)
        return jo, vjp((gt_, jnp.zeros_like(jo[1]), ge_))

    jo, jd = fwd_vjp(jnp.asarray(x), jnp.asarray(hr), jnp.asarray(hc),
                     tuple(map(jnp.asarray, w)), jnp.asarray(gt),
                     jnp.asarray(ge))
    want = [np.asarray(a) for a in (*jo, jd[0], jd[1], jd[2], *jd[3])]

    pa = PE.build_edge_blocks(*_t(row, col, ea, em), block=BLOCK, n_nodes=n)
    leaves = [a.requires_grad_() for a in _t(x, hr, hc, *w)]
    po = PE.fused_edge_layer(*leaves[:3], *pa, PE.EdgeWeights(*leaves[3:]),
                             BLOCK, dtype_name)
    loss = (po[0] * torch.from_numpy(gt)).sum() + (
        po[2] * torch.from_numpy(ge)).sum()
    grads = torch.autograd.grad(loss, leaves)
    got = [a.detach().numpy() for a in (*po, *grads)]
    tol = 1e-5 if dtype_name == "f32" else 2e-2
    names = ("trans_sum", "count", "ef_sum", "d_x", "d_hr", "d_hc", "dws",
             "db1", "dw2", "db2", "dw3", "db3", "dw4")
    assert got[names.index("dw3")].shape == (H, H // 2)
    for name, a, b in zip(names, want, got):
        assert a.shape == b.shape, name
        scale = float(np.abs(a).max())
        assert scale > 0, name
        err = float(np.abs(b - a).max())
        assert err <= tol * scale, f"{name}: {err:.3e} > {tol * scale:.3e}"


@pytest.mark.parametrize("hx", [H // 8, 12])
def test_kernel_wrappers_refuse_an_unsupported_phi_x_width(hx):
    """The kernels take HX in {H, H/2, H/4} (at least 8): any other w3
    width raises a ValueError naming that set before any launch (the
    wrappers check their inputs first, on any device)."""
    row, col, ea, em, n, x, hr, hc, w = _setup(33, nb=3)
    w = _sliced(w, hx)
    pa = PE.build_edge_blocks(*_t(row, col, ea, em), block=BLOCK, n_nodes=n)
    args = (*_t(x, hr, hc), *pa, PE.EdgeWeights(*_t(*w)))
    assert PE.phi_x_widths(H) == (16, 8)
    for call in (lambda: PE._fused_edge_layer_cuda(*args, BLOCK, "f32"),
                 lambda: PE._fused_edge_bwd_cuda(
                     *args, *_t(np.zeros((n, 3), np.float32),
                                np.zeros((n, H), np.float32)), BLOCK,
                     "f32")):
        with pytest.raises(ValueError, match=r"HX in \(16, 8\)"):
            call()
