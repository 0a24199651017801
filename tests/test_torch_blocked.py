"""The port's blocked edge ops (ops/blocked.py, device half) against the JAX
package's, whose Pallas kernels run in interpret mode here as in
tests/test_blocked.py; the blocked layout, pairing and loader; FastEGNN on a
blocked batch under both lowerings.

Tolerances:
  seg_sum     f32 1e-6 of each column's max |JAX sum| (the same exact
              products summed in another order); bf16 data at the JAX
              test's rtol 2e-2 against the f32 sum of the unrounded data.
  gathers     bitwise: one nonzero product per output, exact.
  layout      bitwise (index, mask, pairing, edges per block).
  plan        bitwise: a stable sort, integer offsets, and a degree that is
              an integer count in f32, equal to the JAX package's segment
              sum of the edge mask.
  FastEGNN    f32 1e-5 absolute on coordinates, gradients 1e-5 of the
              largest |JAX gradient|; bf16 2^-9 / 2^-7 (the port's stated
              bf16 bound, tests/test_torch_plain_egnn.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distegnn_tpu.data import loader as jloader
from distegnn_tpu.models.fast_egnn import FastEGNN as JaxFastEGNN
from distegnn_tpu.ops import blocked as jb
from distegnn_tpu.ops import graph as jgraph
from distegnn_tpu_torch import config as pconfig
from distegnn_tpu_torch import main as pmain
from distegnn_tpu_torch.convert import params_from_jax
from distegnn_tpu_torch.data import loader as ploader
from distegnn_tpu_torch.models.fast_egnn import FastEGNN
from distegnn_tpu_torch.ops import blocked as pb
from distegnn_tpu_torch.ops import graph as pgraph
from test_torch_graph import assert_batches_equal, plain_test_graph
from test_torch_plain_egnn import FLAGSHIP

# (n_nodes, real edges, block, tile): tests/test_blocked.py's two cases
CASES = [(1024, 6000, 256, 512), (256, 1500, 64, 128)]
TOL_SUM = 1e-6
ATOL, GRAD_TOL = 1e-5, 1e-5
BF16_ATOL, BF16_GRAD_TOL = 2 ** -9, 2 ** -7


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed, n_nodes, e, block, tile, feat=8):
    """A random blocked edge list (rows sorted, a tail of nodes without
    edges), its slots and [E, feat] data zero at the padding slots."""
    rng = np.random.default_rng(seed)
    row = np.sort(rng.integers(0, n_nodes - 77, e)).astype(np.int64)
    col = rng.integers(0, n_nodes, e).astype(np.int64)
    epb = -(-jb.max_block_degree(row, n_nodes, block) // tile) * tile
    ei, _, em = jb.blockify_edges(np.stack([row, col]), None, n_nodes, epb,
                                  block)
    slots = np.asarray(jb.slot_ids(jnp.asarray(ei[0])[None],
                                   jnp.asarray(em)[None], block, epb))
    data = np.zeros((ei.shape[1], feat), np.float32)
    data[em > 0] = rng.normal(size=(e, feat)).astype(np.float32)
    h = rng.normal(size=(n_nodes, feat)).astype(np.float32)
    return ei, em, epb, slots, data, h


def _close_cols(got, want, tol):
    """|got - want| <= tol x each column's max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).max(axis=-2, keepdims=True), 1e-30)
    err = (np.abs(got - want) / scale).max()
    assert err <= tol, f"{err:.3e} > {tol:.1e}"


@pytest.mark.parametrize("case", CASES)
def test_slot_ids_match_jax(case):
    n, e, block, tile = case
    ei, em, epb, slots, _, _ = _case(0, n, e, block, tile)
    got = pb.slot_ids(_t(ei[0])[None], _t(em)[None], block, epb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), slots)
    assert (got.numpy()[0][em == 0] == block).all()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_segment_sum_ref_matches_jax(case, dtype):
    n, e, block, tile = case
    _, _, _, slots, data, _ = _case(1, n, e, block, tile)
    jd = jnp.asarray(data)
    pd = _t(data)
    if dtype == "bf16":
        jd, pd = jd.astype(jnp.bfloat16), pd.to(torch.bfloat16)
    want = jb.blocked_segment_sum(jd[None], jnp.asarray(slots), n, block,
                                  tile)[0]
    got = pb.blocked_segment_sum_ref(pd[None], _t(slots), n, block, tile)[0]
    assert got.dtype == torch.float32
    if dtype == "f32":
        _close_cols(got.numpy(), want, TOL_SUM)
    else:
        exact = pb.blocked_segment_sum_ref(_t(data)[None], _t(slots), n,
                                           block, tile)[0]
        np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=2e-2,
                                   atol=2e-1)
        _close_cols(got.numpy(), want, TOL_SUM)


def _shuffled(slots, epb, seed):
    """The slots with each node block's order permuted (the plan's sort
    must then move every slot, and keep equal slots in edge order)."""
    rng = np.random.default_rng(seed)
    s = slots.reshape(slots.shape[0], -1, epb).copy()
    for b in range(s.shape[0]):
        for k in range(s.shape[1]):
            s[b, k] = s[b, k][rng.permutation(epb)]
    return s.reshape(slots.shape)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_blocked_plan_ref_is_a_stable_sort_with_jax_degree(case, shuffle):
    """blocked_plan_ref: perm is a stable argsort of each node block's slots
    (sentinels last), off the per-node ranges, and deg equals the JAX
    package's blocked_segment_sum of the edge mask (its in-degree, run in
    interpret mode) bitwise; both cases end in nodes without edges, the
    second in an all-sentinel block."""
    n, e, block, tile = case
    _, em, epb, slots, _, _ = _case(12, n, e, block, tile)
    if shuffle:
        perm_e = _shuffled(np.arange(slots.shape[1])[None], epb, 13)[0]
        slots, em = slots[:, perm_e], em[perm_e]
    nb = n // block
    if not shuffle and block == 64:
        assert (slots.reshape(nb, epb)[-1] == block).all()
    plan = pb.blocked_plan_ref(_t(slots), n, block)
    assert plan.perm.dtype == plan.off.dtype == torch.int32
    assert plan.deg.dtype == torch.float32 and plan.deg.shape == (1, n, 1)
    perm = plan.perm.numpy().reshape(nb, epb)
    off = plan.off.numpy().reshape(nb, block + 1)
    s = slots.reshape(nb, epb)
    key = np.where((s >= 0) & (s < block), s, block)
    for k in range(nb):
        np.testing.assert_array_equal(perm[k],
                                      np.argsort(key[k], kind="stable"))
        np.testing.assert_array_equal(
            off[k], np.searchsorted(key[k][perm[k]], np.arange(block + 1)))
    want = jb.blocked_segment_sum(jnp.asarray(em)[None, :, None],
                                  jnp.asarray(slots), n, block, tile)
    np.testing.assert_array_equal(plan.deg.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        plan.deg.numpy()[0, :, 0],
        (off[:, 1:] - off[:, :-1]).reshape(-1).astype(np.float32))
    # the dispatch runs the plain version on a CPU tensor
    again = pb.blocked_plan(_t(slots), n, block)
    for a, b in zip(again, plan):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_segment_sum_inorder_matches_jax(case, dtype):
    """The edge-order reference through the plan (the CUDA segment sum's
    summation order, which the card tests hold it to bit for bit) against
    the JAX package's segment sum: 1e-6 of each column's max, shuffled
    slots included; the CPU dispatch with a plan is the plain version."""
    n, e, block, tile = case
    _, _, epb, slots, data, _ = _case(14, n, e, block, tile)
    perm_e = _shuffled(np.arange(slots.shape[1])[None], epb, 15)[0]
    slots, data = slots[:, perm_e], data[perm_e]
    jd, pd = jnp.asarray(data), _t(data)
    if dtype == "bf16":
        jd, pd = jd.astype(jnp.bfloat16), pd.to(torch.bfloat16)
    want = jb.blocked_segment_sum(jd[None], jnp.asarray(slots), n, block,
                                  tile)[0]
    plan = pb.blocked_plan(_t(slots), n, block)
    got = pb.blocked_segment_sum_inorder(pd[None], plan, block)[0]
    assert got.dtype == torch.float32
    _close_cols(got.numpy(), want, TOL_SUM)
    with_plan = pb.blocked_segment_sum(pd[None], _t(slots), n, block, tile,
                                       plan)
    assert torch.equal(with_plan, pb.blocked_segment_sum_ref(
        pd[None], _t(slots), n, block, tile))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gather_ref_matches_jax_bitwise(case, dtype):
    n, e, block, tile = case
    ei, em, _, slots, _, h = _case(2, n, e, block, tile)
    jh, ph = jnp.asarray(h), _t(h)
    if dtype == "bf16":
        jh, ph = jh.astype(jnp.bfloat16), ph.to(torch.bfloat16)
    want = jb.blocked_gather(jh[None], jnp.asarray(slots), block, tile)[0]
    got = pb.blocked_gather_ref(ph[None], _t(slots), block, tile)[0]
    assert got.dtype == ph.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    # zero at every padding slot
    assert (got.float().numpy()[em == 0] == 0).all()


def _symmetric_case(seed, block, tile):
    """A blocked symmetric radius graph with its pairing."""
    g = plain_test_graph(seed, n=200, radius=0.25)
    ei = g["edge_index"].astype(np.int64)
    n_pad = -(-200 // block) * block
    epb = -(-jb.max_block_degree(np.sort(ei[0]), n_pad, block) // tile) * tile
    bei, _, em = jb.blockify_edges(ei, None, n_pad, epb, block)
    pair = jb.pairing_perm(bei)
    assert pair is not None
    slots = np.asarray(jb.slot_ids(jnp.asarray(bei[0])[None],
                                   jnp.asarray(em)[None], block, epb))
    return bei, em, pair, slots, n_pad, epb


@pytest.mark.parametrize("case", CASES)
def test_kernel_vjps_match_jax(case):
    """The autograd backwards of seg_sum (a gather: bitwise), gather (a
    seg_sum) and the paired column gather (permutation + seg_sum) against
    jax.vjp of the JAX ops."""
    n, e, block, tile = case
    _, _, _, slots, data, h = _case(3, n, e, block, tile)
    rng = np.random.default_rng(4)
    js, ps = jnp.asarray(slots), _t(slots)

    cot_n = rng.normal(size=(1, n, data.shape[1])).astype(np.float32)
    _, vjp = jax.vjp(lambda d: jb.blocked_segment_sum(d, js, n, block, tile),
                     jnp.asarray(data)[None])
    (want,) = vjp(jnp.asarray(cot_n))
    d = _t(data)[None].requires_grad_()
    (got,) = torch.autograd.grad(
        pb.blocked_segment_sum(d, ps, n, block, tile), d, _t(cot_n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    cot_e = rng.normal(size=(1,) + data.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda hh: jb.blocked_gather(hh, js, block, tile),
                     jnp.asarray(h)[None])
    (want,) = vjp(jnp.asarray(cot_e))
    ht = _t(h)[None].requires_grad_()
    (got,) = torch.autograd.grad(pb.blocked_gather(ht, ps, block, tile), ht,
                                 _t(cot_e))
    _close_cols(got.numpy()[0], np.asarray(want)[0], TOL_SUM)

    bei, em, pair, slots, n_pad, _ = _symmetric_case(5, block, tile)
    hs = rng.normal(size=(1, n_pad, 4)).astype(np.float32)
    cot = rng.normal(size=(1, bei.shape[1], 4)).astype(np.float32)
    col, pj = jnp.asarray(bei[1])[None], jnp.asarray(pair)[None]
    _, vjp = jax.vjp(lambda hh: jb.paired_col_gather(
        hh, col, pj, jnp.asarray(slots), block, tile), jnp.asarray(hs))
    (want,) = vjp(jnp.asarray(cot))
    ht = _t(hs).requires_grad_()
    out = pb.paired_col_gather(ht, _t(bei[1])[None], _t(pair)[None],
                               _t(slots), block, tile)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  hs[0][bei[1]][None])
    (got,) = torch.autograd.grad(out, ht, _t(cot))
    _close_cols(got.numpy()[0], np.asarray(want)[0], TOL_SUM)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_einsum_ops_match_jax(dtype):
    """The einsum lowering's ops and their custom backwards (the cotangent
    split into bf16 terms), forward and backward."""
    block, tile = 64, 128
    bei, em, pair, slots, n_pad, epb = _symmetric_case(6, block, tile)
    rng = np.random.default_rng(7)
    E = bei.shape[1]
    x = (rng.normal(size=(1, E, 8)) * em[None, :, None]).astype(np.float32)
    h = rng.normal(size=(1, n_pad, 8)).astype(np.float32)
    cot_n = rng.normal(size=(1, n_pad, 8)).astype(np.float32)
    cot_e = rng.normal(size=(1, E, 8)).astype(np.float32)
    joh = jb.onehot_blocks(jnp.asarray(slots), epb, block)
    poh = pb.onehot_blocks(_t(slots), epb, block)
    assert poh.dtype == torch.bfloat16
    np.testing.assert_array_equal(poh.float().numpy(),
                                  np.asarray(joh, np.float32))
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    pdt = torch.bfloat16 if dtype == "bf16" else torch.float32

    jx, jh = jnp.asarray(x).astype(jdt), jnp.asarray(h).astype(jdt)
    px = _t(x).to(pdt).requires_grad_()
    ph = _t(h).to(pdt).requires_grad_()
    col, pj = jnp.asarray(bei[1])[None], jnp.asarray(pair)[None]
    pcol, pp = _t(bei[1])[None], _t(pair)[None]

    for jfn, pfn, jin, pin, cot, bitwise in (
            (lambda a: jb.einsum_segment_sum(a, joh),
             lambda a: pb.einsum_segment_sum(a, poh), jx, px, cot_n, False),
            (lambda a: jb.einsum_gather(a, joh),
             lambda a: pb.einsum_gather(a, poh), jh, ph, cot_e, True),
            (lambda a: jax.vmap(jb._paired_gather_ein)(a, col, pj, joh),
             lambda a: pb.paired_gather_ein(a, pcol, pp, poh), jh, ph, cot_e,
             True)):
        want, vjp = jax.vjp(jfn, jin)
        got = pfn(pin)
        assert got.dtype == (torch.float32 if not bitwise else pdt)
        if bitwise:
            np.testing.assert_array_equal(got.detach().float().numpy(),
                                          np.asarray(want, np.float32))
        else:
            _close_cols(got.detach().numpy()[0], np.asarray(want)[0],
                        TOL_SUM)
        (wg,) = vjp(jnp.asarray(cot).astype(want.dtype))
        (gg,) = torch.autograd.grad(got, pin, _t(cot).to(got.dtype))
        assert gg.dtype == pdt
        _close_cols(gg.float().numpy()[0], np.asarray(wg, np.float32)[0],
                    TOL_SUM if dtype == "f32" else 2 ** -8)


@pytest.mark.parametrize("impl", ["pallas", "einsum"])
def test_blocked_slot_inv_deg_matches_jax(impl):
    graphs = [plain_test_graph(8, n=150, radius=0.25),
              plain_test_graph(9, n=230, radius=0.25)]
    jbatch = jgraph.pad_graphs([dict(g) for g in graphs], edge_block=256)
    pbatch = pgraph.pad_graphs([dict(g) for g in graphs], edge_block=256)
    js, jd, joh = jb.blocked_slot_inv_deg(jbatch, impl)
    ps, pd, poh, plan = pb.blocked_slot_inv_deg(pbatch, impl)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    assert (poh is None) == (joh is None) == (impl == "pallas")
    # the kernels' path takes its degree from the slots' plan
    assert (plan is not None) == (impl == "pallas")
    if plan is not None:
        np.testing.assert_array_equal(
            (1.0 / torch.clamp(plan.deg, min=1.0)).numpy(), np.asarray(jd))
    if poh is not None:
        np.testing.assert_array_equal(poh.float().numpy(),
                                      np.asarray(joh, np.float32))
    with pytest.raises(ValueError, match="unknown blocked impl"):
        pb.blocked_slot_inv_deg(pbatch, "xla")


def test_layout_checks_raise_as_in_jax():
    with pytest.raises(ValueError, match="not a multiple of block"):
        pb._layout(1024, 300, 256, 512)
    with pytest.raises(ValueError, match="not a multiple of num_blocks"):
        pb._layout(1001, 512, 256, 512)
    with pytest.raises(ValueError, match="not a multiple of tile"):
        pb._layout(2 * 640, 512, 256, 512)


@pytest.mark.parametrize("compute_pair", [None, True, False])
def test_pad_graphs_blocked_with_pairing_matches_jax(compute_pair):
    """The blocked layout and the pairing of its edge list (padding slots
    pair among themselves), bitwise; an asymmetric graph in the batch
    leaves the whole batch without a pairing, as in the JAX package."""
    graphs = [plain_test_graph(10, n=300, radius=0.2),
              plain_test_graph(11, n=420, radius=0.2)]
    jbatch = jgraph.pad_graphs([dict(g) for g in graphs], edge_block=256,
                               compute_pair=compute_pair)
    pbatch = pgraph.pad_graphs([dict(g) for g in graphs], edge_block=256,
                               compute_pair=compute_pair)
    assert_batches_equal(jbatch, pbatch, plain_pair=True)
    assert pbatch.edges_per_block == jbatch.edges_per_block
    assert (pbatch.edge_pair is not None) == (compute_pair is not False)
    if pbatch.edge_pair is not None:
        ei, pair = pbatch.edge_index.numpy(), pbatch.edge_pair.numpy()
        for b in range(2):
            np.testing.assert_array_equal(ei[b, 0][pair[b]], ei[b, 1])
    g = dict(graphs[0])
    keep = g["edge_index"][0] < g["edge_index"][1]
    g["edge_index"], g["edge_attr"] = (g["edge_index"][:, keep],
                                       g["edge_attr"][keep])
    assert pgraph.pad_graphs([g, dict(graphs[1])], edge_block=256,
                             compute_pair=compute_pair).edge_pair is None


def test_prepare_blocked_graph_repacks_like_jax():
    """A dict blocked under other parameters is re-packed from its real
    edges (the JAX package's behaviour; the port used to refuse)."""
    g = plain_test_graph(12, n=300, radius=0.2)
    deg = jb.max_block_degree(np.sort(g["edge_index"][0]), 512, 256)
    epb = -(-deg // 512) * 512
    ja = jb.prepare_blocked_graph(g, 512, epb, 256)
    pa = pb.prepare_blocked_graph(g, 512, epb, 256)
    for k in ("edge_index", "edge_attr", "_edge_mask", "_edge_pair"):
        np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)
    stamp = (768, epb + 512, 256)
    jr = jb.prepare_blocked_graph(ja, *stamp)
    pr = pb.prepare_blocked_graph(pa, *stamp)
    assert pr["_blockified"] == jr["_blockified"] == stamp
    for k in ("edge_index", "edge_attr", "_edge_mask", "_edge_pair"):
        np.testing.assert_array_equal(pr[k], jr[k], err_msg=k)
    assert int(pr["_edge_mask"].sum()) == g["edge_index"].shape[1]
    assert pb.prepare_blocked_graph(pr, *stamp) is pr


def test_blocked_loader_matches_jax_bitwise():
    """GraphLoader(edge_block=256) without split_remote: no 3-block floor,
    the pairing decided by the symmetry scan, every batch bitwise the JAX
    loader's; main.make_loaders builds it for a plain model."""
    graphs = [plain_test_graph(20 + i, n=180 + 40 * i, radius=0.25)
              for i in range(6)]
    jl = jloader.GraphLoader(jloader.GraphDataset([dict(g) for g in graphs]),
                             batch_size=2, shuffle=True, seed=3,
                             edge_block=256)
    pl = ploader.GraphLoader(ploader.GraphDataset([dict(g) for g in graphs]),
                             batch_size=2, shuffle=True, seed=3,
                             edge_block=256)
    assert pl.pairing is True and jl.pairing is True
    assert (pl.max_nodes, pl.edges_per_block, pl.max_edges) == (
        jl.max_nodes, jl.edges_per_block, jl.max_edges)
    assert pl.max_nodes == 512       # no 3-block floor without split_remote
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        for a, b in zip(jl, pl):
            assert_batches_equal(a, b, plain_pair=True)
            assert b.remote_edge_index is None

    cfg = pconfig.load_config(FLAGSHIP, {
        "data.edge_block": 256, "data.accelerate_mode": "cutoff_edges",
        "model.blocked_impl": "pallas"})
    ds = ploader.GraphDataset([dict(g) for g in graphs])
    for ld in pmain.make_loaders(cfg, ds, ds, ds):
        assert ld.edge_block == 256 and not ld.split_remote
        assert ld.pairing and ld.max_nodes == 512


# ------------------------------------------------------------- FastEGNN

H, L, C = 32, 2, 3


def _blocked_models(kw):
    graphs = [plain_test_graph(21, n=120, radius=0.3),
              plain_test_graph(22, n=90, radius=0.3)]
    jbatch = jgraph.pad_graphs([dict(g) for g in graphs], edge_block=256)
    pbatch = pgraph.pad_graphs([dict(g) for g in graphs], edge_block=256)
    assert pbatch.edge_pair is not None
    common = dict(node_feat_nf=2, edge_attr_nf=2, hidden_nf=H,
                  virtual_channels=C, n_layers=L, **kw)
    jm = JaxFastEGNN(**common)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(3),
                            jgraph.pad_graphs([dict(g) for g in graphs])))
    pm = FastEGNN(**common)
    pm.load_state_dict(params_from_jax(params))
    return jm, jbatch, params, pm, pbatch


def _loss_jax(jm, batch):
    mask = batch.node_mask[..., None]

    def loss(p):
        x, X = jm.apply(p, batch)
        return jnp.sum((x - batch.target) ** 2 * mask) + 0.1 * jnp.sum(X ** 2)

    return loss


def _loss_port(pm, batch):
    x, X = pm(batch)
    return (torch.sum((x - batch.target) ** 2 * batch.node_mask[..., None])
            + 0.1 * torch.sum(X ** 2))


@pytest.mark.parametrize("impl", ["pallas", "einsum"])
@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_fastegnn_blocked_matches_jax(impl, dtype):
    jm, jbatch, params, pm, pbatch = _blocked_models(
        dict(blocked_impl=impl, compute_dtype=dtype))
    jx, jX = jax.jit(jm.apply)(params, jbatch)
    jx, jX = np.asarray(jx), np.asarray(jX)
    jl, jg = jax.jit(jax.value_and_grad(_loss_jax(jm, jbatch)))(params)
    jl = float(jl)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    atol, gtol = (ATOL, GRAD_TOL) if dtype is None else (BF16_ATOL,
                                                         BF16_GRAD_TOL)
    with torch.no_grad():
        px, pX = pm(pbatch)
    mask = np.asarray(jbatch.node_mask) > 0
    np.testing.assert_allclose(px.numpy()[mask], jx[mask], rtol=0, atol=atol)
    np.testing.assert_allclose(pX.numpy(), jX, rtol=0, atol=atol)
    np.testing.assert_array_equal(px.numpy()[~mask], 0.0)

    pm.zero_grad(set_to_none=True)
    loss = _loss_port(pm, pbatch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jl,
                               rtol=1e-5 if dtype is None else 2 ** -7)
    got = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in pm.named_parameters()}
    assert want.keys() == got.keys()
    scale = max(float(np.abs(g.numpy()).max()) for g in want.values())
    for k in want:
        err = float(np.abs(want[k].numpy() - got[k].numpy()).max())
        assert err <= gtol * scale, f"{k}: {err:.3e} > {gtol * scale:.3e}"


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_fastegnn_blocked_remat_threads_one_plan(dtype):
    """blocked_impl='pallas' with remat (each layer checkpointed): one plan
    per forward, built before the layers and passed through checkpoint to
    every segment sum of the forward, its reruns and its backward; outputs
    and gradients match the JAX model's (remat too) at the tolerances of
    test_fastegnn_blocked_matches_jax."""
    from unittest import mock

    jm, jbatch, params, _, pbatch = _blocked_models(
        dict(blocked_impl="pallas", compute_dtype=dtype, remat=True))
    pm = FastEGNN(node_feat_nf=2, edge_attr_nf=2, hidden_nf=H,
                  virtual_channels=C, n_layers=L, blocked_impl="pallas",
                  compute_dtype=dtype, remat=True)
    pm.load_state_dict(params_from_jax(params))
    jx, jX = (np.asarray(a) for a in jax.jit(jm.apply)(params, jbatch))
    jl, jg = jax.jit(jax.value_and_grad(_loss_jax(jm, jbatch)))(params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    atol, gtol = (ATOL, GRAD_TOL) if dtype is None else (BF16_ATOL,
                                                         BF16_GRAD_TOL)
    plans, seg_plans = [], []
    plan_of, seg = pb._plan_impl, pb._seg_sum_impl

    def counted_plan(*a):
        plans.append(plan_of(*a))
        return plans[-1]

    def counted_seg(data, slot, n, block, tile, plan=None):
        seg_plans.append(plan)
        return seg(data, slot, n, block, tile, plan)

    with mock.patch.object(pb, "_plan_impl", counted_plan), \
            mock.patch.object(pb, "_seg_sum_impl", counted_seg):
        pm.zero_grad(set_to_none=True)
        x, X = pm(pbatch)
        loss = (torch.sum((x - pbatch.target) ** 2
                          * pbatch.node_mask[..., None])
                + 0.1 * torch.sum(X ** 2))
        loss.backward()
    assert len(plans) == 1
    # per layer 2 in the forward, 2 in its rerun, and the backward's
    assert len(seg_plans) > 4 * L
    assert all(p is plans[0] or (p is not None and all(
        torch.equal(a, b) for a, b in zip(p, plans[0]))) for p in seg_plans)
    mask = np.asarray(jbatch.node_mask) > 0
    np.testing.assert_allclose(x.detach().numpy()[mask], jx[mask], rtol=0,
                               atol=atol)
    np.testing.assert_allclose(X.detach().numpy(), jX, rtol=0, atol=atol)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=1e-5 if dtype is None else 2 ** -7)
    got = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in pm.named_parameters()}
    assert want.keys() == got.keys()
    scale = max(float(np.abs(g.numpy()).max()) for g in want.values())
    for k in want:
        err = float(np.abs(want[k].numpy() - got[k].numpy()).max())
        assert err <= gtol * scale, f"{k}: {err:.3e} > {gtol * scale:.3e}"


@pytest.mark.parametrize("impl", ["pallas", "einsum"])
@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_fastegnn_blocked_matches_plain_layout(impl, dtype):
    """The JAX package's test_fastegnn_blocked_parity in the port alone:
    the same graphs in the blocked and the plain layout give the same
    outputs and gradients (H=16, L=2, C=2; tolerances of that test)."""
    rng = np.random.default_rng(5)
    graphs = []
    for _ in range(2):
        loc = rng.normal(size=(300, 3)).astype(np.float32)
        vel = rng.normal(size=(300, 3)).astype(np.float32)
        d = np.linalg.norm(loc[:, None] - loc[None, :], axis=-1)
        row, col = np.nonzero((d < 1.2) & ~np.eye(300, dtype=bool))
        dist = d[row, col]
        graphs.append({
            "node_feat": np.linalg.norm(vel, axis=1, keepdims=True),
            "loc": loc, "vel": vel, "target": loc + 0.1 * vel,
            "edge_index": np.stack([row, col]).astype(np.int64),
            "edge_attr": np.repeat(dist[:, None], 2, axis=1).astype(
                np.float32)})
    plain = pgraph.pad_graphs([dict(g) for g in graphs])
    blocked = pgraph.pad_graphs([dict(g) for g in graphs], edge_block=256)
    assert blocked.edge_pair is not None
    model = FastEGNN(node_feat_nf=1, edge_attr_nf=2, hidden_nf=16,
                     virtual_channels=2, n_layers=2, compute_dtype=dtype,
                     blocked_impl=impl,
                     generator=torch.Generator().manual_seed(0))
    tol = 1e-5 if dtype is None else 5e-2
    with torch.no_grad():
        xp, Xp = model(plain)
        xb, Xb = model(blocked)
    n = plain.max_nodes
    np.testing.assert_allclose(
        (xb * blocked.node_mask[..., None])[:, :n].numpy(),
        (xp * plain.node_mask[..., None]).numpy(), atol=tol)
    np.testing.assert_allclose(Xb.numpy(), Xp.numpy(), atol=tol)

    def grads(batch):
        model.zero_grad(set_to_none=True)
        x, _ = model(batch)
        torch.sum((x - batch.target) ** 2
                  * batch.node_mask[..., None]).backward()
        return torch.cat([torch.zeros_like(p).reshape(-1) if p.grad is None
                          else p.grad.reshape(-1)
                          for p in model.parameters()])

    gp, gb = grads(plain), grads(blocked)
    scale = max(float(gp.abs().max()), 1.0)
    np.testing.assert_allclose((gb / scale).numpy(), (gp / scale).numpy(),
                               atol=5 * tol)


def test_one_state_dict_serves_both_layouts_and_lowerings():
    """blocked_impl changes no parameter: one converted state_dict serves
    the plain layout and both blocked lowerings (f32, 1e-5)."""
    jm, jbatch, params, pm, pbatch = _blocked_models({})
    sd = params_from_jax(params)
    outs = []
    plain = pgraph.pad_graphs([plain_test_graph(21, n=120, radius=0.3),
                               plain_test_graph(22, n=90, radius=0.3)])
    for impl, batch in (("einsum", plain), ("einsum", pbatch),
                        ("pallas", pbatch)):
        m = FastEGNN(node_feat_nf=2, edge_attr_nf=2, hidden_nf=H,
                     virtual_channels=C, n_layers=L, blocked_impl=impl)
        m.load_state_dict(sd)
        with torch.no_grad():
            x, X = m(batch)
        outs.append((x[:, :plain.max_nodes] * plain.node_mask[..., None],
                     X))
    for x, X in outs[1:]:
        np.testing.assert_allclose(x.numpy(), outs[0][0].numpy(), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(X.numpy(), outs[0][1].numpy(), rtol=0,
                                   atol=ATOL)
