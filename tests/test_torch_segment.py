"""The port's prefix scan, segment lowerings, EdgeOps dispatch and plain
layout against the JAX package's, on the same numpy inputs (CPU: the scan
runs its plain version, ``prefix_sum_ref``).

Tolerances:
  scan vs the TPU kernel (interpret mode, the same tile)  1e-6 relative: the
      plain version follows ``_prefix_kernel``/``_suffix_kernel`` step by
      step (the same doubling adds in the same order).
  scan vs XLA's cumsum  the JAX test's own (tests/test_segment_cumsum.py):
      f32 rtol 1e-5 / atol 1e-4, bf16 input rtol 2e-2 / atol 1e-1.
  cumsum segment sums vs JAX  2e-5 absolute (unit-normal data, E=400: a sum
      is a difference of two f32 prefixes, each rounded at ~|prefix| * eps;
      the two sides round differently: doubling scan vs XLA's cumsum).
  ELL, scatter, gathers, backward gathers  1e-6 (the same f32 adds, in
      another order; the gathers are exact).
  layout (pairing, max_in_degree)  bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distegnn_tpu.ops import blocked as jblocked
from distegnn_tpu.ops import cumsum as jcumsum
from distegnn_tpu.ops import graph as jgraph
from distegnn_tpu.ops import segment as jseg
from distegnn_tpu_torch.ops import blocked as pblocked
from distegnn_tpu_torch.ops import cumsum as pcumsum
from distegnn_tpu_torch.ops import graph as pgraph
from distegnn_tpu_torch.ops import segment as pseg
from test_torch_graph import BLOCK, blocked_test_graph, plain_test_graph

E, N, F = 400, 37, 5
TOL_CS = 2e-5
TOL = 1e-6


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _seg_inputs(seed, B=None):
    rng = np.random.default_rng(seed)
    lead = (E,) if B is None else (B, E)
    ids = np.sort(rng.integers(0, N, size=lead), axis=-1).astype(np.int32)
    data = rng.standard_normal(lead + (F,)).astype(np.float32)
    mask = (rng.random(lead) < 0.8).astype(np.float32)
    cot = rng.standard_normal(lead[:-1] + (N, F)).astype(np.float32)
    return data, ids, mask, cot


# ------------------------------------------------------------------ scan

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rows", [5, 64, 71, 3 * 64 - 1])
def test_prefix_sum_ref_matches_the_tpu_kernel_and_xla(rows, reverse):
    """Tile 64 as the JAX test runs the kernel; the tile-boundary carry and
    the ragged tail in both directions."""
    x = np.random.default_rng(rows).standard_normal((rows, 3)).astype(
        np.float32)
    want_kernel = np.asarray(jcumsum._prefix_pallas(
        jnp.asarray(x), tile=min(rows, 64), reverse=reverse))
    xs = x[::-1] if reverse else x
    want_xla = np.asarray(jcumsum.prefix_sum(jnp.asarray(xs.copy()),
                                             impl="xla"))
    if reverse:
        want_xla = want_xla[::-1]
    got = pcumsum.prefix_sum_ref(torch.from_numpy(x), reverse,
                                 tile=min(rows, 64))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want_kernel, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(got), want_xla, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("reverse", [False, True])
def test_prefix_sum_ref_bf16_input_accumulates_in_f32(reverse):
    x = np.random.default_rng(3).standard_normal((100, 2)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jcumsum._prefix_pallas(xb, tile=32, reverse=reverse))
    got = pcumsum.prefix_sum_ref(torch.from_numpy(x).to(torch.bfloat16),
                                 reverse, tile=32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
    if not reverse:
        np.testing.assert_allclose(
            _np(got), np.asarray(jcumsum.prefix_sum(xb, impl="xla")),
            rtol=2e-2, atol=1e-1)


def test_prefix_sum_batched_equals_per_graph_under_vmap():
    """One call over [B, E, F] (one launch on the card) is the vmap of the
    JAX kernel over the B graphs."""
    x = np.random.default_rng(4).standard_normal((4, 130, 3)).astype(
        np.float32)
    want = np.asarray(jax.vmap(lambda a: jcumsum._prefix_pallas(a, tile=64))(
        jnp.asarray(x)))
    got = pcumsum.prefix_sum_ref(torch.from_numpy(x), tile=64)
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
    # the default tile (4096) and the public entry point agree with it
    np.testing.assert_allclose(_np(pcumsum.prefix_sum(torch.from_numpy(x))),
                               want, rtol=1e-5, atol=1e-5)


def test_prefix_sum_vjp_matches_the_jax_kernels_vjp(monkeypatch):
    """prefix and suffix are each other's VJPs, as the JAX custom VJPs of the
    Pallas path are (pinned to the kernel through the env switch)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((300, 4)).astype(np.float32)
    w = rng.standard_normal((300, 4)).astype(np.float32)
    monkeypatch.setenv("DISTEGNN_PREFIX_IMPL", "pallas")
    jv, jg = jax.value_and_grad(
        lambda a: (jcumsum.prefix_sum(a) * w).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    before = (pcumsum.prefix_sum.launches, pcumsum.prefix_sum.suffix_launches)
    v = (pcumsum.prefix_sum(xt) * torch.from_numpy(w)).sum()
    (g,) = torch.autograd.grad(v, xt)
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    # the suffix's own VJP is the prefix sum
    st = torch.from_numpy(x).requires_grad_()
    (gs,) = torch.autograd.grad((pcumsum.suffix_sum(st) * torch.from_numpy(
        w)).sum(), st)
    np.testing.assert_allclose(gs.numpy(), np.cumsum(w, axis=0), rtol=1e-5,
                               atol=1e-5)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert (pcumsum.prefix_sum.launches,
            pcumsum.prefix_sum.suffix_launches) == before


def test_prefix_sum_refuses_other_shapes():
    with pytest.raises(ValueError, match="prefix_sum takes"):
        pcumsum.prefix_sum(torch.zeros(2, 3, 4, 5))


# ------------------------------------------------------- segment lowerings

@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_segment_sum_and_mean_cs_match_jax_fwd_and_bwd(with_mask, batched):
    data, ids, mask, cot = _seg_inputs(6, B=3 if batched else None)
    m = mask if with_mask else None

    def jfn(fn):
        ms = np.ones_like(mask) if m is None else m

        def f(d, i, mm):
            return fn(d, i, N, mask=None if m is None else mm)

        f = jax.vmap(f) if batched else f
        return lambda d: f(d, jnp.asarray(ids), jnp.asarray(ms))

    for jf, pf in ((jseg.segment_sum_cs, pseg.segment_sum_cs),
                   (jseg.segment_mean_cs, pseg.segment_mean_cs)):
        want, vjp = jax.vjp(jfn(jf), jnp.asarray(data))
        (want_g,) = vjp(jnp.asarray(cot))
        dt = torch.from_numpy(data).requires_grad_()
        got = pf(dt, torch.from_numpy(ids), N,
                 mask=None if m is None else torch.from_numpy(m))
        (got_g,) = torch.autograd.grad(got, dt, torch.from_numpy(cot))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=TOL_CS)
        # the backward is a gather: exact
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                   rtol=0, atol=TOL)


def test_segment_sum_cs_empty_and_boundary_segments():
    ids = np.full(20, 3, np.int32)
    data = np.random.default_rng(7).standard_normal((20, 2)).astype(
        np.float32)
    got = _np(pseg.segment_sum_cs(torch.from_numpy(data),
                                  torch.from_numpy(ids), 7))
    np.testing.assert_allclose(got, np.asarray(jseg.segment_sum_cs(
        jnp.asarray(data), jnp.asarray(ids), 7)), atol=1e-5)
    assert np.abs(got[[0, 1, 2, 4, 5, 6]]).max() == 0.0


@pytest.mark.parametrize("with_mask", [False, True])
def test_segment_sum_and_mean_ell_match_jax_fwd_and_bwd(with_mask):
    data, ids, mask, cot = _seg_inputs(8)
    m = mask if with_mask else None
    dmax = int(np.bincount(ids, minlength=N).max())
    for jf, pf in ((jseg.segment_sum_ell, pseg.segment_sum_ell),
                   (jseg.segment_mean_ell, pseg.segment_mean_ell)):
        for D in (dmax, dmax + 5):
            want, vjp = jax.vjp(lambda d: jf(
                d, jnp.asarray(ids), N, D,
                mask=None if m is None else jnp.asarray(m)),
                jnp.asarray(data))
            (want_g,) = vjp(jnp.asarray(cot))
            dt = torch.from_numpy(data).requires_grad_()
            got = pf(dt, torch.from_numpy(ids), N, D,
                     mask=None if m is None else torch.from_numpy(m))
            (got_g,) = torch.autograd.grad(got, dt, torch.from_numpy(cot))
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                       atol=TOL)
            np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                       rtol=0, atol=TOL)


def test_segment_mean_matches_jax():
    data, ids, mask, _ = _seg_inputs(9)
    want = jseg.segment_mean(jnp.asarray(data), jnp.asarray(ids), N,
                             mask=jnp.asarray(mask))
    got = pseg.segment_mean(torch.from_numpy(data), torch.from_numpy(ids), N,
                            mask=torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)


# ------------------------------------------------------------- the layout

def _paired_graphs():
    return [plain_test_graph(11, n=120, radius=0.3),
            plain_test_graph(12, n=90, radius=0.3)]


def test_pad_graphs_pairing_and_in_degree_are_bitwise_the_jax_ones():
    graphs = _paired_graphs()
    jb = jgraph.pad_graphs(graphs, compute_pair=True)
    pb = pgraph.pad_graphs(graphs, compute_pair=True)
    assert pb.edge_pair is not None and pb.edges_sorted
    np.testing.assert_array_equal(pb.edge_pair.numpy(),
                                  np.asarray(jb.edge_pair))
    assert pb.edge_pair.dtype == torch.int32
    assert pb.max_in_degree == jb.max_in_degree > 0
    for b in range(pb.batch_size):
        r, c, p = (pb.row[b].numpy(), pb.col[b].numpy(),
                   pb.edge_pair[b].numpy())
        np.testing.assert_array_equal(r[p], c)
        np.testing.assert_array_equal(c[p], r)
    # each graph's pairing is cached on its dict
    assert all("_plain_pair" in g for g in graphs)
    # a loader's dataset-stable degree is kept, an undersized one refused
    kw = dict(compute_pair=True, max_in_degree=jb.max_in_degree + 8)
    assert pgraph.pad_graphs(graphs, **kw).max_in_degree == \
        jgraph.pad_graphs(graphs, **kw).max_in_degree
    with pytest.raises(ValueError, match="max_in_degree"):
        pgraph.pad_graphs(graphs, compute_pair=True, max_in_degree=1)
    # scatter-only batches carry neither
    plain = pgraph.pad_graphs(graphs)
    assert plain.edge_pair is None and plain.max_in_degree == 0


def test_pairing_perm_of_an_asymmetric_graph_is_none():
    ei = blocked_test_graph(0, n_real=BLOCK)["edge_index"]
    assert jblocked.pairing_perm(ei) is None
    assert pblocked.pairing_perm_fast(ei) is None
    sym = plain_test_graph(13)["edge_index"]
    np.testing.assert_array_equal(pblocked.pairing_perm_fast(sym),
                                  jblocked.pairing_perm_fast(sym))
    jb = jgraph.pad_graphs([blocked_test_graph(0, n_real=BLOCK)],
                           compute_pair=True)
    pb = pgraph.pad_graphs([blocked_test_graph(0, n_real=BLOCK)],
                           compute_pair=True)
    assert pb.edge_pair is None and jb.edge_pair is None
    assert pb.max_in_degree == jb.max_in_degree


# ---------------------------------------------------------------- EdgeOps

def _edgeops_pair(seg_impl, pair=True):
    graphs = _paired_graphs()
    jb = jgraph.pad_graphs(graphs, compute_pair=pair)
    pb = pgraph.pad_graphs(graphs, compute_pair=pair)
    return (jblocked.EdgeOps(jb, seg_impl=seg_impl),
            pblocked.EdgeOps(pb, seg_impl=seg_impl), jb, pb)


@pytest.mark.parametrize("seg_impl", ["scatter", "cumsum", "ell"])
def test_edgeops_lowering_choice_matches_jax(seg_impl):
    for pair in (True, False):
        jops, pops, _, _ = _edgeops_pair(seg_impl, pair)
        assert (pops.cumsum, pops.ell) == (jops.cumsum, jops.ell)
    # an unsorted batch keeps the exact scatter path
    _, pops, _, pb = _edgeops_pair(seg_impl)
    pb.edges_sorted = False
    ops = pblocked.EdgeOps(pb, seg_impl=seg_impl)
    assert not (ops.cumsum or ops.ell)


@pytest.mark.parametrize("seg_impl", ["scatter", "cumsum", "ell"])
def test_edgeops_aggregations_match_jax(seg_impl):
    jops, pops, jb, pb = _edgeops_pair(seg_impl)
    B, Ep = pb.row.shape
    rng = np.random.default_rng(14)
    a = rng.standard_normal((B, Ep, 3)).astype(np.float32)
    b = rng.standard_normal((B, Ep, 8)).astype(np.float32)
    tol = TOL_CS if seg_impl == "cumsum" else TOL
    for name in ("agg_rows_sum", "agg_rows_mean"):
        np.testing.assert_allclose(
            _np(getattr(pops, name)(torch.from_numpy(b))),
            np.asarray(getattr(jops, name)(jnp.asarray(b))), rtol=0,
            atol=tol)
    for a_mean in (False, True):
        for agg_dtype in (None, "bf16"):
            want = jops.agg_rows_pair(jnp.asarray(a), jnp.asarray(b), a_mean,
                                      agg_dtype=agg_dtype)
            got = pops.agg_rows_pair(torch.from_numpy(a), torch.from_numpy(b),
                                     a_mean, agg_dtype=agg_dtype)
            for x, y in zip(got, want):
                assert x.dtype == torch.float32
                # a bf16 stream: the scatter-free lowerings return their
                # sums in the stream's type on both sides, so an f32
                # rounding difference can flip one bf16 ulp (2^-7 relative)
                rtol = 2 ** -7 if agg_dtype and seg_impl != "scatter" else 0
                np.testing.assert_allclose(_np(x), np.asarray(y), rtol=rtol,
                                           atol=tol)


@pytest.mark.parametrize("seg_impl", ["scatter", "cumsum", "ell"])
def test_edgeops_gathers_match_jax_fwd_and_bwd(seg_impl):
    """Forward gathers are exact; their backward is the lowering's segment
    sum (cumsum: the scan), the column one through the pairing."""
    jops, pops, jb, pb = _edgeops_pair(seg_impl)
    B, Ep = pb.row.shape
    rng = np.random.default_rng(15)
    h = rng.standard_normal((B, pb.max_nodes, F)).astype(np.float32)
    # cotangents zero on padded edges, as the model's are
    cot = (rng.standard_normal((B, Ep, F))
           * pb.edge_mask.numpy()[..., None]).astype(np.float32)
    tol = TOL_CS if seg_impl == "cumsum" else TOL
    for name in ("gather_rows", "gather_cols"):
        want, vjp = jax.vjp(getattr(jops, name), jnp.asarray(h))
        (want_g,) = vjp(jnp.asarray(cot))
        ht = torch.from_numpy(h).requires_grad_()
        got = getattr(pops, name)(ht)
        (got_g,) = torch.autograd.grad(got, ht, torch.from_numpy(cot))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("kind", ["cs", "ell"])
def test_row_and_paired_col_gathers_backward_match_jax_vjp(kind):
    """The single-graph custom-VJP gathers of ops/segment.py."""
    graphs = _paired_graphs()
    jb = jgraph.pad_graphs(graphs[:1], compute_pair=True)
    pb = pgraph.pad_graphs(graphs[:1], compute_pair=True)
    D = pb.max_in_degree
    rng = np.random.default_rng(16)
    h = rng.standard_normal((1, pb.max_nodes, F)).astype(np.float32)
    em = pb.edge_mask.numpy()
    cot = (rng.standard_normal((1, pb.max_edges, F))
           * em[..., None]).astype(np.float32)
    r, c, p = (np.asarray(jb.row[0]), np.asarray(jb.col[0]),
               np.asarray(jb.edge_pair[0]))
    if kind == "cs":
        jr = lambda a: jseg.gather_rows_cs(a, r)                  # noqa: E731
        jc = lambda a: jseg.paired_gather_cols_cs(a, c, p, r, em[0])  # noqa
        pr = lambda a: pseg.gather_rows_cs(a, pb.row)             # noqa: E731
        pc = lambda a: pseg.paired_gather_cols_cs(                # noqa: E731
            a, pb.col, pb.edge_pair, pb.row, pb.edge_mask)
        tol = TOL_CS
    else:
        jr = lambda a: jseg.gather_rows_ell(a, r, D)              # noqa: E731
        jc = lambda a: jseg.paired_gather_cols_ell(a, c, p, r, em[0], D)  # noqa
        pr = lambda a: pseg.gather_rows_ell(a, pb.row, D)         # noqa: E731
        pc = lambda a: pseg.paired_gather_cols_ell(               # noqa: E731
            a, pb.col, pb.edge_pair, pb.row, pb.edge_mask, D)
        tol = TOL
    for jf, pf in ((jr, pr), (jc, pc)):
        _, vjp = jax.vjp(jf, jnp.asarray(h[0]))
        (want_g,) = vjp(jnp.asarray(cot[0]))
        ht = torch.from_numpy(h).requires_grad_()
        (got_g,) = torch.autograd.grad(pf(ht), ht, torch.from_numpy(cot))
        np.testing.assert_allclose(got_g[0].numpy(), np.asarray(want_g),
                                   rtol=0, atol=tol)


def test_edgeops_refuses_a_blocked_batch_and_names_slice_5():
    """Refused until port slice 5; now a blocked batch takes the blocked
    branches (as in the JAX package the cumsum and ELL lowerings stay off
    there), whose row gather is h[row] with 0 at the padding slots."""
    pb = pgraph.pad_graphs([blocked_test_graph(0, n_real=BLOCK)],
                           edge_block=BLOCK)
    slot, inv_deg, oh, plan = pblocked.blocked_slot_inv_deg(pb, "pallas")
    ops = pblocked.EdgeOps(pb, slot, inv_deg, oh, plan, seg_impl="cumsum")
    assert ops.blocked and not ops.cumsum and not ops.ell
    h = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, pb.max_nodes, 4)).astype(np.float32))
    want = pseg.take_rows(h, pb.row) * pb.edge_mask[..., None]
    assert torch.equal(ops.gather_rows(h), want)
