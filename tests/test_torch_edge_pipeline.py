"""The port's fused edge pipeline (distegnn_tpu_torch/ops/edge_pipeline.py)
against the JAX package's: the kernel layout and the remote split must be
equal, and the plain PyTorch version ``fused_edge_layer_ref`` must compute
what the JAX ``fused_edge_layer`` computes (its Pallas kernel run in
interpret mode, as the JAX package's own tests run it on the CPU).

Tolerances:
  f32  — |port - jax| <= 1e-5 * max|jax| + 1e-5 * |jax| per element: the
         roundings are the same (bf16 hi+lo translations, bf16 edge
         features, f32 sums), only the summation order differs.
  bf16 — |port - jax| <= 2e-2 * max|jax|: the MLPs round every intermediate
         to bf16, and XLA on the CPU keeps excess precision inside fused
         elementwise chains where PyTorch rounds each op, so single bf16
         ulps (2^-8 relative) of per-edge features differ (the JAX package's
         own bf16-stream tolerance, tests/test_edge_pipeline.py).
The CUDA kernel itself is compared with the plain version on the card in
tests/test_torch_kernels_cuda.py.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distegnn_tpu.ops import edge_pipeline as J
from distegnn_tpu_torch.ops import edge_pipeline as P
from test_torch_kernels_cuda import T, _setup, _t


@pytest.mark.parametrize("empty_tail_blocks", [0, 2])
def test_build_edge_blocks_matches_jax(empty_tail_blocks):
    row, col, ea, em, n, *_ = _setup(3, empty_tail_blocks=empty_tail_blocks)
    ja = J.build_edge_blocks(jnp.asarray(row), jnp.asarray(col),
                             jnp.asarray(ea), jnp.asarray(em), block=T,
                             n_nodes=n)
    pa = P.build_edge_blocks(*_t(row, col, ea, em), block=T, n_nodes=n)
    for a, b, name in zip(ja, pa, ("row_t", "col_l", "kblk", "scal")):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


def test_build_edge_blocks_batched_equals_per_graph():
    gs = [_setup(s)[:5] for s in (1, 2)]
    stacked = [torch.stack(_t(*[g[i] for g in gs])) for i in range(4)]
    batched = P.build_edge_blocks(*stacked, block=T, n_nodes=gs[0][4])
    for b, g in enumerate(gs):
        single = P.build_edge_blocks(*_t(*g[:4]), block=T, n_nodes=g[4])
        for x, y in zip(batched, single):
            assert torch.equal(x[b], y)


def test_remote_split_matches_jax_and_partitions_edges():
    row, col, ea, em, n, *_ = _setup(5)
    real = em > 0
    ei = np.stack([row[real], col[real]])
    outs_j = J.split_remote_edges(ei, ea[real], block=T, n_nodes=n)
    outs_p = P.split_remote_edges(ei, ea[real], block=T, n_nodes=n)
    for a, b in zip(outs_j, outs_p):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # every real edge is in-window (kernel mask) XOR remote
    scal = P.build_edge_blocks(*_t(row, col, ea, em), block=T, n_nodes=n)[3]
    n_window = int((scal[:, 2] > 0).sum())
    n_remote = int(outs_p[2].sum())
    assert n_window > 0 and n_remote > 0
    assert n_window + n_remote == int(real.sum())


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_fused_edge_layer_ref_matches_jax(dtype_name):
    row, col, ea, em, n, x, hr, hc, w = _setup(7)
    ja = J.build_edge_blocks(jnp.asarray(row), jnp.asarray(col),
                             jnp.asarray(ea), jnp.asarray(em), block=T,
                             n_nodes=n)
    jo = J.fused_edge_layer(jnp.asarray(x), jnp.asarray(hr), jnp.asarray(hc),
                            *ja, J.EdgeWeights(*map(jnp.asarray, w)), T,
                            dtype_name)
    pa = P.build_edge_blocks(*_t(row, col, ea, em), block=T, n_nodes=n)
    po = P.fused_edge_layer(*_t(x, hr, hc), *pa, P.EdgeWeights(*_t(*w)), T,
                            dtype_name)
    for a, b, name in zip(jo, po, ("trans_sum", "count", "ef_sum")):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        scale = float(np.abs(a).max())
        assert scale > 0, name
        if dtype_name == "f32":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=2e-2 * scale,
                                       err_msg=name)


def test_fused_edge_layer_cpu_runs_plain_version_without_launch():
    row, col, ea, em, n, x, hr, hc, w = _setup(9)
    pa = P.build_edge_blocks(*_t(row, col, ea, em), block=T, n_nodes=n)
    before = P.fused_edge_layer.launches
    out = P.fused_edge_layer(*_t(x, hr, hc), *pa, P.EdgeWeights(*_t(*w)), T,
                             "f32")
    ref = P.fused_edge_layer_ref(*_t(x, hr, hc), *pa, P.EdgeWeights(*_t(*w)),
                                 T, "f32")
    assert P.fused_edge_layer.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_fused_edge_layer_rejects_other_devices_and_small_grids():
    row, col, ea, em, n, x, hr, hc, w = _setup(11)
    pa = P.build_edge_blocks(*_t(row, col, ea, em), block=T, n_nodes=n)
    wt = P.EdgeWeights(*_t(*w))
    meta = [a.to("meta") for a in _t(x, hr, hc)]
    with pytest.raises(ValueError, match="unsupported device"):
        P.fused_edge_layer(*meta, *pa, wt, T, "f32")
    small = _t(x[:2 * T], hr[:2 * T], hc[:2 * T])
    with pytest.raises(ValueError, match="3 node blocks"):
        P.fused_edge_layer(*small, *pa, wt, T, "f32")
    with pytest.raises(ValueError, match="OH_CHUNK"):
        P.build_edge_blocks(*_t(row, col, ea, em), block=256, n_nodes=n)
