"""The backward of the port's fused edge layer against the JAX package's.

``fused_edge_layer_bwd_ref`` (the plain PyTorch version of the backward
kernel) is held against ``jax.vjp`` of the JAX ``fused_edge_layer``, whose
custom VJP runs the Pallas backward kernel in interpret mode on the CPU, at
N=2048 (4 blocks of 512, the last without edges): the smallest grid with a
remote tail, since at 3 blocks every window covers the whole graph.

Tolerances, relative to each output's max |jax| ("scale"):
  f32  — 1e-5 * scale: the roundings are the same (bf16 hi+lo of d_cd, bf16
         per-edge d_t1 payload, f32 sums); only the summation order of the
         sums and products differs.
  bf16 — 2e-2 * scale: the JAX package's own bound for the fused layer's
         gradients (tests/test_edge_pipeline.py); XLA on the CPU keeps excess
         precision inside fused bf16 elementwise chains where PyTorch rounds
         every op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distegnn_tpu.ops import edge_pipeline as J
from distegnn_tpu_torch.ops import edge_pipeline as P
from test_torch_kernels_cuda import T, _setup, _t

NAMES = ("d_x", "d_hr", "d_hc", "dws", "db1", "dw2", "db2", "dw3", "db3",
         "dw4")


def _cotangents(seed, n, h):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, h)).astype(np.float32))


def _jax_grads(row, col, ea, em, n, x, hr, hc, w, gt, ge, dtype_name):
    arrs = J.build_edge_blocks(jnp.asarray(row), jnp.asarray(col),
                               jnp.asarray(ea), jnp.asarray(em), block=T,
                               n_nodes=n)

    def f(x_, hr_, hc_, w_):
        return J.fused_edge_layer(x_, hr_, hc_, *arrs, J.EdgeWeights(*w_), T,
                                  dtype_name)

    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(hr), jnp.asarray(hc),
                       tuple(map(jnp.asarray, w)))
    dx, dhr, dhc, dw = vjp((jnp.asarray(gt), jnp.zeros_like(out[1]),
                            jnp.asarray(ge)))
    return [np.asarray(a) for a in (dx, dhr, dhc, *dw)]


def _port_grads(row, col, ea, em, n, x, hr, hc, w, gt, ge, dtype_name):
    pa = P.build_edge_blocks(*_t(row, col, ea, em), block=T, n_nodes=n)
    d_x, d_hr, d_hc, d_w = P.fused_edge_layer_bwd_ref(
        *_t(x, hr, hc), *pa, P.EdgeWeights(*_t(*w)), *_t(gt, ge), T,
        dtype_name)
    return [a.numpy() for a in (d_x, d_hr, d_hc, *d_w)]


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_bwd_ref_matches_jax_vjp(dtype_name):
    row, col, ea, em, n, x, hr, hc, w = _setup(21, nb=4, empty_tail_blocks=1)
    assert n == 4 * T
    gt, ge = _cotangents(22, n, hr.shape[1])
    want = _jax_grads(row, col, ea, em, n, x, hr, hc, w, gt, ge, dtype_name)
    got = _port_grads(row, col, ea, em, n, x, hr, hc, w, gt, ge, dtype_name)
    # the graph has a remote tail: some real edges are outside the window
    scal = P.build_edge_blocks(*_t(row, col, ea, em), block=T, n_nodes=n)[3]
    assert 0 < int((scal[:, 2] > 0).sum()) < int(em.sum())
    tol = 1e-5 if dtype_name == "f32" else 2e-2
    for name, a, b in zip(NAMES, want, got):
        assert a.shape == b.shape, name
        scale = float(np.abs(a).max())
        assert scale > 0, name
        err = float(np.abs(b - a).max())
        assert err <= tol * scale, f"{name}: {err:.3e} > {tol * scale:.3e}"


def test_autograd_function_on_cpu_equals_bwd_ref_without_launch():
    row, col, ea, em, n, x, hr, hc, w = _setup(23)
    gt, ge = _cotangents(24, n, hr.shape[1])
    pa = P.build_edge_blocks(*_t(row, col, ea, em), block=T, n_nodes=n)
    leaves = [a.requires_grad_() for a in _t(x, hr, hc, *w)]
    before = (P.fused_edge_layer.launches, P.fused_edge_layer.bwd_launches)
    trans, count, ef = P.fused_edge_layer(
        *leaves[:3], *pa, P.EdgeWeights(*leaves[3:]), T, "f32")
    assert not count.requires_grad
    loss = (trans * torch.from_numpy(gt)).sum() + (
        ef * torch.from_numpy(ge)).sum()
    grads = torch.autograd.grad(loss, leaves)
    assert (P.fused_edge_layer.launches,
            P.fused_edge_layer.bwd_launches) == before
    d_x, d_hr, d_hc, d_w = P.fused_edge_layer_bwd_ref(
        *_t(x, hr, hc), *pa, P.EdgeWeights(*_t(*w)), *_t(gt, ge), T, "f32")
    for name, a, b in zip(NAMES, grads, (d_x, d_hr, d_hc, *d_w)):
        assert a.shape == b.shape, name
        assert torch.equal(a, b), name


def test_weight_views_receive_their_gradients():
    """Views of one parameter (the fused layer's ws is a slice of w1, b1 and
    w4 reshapes) carry their gradients back to it."""
    row, col, ea, em, n, x, hr, hc, w = _setup(25)
    pa = P.build_edge_blocks(*_t(row, col, ea, em), block=T, n_nodes=n)
    H = hr.shape[1]
    w1 = torch.nn.Parameter(torch.randn(2 * H + 3, H,
                                        generator=torch.Generator().manual_seed(0)))
    w4 = torch.nn.Parameter(torch.from_numpy(w[6].T.copy()))     # [H, 1]
    ew = P.EdgeWeights(w1[2 * H:], *_t(*w[1:6]), w4.T)
    trans, _, ef = P.fused_edge_layer(*_t(x, hr, hc), *pa, ew, T, "f32")
    (trans.sum() + ef.sum()).backward()
    assert w1.grad is not None and w4.grad is not None
    assert torch.count_nonzero(w1.grad[:2 * H]) == 0
    assert torch.count_nonzero(w1.grad[2 * H:]) > 0
    assert w4.grad.shape == (H, 1) and torch.count_nonzero(w4.grad) > 0
