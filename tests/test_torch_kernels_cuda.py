"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one (the kernels have no CPU
mode). This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

It also holds the small blocked-graph builder that the CPU tests of the
fused edge pipeline share.
"""

import numpy as np
import pytest
import torch

from distegnn_tpu_torch.ops import edge_pipeline as P

T = 512
H = 16


def _blocked_graph(rng, nb=5, fill=0.6, empty_tail_blocks=1):
    """Blocked-layout edge arrays: nb node blocks of T nodes, each owning a
    T-slot edge slice; ``fill`` of the slots hold real edges (rows inside
    the block, cols anywhere, so many are remote); the last
    ``empty_tail_blocks`` blocks get no real edges."""
    n_nodes, E = nb * T, nb * T
    row = np.zeros(E, np.int64)
    col = np.zeros(E, np.int64)
    emask = np.zeros(E, np.float32)
    for b in range(nb):
        sl = slice(b * T, (b + 1) * T)
        k = 0 if b >= nb - empty_tail_blocks else int(fill * T)
        row[sl] = np.sort(rng.integers(b * T, (b + 1) * T, size=T))
        col[sl] = rng.integers(0, n_nodes, size=T)
        emask[b * T: b * T + k] = 1.0
    ea = rng.normal(size=(E, 2)).astype(np.float32)
    return row, col, ea, emask, n_nodes


def _weights(rng):
    s = 0.3 / np.sqrt(H)
    return [(rng.normal(size=shape) * s).astype(np.float32)
            for shape in ((3, H), (1, H), (H, H), (1, H), (H, H), (1, H),
                          (1, H))]


def _setup(seed=7, **kw):
    rng = np.random.default_rng(seed)
    row, col, ea, em, n = _blocked_graph(rng, **kw)
    x = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    hr = (rng.normal(size=(n, H)) * 0.5).astype(np.float32)
    hc = (rng.normal(size=(n, H)) * 0.5).astype(np.float32)
    return row, col, ea, em, n, x, hr, hc, _weights(rng)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_fused_edge_kernel_matches_plain_version_on_card(dtype_name):
    """The CUDA kernel against fused_edge_layer_ref on the same card tensors
    (max error <= 2^-7 of each output's scale: both round per-edge features
    to bf16 at the same points; f32 summation order, and in bf16 mode
    single-ulp rounding flips of intermediates, differ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    row, col, ea, em, n, x, hr, hc, w = _setup(13)
    dev = torch.device("cuda")
    pa = [a.to(dev) for a in P.build_edge_blocks(*_t(row, col, ea, em),
                                                  block=T, n_nodes=n)]
    args = [a.to(dev) for a in _t(x, hr, hc)]
    wt = P.EdgeWeights(*[a.to(dev) for a in _t(*w)])
    before = P.fused_edge_layer.launches
    out = P.fused_edge_layer(*args, *pa, wt, T, dtype_name)
    torch.cuda.synchronize()
    assert P.fused_edge_layer.launches == before + 1
    ref = P.fused_edge_layer_ref(*args, *pa, wt, T, dtype_name)
    for a, b in zip(out, ref):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2 ** -7 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_fused_edge_bwd_kernel_matches_plain_version_on_card(dtype_name):
    """The backward kernel against fused_edge_layer_bwd_ref on the same card
    tensors, through the autograd Function (one forward and one backward
    launch). Max error <= 2^-7 of each output's scale (f32: summation order,
    the column side by atomics; bf16: single-ulp flips of intermediates)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    row, col, ea, em, n, x, hr, hc, w = _setup(17)
    rng = np.random.default_rng(18)
    gt = rng.normal(size=(n, 3)).astype(np.float32)
    ge = rng.normal(size=(n, H)).astype(np.float32)
    dev = torch.device("cuda")
    pa = [a.to(dev) for a in P.build_edge_blocks(*_t(row, col, ea, em),
                                                  block=T, n_nodes=n)]
    leaves = [a.to(dev).requires_grad_() for a in _t(x, hr, hc, *w)]
    gtd, ged = (a.to(dev) for a in _t(gt, ge))
    before = (P.fused_edge_layer.launches, P.fused_edge_layer.bwd_launches)
    trans, _, ef = P.fused_edge_layer(*leaves[:3], *pa,
                                      P.EdgeWeights(*leaves[3:]), T,
                                      dtype_name)
    grads = torch.autograd.grad((trans * gtd).sum() + (ef * ged).sum(),
                                leaves)
    torch.cuda.synchronize()
    assert (P.fused_edge_layer.launches,
            P.fused_edge_layer.bwd_launches) == (before[0] + 1, before[1] + 1)
    d_x, d_hr, d_hc, d_w = P.fused_edge_layer_bwd_ref(
        *[a.detach() for a in leaves[:3]], *pa,
        P.EdgeWeights(*[a.detach() for a in leaves[3:]]), gtd, ged, T,
        dtype_name)
    for a, b in zip(grads, (d_x, d_hr, d_hc, *d_w)):
        assert a.shape == b.shape
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2 ** -7 * scale


# ------------------------------------------------------------ prefix scan

def _scan_f64(x, reverse):
    """The exact scan (f64) and its scale: each column's max of the scan of
    |x|, the size of the prefixes the f32 rounding is relative to."""
    xd = x.double()
    if reverse:
        xd = xd.flip(-2)
    ref, scale = xd.cumsum(-2), xd.abs().cumsum(-2).amax(-2, keepdim=True)
    return (ref.flip(-2) if reverse else ref), scale.clamp(min=1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, E, F", [(1, 100, 5), (1, 4097, 1),
                                     (2, 9001, 3), (4, 12345, 68)])
def test_prefix_scan_kernel_matches_f64_and_plain_on_card(B, E, F, dtype,
                                                          reverse):
    """csrc/prefix_scan.cu in both directions: odd E (one tile, a ragged
    tail), F = 1 / 3 / 5 / 68, a batch axis, bf16 input widened to f32.
    Within 1e-5 of each column's max |prefix| of f64 (measured ~1e-8 on the
    H100: f32 rounding of a sequential carry), and of the plain version."""
    from distegnn_tpu_torch.ops import cumsum as CS

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(E + F)
    x = torch.randn((B, E, F), generator=gen, device="cuda").to(dtype)
    before = (CS.prefix_sum.launches, CS.prefix_sum.suffix_launches)
    out = CS._scan(x, reverse)
    torch.cuda.synchronize()
    after = (CS.prefix_sum.launches, CS.prefix_sum.suffix_launches)
    assert after == (before[0] + (not reverse), before[1] + reverse)
    assert out.dtype == torch.float32 and out.shape == x.shape
    ref, scale = _scan_f64(x, reverse)
    assert float(((out.double() - ref).abs() / scale).max()) <= 1e-5
    plain = CS.prefix_sum_ref(x, reverse)
    assert float(((out.double() - plain.double()).abs() / scale).max()) \
        <= 1e-5


@pytest.mark.cuda
def test_prefix_sum_backward_is_the_suffix_kernel_on_card():
    from distegnn_tpu_torch.ops import cumsum as CS

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((5000, 7), generator=gen, device="cuda").requires_grad_()
    w = torch.randn((5000, 7), generator=gen, device="cuda")
    before = (CS.prefix_sum.launches, CS.prefix_sum.suffix_launches)
    (g,) = torch.autograd.grad((CS.prefix_sum(x) * w).sum(), x)
    torch.cuda.synchronize()
    assert (CS.prefix_sum.launches, CS.prefix_sum.suffix_launches) == (
        before[0] + 1, before[1] + 1)
    ref, scale = _scan_f64(w, reverse=True)
    assert float(((g.double() - ref).abs() / scale).max()) <= 1e-5


@pytest.mark.cuda
def test_prefix_scan_kernel_rounds_no_worse_than_the_tpu_algorithm():
    """A positive stream, whose |prefix| grows with every row: the kernel
    keeps its running totals block-local and adds the (compensated) carry
    once per output, so its error against f64 stays within 2x of the plain
    version's (the TPU kernel's doubling scan plus tile carry)."""
    from distegnn_tpu_torch.ops import cumsum as CS

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((1, 600000, 68), generator=gen, device="cuda").abs()
    ref, scale = _scan_f64(x, reverse=False)
    err = float(((CS._scan(x, False).double() - ref).abs() / scale).max())
    perr = float(((CS.prefix_sum_ref(x).double() - ref).abs() / scale).max())
    assert err <= 2 * perr + 1e-9
