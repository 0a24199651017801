"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one (the kernels have no CPU
mode). This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

It also holds the small blocked-graph builder that the CPU tests of the
fused edge pipeline share.
"""

import contextlib

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


def _bwd_case(Hn, seed, nb=5):
    """A blocked graph of nb node blocks at hidden width Hn for the bf16
    backward kernel: block 0's first 100 edges share one receiver (whole
    tiles of a single row segment), each block's slice ends in padding (a
    ragged tile, then fully inactive tiles) and the last block has no edges
    at all; bf16 hr / hc, f32 weights and cotangents."""
    rng = np.random.default_rng(seed)
    row, col, ea, em, n = _blocked_graph(rng, nb=nb, fill=0.55)
    row[:100] = row[0]
    x = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    hr = (rng.normal(size=(n, Hn)) * 0.5).astype(np.float32)
    hc = (rng.normal(size=(n, Hn)) * 0.5).astype(np.float32)
    s = 0.3 / np.sqrt(Hn)
    w = [(rng.normal(size=shape) * s).astype(np.float32)
         for shape in ((3, Hn), (1, Hn), (Hn, Hn), (1, Hn), (Hn, Hn),
                       (1, Hn), (1, Hn))]
    gt = rng.normal(size=(n, 3)).astype(np.float32)
    ge = rng.normal(size=(n, Hn)).astype(np.float32)
    return row, col, ea, em, n, x, hr, hc, w, gt, ge


@pytest.mark.cuda
@pytest.mark.parametrize("Hn", [16, 32, 64])
def test_fused_edge_bwd_tensor_core_kernel_on_card(Hn):
    """The bf16 backward (the tensor-core kernel) against
    fused_edge_layer_bwd_ref at every width the wrapper takes, over a ragged
    last tile, fully inactive tiles and tiles of one receiver: all ten
    outputs within 2^-7 of their scale (the bf16 bound above), one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    row, col, ea, em, n, x, hr, hc, w, gt, ge = _bwd_case(Hn, 40 + Hn)
    dev = torch.device("cuda")
    pa = [a.to(dev) for a in P.build_edge_blocks(*_t(row, col, ea, em),
                                                  block=T, n_nodes=n)]
    scal = pa[3]
    tiles = scal[:, 2].reshape(-1, 64) > 0
    assert (~tiles.any(1)).any() and (tiles.any(1) & ~tiles.all(1)).any()
    xd, hrd, hcd, gtd, ged = (a.to(dev) for a in _t(x, hr, hc, gt, ge))
    hrd, hcd = hrd.to(torch.bfloat16), hcd.to(torch.bfloat16)
    wt = P.EdgeWeights(*[a.to(dev) for a in _t(*w)])
    args = (xd, hrd, hcd, *pa, wt, gtd, ged, T, "bf16")
    before = P.fused_edge_layer.bwd_launches
    out = P._fused_edge_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert P.fused_edge_layer.bwd_launches == before + 1
    ref = P.fused_edge_layer_bwd_ref(*args)
    for a, b in zip((*out[:3], *out[3]), (*ref[:3], *ref[3])):
        assert a.shape == b.shape and torch.isfinite(a).all()
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= 2 ** -7 * scale


def _fwd_tc_case(Hn, seed, nb):
    """As _bwd_case without cotangents, over nb node blocks (nb = 3: the
    window is the whole graph): padding and all-padding tiles, a tile of
    one receiver, a last block with no edges."""
    row, col, ea, em, n, x, hr, hc, w, _, _ = _bwd_case(Hn, seed, nb)
    col[:100] %= 3 * T   # block 0's window: the one-row tiles all active
    return row, col, ea, em, n, x, hr, hc, w


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [5, 3])
@pytest.mark.parametrize("Hn", [16, 32, 64])
def test_fused_edge_fwd_tensor_core_kernel_on_card(Hn, nb):
    """The bf16 forward at H = 16 / 32 / 64 runs the tensor-core kernel (one
    launch, counted in tc_launches too) and agrees with fused_edge_layer_ref
    within 2^-7 of each output's scale (the bf16 bound above), over
    all-padding tiles, a tile whose 64 edges share one row, and a graph of
    exactly 3 node blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    row, col, ea, em, n, x, hr, hc, w = _fwd_tc_case(Hn, 60 + Hn + nb, nb)
    assert (row[:64] == row[0]).all()
    dev = torch.device("cuda")
    pa = [a.to(dev) for a in P.build_edge_blocks(*_t(row, col, ea, em),
                                                  block=T, n_nodes=n)]
    tiles = pa[3][:, 2].reshape(-1, 64) > 0
    assert (~tiles.any(1)).any() and tiles[0].all()
    xd, hrd, hcd = (a.to(dev) for a in _t(x, hr, hc))
    hrd, hcd = hrd.to(torch.bfloat16), hcd.to(torch.bfloat16)
    wt = P.EdgeWeights(*[a.to(dev) for a in _t(*w)])
    assert P.fwd_uses_tensor_cores(Hn, "bf16")
    before = (P.fused_edge_layer.launches, P.fused_edge_layer.tc_launches)
    out = P.fused_edge_layer(xd, hrd, hcd, *pa, wt, T, "bf16")
    torch.cuda.synchronize()
    assert (P.fused_edge_layer.launches, P.fused_edge_layer.tc_launches) == (
        before[0] + 1, before[1] + 1)
    ref = P.fused_edge_layer_ref(xd, hrd, hcd, *pa, wt, T, "bf16")
    for a, b in zip(out, ref):
        assert a.shape == b.shape and torch.isfinite(a).all()
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= 2 ** -7 * scale
    # the edge count is exact: a sum of ones
    assert torch.equal(out[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("Hn, dtype_name", [(48, "bf16"), (16, "f32"),
                                            (64, "f32"), (32, "f32"),
                                            (48, "f32"), (128, "f32")])
def test_fused_edge_fwd_fma_kernel_cases_on_card(Hn, dtype_name):
    """bf16 at an H the tensor-core kernel does not take runs the bf16 FMA
    kernel, f32 at any H the f32 FMA kernel (f32_launches counts it; H =
    128 fits one block an SM): one launch, tc_launches unchanged, within
    2^-7 of the plain version, the edge count exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    row, col, ea, em, n, x, hr, hc, w = _fwd_tc_case(Hn, 80 + Hn, 5)
    dev = torch.device("cuda")
    pa = [a.to(dev) for a in P.build_edge_blocks(*_t(row, col, ea, em),
                                                  block=T, n_nodes=n)]
    args = [a.to(dev) for a in _t(x, hr, hc)]
    wt = P.EdgeWeights(*[a.to(dev) for a in _t(*w)])
    assert not P.fwd_uses_tensor_cores(Hn, dtype_name)
    f32 = P.fwd_uses_f32_kernel(Hn, dtype_name)
    assert f32 == (dtype_name == "f32")
    counts = (lambda: (P.fused_edge_layer.launches,
                       P.fused_edge_layer.tc_launches,
                       P.fused_edge_layer.f32_launches))
    before = counts()
    out = P.fused_edge_layer(*args, *pa, wt, T, dtype_name)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1], before[2] + f32)
    ref = P.fused_edge_layer_ref(*args, *pa, wt, T, dtype_name)
    for a, b in zip(out, ref):
        assert a.shape == b.shape and torch.isfinite(a).all()
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2 ** -7 * scale
    assert torch.equal(out[1], ref[1])


def _sliced_phi_x(w, hx):
    """A tensor rank's phi_x weights: the first hx columns of w3, b3, w4."""
    ws, b1, w2, b2, w3, b3, w4 = w
    return [ws, b1, w2, b2] + [np.ascontiguousarray(a[:, :hx])
                               for a in (w3, b3, w4)]


# (H, phi_x width HX): the tensor axis at T = 2 and 4, every H of the
# tensor-core and backward kernels, and an H of the FMA forwards only
PHI_X_CASES = [(16, 8), (32, 16), (32, 8), (64, 32), (64, 16), (48, 24),
               (48, 12), (128, 64), (128, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["bf16", "f32"])
@pytest.mark.parametrize("Hn, hx", PHI_X_CASES)
def test_fused_edge_kernels_at_a_sliced_phi_x_width_on_card(Hn, hx,
                                                            dtype_name):
    """w3 [H, HX], b3 and w4 [HX] (a tensor rank's slice, HX = H/2 or H/4):
    the forward (the tensor-core kernel for bf16 at H in 16 / 32 / 64, the
    bf16 FMA kernel at other H, the f32 kernel) and, at the backward's H,
    the backward (the tensor-core kernel for bf16, the FMA kernel for f32),
    each one launch counted at (H, HX), within 2^-7 of each output's scale
    of its plain version (the bounds above), the edge count exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    row, col, ea, em, n, x, hr, hc, w, gt, ge = _bwd_case(Hn, 90 + Hn + hx)
    dev = torch.device("cuda")
    pa = [a.to(dev) for a in P.build_edge_blocks(*_t(row, col, ea, em),
                                                  block=T, n_nodes=n)]
    xd, hrd, hcd, gtd, ged = (a.to(dev) for a in _t(x, hr, hc, gt, ge))
    dt = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    hrd, hcd = hrd.to(dt), hcd.to(dt)
    wt = P.EdgeWeights(*[a.to(dev) for a in _t(*_sliced_phi_x(w, hx))])
    fwd = P.fused_edge_layer.launch_widths[(Hn, hx)]
    tc = P.fused_edge_layer.tc_launches
    args = (xd, hrd, hcd, *pa, wt, T, dtype_name)
    out = P._fused_edge_layer_cuda(*args)
    torch.cuda.synchronize()
    assert P.fused_edge_layer.launch_widths[(Hn, hx)] == fwd + 1
    assert P.fused_edge_layer.tc_launches == tc + P.fwd_uses_tensor_cores(
        Hn, dtype_name)
    ref = P.fused_edge_layer_ref(*args)
    for a, b in zip(out, ref):
        assert a.shape == b.shape and torch.isfinite(a).all()
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2 ** -7 * scale
    assert torch.equal(out[1], ref[1])
    if Hn not in (16, 32, 64):
        return
    bwd = P.fused_edge_layer.bwd_launch_widths[(Hn, hx)]
    bargs = (xd, hrd, hcd, *pa, wt, gtd, ged, T, dtype_name)
    out = P._fused_edge_bwd_cuda(*bargs)
    torch.cuda.synchronize()
    assert P.fused_edge_layer.bwd_launch_widths[(Hn, hx)] == bwd + 1
    assert out[3].w3.shape == (Hn, hx) and out[3].w4.shape == (1, hx)
    ref = P.fused_edge_layer_bwd_ref(*bargs)
    for a, b in zip((*out[:3], *out[3]), (*ref[:3], *ref[3])):
        assert a.shape == b.shape and torch.isfinite(a).all()
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= 2 ** -7 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_fused_edge_kernels_refuse_an_unsupported_phi_x_width_on_card(
        kernel):
    """w3 [64, 8] (H/8) or [64, 24] (not a divisor's slice): a ValueError
    naming the widths the kernels take, and no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    row, col, ea, em, n, x, hr, hc, w, gt, ge = _bwd_case(64, 95)
    dev = torch.device("cuda")
    pa = [a.to(dev) for a in P.build_edge_blocks(*_t(row, col, ea, em),
                                                  block=T, n_nodes=n)]
    xd, hrd, hcd, gtd, ged = (a.to(dev) for a in _t(x, hr, hc, gt, ge))
    hrd, hcd = hrd.to(torch.bfloat16), hcd.to(torch.bfloat16)
    before = (P.fused_edge_layer.launches, P.fused_edge_layer.bwd_launches)
    for hx in (8, 24):
        wt = P.EdgeWeights(*[a.to(dev) for a in _t(*_sliced_phi_x(w, hx))])
        with pytest.raises(ValueError, match=r"HX in \(64, 32, 16\)"):
            if kernel == "fwd":
                P._fused_edge_layer_cuda(xd, hrd, hcd, *pa, wt, T, "bf16")
            else:
                P._fused_edge_bwd_cuda(xd, hrd, hcd, *pa, wt, gtd, ged, T,
                                       "bf16")
    assert (P.fused_edge_layer.launches,
            P.fused_edge_layer.bwd_launches) == before


@pytest.mark.cuda
def test_fused_edge_fwd_tc_kernel_is_built_on_hmma_on_card():
    """The built library's SASS of fused_edge_fwd_tc_kernel<64, HX> holds
    HMMA (tensor-core) instructions at every phi_x width HX."""
    import os
    import shutil
    import subprocess

    from distegnn_tpu_torch.ops import build

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "", "bin",
                                                     "cuobjdump")
    lib = build._build("fused_edge_fwd")[0]
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    # one section per kernel, headed by its mangled name: at H = 64 one an
    # phi_x width HX (64, 32, 16)
    tc = [f for f in sass.split("Function : ")[1:]
          if "fused_edge_fwd_tc_kernelILi64E" in f.split()[0]]
    assert len(tc) == 3
    assert all("HMMA" in f for f in tc)


@pytest.mark.cuda
def test_fused_edge_fwd_f32_kernel_is_built_on_ffma_on_card():
    """The built library's SASS of fused_edge_fwd_f32_kernel<64, HX> holds
    FFMA (CUDA-core f32 FMA) instructions and no HMMA at every phi_x width
    HX: its products stay in f32, not TF32."""
    import os
    import shutil
    import subprocess

    from distegnn_tpu_torch.ops import build

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "", "bin",
                                                     "cuobjdump")
    lib = build._build("fused_edge_fwd")[0]
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    f32 = [f for f in sass.split("Function : ")[1:]
           if "fused_edge_fwd_f32_kernelILi64E" in f.split()[0]]
    assert len(f32) == 3      # one a phi_x width HX (64, 32, 16)
    # a k step of one product is 8 edges x 4 columns = 32 FMAs a thread
    assert all(f.count("FFMA") >= 4 * 32 for f in f32)
    assert not any("HMMA" in f for f in f32)


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


# (F, type): the paths' widths, the narrowest and the widest F
SCAN_REPEAT_CASES = [(F, dt) for F in (1, 3, 64, 68, 8192)
                     for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("F, dtype", SCAN_REPEAT_CASES)
def test_prefix_scan_single_pass_is_bitwise_repeatable_on_card(F, dtype,
                                                               reverse):
    """The single pass at B = 4 and an E of 300 tiles and 7 rows (a ragged
    last tile, two super-groups of 256 tiles of the carry's tree): two
    launches agree bit for bit (the carry is summed in a fixed order), and
    each is within 1e-5 of each column's max |prefix| of f64."""
    from distegnn_tpu_torch.ops import cumsum as CS

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    R = max(1, CS.SCAN_TILE_BYTES // (F * (2 if dtype == torch.bfloat16
                                           else 4)))
    E = 300 * R + 7
    assert (R == 1 or E % R) and -(-E // R) > 256
    gen = torch.Generator(device="cuda").manual_seed(F)
    x = torch.randn((4, E, F), generator=gen, device="cuda").to(dtype)
    before = (CS.prefix_sum.launches, CS.prefix_sum.suffix_launches)
    a = CS._scan(x, reverse)
    b = CS._scan(x, reverse)
    torch.cuda.synchronize()
    after = (CS.prefix_sum.launches, CS.prefix_sum.suffix_launches)
    assert after == (before[0] + 2 * (not reverse), before[1] + 2 * reverse)
    assert torch.equal(a, b)
    ref, scale = _scan_f64(x, reverse)
    assert float(((a.double() - ref).abs() / scale).max()) <= 1e-5


# ------------------------------------------------------ fused-stack megakernel

def _stack_graph(rng, n_real=4 * T):
    """4 real node blocks (padded to 5: a trailing empty block), edges near
    the diagonal with ~10 % into a far block (a remote tail), 2 node
    attributes — the JAX package's megakernel workload."""
    rows, cols = [], []
    for b in range(n_real // T):
        r = rng.integers(b * T, (b + 1) * T, size=384)
        near = rng.integers(max(0, (b - 1) * T), min(n_real, (b + 2) * T),
                            size=384)
        far_block = (b + 3) % (n_real // T)
        far = rng.integers(far_block * T, (far_block + 1) * T, size=384)
        rows.append(r)
        cols.append(np.where(rng.uniform(size=384) < 0.1, far, near))
    row, col = np.concatenate(rows), np.concatenate(cols)
    order = np.argsort(row, kind="stable")
    ei = np.stack([row[order], col[order]]).astype(np.int64)
    return {"node_feat": rng.normal(size=(n_real, 2)).astype(np.float32),
            "node_attr": rng.normal(size=(n_real, 2)).astype(np.float32),
            "loc": rng.uniform(0, 1, size=(n_real, 3)).astype(np.float32),
            "vel": (rng.normal(size=(n_real, 3)) * 0.05).astype(np.float32),
            "target": rng.uniform(0, 1, size=(n_real, 3)).astype(np.float32),
            "edge_index": ei,
            "edge_attr": rng.normal(size=(ei.shape[1], 2)).astype(np.float32)}


def _stack_operands(seed, L, dtype_name, gravity, dev, C=2, A=2):
    from distegnn_tpu_torch.ops import layer_pipeline as LP
    from distegnn_tpu_torch.ops.graph import pad_graphs

    rng = np.random.default_rng(seed)
    pb = pad_graphs([_stack_graph(rng)], max_nodes=5 * T, edge_block=T,
                    split_remote=True).to(dev)
    arrs = tuple(a[0].contiguous() for a in P.build_edge_blocks(
        pb.row, pb.col, pb.edge_attr, pb.edge_mask, block=T,
        n_nodes=5 * T))
    N = 5 * T
    cfg = LP.StackConfig(n_layers=L, block=T, hidden=H, channels=C,
                         node_attr_nf=A, has_gravity=gravity,
                         dtype_name=dtype_name)
    wstack = {}
    for k, (a, b) in LP.stack_weight_shapes(cfg).items():
        s = (1e-3 if k in ("e_w4", "xv_k1", "X_k1") else 1.0) / np.sqrt(
            a if a > 1 else b)
        wstack[k] = torch.from_numpy(rng.uniform(-s, s, size=(L, a, b))
                                     .astype(np.float32)).to(dev)
    nm = pb.node_mask[0]
    ops = (torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32))
           .to(dev) * nm[:, None],
           pb.loc[0], pb.vel[0], pb.loc_mean[0][:, None].repeat(1, C),
           torch.from_numpy(rng.normal(size=(H, C)).astype(np.float32))
           .to(dev), nm, pb.node_attr[0],
           torch.tensor([0.0, 0.0, -9.8], device=dev) if gravity else None,
           arrs, (pb.remote_edge_index[0, 0], pb.remote_edge_index[0, 1],
                  pb.remote_edge_attr[0], pb.remote_edge_mask[0]))
    return cfg, ops, wstack


def _close(a, b, dtype_name):
    """Kernel vs plain version: max abs error <= 2^-7 (f32) / 2^-5 (bf16)
    and mean <= 1e-5 / 2^-9 of the output's scale (summation order; single
    bf16-ulp flips of per-edge features that sat on a rounding boundary,
    carried through the layers)."""
    tmax, tmean = {"f32": (2 ** -7, 1e-5), "bf16": (2 ** -5, 2 ** -9)}[
        dtype_name]
    assert a.shape == b.shape and bool(torch.isfinite(a).all())
    d = (a.float() - b.float()).abs()
    scale = float(b.abs().max())
    assert float(d.max()) <= tmax * scale and float(d.mean()) <= tmean * scale


@pytest.mark.cuda
@pytest.mark.parametrize("gravity", [False, True])
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_fused_stack_kernel_matches_plain_version_on_card(dtype_name,
                                                          gravity):
    """csrc/fused_stack_fwd.cu against fused_egnn_stack_ref on the same card
    tensors (L=2, H=16, C=2, A=2, a remote tail and a trailing empty node
    block): the four outputs and the four layer-input checkpoints, one
    launch."""
    from distegnn_tpu_torch.ops import layer_pipeline as LP

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    cfg, ops, w = _stack_operands(21, 2, dtype_name, gravity, dev)
    before = LP.fused_egnn_stack.launches
    # the graph as a batch of one
    one = [None if a is None else tuple(t[None] for t in a)
           if isinstance(a, tuple) else a[None] for a in ops]
    one[7] = ops[7]                            # gravity is shared
    with torch.no_grad():
        out, cks = LP._fused_egnn_stack_batch_cuda(cfg, *one, w)
        torch.cuda.synchronize()
        assert LP.fused_egnn_stack.launches == before + 1
        ref_out, ref_cks = LP.fused_egnn_stack_ref(cfg, *ops, w)
    for a, b in zip(list(out) + list(cks), list(ref_out) + list(ref_cks)):
        _close(a[0], b, dtype_name)
    assert torch.equal(cks[0][0, 0], ops[0])   # slot 0 is the input


@pytest.mark.cuda
def test_fused_stack_launch_counts_and_gradients_on_card():
    """Through the autograd Function: one stack launch forward; backward L
    fused_edge_fwd + L fused_edge_bwd launches (each layer rerun from its
    checkpoint), and gradients within 2^-7 of the largest of those of the
    same walk from the plain version's checkpoints."""
    from unittest import mock

    from distegnn_tpu_torch.ops import layer_pipeline as LP

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    L = 2
    cfg, ops, w = _stack_operands(22, L, "f32", True, dev)

    def grads():
        diff = [a.clone().requires_grad_() for a in ops[:5]]
        wt = {k: a.clone().requires_grad_() for k, a in w.items()}
        out = LP.fused_egnn_stack(cfg, *diff, *ops[5:], wt)
        loss = sum((o * o).sum() for o in out)
        return torch.autograd.grad(loss, diff + list(wt.values()))

    counts = (lambda: (LP.fused_egnn_stack.launches,
                       P.fused_edge_layer.launches,
                       P.fused_edge_layer.bwd_launches))
    before = counts()
    g = grads()
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + L, before[2] + L)
    with mock.patch.object(LP, "_fused_egnn_stack_batch_cuda",
                           LP.fused_egnn_stack_batch_ref):
        g_ref = grads()
    scale = max(float(a.abs().max()) for a in g_ref)
    for a, b in zip(g, g_ref):
        assert float((a - b).abs().max()) <= 2 ** -7 * scale


@pytest.mark.cuda
def test_fused_stack_budget_error_before_any_launch_on_card():
    from distegnn_tpu_torch.ops import layer_pipeline as LP

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cfg, ops, w = _stack_operands(23, 2, "f32", False, torch.device("cuda"))
    before = LP.fused_egnn_stack.launches
    with pytest.raises(LP.StackVmemBudgetError):
        LP.fused_egnn_stack(cfg._replace(vmem_budget=1024), *ops, w)
    assert LP.fused_egnn_stack.launches == before


# graphs of different real sizes and edge sets for the batched launch
STACK_BATCH_SIZES = (4 * T, 3 * T + 200, 2 * T + 37, 4 * T - 100)


def _stack_batch_operands(seed, B, L, dtype_name, gravity, dev, C=2, A=2):
    """A batch of the first B of STACK_BATCH_SIZES graphs, padded to 5
    blocks, in fused_egnn_stack_batch's layout."""
    from distegnn_tpu_torch.ops import layer_pipeline as LP
    from distegnn_tpu_torch.ops.graph import pad_graphs

    rng = np.random.default_rng(seed)
    graphs = [_stack_graph(rng, n) for n in STACK_BATCH_SIZES[:B]]
    pb = pad_graphs(graphs, max_nodes=5 * T, edge_block=T,
                    split_remote=True).to(dev)
    arrs = tuple(a.contiguous() for a in P.build_edge_blocks(
        pb.row, pb.col, pb.edge_attr, pb.edge_mask, block=T,
        n_nodes=5 * T))
    N = 5 * T
    cfg = LP.StackConfig(n_layers=L, block=T, hidden=H, channels=C,
                         node_attr_nf=A, has_gravity=gravity,
                         dtype_name=dtype_name)
    wstack = {}
    for k, (a, b) in LP.stack_weight_shapes(cfg).items():
        s = (1e-3 if k in ("e_w4", "xv_k1", "X_k1") else 1.0) / np.sqrt(
            a if a > 1 else b)
        wstack[k] = torch.from_numpy(rng.uniform(-s, s, size=(L, a, b))
                                     .astype(np.float32)).to(dev)
    nm = pb.node_mask
    ops = (torch.from_numpy(rng.normal(size=(B, N, H)).astype(np.float32))
           .to(dev) * nm[..., None],
           pb.loc, pb.vel, pb.loc_mean[:, :, None].repeat(1, 1, C),
           torch.from_numpy(rng.normal(size=(B, H, C)).astype(np.float32))
           .to(dev), nm, pb.node_attr,
           torch.tensor([0.0, 0.0, -9.8], device=dev) if gravity else None,
           arrs, (pb.remote_edge_index[:, 0], pb.remote_edge_index[:, 1],
                  pb.remote_edge_attr, pb.remote_edge_mask))
    return cfg, ops, wstack


@pytest.mark.cuda
@pytest.mark.parametrize("gravity", [False, True])
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 2, 4])
def test_fused_stack_batch_kernel_matches_plain_version_on_card(
        B, dtype_name, gravity):
    """One launch for a batch of B graphs of different real sizes (L=2,
    H=16, C=2, A=2, remote tails, trailing empty blocks) against the plain
    version graph by graph: every graph's four outputs and four layer-input
    checkpoints."""
    from distegnn_tpu_torch.ops import layer_pipeline as LP

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    cfg, ops, w = _stack_batch_operands(31 + B, B, 2, dtype_name, gravity,
                                        dev)
    assert len(set(float(ops[5][b].sum()) for b in range(B))) == B
    before = LP.fused_egnn_stack.launches
    with torch.no_grad():
        out, cks = LP._fused_egnn_stack_batch_cuda(cfg, *ops, w)
        torch.cuda.synchronize()
        assert LP.fused_egnn_stack.launches == before + 1
        assert LP.fused_egnn_stack.last_launch["graphs"] == B
        ref_out, ref_cks = LP.fused_egnn_stack_batch_ref(cfg, *ops, w)
    for b in range(B):
        for a, r in zip(list(out) + list(cks),
                        list(ref_out) + list(ref_cks)):
            _close(a[b], r[b], dtype_name)
        assert torch.equal(cks[0][b, 0], ops[0][b])   # slot 0 is the input


@pytest.mark.cuda
def test_fused_stack_batch_launch_counts_and_gradients_on_card():
    """The batched autograd node: one stack launch for B=2 graphs forward;
    backward L x B fused_edge_fwd + L x B fused_edge_bwd launches (each
    graph's layers rerun from their checkpoints), and gradients within 2^-7
    of the largest of those of the same walk from the plain version's
    checkpoints."""
    from unittest import mock

    from distegnn_tpu_torch.ops import layer_pipeline as LP

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    B, L = 2, 2
    cfg, ops, w = _stack_batch_operands(41, B, L, "f32", True, dev)

    def grads():
        diff = [a.clone().requires_grad_() for a in ops[:5]]
        wt = {k: a.clone().requires_grad_() for k, a in w.items()}
        out = LP.fused_egnn_stack_batch(cfg, *diff, *ops[5:], wt)
        loss = sum((o * o).sum() for o in out)
        return torch.autograd.grad(loss, diff + list(wt.values()))

    counts = (lambda: (LP.fused_egnn_stack.launches,
                       P.fused_edge_layer.launches,
                       P.fused_edge_layer.bwd_launches))
    before = counts()
    g = grads()
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + L * B,
                        before[2] + L * B)
    with mock.patch.object(LP, "_fused_egnn_stack_batch_cuda",
                           LP.fused_egnn_stack_batch_ref):
        g_ref = grads()
    scale = max(float(a.abs().max()) for a in g_ref)
    for a, b in zip(g, g_ref):
        assert float((a - b).abs().max()) <= 2 ** -7 * scale


@pytest.mark.cuda
def test_fused_stack_batch_budget_error_before_any_launch_on_card():
    """A batch whose graphs each exceed the budget raises the typed error
    (the per-graph check) and launches nothing."""
    from distegnn_tpu_torch.ops import layer_pipeline as LP

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cfg, ops, w = _stack_batch_operands(43, 2, 2, "f32", False,
                                        torch.device("cuda"))
    before = LP.fused_egnn_stack.launches
    with pytest.raises(LP.StackVmemBudgetError):
        LP.fused_egnn_stack_batch(cfg._replace(vmem_budget=1024), *ops, w)
    assert LP.fused_egnn_stack.launches == before


# ------------------------------------------------- the blocked one-hot ops

def blocked_slots(rng, B, nb, epb, block=256, fill=0.7, empty_block=True,
                  shuffle=False):
    """[B, nb*epb] int32 slots of the blocked layout: in each node block
    ``fill`` of the slots hold sorted block-local receivers, the rest the
    sentinel ``block``; with ``empty_block`` the last block of graph 0 is
    all sentinels; ``shuffle`` mixes the slot order within each block."""
    s = np.full((B, nb, epb), block, np.int32)
    for b in range(B):
        for k in range(nb):
            if empty_block and b == 0 and k == nb - 1:
                continue
            n = int(fill * epb)
            s[b, k, :n] = np.sort(rng.integers(0, block, n))
            if shuffle:
                s[b, k] = rng.permutation(s[b, k])
    return torch.from_numpy(s.reshape(B, nb * epb))


def _seg_sum_f64(data, slot, n_nodes, block):
    """The exact segment sum in f64 ([B, N, F]) and each column's scale."""
    B, E, F = data.shape
    nb = n_nodes // block
    epb = E // nb
    blk = (torch.arange(E, device=slot.device) // epb) * block
    valid = (slot >= 0) & (slot < block)
    idx = torch.where(valid, slot.long() + blk, torch.zeros_like(blk))
    out = torch.zeros((B, n_nodes, F), dtype=torch.float64,
                      device=data.device)
    d = data.double() * valid[..., None]
    out.scatter_add_(1, idx[..., None].expand(B, E, F), d)
    mag = torch.zeros_like(out).scatter_add_(
        1, idx[..., None].expand(B, E, F), d.abs())
    return out, mag.amax(dim=1, keepdim=True).clamp(min=1e-30)


# (B, nb, epb, F): the paths' widths (1, 3, 64), epb == tile, a batch of 4,
# a block size of 64 with a tile of 128
BLOCKED_CASES = [(1, 6, 1024, 64, 256, 512), (1, 6, 512, 3, 256, 512),
                 (1, 5, 512, 1, 256, 512), (4, 4, 1536, 64, 256, 512),
                 (2, 5, 256, 17, 64, 128), (1, 3, 512, 128, 256, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, nb, epb, F, block, tile", BLOCKED_CASES)
def test_blocked_seg_sum_kernel_matches_f64_and_plain_on_card(
        B, nb, epb, F, block, tile, dtype, shuffle):
    """The segment-sum kernel against the exact sum (f64) and against its
    plain version: max error <= 1e-6 of each column's max |sum| (f32
    accumulation in another order); repeated launches are bitwise equal."""
    from distegnn_tpu_torch.ops import blocked as BL

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(B * 1000 + F)
    slot = blocked_slots(rng, B, nb, epb, block, shuffle=shuffle).to(dev)
    data = torch.from_numpy(rng.normal(size=(B, nb * epb, F)).astype(
        np.float32)).to(dev).to(dtype)
    n = nb * block
    before = BL.blocked_segment_sum.launches
    out = BL._seg_sum_cuda(data, slot, n, block, tile)
    torch.cuda.synchronize()
    assert BL.blocked_segment_sum.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (B, n, F)
    ref, scale = _seg_sum_f64(data, slot, n, block)
    assert float(((out.double() - ref).abs() / scale).max()) <= 1e-6
    plain = BL.blocked_segment_sum_ref(data, slot, n, block, tile)
    assert float(((out - plain).double().abs() / scale).max()) <= 1e-6
    assert torch.equal(BL._seg_sum_cuda(data, slot, n, block, tile), out)
    if B == 1 and nb > 1:
        # the empty (all-sentinel) last block sums to exact zeros
        assert (out[0, (nb - 1) * block:] == 0).all()


def plan_slots(rng, B, nb, epb, block, variant):
    """Slots for the plan and edge-order tests: ``shuffled`` (blocked_slots
    with the slot order mixed), ``sentinels`` (shuffled, padding marked by
    -1 and block + 3 as well as block), ``short`` (2 % of the slots real:
    most nodes own none, some one)."""
    if variant == "short":
        return blocked_slots(rng, B, nb, epb, block, fill=0.02, shuffle=True)
    slot = blocked_slots(rng, B, nb, epb, block, shuffle=True)
    if variant == "sentinels":
        pad = slot == block
        other = torch.from_numpy(rng.choice(
            np.array([-1, block, block + 3], np.int32),
            size=tuple(slot.shape)))
        slot = torch.where(pad, other, slot)
    return slot


PLAN_CASES = [(B, nb, epb, block) for B, nb, epb, block in
              ((1, 6, 1024, 256), (4, 4, 1536, 256), (2, 5, 256, 64),
               (4, 16, 12288, 256))]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["shuffled", "sentinels", "short"])
@pytest.mark.parametrize("B, nb, epb, block", PLAN_CASES)
def test_blocked_plan_kernel_equals_plain_on_card(B, nb, epb, block,
                                                  variant):
    """The plan kernel (per-warp counts, a block-wide scan, a stable
    placement by every warp) equals blocked_plan_ref, a stable argsort per
    node block with bincount / cumsum offsets, with torch.equal: perm, off
    and the degree; one counted launch; repeatable."""
    from distegnn_tpu_torch.ops import blocked as BL

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(B * 100 + nb)
    slot = plan_slots(rng, B, nb, epb, block, variant).to(dev)
    n = nb * block
    before = BL.blocked_plan.launches
    plan = BL.blocked_plan(slot, n, block)
    torch.cuda.synchronize()
    assert BL.blocked_plan.launches == before + 1
    want = BL.blocked_plan_ref(slot, n, block)
    for a, b in zip(plan, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    for a, b in zip(BL.blocked_plan(slot, n, block), plan):
        assert torch.equal(a, b)


# the paths' widths and types, a batch of 1 and of 4
INORDER_CASES = [(B, F, dt) for B in (1, 4) for F in (1, 3, 64)
                 for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["shuffled", "sentinels", "short"])
@pytest.mark.parametrize("B, F, dtype", INORDER_CASES)
def test_blocked_seg_sum_is_the_edge_order_sum_on_card(B, F, dtype,
                                                       variant):
    """The segment sum through a plan equals the edge-order reference (a
    dense gather through the plan summed one degree step at a time in f32)
    with torch.equal, lies within 1e-6 of the f64 sum of each column's max,
    repeats bitwise, and launches once with no plan launch of its own; an
    all-sentinel block sums to exact zeros."""
    from distegnn_tpu_torch.ops import blocked as BL

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    nb, epb, block, tile = 5, 1024, 256, 512
    rng = np.random.default_rng(B * 1000 + F)
    slot = plan_slots(rng, B, nb, epb, block, variant).to(dev)
    n = nb * block
    data = torch.from_numpy(rng.normal(size=(B, nb * epb, F)).astype(
        np.float32)).to(dev).to(dtype)
    plan = BL.blocked_plan(slot, n, block)
    counts = (lambda: (BL.blocked_segment_sum.launches,
                       BL.blocked_plan.launches))
    before = counts()
    out = BL.blocked_segment_sum(data, slot, n, block, tile, plan)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1])
    assert out.dtype == torch.float32 and out.shape == (B, n, F)
    assert torch.equal(out, BL.blocked_segment_sum_inorder(data, plan,
                                                           block))
    ref, scale = _seg_sum_f64(data, slot, n, block)
    assert float(((out.double() - ref).abs() / scale).max()) <= 1e-6
    assert torch.equal(BL._seg_sum_cuda(data, slot, n, block, tile, plan),
                       out)
    if variant != "short":
        # blocked_slots leaves graph 0's last block all sentinels
        assert (out[0, (nb - 1) * block:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, nb, epb, F, block, tile", BLOCKED_CASES)
def test_blocked_gather_kernel_matches_plain_bitwise_on_card(
        B, nb, epb, F, block, tile, dtype):
    """The gather kernel is a bit copy: equal to its plain version, and
    exactly zero at every sentinel slot."""
    from distegnn_tpu_torch.ops import blocked as BL

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(B * 7 + F)
    slot = blocked_slots(rng, B, nb, epb, block, shuffle=True).to(dev)
    h = torch.from_numpy(rng.normal(size=(B, nb * block, F)).astype(
        np.float32)).to(dev).to(dtype)
    before = BL.blocked_gather.launches
    out = BL._gather_cuda(h, slot, block, tile)
    torch.cuda.synchronize()
    assert BL.blocked_gather.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, nb * epb, F)
    assert torch.equal(out, BL.blocked_gather_ref(h, slot, block, tile))
    sentinel = slot == block
    assert sentinel.any()
    assert (out[sentinel] == 0).all()
    assert not torch.signbit(out[sentinel].float()).any()


@pytest.mark.cuda
@pytest.mark.parametrize("short", [1, 512])
def test_blocked_seg_sum_rejects_short_slots_before_launch(short):
    """Slots shorter than the edge axis raise before any launch (the kernel
    would read past their end)."""
    from distegnn_tpu_torch.ops import blocked as BL

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    B, nb, epb, F, block = 1, 4, 1024, 64, 256
    slot = blocked_slots(rng, B, nb, epb, block).to(dev)
    data = torch.randn((B, nb * epb, F), device=dev)
    before = BL.blocked_segment_sum.launches
    with pytest.raises(ValueError, match="slots"):
        BL._seg_sum_cuda(data, slot[:, :-short], nb * block, block, 512)
    assert BL.blocked_segment_sum.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_gather_misaligned_view_on_card(dtype, offset):
    """A contiguous h that starts a few elements into its storage (not 16-
    or 8-byte aligned) takes a narrower vector and still copies bitwise."""
    from distegnn_tpu_torch.ops import blocked as BL

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(offset)
    B, nb, epb, F, block = 2, 3, 512, 64, 256
    slot = blocked_slots(rng, B, nb, epb, block, shuffle=True).to(dev)
    flat = torch.from_numpy(rng.normal(size=B * nb * block * F + 8).astype(
        np.float32)).to(dev).to(dtype)
    h = flat[offset:offset + B * nb * block * F].view(B, nb * block, F)
    assert h.is_contiguous() and h.data_ptr() % 16
    out = BL._gather_cuda(h, slot, block, 512)
    torch.cuda.synchronize()
    assert torch.equal(out, BL.blocked_gather_ref(h, slot, block, 512))


# rows of at most 16 bytes (the one-thread-per-row gather): 4, 8, 12, 16
# bytes in f32 and 2, 4, 6, 8, 12, 16 in bf16
NARROW_ROWS = ([(torch.float32, F) for F in (1, 2, 3, 4)]
               + [(torch.bfloat16, F) for F in (1, 2, 3, 4, 6, 8)])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype, F", NARROW_ROWS)
def test_blocked_gather_narrow_rows_on_card(dtype, F, offset):
    """Narrow rows, a batch of 4 with an all-sentinel block, h aligned or a
    view that starts one element into its storage (mid-row): a bit copy,
    equal to the plain version, zero at every sentinel, one launch."""
    from distegnn_tpu_torch.ops import blocked as BL

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(100 * F + offset)
    B, nb, epb, block = 4, 3, 1536, 256
    slot = blocked_slots(rng, B, nb, epb, block, shuffle=True).to(dev)
    assert (slot[0, (nb - 1) * epb:] == block).all()
    size = B * nb * block * F
    flat = torch.from_numpy(rng.normal(size=size + 8).astype(
        np.float32)).to(dev).to(dtype)
    h = flat[offset:offset + size].view(B, nb * block, F)
    assert h.is_contiguous() and (h.data_ptr() % 16 == 0) == (offset == 0)
    before = BL.blocked_gather.launches
    out = BL._gather_cuda(h, slot, block, 512)
    torch.cuda.synchronize()
    assert BL.blocked_gather.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, nb * epb, F)
    assert torch.equal(out, BL.blocked_gather_ref(h, slot, block, 512))
    sentinel = slot == block
    assert (out[sentinel] == 0).all()
    assert not torch.signbit(out[sentinel].float()).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_op_backwards_on_card(dtype):
    """The autograd Functions on the card: seg_sum's backward is the gather
    kernel, the gather's and the paired column gather's the seg_sum kernel
    (one launch each) through the plan their forward was given (one plan
    launch in all; a plan apiece without one), equal to the same Functions
    on the plain versions."""
    from unittest import mock

    from distegnn_tpu_torch.ops import blocked as BL

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    B, nb, epb, F, block = 2, 4, 1024, 64, 256
    slot = blocked_slots(rng, B, nb, epb, block).to(dev)
    E, n = nb * epb, nb * block
    data = torch.from_numpy(rng.normal(size=(B, E, F)).astype(
        np.float32)).to(dev).to(dtype)
    h = torch.from_numpy(rng.normal(size=(B, n, F)).astype(
        np.float32)).to(dev).to(dtype)
    col = torch.from_numpy(rng.integers(0, n, (B, E)).astype(
        np.int32)).to(dev)
    pair = torch.stack([torch.randperm(E, device=dev) for _ in range(B)])
    cot_n = torch.randn((B, n, F), device=dev)
    cot_e = torch.randn((B, E, F), device=dev).to(dtype)

    def grads(plan):
        d = data.clone().requires_grad_()
        hh = h.clone().requires_grad_()
        (gd,) = torch.autograd.grad(
            BL.blocked_segment_sum(d, slot, n, plan=plan), d, cot_n)
        (gh,) = torch.autograd.grad(BL.blocked_gather(hh, slot, plan=plan),
                                    hh, cot_e)
        (gp,) = torch.autograd.grad(
            BL.paired_col_gather(hh, col, pair, slot, plan=plan), hh, cot_e)
        return gd, gh, gp

    counts = (lambda: (BL.blocked_segment_sum.launches,
                       BL.blocked_gather.launches, BL.blocked_plan.launches))
    before = counts()
    plan = BL.blocked_plan(slot, n)
    got = grads(plan)
    torch.cuda.synchronize()
    # the plan once; forwards: 1 seg_sum + 1 gather; backwards: 1 gather +
    # 2 seg_sums, all three seg_sums through that plan
    assert counts() == (before[0] + 3, before[1] + 2, before[2] + 1)
    # without a plan each segment sum builds its own
    unplanned = grads(None)
    assert counts() == (before[0] + 6, before[1] + 4, before[2] + 4)
    with mock.patch.object(BL, "_seg_sum_cuda",
                           BL.blocked_segment_sum_ref), \
            mock.patch.object(BL, "_gather_cuda", BL.blocked_gather_ref):
        want = grads(plan)
    assert counts() == (before[0] + 6, before[1] + 4, before[2] + 4)
    for a, b in zip(got, unplanned):
        assert torch.equal(a, b)
    assert got[0].dtype == dtype and torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == dtype
        scale = float(b.float().abs().max())
        tol = 1e-6 if dtype == torch.float32 else 2 ** -8
        assert float((a.float() - b.float()).abs().max()) <= tol * scale


# ------------------------------ FastRF and FastSchNet through the kernels

def _fast_model_graphs(rng, sizes=(300, 260), radius=0.25):
    """Symmetric radius graphs (rows ascending) in the unit cube, n-body
    style features, for the FastRF / FastSchNet cases."""
    from distegnn_tpu_torch.ops.radius import radius_graph_np

    out = []
    for n in sizes:
        loc = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
        vel = (rng.normal(size=(n, 3)) * 0.05).astype(np.float32)
        ei = radius_graph_np(loc, radius).astype(np.int64)
        d = np.linalg.norm(loc[ei[0]] - loc[ei[1]], axis=1)
        out.append({"node_feat": rng.normal(size=(n, 2)).astype(np.float32),
                    "loc": loc, "vel": vel, "target": loc + vel,
                    "edge_index": ei,
                    "edge_attr": np.repeat(d[:, None], 2, 1).astype(
                        np.float32)})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("lowering", ["blocked", "cumsum"])
@pytest.mark.parametrize("family", ["FastRF", "FastSchNet"])
def test_fast_models_run_the_blocked_and_scan_kernels_on_card(family,
                                                              lowering):
    """FastRF / FastSchNet (H=16, L=2, C=2) forward and backward on the
    card with ``blocked_impl: pallas`` on a blocked batch (blocked_plan,
    blocked_seg_sum, blocked_gather) or ``segment_impl: cumsum`` on a plain
    paired batch (the prefix scan): every kernel launched, and the output
    and every gradient within 1e-6 / 1e-5 of scale of the same model
    through the kernels' plain versions."""
    from unittest import mock

    from distegnn_tpu_torch.models.fast_rf import FastRF
    from distegnn_tpu_torch.models.fast_schnet import FastSchNet
    from distegnn_tpu_torch.ops import blocked as BL
    from distegnn_tpu_torch.ops import cumsum as CS
    from distegnn_tpu_torch.ops.graph import pad_graphs

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    graphs = _fast_model_graphs(np.random.default_rng(3))
    if lowering == "blocked":
        batch = pad_graphs(graphs, edge_block=256)
        kw = {"blocked_impl": "pallas"}
        plain = (mock.patch.object(BL, "_seg_sum_cuda",
                                   BL.blocked_segment_sum_ref),
                 mock.patch.object(BL, "_gather_cuda", BL.blocked_gather_ref),
                 mock.patch.object(BL, "_plan_cuda", BL.blocked_plan_ref))
    else:
        batch = pad_graphs(graphs, compute_pair=True)
        kw = {"segment_impl": "cumsum"}
        plain = (mock.patch.object(CS, "_scan_cuda", CS.prefix_sum_ref),)
    batch = batch.to(dev)
    gen = torch.Generator().manual_seed(1)
    if family == "FastRF":
        model = FastRF(edge_attr_nf=2, hidden_nf=16, virtual_channels=2,
                       n_layers=2, generator=gen, **kw)
    else:
        model = FastSchNet(node_feat_nf=2, edge_attr_nf=2, hidden_nf=16,
                           virtual_channels=2, n_layers=2, cutoff=1.0,
                           generator=gen, **kw)
    model = model.to(dev)

    def run():
        model.zero_grad(set_to_none=True)
        x, X = model(batch)
        loss = (torch.sum((x - batch.target) ** 2
                          * batch.node_mask[..., None])
                + 0.1 * torch.sum(X ** 2))
        loss.backward()
        torch.cuda.synchronize()
        return x.detach(), X.detach(), {
            n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}

    def counts():
        return (BL.blocked_segment_sum.launches, BL.blocked_gather.launches,
                BL.blocked_plan.launches, CS.prefix_sum.launches)

    before = counts()
    x, X, g = run()
    n = [a - b for a, b in zip(counts(), before)]
    if lowering == "blocked":
        assert n[0] > 0 and n[1] > 0 and n[2] == 1 and n[3] == 0, n
    else:
        assert n[:3] == [0, 0, 0] and n[3] > 0, n
    with contextlib.ExitStack() as stack:
        for patch in plain:
            stack.enter_context(patch)
        xp, Xp, gp = run()
    assert counts() == tuple(a + b for a, b in zip(before, n))
    mask = batch.node_mask > 0
    assert float((x - xp)[mask].abs().max()) <= 1e-6 * float(
        xp[mask].abs().max())
    assert float((X - Xp).abs().max()) <= 1e-6 * float(Xp.abs().max())
    scale = max(float(v.abs().max()) for v in gp.values())
    assert g.keys() == gp.keys()
    for k in gp:
        assert float((g[k] - gp[k]).abs().max()) <= 1e-5 * scale, k

