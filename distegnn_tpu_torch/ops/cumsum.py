"""One-pass prefix sum along the edge axis (port of
``distegnn_tpu/ops/cumsum.py``).

The cumsum segment lowering (ops/segment.py) takes every segment sum as a
difference of two f32 prefix sums, so its cost is the prefix sum's.
``prefix_sum(x)`` returns the inclusive f32 prefix sum of ``x`` along its
edge axis: ``x`` is ``[E, F]`` or ``[B, E, F]`` (one scan per graph of a
batch, in one call), in f32 or bf16, and the result is always f32.

On a CUDA tensor every call launches the hand-written kernel
``csrc/prefix_scan.cu`` (prefix or suffix direction; a single pass that
reads the input once, with a carry summed in a fixed order, so the result is
bitwise repeatable run to run), at any E: the JAX
package routes axes shorter than 32768 rows to XLA's cumsum because a Pallas
dispatch cost more than it saved on the TPU; here that route would be a
library call on the path, so there is none. On a CPU tensor it runs
:func:`prefix_sum_ref`, the plain version, which follows the TPU kernels
step by step. ``torch.cumsum`` computes the same function and is only the
yardstick ``chip_smoke.py`` times beside the kernel.

``prefix_sum`` is differentiable: prefix and suffix are each other's VJPs
(autograd Functions), as ``_prefix_pallas_diff``/``_suffix_pallas_diff`` are
in the JAX package. ``prefix_sum.launches`` and
``prefix_sum.suffix_launches`` count the kernel's calls in each direction;
``prefix_sum.launch_widths`` counts them by (direction, input type, F).
"""

from __future__ import annotations

import collections
import ctypes

import torch

TILE = 4096          # rows per tile of the TPU kernels (and of the plain version)
# the CUDA kernel's tiles: a block holds max(1, SCAN_TILE_BYTES // (F *
# input bytes)) rows of F input values in shared memory (96 KB: two blocks
# an SM); F is at most SCAN_MAX_F
SCAN_TILE_BYTES = 98304
SCAN_MAX_F = 8192


def _lead(x: torch.Tensor) -> torch.Tensor:
    """[E, F] or [B, E, F] -> a [B, E, F] view."""
    if x.ndim == 2:
        return x[None]
    if x.ndim == 3:
        return x
    raise ValueError(f"prefix_sum takes [E, F] or [B, E, F], got {tuple(x.shape)}")


def prefix_sum_ref(x: torch.Tensor, reverse: bool = False,
                   tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch version of the scan, written step by step after the TPU
    kernels ``_prefix_kernel``/``_suffix_kernel``: the edge axis is cut into
    ``tile``-row tiles (the tail zero-padded), each tile is scanned by
    log-step doubling (shift by k = 1, 2, 4, ... and masked add), and an f32
    carry runs from tile to tile in order (first to last, or last to first
    for ``reverse``). Returns the inclusive prefix (suffix) sum in f32."""
    xb = _lead(x).to(torch.float32)
    B, E, F = xb.shape
    n_tiles = max(-(-E // tile), 1)
    pad = n_tiles * tile - E
    if pad:
        xb = torch.cat([xb, xb.new_zeros((B, pad, F))], dim=1)
    t = xb.reshape(B, n_tiles, tile, F)
    k = 1
    while k < tile:
        zeros = t.new_zeros((B, n_tiles, k, F))
        if reverse:
            shifted = torch.cat([t[:, :, k:], zeros], dim=2)
        else:
            shifted = torch.cat([zeros, t[:, :, :-k]], dim=2)
        t = t + shifted
        k *= 2
    out = torch.empty_like(t)
    carry = t.new_zeros((B, 1, F))
    order = range(n_tiles - 1, -1, -1) if reverse else range(n_tiles)
    for i in order:
        c = t[:, i] + carry
        out[:, i] = c
        carry = c[:, :1] if reverse else c[:, -1:]
    out = out.reshape(B, n_tiles * tile, F)[:, :E]
    return out if x.ndim == 3 else out[0]


def _lib_fns():
    """The kernel's C entry points ``(prefix_scan,
    prefix_scan_scratch_bytes)``."""
    from distegnn_tpu_torch.ops.build import LIBRARIES

    lib = LIBRARIES.get("prefix_scan")
    fn, scratch = lib.prefix_scan, lib.prefix_scan_scratch_bytes
    if fn.argtypes is None:
        # pointers (and the stream) as c_void_p: ctypes would pass a bare
        # Python int as a 32-bit int and cut the pointer
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        scratch.argtypes = [i] * 4
        scratch.restype = ctypes.c_longlong
    return fn, scratch


def _scan_cuda(x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Launch ``csrc/prefix_scan.cu`` on a CUDA tensor: one call of the C
    entry point (a flag reset and the single-pass scan kernel) per wrapper
    call, counted once."""
    xb = _lead(x)
    if xb.dtype not in (torch.float32, torch.bfloat16):
        xb = xb.to(torch.float32)
    xb = xb.contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()    # the kernel reads x in 16-byte vectors
    B, E, F = xb.shape
    if F < 1 or F > SCAN_MAX_F:
        raise ValueError(f"prefix_scan takes 1 <= F <= {SCAN_MAX_F}, got {F}")
    if E >= 2 ** 31 or B > 65535:
        raise ValueError(f"prefix_scan takes E < 2^31 and B <= 65535, got "
                         f"B={B} E={E}")
    out = torch.empty((B, E, F), dtype=torch.float32, device=xb.device)
    if E == 0:
        return out if x.ndim == 3 else out[0]
    R = max(1, SCAN_TILE_BYTES // (F * xb.element_size()))
    fn, scratch_bytes = _lib_fns()
    # the tiles' aggregates, the carry tree's sums, the flags
    scratch = torch.empty((scratch_bytes(B, E, F, R),), dtype=torch.uint8,
                          device=xb.device)
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    err = fn(xb.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, E, F, R,
             int(xb.dtype == torch.bfloat16), int(reverse), stream)
    if err != 0:
        raise RuntimeError(f"prefix_scan launch failed: CUDA error {err}")
    if reverse:
        prefix_sum.suffix_launches += 1
    else:
        prefix_sum.launches += 1
    prefix_sum.launch_widths[(
        "suffix" if reverse else "prefix",
        "bf16" if xb.dtype == torch.bfloat16 else "f32", F)] += 1
    return out if x.ndim == 3 else out[0]


def _scan(x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """CUDA tensors take the kernel, CPU tensors the plain version; any
    other device is refused (there is no fallback)."""
    if x.device.type == "cuda":
        return _scan_cuda(x, reverse)
    if x.device.type == "cpu":
        return prefix_sum_ref(x, reverse)
    raise ValueError(f"prefix_sum: unsupported device {x.device}")


class _Prefix(torch.autograd.Function):
    # out_i = sum_{j<=i} x_j, so d/dx_j = sum_{i>=j} g_i: the suffix scan
    @staticmethod
    def forward(ctx, x):
        ctx.in_dtype = x.dtype
        return _scan(x, reverse=False)

    @staticmethod
    def backward(ctx, g):
        return _Suffix.apply(g).to(ctx.in_dtype)


class _Suffix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.in_dtype = x.dtype
        return _scan(x, reverse=True)

    @staticmethod
    def backward(ctx, g):
        return _Prefix.apply(g).to(ctx.in_dtype)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 inclusive cumulative sum of ``x`` ([E, F] or [B, E, F]) along the
    edge axis; differentiable (its VJP is :func:`suffix_sum`)."""
    return _Prefix.apply(x)


def suffix_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 inclusive reverse cumulative sum (out[i] = sum_{j>=i} x[j])."""
    return _Suffix.apply(x)


prefix_sum.launches = 0
prefix_sum.suffix_launches = 0
prefix_sum.launch_widths = collections.Counter()
