"""Fused edge pipeline — one pass per EGCL layer over the in-window edges
(port of ``distegnn_tpu/ops/edge_pipeline.py``).

Per receiver-sorted edge the pass gathers ``x``, ``hr[row]`` and
``hc[col]``, computes ``cd = x_r - x_c`` and ``radial = |cd|^2``, runs phi_e
(``silu(silu(hr + hc + sfeat@ws + b1) @ w2 + b2) = ef``) and the phi_x gate
``g = silu(ef@w3 + b3) . w4``, and segment-sums ``[cd*g, 1, ef]`` by row.

Layout: node ids are Morton-ordered and the edges are in the blocked layout
(ops/blocked.py) with blocks of ``block`` nodes. An edge is in-window when its
sender lies in node blocks ``s_b .. s_b+2`` with ``s_b = clip(b-1, 0, nb-3)``
for the receiver's block ``b``; ``build_edge_blocks`` masks the rest, and
``split_remote_edges`` routes those (the remote tail) to plain tensor code.

``fused_edge_layer`` is the ``torch.autograd.Function`` ``FusedEdgeLayer``.
Its forward runs the hand-written CUDA kernels of ``csrc/fused_edge_fwd.cu``
on CUDA tensors (bf16 at H in 16 / 32 / 64 on the tensor cores, f32 on the
register-blocked f32 FMA kernel, bf16 at other H on the FMA tile) and the
plain PyTorch version
``fused_edge_layer_ref`` on CPU tensors; its backward runs
``csrc/fused_edge_bwd.cu`` (which recomputes the per-edge forward: no
``[E, H]`` residual is kept) or the plain
``fused_edge_layer_bwd_ref``. The roundings are those of the TPU kernels, in
f32 mode too: the aggregated translation and its cotangent are split into
two bf16 terms (hi + lo), and the edge features and the per-edge ``d_t1``
payload are rounded to bf16 before an f32 sum.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

OH_CHUNK = 512   # the TPU kernel's aggregation chunk: the smallest block
XL = 8           # lanes of the per-edge scalar array scal [E, XL]
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


class EdgeWeights(NamedTuple):
    """phi_e (scalar part of the hoisted first Dense) + phi_x params, f32.
    HX, phi_x's hidden width, is H, or H / T on a rank of the tensor axis
    (its 1/T slice of w3's columns, b3 and w4)."""

    ws: torch.Tensor   # [S, H] scalar part of the hoisted Dense (S = 3)
    b1: torch.Tensor   # [1, H]
    w2: torch.Tensor   # [H, H] phi_e second Dense
    b2: torch.Tensor   # [1, H]
    w3: torch.Tensor   # [H, HX] phi_x hidden Dense
    b3: torch.Tensor   # [1, HX]
    w4: torch.Tensor   # [1, HX] phi_x head (no bias)


# ---------------------------------------------------------------- layout

def _validate_block(block: int) -> None:
    if block < OH_CHUNK or block % OH_CHUNK:
        raise ValueError(
            f"edge_pipeline requires block to be a multiple of OH_CHUNK="
            f"{OH_CHUNK} and >= {OH_CHUNK} (got block={block})")


def _check_grid(n_nodes: int, block: int) -> int:
    """The window spans 3 node blocks: reject graphs with fewer."""
    _validate_block(block)
    nb = n_nodes // block
    if nb < 3:
        raise ValueError(
            f"fused_edge_layer needs at least 3 node blocks (n_nodes="
            f"{n_nodes}, block={block} -> nb={nb}): the 3-block window "
            f"would index out of bounds; graphs smaller than {3 * block} "
            f"padded nodes must be padded up")
    return nb


def build_edge_blocks(row, col, edge_attr, edge_mask, *, block, n_nodes):
    """Blocked-layout edge tensors [..., E] -> the kernel's layout.

    With T = block, nb = n_nodes/T, epb = E/nb, nt = epb/T:
      row_t [..., nb*nt, T] int32 — block-LOCAL rows; masked slots carry T
      col_l [..., E, 1]     int32 — window-block-local col in [0, T)
      kblk  [..., E, 1]     int32 — which window slot (0..2) the col is in
      scal  [..., E, XL]    f32   — [edge_attr[0:2], active-mask, 0, ...]
    Edges whose col lies outside the 3-block window are masked out (they
    belong to the remote tail, ``split_remote_edges``).
    """
    _validate_block(block)
    nb = n_nodes // block
    E = row.shape[-1]
    epb = E // nb
    T = block
    if n_nodes % block or E % nb or epb % T:
        raise ValueError(f"layout mismatch: N={n_nodes} E={E} block={block}")
    nt = epb // T
    lead = tuple(row.shape[:-1])

    b_of_edge = torch.arange(E, dtype=torch.int32, device=row.device) // epb
    s = torch.clamp(b_of_edge - 1, 0, max(nb - 3, 0))
    row_local = row.to(torch.int32) - b_of_edge * T
    col_win = col.to(torch.int32) - s * T
    in_win = (col_win >= 0) & (col_win < 3 * T)
    mask = (edge_mask > 0) & in_win
    row_t = torch.where(mask, row_local, torch.full_like(row_local, T))
    row_t = row_t.reshape(lead + (nb * nt, T))
    col_win = torch.clamp(col_win, 0, 3 * T - 1)
    kblk = col_win // T
    col_l = col_win - kblk * T

    ea = edge_attr.to(torch.float32)
    scal = torch.cat(
        [ea[..., :2], mask[..., None].to(torch.float32),
         ea.new_zeros(lead + (E, XL - 3))], dim=-1)
    return row_t, col_l[..., None], kblk[..., None], scal


def _remote_sel(edge_index: np.ndarray, block: int, n_nodes: int) -> np.ndarray:
    """Boolean [e] mask of the edges OUTSIDE the 3-block window — the single
    definition of the remote classification (mirrors build_edge_blocks)."""
    if n_nodes % block:
        raise ValueError(f"n_nodes={n_nodes} not a multiple of block={block}")
    row, col = edge_index[0], edge_index[1]
    br, bc = row // block, col // block
    nb = n_nodes // block
    s = np.clip(br - 1, 0, max(nb - 3, 0))
    return (bc < s) | (bc > s + 2)


def count_remote_edges(edge_index: np.ndarray, *, block: int,
                       n_nodes: int) -> int:
    """Number of out-of-window edges (loader scans use this to pick a
    dataset-stable remote pad without materialising the split)."""
    return int(_remote_sel(np.asarray(edge_index), block, n_nodes).sum())


def remote_selection(edge_index: np.ndarray, *, block: int,
                     n_nodes: int) -> np.ndarray:
    """Row-sorted indices of the out-of-window edges."""
    remote = _remote_sel(edge_index, block, n_nodes)
    row = edge_index[0]
    r_idx = np.where(remote)[0]
    return r_idx[np.argsort(row[r_idx], kind="stable")]


def pad_remote_list(ei_r: np.ndarray, ea_r: np.ndarray,
                    n_pad: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a compact remote edge list to ``n_pad`` slots (default: next
    multiple of 128); padding points at node 0 with mask 0."""
    er = ei_r.shape[1]
    if n_pad is None:
        n_pad = max(((er + 127) // 128) * 128, 128)
    if er > n_pad:
        raise ValueError(f"{er} remote edges exceed pad {n_pad}")
    ei = np.zeros((2, n_pad), np.int32)
    ea = np.zeros((n_pad, ea_r.shape[1]), ea_r.dtype)
    m = np.zeros((n_pad,), np.float32)
    ei[:, :er] = ei_r
    ea[:er] = ea_r
    m[:er] = 1.0
    return ei, ea, m


def split_remote_edges(edge_index: np.ndarray, edge_attr: np.ndarray,
                       *, block: int, n_nodes: int,
                       n_pad: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """numpy: the out-of-window edges as a compact row-sorted edge list
    (remote_edge_index [2, R], remote_edge_attr [R, D], remote_mask [R]).

    ``n_nodes`` is the padded node count of the blocked layout; ``nb`` is
    derived from it exactly as ``build_edge_blocks`` does, so the two agree
    on every edge (an edge is processed by exactly one of the two paths)."""
    r_idx = remote_selection(edge_index, block=block, n_nodes=n_nodes)
    return pad_remote_list(edge_index[:, r_idx], edge_attr[r_idx],
                           n_pad=n_pad)


# ---------------------------------------------------------------- plain

def _silu(t: torch.Tensor) -> torch.Tensor:
    # x * sigmoid(x) with the sigmoid rounded to x's dtype first, as the
    # JAX package's _silu rounds it
    return t * torch.sigmoid(t)


def _dsilu(t: torch.Tensor) -> torch.Tensor:
    # silu'(t) = s * (1 + t * (1 - s)), each op rounded to t's dtype
    s = torch.sigmoid(t)
    return s * (1.0 + t * (1.0 - s))


def _split2(x: torch.Tensor):
    """2-term bf16 split of f32 (hi + lo carries ~16 mantissa bits)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _global_edges(row_t, col_l, kblk, n_nodes, block):
    """Global (row, col) of every edge slot from the kernel layout; masked
    slots get their block's last row (their contributions are zero)."""
    T = block
    nb = n_nodes // T
    E = col_l.shape[0]
    epb = E // nb
    b = torch.arange(E, device=col_l.device) // epb
    s = torch.clamp(b - 1, 0, max(nb - 3, 0))
    row = b * T + torch.clamp(row_t.reshape(-1).long(), max=T - 1)
    col = (s + kblk.reshape(-1).long()) * T + col_l.reshape(-1).long()
    return row, col


def fused_edge_layer_ref(x, hr, hc, row_t, col_l, kblk, scal,
                         weights: EdgeWeights, block: int,
                         dtype_name: str = "bf16"):
    """Plain PyTorch version of :func:`fused_edge_layer` (same arguments,
    same results): vectorised gathers, the MLPs in ``dtype_name`` with the
    kernel's roundings, and ``index_add_`` for the segment sums."""
    T = block
    n_nodes, H = hr.shape
    _check_grid(n_nodes, T)
    dt = _DTYPES[dtype_name]
    w = weights
    row, col = _global_edges(row_t, col_l, kblk, n_nodes, T)
    mask = scal[:, 2:3]                                     # [E, 1] f32

    cd = (x[row] - x[col]) * mask                           # [E, 3] f32
    radial = torch.sum(cd * cd, dim=1, keepdim=True)
    sfeat = torch.cat([radial, scal[:, 0:2]], dim=1).to(dt)
    hr_, hc_ = hr.to(dt), hc.to(dt)
    t1 = (hr_[row] + hc_[col]) + sfeat @ w.ws.to(dt) + w.b1.to(dt)
    y1 = _silu(t1)
    ef = _silu(y1 @ w.w2.to(dt) + w.b2.to(dt))              # [E, H]
    y2 = _silu(ef @ w.w3.to(dt) + w.b3.to(dt))
    g = torch.sum(y2.to(torch.float32) * w.w4, dim=1, keepdim=True) * mask

    hi, lo = _split2(cd * g)
    efm = (ef * mask.to(ef.dtype)).to(torch.bfloat16)
    data = torch.cat([hi.float(), lo.float(), mask, torch.zeros_like(mask),
                      efm.float()], dim=1)                  # [E, H+8]
    out = torch.zeros((n_nodes, H + 8), dtype=torch.float32, device=x.device)
    out.index_add_(0, row, data)
    return out[:, 0:3] + out[:, 3:6], out[:, 6], out[:, 8:]


def _combine_bwd(drow, dcol, H):
    """Row- and column-side sums [N, H+8] -> (d_x, d_hr, d_hc), added in the
    order of the JAX package's combine."""
    d_x = drow[:, 0:3] + drow[:, 3:6]
    d_x = d_x + dcol[:, 0:3] + dcol[:, 3:6]
    return d_x, drow[:, 8:], dcol[:, 8:]


def fused_edge_layer_bwd_ref(x, hr, hc, row_t, col_l, kblk, scal,
                             weights: EdgeWeights, g_trans, g_ef, block: int,
                             dtype_name: str = "bf16"):
    """Plain PyTorch version of the fused layer's backward: the arguments of
    :func:`fused_edge_layer` plus the cotangents ``g_trans [N, 3]`` and
    ``g_ef [N, H]`` of its sums (``count`` has none). Returns ``(d_x [N, 3],
    d_hr [N, H], d_hc [N, H], EdgeWeights of the weight gradients)``, all
    f32.

    Written step by step after the TPU kernel's backward, with its roundings
    (autograd through :func:`fused_edge_layer_ref` rounds elsewhere): the
    per-edge ``d_t1`` payload is rounded to bf16 and ``d_cd`` split into bf16
    hi + lo before the segment sums; in bf16 mode ``d_y2``, ``d_t3``,
    ``d_t2``, ``d_t1`` and every ``@ w.T`` product are bf16, and the
    weight-gradient products take the bf16 operands with f32 accumulation."""
    T = block
    n_nodes, H = hr.shape
    _check_grid(n_nodes, T)
    dt = _DTYPES[dtype_name]
    f32 = torch.float32
    w = weights
    row, col = _global_edges(row_t, col_l, kblk, n_nodes, T)
    mask = scal[:, 2:3]                                     # [E, 1] f32

    # the forward, recomputed as the kernel recomputes it
    cd = (x[row] - x[col]) * mask                           # [E, 3] f32
    radial = torch.sum(cd * cd, dim=1, keepdim=True)
    sfeat = torch.cat([radial, scal[:, 0:2]], dim=1).to(dt)
    ws, b1, w2, b2, w3, b3 = (a.to(dt) for a in (w.ws, w.b1, w.w2, w.b2,
                                                  w.w3, w.b3))
    hr_, hc_ = hr.to(dt), hc.to(dt)
    t1 = (hr_[row] + hc_[col]) + sfeat @ ws + b1
    y1 = _silu(t1)
    t2 = y1 @ w2 + b2
    ef = _silu(t2)
    t3 = ef @ w3 + b3
    y2 = _silu(t3)
    g = torch.sum(y2.to(f32) * w.w4, dim=1, keepdim=True) * mask

    # the chain, per edge
    d_trans = g_trans.to(f32)[row] * mask                   # [E, 3]
    d_ef_up = g_ef.to(f32)[row] * mask                      # [E, H]
    d_g = torch.sum(cd * d_trans, dim=1, keepdim=True)      # [E, 1]
    d_cd3 = d_trans * g
    d_y2 = (d_g * w.w4).to(dt)
    dw4 = torch.sum(y2.to(f32) * d_g, dim=0, keepdim=True)
    d_t3 = d_y2 * _dsilu(t3)
    d_ef = d_ef_up.to(dt) + d_t3 @ w3.T
    dw3 = ef.to(f32).T @ d_t3.to(f32)
    db3 = torch.sum(d_t3.to(f32), dim=0, keepdim=True)
    d_t2 = d_ef * _dsilu(t2)
    d_y1 = d_t2 @ w2.T
    dw2 = y1.to(f32).T @ d_t2.to(f32)
    db2 = torch.sum(d_t2.to(f32), dim=0, keepdim=True)
    d_t1 = d_y1 * _dsilu(t1)
    dws = sfeat.to(f32).T @ d_t1.to(f32)
    db1 = torch.sum(d_t1.to(f32), dim=0, keepdim=True)
    d_sfeat = d_t1 @ ws.T                                   # [E, 3]
    d_radial = d_sfeat[:, 0:1].to(f32) * mask
    d_cd = 2.0 * cd * d_radial + d_cd3                      # [E, 3] f32

    # row side at row, column side (d_x_col = -d_cd, d_hc = d_t1) at col
    d_t1m = (d_t1 * mask.to(dt)).to(torch.bfloat16).to(f32)
    hi, lo = _split2(d_cd)
    hi, lo = hi.to(f32), lo.to(f32)
    zero2 = torch.zeros_like(d_cd[:, 0:2])
    row_data = torch.cat([hi, lo, zero2, d_t1m], dim=1)     # [E, H+8]
    col_data = torch.cat([-hi, -lo, zero2, d_t1m], dim=1)
    drow = torch.zeros((n_nodes, H + 8), dtype=f32, device=x.device)
    dcol = torch.zeros_like(drow)
    drow.index_add_(0, row, row_data)
    dcol.index_add_(0, col, col_data)
    d_x, d_hr, d_hc = _combine_bwd(drow, dcol, H)
    return d_x, d_hr, d_hc, EdgeWeights(dws, db1, dw2, db2, dw3, db3, dw4)


# ---------------------------------------------------------------- kernel

def _lib_fn(name: str, n_ptr: int, n_int: int, lib: Optional[str] = None):
    """The C entry point ``name`` of ``csrc/<lib or name>.cu``."""
    from distegnn_tpu_torch.ops.build import LIBRARIES

    fn = getattr(LIBRARIES.get(lib or name), name)
    if fn.argtypes is None:
        # every pointer (and the stream) as c_void_p: ctypes would pass a
        # bare Python int as a 32-bit int and cut the pointer
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
        fn.restype = ctypes.c_int
    return fn


def _grid_fn():
    from distegnn_tpu_torch.ops.build import LIBRARIES

    fn = LIBRARIES.get("fused_edge_bwd").fused_edge_bwd_grid
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def phi_x_widths(H: int) -> Tuple[int, ...]:
    """The phi_x widths HX the kernels take at hidden width H: H, H/2 and
    H/4 (the tensor axis at T = 1, 2, 4), those of at least 8."""
    return tuple(hx for hx in (H, H // 2, H // 4) if hx >= 8 and H % hx == 0)


def _kernel_args(x, hr, hc, row_t, col_l, kblk, scal, weights: EdgeWeights,
                 block, dtype_name, kernel: str, sizes):
    """Check and lay out the inputs both kernels share; returns the
    contiguous (row_t, col_l, kblk, scal, x, hr, hc, ws, b1, w2, b2, w3, b3,
    w4) tuple the C entry points take, the edge-slot count and phi_x's
    width HX (w3's columns)."""
    T = block
    n_nodes, H = hr.shape
    nb = _check_grid(n_nodes, T)
    if H not in sizes:
        raise ValueError(f"{kernel} supports H in {sorted(sizes)}, got H={H}")
    HX = weights.w3.shape[-1] if weights.w3.ndim == 2 else -1
    if HX not in phi_x_widths(H):
        raise ValueError(
            f"{kernel} supports w3 [H, HX] with HX in {phi_x_widths(H)} at "
            f"H={H} (the tensor axis at T = 1, 2, 4), got w3 of shape "
            f"{tuple(weights.w3.shape)}")
    E = scal.shape[0]
    if E % nb or (E // nb) % T:
        raise ValueError(f"layout mismatch: N={n_nodes} E={E} block={T}")
    dev = x.device
    dt = _DTYPES[dtype_name]
    f32, i32 = torch.float32, torch.int32
    # the kernels read the activations in the compute dtype, as the TPU
    # kernels' packed [hr || hc] array, in 16-byte vectors
    hr, hc = (a if a.data_ptr() % 16 == 0 else a.clone()
              for a in (hr.to(dt).contiguous(), hc.to(dt).contiguous()))
    w = weights
    flat = [w.ws.contiguous()] + [a.reshape(-1).contiguous() if a.shape[0] == 1
                                  else a.contiguous()
                                  for a in (w.b1, w.w2, w.b2, w.w3, w.b3,
                                            w.w4)]
    args = (x, hr, hc, row_t, col_l, kblk, scal, *flat)
    for t, name, dtype, shape in zip(
            args,
            ("x", "hr", "hc", "row_t", "col_l", "kblk", "scal", "ws", "b1",
             "w2", "b2", "w3", "b3", "w4"),
            (f32, dt, dt, i32, i32, i32, f32) + (f32,) * 7,
            ((n_nodes, 3), (n_nodes, H), (n_nodes, H), (E // T, T), (E, 1),
             (E, 1), (E, XL), (3, H), (H,), (H, H), (H,), (H, HX), (HX,),
             (HX,))):
        _check(t, name, dtype, shape, dev)
    # the C entry points take the edge layout first
    return args[3:7] + args[0:3] + args[7:], E, HX


_FWD_SIZES = frozenset(range(16, 129, 16))
_BWD_SIZES = frozenset((16, 32, 64))
# bf16 at these H runs the forward's tensor-core kernel, bf16 at the other
# H its bf16 FMA kernel, f32 at every H its f32 FMA kernel (f32 on the
# tensor cores would be rounded to TF32)
_FWD_TC_SIZES = frozenset((16, 32, 64))


def fwd_uses_tensor_cores(H: int, dtype_name: str) -> bool:
    """Whether a forward launch of width ``H`` in ``dtype_name`` runs
    ``fused_edge_fwd_tc_kernel`` (else an FMA kernel)."""
    return dtype_name == "bf16" and H in _FWD_TC_SIZES


def fwd_uses_f32_kernel(H: int, dtype_name: str) -> bool:
    """Whether a forward launch of width ``H`` in ``dtype_name`` runs
    ``fused_edge_fwd_f32_kernel`` (f32 at every H; bf16 outside the
    tensor-core sizes runs ``fused_edge_fwd_kernel``)."""
    return dtype_name == "f32"


def _fused_edge_layer_cuda(x, hr, hc, row_t, col_l, kblk, scal,
                           weights: EdgeWeights, block, dtype_name):
    args, E, HX = _kernel_args(x, hr, hc, row_t, col_l, kblk, scal, weights,
                               block, dtype_name, "fused_edge_fwd",
                               _FWD_SIZES)
    n_nodes, H = hr.shape
    dev = x.device
    out = torch.zeros((n_nodes, H + 8), dtype=torch.float32, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a.data_ptr() for a in args] + [out.data_ptr()]
    tc = fwd_uses_tensor_cores(H, dtype_name)
    if tc:
        fn = _lib_fn("fused_edge_fwd_tc", 15, 6, lib="fused_edge_fwd")
        err = fn(*ptrs, n_nodes, E, block, H, HX, n_sm, stream)
    else:
        fn = _lib_fn("fused_edge_fwd", 15, 7)
        err = fn(*ptrs, n_nodes, E, block, H, HX,
                 int(dtype_name == "bf16"), n_sm, stream)
    if err != 0:
        raise RuntimeError(f"fused_edge_fwd{'_tc' if tc else ''} launch "
                           f"failed: CUDA error {err}")
    fused_edge_layer.launches += 1
    fused_edge_layer.tc_launches += tc
    fused_edge_layer.f32_launches += fwd_uses_f32_kernel(H, dtype_name)
    fused_edge_layer.launch_widths[(H, HX)] += 1
    return out[:, 0:3] + out[:, 3:6], out[:, 6], out[:, 8:]


def _fused_edge_bwd_cuda(x, hr, hc, row_t, col_l, kblk, scal,
                         weights: EdgeWeights, g_trans, g_ef, block,
                         dtype_name):
    """Launch ``csrc/fused_edge_bwd.cu``: the same results as
    :func:`fused_edge_layer_bwd_ref` (column-side sums by f32 atomics, so
    their summation order changes from run to run)."""
    args, E, HX = _kernel_args(x, hr, hc, row_t, col_l, kblk, scal, weights,
                               block, dtype_name, "fused_edge_bwd",
                               _BWD_SIZES)
    n_nodes, H = hr.shape
    dev = x.device
    f32 = torch.float32
    g_pack = torch.cat([g_trans.to(f32),
                        torch.zeros((n_nodes, XL - 3), dtype=f32, device=dev),
                        g_ef.to(f32)], dim=1).contiguous()     # [N, H+8]
    drow, dcol = torch.zeros((2, n_nodes, H + 8), dtype=f32, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16 = int(dtype_name == "bf16")
    # the persistent grid the launch will use (every resident block), so
    # that part holds one partial per block
    grid = ctypes.c_int(0)
    err = _grid_fn()(H, HX, bf16, n_sm, E, ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(f"fused_edge_bwd: no launch of H={H} HX={HX} "
                           f"{dtype_name} fits an SM: CUDA error {err}")
    max_grid = max(grid.value, 1)
    # one weight-gradient vector: [dws 3H | db1 H | dw2 H*H | db2 H |
    # dw3 H*HX | db3 HX | dw4 HX]
    sizes = [3 * H, H, H * H, H, H * HX, HX, HX]
    n_w = sum(sizes)
    scratch = torch.empty(((max_grid + 1) * n_w,), dtype=f32, device=dev)
    part, dw = scratch[:max_grid * n_w], scratch[max_grid * n_w:]
    fn = _lib_fn("fused_edge_bwd", 19, 8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*(a.data_ptr() for a in args), g_pack.data_ptr(),
             drow.data_ptr(), dcol.data_ptr(), part.data_ptr(), dw.data_ptr(),
             n_nodes, E, block, H, HX, bf16, n_sm, max_grid, stream)
    if err != 0:
        raise RuntimeError(f"fused_edge_bwd launch failed: CUDA error {err}")
    fused_edge_layer.bwd_launches += 1
    fused_edge_layer.bwd_launch_widths[(H, HX)] += 1
    d_x, d_hr, d_hc = _combine_bwd(drow, dcol, H)
    o = np.cumsum([0] + sizes)
    dws, db1, dw2, db2, dw3, db3, dw4 = (dw[o[k]:o[k + 1]] for k in range(7))
    d_w = EdgeWeights(dws.reshape(3, H), db1.reshape(1, H), dw2.reshape(H, H),
                      db2.reshape(1, H), dw3.reshape(H, HX),
                      db3.reshape(1, HX), dw4.reshape(1, HX))
    return d_x, d_hr, d_hc, d_w


def _on_device(kernel, plain, x):
    """CUDA tensors take the kernel, CPU tensors the plain version; any other
    device is refused (there is no fallback)."""
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"fused_edge_layer: unsupported device {x.device}")


class FusedEdgeLayer(torch.autograd.Function):
    """The fused layer as an autograd node. The seven weights come in as
    separate tensors (autograd cannot see into an EdgeWeights tuple), so
    their gradients reach the parameters they are views of."""

    @staticmethod
    def forward(ctx, x, hr, hc, row_t, col_l, kblk, scal, ws, b1, w2, b2, w3,
                b3, w4, block, dtype_name):
        run = _on_device(_fused_edge_layer_cuda, fused_edge_layer_ref, x)
        w = EdgeWeights(ws, b1, w2, b2, w3, b3, w4)
        trans, count, ef_sum = run(x, hr, hc, row_t, col_l, kblk, scal, w,
                                   block, dtype_name)
        ctx.save_for_backward(x, hr, hc, row_t, col_l, kblk, scal, ws, b1,
                              w2, b2, w3, b3, w4)
        ctx.block, ctx.dtype_name = block, dtype_name
        count = count.contiguous()
        # count is data-independent (the mask sum): no gradient
        ctx.mark_non_differentiable(count)
        return trans, count, ef_sum.contiguous()

    @staticmethod
    def backward(ctx, g_trans, g_count, g_ef):
        x, hr, hc, row_t, col_l, kblk, scal, *w = ctx.saved_tensors
        run = _on_device(_fused_edge_bwd_cuda, fused_edge_layer_bwd_ref, x)
        n_nodes, H = hr.shape
        if g_trans is None:
            g_trans = x.new_zeros((n_nodes, 3))
        if g_ef is None:
            g_ef = x.new_zeros((n_nodes, H))
        d_x, d_hr, d_hc, d_w = run(x, hr, hc, row_t, col_l, kblk, scal,
                                   EdgeWeights(*w), g_trans, g_ef, ctx.block,
                                   ctx.dtype_name)
        d_ws = [d.reshape(p.shape).to(p.dtype) for d, p in zip(d_w, w)]
        return (d_x, d_hr.to(hr.dtype), d_hc.to(hc.dtype), None, None, None,
                None, *d_ws, None, None)


def fused_edge_layer(x, hr, hc, row_t, col_l, kblk, scal,
                     weights: EdgeWeights, block: int = 2048,
                     dtype_name: str = "bf16"):
    """Fused phi_e + phi_x + row aggregation over the blocked edge arrays.

    Args:
      x    [N, 3] f32 coordinates (Morton-ordered, block-padded)
      hr   [N, H] hoisted row features (h @ W_row, node axis)
      hc   [N, H] hoisted col features
      row_t/col_l/kblk/scal — ``build_edge_blocks`` output for one graph
      weights — EdgeWeights (f32); w3 [H, HX], b3 / w4 [1, HX] with HX in
        :func:`phi_x_widths` (H, or a rank's slice under the tensor axis:
        trans_sum is then the rank's partial)
      dtype_name — 'f32' or 'bf16': the MLPs' compute dtype
    Returns (trans_sum [N, 3] f32, count [N] f32, ef_sum [N, H] f32): the
    un-normalised in-window segment sums; the caller adds the remote tail.

    Differentiable in x, hr, hc and the weights (:class:`FusedEdgeLayer`).
    CUDA tensors run the CUDA kernels (a failed build or launch raises; there
    is no fallback); CPU tensors run :func:`fused_edge_layer_ref` and
    :func:`fused_edge_layer_bwd_ref`. ``fused_edge_layer.launches`` and
    ``fused_edge_layer.bwd_launches`` count the forward and backward kernel
    launches; ``fused_edge_layer.tc_launches`` the forward launches that ran
    the tensor-core kernel (bf16 at H in 16 / 32 / 64,
    :func:`fwd_uses_tensor_cores`) and ``fused_edge_layer.f32_launches``
    those that ran the f32 FMA kernel (:func:`fwd_uses_f32_kernel`);
    ``fused_edge_layer.launch_widths`` / ``.bwd_launch_widths`` count them
    by (H, HX).
    """
    return FusedEdgeLayer.apply(x, hr, hc, row_t, col_l, kblk, scal,
                                *weights, block, dtype_name)


fused_edge_layer.launches = 0
fused_edge_layer.tc_launches = 0
fused_edge_layer.f32_launches = 0
fused_edge_layer.bwd_launches = 0
fused_edge_layer.launch_widths = collections.Counter()
fused_edge_layer.bwd_launch_widths = collections.Counter()
