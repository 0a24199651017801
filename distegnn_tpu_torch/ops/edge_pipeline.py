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

``fused_edge_layer`` runs the hand-written CUDA kernel
(``csrc/fused_edge_fwd.cu``) on CUDA tensors and its plain PyTorch version
``fused_edge_layer_ref`` on CPU tensors. The roundings are those of the TPU
kernel, in f32 mode too: the aggregated translation is split into two bf16
terms (hi + lo) and the edge features are rounded to bf16 before an f32 sum.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

OH_CHUNK = 512   # the TPU kernel's aggregation chunk: the smallest block
XL = 8           # lanes of the per-edge scalar array scal [E, XL]
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


class EdgeWeights(NamedTuple):
    """phi_e (scalar part of the hoisted first Dense) + phi_x params, f32."""

    ws: torch.Tensor   # [S, H] scalar part of the hoisted Dense (S = 3)
    b1: torch.Tensor   # [1, H]
    w2: torch.Tensor   # [H, H] phi_e second Dense
    b2: torch.Tensor   # [1, H]
    w3: torch.Tensor   # [H, H] phi_x hidden Dense
    b3: torch.Tensor   # [1, H]
    w4: torch.Tensor   # [1, H] phi_x head (no bias)


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


# ---------------------------------------------------------------- kernel

def _launch_fn():
    from distegnn_tpu_torch.ops.build import LIBRARIES

    fn = LIBRARIES.get("fused_edge_fwd").fused_edge_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p, p, p,
                       i, i, i, i, i, i, p]
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


def _fused_edge_layer_cuda(x, hr, hc, row_t, col_l, kblk, scal,
                           weights: EdgeWeights, block, dtype_name):
    T = block
    n_nodes, H = hr.shape
    nb = _check_grid(n_nodes, T)
    if H % 16 or H > 128:
        raise ValueError(f"fused_edge_fwd supports H in {{16, 32, ..., 128}} "
                         f"(multiples of 16), got H={H}")
    E = scal.shape[0]
    if E % nb or (E // nb) % T:
        raise ValueError(f"layout mismatch: N={n_nodes} E={E} block={T}")
    dev = x.device
    dt = _DTYPES[dtype_name]
    f32, i32 = torch.float32, torch.int32
    # the kernel reads the activations in the compute dtype, as the TPU
    # kernel's packed [hr || hc] array
    hr, hc = hr.to(dt).contiguous(), hc.to(dt).contiguous()
    w = weights
    ws, b1, w2, b2 = (w.ws.contiguous(), w.b1.reshape(-1).contiguous(),
                      w.w2.contiguous(), w.b2.reshape(-1).contiguous())
    w3, b3, w4 = (w.w3.contiguous(), w.b3.reshape(-1).contiguous(),
                  w.w4.reshape(-1).contiguous())
    for t, name, dtype, shape in (
            (x, "x", f32, (n_nodes, 3)), (hr, "hr", dt, (n_nodes, H)),
            (hc, "hc", dt, (n_nodes, H)),
            (row_t, "row_t", i32, (E // T, T)), (col_l, "col_l", i32, (E, 1)),
            (kblk, "kblk", i32, (E, 1)), (scal, "scal", f32, (E, XL)),
            (ws, "ws", f32, (3, H)), (b1, "b1", f32, (H,)),
            (w2, "w2", f32, (H, H)), (b2, "b2", f32, (H,)),
            (w3, "w3", f32, (H, H)), (b3, "b3", f32, (H,)),
            (w4, "w4", f32, (H,))):
        _check(t, name, dtype, shape, dev)

    out = torch.zeros((n_nodes, H + 8), dtype=f32, device=dev)
    fn = _launch_fn()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(row_t.data_ptr(), col_l.data_ptr(), kblk.data_ptr(),
             scal.data_ptr(), x.data_ptr(), hr.data_ptr(), hc.data_ptr(),
             ws.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
             w3.data_ptr(), b3.data_ptr(), w4.data_ptr(), out.data_ptr(),
             n_nodes, E, T, H, int(dtype_name == "bf16"), n_sm, stream)
    if err != 0:
        raise RuntimeError(f"fused_edge_fwd launch failed: CUDA error {err}")
    fused_edge_layer.launches += 1
    return out[:, 0:3] + out[:, 3:6], out[:, 6], out[:, 8:]


def fused_edge_layer(x, hr, hc, row_t, col_l, kblk, scal,
                     weights: EdgeWeights, block: int = 2048,
                     dtype_name: str = "bf16"):
    """Fused phi_e + phi_x + row aggregation over the blocked edge arrays.

    Args:
      x    [N, 3] f32 coordinates (Morton-ordered, block-padded)
      hr   [N, H] hoisted row features (h @ W_row, node axis)
      hc   [N, H] hoisted col features
      row_t/col_l/kblk/scal — ``build_edge_blocks`` output for one graph
      weights — EdgeWeights (f32)
      dtype_name — 'f32' or 'bf16': the MLPs' compute dtype
    Returns (trans_sum [N, 3] f32, count [N] f32, ef_sum [N, H] f32): the
    un-normalised in-window segment sums; the caller adds the remote tail.

    CUDA tensors run the CUDA kernel (a failed build or launch raises; there
    is no fallback); CPU tensors run :func:`fused_edge_layer_ref`.
    ``fused_edge_layer.launches`` counts the kernel launches.
    """
    if x.device.type == "cuda":
        return _fused_edge_layer_cuda(x, hr, hc, row_t, col_l, kblk, scal,
                                      weights, block, dtype_name)
    if x.device.type == "cpu":
        return fused_edge_layer_ref(x, hr, hc, row_t, col_l, kblk, scal,
                                    weights, block, dtype_name)
    raise ValueError(f"fused_edge_layer: unsupported device {x.device}")


fused_edge_layer.launches = 0
