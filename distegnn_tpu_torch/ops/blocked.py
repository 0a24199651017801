"""Blocked edge layout and its aggregation kernels (port of
``distegnn_tpu/ops/blocked.py``).

Edge lists are sorted by receiver row and padded so that every node block of
``block`` nodes owns a fixed slice of ``epb`` edge slots:

    edge slice [b*epb, (b+1)*epb)  holds exactly the edges whose receiver
    row lies in node block [b*block, (b+1)*block), padded with masked slots.

Padding slots carry row = col = (their block's last node), so the whole edge
list stays row-sorted. The fused edge kernel (ops/edge_pipeline.py) and the
blocked ``EdgeOps`` branches below read this layout.

Host half: ``blockify`` / ``prepare_blocked_graph`` / ``pairing_perm`` /
``scan_dataset_for_blocking`` / ``repack_blocked`` (the topology-only
``RepackPlan`` that the serve prep cache re-applies), through the C++ library of ``native.py``
where it builds and numpy otherwise (the same layout either way).

Device half: ``slot_ids`` turns (row, edge_mask) into block-local receiver
ids with the sentinel ``block`` for masked slots, ``blocked_plan`` turns
slot ids into their CSR (``BlockedPlan``: each node block's slot positions
stably sorted by slot, each node's range, the in-degree), and two ops
compute the blocked aggregation and its adjoint:

  blocked_segment_sum  [B, E, F] -> [B, N, F] f32: out[b*block + k] = sum of
                       the slots of block b with slot == k, in edge order
                       (sentinels add nothing);
  blocked_gather       [B, N, F] -> [B, E, F] in h's type: out[e] =
                       h[b*block + slot[e]], 0 at a sentinel.

A forward's slots are the same for every layer, so ``blocked_slot_inv_deg``
builds the plan once per forward (its degree gives ``inv_deg``) and every
segment sum of that forward and its backward reads it. On a CUDA tensor
each call launches the hand-written kernel ``csrc/blocked_onehot.cu`` once
for the whole batch (a segment sum called without a plan launches
``blocked_plan`` first); on a CPU tensor it runs the plain version
(``blocked_plan_ref``; ``blocked_segment_sum_ref`` / ``blocked_gather_ref``,
which follow the TPU kernels step by step: a [tile, block] one-hot per edge
tile, an f32 product with exact 0/1 factors, accumulated tile by tile, and
need no plan). Any other device is refused: there is no fallback. The two
ops are each other's VJP (``torch.autograd.Function``s), as in the JAX
package, and ``paired_col_gather`` is a plain column take whose backward is
the reverse-edge permutation followed by the segment sum. Launch counts:
``blocked_plan.launches``, ``blocked_segment_sum.launches`` /
``blocked_gather.launches``, and ``.launch_widths`` by (F, input type).

The ``einsum`` lowering (``blocked_impl='einsum'``, the JAX default) is
plain PyTorch: the one-hot incidence is materialised once per forward as a
bf16 ``[B, nb, epb, block]`` tensor and each op is a batched contraction of
its bf16 terms, taken in f32 (exact: 0/1 times a bf16-valued term).

``EdgeOps`` is the edge-op dispatch of the plain (``edge_impl='plain'``)
path: the blocked branches above when the batch is blocked, else the
``scatter`` / ``cumsum`` / ``ell`` lowerings of ops/segment.py.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from distegnn_tpu_torch.ops import segment as S

DEFAULT_BLOCK = 256       # nodes per block
DEFAULT_EDGE_TILE = 512   # edge slots per tile of the TPU kernels


# ---------------------------------------------------------------------------
# Host-side layout builder
# ---------------------------------------------------------------------------

def _blockify_plan(edge_index: np.ndarray, n_nodes_padded: int, epb: int,
                   block: int):
    """Arbitrary edge order -> (src, dst, blocked index, mask) in one pass.

    ``src`` are input-edge positions sorted stably by receiver row (so sorted
    input keeps its order bit for bit); ``dst`` is each sorted edge's slot
    ``block_idx*epb + rank_within_block``."""
    row = edge_index[0]
    e = int(row.shape[0])
    nb = n_nodes_padded // block
    src = np.argsort(row, kind="stable")
    rows = row[src]
    bounds = np.searchsorted(rows, np.arange(nb + 1) * block)
    counts = np.diff(bounds)
    if counts.max(initial=0) > epb:
        raise ValueError(
            f"blockify_edges: epb={epb} < max block degree {counts.max()}")
    if bounds[-1] != e:
        raise ValueError("blockify_edges: edge rows exceed n_nodes_padded")
    dst = (np.repeat(np.arange(nb, dtype=np.int64) * epb, counts)
           + np.arange(e, dtype=np.int64)
           - np.repeat(bounds[:-1].astype(np.int64), counts))
    E = nb * epb
    new_index = np.empty((2, E), np.int32)
    pad_rows = np.arange(1, nb + 1, dtype=np.int32) * block - 1
    new_index[0] = np.repeat(pad_rows, epb)
    new_index[1] = new_index[0]
    new_index[:, dst] = edge_index[:, src]
    new_mask = np.zeros((E,), np.float32)
    new_mask[dst] = 1.0
    return src, dst, new_index, new_mask


def blockify_edges(edge_index: np.ndarray, edge_attr: Optional[np.ndarray],
                   n_nodes_padded: int, epb: int, block: int = DEFAULT_BLOCK):
    """Re-lay one graph's edge list into per-block padded slices: returns
    (edge_index' [2, NB*epb], edge_attr' [NB*epb, D], edge_mask' [NB*epb])."""
    src, dst, new_index, new_mask = _blockify_plan(
        edge_index, n_nodes_padded, epb, block)
    D = edge_attr.shape[1] if edge_attr is not None else 0
    new_attr = np.zeros((new_mask.shape[0], D), np.float32)
    if D:
        new_attr[dst] = edge_attr[src]
    return new_index, new_attr, new_mask


class RepackPlan(NamedTuple):
    """Topology-only artifact of :func:`repack_blocked` — everything about a
    graph's blocked layout that does NOT depend on positions/attributes, so a
    session serving the same scene can re-apply it to fresh per-step arrays
    with two fancy-index gathers (the serve prep cache's hit path).

    perm[new] = old Morton node relabel (None when built without loc);
    edge_index/edge_mask are the blocked [2, NB*epb]/[NB*epb] arrays;
    src/dst map client edge k's payload to slot dst via attr'[dst] = attr[src].
    """
    perm: Optional[np.ndarray]
    edge_index: np.ndarray
    edge_mask: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    stamp: tuple                 # (n_nodes_padded, epb, block)

    def apply_edge_attr(self, edge_attr: np.ndarray) -> np.ndarray:
        out = np.zeros((self.edge_mask.shape[0], edge_attr.shape[1]),
                       np.float32)
        out[self.dst] = edge_attr[self.src]
        return out


def repack_blocked(edge_index: np.ndarray, loc: Optional[np.ndarray] = None,
                   *, n_nodes_padded: int, epb: int,
                   block: int = DEFAULT_BLOCK, bits: int = 16) -> RepackPlan:
    """Arbitrary client edge order -> the kernels' Morton/blocked layout in
    one vectorized NumPy pass (sort-by-(block, row), no per-block loop).

    When ``loc`` is given the node ids are first relabeled along the Z-order
    curve (ops/order.py) so spatially-near nodes share blocks — the layout
    the fused kernel's locality analysis assumes. Returns a :class:`RepackPlan`
    whose ``src``/``dst`` index maps let position-dependent payloads
    (edge_attr) be re-laid later without redoing the sort.
    """
    ei = np.asarray(edge_index).astype(np.int64, copy=False)
    perm = None
    if loc is not None:
        from distegnn_tpu_torch.ops.order import morton_perm

        perm = morton_perm(np.asarray(loc), bits=bits)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
        ei = inv[ei]
    src, dst, new_index, new_mask = _blockify_plan(
        ei, n_nodes_padded, epb, block)
    return RepackPlan(perm=perm, edge_index=new_index, edge_mask=new_mask,
                      src=src, dst=dst,
                      stamp=(n_nodes_padded, epb, block))


def max_block_degree(rows_sorted: np.ndarray, n_nodes_padded: int,
                     block: int) -> int:
    """Max number of edges landing in any single node block (sorted rows)."""
    nb = n_nodes_padded // block
    bounds = np.searchsorted(rows_sorted, np.arange(nb + 1) * block)
    return int(np.diff(bounds).max(initial=0))


def prepare_blocked_graph(g: dict, n_nodes_padded: int, epb: int,
                          block: int, compute_pair: bool = True) -> dict:
    """Blockify one graph dict (returns a copy): row-sort if needed, re-lay
    the edges per block, and attach the reverse-edge pairing of the blocked
    edge list (``_edge_pair``, None when the list is not symmetric or
    ``compute_pair`` is off). The copy carries ``_edge_mask`` (real slots)
    and the ``_blockified`` stamp; a dict already stamped with the same
    layout is returned unchanged. A dict blocked under other parameters is
    re-packed from its real edges (those of ``_edge_mask``)."""
    stamp = (n_nodes_padded, epb, block)
    if g.get("_blockified") == stamp:
        return g
    g = dict(g)
    if g.get("_blockified") is not None and g.get("_edge_mask") is not None:
        # padding slots must not become edges: keep the real ones only
        keep = g["_edge_mask"] > 0
        g["edge_index"] = g["edge_index"][:, keep]
        if g.get("edge_attr") is not None:
            g["edge_attr"] = g["edge_attr"][keep]
        for k in ("_edge_pair", "_edge_mask", "_blockified", "_remote_sel"):
            g.pop(k, None)
    if np.any(np.diff(g["edge_index"][0]) < 0):
        order = np.argsort(g["edge_index"][0], kind="stable")
        g["edge_index"] = g["edge_index"][:, order]
        if g.get("edge_attr") is not None:
            g["edge_attr"] = g["edge_attr"][order]
    from distegnn_tpu_torch.native import native_blockify

    ei64 = g["edge_index"].astype(np.int64)
    nat = native_blockify(ei64, g.get("edge_attr"), n_nodes_padded, epb,
                          block)
    ei, ea, em = (nat if nat is not None else blockify_edges(
        ei64, g.get("edge_attr"), n_nodes_padded, epb, block))
    g["edge_index"], g["edge_attr"], g["_edge_mask"] = ei, ea, em
    g["_edge_pair"] = pairing_perm_fast(ei) if compute_pair else None
    g["_blockified"] = stamp
    return g


def pairing_perm(edge_index: np.ndarray) -> Optional[np.ndarray]:
    """Reverse-edge involution P with edge_index[:, P[e]] == (col[e],
    row[e]), or None when the edge list is not symmetric. Works on blocked
    layouts too: padding slots carry row == col and pair among themselves."""
    r, c = edge_index[0], edge_index[1]
    by_rc = np.lexsort((c, r))
    by_cr = np.lexsort((r, c))
    pair = np.empty(r.shape[0], np.int64)
    pair[by_rc] = by_cr
    if not (np.array_equal(r[pair], c) and np.array_equal(c[pair], r)):
        return None
    return pair


def pairing_perm_fast(edge_index: np.ndarray) -> Optional[np.ndarray]:
    """:func:`pairing_perm` through the C++ library (native/blockify.cpp)
    where it builds, numpy otherwise: the same permutation, or None when
    the list is not symmetric."""
    from distegnn_tpu_torch.native import native_pairing

    pair = native_pairing(edge_index)
    if pair is None:
        return pairing_perm(edge_index)
    return None if pair is False else pair


def scan_dataset_for_blocking(dataset, n_nodes_padded: int, block: int):
    """One pass over a dataset: (max block degree, every-graph-symmetric).
    Both are layout decisions made once per dataset, so every batch of a run
    has one shape."""
    deg, symmetric = 1, True
    for i in range(len(dataset)):
        ei = dataset[i]["edge_index"]
        deg = max(deg, max_block_degree(np.sort(ei[0]), n_nodes_padded, block))
        symmetric = symmetric and pairing_perm_fast(ei) is not None
    return deg, symmetric


# ---------------------------------------------------------------------------
# Device half: slot ids, the kernels and their plain versions
# ---------------------------------------------------------------------------

def slot_ids(row: torch.Tensor, edge_mask: torch.Tensor, block: int,
             epb: int) -> torch.Tensor:
    """Block-local receiver ids with a sentinel for padding: row/edge_mask
    [..., E] in the blocked layout -> int32 [..., E]; a real edge at
    position k gets ``row - (k // epb) * block`` in [0, block), a masked slot
    ``block``, which no node of the block matches."""
    E = row.shape[-1]
    blk = (torch.arange(E, dtype=torch.int32, device=row.device) // epb) \
        * block
    local = row.to(torch.int32) - blk
    return torch.where(edge_mask > 0, local,
                       torch.full_like(local, block))


def _plan_layout(E: int, n_nodes: int, block: int):
    """(node blocks, slots per block), with the JAX package's checks."""
    nb, rem = divmod(n_nodes, block)
    if rem or nb < 1:
        raise ValueError(f"n_nodes {n_nodes} not a multiple of block {block}")
    epb, rem = divmod(E, nb)
    if rem:
        raise ValueError(f"E {E} not a multiple of num_blocks {nb}")
    return nb, epb


def _layout(E: int, n_nodes: int, block: int, tile: int):
    """(node blocks, tiles per block), with the JAX package's checks."""
    nb, epb = _plan_layout(E, n_nodes, block)
    ept, rem = divmod(epb, tile)
    if rem:
        raise ValueError(f"edges/block {epb} not a multiple of tile {tile}")
    return nb, ept


class BlockedPlan(NamedTuple):
    """The CSR of one slot tensor [B, E] over node blocks of ``block``
    nodes and ``epb`` slots (:func:`blocked_plan`):

      perm [B, E] int32            each node block's block-local slot
                                   positions (0..epb-1) stably sorted by
                                   slot, the sentinels last;
      off  [B, nb, block + 1] int32  node k of block bi owns
                                   perm[b, bi*epb + off[b, bi, k] :
                                   bi*epb + off[b, bi, k + 1]];
      deg  [B, N, 1] f32           the in-degree off[k + 1] - off[k]
                                   (an integer count, exact in f32)."""
    perm: torch.Tensor
    off: torch.Tensor
    deg: torch.Tensor


def blocked_plan_ref(slot: torch.Tensor, num_segments: int,
                     block: int = DEFAULT_BLOCK) -> BlockedPlan:
    """Plain PyTorch version of the plan kernel: a stable argsort of each
    node block's slots (sentinels, any value outside [0, block), as
    ``block``), the per-node counts by ``bincount`` and their exclusive
    ``cumsum``."""
    B, E = slot.shape
    nb, epb = _plan_layout(E, num_segments, block)
    s = slot.reshape(B, nb, epb)
    key = torch.where((s >= 0) & (s < block), s, torch.full_like(s, block))
    perm = torch.argsort(key, dim=-1, stable=True).to(torch.int32)
    bucket = key.long() + (block + 1) * torch.arange(
        B * nb, device=slot.device).reshape(B, nb, 1)
    counts = torch.bincount(bucket.reshape(-1),
                            minlength=B * nb * (block + 1)).reshape(
        B, nb, block + 1)[..., :block]
    off = torch.zeros((B, nb, block + 1), dtype=torch.int32,
                      device=slot.device)
    off[..., 1:] = torch.cumsum(counts, dim=-1)
    deg = counts.to(torch.float32).reshape(B, num_segments, 1)
    return BlockedPlan(perm.reshape(B, E), off, deg)


def _tile_onehots(slot: torch.Tensor, nb: int, ept: int, tile: int,
                  block: int):
    """The [B, nb, tile, block] f32 one-hot of each edge tile, in order (an
    iota compare, as in the TPU kernels)."""
    s = slot.reshape(slot.shape[0], nb, ept, tile)
    iota = torch.arange(block, dtype=torch.int32, device=slot.device)
    for t in range(ept):
        yield t, (s[:, :, t, :, None] == iota).to(torch.float32)


def blocked_segment_sum_ref(data: torch.Tensor, slot: torch.Tensor,
                            num_segments: int, block: int = DEFAULT_BLOCK,
                            tile: int = DEFAULT_EDGE_TILE,
                            plan: Optional[BlockedPlan] = None
                            ) -> torch.Tensor:
    """Plain PyTorch version of the segment-sum kernel, step by step after
    ``_seg_sum_kernel``: per edge tile, out[block b] += onehot[tile,
    block]^T @ data[tile, F] in f32 (exact 0/1 factors; bf16 data widened
    exactly), tiles accumulated in order. [B, E, F] -> [B, N, F] f32.
    ``plan`` is accepted for the kernel's signature and not needed."""
    B, E, F = data.shape
    nb, ept = _layout(E, num_segments, block, tile)
    d = data.to(torch.float32).reshape(B, nb, ept, tile, F)
    out = torch.zeros((B, nb, block, F), dtype=torch.float32,
                      device=data.device)
    for t, oh in _tile_onehots(slot, nb, ept, tile, block):
        out = out + oh.transpose(-1, -2) @ d[:, :, t]
    return out.reshape(B, num_segments, F)


def blocked_gather_ref(h: torch.Tensor, slot: torch.Tensor,
                       block: int = DEFAULT_BLOCK,
                       tile: int = DEFAULT_EDGE_TILE) -> torch.Tensor:
    """Plain PyTorch version of the gather kernel, after ``_gather_kernel``:
    per edge tile, onehot[tile, block] @ h[block b] in f32, cast to h's
    type. [B, N, F] -> [B, E, F]."""
    B, N, F = h.shape
    E = slot.shape[-1]
    nb, ept = _layout(E, N, block, tile)
    hb = h.to(torch.float32).reshape(B, nb, block, F)
    parts = [oh @ hb for _, oh in _tile_onehots(slot, nb, ept, tile, block)]
    out = torch.stack(parts, dim=2)                  # [B, nb, ept, tile, F]
    return out.reshape(B, E, F).to(h.dtype)


def blocked_segment_sum_inorder(data: torch.Tensor, plan: BlockedPlan,
                                block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """The in-order f32 segment sum through a plan: a dense [B, N, max
    degree, F] gather of each node's rows (zeros past its degree), summed
    over the degree axis one step at a time from 0. The CUDA segment sum
    adds each node's rows in the same order, so it equals this bit for
    bit. [B, E, F] -> [B, N, F] f32."""
    B, E, F = data.shape
    nb = plan.off.shape[1]
    epb = E // nb
    N = nb * block
    start = plan.off[..., :block].reshape(B, N).long()
    deg = plan.deg.reshape(B, N).long()
    width = int(deg.max()) if deg.numel() else 0
    base = (torch.arange(N, device=data.device) // block) * epb
    out = torch.zeros((B, N, F), dtype=torch.float32, device=data.device)
    for d in range(width):
        live = d < deg
        j = torch.where(live, base + start + d, torch.zeros_like(start))
        rows = torch.gather(plan.perm.long(), 1, j) + base
        step = torch.gather(data, 1, rows[..., None].expand(B, N, F))
        out = out + torch.where(live[..., None], step.to(torch.float32),
                                torch.zeros((), device=data.device))
    return out


def _lib_fn(name: str, n_ptr: int, n_int: int):
    """The C entry point ``name``: ``n_ptr`` pointers, ``n_int`` ints, the
    stream."""
    from distegnn_tpu_torch.ops.build import LIBRARIES

    fn = getattr(LIBRARIES.get("blocked_onehot"), name)
    if fn.argtypes is None:
        # pointers (and the stream) as c_void_p: ctypes would pass a bare
        # Python int as a 32-bit int and cut the pointer
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
        fn.restype = ctypes.c_int
    return fn


def _kernel_args(x: torch.Tensor, slot: torch.Tensor, E: int, what: str):
    """Checks before a launch; E is the slot count the kernel will read."""
    if (x.ndim != 3 or slot.ndim != 2 or slot.shape[0] != x.shape[0]
            or slot.shape[1] != E):
        raise ValueError(f"{what} takes [B, *, F] and slots [B, E] with "
                         f"E = {E}, got {tuple(x.shape)} and "
                         f"{tuple(slot.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} takes f32 or bf16, got {x.dtype}")
    if slot.device != x.device:
        raise ValueError(f"{what}: slots on {slot.device}, data on "
                         f"{x.device}")
    if x.shape[0] > 65535 or x.shape[-1] > 65535 * 32:
        raise ValueError(f"{what}: B <= 65535 and F <= {65535 * 32}, got "
                         f"{tuple(x.shape)}")
    # .to() costs host time even when it has nothing to do: these wrappers
    # run dozens of times a rollout step
    if slot.dtype != torch.int32:
        slot = slot.to(torch.int32)
    return x.contiguous(), slot.contiguous()


def _plan_cuda(slot: torch.Tensor, num_segments: int,
               block: int) -> BlockedPlan:
    """Launch ``csrc/blocked_onehot.cu`` ``blocked_plan`` once for the
    batch; counted once."""
    if slot.ndim != 2:
        raise ValueError(f"blocked_plan takes slots [B, E], got "
                         f"{tuple(slot.shape)}")
    B, E = slot.shape
    nb, epb = _plan_layout(E, num_segments, block)
    if block > 1024 or B > 65535 or nb > 65535:
        raise ValueError(f"blocked_plan takes block <= 1024 and B, nb <= "
                         f"65535, got block={block} B={B} nb={nb}")
    if slot.dtype != torch.int32:
        slot = slot.to(torch.int32)
    slot = slot.contiguous()
    dev = slot.device
    perm = torch.empty((B, E), dtype=torch.int32, device=dev)
    off = torch.empty((B, nb, block + 1), dtype=torch.int32, device=dev)
    deg = torch.empty((B, num_segments, 1), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib_fn("blocked_plan", 4, 4)(slot.data_ptr(), perm.data_ptr(),
                                        off.data_ptr(), deg.data_ptr(), B,
                                        nb, epb, block, stream)
    if err != 0:
        raise RuntimeError(f"blocked_plan launch failed: CUDA error {err}")
    blocked_plan.launches += 1
    return BlockedPlan(perm, off, deg)


def _seg_sum_cuda(data: torch.Tensor, slot: torch.Tensor, num_segments: int,
                  block: int, tile: int,
                  plan: Optional[BlockedPlan] = None) -> torch.Tensor:
    """Launch ``csrc/blocked_onehot.cu`` ``blocked_seg_sum`` once for the
    batch, reading the slots through ``plan`` (built first, one counted
    ``blocked_plan`` launch, when none is given); counted once."""
    B, E, F = data.shape
    nb, _ = _layout(E, num_segments, block, tile)
    if block > 1024:
        raise ValueError(f"blocked_seg_sum takes block <= 1024, got {block}")
    data, slot = _kernel_args(data, slot, E, "blocked_segment_sum")
    if plan is None:
        plan = _plan_cuda(slot, num_segments, block)
    elif (tuple(plan.perm.shape) != (B, E)
          or tuple(plan.off.shape) != (B, nb, block + 1)
          or plan.perm.dtype != torch.int32 or plan.off.dtype != torch.int32
          or plan.perm.device != data.device
          or plan.off.device != data.device):
        raise ValueError(f"blocked_segment_sum: a plan of perm "
                         f"{tuple(plan.perm.shape)} / off "
                         f"{tuple(plan.off.shape)} does not fit slots "
                         f"{(B, E)} over {nb} blocks of {block}")
    out = torch.empty((B, num_segments, F), dtype=torch.float32,
                      device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    bf16 = data.dtype == torch.bfloat16
    err = _lib_fn("blocked_seg_sum", 4, 6)(
        data.data_ptr(), plan.perm.data_ptr(), plan.off.data_ptr(),
        out.data_ptr(), B, nb, E // nb, F, block, int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"blocked_seg_sum launch failed: CUDA error {err}")
    blocked_segment_sum.launches += 1
    blocked_segment_sum.launch_widths[(F, "bf16" if bf16 else "f32")] += 1
    return out


def _gather_cuda(h: torch.Tensor, slot: torch.Tensor, block: int,
                 tile: int) -> torch.Tensor:
    """Launch ``csrc/blocked_onehot.cu`` ``blocked_gather`` (or, for rows
    of at most 16 bytes, ``blocked_gather_rows``) once for the batch;
    counted once."""
    B, N, F = h.shape
    E = slot.shape[-1]
    nb, _ = _layout(E, N, block, tile)
    if max(E, N) * F >= 2 ** 30:
        raise ValueError(f"blocked_gather takes E*F and N*F < 2^30 per graph, "
                         f"got E={E} N={N} F={F}")
    h, slot = _kernel_args(h, slot, E, "blocked_gather")
    out = torch.empty((B, E, F), dtype=h.dtype, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    # rows of at most 16 bytes take the one-thread-per-row form
    name = ("blocked_gather_rows" if F * h.element_size() <= 16
            else "blocked_gather")
    err = _lib_fn(name, 3, 6)(h.data_ptr(), slot.data_ptr(), out.data_ptr(),
                              B, nb, E // nb, F, block, h.element_size(),
                              stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    blocked_gather.launches += 1
    blocked_gather.launch_widths[
        (F, "bf16" if h.dtype == torch.bfloat16 else "f32")] += 1
    return out


def _plan_impl(slot, num_segments, block):
    """CUDA tensors take the kernel, CPU tensors the plain version."""
    if slot.device.type == "cuda":
        return _plan_cuda(slot, num_segments, block)
    if slot.device.type == "cpu":
        return blocked_plan_ref(slot, num_segments, block)
    raise ValueError(f"blocked_plan: unsupported device {slot.device}")


def _seg_sum_impl(data, slot, num_segments, block, tile, plan=None):
    """CUDA tensors take the kernel, CPU tensors the plain version."""
    if data.device.type == "cuda":
        return _seg_sum_cuda(data, slot, num_segments, block, tile, plan)
    if data.device.type == "cpu":
        return blocked_segment_sum_ref(data, slot, num_segments, block, tile,
                                       plan)
    raise ValueError(f"blocked_segment_sum: unsupported device {data.device}")


def _gather_impl(h, slot, block, tile):
    if h.device.type == "cuda":
        return _gather_cuda(h, slot, block, tile)
    if h.device.type == "cpu":
        return blocked_gather_ref(h, slot, block, tile)
    raise ValueError(f"blocked_gather: unsupported device {h.device}")


def _save_plan(ctx, plan, *tensors):
    """Save ``tensors`` and the plan's tensors (if any) for the backward."""
    ctx.has_plan = plan is not None
    ctx.save_for_backward(*tensors, *((plan.perm, plan.off, plan.deg)
                                      if plan is not None else ()))


def _saved(ctx, n):
    """The ``n`` saved tensors and the saved plan (or None)."""
    saved = ctx.saved_tensors
    return saved[:n], BlockedPlan(*saved[n:]) if ctx.has_plan else None


class _SegSum(torch.autograd.Function):
    # the VJP of the aggregation is the gather of the cotangent, in the
    # data's type
    @staticmethod
    def forward(ctx, data, slot, num_segments, block, tile, plan):
        ctx.save_for_backward(slot)
        ctx.cfg, ctx.dtype = (block, tile), data.dtype
        return _seg_sum_impl(data, slot, num_segments, block, tile, plan)

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        return (_gather_impl(g.to(ctx.dtype), slot, *ctx.cfg),
                None, None, None, None, None)


class _Gather(torch.autograd.Function):
    # the VJP of the gather is the aggregation of the cotangent, cast to h's
    # type, through the forward's plan
    @staticmethod
    def forward(ctx, h, slot, block, tile, plan):
        _save_plan(ctx, plan, slot)
        ctx.cfg, ctx.n, ctx.dtype = (block, tile), h.shape[1], h.dtype
        return _gather_impl(h, slot, block, tile)

    @staticmethod
    def backward(ctx, g):
        (slot,), plan = _saved(ctx, 1)
        return (_seg_sum_impl(g, slot, ctx.n, *ctx.cfg, plan).to(ctx.dtype),
                None, None, None, None)


class _PairedGather(torch.autograd.Function):
    # h[col]: the transpose of a symmetric graph's column incidence is the
    # edge permutation ``pair``, so grad_h = seg_sum(g[pair], slot)
    @staticmethod
    def forward(ctx, h, col, pair, slot, block, tile, plan):
        _save_plan(ctx, plan, pair, slot)
        ctx.cfg, ctx.n, ctx.dtype = (block, tile), h.shape[1], h.dtype
        return S.take_rows(h, col)

    @staticmethod
    def backward(ctx, g):
        (pair, slot), plan = _saved(ctx, 2)
        grad_h = _seg_sum_impl(S.take_rows(g, pair), slot, ctx.n, *ctx.cfg,
                               plan)
        return grad_h.to(ctx.dtype), None, None, None, None, None, None


def blocked_plan(slot, num_segments: int, block: int = DEFAULT_BLOCK
                 ) -> BlockedPlan:
    """The CSR of ``slot`` [B, E] (from :func:`slot_ids`) over node blocks
    of ``block`` nodes: a :class:`BlockedPlan`, built once per slot tensor
    and read by every segment sum over it."""
    return _plan_impl(slot, num_segments, block)


def blocked_segment_sum(data, slot, num_segments: int,
                        block: int = DEFAULT_BLOCK,
                        tile: int = DEFAULT_EDGE_TILE,
                        plan: Optional[BlockedPlan] = None):
    """Batched [B, E, F] -> [B, N, F] f32. ``slot`` from :func:`slot_ids`
    (masked slots carry the sentinel and contribute nothing); ``plan`` its
    :func:`blocked_plan` (on the card a call without one builds it)."""
    return _SegSum.apply(data, slot, num_segments, block, tile, plan)


def blocked_gather(h, slot, block: int = DEFAULT_BLOCK,
                   tile: int = DEFAULT_EDGE_TILE,
                   plan: Optional[BlockedPlan] = None):
    """Batched [B, N, F] -> [B, E, F]; rows fetched block-locally (masked
    slots read as 0). Adjoint of :func:`blocked_segment_sum`, whose
    backward segment sum reads ``plan``."""
    return _Gather.apply(h, slot, block, tile, plan)


def paired_col_gather(h, col, pair, slot, block: int = DEFAULT_BLOCK,
                      tile: int = DEFAULT_EDGE_TILE,
                      plan: Optional[BlockedPlan] = None):
    """Batched h[b, col[b, e]] whose backward is the reverse-edge
    permutation plus the blocked segment sum (no scatter) through
    ``plan``."""
    return _PairedGather.apply(h, col, pair, slot, block, tile, plan)


blocked_plan.launches = 0
blocked_segment_sum.launches = 0
blocked_segment_sum.launch_widths = collections.Counter()
blocked_gather.launches = 0
blocked_gather.launch_widths = collections.Counter()


# ---------------------------------------------------------------------------
# The einsum lowering (blocked_impl='einsum'): plain PyTorch
# ---------------------------------------------------------------------------

def onehot_blocks(slot: torch.Tensor, epb: int, block: int) -> torch.Tensor:
    """[..., E] slot ids -> [..., nb, epb, block] bf16 one-hot incidence.
    Sentinel slots (== block) match no column and vanish."""
    E = slot.shape[-1]
    s = slot.reshape(tuple(slot.shape[:-1]) + (E // epb, epb))
    iota = torch.arange(block, dtype=torch.int32, device=slot.device)
    return (s[..., None] == iota).to(torch.bfloat16)


_BF16_TERMS = 3


def _bf16_terms(x: torch.Tensor):
    """Split x into _BF16_TERMS bf16 terms summing to x up to ~2^-24
    relative error; bf16 input passes through unsplit."""
    if x.dtype == torch.bfloat16:
        return [x]
    terms = []
    rem = x.to(torch.float32)
    for _ in range(_BF16_TERMS - 1):
        t = rem.to(torch.bfloat16)
        terms.append(t)
        rem = rem - t.to(torch.float32)
    terms.append(rem.to(torch.bfloat16))
    return terms


def _ein_seg_sum_raw(data: torch.Tensor, oh: torch.Tensor) -> torch.Tensor:
    """[..., E, F] x [..., nb, epb, block] -> [..., nb*block, F] f32. Each
    bf16 term is contracted in f32: exact products, f32 sums."""
    *lead, E, F = data.shape
    nb, epb, block = oh.shape[-3:]
    d = data.reshape(*lead, nb, epb, F)
    ohf = oh.to(torch.float32)
    out = None
    for t in _bf16_terms(d):
        part = torch.einsum("...bek,...bef->...bkf", ohf, t.to(torch.float32))
        out = part if out is None else out + part
    return out.reshape(*lead, nb * block, F)


def _ein_gather_raw(h: torch.Tensor, oh: torch.Tensor) -> torch.Tensor:
    """[..., N, F] x [..., nb, epb, block] -> [..., E, F] f32 (sentinel
    slots read as 0)."""
    *lead, N, F = h.shape
    nb, epb, block = oh.shape[-3:]
    hh = h.reshape(*lead, nb, block, F)
    ohf = oh.to(torch.float32)
    out = None
    for t in _bf16_terms(hh):
        part = torch.einsum("...bek,...bkf->...bef", ohf, t.to(torch.float32))
        out = part if out is None else out + part
    return out.reshape(*lead, nb * epb, F)


# The raw forms are exact adjoints, but differentiating through the bf16
# term split would round the cotangent to bf16; these backwards split the
# cotangent itself instead, as the JAX package's custom VJPs do.

class _EinSegSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, oh):
        ctx.save_for_backward(oh)
        ctx.dtype = data.dtype
        return _ein_seg_sum_raw(data, oh)

    @staticmethod
    def backward(ctx, g):
        (oh,) = ctx.saved_tensors
        return _ein_gather_raw(g, oh).to(ctx.dtype), None


class _EinGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, oh):
        ctx.save_for_backward(oh)
        ctx.dtype = h.dtype
        return _ein_gather_raw(h, oh).to(h.dtype)

    @staticmethod
    def backward(ctx, g):
        (oh,) = ctx.saved_tensors
        return _ein_seg_sum_raw(g, oh).to(ctx.dtype), None


class _PairedGatherEin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, col, pair, oh):
        ctx.save_for_backward(pair, oh)
        ctx.dtype = h.dtype
        return S.take_rows(h, col)

    @staticmethod
    def backward(ctx, g):
        pair, oh = ctx.saved_tensors
        grad_h = _ein_seg_sum_raw(S.take_rows(g, pair), oh)
        return grad_h.to(ctx.dtype), None, None, None


def einsum_segment_sum(data, oh):
    """[..., E, F] -> [..., N, F] f32 through the materialised one-hot."""
    return _EinSegSum.apply(data, oh)


def einsum_gather(h, oh):
    """[..., N, F] -> [..., E, F] in h's type (0 at sentinel slots)."""
    return _EinGather.apply(h, oh)


def paired_gather_ein(h, col, pair, oh):
    """Batched h[b, col[b, e]] whose backward is the reverse-edge
    permutation plus the einsum segment sum."""
    return _PairedGatherEin.apply(h, col, pair, oh)


def blocked_slot_inv_deg(g, impl: str = "einsum"):
    """(slot ids, 1/max(in-degree, 1) [B, N, 1], one-hot incidence or None,
    plan or None) for a blocked GraphBatch, or four Nones when g is not
    blocked. Computed once per forward: row and edge_mask are the same for
    every layer. ``impl``: 'pallas' (the kernels; the slots' plan, built
    once here and read by every segment sum of the forward and its
    backward, and the degree its node counts) or 'einsum' (the one-hot
    materialised; the degree is its column sum)."""
    if g.edge_block <= 0:
        return None, None, None, None
    slot = slot_ids(g.row, g.edge_mask, g.edge_block, g.edges_per_block)
    if impl == "einsum":
        plan = None
        oh = onehot_blocks(slot, g.edges_per_block, g.edge_block)
        deg = torch.sum(oh, dim=-2, dtype=torch.float32).reshape(
            oh.shape[0], g.max_nodes, 1)
    elif impl == "pallas":
        oh = None
        plan = blocked_plan(slot, g.max_nodes, g.edge_block)
        deg = plan.deg
    else:
        raise ValueError(f"unknown blocked impl {impl!r}")
    return slot, 1.0 / torch.clamp(deg, min=1.0), oh, plan


# ---------------------------------------------------------------------------
# EdgeOps
# ---------------------------------------------------------------------------

class EdgeOps:
    """Row/column gathers and per-destination aggregations of one batch
    (port of the JAX package's ``EdgeOps``), lowered as

      blocked  the batch carries the blocked layout: the kernels above
               (``oh is None``) or the einsum lowering (``oh`` given), with
               the reverse-edge pairing backward of the column gathers when
               the batch carries ``edge_pair``;
      cumsum   ``seg_impl='cumsum'`` on a plain row-sorted batch:
               prefix-sum differences (the CUDA scan kernel on the card)
               with gather-only backwards;
      ell      ``seg_impl='ell'`` on a plain row-sorted batch carrying
               ``max_in_degree``: fixed-degree chained gathers (exact);
      scatter  ``index_add_`` otherwise (the exact reference lowering).

    ``slot``/``inv_deg``/``oh``/``plan`` come from
    :func:`blocked_slot_inv_deg`, computed once per forward. As in the JAX package, a lowering the batch
    cannot support (a blocked batch, unsorted rows, no ``max_in_degree``)
    is not taken."""

    def __init__(self, g, slot=None, inv_deg=None, oh=None, plan=None,
                 seg_impl: str = "scatter"):
        if seg_impl not in ("scatter", "cumsum", "ell"):
            raise ValueError(f"unknown seg_impl {seg_impl!r}")
        self.g, self.slot, self.inv_deg, self.oh = g, slot, inv_deg, oh
        self.plan = plan
        self.blocked = slot is not None
        self.cumsum = (seg_impl == "cumsum" and not self.blocked
                       and g.edges_sorted)
        self.ell = (seg_impl == "ell" and not self.blocked
                    and g.edges_sorted and g.max_in_degree > 0)

    def gather_rows(self, data):
        if self.blocked:
            if self.oh is not None:
                return einsum_gather(data, self.oh)
            return blocked_gather(data, self.slot, self.g.edge_block,
                                  self.g.edge_tile, self.plan)
        if self.cumsum:
            return S.gather_rows_cs(data, self.g.row)
        if self.ell:
            return S.gather_rows_ell(data, self.g.row, self.g.max_in_degree)
        return S.take_rows(data, self.g.row)

    def gather_cols(self, data):
        g = self.g
        if self.blocked and g.edge_pair is not None:
            if self.oh is not None:
                return paired_gather_ein(data, g.col, g.edge_pair, self.oh)
            return paired_col_gather(data, g.col, g.edge_pair, self.slot,
                                     g.edge_block, g.edge_tile, self.plan)
        if self.cumsum and g.edge_pair is not None:
            return S.paired_gather_cols_cs(data, g.col, g.edge_pair, g.row,
                                           g.edge_mask)
        if self.ell and g.edge_pair is not None:
            return S.paired_gather_cols_ell(data, g.col, g.edge_pair, g.row,
                                            g.edge_mask, g.max_in_degree)
        return S.take_rows(data, g.col)

    def _agg(self, data, mean: bool):
        g = self.g
        N = g.max_nodes
        if self.blocked:
            if self.oh is not None:
                out = einsum_segment_sum(data, self.oh)
            else:
                out = blocked_segment_sum(data, self.slot, N, g.edge_block,
                                          g.edge_tile, self.plan)
            if mean:
                out = out * self.inv_deg
            return out.to(data.dtype)
        if self.cumsum:
            fn = S.segment_mean_cs if mean else S.segment_sum_cs
            return fn(data, g.row, N, mask=g.edge_mask)
        if self.ell:
            fn = S.segment_mean_ell if mean else S.segment_sum_ell
            return fn(data, g.row, N, g.max_in_degree, mask=g.edge_mask)
        fn = S.segment_mean if mean else S.segment_sum
        return fn(data, g.row, N, mask=g.edge_mask)

    def agg_rows_mean(self, data):
        """Per-destination mean over real edges (count clamped >= 1)."""
        return self._agg(data, mean=True)

    def agg_rows_sum(self, data):
        return self._agg(data, mean=False)

    def agg_rows_pair(self, a, b, a_mean: bool, agg_dtype=None):
        """Aggregate TWO edge streams: returns (sum or mean of ``a``, mean
        of ``b``), both f32. On a plain batch ``a`` [B, E, Sa], ``b`` [B, E,
        Sb] and the count ride one packed [B, E, Sa + Sb + 1] stream (one
        prefix scan per layer on the cumsum lowering); a blocked batch takes
        two calls (the mean is a multiply by ``inv_deg`` there).

        ``agg_dtype='bf16'`` casts the stream(s) to bf16 first (half the
        bytes; the sums still accumulate in f32, and the coordinate
        translations in ``a`` are rounded — equivariance becomes
        approximate)."""
        bf16 = agg_dtype in ("bf16", "bfloat16", torch.bfloat16)
        if self.blocked:
            if bf16:
                a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
            out_a = self.agg_rows_mean(a) if a_mean else self.agg_rows_sum(a)
            return (out_a.to(torch.float32),
                    self.agg_rows_mean(b).to(torch.float32))
        g = self.g
        B, E = b.shape[0], b.shape[1]
        sa = a.shape[-1]
        dt = torch.bfloat16 if bf16 else torch.float32
        em = g.edge_mask[..., None].to(dt)
        packed = torch.cat([a.to(dt), b.to(dt),
                            a.new_ones((B, E, 1), dtype=dt)], dim=-1) * em
        N = g.max_nodes
        if self.cumsum:
            out = S.sorted_segment_sum_cs(packed, g.row, N).to(torch.float32)
        elif self.ell:
            out = S.sorted_segment_sum_ell(packed, g.row, N,
                                           g.max_in_degree).to(torch.float32)
        else:
            # an f32 accumulator whatever the stream type
            out = S.segment_sum(packed.to(torch.float32), g.row, N)
        cnt = torch.clamp(out[..., -1:], min=1.0)
        out_a = out[..., :sa] / cnt if a_mean else out[..., :sa]
        return out_a, out[..., sa:-1] / cnt
