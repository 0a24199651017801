"""Segment and masked reductions (port of ``distegnn_tpu/ops/segment.py``).

Three lowerings of the per-destination aggregation, as in the JAX package:

  scatter  ``index_add_`` (the JAX package's scatter-add);
  cumsum   scatter-free for ascending ids (GraphBatch.edges_sorted): a
           segment sum is the difference of two f32 prefix sums taken at the
           segment's CSR bounds, ``out[n] = P[end_n - 1] - P[start_n - 1]``
           (ops/cumsum.py ``prefix_sum``: the CUDA scan kernel on the card).
           Each sum carries the rounding of the shared prefix (~|prefix| *
           eps), so it is not bit-identical to the scatter lowering;
  ell      scatter-free and exact: each segment padded to the batch's max
           in-degree D, summed by D chained row gathers.

The segment ops here and the row/column gathers whose backward is one of
them are ``torch.autograd.Function``s with the JAX package's custom VJPs:
the backward of a segment sum is a row gather, and the backward of a gather
is a segment sum through the same lowering. So with ``cumsum`` every
backward aggregation is the scan kernel, and no scatter appears in either
direction.

Every function takes one graph (ids ``[E]``, data ``[E, ...]``) or a batch
(ids ``[B, E]``, data ``[B, E, ...]``); a batch runs as one call, so the
scan kernel is launched once for the B graphs.
"""

from __future__ import annotations

import torch

from distegnn_tpu_torch.ops.cumsum import prefix_sum


def _bcast(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return mask.to(data.dtype).reshape(
        tuple(mask.shape) + (1,) * (data.ndim - mask.ndim))


def _batched(fn):
    """Run ``fn(data [B, E, ...], ids [B, E], *rest) -> [B, N, ...]`` on one
    graph (ids [E]) by adding and removing the batch axis."""

    def wrapper(data, segment_ids, *rest, **kw):
        if segment_ids.ndim == 1:
            if kw.get("mask") is not None:
                kw["mask"] = kw["mask"][None]
            return fn(data[None], segment_ids[None], *rest, **kw)[0]
        return fn(data, segment_ids, *rest, **kw)

    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def take_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather along axis 1: data [B, N, ...], idx [B, E] ->
    [B, E, ...] (``jnp.take(data, idx, axis=0)`` per graph)."""
    B, E = idx.shape
    flat = data.reshape(B, data.shape[1], -1)
    out = torch.gather(flat, 1, idx.long()[..., None].expand(
        B, E, flat.shape[-1]))
    return out.reshape((B, E) + tuple(data.shape[2:]))


@_batched
def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask=None) -> torch.Tensor:
    """Sum ``data`` rows [.., E, ...] into ``num_segments`` buckets by
    ``segment_ids`` (``index_add_``; the JAX package's scatter-add). Rows
    with ``mask`` == 0 contribute nothing."""
    if mask is not None:
        data = data * _bcast(mask, data)
    B, E = segment_ids.shape
    idx = (segment_ids.long() + torch.arange(
        B, device=segment_ids.device)[:, None] * num_segments).reshape(-1)
    flat = data.reshape((B * E,) + tuple(data.shape[2:]))
    out = flat.new_zeros((B * num_segments,) + tuple(data.shape[2:]))
    out = out.index_add_(0, idx, flat)
    return out.reshape((B, num_segments) + tuple(data.shape[2:]))


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, mask=None) -> torch.Tensor:
    """Mean of ``data`` rows per segment; empty segments yield 0 (count
    clamped >= 1, counted in f32 whatever the data type)."""
    total = segment_sum(data, segment_ids, num_segments, mask=mask)
    ones = (torch.ones(segment_ids.shape, dtype=torch.float32,
                       device=data.device) if mask is None
            else mask.to(torch.float32))
    count = segment_sum(ones, segment_ids, num_segments)
    count = torch.clamp(count, min=1.0).to(data.dtype)
    return total / _bcast(count, total)


@_batched
def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask=None,
                initial: float = -1e30) -> torch.Tensor:
    """Per-segment max; empty segments yield ``initial``. Masked rows are
    replaced by ``initial`` first, so they never win."""
    if mask is not None:
        data = torch.where(_bcast(mask, data) > 0, data,
                           data.new_full((), initial))
    B, E = segment_ids.shape
    idx = (segment_ids.long() + torch.arange(
        B, device=segment_ids.device)[:, None] * num_segments).reshape(-1)
    flat = data.reshape((B * E,) + tuple(data.shape[2:]))
    idx = idx.reshape((-1,) + (1,) * (flat.ndim - 1)).expand(flat.shape)
    out = flat.new_full((B * num_segments,) + tuple(data.shape[2:]),
                        initial)
    out = out.scatter_reduce(0, idx, flat, "amax", include_self=True)
    return out.reshape((B, num_segments) + tuple(data.shape[2:]))


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask=None) -> torch.Tensor:
    """Numerically stable softmax over the rows sharing a segment id (the
    JAX package's replacement for DGL's edge_softmax). Masked rows get
    weight 0; a segment with no rows gives no weight. One graph or a
    batch, as :func:`segment_sum`."""
    if mask is not None:
        # mask BEFORE the exp: a masked row's raw score may exceed its
        # segment's real max, and exp(large) * 0 would be NaN
        scores = torch.where(_bcast(mask, scores) > 0, scores,
                             scores.new_full((), -1e30))
    one = segment_ids.ndim == 1
    ids = segment_ids[None] if one else segment_ids
    s = scores[None] if one else scores
    mx = segment_max(s, ids, num_segments)
    shifted = torch.clamp(s - take_rows(mx, ids), min=-80.0)
    e = torch.where(s > -1e29, torch.exp(shifted), s.new_zeros(()))
    denom = segment_sum(e, ids, num_segments)
    out = e / torch.clamp(take_rows(denom, ids), min=1e-30)
    return out[0] if one else out


def masked_sum(data: torch.Tensor, mask: torch.Tensor, axis: int):
    """Sum over ``axis`` counting only mask==1 elements (mask broadcasts from
    the left)."""
    return torch.sum(data * _bcast(mask, data), dim=axis)


def masked_mean(data: torch.Tensor, mask: torch.Tensor, axis: int,
                eps_count: float = 1.0):
    """Mean over ``axis`` counting only mask==1 elements (count clamped
    >= eps_count)."""
    m = _bcast(mask, data)
    total = torch.sum(data * m, dim=axis)
    count = torch.sum(m, dim=axis)
    return total / torch.clamp(count, min=eps_count)


# ----------------------------------------------------------------- cumsum

def _cs_bounds(segment_ids: torch.Tensor, num_segments: int):
    """CSR bounds [B, N] of ascending ids [B, E] (binary search)."""
    ids = segment_ids.contiguous()
    idx = torch.arange(num_segments, dtype=ids.dtype,
                       device=ids.device).expand(ids.shape[0], num_segments)
    idx = idx.contiguous()
    starts = torch.searchsorted(ids, idx, right=False)
    ends = torch.searchsorted(ids, idx, right=True)
    return starts, ends


def _cs_sum_impl(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """[B, E, ...] -> [B, N, ...] as prefix-sum differences (data dtype)."""
    B, E = segment_ids.shape
    c = prefix_sum(data.reshape(B, E, -1))                 # [B, E, F] f32
    starts, ends = _cs_bounds(segment_ids, num_segments)

    def at(bound):
        v = take_rows(c, torch.clamp(bound - 1, min=0))
        return torch.where((bound > 0)[..., None], v, v.new_zeros(()))

    out = (at(ends) - at(starts)).to(data.dtype)
    return out.reshape((B, num_segments) + tuple(data.shape[2:]))


class _SortedSegmentSumCs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        return _cs_sum_impl(data, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        # d out[n] / d data[e] = [ids[e] == n]: the pull-back is a gather
        (segment_ids,) = ctx.saved_tensors
        return take_rows(g, segment_ids), None, None


@_batched
def sorted_segment_sum_cs(data, segment_ids, num_segments):
    """Segment sum for ASCENDING ``segment_ids`` without any scatter. Rows
    to exclude must be zeroed by the caller (multiply by the mask first —
    that also routes the mask's gradient)."""
    return _SortedSegmentSumCs.apply(data, segment_ids, num_segments)


def segment_sum_cs(data, segment_ids, num_segments, mask=None):
    """:func:`segment_sum` on sorted ids, cumsum lowering."""
    if mask is not None:
        data = data * _bcast(mask, data)
    return sorted_segment_sum_cs(data, segment_ids, num_segments)


def _packed_mean(sum_fn, data, segment_ids, num_segments, mask):
    """Segment mean as ONE call of ``sum_fn``: the count rides the same pass
    as the data (one extra column), clamped >= 1. Shared by the cumsum and
    ELL lowerings."""
    lead = tuple(segment_ids.shape)
    flat = data.reshape(lead + (-1,))
    if mask is not None:
        m = mask.to(flat.dtype).reshape(lead + (1,))
        flat = flat * m
        ones = m
    else:
        ones = flat.new_ones(lead + (1,))
    packed = sum_fn(torch.cat([flat, ones], dim=-1), segment_ids,
                    num_segments)
    total, count = packed[..., :-1], packed[..., -1:]
    count = torch.clamp(count.to(torch.float32), min=1.0).to(data.dtype)
    return (total / count).reshape(
        lead[:-1] + (num_segments,) + tuple(data.shape[len(lead):]))


def segment_mean_cs(data, segment_ids, num_segments, mask=None):
    """:func:`segment_mean` on sorted ids, cumsum lowering."""
    return _packed_mean(sorted_segment_sum_cs, data, segment_ids,
                        num_segments, mask)


# ----------------------------------------------------------------- ELL

def _ell_sum_impl(data: torch.Tensor, segment_ids: torch.Tensor,
                  num_segments: int, max_in_degree: int,
                  degree_chunk: int = 8) -> torch.Tensor:
    """[B, E, ...] -> [B, N, ...] by fixed-degree gathers, chunked over the
    degree axis (one [B, N, K, F] gather + masked reduce per chunk of K =
    ``degree_chunk``), accumulated in f32."""
    B, E = segment_ids.shape
    N = num_segments
    flat = data.reshape(B, E, -1)
    starts, ends = _cs_bounds(segment_ids, N)
    out = flat.new_zeros((B, N, flat.shape[-1]), dtype=torch.float32)
    for d0 in range(0, max_in_degree, degree_chunk):
        k = min(degree_chunk, max_in_degree - d0)
        idx = starts[..., None] + torch.arange(d0, d0 + k,
                                               device=starts.device)
        valid = (idx < ends[..., None])[..., None]          # [B, N, K, 1]
        blk = take_rows(flat, torch.clamp(idx, max=E - 1).reshape(B, N * k))
        blk = blk.reshape(B, N, k, -1).to(torch.float32)
        out = out + torch.where(valid, blk, blk.new_zeros(())).sum(dim=2)
    return out.to(data.dtype).reshape((B, N) + tuple(data.shape[2:]))


class _SortedSegmentSumEll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, max_in_degree):
        ctx.save_for_backward(segment_ids)
        return _ell_sum_impl(data, segment_ids, num_segments, max_in_degree)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        return take_rows(g, segment_ids), None, None, None


@_batched
def sorted_segment_sum_ell(data, segment_ids, num_segments, max_in_degree):
    """Segment sum for ASCENDING ids via fixed-degree gathers. Rows to
    exclude must be zeroed by the caller; ``max_in_degree`` must cover
    every segment's real row count."""
    return _SortedSegmentSumEll.apply(data, segment_ids, num_segments,
                                      max_in_degree)


def segment_sum_ell(data, segment_ids, num_segments, max_in_degree,
                    mask=None):
    if mask is not None:
        data = data * _bcast(mask, data)
    return sorted_segment_sum_ell(data, segment_ids, num_segments,
                                  max_in_degree)


def segment_mean_ell(data, segment_ids, num_segments, max_in_degree,
                     mask=None):
    """Mean via one packed ELL pass (see :func:`_packed_mean`)."""
    return _packed_mean(
        lambda d, i, n: sorted_segment_sum_ell(d, i, n, max_in_degree),
        data, segment_ids, num_segments, mask)


# ------------------------------------------- gathers with a segment backward

class _GatherRows(torch.autograd.Function):
    """``h[rows]`` whose backward is the segment sum ``sum_impl`` over the
    ascending ``rows`` (no transpose-of-gather scatter). Padding rows may
    point at any node slot; their cotangent lands on that slot, as with
    ``torch.gather``'s own backward."""

    @staticmethod
    def forward(ctx, h, rows, sum_impl):
        ctx.save_for_backward(rows)
        ctx.n, ctx.sum_impl = h.shape[1], sum_impl
        return take_rows(h, rows)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        return ctx.sum_impl(g, rows, ctx.n), None, None


class _PairedGatherCols(torch.autograd.Function):
    """``h[cols]`` for a symmetric edge list whose backward rides the sorted
    row axis: the transpose of the column incidence is the reverse-edge
    permutation ``pair`` (ops/blocked.pairing_perm), so grad_h =
    segment_sum(g[pair] * mask, rows). Scatter-free in both directions."""

    @staticmethod
    def forward(ctx, h, cols, pair, rows, edge_mask, sum_impl):
        ctx.save_for_backward(pair, rows, edge_mask)
        ctx.n, ctx.sum_impl = h.shape[1], sum_impl
        return take_rows(h, cols)

    @staticmethod
    def backward(ctx, g):
        pair, rows, edge_mask = ctx.saved_tensors
        gp = take_rows(g, pair)
        gp = gp * _bcast(edge_mask, gp)
        return ctx.sum_impl(gp, rows, ctx.n), None, None, None, None, None


def _ell(max_in_degree):
    return lambda d, i, n: _ell_sum_impl(d, i, n, max_in_degree)


def gather_rows_cs(h, rows_sorted):
    """Batched ``h[b, rows[b]]`` ([B, N, ...] -> [B, E, ...]) whose backward
    is the cumsum segment sum (ids ascending)."""
    return _GatherRows.apply(h, rows_sorted, _cs_sum_impl)


def paired_gather_cols_cs(h, cols, pair, rows_sorted, edge_mask):
    """Batched ``h[b, cols[b]]`` whose backward is the reverse-edge
    permutation plus the cumsum segment sum."""
    return _PairedGatherCols.apply(h, cols, pair, rows_sorted, edge_mask,
                                   _cs_sum_impl)


def gather_rows_ell(h, rows_sorted, max_in_degree):
    """Batched ``h[b, rows[b]]`` whose backward is the ELL segment sum."""
    return _GatherRows.apply(h, rows_sorted, _ell(max_in_degree))


def paired_gather_cols_ell(h, cols, pair, rows_sorted, edge_mask,
                           max_in_degree):
    """Batched ``h[b, cols[b]]`` whose backward is the reverse-edge
    permutation plus the ELL segment sum."""
    return _PairedGatherCols.apply(h, cols, pair, rows_sorted, edge_mask,
                                   _ell(max_in_degree))
