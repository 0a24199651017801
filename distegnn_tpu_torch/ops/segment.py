"""Segment and masked reductions (port of the parts of
``distegnn_tpu/ops/segment.py`` the fused serving path uses)."""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask=None) -> torch.Tensor:
    """Sum ``data`` rows [E, ...] into ``num_segments`` buckets by
    ``segment_ids`` [E] (``index_add_``; the JAX package's scatter-add).
    Rows with ``mask`` [E] == 0 contribute nothing."""
    if mask is not None:
        data = data * _bcast(mask, data)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def _bcast(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return mask.to(data.dtype).reshape(
        tuple(mask.shape) + (1,) * (data.ndim - mask.ndim))


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
