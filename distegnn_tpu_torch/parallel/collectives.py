"""Global node reductions (port of ``distegnn_tpu/parallel/collectives.py``).

Only the single-device form exists so far: ``axis_name`` must be None.
Sharded graphs (the cross-partition sums over ``torch.distributed``) are a
later slice of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from distegnn_tpu_torch.ops.segment import masked_sum


def _single_device(axis_name: Optional[str]) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            f"axis_name={axis_name!r}: cross-partition reductions over "
            "torch.distributed come in a later slice of the port")


def global_node_sum(data: torch.Tensor, mask: torch.Tensor,
                    axis_name: Optional[str] = None):
    """Masked sum over the node axis (axis 1 of [B, N, ...]).
    Returns ([B, ...] sum, [B] count)."""
    _single_device(axis_name)
    s = masked_sum(data, mask, axis=1)
    c = torch.sum(mask.to(data.dtype), dim=1)
    return s, c


def global_node_mean(data: torch.Tensor, mask: torch.Tensor,
                     axis_name: Optional[str] = None):
    """Exact mean over the real nodes of each graph."""
    s, c = global_node_sum(data, mask, axis_name)
    c = torch.clamp(c, min=1.0).reshape(
        tuple(c.shape) + (1,) * (s.ndim - c.ndim))
    return s / c
