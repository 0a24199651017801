"""Differentiable reductions across graph parts (port of
``distegnn_tpu/parallel/collectives.py``).

``_psum(x, axis_name)`` sums ``x`` over the process group bound to
``axis_name`` (parallel/mesh.py). Its backward sums the cotangent over the
group too: the transpose the JAX step relies on (``psum`` under
``shard_map(check_vma=False)``), and the reference's hand-written
``_AllReduce``. Each rank then differentiates its own node-weighted loss
share and the step sums the parameter gradients (train/step.py).
``axis_name=None`` means one device: every function is then the local
reduction.

Every collective goes through :func:`all_reduce`, which counts it by kind in
``all_reduce.counts`` and its host seconds in ``all_reduce.seconds``.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import torch
import torch.distributed as dist

from distegnn_tpu_torch.ops.segment import masked_sum
from distegnn_tpu_torch.parallel.mesh import axis_group


def all_reduce(t: torch.Tensor, axis_name: str, kind: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place ``dist.all_reduce`` of ``t`` over the axis's group,
    counted under ``kind``."""
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op, group=axis_group(axis_name))
    all_reduce.seconds[kind] += time.perf_counter() - t0
    all_reduce.counts[kind] += 1
    return t


all_reduce.counts = collections.Counter()
all_reduce.seconds = collections.Counter()


class _PSum(torch.autograd.Function):
    """Forward: sum over the group. Backward: sum of the cotangent over the
    group."""

    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return all_reduce(x.detach().clone(memory_format=torch.contiguous_format),
                          axis_name, "psum")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          ctx.axis_name, "psum_bwd"), None


def _psum(x: torch.Tensor, axis_name: Optional[str]) -> torch.Tensor:
    return x if axis_name is None else _PSum.apply(x, axis_name)


def pweighted_mean(data: torch.Tensor, weight: torch.Tensor,
                   axis_name: Optional[str] = None) -> torch.Tensor:
    """Weighted mean across parts: sum(data * w) / sum(w), both summed over
    the axis (``weight`` broadcasts against ``data``)."""
    num = _psum(data * weight, axis_name)
    den = _psum(weight, axis_name)
    return num / torch.clamp(den, min=1e-30)


def global_node_sum(data: torch.Tensor, mask: torch.Tensor,
                    axis_name: Optional[str] = None):
    """Masked sum over the node axis (axis 1 of [B, N, ...]), summed across
    parts. Returns ([B, ...] sum, [B] count)."""
    s = _psum(masked_sum(data, mask, axis=1), axis_name)
    c = _psum(torch.sum(mask.to(data.dtype), dim=1), axis_name)
    return s, c


def global_node_mean(data: torch.Tensor, mask: torch.Tensor,
                     axis_name: Optional[str] = None) -> torch.Tensor:
    """Exact mean over the real nodes of each graph, across all parts."""
    s, c = global_node_sum(data, mask, axis_name)
    c = torch.clamp(c, min=1.0).reshape(
        tuple(c.shape) + (1,) * (s.ndim - c.ndim))
    return s / c
