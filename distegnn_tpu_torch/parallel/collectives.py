"""Differentiable reductions across graph parts (port of
``distegnn_tpu/parallel/collectives.py``).

``_psum(x, axis_name)`` sums ``x`` over the process group of ``axis_name``
(parallel/mesh.py: one axis name or a tuple of them). Its backward sums the cotangent over the
group too: the transpose the JAX step relies on (``psum`` under
``shard_map(check_vma=False)``), and the reference's hand-written
``_AllReduce``. Each rank then differentiates its own node-weighted loss
share and the step sums the parameter gradients (train/step.py).
``axis_name=None`` means one device: every function is then the local
reduction.

Every collective goes through :func:`all_reduce` or :func:`all_gather`,
which count it by kind in ``.counts`` and its host seconds in ``.seconds``.

The tensor axis (``tp_*``, the JAX package's Megatron split of the hidden
width): the parameters stay full and replicated on every rank and are
sliced at compute time, and the loss is computed once on every tensor rank.
So the plain transposes of the collectives would count gradients T times;
each ``tp_*`` is a ``torch.autograd.Function`` whose backward is the
transpose under "the loss counted once", the JAX package's pairs:

  tp_copy    forward identity             backward sum over the tensor axis
  tp_reduce  forward sum                  backward identity
  tp_gather  forward all-gather (last dim) backward this rank's slice
  tp_slice   forward this rank's slice    backward all-gather (last dim)
  tp_slice_rows   the same on dim 0
  tp_once    forward identity             backward / T (no communication)

Every parameter gradient then comes out whole and the same on every tensor
rank, and the step's gradient sum over (data, graph) needs no change.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import torch
import torch.distributed as dist

from distegnn_tpu_torch.ops.segment import masked_sum
from distegnn_tpu_torch.parallel.mesh import (axis_group, axis_index,
                                              axis_size)


def all_reduce(t: torch.Tensor, axis_name, kind: str,
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


def all_gather(t: torch.Tensor, axis_name, kind: str,
               dim: int = -1) -> torch.Tensor:
    """The ranks' ``t`` over the axis's group concatenated along ``dim``
    in rank order (JAX's tiled ``all_gather``), counted under ``kind``."""
    t0 = time.perf_counter()
    group = axis_group(axis_name)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    out = torch.cat(parts, dim=dim)
    all_gather.seconds[kind] += time.perf_counter() - t0
    all_gather.counts[kind] += 1
    return out


all_gather.counts = collections.Counter()
all_gather.seconds = collections.Counter()


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


def _psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """``x`` summed over ``axis_name`` (a name or a tuple of names; None:
    ``x`` itself)."""
    return x if axis_name is None else _PSum.apply(x, axis_name)


# ---------------------------------------------------------------- tensor axis

def _slice_bounds(full: int, axis_name: str):
    """(width, start) of this rank's contiguous 1/T slice of ``full``."""
    t = axis_size(axis_name)
    if full % t:
        raise ValueError(f"hidden dim {full} not divisible by tensor size {t}")
    width = full // t
    return width, axis_index(axis_name) * width


class _TpCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          ctx.axis_name, "tp_copy_bwd"), None


class _TpReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        return all_reduce(x.detach().clone(
            memory_format=torch.contiguous_format), axis_name, "tp_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.width, ctx.start = x.shape[-1], axis_index(axis_name) * x.shape[-1]
        return all_gather(x.detach(), axis_name, "tp_gather")

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.start:ctx.start + ctx.width].contiguous(), None


class _TpSlice(torch.autograd.Function):
    """This rank's slice of ``dim`` (the last or the first)."""

    @staticmethod
    def forward(ctx, x, axis_name, dim):
        width, start = _slice_bounds(x.shape[dim], axis_name)
        ctx.axis_name, ctx.dim = axis_name, dim
        return x.narrow(dim, start, width).contiguous()

    @staticmethod
    def backward(ctx, g):
        kind = "tp_slice_bwd" if ctx.dim else "tp_slice_rows_bwd"
        return all_gather(g, ctx.axis_name, kind, dim=ctx.dim), None, None


class _TpOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.t = axis_size(axis_name)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.t, None


def tp_copy(x: torch.Tensor, axis_name: Optional[str] = None):
    """Identity forward; the cotangent summed over the tensor axis. Where
    a tensor-replicated value enters a sharded computation."""
    return x if axis_name is None else _TpCopy.apply(x, axis_name)


def tp_reduce(x: torch.Tensor, axis_name: Optional[str] = None):
    """Sum over the tensor axis forward (the row-parallel contraction back
    to the full width); identity backward."""
    return x if axis_name is None else _TpReduce.apply(x, axis_name)


def tp_gather(x: torch.Tensor, axis_name: Optional[str] = None):
    """The ranks' slices all-gathered along the last dim forward; this
    rank's slice of the cotangent backward."""
    return x if axis_name is None else _TpGather.apply(x, axis_name)


def tp_slice(x: torch.Tensor, axis_name: Optional[str] = None):
    """This rank's contiguous 1/T slice of the last dim forward (a full
    replicated parameter cut at compute time); the cotangents all-gathered
    backward."""
    return x if axis_name is None else _TpSlice.apply(x, axis_name, -1)


def tp_slice_rows(x: torch.Tensor, axis_name: Optional[str] = None):
    """:func:`tp_slice` of dim 0 (the row-parallel second Dense)."""
    return x if axis_name is None else _TpSlice.apply(x, axis_name, 0)


def tp_once(x: torch.Tensor, axis_name: Optional[str] = None):
    """Identity forward; the cotangent divided by T, no communication. For
    values every tensor rank computes alike from replicated inputs (the
    fused kernel's ``ef_sum`` and ``count``) whose inputs are ``tp_copy``
    wrapped: the copy's sum then counts their cotangent once (exactly, for
    T a power of two)."""
    return x if axis_name is None else _TpOnce.apply(x, axis_name)


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
