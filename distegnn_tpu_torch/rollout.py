"""Autoregressive rollout on the device (port of ``distegnn_tpu/rollout.py``).

Each step predicts positions, rebuilds the radius graph from them on the
device (ops/radius_dev.py, fixed shapes) and runs the next model step. The
rebuilt edge list is already in the blocked layout that the blocked
aggregation ops read (``max_degree * edge_block`` slots per node block), so
a plain model takes its blocked lowering (``blocked_impl``: the CUDA kernels
``csrc/blocked_onehot.cu`` on the card, or the einsum contraction). The
slots change every step, so each step's forward builds their plan once
(``blocked_slot_inv_deg``: one ``blocked_plan`` launch) for all its layers.

The JAX package runs the K steps inside one ``lax.scan``; here they are a
Python loop of device work that never reads a value back: the per-step
overflow flags stay on the device, are stacked, and are read once per
rollout by the caller. A step that overflows the static capacity bounds (a
cell holding more than ``max_per_cell`` nodes, a node with more than
``max_degree`` neighbours) drops edges, which is why the flags are returned.

``make_batched_rollout_fn`` runs B scenes through the model's batch axis:
every scene rebuilds its own graph each step, and one model forward per step
serves all B (the ops take ``[B, ...]``, and one kernel launch covers the
batch).
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

from distegnn_tpu_torch.ops.graph import GraphBatch
from distegnn_tpu_torch.ops.radius_dev import (ell_to_edge_list,
                                               radius_graph_dev)


def default_feature_fn(v: torch.Tensor) -> torch.Tensor:
    """[N, 3] velocity -> [N, 1] speed (the n-body convention)."""
    return torch.linalg.norm(v, dim=-1, keepdim=True)


def default_edge_attr_fn(x, ei, em) -> torch.Tensor:
    """Distance twice — the fluid pipelines' [d, d] edge attribute."""
    d = torch.linalg.norm(x[ei[0].long()] - x[ei[1].long()], dim=-1,
                          keepdim=True)
    return torch.cat([d, d], dim=-1) * em[:, None]


def _check_layout(max_degree: int, edge_block: int) -> None:
    if (max_degree * edge_block) % 512:
        raise ValueError("max_degree * edge_block must be a multiple of 512")


def _scene_graph(x, v, node_mask, radius, max_degree, max_per_cell,
                 feature_fn, edge_attr_fn, node_attr=None):
    """One scene's per-step graph: (arrays of the GraphBatch fields without
    the batch axis, overflow flag). ``node_attr`` [N, A]: static per-node
    attributes (none by default)."""
    g = radius_graph_dev(x, radius, max_degree, max_per_cell,
                         node_mask=node_mask)
    ei, em = ell_to_edge_list(g)
    N = x.shape[0]
    nm = node_mask[:, None]
    loc_mean = torch.sum(x * nm, dim=0) / torch.clamp(torch.sum(node_mask),
                                                      min=1.0)
    fields = dict(
        node_feat=feature_fn(v) * nm,
        node_attr=(x.new_zeros((N, 0)) if node_attr is None
                   else node_attr * nm),
        loc=x * nm,
        vel=v * nm,
        target=x.new_zeros((N, 3)),
        loc_mean=loc_mean,
        node_mask=node_mask,
        edge_index=ei,
        edge_attr=edge_attr_fn(x, ei, em),
        edge_mask=em)
    return fields, g.cell_overflow | g.degree_overflow


def _batch(scenes, edge_block: int) -> GraphBatch:
    """Stack per-scene field dicts into one blocked GraphBatch (no pairing:
    the rebuilt graph's padding slots point at their own node)."""
    return GraphBatch(**{k: torch.stack([s[k] for s in scenes])
                         for k in scenes[0]},
                      edges_sorted=True, edge_block=edge_block, edge_tile=512)


def _rollout_loop(model, steps, loc0, vel0, node_mask, graph_fn,
                  edge_block, velocity_from_delta, velocity_scale):
    """The K steps over [B, N, 3] states: (traj [B, steps, N, 3], overflow
    [B, steps] bool), both left on the device."""
    x, v = loc0, vel0
    traj, over = [], []
    with torch.no_grad():
        for _ in range(int(steps)):
            per = [graph_fn(x[b], v[b], node_mask[b])
                   for b in range(x.shape[0])]
            batch = _batch([p[0] for p in per], edge_block)
            x_next = model(batch)[0] * node_mask[..., None]
            # velocity_scale converts the per-rollout-step displacement into
            # the velocity convention the model was trained on
            v = ((x_next - x) * velocity_scale if velocity_from_delta else v)
            x = x_next
            traj.append(x)
            over.append(torch.stack([p[1] for p in per]))
    return torch.stack(traj, dim=1), torch.stack(over, dim=1)


def make_rollout_fn(
    model,
    radius: float,
    max_degree: int,
    max_per_cell: int = 16,
    feature_fn: Callable = default_feature_fn,
    edge_attr_fn: Callable = default_edge_attr_fn,
    edge_block: int = 256,
    velocity_from_delta: bool = True,
    velocity_scale: float = 1.0,
    node_attr=None,
):
    """Build ``rollout(loc0 [N, 3], vel0 [N, 3], node_mask [N], steps)``.

    Returns (traj [steps, N, 3], overflow [steps] bool), on the model's
    device. N must be a multiple of ``edge_block`` and ``max_degree *
    edge_block`` a multiple of the kernel edge tile (512 at block 256 ->
    keep max_degree even) so every rebuilt graph is a legal blocked
    layout. ``node_attr`` [N, A]: the scene's static per-node attributes
    (JAX's ``node_attr`` / ``node_attr_now``)."""
    _check_layout(max_degree, edge_block)

    def rollout(loc0, vel0, node_mask, steps: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if loc0.shape[0] % edge_block:
            raise ValueError(f"N={loc0.shape[0]} must be a multiple of "
                             f"edge_block={edge_block} (pad loc0/node_mask)")
        fn = functools.partial(
            _scene_graph, radius=radius, max_degree=max_degree,
            max_per_cell=max_per_cell, feature_fn=feature_fn,
            edge_attr_fn=edge_attr_fn, node_attr=node_attr)
        traj, over = _rollout_loop(model, steps, loc0[None], vel0[None],
                                   node_mask[None], fn, edge_block,
                                   velocity_from_delta, velocity_scale)
        return traj[0], over[0]

    return rollout


def make_batched_rollout_fn(
    model,
    radius: float,
    max_degree: int,
    max_per_cell: int = 16,
    feature_fn: Callable = default_feature_fn,
    edge_attr_fn: Callable = default_edge_attr_fn,
    edge_block: int = 256,
    velocity_from_delta: bool = True,
    velocity_scale: float = 1.0,
):
    """Batched variant of :func:`make_rollout_fn`: a leading scene axis.

    ``rollout_batch(loc0 [B,N,3], vel0 [B,N,3], node_mask [B,N], steps)`` ->
    (traj [B, steps, N, 3], overflow [B, steps] bool). Each step rebuilds
    every scene's graph and runs ONE model forward over the B scenes (the
    JAX package vmaps the single-scene step; here the scene axis is the
    model's batch axis). Per-scene trajectories match B calls of the
    unbatched rollout."""
    _check_layout(max_degree, edge_block)

    def rollout_batch(loc0, vel0, node_mask, steps: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        if loc0.ndim != 3:
            raise ValueError(f"rollout_batch expects loc0 [B, N, 3], got "
                             f"shape {tuple(loc0.shape)}")
        if loc0.shape[1] % edge_block:
            raise ValueError(f"N={loc0.shape[1]} must be a multiple of "
                             f"edge_block={edge_block} (pad loc0/node_mask)")
        fn = functools.partial(
            _scene_graph, radius=radius, max_degree=max_degree,
            max_per_cell=max_per_cell, feature_fn=feature_fn,
            edge_attr_fn=edge_attr_fn)
        return _rollout_loop(model, steps, loc0, vel0, node_mask, fn,
                             edge_block, velocity_from_delta, velocity_scale)

    return rollout_batch
