"""distegnn_tpu_torch.serve — bucketed one-step inference and K-step
rollouts (port of the engine half of ``distegnn_tpu/serve``; the request
queue, HTTP transport and worker processes are later slices)."""

from __future__ import annotations

from typing import Optional

import torch

from distegnn_tpu_torch import resolve_device
from distegnn_tpu_torch.serve.buckets import (Bucket, BucketLadder,
                                              BucketOverflowError,
                                              synthetic_graph)
from distegnn_tpu_torch.serve.engine import (InferenceEngine,
                                             MixedRolloutStepsError,
                                             RolloutOverflowError)

__all__ = ["Bucket", "BucketLadder", "BucketOverflowError", "synthetic_graph",
           "InferenceEngine", "MixedRolloutStepsError",
           "RolloutOverflowError", "engine_from_config",
           "engine_with_params_from_config"]


def engine_from_config(cfg, model: torch.nn.Module,
                       device=None) -> InferenceEngine:
    """Build an InferenceEngine from a config's ``serve:`` section."""
    s = cfg.serve
    ladder = BucketLadder(
        node_floor=s.node_floor, edge_floor=s.edge_floor, growth=s.growth,
        node_multiple=s.node_multiple, edge_multiple=s.edge_multiple,
        max_nodes=s.max_nodes, max_edges=s.max_edges)
    layout = None
    if cfg.model.get("edge_impl") in ("fused", "fused_stack"):
        # fused models only consume blocked split_remote batches
        layout = dict(edge_block=int(cfg.data.edge_block), split_remote=True)
    rollout = s.get("rollout")
    return InferenceEngine(model, resolve_device(device), ladder=ladder,
                           max_batch=s.max_batch, layout_opts=layout,
                           rollout_opts=dict(rollout) if rollout else None)


def engine_with_params_from_config(cfg, device=None,
                                   checkpoint: Optional[str] = None):
    """The deterministic model + engine recipe: parameters drawn from a
    ``torch.Generator`` seeded with ``cfg.seed``, then an optional
    checkpoint, a trainer checkpoint or a bare ``state_dict`` file (see
    ``train.checkpoint.load_params``). ``checkpoint`` overrides
    ``cfg.model.checkpoint``. ``device`` defaults to CUDA and raises when no
    card is available; pass ``device="cpu"`` for the plain path.
    Returns ``(model, engine)``."""
    from distegnn_tpu_torch.models.registry import get_model
    from distegnn_tpu_torch.train.checkpoint import load_params

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(cfg.get("seed", 0) or 0))
    model = get_model(cfg.model, generator=gen)
    ckpt = checkpoint if checkpoint is not None else cfg.model.get(
        "checkpoint")
    if ckpt:
        load_params(str(ckpt), model)
    engine = engine_from_config(cfg, model, dev)
    return model, engine
