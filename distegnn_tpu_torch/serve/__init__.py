"""distegnn_tpu_torch.serve — bucketed serving (port of
``distegnn_tpu/serve``).

Request path: HTTP gateway (``transport.py``, run as
``python -m distegnn_tpu_torch.serve.gateway``) -> ModelRegistry route ->
ReplicaSet -> RequestQueue.submit(graph) -> bucket ladder -> micro-batcher
-> InferenceEngine -> ServeFuture result. All components of one model share
one ServeMetrics; the gateway adds process-wide admission and latency
series and a ``/metrics`` scrape endpoint.

Replicas run as threads of this process or, under ``serve.workers:
process``, in worker children (``serve/worker.py``); the replica layer, the
supervisor, the registry and the transport import lazily, so a worker child
that imports this package never loads them.

A scene above ``serve.max_nodes`` is served through the tiled executor
(``tiled.py``, ``mesh_tiled.py``) when ``serve.tiled.enable`` is set; above
``serve.tiled.max_nodes`` it is a 413 (``TiledOverflowError``).
"""

from __future__ import annotations

from typing import Optional

import torch

from distegnn_tpu_torch import resolve_device
from distegnn_tpu_torch.serve.buckets import (Bucket, BucketLadder,
                                              BucketOverflowError,
                                              synthetic_graph)
from distegnn_tpu_torch.serve.engine import (CanaryError, InferenceEngine,
                                             MixedRolloutStepsError,
                                             RolloutOverflowError)
from distegnn_tpu_torch.serve.metrics import ServeMetrics
from distegnn_tpu_torch.serve.prep import (PrepPlan, PrepResult,
                                           SessionPrepCache)
from distegnn_tpu_torch.serve.queue import (DispatcherCrashError,
                                            QueueFullError, RequestQueue,
                                            RequestTimeoutError, ServeFuture,
                                            StreamSink)
from distegnn_tpu_torch.serve.tiled import TiledExecutor, TiledOverflowError

__all__ = ["Bucket", "BucketLadder", "BucketOverflowError", "synthetic_graph",
           "CanaryError", "InferenceEngine", "MixedRolloutStepsError",
           "RolloutOverflowError", "ServeMetrics", "PrepPlan", "PrepResult",
           "SessionPrepCache", "DispatcherCrashError", "QueueFullError",
           "RequestQueue", "RequestTimeoutError", "ServeFuture", "StreamSink",
           "TiledExecutor", "TiledOverflowError",
           "ModelUnavailableError", "Replica", "ReplicaSet",
           "ReplicaSupervisor", "engine_from_config", "queue_from_config",
           "engine_with_params_from_config", "Gateway", "PayloadError",
           "ModelEntry", "ModelRegistry", "SwapError", "SwapInProgressError"]


def __getattr__(name):
    # the transport, registry, replica layer and supervisor import lazily:
    # the in-process serve stack does not need the HTTP layer, a worker
    # child needs none of them, and registry -> engine_from_config would
    # otherwise be a load-time cycle through this package
    if name in ("ModelUnavailableError", "Replica", "ReplicaSet"):
        from distegnn_tpu_torch.serve import replica

        return getattr(replica, name)
    if name == "ReplicaSupervisor":
        from distegnn_tpu_torch.serve import supervisor

        return supervisor.ReplicaSupervisor
    if name in ("Gateway", "PayloadError"):
        from distegnn_tpu_torch.serve import transport

        return getattr(transport, name)
    if name in ("ModelEntry", "ModelRegistry", "SwapError",
                "SwapInProgressError"):
        from distegnn_tpu_torch.serve import registry

        return getattr(registry, name)
    raise AttributeError(name)


def engine_from_config(cfg, model: torch.nn.Module, device=None,
                       metrics: Optional[ServeMetrics] = None
                       ) -> InferenceEngine:
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
    return InferenceEngine(
        model, resolve_device(device), ladder=ladder, max_batch=s.max_batch,
        cache_size=int(s.get("cache_size", 32)), metrics=metrics,
        layout_opts=layout,
        rollout_opts=dict(rollout) if rollout else None,
        session_cache=int(s.get("session_cache", 0) or 0),
        session_cache_bytes=int(s.get("session_cache_bytes", 0) or 0),
        tiled=(dict(s.tiled) if s.get("tiled") and s.tiled.get("enable")
               else None))


def queue_from_config(cfg, engine: InferenceEngine) -> RequestQueue:
    """The engine's RequestQueue from ``serve:`` (not started)."""
    s = cfg.serve
    return RequestQueue(
        engine, batch_deadline_ms=float(s.batch_deadline_ms),
        queue_capacity=int(s.queue_capacity),
        request_timeout_ms=float(s.request_timeout_ms),
        result_margin_s=float(s.get("result_margin_s", 30.0)),
        metrics=engine.metrics)


def engine_with_params_from_config(cfg, device=None,
                                   checkpoint: Optional[str] = None,
                                   metrics: Optional[ServeMetrics] = None):
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
    model = get_model(cfg.model, dataset_name=cfg.data.dataset_name,
                      generator=gen)
    ckpt = checkpoint if checkpoint is not None else cfg.model.get(
        "checkpoint")
    if ckpt:
        load_params(str(ckpt), model)
    engine = engine_from_config(cfg, model, dev, metrics=metrics)
    return model, engine
