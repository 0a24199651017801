"""Serving metrics (port of ``distegnn_tpu/serve/metrics.py``; pure Python,
a copy of its own): thread-safe counters and a JSON-able snapshot.

One :class:`ServeMetrics` is shared by a model's engines (the shape-key LRU,
execute latencies) and its queues (depth, batch fill, rejections). It is a
facade over the port's ``obs/metrics.py`` primitives in a private
``MetricsRegistry``, so the record path is O(1) and the same registry renders
Prometheus text (:meth:`ServeMetrics.render_prometheus`, the gateway's
``/metrics``). The snapshot's keys and the registry's metric names are the
JAX package's.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

from distegnn_tpu_torch.obs.metrics import MetricsRegistry

_COUNTERS = (
    "requests_submitted", "requests_completed", "requests_failed",
    "requests_timeout", "requests_rejected", "requests_retried",
    "requests_poison", "worker_restarts", "requests_failed_over",
    "replica_restarts", "batches_executed",
    "batch_slots_total", "batch_slots_filled",
    "cache_hits", "cache_misses", "cache_evictions",
    "session_hits", "session_misses", "session_evictions",
)


class ServeMetrics:
    """Counters for the serving path. All methods are thread-safe.

    Latencies are recorded in milliseconds into a bounded reservoir (the most
    recent ``reservoir`` samples) — p50/p99 are computed at snapshot time, so
    the record path is O(1). Counter values stay readable as plain int
    attributes (``metrics.requests_submitted``) for existing callers.
    """

    def __init__(self, reservoir: int = 8192):
        self._registry = MetricsRegistry()
        self._t0 = time.perf_counter()
        self._c = {name: self._registry.counter("serve/" + name)
                   for name in _COUNTERS}
        self._qdepth = self._registry.gauge("serve/queue_depth")
        self._lat = self._registry.reservoir("serve/latency_ms",
                                             size=int(reservoir))
        self._queue = self._registry.reservoir("serve/queue_wait_ms",
                                               size=int(reservoir))

    def __getattr__(self, name: str):
        # attribute back-compat: counters/gauge read as plain numbers
        c = self.__dict__.get("_c") or {}
        if name in c:
            return int(c[name].value)
        if name == "queue_depth":
            return int(self.__dict__["_qdepth"].value)
        raise AttributeError(name)

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry

    # ---- recorders -------------------------------------------------------
    def submitted(self, n: int = 1) -> None:
        self._c["requests_submitted"].add(n)

    def rejected(self, n: int = 1) -> None:
        self._c["requests_rejected"].add(n)

    def timed_out(self, n: int = 1) -> None:
        self._c["requests_timeout"].add(n)

    def failed(self, n: int = 1) -> None:
        self._c["requests_failed"].add(n)

    def retried(self, n: int = 1) -> None:
        self._c["requests_retried"].add(n)

    def poison(self, n: int = 1) -> None:
        self._c["requests_poison"].add(n)

    def worker_restarted(self, n: int = 1) -> None:
        self._c["worker_restarts"].add(n)

    def failed_over(self, n: int = 1) -> None:
        """A dead replica's in-flight request was re-dispatched to a
        survivor (the replica layer's at-most-once failover)."""
        self._c["requests_failed_over"].add(n)

    def replica_restarted(self, n: int = 1) -> None:
        """The supervisor restarted a crashed/wedged replica (distinct from
        ``worker_restarts``, the in-queue dispatcher crash containment)."""
        self._c["replica_restarts"].add(n)

    def batch_done(self, filled: int, capacity: int,
                   latencies_ms: List[float],
                   queue_ms_each: Optional[List[float]] = None) -> None:
        """One executed micro-batch: ``filled`` real requests padded to
        ``capacity`` slots, with one end-to-end latency per request."""
        self._c["batches_executed"].add(1)
        self._c["batch_slots_total"].add(capacity)
        self._c["batch_slots_filled"].add(filled)
        self._c["requests_completed"].add(filled)
        self._lat.record_many(latencies_ms)
        if queue_ms_each:
            self._queue.record_many(queue_ms_each)

    def cache_event(self, hit: bool, evicted: int = 0) -> None:
        self._c["cache_hits" if hit else "cache_misses"].add(1)
        if evicted:
            self._c["cache_evictions"].add(evicted)

    def session_event(self, hit: bool, evicted: int = 0) -> None:
        """One session-affinity prep-cache lookup (distinct from the compile
        cache tracked by :meth:`cache_event`)."""
        self._c["session_hits" if hit else "session_misses"].add(1)
        if evicted:
            self._c["session_evictions"].add(evicted)

    def set_queue_depth(self, depth: int) -> None:
        self._qdepth.set(depth)

    # ---- export ----------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        c = {name: int(cnt.value) for name, cnt in self._c.items()}
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        fill = (c["batch_slots_filled"] / c["batch_slots_total"]
                if c["batch_slots_total"] else 0.0)
        return {
            "uptime_s": round(elapsed, 3),
            "requests_submitted": c["requests_submitted"],
            "requests_completed": c["requests_completed"],
            "requests_failed": c["requests_failed"],
            "requests_timeout": c["requests_timeout"],
            "requests_rejected": c["requests_rejected"],
            "requests_retried": c["requests_retried"],
            "requests_poison": c["requests_poison"],
            "worker_restarts": c["worker_restarts"],
            "requests_failed_over": c["requests_failed_over"],
            "replica_restarts": c["replica_restarts"],
            "requests_per_sec": round(c["requests_completed"] / elapsed, 3),
            "batches_executed": c["batches_executed"],
            "batch_fill_ratio": round(fill, 4),
            "latency_p50_ms": round(self._lat.percentile(50), 3),
            "latency_p99_ms": round(self._lat.percentile(99), 3),
            "queue_wait_p50_ms": round(self._queue.percentile(50), 3),
            "queue_wait_p99_ms": round(self._queue.percentile(99), 3),
            "cache_hits": c["cache_hits"],
            "cache_misses": c["cache_misses"],
            "cache_evictions": c["cache_evictions"],
            "session_hits": c["session_hits"],
            "session_misses": c["session_misses"],
            "session_evictions": c["session_evictions"],
            "queue_depth": int(self._qdepth.value),
        }

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def render_prometheus(self, prefix: str = "distegnn") -> str:
        """Prometheus text exposition of the underlying registry."""
        return self._registry.render_prometheus(prefix=prefix)
