"""SLO-driven replica autoscaler (port of ``distegnn_tpu/serve/autoscale.py``;
stdlib threads, a copy of its own).

One :class:`ReplicaAutoscaler` watches every model of a
:class:`~distegnn_tpu_torch.serve.registry.ModelRegistry` and grows or
shrinks each model's :class:`~distegnn_tpu_torch.serve.replica.ReplicaSet`
LIVE, reading the same windowed numbers ``GET /metrics`` exports (the
SLOMonitor's rolling window plus the per-model queue depth):

  scale UP    when queued work per healthy replica exceeds ``queue_high``,
              the window shed rate exceeds ``shed_high``, or (optionally)
              the windowed predict p99 exceeds ``p99_high_ms`` — bounded by
              ``max_replicas`` and ``scale_up_cooldown_s``
  scale DOWN  after ``idle_rounds`` consecutive calm evaluations (depth per
              replica under ``queue_low``, zero window shed, no up-trigger)
              — bounded by ``min_replicas`` and ``scale_down_cooldown_s``

New replicas come from the registry entry's ``replica_factory`` (a thread
replica under the same supervisor and breaker as the static ones).
Retirement goes through ``ReplicaSet.retire_replica``: the victim first
stops being choosable, its in-flight set drains, then its queue stops.

Every decision lands on the obs stream as ``gateway/scale_up`` /
``gateway/scale_down`` / ``gateway/scale_blocked`` with the triggering
gauge values, and ``gateway/autoscale_<model>_replicas`` / ``..._target``
gauges ride every metrics render. ``tick(now=...)`` is public and
synchronous, so tests drive the decision table with a synthetic clock.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from distegnn_tpu_torch import obs

# knob defaults — kept in lockstep with config._DEFAULTS["serve"]["autoscale"]
# (the in-code fallback for hand-built configs)
_DEFAULTS: Dict[str, Any] = {
    "enable": False,
    "min_replicas": 1,
    "max_replicas": 4,
    "interval_s": 0.5,
    "scale_up_cooldown_s": 2.0,
    "scale_down_cooldown_s": 10.0,
    "step": 1,
    "queue_high": 4.0,
    "shed_high": 0.01,
    "p99_high_ms": None,
    "queue_low": 0.5,
    "idle_rounds": 3,
    "drain_timeout_s": 30.0,
}


class _ModelState:
    """Per-model control-loop memory (cooldowns + calm streak)."""

    __slots__ = ("last_up_at", "last_down_at", "calm_rounds")

    def __init__(self):
        self.last_up_at = float("-inf")
        self.last_down_at = float("-inf")
        self.calm_rounds = 0


class ReplicaAutoscaler:
    """Per-model scale control loop over a live registry + SLO window.

    Args:
      registry: the ModelRegistry whose entries scale.
      monitor: the gateway's SLOMonitor (``window_snapshot`` source); None
        disables the shed/p99 triggers (depth still drives decisions).
      config: the ``serve.autoscale`` mapping (missing keys take defaults).
      metrics_registry: obs MetricsRegistry for the replica-count gauges
        (None skips gauge export).
    """

    def __init__(self, registry, monitor=None, *,
                 config: Optional[dict] = None, metrics_registry=None):
        knobs = dict(_DEFAULTS)
        knobs.update(dict(config or {}))
        self.enable = bool(knobs["enable"])
        self.min_replicas = max(1, int(knobs["min_replicas"]))
        self.max_replicas = max(self.min_replicas, int(knobs["max_replicas"]))
        self.interval_s = float(knobs["interval_s"])
        self.up_cooldown_s = float(knobs["scale_up_cooldown_s"])
        self.down_cooldown_s = float(knobs["scale_down_cooldown_s"])
        self.step = max(1, int(knobs["step"]))
        self.queue_high = float(knobs["queue_high"])
        self.shed_high = float(knobs["shed_high"])
        self.p99_high_ms = (None if knobs["p99_high_ms"] is None
                            else float(knobs["p99_high_ms"]))
        self.queue_low = float(knobs["queue_low"])
        self.idle_rounds = max(1, int(knobs["idle_rounds"]))
        self.drain_timeout_s = float(knobs["drain_timeout_s"])
        self.registry = registry
        self.monitor = monitor
        self._reg = metrics_registry
        self._states: Dict[str, _ModelState] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()  # one tick at a time (loop vs tests)

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "ReplicaAutoscaler":
        if self._thread is not None or not self.enable:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-autoscale", daemon=True)
        self._thread.start()
        return self

    def stop(self, join_timeout_s: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=join_timeout_s)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as exc:  # the loop must outlive any one model
                obs.log(f"autoscale: tick failed: {exc!r}")
            self._stop.wait(self.interval_s)

    # ---- the control loop body -------------------------------------------
    def tick(self, now: Optional[float] = None) -> None:
        """One synchronous evaluation of every model. ``now`` overrides the
        clock for the cooldown/calm bookkeeping AND the window snapshot —
        tests drive the full decision table deterministically with it."""
        with self._lock:
            t = time.monotonic() if now is None else float(now)
            snap = (self.monitor.window_snapshot(now=now)
                    if self.monitor is not None else {})
            for name, entry in self.registry.items():
                try:
                    self._tick_model(name, entry, snap, t)
                except Exception as exc:
                    obs.log(f"autoscale: {name}: {exc!r}")

    def _tick_model(self, name: str, entry, snap: Dict[str, float],
                    t: float) -> None:
        st = self._states.setdefault(name, _ModelState())
        rset = entry.replicas
        current = len(rset.replicas)
        healthy = rset.available()
        depth = int(entry.queue.depth())
        per_rep = depth / max(healthy, 1)
        shed = float(snap.get("shed_rate", 0.0))
        p99 = snap.get("predict_p99_ms")
        gauges = dict(depth=depth, healthy=healthy,
                      per_replica_depth=round(per_rep, 3),
                      shed_rate=round(shed, 6),
                      predict_p99_ms=(None if p99 is None else round(p99, 3)))

        reasons = []
        if per_rep > self.queue_high:
            reasons.append("queue_depth")
        if shed > self.shed_high:
            reasons.append("shed_rate")
        if (self.p99_high_ms is not None and p99 is not None
                and p99 > self.p99_high_ms):
            reasons.append("p99")

        target = current
        if reasons:
            st.calm_rounds = 0
            target = min(current + self.step, self.max_replicas)
            if current >= self.max_replicas:
                obs.event("gateway/scale_blocked", model=name,
                          direction="up", reason="max_replicas",
                          replicas=current, triggers=reasons, **gauges)
            elif t - st.last_up_at < self.up_cooldown_s:
                obs.event("gateway/scale_blocked", model=name,
                          direction="up", reason="cooldown",
                          replicas=current, triggers=reasons, **gauges)
            elif entry.replica_factory is None:
                obs.event("gateway/scale_blocked", model=name,
                          direction="up", reason="no_factory",
                          replicas=current, triggers=reasons, **gauges)
            else:
                added = self._grow(name, entry, target - current)
                if added:
                    st.last_up_at = t
                    obs.event("gateway/scale_up", model=name,
                              from_replicas=current,
                              to_replicas=current + added,
                              triggers=reasons, **gauges)
        else:
            calm = per_rep < self.queue_low and shed == 0.0
            st.calm_rounds = st.calm_rounds + 1 if calm else 0
            if (st.calm_rounds >= self.idle_rounds
                    and current > self.min_replicas):
                target = max(current - self.step, self.min_replicas)
                if t - max(st.last_down_at, st.last_up_at) \
                        < self.down_cooldown_s:
                    obs.event("gateway/scale_blocked", model=name,
                              direction="down", reason="cooldown",
                              replicas=current,
                              calm_rounds=st.calm_rounds, **gauges)
                else:
                    removed = self._shrink(entry, current - target)
                    if removed:
                        st.last_down_at = t
                        st.calm_rounds = 0
                        obs.event("gateway/scale_down", model=name,
                                  from_replicas=current,
                                  to_replicas=current - removed,
                                  calm_rounds=self.idle_rounds, **gauges)
        if self._reg is not None:
            self._reg.gauge(f"gateway/autoscale_{name}_replicas").set(
                len(rset.replicas))
            self._reg.gauge(f"gateway/autoscale_{name}_target").set(target)

    def _grow(self, name: str, entry, count: int) -> int:
        added = 0
        # warm the already-warmed rungs BEFORE the new replica becomes
        # choosable (add_replica's warm_sizes contract), so a mid-spike
        # scale-up never routes live traffic into a kernel build; warmup
        # failure is non-fatal (a lazy build on first traffic)
        sizes = [(b.n, b.e) for b in entry.warmed]
        for _ in range(count):
            try:
                # entry.add_replica (not the raw set) so a blue/green swap
                # racing the build cannot leave the new replica on the
                # retired version — it re-pins under the swap lock
                entry.add_replica(warm_sizes=sizes)
            except Exception as exc:
                obs.event("gateway/scale_blocked", model=name,
                          direction="up", reason="spawn_failed",
                          error=repr(exc)[:300])
                break
            added += 1
        return added

    def _shrink(self, entry, count: int) -> int:
        removed = 0
        for _ in range(count):
            victim = entry.replicas.retire_replica(
                drain_timeout_s=self.drain_timeout_s)
            if victim is None:
                break
            removed += 1
        return removed

    # ---- health surface ---------------------------------------------------
    def status(self) -> Dict[str, dict]:
        """Per-model scale state for /readyz."""
        out: Dict[str, dict] = {}
        for name, entry in self.registry.items():
            st = self._states.get(name)
            out[name] = {
                "replicas": len(entry.replicas.replicas),
                "available": entry.replicas.available(),
                "min": self.min_replicas,
                "max": self.max_replicas,
                "calm_rounds": 0 if st is None else st.calm_rounds,
            }
        return out


__all__ = ["ReplicaAutoscaler"]
