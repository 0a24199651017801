"""Replica supervisor (port of ``distegnn_tpu/serve/supervisor.py``):
heartbeat, wedge detection, backoff, circuit breaker.

One daemon thread per :class:`~distegnn_tpu_torch.serve.replica.ReplicaSet`
ticks every ``heartbeat_s`` and drives each replica's state machine:

  - **crash**: the dispatcher thread is gone (``queue.alive()`` False while
    the replica should be running). The queue's own crash budget already
    failed its futures; the supervisor claims anything still tracked,
    fails it over to survivors, and schedules a restart.
  - **wedge**: the dispatcher is alive but makes no batch progress
    (``queue.depth() > 0`` and ``queue.last_progress`` older than
    ``wedge_timeout_s``: a stuck device call). The supervisor claims the
    in-flight work for failover FIRST (claims are compare-and-pop), then
    ``kill()``s the queue so any straggler fails typed instead of hanging,
    and schedules a restart. The abandoned thread dies at its next
    kill-flag check; its late results are dropped by the outer futures'
    first-wins resolution.
  - **restart**: after an exponential backoff (``backoff_base_s`` doubling
    per consecutive failure, capped at ``backoff_max_s``) the replica gets a
    fresh RequestQueue on its existing warmed engine. ``breaker_threshold``
    consecutive failures open the replica's circuit breaker: it sits out
    ``breaker_cooldown_s`` before the next (half-open) attempt. A replica
    healthy for ``healthy_reset_s`` gets its failure count cleared.

The first use of a CUDA kernel builds it (``nvcc``, tens of seconds): warm
the engines (``ModelRegistry.warmup``) before traffic, or a first batch can
sit past ``wedge_timeout_s`` and be restarted mid-build.

Every transition emits a ``gateway/replica_*`` obs event. ``tick(now=)`` is
public so tests drive the state machine with synthetic clocks. The
``worker_heartbeat_timeout_s`` knob belongs to JAX's process backend
(``serve/worker.py``, not ported; ``serve.workers: process`` is refused): it
is accepted, as the config's ``serve.supervisor`` section carries it, and a
thread replica has no heartbeat for it to bound.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from distegnn_tpu_torch import obs


class ReplicaSupervisor:
    def __init__(self, replica_set, *,
                 heartbeat_s: float = 0.25,
                 wedge_timeout_s: float = 60.0,
                 worker_heartbeat_timeout_s: float = 10.0,
                 backoff_base_s: float = 0.5,
                 backoff_max_s: float = 30.0,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 healthy_reset_s: float = 60.0):
        self.rset = replica_set
        self.heartbeat_s = float(heartbeat_s)
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.worker_heartbeat_timeout_s = float(worker_heartbeat_timeout_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.healthy_reset_s = float(healthy_reset_s)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "ReplicaSupervisor":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"replica-supervisor-{self.rset.model}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                self.tick()
            except Exception as exc:  # supervision must never die silently
                obs.log(f"serve: supervisor tick failed for "
                        f"{self.rset.model}: {exc!r}")

    # ---- state machine ----------------------------------------------------
    def tick(self, now: Optional[float] = None) -> None:
        """One heartbeat pass (public: tests call it with synthetic clocks)."""
        if not self.rset._supervised:
            return  # set is stopping/stopped — nothing to supervise
        now = time.perf_counter() if now is None else now
        for r in self.rset.replicas:
            if r.state == "running":
                if not r.queue.alive():
                    self._mark_down(r, "crash", now)
                elif (r.queue.depth() > 0
                      and now - r.queue.last_progress > self.wedge_timeout_s):
                    self._mark_down(r, "wedge", now)
                elif r.failures and now - r.started_at >= self.healthy_reset_s:
                    r.failures = 0
                    obs.event("gateway/replica_breaker_close",
                              model=self.rset.model, replica=r.idx)
            elif r.state in ("backoff", "broken"):
                if now >= r.next_restart_at:
                    self._restart(r, now)

    def _mark_down(self, r, reason: str, now: float) -> None:
        r.last_reason = reason
        r.failures += 1
        broken = r.failures >= self.breaker_threshold
        r.state = "broken" if broken else "backoff"
        delay = (self.breaker_cooldown_s if broken else
                 min(self.backoff_base_s * (2 ** (r.failures - 1)),
                     self.backoff_max_s))
        r.next_restart_at = now + delay
        obs.event(f"gateway/replica_{reason}", model=self.rset.model,
                  replica=r.idx, failures=r.failures, state=r.state,
                  restart_in_s=round(delay, 3))
        if broken:
            obs.event("gateway/replica_breaker_open", model=self.rset.model,
                      replica=r.idx, failures=r.failures,
                      cooldown_s=self.breaker_cooldown_s)
        # claim in-flight work for failover BEFORE poisoning the queue, so
        # each record is claimed exactly once (supervisor vs done-callback);
        # per-request gateway/replica_failover events carry the detail
        self.rset.fail_over_replica(r, reason=reason)
        if reason == "wedge":
            # poison the stragglers so no future hangs
            r.queue.kill(reason=f"marked down ({reason}) by supervisor")

    def _restart(self, r, now: float) -> None:
        r.restarts += 1
        self.rset.metrics.replica_restarted()
        try:
            r.restart_queue()
        except Exception as exc:
            # counts as another failure: breaker math applies unchanged
            obs.log(f"serve: {self.rset.model} replica {r.idx} restart "
                    f"failed: {exc!r}")
            self._mark_down(r, "restart_failed", now)
            return
        if not self.rset._supervised:
            # a stop() raced us while restart_queue ran: never revive a
            # queue after drain has begun
            r.queue.stop(drain=False, join_timeout_s=2.0)
            r.state = "stopped"
            obs.event("gateway/replica_restart_aborted",
                      model=self.rset.model, replica=r.idx)
            return
        r.state = "running"
        r.started_at = now
        obs.event("gateway/replica_restart", model=self.rset.model,
                  replica=r.idx, attempt=r.restarts, failures=r.failures)
