"""Shared-nothing engine replicas behind one admission front (port of
``distegnn_tpu/serve/replica.py``, the thread backend).

A :class:`ReplicaSet` owns N (engine, RequestQueue) pairs for one model and
duck-types the single RequestQueue: ``submit`` / ``submit_rollout`` /
``depth`` / ``alive`` / ``start`` / ``stop`` keep their signatures, so the
gateway routes work unchanged with ``replicas: 1``.

What changes with N > 1:

  - admission picks a HEALTHY replica round-robin; the caller gets an OUTER
    :class:`~distegnn_tpu_torch.serve.queue.ServeFuture` wired to the
    replica's inner future via ``add_done_callback``
  - if the chosen replica's dispatcher dies with the request in flight
    (inner future resolves with :class:`DispatcherCrashError`), the request
    FAILS OVER to a survivor — at most once per replica, tracked in the
    record's ``tried`` set, so a poison batch that kills whoever runs it
    can't ping-pong forever
  - when no replica is available AND the set is supervised, admission raises
    :class:`ModelUnavailableError` carrying a ``retry_after_s`` hint from the
    earliest scheduled restart (the gateway's 503 + ``Retry-After`` for
    THIS model only)
  - an unsupervised set (never ``start()``-ed) passes through to replica 0,
    so the queue's own admission errors surface unchanged

Failover is AT-MOST-ONCE per delivery: in-flight records are claimed either
by the inner future's done-callback or by the supervisor's drain — never
both — via ``Replica.untrack``'s compare-and-pop, and the outer future's
first-wins resolution drops any late result from an abandoned replica.

Every replica's dispatcher is a thread of this process. Replicas on one
card serialize there, as JAX's replicas on one device do. JAX's process
backend (``WorkerQueue`` / ``WorkerReplica``, ``serve/worker.py``) is not
ported: ``serve.workers: process`` is refused.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.serve.buckets import Bucket
from distegnn_tpu_torch.serve.queue import (DispatcherCrashError,
                                            RequestQueue, ServeFuture)


class ModelUnavailableError(RuntimeError):
    """Every replica of one model is down (crashed/broken/restarting).

    ``retry_after_s`` is the serving hint for the gateway's ``Retry-After``
    header: time until the earliest scheduled replica restart, floored so
    clients never busy-spin.
    """

    def __init__(self, model: str, retry_after_s: float = 1.0):
        super().__init__(
            f"model '{model}' has no live replicas (all crashed, wedged, or "
            f"in breaker cooldown); retry after {retry_after_s:.1f} s")
        self.model = model
        self.retry_after_s = float(retry_after_s)


class _Tracked:
    """One admitted request: the outer future handed to the caller plus
    everything needed to re-dispatch it to a survivor."""

    __slots__ = ("kind", "payload", "bucket", "request_id", "outer", "tried",
                 "stream")

    def __init__(self, kind: str, payload: dict, bucket, request_id,
                 outer: ServeFuture, stream=None):
        self.kind = kind            # "predict" | "rollout"
        self.payload = payload
        self.bucket = bucket        # predict-only override (may be None)
        self.request_id = request_id
        self.outer = outer
        self.tried: Set[int] = set()  # replica indices that saw this request
        self.stream = stream        # StreamSink: streamed rollouts only


class Replica:
    """One engine + its current dispatcher queue, plus supervision state.

    The ENGINE is stable across restarts (warmed: its kernels built, its
    shape keys seen); only the RequestQueue — the crashed thread and its
    poisoned pending state — is rebuilt.

    States: ``init`` (built, not started) → ``running`` → ``backoff``
    (crashed/wedged, restart scheduled) → ``broken`` (circuit breaker open,
    long cooldown) → ``running`` again, or → ``stopped`` (clean shutdown).
    """

    backend = "thread"

    def __init__(self, idx: int, engine, queue: RequestQueue):
        self.idx = idx
        self.engine = engine
        self.queue = queue
        self.state = "init"
        self.failures = 0        # consecutive supervised failures (breaker)
        self.restarts = 0        # lifetime supervised restarts
        self.started_at = 0.0
        self.next_restart_at = 0.0
        self.last_reason: Optional[str] = None
        self._inflight: Dict[int, _Tracked] = {}
        self._lock = threading.Lock()

    def healthy(self) -> bool:
        return self.state == "running" and self.queue.alive()

    # ---- in-flight tracking (at-most-once claim protocol) ----------------
    def track(self, rec: _Tracked) -> None:
        with self._lock:
            self._inflight[id(rec)] = rec

    def untrack(self, rec: _Tracked) -> bool:
        """Claim one record; True for exactly one of the competing claimers
        (inner-future callback vs supervisor drain)."""
        with self._lock:
            return self._inflight.pop(id(rec), None) is not None

    def drain_inflight(self) -> List[_Tracked]:
        with self._lock:
            recs = list(self._inflight.values())
            self._inflight.clear()
        return recs

    def inflight_count(self) -> int:
        with self._lock:
            return len(self._inflight)

    def fresh_queue(self) -> RequestQueue:
        """Replacement RequestQueue cloned from the dead one's knobs; the
        warmed engine is reused as-is."""
        old = self.queue
        self.queue = RequestQueue(
            self.engine,
            batch_deadline_ms=old.batch_deadline * 1e3,
            queue_capacity=old._ingress.maxsize,
            request_timeout_ms=old.request_timeout * 1e3,
            result_margin_s=old.result_margin,
            metrics=old.metrics)
        return self.queue

    # ---- lifecycle --------------------------------------------------------
    def start_queue(self) -> None:
        """Start the current queue (ReplicaSet.start / supervisor restart)."""
        self.queue.start()

    def restart_queue(self) -> None:
        """Supervisor restart: a fresh queue, then start it."""
        self.fresh_queue()
        self.start_queue()

    def warmup(self, sizes) -> List[Bucket]:
        """Warm this replica's engine (its kernels built before traffic)."""
        return self.engine.warmup(sizes)

    def swap_params(self, checkpoint: str, new_params, rungs) -> int:
        """Blue/green unit, one replica: canary CANDIDATE params on this
        replica's engine, then flip (the engine installs a new module).
        Returns rungs checked; raises (CanaryError, ...) without flipping
        on failure."""
        checked = self.engine.canary(new_params, rungs)
        self.engine.params = new_params
        return checked

    def swap_rollback(self, old_params) -> None:
        """Undo a flip this swap already applied to this replica."""
        self.engine.params = old_params


class ReplicaSet:
    """N shared-nothing replicas of one model behind one admission front.

    Duck-types RequestQueue for the transport/registry (submit,
    submit_rollout, depth, alive, start, stop), adds the failover and
    health surface, and owns the :class:`ReplicaSupervisor`.
    """

    def __init__(self, model: str, pairs, *, supervisor_opts: Optional[dict] = None):
        if not pairs:
            raise ValueError("ReplicaSet needs at least one (engine, queue)")
        self.model = model
        # members are (engine, queue) pairs or pre-built Replica objects
        self.replicas: List[Replica] = []
        for i, item in enumerate(pairs):
            if isinstance(item, Replica):
                item.idx = i
                self.replicas.append(item)
            else:
                eng, q = item
                self.replicas.append(Replica(i, eng, q))
        self.metrics = self.replicas[0].queue.metrics
        self.request_timeout = self.replicas[0].queue.request_timeout
        self.result_margin = self.replicas[0].queue.result_margin
        self._rr = 0
        self._lock = threading.Lock()
        self._supervised = False
        # replica indices pinned OUT of live round-robin (the promotion
        # conveyor's canary slice): still supervised, still restartable,
        # but _choose never routes live traffic to them — shadow traffic is
        # submitted straight to the replica's own queue
        self._quarantined: Set[int] = set()
        # monotonic index source for replicas added LIVE (autoscaler
        # scale-up): indices are never renumbered or reused, so per-replica
        # gauges and health rows keyed on idx can't alias across a
        # grow/shrink cycle
        self._next_idx = len(self.replicas)
        from distegnn_tpu_torch.serve.supervisor import ReplicaSupervisor
        self.supervisor = ReplicaSupervisor(self, **(supervisor_opts or {}))

    # ---- RequestQueue-compatible surface ---------------------------------
    @property
    def engine(self):
        """Primary replica's engine — the registry's width/session-cache/
        capability handle (stable across restarts)."""
        return self.replicas[0].engine

    @property
    def ladder(self):
        return self.replicas[0].engine.ladder

    def start(self) -> "ReplicaSet":
        now = time.perf_counter()
        for r in self.replicas:
            r.start_queue()
            r.state = "running"
            r.started_at = now
        self._supervised = True
        self.supervisor.start()
        return self

    def begin_stop(self) -> None:
        """Phase 1 of shutdown: drop the supervised flag and stop the
        supervisor BEFORE any queue drains, so an in-flight restart can
        never revive a queue after drain has begun —
        the supervisor's _restart rechecks ``_supervised`` after its
        blocking claim and aborts. Idempotent; ModelRegistry.stop calls it
        for EVERY model before draining any of them."""
        self._supervised = False
        self.supervisor.stop()

    def stop(self, drain: bool = True, join_timeout_s: float = 30.0) -> None:
        self.begin_stop()
        for r in self.replicas:
            r.queue.stop(drain=drain, join_timeout_s=join_timeout_s)
            r.state = "stopped"

    def alive(self) -> bool:
        return any(r.queue.alive() for r in self.replicas)

    def depth(self) -> int:
        return sum(r.queue.depth() for r in self.replicas)

    def submit(self, graph: dict, bucket=None,
               request_id: Optional[str] = None) -> ServeFuture:
        return self._admit("predict", graph, bucket, request_id)

    def submit_rollout(self, scene: dict,
                       request_id: Optional[str] = None,
                       stream=None) -> ServeFuture:
        return self._admit("rollout", scene, None, request_id, stream=stream)

    # ---- elastic membership (autoscaler surface) -------------------------
    def add_replica(self, build_fn, warm_sizes=None) -> Replica:
        """Grow the set LIVE by one replica built by ``build_fn(idx) ->
        Replica`` (the registry's per-model factory). The new replica gets a
        fresh monotonic index, is started AND warmed at ``warm_sizes``
        BEFORE it becomes visible (so admission never picks a half-built
        member, and a mid-spike scale-up never routes live traffic into a
        kernel build) — warmup failure is non-fatal, the replica just
        builds lazily on first traffic. Because the supervisor's tick
        iterates the live list, the new member is supervised from its next
        tick with no extra wiring. Raises whatever the factory or queue
        start raises; nothing is appended on failure."""
        with self._lock:
            idx = self._next_idx
            self._next_idx += 1
        replica = build_fn(idx)
        replica.idx = idx
        replica.start_queue()
        if warm_sizes:
            try:
                replica.warmup(warm_sizes)
            except Exception as exc:
                obs.log(f"replica {idx}: pre-visibility warmup failed "
                        f"({exc!r}); building lazily on first traffic")
        replica.state = "running"
        replica.started_at = time.perf_counter()
        with self._lock:
            self.replicas.append(replica)
        return replica

    def retire_replica(self, drain_timeout_s: float = 30.0
                       ) -> Optional[Replica]:
        """Shrink the set LIVE by one replica, preserving at-most-once: the
        victim (the newest running replica; replica 0 — the registry's
        engine handle — is never retired) first stops being choosable
        (state ``retiring`` fails ``healthy()``), then its in-flight set
        and queue depth drain (bounded by ``drain_timeout_s``), then its
        queue stops with drain and the replica leaves the list. Returns
        the retired replica, or None when only one running replica
        remains."""
        with self._lock:
            running = [r for r in self.replicas if r.state == "running"
                       and r.idx not in self._quarantined]
            if len(running) <= 1:
                return None
            victim = running[-1]
            if victim is self.replicas[0]:
                return None
            victim.state = "retiring"
        deadline = time.perf_counter() + float(drain_timeout_s)
        while time.perf_counter() < deadline:
            if victim.inflight_count() == 0 and victim.queue.depth() == 0:
                break
            time.sleep(0.01)
        # claim whatever the drain window could not flush (a wedged
        # dispatcher) BEFORE stopping the queue — the supervisor's ordering:
        # stop would fail the stragglers' inner futures, and the done
        # callback passes a non-crash error straight to the client; a claim
        # is compare-and-pop, so a result that races in still wins exactly
        # once
        self.fail_over_replica(victim, reason="retired with work in flight")
        victim.queue.stop(drain=True, join_timeout_s=float(drain_timeout_s))
        victim.state = "stopped"
        with self._lock:
            if victim in self.replicas:
                self.replicas.remove(victim)
        return victim

    # ---- canary quarantine (promotion conveyor surface) ------------------
    def quarantine(self, idx: int) -> bool:
        """Pin replica ``idx`` out of live round-robin (the promotion
        canary slice). Refused (returns False) when it would leave no other
        healthy live replica — a single-replica fleet has no slice to
        spare. Idempotent; the replica stays supervised throughout."""
        with self._lock:
            target = next((r for r in self.replicas if r.idx == idx), None)
            if target is None:
                return False
            others = [r for r in self.replicas
                      if r.idx != idx and r.idx not in self._quarantined
                      and r.healthy()]
            if not others:
                return False
            self._quarantined.add(idx)
            return True

    def release(self, idx: int) -> None:
        """Return a quarantined replica to live rotation. Idempotent."""
        with self._lock:
            self._quarantined.discard(idx)

    def quarantined(self) -> Set[int]:
        with self._lock:
            return set(self._quarantined)

    # ---- dispatch / failover ---------------------------------------------
    def _admit(self, kind: str, payload: dict, bucket, request_id,
               stream=None) -> ServeFuture:
        now = time.perf_counter()
        outer = ServeFuture(
            hard_deadline=now + self.request_timeout + self.result_margin)
        rec = _Tracked(kind, payload, bucket, request_id, outer,
                       stream=stream)
        self._dispatch(rec, admission=True)
        return outer

    def _choose(self, exclude: Set[int]) -> Optional[Replica]:
        with self._lock:
            cands = [r for r in self.replicas
                     if r.idx not in exclude and r.healthy()
                     and r.idx not in self._quarantined]
            if not cands:
                return None
            self._rr += 1
            return cands[self._rr % len(cands)]

    def _dispatch(self, rec: _Tracked, admission: bool) -> None:
        replica = self._choose(rec.tried)
        if replica is None:
            if not self._supervised and not rec.tried:
                # pass-through: an unstarted/unsupervised set surfaces
                # replica 0's own admission errors (RuntimeError not-started,
                # QueueFullError) exactly as a single queue does
                replica = self.replicas[0]
            else:
                exc = ModelUnavailableError(self.model,
                                            retry_after_s=self.retry_after_s())
                if admission:
                    raise exc
                rec.outer.set_exception(exc)
                if rec.stream is not None:
                    rec.stream.fail(exc)
                return
        rec.tried.add(replica.idx)
        try:
            if rec.kind == "rollout":
                inner = replica.queue.submit_rollout(
                    rec.payload, request_id=rec.request_id,
                    stream=rec.stream)
            else:
                inner = replica.queue.submit(
                    rec.payload, bucket=rec.bucket, request_id=rec.request_id)
        except Exception:
            if admission:
                raise  # typed 4xx/5xx mapping happens at the gateway
            # survivor couldn't admit (full / just died): try the next one;
            # recursion is bounded by the growing tried set
            self._dispatch(rec, admission=False)
            return
        replica.track(rec)
        inner.add_done_callback(
            lambda fut, rec=rec, rep=replica: self._on_inner_done(rec, rep, fut))

    def _on_inner_done(self, rec: _Tracked, replica: Replica,
                       inner: ServeFuture) -> None:
        if not replica.untrack(rec):
            return  # supervisor already claimed it (drained for failover)
        exc = inner.exception()
        if isinstance(exc, DispatcherCrashError) and rec.stream is None:
            # streams are deliberately NOT failed over: the client may have
            # already consumed a chunk prefix, and a re-dispatch would
            # replay it from step 0 — the sink carries the typed error and
            # the client retries the whole request instead
            self._fail_over(rec, replica, reason=str(exc))
            return
        rec.outer.meta.update(inner.meta)
        rec.outer.meta["replica"] = replica.idx
        if exc is not None:
            rec.outer.set_exception(exc)
        else:
            rec.outer.set_result(inner._result)

    def _fail_over(self, rec: _Tracked, dead: Replica, reason: str) -> None:
        if rec.stream is not None:
            # no stream failover (see _on_inner_done): surface the typed
            # error on both the future and the sink so the consumer ends
            exc = DispatcherCrashError(
                f"streamed rollout lost its replica ({reason[:160]}); "
                f"streams are not failed over — retry the request")
            rec.outer.set_exception(exc)
            rec.stream.fail(exc)
            return
        self.metrics.failed_over()
        obs.event("gateway/replica_failover", model=self.model,
                  replica=dead.idx, request_id=rec.request_id,
                  tried=sorted(rec.tried), reason=reason[:160])
        self._dispatch(rec, admission=False)

    def fail_over_replica(self, replica: Replica, reason: str) -> int:
        """Supervisor entry point: claim and re-dispatch everything in
        flight on a dead/wedged replica. Returns how many moved."""
        recs = replica.drain_inflight()
        for rec in recs:
            self._fail_over(rec, replica, reason=reason)
        return len(recs)

    # ---- health / hints ---------------------------------------------------
    def available(self) -> int:
        with self._lock:
            return sum(1 for r in self.replicas
                       if r.healthy() and r.idx not in self._quarantined)

    def health(self) -> List[dict]:
        rows = []
        for r in self.replicas:
            row = {"replica": r.idx, "state": r.state,
                   "alive": r.queue.alive(), "failures": r.failures,
                   "restarts": r.restarts, "inflight": r.inflight_count(),
                   "depth": r.queue.depth(), "last_reason": r.last_reason,
                   "quarantined": r.idx in self._quarantined,
                   "backend": r.backend}
            rows.append(row)
        return rows

    def retry_after_s(self) -> float:
        """Hint for 503 Retry-After: time to the earliest scheduled replica
        restart (floored at 0.1 s so clients never busy-spin)."""
        now = time.perf_counter()
        waits = [r.next_restart_at - now for r in self.replicas
                 if r.state in ("backoff", "broken")]
        if not waits:
            return 1.0
        return round(max(min(waits), 0.1), 3)

    def queue_retry_after_s(self) -> float:
        """Hint for 429 Retry-After: roughly how long the current backlog
        takes to drain (one batch deadline per max_batch queued requests),
        clamped to [0.1, 5] s."""
        per_batch = max(self.replicas[0].queue.batch_deadline, 0.01)
        max_batch = max(int(getattr(self.engine, "max_batch", 1)), 1)
        est = per_batch * (1.0 + self.depth() / max_batch)
        return round(min(max(est, 0.1), 5.0), 3)
