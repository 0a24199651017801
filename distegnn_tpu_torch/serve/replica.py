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

Two backends (``serve.workers``): ``thread`` — every replica's dispatcher
is a thread of this process, and replicas on one card serialize there, as
JAX's replicas on one device do — and ``process`` (:class:`WorkerReplica`):
each replica's batches execute in a worker child (``serve/worker.py``), one
interpreter and one CUDA context per replica, while admission, failover
and the in-flight records stay in this process, so at-most-once failover
survives a SIGKILL'd child.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Set

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.serve import worker as worker_mod
from distegnn_tpu_torch.serve.buckets import Bucket
from distegnn_tpu_torch.serve.queue import (DispatcherCrashError,
                                            RequestQueue, ServeFuture,
                                            WorkerLostError, _request_ids)


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

    # ---- backend lifecycle (WorkerReplica overrides) ---------------------
    def start_queue(self) -> None:
        """Start the current queue (ReplicaSet.start / supervisor restart).
        WorkerReplica's override spawns the child and degrades to an
        in-process queue on spawn failure."""
        self.queue.start()

    def restart_queue(self) -> None:
        """Supervisor restart: fresh queue (fresh worker for the process
        backend), then start it."""
        self.fresh_queue()
        self.start_queue()

    def warmup(self, sizes) -> List[Bucket]:
        """Warm this replica's EXECUTOR (its kernels built before traffic):
        the local engine here, the worker child for the process backend."""
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

    def backend_detail(self) -> dict:
        """Extra per-replica health fields (pid/heartbeat/degraded for the
        process backend; empty for threads)."""
        return {}

    def heartbeat_age(self) -> Optional[float]:
        """Seconds since the executor last beat: None, a thread has no
        heartbeat (WorkerReplica reads its child's)."""
        return None

    def reconcile_checkpoint(self) -> None:
        """Supervisor tick hook: nothing to heal for a thread replica (its
        params live in this process; WorkerReplica swaps a stale child)."""


def _obs_run_dir() -> Optional[str]:
    """Directory of the live obs sink (``<run>/obs``) — worker children put
    their stderr logs and per-process event files next to the parent's
    events.jsonl. None when tracing is off (worker stderr then lands in a
    tempdir so it is never lost)."""
    try:
        w = obs.get_tracer().writer
        if w is not None and getattr(w, "path", None):
            return os.path.dirname(os.path.abspath(str(w.path)))
    except Exception:
        pass
    return None


class WorkerQueue(RequestQueue):
    """RequestQueue whose micro-batches execute in an out-of-process worker
    child over the checksummed IPC channel (serve/worker.py).

    Inherits ALL of the parent-side machinery — bounded ingress, per-bucket
    coalescing, deadlines, poison retry, kill/wedge chaos, crash budget —
    and overrides only the batch-execution hop: ``_run_batch`` becomes one
    framed call with a hard deadline, and a dead channel surfaces as
    :class:`~distegnn_tpu_torch.serve.queue.WorkerLostError` so the
    dispatcher poisons itself and the replica layer fails the work over.
    The parent-side ``engine`` stays the model's reference handle (ladder
    math, prep cache, params for digest/fallback); it never executes this
    queue's traffic.
    """

    backend = "process"

    def __init__(self, engine, *, spawn_fn, model: str = "default",
                 idx: int = 0, kill_grace_s: float = 3.0, **queue_kw):
        super().__init__(engine, **queue_kw)
        self._spawn_fn = spawn_fn  # () -> WorkerHandle; may raise WorkerSpawnError
        self.model = model
        self.idx = idx
        self.kill_grace_s = float(kill_grace_s)
        self.worker: Optional[worker_mod.WorkerHandle] = None

    def start(self):
        if self.worker is None:
            self.worker = self._spawn_fn()  # WorkerSpawnError propagates
        return super().start()

    def alive(self) -> bool:
        w = self.worker
        return (super().alive() and w is not None
                and w.lost_reason is None and w.proc_alive())

    def heartbeat_age(self) -> Optional[float]:
        """Seconds since the child's last frame (the supervisor's staleness
        wedge signal); None before the worker exists."""
        w = self.worker
        return None if w is None else w.heartbeat_age()

    @property
    def pid(self) -> Optional[int]:
        w = self.worker
        return None if w is None else w.pid

    def _run_batch(self, key, reqs) -> List:
        kind, bucket, _steps = key
        if kind == "rollout_stream":
            # the IPC channel is one framed call per batch — there is no
            # chunk conduit to a child. The ReplicaSet routes streams to
            # thread replicas; this is the typed backstop for direct callers.
            exc = RuntimeError(
                f"streamed rollouts are not supported over the "
                f"process-worker IPC channel ({self.model}/{self.idx}); "
                f"route to a thread-backend replica")
            for r in reqs:
                if r.stream is not None:
                    r.stream.fail(exc)
                r.future.set_exception(exc)
            return [{"error": "stream-unsupported"}] * len(reqs)
        w = self.worker
        if w is None:
            raise WorkerLostError(
                f"worker {self.model}/{self.idx} never spawned")
        rids = _request_ids(reqs)
        timeout = self.request_timeout + self.result_margin
        try:
            if kind == "rollout":
                return w.call("rollout",
                              {"scenes": [r.graph for r in reqs],
                               "request_ids": rids}, timeout_s=timeout)
            return w.call("predict",
                          {"graphs": [r.graph for r in reqs],
                           "bucket": list(bucket) if bucket else None,
                           "request_ids": rids}, timeout_s=timeout)
        except (worker_mod.WorkerClosedError,
                worker_mod.WorkerTimeoutError) as exc:
            raise WorkerLostError(
                f"worker {self.model}/{self.idx} (pid {self.pid}) lost "
                f"mid-batch: {exc}") from exc

    def kill(self, reason: str = "killed") -> None:
        super().kill(reason)
        self.ensure_worker_dead()

    def ensure_worker_dead(self) -> None:
        """SIGTERM → SIGKILL the child and reap the zombie (idempotent)."""
        w = self.worker
        if w is not None:
            w.terminate(grace_s=self.kill_grace_s)

    def stop(self, drain: bool = True, join_timeout_s: float = 30.0) -> None:
        super().stop(drain=drain, join_timeout_s=join_timeout_s)
        w = self.worker
        if w is not None and w.lost_reason is None and w.proc_alive():
            try:
                # polite shutdown flushes the child's obs buffers
                w.call("shutdown", timeout_s=min(float(join_timeout_s), 5.0))
            except worker_mod.WorkerError:
                pass
        self.ensure_worker_dead()


class WorkerReplica(Replica):
    """Replica whose dispatcher queue executes in a worker child process
    (``serve.workers: process``).

    The ``engine`` attribute stays the PARENT-side reference handle: it
    holds the canonical params (digest source for the spawn handshake,
    fallback source for degradation) and the shared prep/session caches,
    but never runs this replica's traffic. In-flight tracking lives in the
    base class — in the parent — which is what makes at-most-once failover
    survive a SIGKILL'd child.

    Degradation: a spawn failure (exec error, init crash, no card, digest
    mismatch) falls back to a fresh in-process queue with a
    ``gateway/worker_degraded`` event — the model keeps serving without
    isolation, and the next supervised restart attempts a real worker
    again.
    """

    backend = "process"

    def __init__(self, idx: int, engine, *, model: str, queue_kw: dict,
                 worker_opts: dict, cfg_dict: dict, fallback_factory,
                 checkpoint: Optional[str] = None):
        super().__init__(idx, engine, None)
        self.model_name = model
        self.degraded = False
        self.current_checkpoint = checkpoint  # tracks swaps for respawn
        self.warm_sizes: List = []
        self._queue_kw = dict(queue_kw)
        self._worker_opts = dict(worker_opts or {})
        self._cfg_dict = cfg_dict
        self._fallback_factory = fallback_factory
        self._spawn_fail_next = 0  # chaos: forced spawn failures
        self._swap_prev_ckpt: Optional[str] = None
        # orders deferred-swap bookkeeping against the post-spawn catch-up
        # check in start_queue (a swap can defer WHILE a respawn is in
        # flight; whichever side runs second must see the other's write)
        self._ckpt_lock = threading.Lock()
        # the params digest a child must report for each checkpoint it is
        # sent (None: the config's seeded params); the parent engine holds
        # ``checkpoint``'s params now
        self._digests: Dict[Optional[str], str] = {
            checkpoint: engine.params_digest()}
        self.queue = self._make_worker_queue()

    # ---- spawn -----------------------------------------------------------
    def _make_worker_queue(self) -> WorkerQueue:
        return WorkerQueue(
            self.engine, spawn_fn=self._spawn_worker, model=self.model_name,
            idx=self.idx,
            kill_grace_s=float(self._worker_opts.get("kill_grace_s", 3.0)),
            **self._queue_kw)

    def _expected_digest(self, checkpoint: Optional[str]) -> str:
        """The digest of the params a child spawned on ``checkpoint`` must
        report: the parent's own where it holds that version, else the
        checkpoint loaded here (a canary killed before its rollback
        respawns on the candidate while the parent holds the live
        version)."""
        if checkpoint not in self._digests:
            import copy

            from distegnn_tpu_torch.serve.engine import params_digest
            from distegnn_tpu_torch.train.checkpoint import load_params

            try:
                if checkpoint is None:
                    from distegnn_tpu_torch.config import ConfigDict
                    from distegnn_tpu_torch.serve import \
                        engine_with_params_from_config

                    sd = engine_with_params_from_config(
                        ConfigDict(self._cfg_dict), device="cpu",
                        checkpoint="")[0].state_dict()
                else:
                    sd = load_params(checkpoint, copy.deepcopy(
                        self.engine.model).cpu()).state_dict()
            except Exception as exc:
                raise worker_mod.WorkerSpawnError(
                    f"worker {self.model_name}/{self.idx}: checkpoint "
                    f"{checkpoint!r} does not load: {exc!r}") from exc
            self._digests[checkpoint] = params_digest(sd)
        return self._digests[checkpoint]

    def _spawn_worker(self) -> worker_mod.WorkerHandle:
        if self._spawn_fail_next > 0:
            self._spawn_fail_next -= 1
            raise worker_mod.WorkerSpawnError(
                f"injected spawn failure (chaos) for "
                f"{self.model_name}/{self.idx}")
        opts = self._worker_opts
        checkpoint = self.current_checkpoint
        return worker_mod.WorkerHandle.spawn(
            self._cfg_dict, self.model_name, self.idx,
            checkpoint=checkpoint,
            warm_sizes=list(self.warm_sizes),
            obs_dir=_obs_run_dir(),
            spawn_timeout_s=float(opts.get("spawn_timeout_s", 120.0)),
            heartbeat_s=float(opts.get("heartbeat_s", 0.5)),
            kill_grace_s=float(opts.get("kill_grace_s", 3.0)),
            expect_digest=self._expected_digest(checkpoint),
            precision=worker_mod.current_precision(),
            device=str(self.engine.device))

    def fail_next_spawns(self, n: int = 1) -> None:
        """Chaos hook (testing/serve_faults.py): the next ``n`` spawn
        attempts raise WorkerSpawnError, exercising degradation."""
        self._spawn_fail_next = int(n)

    # ---- lifecycle -------------------------------------------------------
    def start_queue(self) -> None:
        try:
            self.queue.start()
            if isinstance(self.queue, WorkerQueue):
                self.degraded = False
                self._catch_up_checkpoint()
        except worker_mod.WorkerSpawnError as exc:
            obs.event("gateway/worker_degraded", model=self.model_name,
                      replica=self.idx, error=str(exc)[:300])
            if isinstance(self.queue, WorkerQueue):
                # a failed catch-up swap leaves a RUNNING queue over a
                # stale child: poison the dispatcher and kill the child
                self.queue.kill(reason="stale-checkpoint catch-up failed")
            _eng, q = self._fallback_factory()
            self.queue = q
            self.queue.start()
            self.degraded = True

    def _catch_up_checkpoint(self) -> None:
        """Close the in-flight-spawn swap window: a spawn takes seconds
        (the child's torch import and CUDA context), and a hot-swap that
        arrives in that window defers — but the child already captured the
        PRE-swap checkpoint, so without this it would come up serving stale
        params and the deferral would never reach it. Compare what the
        child actually loaded against ``current_checkpoint`` under the same
        lock the deferred branch writes it, and swap the fresh worker over
        IPC if they diverge. A failure here is a spawn failure (the child is
        unusable on the wrong version) → WorkerSpawnError → degradation,
        whose fallback serves the parent handle's post-swap params."""
        w = self.queue.worker
        if w is None:
            return
        with self._ckpt_lock:
            want = self.current_checkpoint
            if getattr(w, "checkpoint", None) == want:
                return
            try:
                w.call("swap", {"checkpoint": want, "rungs": []},
                       timeout_s=float(
                           self._worker_opts.get("spawn_timeout_s", 120.0)))
            except worker_mod.WorkerError as exc:
                raise worker_mod.WorkerSpawnError(
                    f"worker {self.model_name}/{self.idx} spawned on a "
                    f"stale checkpoint and the catch-up swap to {want!r} "
                    f"failed: {exc}") from exc
            w.checkpoint = want
            obs.event("gateway/swap_catchup", model=self.model_name,
                      replica=self.idx, path=want)

    def reconcile_checkpoint(self) -> None:
        """Supervisor-tick safety net for the last swap/respawn race window
        (a deferral landing between the post-spawn catch-up check and the
        replica being marked up): if a healthy worker is serving a version
        other than ``current_checkpoint``, catch it up now; if that fails,
        kill the queue so the normal restart path reloads the right
        version. Normal ticks cost one attribute compare."""
        if self.degraded or not isinstance(self.queue, WorkerQueue):
            return
        w = self.queue.worker
        if (w is None
                or getattr(w, "checkpoint", None) == self.current_checkpoint):
            return
        try:
            self._catch_up_checkpoint()
        except worker_mod.WorkerSpawnError:
            self.queue.kill(reason="checkpoint reconcile failed")

    def fresh_queue(self) -> WorkerQueue:
        old = self.queue
        if isinstance(old, WorkerQueue):
            old.ensure_worker_dead()
        # ALWAYS retry the worker backend, even off a degraded fallback:
        # degradation is temporary by construction
        self.queue = self._make_worker_queue()
        return self.queue

    def warmup(self, sizes) -> List[Bucket]:
        self.warm_sizes = [tuple(s) for s in sizes]
        if not isinstance(self.queue, WorkerQueue):
            return self.queue.engine.warmup(sizes)
        w = self.queue.worker
        if w is None:
            raise RuntimeError(
                f"worker {self.model_name}/{self.idx} not spawned — start "
                f"the replica set before warmup")
        rungs = w.call(
            "warmup", {"sizes": [list(s) for s in self.warm_sizes]},
            timeout_s=float(self._worker_opts.get("spawn_timeout_s", 120.0)))
        return [Bucket(*r) for r in rungs]

    # ---- blue/green ------------------------------------------------------
    def swap_params(self, checkpoint: str, new_params, rungs) -> int:
        self._swap_prev_ckpt = self.current_checkpoint
        if not isinstance(self.queue, WorkerQueue):
            # degraded fallback executes in-process: flip its engine
            checked = self.queue.engine.canary(new_params, rungs)
            self.queue.engine.params = new_params
            self.current_checkpoint = str(checkpoint)
            return checked
        w = self.queue.worker
        if w is None or not self.healthy():
            # down / mid-restart: adopt the new version at the next respawn
            # instead of failing the whole swap. Under _ckpt_lock so a
            # respawn already past its catch-up check can't miss this write
            # (the catch-up re-reads current_checkpoint under the same lock).
            with self._ckpt_lock:
                self.current_checkpoint = str(checkpoint)
            obs.event("gateway/swap_deferred", model=self.model_name,
                      replica=self.idx, path=str(checkpoint))
            return 0
        res = w.call(
            "swap", {"checkpoint": str(checkpoint),
                     "rungs": [[b.n, b.e] for b in rungs]},
            timeout_s=float(self._worker_opts.get("spawn_timeout_s", 120.0)))
        self.current_checkpoint = str(checkpoint)
        # the child's version, so the reconcile swaps only real divergence
        w.checkpoint = str(checkpoint)
        return int(res.get("rungs", 0))

    def swap_rollback(self, old_params) -> None:
        self.current_checkpoint = self._swap_prev_ckpt
        if not isinstance(self.queue, WorkerQueue):
            self.queue.engine.params = old_params
            return
        w = self.queue.worker
        if w is not None and self.healthy():
            try:
                res = w.call("swap_rollback", timeout_s=30.0)
            except worker_mod.WorkerError:
                return  # child is dying; its respawn loads _swap_prev_ckpt
            if res.get("rolled_back"):
                w.checkpoint = self.current_checkpoint
            # a child respawned on the candidate holds nothing to roll back
            # to: swap it to the version this replica now serves
            self.reconcile_checkpoint()

    # ---- health ----------------------------------------------------------
    def heartbeat_age(self) -> Optional[float]:
        q = self.queue
        return q.heartbeat_age() if isinstance(q, WorkerQueue) else None

    def backend_detail(self) -> dict:
        q = self.queue
        if self.degraded or not isinstance(q, WorkerQueue):
            return {"backend": "thread", "degraded": self.degraded,
                    "pid": None, "heartbeat_age_s": None}
        age = self.heartbeat_age()
        ready = q.worker.ready if q.worker is not None else {}
        return {"backend": "process", "degraded": False, "pid": q.pid,
                "heartbeat_age_s": None if age is None else round(age, 3),
                # what the child came up on (its spawn handshake): exec to
                # ready, and the part of it after the init message
                "device": ready.get("device_name", ready.get("device")),
                "params_digest": ready.get("params_digest"),
                "spawn_s": (None if q.worker is None
                            or q.worker.spawn_s is None
                            else round(q.worker.spawn_s, 3)),
                "init_s": ready.get("init_s")}


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
        # (the registry hands in WorkerReplicas for the process backend)
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
        # a process replica's start blocks on its child's init handshake
        # (interpreter, torch, device context): the replicas come up side
        # by side, not one after another
        errors: List[BaseException] = []

        def start_one(r):
            try:
                r.start_queue()
            except BaseException as exc:
                errors.append(exc)

        threads = [threading.Thread(target=start_one, args=(r,),
                                    name=f"replica-start-{r.idx}")
                   for r in self.replicas]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        for r in self.replicas:
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

    def submit_tiled(self, graph: dict,
                     request_id: Optional[str] = None,
                     stream=None) -> ServeFuture:
        """Above-ladder predict through the tiled executor. Runs only on
        in-process replicas (the host-side halo exchange loop can't cross
        the worker IPC channel). ``serve.tiled.devices`` > 1 parallelizes
        WITHIN one request (tile rounds over cards, serve/mesh_tiled.py) —
        orthogonal to replica-level parallelism across requests."""
        return self._admit("tiled", graph, None, request_id, stream=stream)

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

    def supports_streaming(self) -> bool:
        """True when some member executes in-process (a plain RequestQueue)
        — the chunk conduit can't cross the worker IPC channel, so the
        gateway falls back to buffered rollouts when this is False."""
        with self._lock:
            return any(not isinstance(r.queue, WorkerQueue)
                       for r in self.replicas)

    # ---- dispatch / failover ---------------------------------------------
    def _admit(self, kind: str, payload: dict, bucket, request_id,
               stream=None) -> ServeFuture:
        now = time.perf_counter()
        factor = 1.0
        if kind == "tiled":
            # a tiled predict runs L x n_tiles tile forwards; its inner
            # deadline is scaled by serve.tiled.timeout_factor, so the outer
            # safety net must stretch by the same factor
            tiled = getattr(self.replicas[0].engine, "tiled", None)
            factor = max(float(getattr(tiled, "timeout_factor", 1.0) or 1.0),
                         1.0)
        outer = ServeFuture(
            hard_deadline=now + (self.request_timeout + self.result_margin)
            * factor)
        rec = _Tracked(kind, payload, bucket, request_id, outer,
                       stream=stream)
        self._dispatch(rec, admission=True)
        return outer

    def _choose(self, exclude: Set[int],
                thread_only: bool = False) -> Optional[Replica]:
        with self._lock:
            cands = [r for r in self.replicas
                     if r.idx not in exclude and r.healthy()
                     and r.idx not in self._quarantined
                     and not (thread_only and isinstance(r.queue,
                                                         WorkerQueue))]
            if not cands:
                return None
            self._rr += 1
            return cands[self._rr % len(cands)]

    def _dispatch(self, rec: _Tracked, admission: bool) -> None:
        # streams need an in-process executor: the chunk conduit can't
        # cross the worker IPC channel; tiled predicts likewise — the halo
        # exchange loop lives in the gateway's process
        replica = self._choose(rec.tried,
                               thread_only=(rec.stream is not None
                                            or rec.kind == "tiled"))
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
            elif rec.kind == "tiled":
                inner = replica.queue.submit_tiled(
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
            row.update(r.backend_detail())  # may downgrade backend: degraded
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
