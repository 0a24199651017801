"""Request queue and micro-batcher (port of ``distegnn_tpu/serve/queue.py``;
stdlib threads, with the engine swapped): coalesce same-rung requests.

One dispatcher thread owns the serving loop: it drains a BOUNDED ingress
queue into per-key pending lists and flushes a key as a micro-batch when it
reaches ``max_batch`` or its oldest request has waited the batching
deadline (deadline 0 = no batching; larger = fuller batches, and up to the
deadline of added latency).

Rollout requests (``submit_rollout``) ride the same machinery: the ingress,
deadlines, poison isolation and restart containment are shared, but they
coalesce per (node rung, steps), so scenes with different K never co-batch
(``engine.rollout_batch`` raises MixedRolloutStepsError as the typed
backstop). Streamed rollouts (a :class:`StreamSink`) run alone, chunk by
chunk (``engine.rollout_stream``).

Failure surfaces (never silent):
  - ingress full            -> QueueFullError raised at submit (backpressure)
  - graph exceeds ladder    -> BucketOverflowError raised at submit
  - deadline passed queued  -> RequestTimeoutError set on the future
  - engine/model exception  -> each request of the batch is retried ALONE
    once (one poison graph must not take down its batchmates); only the
    requests that fail alone get the exception (counted as ``poison``)
  - dispatcher thread crash -> restarted with exponential backoff, up to
    ``_MAX_WORKER_RESTARTS`` times within ``_RESTART_WINDOW_S``; past the
    budget every outstanding future fails with :class:`DispatcherCrashError`
    and submit() raises — never a silent hang

The queue also carries the chaos and supervision surface (``kill`` /
``wedge`` / ``inject_latency``) used by the replica supervisor and the
tests, and a ``last_progress`` heartbeat the supervisor reads to detect a
wedged dispatcher (depth > 0 with no batch progress).

The forward runs inline in the dispatcher thread: the card is a serial
resource, and its kernels launch on that thread's current CUDA stream.
``torch.no_grad`` is thread-local, so the engine enters it inside each
call. PyTorch releases the GIL in its kernels, so submitters keep running.
"""

from __future__ import annotations

import queue as _pyqueue
import threading
import time
from typing import Dict, List, Optional

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.serve.buckets import Bucket, BucketLadder
from distegnn_tpu_torch.serve.engine import InferenceEngine
from distegnn_tpu_torch.serve.metrics import ServeMetrics


class QueueFullError(RuntimeError):
    """Bounded ingress queue is full — shed load at the edge."""


class RequestTimeoutError(RuntimeError):
    """The request's deadline passed before a batch picked it up."""


class DispatcherCrashError(RuntimeError):
    """The dispatcher died permanently (crash budget exhausted, or killed by
    chaos / the replica supervisor). Outstanding futures carry this error so
    the replica layer can tell a dead dispatcher (fail over the request)
    from a per-request failure (propagate to the caller)."""


class WorkerLostError(RuntimeError):
    """The out-of-process worker executing this queue's batches is gone
    (dead pipe, SIGKILL'd child, missed deadline). Unlike a per-request
    failure this poisons the WHOLE queue: the dispatcher kills itself so
    every pending future carries :class:`DispatcherCrashError` and the
    replica layer fails the work over — a lost child must never be
    retried request-by-request against the same dead channel."""


class _KilledError(Exception):
    """Internal control flow: the dispatcher observed its kill flag."""


class ServeFuture:
    """Minimal one-shot future (no asyncio dependency in the serving core).

    ``hard_deadline`` (absolute ``time.perf_counter()`` seconds) is the
    belt-and-suspenders bound the queue stamps on every request: a
    ``result()`` call with no explicit timeout waits at most until then, so
    a wedged dispatcher surfaces as :class:`RequestTimeoutError` (the
    gateway's 504) instead of a hung caller. ``meta`` is filled by the
    dispatcher before resolution (queue_ms / compute_ms / batch_filled /
    bucket) for transports that report per-request timing.

    Resolution is FIRST-WINS: once resolved, later ``set_result`` /
    ``set_exception`` calls are ignored (and return False). The replica
    layer relies on this for at-most-once failover — a late result from an
    abandoned wedged replica can't clobber the failover's answer.
    """

    def __init__(self, hard_deadline: Optional[float] = None):
        self._event = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self._hard_deadline = hard_deadline
        self._lock = threading.Lock()
        self._callbacks: List = []
        self.meta: dict = {}

    def _resolve(self, value, exc: Optional[BaseException]) -> bool:
        with self._lock:
            if self._event.is_set():
                return False  # first resolution wins
            self._result = value
            self._exc = exc
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception as cb_exc:
                obs.log(f"serve: future callback raised: {cb_exc!r}")
        return True

    def set_result(self, value) -> bool:
        return self._resolve(value, None)

    def set_exception(self, exc: BaseException) -> bool:
        return self._resolve(None, exc)

    def add_done_callback(self, fn) -> None:
        """Run ``fn(self)`` when the future resolves (immediately if it
        already has). Callbacks fire in the resolving thread; exceptions are
        logged, never propagated into the dispatcher."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception as cb_exc:
            obs.log(f"serve: future callback raised: {cb_exc!r}")

    def done(self) -> bool:
        return self._event.is_set()

    def exception(self) -> Optional[BaseException]:
        """Non-blocking peek at the resolved exception (None if pending or
        resolved with a result)."""
        return self._exc if self._event.is_set() else None

    def result(self, timeout: Optional[float] = None):
        if timeout is None and self._hard_deadline is not None:
            remaining = max(self._hard_deadline - time.perf_counter(), 0.0)
            if not self._event.wait(remaining):
                raise RequestTimeoutError(
                    "request passed its hard deadline with no dispatcher "
                    "progress (dispatcher wedged or overloaded past the "
                    "result margin)")
        elif not self._event.wait(timeout):
            raise TimeoutError("serve future not ready")
        if self._exc is not None:
            raise self._exc
        return self._result


class StreamSink:
    """Chunk conduit between the dispatcher (producer) and a streaming
    consumer (the gateway's chunked-transfer writer) for ONE rollout.

    The producer calls ``put_chunk`` per chunk, then exactly one of
    ``finish`` / ``fail``; the consumer iterates ``next`` and calls
    ``cancel()`` when its client disconnects — the producer polls
    ``cancelled`` between chunk computations and stops, so remaining
    compute is skipped at the next chunk boundary. Thread-safe; items are
    ``("chunk", start_step, traj)``, ``("done", summary, None)``, or
    ``("error", exc, None)``."""

    def __init__(self):
        self._q: "_pyqueue.Queue" = _pyqueue.Queue()
        self._cancelled = threading.Event()

    def put_chunk(self, start_step: int, traj) -> None:
        self._q.put(("chunk", int(start_step), traj))

    def finish(self, summary: dict) -> None:
        self._q.put(("done", summary, None))

    def fail(self, exc: BaseException) -> None:
        self._q.put(("error", exc, None))

    def cancel(self) -> None:
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def next(self, timeout: Optional[float] = None):
        """Blocking pop of the next item; raises ``queue.Empty`` on
        timeout (the consumer's poll loop re-checks the future then)."""
        return self._q.get(timeout=timeout)


class _Request:
    __slots__ = ("graph", "bucket", "kind", "steps", "future", "t_submit",
                 "deadline", "request_id", "stream")

    def __init__(self, graph: dict, bucket: Bucket, deadline: float,
                 hard_deadline: Optional[float] = None,
                 kind: str = "predict", steps: Optional[int] = None,
                 request_id: Optional[str] = None,
                 stream: Optional[StreamSink] = None):
        self.graph = graph
        self.bucket = bucket
        self.kind = kind        # "predict" | "rollout" | "rollout_stream"
        self.steps = steps      # rollout scan length (None for predicts)
        self.future = ServeFuture(hard_deadline=hard_deadline)
        self.t_submit = time.perf_counter()
        self.deadline = deadline
        self.request_id = request_id  # gateway trace id (None off-gateway)
        self.stream = stream    # StreamSink for kind "rollout_stream"

    @property
    def key(self):
        """Micro-batch coalescing key: same-rung predicts batch together as
        before; rollouts additionally key on steps (the rollout's length)
        so mixed-K scenes never co-batch."""
        return (self.kind, self.bucket, self.steps)


def _request_ids(reqs: List["_Request"]) -> List[Optional[str]]:
    """Trace ids for a micro-batch, POSITION-ALIGNED with the batch members
    (so the i-th queue_ms in the batch event belongs to the i-th id). All
    non-gateway traffic (in-proc bench submits) has no ids: return [] so
    those events stay compact."""
    ids = [r.request_id for r in reqs]
    return ids if any(i is not None for i in ids) else []


_STOP = object()
_KILL = object()  # chaos/supervisor kill marker — wakes a blocked ingress.get

# dispatcher crash tolerance: a crashing _loop (a BUG, not an engine error —
# those are caught per-batch) restarts with exponential backoff; only crashes
# within _RESTART_WINDOW_S count against the budget, so the budget replenishes
# after a healthy interval and 3 transient crashes spread over hours never
# kill the queue — but a tight crash loop still dies after
# _MAX_WORKER_RESTARTS + 1 total crashes instead of spinning forever
_MAX_WORKER_RESTARTS = 3
_RESTART_WINDOW_S = 60.0
_RESTART_BACKOFF_BASE_S = 0.05
_RESTART_BACKOFF_MAX_S = 2.0


class RequestQueue:
    """Bounded ingress + per-bucket micro-batcher over an InferenceEngine.

    Args:
      engine: the InferenceEngine (its ladder buckets requests).
      batch_deadline_ms: max time the OLDEST pending request of a bucket
        waits for co-batchable traffic before the bucket flushes.
      queue_capacity: ingress bound; submits beyond it raise QueueFullError.
      request_timeout_ms: per-request deadline (queued time only — an
        admitted request that starts executing always completes).
      result_margin_s: execute-time headroom added on top of the queued
        deadline to form each future's HARD deadline — a no-timeout
        ``ServeFuture.result()`` never waits longer than
        ``request_timeout + result_margin``, so a wedged dispatcher is a
        typed RequestTimeoutError, not a hang.
    """

    backend = "thread"  # executes in this process (WorkerQueue: a child)

    def __init__(self, engine: InferenceEngine, *,
                 batch_deadline_ms: float = 5.0, queue_capacity: int = 256,
                 request_timeout_ms: float = 1000.0,
                 result_margin_s: float = 30.0,
                 metrics: Optional[ServeMetrics] = None):
        self.engine = engine
        self.metrics = metrics or engine.metrics
        self.batch_deadline = batch_deadline_ms / 1e3
        self.request_timeout = request_timeout_ms / 1e3
        self.result_margin = float(result_margin_s)
        self._ingress: "_pyqueue.Queue" = _pyqueue.Queue(maxsize=queue_capacity)
        # keyed on _Request.key = (kind, bucket, steps): predicts coalesce
        # per rung exactly as before; rollouts per (rung, steps)
        self._pending: Dict[tuple, List[_Request]] = {}
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._restarts = 0             # lifetime crash count (informational)
        self._crash_times: List[float] = []  # windowed restart budget
        # chaos / supervision surface
        self._kill_reason: Optional[str] = None
        self._wedge_until = 0.0
        self._inject_latency_s = 0.0
        self.last_progress = time.perf_counter()
        # stop() coordination: idempotent and signal-safe — any number of
        # threads (SIGTERM handler, bench atexit, with-block) may race it
        self._stop_lock = threading.Lock()
        self._stop_begun = False

    @property
    def ladder(self) -> BucketLadder:
        return self.engine.ladder

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "RequestQueue":
        if self._started:
            return self
        with self._stop_lock:
            self._stop_begun = False
        self._started = True
        self._thread = threading.Thread(target=self._run,
                                        name="serve-dispatch", daemon=True)
        self._thread.start()
        return self

    def alive(self) -> bool:
        """True while the dispatcher thread is accepting and running."""
        t = self._thread
        return bool(self._started and t is not None and t.is_alive())

    def stop(self, drain: bool = True, join_timeout_s: float = 30.0) -> None:
        """Stop the dispatcher. ``drain=True`` flushes everything already
        admitted; False fails pending futures with RequestTimeoutError.
        ``join_timeout_s`` bounds the wait for the dispatcher thread — the
        registry's concurrent drain passes its per-model grace slice so one
        wedged queue can't eat every model's budget.

        Idempotent and signal-safe: double-stop, stop-before-start, and
        concurrent stops (the gateway's SIGTERM drain racing a bench's
        with-block exit) never raise, block indefinitely, or strand a
        future. Only the first caller delivers the STOP; later callers just
        wait for the dispatcher to finish.
        """
        with self._stop_lock:
            first = not self._stop_begun
            self._stop_begun = True
            thread = self._thread
        if thread is None:
            # stop before start: nothing is running and nothing was admitted
            self._started = False
            return
        if first:
            self._started = False   # reject new submits while stopping
            # never block forever handing over the STOP: a full ingress with
            # a live dispatcher drains; a dead dispatcher can't take it
            while thread.is_alive():
                try:
                    self._ingress.put((_STOP, drain), timeout=0.05)
                    break
                except _pyqueue.Full:
                    continue
        thread.join(timeout=join_timeout_s)
        if first:
            # a submit racing the final drain check could leave a request in
            # the ingress after the dispatcher exited — fail it, never
            # strand it
            self._fail_all(RequestTimeoutError("server stopped"))

    def __enter__(self) -> "RequestQueue":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- submission ------------------------------------------------------
    def submit(self, graph: dict, bucket: Optional[Bucket] = None,
               request_id: Optional[str] = None) -> ServeFuture:
        """Admit one pad_graphs-style graph dict; returns a ServeFuture
        resolving to the predicted positions [n, 3] (numpy). ``bucket``
        overrides the ladder assignment — the session prep cache passes the
        rung it computed from the RAW topology, since a prepared (blocked)
        dict's inflated edge count would otherwise re-bucket it.
        ``request_id`` tags the request's batch/execute spans in the event
        stream (the gateway passes its X-Request-Id)."""
        if not self._started:
            raise RuntimeError("RequestQueue not started (use start() or a "
                               "with-block)")
        if bucket is None:
            bucket = self.ladder.bucket_of_graph(graph)  # BucketOverflowError
        now = time.perf_counter()
        req = _Request(graph, bucket, deadline=now + self.request_timeout,
                       hard_deadline=(now + self.request_timeout
                                      + self.result_margin),
                       request_id=request_id)
        return self._enqueue(req)

    def submit_rollout(self, scene: dict,
                       request_id: Optional[str] = None,
                       stream: Optional[StreamSink] = None) -> ServeFuture:
        """Admit one rollout scene dict (``loc`` [n,3], ``vel`` [n,3],
        ``steps`` int, optional ``node_mask``); resolves to the trajectory
        [steps, n, 3]. Same deadline/backpressure semantics as ``submit`` —
        rollouts share the ingress, deadlines, and restart containment; they
        coalesce per (node rung, steps), so same-shape same-K scenes fill one
        rollout batch exactly like predicts fill a padded batch.

        With ``stream`` (a :class:`StreamSink`), the scene runs as a CHUNKED
        stream instead: the trajectory arrives on the sink chunk by chunk
        (``engine.rollout_stream``), the future resolves to the run summary,
        and a ``stream.cancel()`` stops the remaining chunks. Streams never
        co-batch with buffered rollouts and never enter the solo-retry path
        after partial emission — a failed chunk fails the sink, once."""
        if not self._started:
            raise RuntimeError("RequestQueue not started (use start() or a "
                               "with-block)")
        steps = int(scene.get("steps", 0))
        if steps < 1:
            raise ValueError(f"rollout steps must be >= 1, got {steps}")
        n_pad = self.engine.rollout_rung(int(scene["loc"].shape[0]))
        now = time.perf_counter()
        req = _Request(scene, Bucket(n_pad, 0),
                       deadline=now + self.request_timeout,
                       hard_deadline=(now + self.request_timeout
                                      + self.result_margin),
                       kind="rollout" if stream is None else "rollout_stream",
                       steps=steps, request_id=request_id, stream=stream)
        return self._enqueue(req)

    def submit_tiled(self, graph: dict,
                     request_id: Optional[str] = None,
                     stream: Optional[StreamSink] = None) -> ServeFuture:
        """Admit one GIANT scene for the tiled executor (serve/tiled.py) —
        the path for ``n_nodes`` above the ladder cap, so it bypasses the
        rung assignment entirely (``Bucket(0, 0)`` keys these requests into
        their own dispatch group). Resolves to the executor's result dict
        (prediction + tiling stats). Deadlines scale by
        ``serve.tiled.timeout_factor``: a tiled scene is tens of tile
        invocations, not one padded batch, and the queued-time deadline
        must admit sitting behind another giant scene.

        With ``stream`` (a :class:`StreamSink`), per-tile progress arrives
        on the sink as ``(layer, tile)`` chunks — or per-ROUND
        ``(layer, round)`` chunks when the executor runs device-parallel
        rounds (``serve.tiled.devices`` > 1, serve/mesh_tiled.py) — and a
        ``stream.cancel()`` stops the remaining compute at the next
        tile/round boundary (the streamed-rollout disconnect contract)."""
        if not self._started:
            raise RuntimeError("RequestQueue not started (use start() or a "
                               "with-block)")
        tiled = getattr(self.engine, "tiled", None)
        if tiled is None:
            raise RuntimeError("engine built without serve.tiled config; "
                               "giant scenes cannot be served")
        tiled.check_admit(int(graph["loc"].shape[0]))  # TiledOverflowError
        factor = max(float(tiled.timeout_factor), 1.0)
        now = time.perf_counter()
        req = _Request(graph, Bucket(0, 0),
                       deadline=now + self.request_timeout * factor,
                       hard_deadline=(now + self.request_timeout * factor
                                      + self.result_margin * factor),
                       kind="tiled", request_id=request_id, stream=stream)
        return self._enqueue(req)

    def _enqueue(self, req: _Request) -> ServeFuture:
        try:
            self._ingress.put_nowait(req)
        except _pyqueue.Full:
            self.metrics.rejected()
            raise QueueFullError(
                f"ingress queue full ({self._ingress.maxsize}); retry with "
                f"backoff or raise serve.queue_capacity") from None
        self.metrics.submitted()
        return req.future

    def depth(self) -> int:
        return self._ingress.qsize() + sum(len(v) for v in self._pending.values())

    # ---- chaos / supervision hooks ---------------------------------------
    def kill(self, reason: str = "killed") -> None:
        """Abruptly and permanently kill the dispatcher (chaos harness; also
        how the supervisor abandons a wedged replica). Every outstanding
        future fails with :class:`DispatcherCrashError` immediately — even if
        the dispatcher thread is stuck inside a device call — and the queue
        rejects further submits. No restart budget applies: a killed queue
        stays dead; the replica supervisor builds a fresh one."""
        self._kill_reason = str(reason)
        self._started = False
        self._fail_all(DispatcherCrashError(
            f"dispatcher killed: {self._kill_reason}"))
        # after the drain so _fail_all can't consume the wake-up marker
        try:
            self._ingress.put_nowait(_KILL)  # wake a blocked ingress.get
        except _pyqueue.Full:
            pass

    def wedge(self, duration_s: float) -> None:
        """Chaos: make the dispatcher sit without batch progress for
        ``duration_s`` — admitted requests pile up and ``last_progress``
        goes stale, exactly what a stuck device call looks like to the
        supervisor."""
        self._wedge_until = time.perf_counter() + float(duration_s)

    def inject_latency(self, seconds: float) -> None:
        """Chaos: add a fixed sleep before every batch execute (0 clears)."""
        self._inject_latency_s = max(float(seconds), 0.0)

    # ---- dispatcher ------------------------------------------------------
    def _run(self) -> None:
        """Thread target: _loop with crash containment. Engine errors are
        handled per-batch inside _execute; anything escaping _loop is a bug —
        restart the loop (pending state survives on the instance) with
        exponential backoff, budgeted over a sliding window (the budget
        replenishes after a healthy interval), then fail everything
        outstanding and mark the queue dead so submit() raises instead of
        hanging until timeout."""
        while True:
            try:
                self._loop()
                return  # clean exit (stop/drain)
            except _KilledError:
                self._die(DispatcherCrashError(
                    f"dispatcher killed: {self._kill_reason}"))
                return
            except Exception as exc:
                now = time.perf_counter()
                self._crash_times = [t for t in self._crash_times
                                     if now - t < _RESTART_WINDOW_S]
                self._crash_times.append(now)
                self._restarts += 1
                self.metrics.worker_restarted()
                burst = len(self._crash_times)
                if burst > _MAX_WORKER_RESTARTS:
                    obs.log(f"serve: dispatcher died permanently after "
                            f"{_MAX_WORKER_RESTARTS} restarts in "
                            f"{_RESTART_WINDOW_S:.0f} s: {exc!r}")
                    self._die(DispatcherCrashError(
                        f"serve dispatcher crashed: {exc!r}"))
                    return
                backoff = min(_RESTART_BACKOFF_BASE_S * (2 ** (burst - 1)),
                              _RESTART_BACKOFF_MAX_S)
                obs.log(f"serve: dispatcher crashed ({exc!r}); restart "
                        f"{burst}/{_MAX_WORKER_RESTARTS} in "
                        f"{backoff * 1e3:.0f} ms")
                time.sleep(backoff)

    def _die(self, exc: BaseException) -> None:
        self._fail_all(exc)
        self._started = False

    def _next_flush_deadline(self) -> Optional[float]:
        ts = [rs[0].t_submit + self.batch_deadline
              for rs in self._pending.values() if rs]
        return min(ts) if ts else None

    def _absorb(self, item) -> bool:
        """Move one ingress item into pending; returns True on _STOP."""
        if item is _KILL:
            raise _KilledError()
        if isinstance(item, tuple) and item[0] is _STOP:
            if not item[1]:  # drain=False: fail everything outstanding
                self._fail_all(RequestTimeoutError("server stopped"))
            return True
        self._pending.setdefault(item.key, []).append(item)
        return False

    def _loop(self) -> None:
        draining = False
        while True:
            if self._kill_reason is not None:
                raise _KilledError()
            now = time.perf_counter()
            if now < self._wedge_until:
                # chaos wedge: no absorption, no flush, no progress stamp —
                # depth grows while last_progress goes stale
                time.sleep(min(0.05, self._wedge_until - now))
                continue
            self.last_progress = now
            flush_at = self._next_flush_deadline()
            timeout = None if flush_at is None else max(flush_at - now, 0.0)
            if not draining:
                try:
                    item = self._ingress.get(timeout=timeout)
                except _pyqueue.Empty:
                    item = None
                # absorb everything already arrived in one pass (no sleep);
                # a _STOP flips to draining but this round still flushes
                while item is not None:
                    draining = self._absorb(item) or draining
                    try:
                        item = self._ingress.get_nowait()
                    except _pyqueue.Empty:
                        item = None
            else:
                while True:  # drain mode: empty the ingress, then flush all
                    try:
                        self._absorb(self._ingress.get_nowait())
                    except _pyqueue.Empty:
                        break
            self.metrics.set_queue_depth(self.depth())

            now = time.perf_counter()
            for key in list(self._pending):
                # a concurrent kill()'s _fail_all may clear pending under us:
                # tolerate vanished keys instead of crashing the loop (the
                # kill flag ends it at the next iteration)
                reqs = self._pending.get(key)
                if not reqs:
                    self._pending.pop(key, None)
                    continue
                self._expire(key, reqs, now)
                while len(reqs) >= self.engine.max_batch:
                    self._execute(key, reqs[: self.engine.max_batch])
                    del reqs[: self.engine.max_batch]
                if reqs and (draining or
                             now - reqs[0].t_submit >= self.batch_deadline):
                    self._execute(key, reqs)
                    reqs.clear()
                if not reqs:
                    self._pending.pop(key, None)
            self.metrics.set_queue_depth(self.depth())
            if draining and not self._pending and self._ingress.empty():
                return

    def _expire(self, key, reqs: List[_Request], now: float) -> None:
        alive = [r for r in reqs if r.deadline > now]
        for r in reqs:
            if r.deadline <= now:
                self.metrics.timed_out()
                exc = RequestTimeoutError(
                    f"request waited > {self.request_timeout * 1e3:.0f} ms "
                    f"in bucket {key[1]}")
                r.future.set_exception(exc)
                if r.stream is not None:
                    r.stream.fail(exc)
        reqs[:] = alive

    def _run_batch(self, key, reqs: List[_Request]) -> List:
        """One engine call for a coalesced micro-batch; dispatch on kind."""
        kind, bucket, _steps = key
        graphs = [r.graph for r in reqs]
        rids = _request_ids(reqs)
        if kind == "rollout_stream":
            return [self._run_stream(r) for r in reqs]
        if kind == "tiled":
            return [self._run_tiled(r) for r in reqs]
        if kind == "rollout":
            return self.engine.rollout_batch(graphs, request_ids=rids)
        return self.engine.predict_batch(graphs, bucket=bucket,
                                         request_ids=rids)

    def _run_stream(self, r: _Request) -> dict:
        """Execute ONE streamed rollout scene. Exceptions stay inside: a
        failed chunk fails the request's sink and future directly — a
        partially-emitted stream must never re-run through the solo-retry
        path (the client already consumed its prefix)."""
        sink = r.stream
        try:
            summary = self.engine.rollout_stream(r.graph, sink,
                                                 request_id=r.request_id)
        except Exception as exc:
            self.metrics.failed()
            sink.fail(exc)
            r.future.set_exception(exc)
            return {"error": repr(exc)}
        if summary.get("cancelled"):
            # client went away mid-stream: the remaining steps were skipped
            # at the chunk boundary — the freed-compute audit trail
            obs.event("serve/stream_cancelled",
                      request_id=r.request_id,
                      steps_done=summary["steps_done"],
                      steps_total=summary["steps_total"],
                      steps_skipped=(summary["steps_total"]
                                     - summary["steps_done"]))
        sink.finish(summary)
        return summary

    def _run_tiled(self, r: _Request) -> dict:
        """Execute ONE giant scene through the tiled executor. Same
        containment shape as :meth:`_run_stream`: failures resolve the
        request's sink and future directly and never reach the solo-retry
        path (a tiled request already IS solo, and its progress stream may
        have partially emitted)."""
        sink = r.stream
        progress = None
        if sink is not None:
            seq = [0]

            def progress(**info):
                if sink.cancelled:
                    return False        # client gone: stop at tile boundary
                sink.put_chunk(seq[0], info)
                seq[0] += 1
                return True

        try:
            out = self.engine.predict_tiled(r.graph,
                                            request_id=r.request_id,
                                            progress=progress)
        except Exception as exc:
            self.metrics.failed()
            if sink is not None:
                sink.fail(exc)
            r.future.set_exception(exc)
            return {"error": repr(exc)}
        if out.get("cancelled"):
            obs.event("serve/tiled_cancelled", request_id=r.request_id,
                      tiles=out["tiles"], layers=out["layers"])
        if sink is not None:
            sink.finish(out)
        return out

    def _execute(self, key, reqs: List[_Request]) -> None:
        kind, bucket, steps = key
        if self._inject_latency_s > 0:
            time.sleep(self._inject_latency_s)  # chaos: slow device
        t_start = time.perf_counter()
        try:
            outs = self._run_batch(key, reqs)
        except WorkerLostError as exc:
            # the executor itself is gone, not one bad graph: kill the queue
            # (futures fail typed, the replica layer claims them for
            # failover) and let the dispatcher die at its kill check
            self.kill(reason=str(exc))
            raise _KilledError() from None
        except Exception:
            # one bad graph fails the whole padded batch — retry each request
            # ALONE once, so a poison graph only takes down itself
            self._retry_individually(key, reqs)
            return
        now = time.perf_counter()
        self.last_progress = now  # batch progress heartbeat for the supervisor
        lats = [(now - r.t_submit) * 1e3 for r in reqs]
        qms = [(t_start - r.t_submit) * 1e3 for r in reqs]
        self.metrics.batch_done(len(reqs), self.engine.max_batch, lats, qms)
        obs.event("serve/batch", n=bucket.n, e=bucket.e, filled=len(reqs),
                  capacity=self.engine.max_batch, workload=kind,
                  dur_s=round(now - t_start, 6),
                  request_ids=_request_ids(reqs),
                  queue_ms=[round(q, 3) for q in qms])
        compute_ms = round((now - t_start) * 1e3, 3)
        for r, out, q_ms in zip(reqs, outs, qms):
            r.future.meta.update(queue_ms=round(q_ms, 3),
                                 compute_ms=compute_ms,
                                 batch_filled=len(reqs),
                                 bucket_n=bucket.n, bucket_e=bucket.e,
                                 request_id=r.request_id)
            r.future.set_result(out)

    def _retry_individually(self, key, reqs: List[_Request]) -> None:
        kind, bucket, _steps = key
        self.metrics.retried(len(reqs))
        for r in reqs:
            t_start = time.perf_counter()
            try:
                out = self._run_batch(key, [r])[0]
            except WorkerLostError as exc:
                self.kill(reason=str(exc))
                raise _KilledError() from None
            except Exception as solo_exc:  # fails even alone: the poison graph
                self.metrics.poison()
                self.metrics.failed()
                r.future.set_exception(solo_exc)
                continue
            now = time.perf_counter()
            q_ms = (t_start - r.t_submit) * 1e3
            self.metrics.batch_done(1, self.engine.max_batch,
                                    [(now - r.t_submit) * 1e3], [q_ms])
            obs.event("serve/batch", n=bucket.n, e=bucket.e, filled=1,
                      capacity=self.engine.max_batch, workload=kind,
                      dur_s=round(now - t_start, 6), retry=True,
                      request_ids=_request_ids([r]),
                      queue_ms=[round(q_ms, 3)])
            r.future.meta.update(
                queue_ms=round(q_ms, 3),
                compute_ms=round((now - t_start) * 1e3, 3),
                batch_filled=1, bucket_n=bucket.n, bucket_e=bucket.e,
                request_id=r.request_id)
            r.future.set_result(out)

    def _fail_all(self, exc: BaseException) -> None:
        # list() copies: kill() calls this from a foreign thread while the
        # dispatcher may still be mutating _pending; futures are first-wins
        # so double resolution is harmless
        for reqs in list(self._pending.values()):
            for r in list(reqs):
                r.future.set_exception(exc)
                if r.stream is not None:
                    r.stream.fail(exc)
        self._pending.clear()
        while True:
            try:
                item = self._ingress.get_nowait()
            except _pyqueue.Empty:
                return
            if item is _KILL:
                continue
            if not (isinstance(item, tuple) and item[0] is _STOP):
                item.future.set_exception(exc)
                if item.stream is not None:
                    item.stream.fail(exc)
