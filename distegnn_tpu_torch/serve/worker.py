"""Out-of-process serving worker — IPC child + parent-side handle (port of
``distegnn_tpu/serve/worker.py``).

``serve.workers: process`` moves each replica's engine out of the gateway
process: a crashed device call, an OOM kill, or a GIL-holding wedge takes
down ONE child, not the fleet, and each child's dispatcher runs under its
own interpreter lock. This module is both halves of that boundary:

  - **child** (``python -m distegnn_tpu_torch.serve.worker --fd N``): builds
    its own engine from the model config — the registry's deterministic
    recipe via :func:`distegnn_tpu_torch.serve.engine_with_params_from_config`
    on the device the init message names (the card unless the caller asked
    for the CPU; a child that finds no card fails its spawn, it never
    serves on the CPU instead), so params are bitwise-identical to the
    parent's — and serves predict / rollout / warmup / swap ops over the
    inherited socket. Outputs reach the host in the child: frames carry
    numpy arrays, never CUDA tensors. A heartbeat thread beats every
    ``heartbeat_s`` (torch releases the GIL while it waits on the card, so
    a running kernel does not stop it) and doubles as the parent-death
    watchdog (``getppid`` flip or a dead pipe → ``os._exit``; no orphans).
  - **parent** (:class:`WorkerHandle`): spawns the child as a fresh
    interpreter (``subprocess.Popen`` of ``sys.executable -m``: fork + exec,
    so no CUDA state of the parent is inherited), speaks the framed
    protocol with per-message deadlines, tracks heartbeat age for the
    supervisor's staleness check, and escalates SIGTERM → SIGKILL with
    zombie reaping on ``terminate()``.

The child's kernels load from ``distegnn_tpu_torch/_build/`` through
``ops/build.py``'s cross-process lock: children never run ``nvcc`` at the
same moment, and one that finds a library already built only loads it.

Framing: ``!2sBIII`` header (magic ``DW``, frame kind, sequence number,
payload length, CRC32) + a pickled payload. Every failure mode is a typed
error — :class:`FrameError` (corruption), :class:`WorkerClosedError` (dead
pipe / EOF), :class:`WorkerTimeoutError` (deadline), :class:`WorkerSpawnError`
(exec/handshake/digest failure) — never a hang: a caller blocked on a dead
child is released by the reader thread failing its pending slot.

Module-level imports are STDLIB ONLY (``tests/test_torch_worker.py``
checks, and checks a child's ``sys.modules``): the child must stay a thin
engine host, so transport/registry/supervisor code can never ride into the
isolated process.
"""

from __future__ import annotations

import argparse
import atexit
import os
import pickle
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import zlib
from typing import Any, Dict, List, Optional

_MAGIC = b"DW"
_HEADER = struct.Struct("!2sBIII")  # magic, kind, seq, length, crc32
FRAME_REQUEST = 1
FRAME_RESPONSE = 2
FRAME_HEARTBEAT = 3


class WorkerError(RuntimeError):
    """Base of every typed worker-IPC failure."""


class FrameError(WorkerError):
    """Corrupt framing: bad magic or a checksum mismatch. The channel is
    unusable after this — the reader marks the worker lost."""


class WorkerClosedError(WorkerError):
    """The IPC channel is dead (EOF, reset, or the worker was reaped)."""


class WorkerTimeoutError(WorkerError):
    """A framed call exceeded its per-message deadline. The child may still
    be computing — the caller decides whether to kill it."""


class WorkerSpawnError(WorkerError):
    """The child failed to exec, initialize, or match the parent's params
    digest. The replica layer degrades to an in-process queue on this."""


class WorkerRemoteError(WorkerError):
    """The child executed the op but raised an exception the parent has no
    richer type for; carries the remote type name + message."""


# ---- framing ----------------------------------------------------------------

def send_frame(sock: socket.socket, lock: threading.Lock, kind: int,
               seq: int, obj: Any) -> None:
    """Serialize + frame + send one message under the channel write lock
    (the child's heartbeat thread and op loop share one socket)."""
    payload = pickle.dumps(obj, protocol=4)
    header = _HEADER.pack(_MAGIC, kind, seq, len(payload),
                          zlib.crc32(payload) & 0xFFFFFFFF)
    try:
        with lock:
            sock.sendall(header + payload)
    except OSError as exc:
        raise WorkerClosedError(f"worker channel write failed: {exc}") from None


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float]) -> bytes:
    chunks: List[bytes] = []
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise WorkerTimeoutError("worker channel read deadline passed")
            sock.settimeout(remaining)
        else:
            sock.settimeout(None)
        try:
            chunk = sock.recv(n - got)
        except socket.timeout:
            raise WorkerTimeoutError(
                "worker channel read deadline passed") from None
        except OSError as exc:
            raise WorkerClosedError(
                f"worker channel read failed: {exc}") from None
        if not chunk:
            raise WorkerClosedError("worker channel closed (EOF)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket,
               deadline: Optional[float] = None) -> tuple:
    """Read one frame; returns (kind, seq, payload object). ``deadline`` is
    absolute ``time.monotonic()`` seconds (None = block forever — the
    parent's dedicated reader thread relies on EOF instead)."""
    header = _recv_exact(sock, _HEADER.size, deadline)
    magic, kind, seq, length, crc = _HEADER.unpack(header)
    if magic != _MAGIC:
        raise FrameError(f"bad frame magic {magic!r}")
    payload = _recv_exact(sock, length, deadline)
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise FrameError(f"frame checksum mismatch (seq {seq})")
    return kind, seq, pickle.loads(payload)


def current_precision() -> Dict[str, Any]:
    """The parent's float32 matmul settings (``torch.
    get_float32_matmul_precision`` and the TF32 flags), forwarded to the
    child at init so cross-process predictions stay bitwise-identical."""
    import torch

    return {"float32_matmul_precision":
            torch.get_float32_matmul_precision(),
            "matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32)}


def _apply_precision(prec: Optional[Dict[str, Any]]) -> None:
    if not prec:
        return
    import torch

    torch.set_float32_matmul_precision(
        str(prec.get("float32_matmul_precision", "highest")))
    torch.backends.cuda.matmul.allow_tf32 = bool(
        prec.get("matmul_allow_tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(prec.get("cudnn_allow_tf32",
                                                    False))


def _obs_event(name: str, **attrs) -> None:
    """Best-effort obs event (lazy import keeps module-level stdlib-only)."""
    try:
        from distegnn_tpu_torch import obs

        obs.event(name, **attrs)
    except Exception:
        pass


# ---- parent side ------------------------------------------------------------

_LIVE: "set[WorkerHandle]" = set()
_LIVE_LOCK = threading.Lock()


def reap_live_workers(join_timeout_s: float = 10.0) -> int:
    """Terminate (SIGTERM → SIGKILL) every worker this process still holds a
    live handle to; bounded overall by ``join_timeout_s``. The test-suite
    orphan reaper and the atexit sweep both call this — no child survives
    its parent. Returns how many handles were reaped."""
    deadline = time.monotonic() + max(float(join_timeout_s), 0.1)
    with _LIVE_LOCK:
        handles = list(_LIVE)
    for h in handles:
        h.terminate(grace_s=max(min(0.5, deadline - time.monotonic()), 0.05))
    return len(handles)


@atexit.register
def _reap_at_exit() -> None:
    try:
        reap_live_workers(join_timeout_s=5.0)
    except Exception:
        pass


class WorkerHandle:
    """Parent-side handle to one worker child: spawn, framed calls with
    deadlines, heartbeat-age tracking, and SIGTERM→SIGKILL teardown.

    A dedicated reader thread owns every read on the channel: responses are
    routed to their callers by sequence number, heartbeats refresh
    ``heartbeat_age()``, and EOF/corruption fails every pending call with
    :class:`WorkerClosedError` — a dead child never strands a caller.
    """

    def __init__(self, proc: subprocess.Popen, sock: socket.socket,
                 model: str, idx: int, log_path: Optional[str],
                 kill_grace_s: float, log_file=None):
        self.proc = proc
        self.pid = proc.pid
        self.model = model
        self.idx = idx
        self.log_path = log_path
        self.kill_grace_s = float(kill_grace_s)
        self.ready: Dict[str, Any] = {}
        self.spawn_s: Optional[float] = None   # exec to init reply
        self.checkpoint: Optional[str] = None  # set by spawn()
        self._sock = sock
        self._log_file = log_file
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        self._pending: Dict[int, list] = {}  # seq -> [Event, response|None]
        self._seq = 0
        self._lost: Optional[str] = None
        self._closed = False
        # terminate() is serialized: the supervisor's kill and a dispatcher's
        # WorkerLostError path can race it, and the thread that escalated to
        # SIGKILL must be the one whose story the worker_exit event tells
        self._term_lock = threading.Lock()
        self._escalated = False
        self._last_frame = time.monotonic()
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"worker-io-{model}-{idx}")
        self._reader.start()

    # ---- spawn -----------------------------------------------------------
    @classmethod
    def spawn(cls, cfg_dict: dict, model: str, idx: int, *,
              checkpoint: Optional[str] = None,
              warm_sizes: Optional[List] = None,
              obs_dir: Optional[str] = None,
              spawn_timeout_s: float = 120.0,
              heartbeat_s: float = 0.5,
              kill_grace_s: float = 3.0,
              expect_digest: Optional[str] = None,
              precision: Optional[Dict[str, Any]] = None,
              device: str = "cuda") -> "WorkerHandle":
        """Launch ``python -m distegnn_tpu_torch.serve.worker`` over a
        socketpair and run the init handshake (config + checkpoint + warm
        sizes + device + precision) within ``spawn_timeout_s``. Child
        stderr/stdout land in ``<obs_dir>/worker_<model>_<idx>.log`` (a
        tempdir when tracing is off). Any exec/handshake failure — a child
        without the card it was sent to, or a params-digest mismatch
        against ``expect_digest``, which would silently break cross-process
        parity — tears the child down and raises :class:`WorkerSpawnError`.
        """
        t_spawn = time.perf_counter()
        parent_sock, child_sock = socket.socketpair()
        log_dir = obs_dir or os.path.join(tempfile.gettempdir(),
                                          "distegnn_tpu_torch_workers")
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, f"worker_{model}_{idx}.log")
        log_f = open(log_path, "ab")
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_root)
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "distegnn_tpu_torch.serve.worker",
                 "--fd", str(child_sock.fileno())],
                pass_fds=(child_sock.fileno(),),
                stdin=subprocess.DEVNULL, stdout=log_f,
                stderr=subprocess.STDOUT, env=env, close_fds=True)
        except Exception as exc:
            parent_sock.close()
            child_sock.close()
            log_f.close()
            raise WorkerSpawnError(
                f"failed to exec worker {model}/{idx}: {exc}") from exc
        child_sock.close()
        handle = cls(proc, parent_sock, model, idx, log_path, kill_grace_s,
                     log_file=log_f)
        init = {"config": cfg_dict, "model": model, "idx": idx,
                "heartbeat_s": float(heartbeat_s),
                "checkpoint": checkpoint,
                "warm_sizes": [list(s) for s in (warm_sizes or [])],
                "precision": dict(precision or {}),
                "device": str(device),
                "obs": {"dir": obs_dir} if obs_dir else {}}
        try:
            ready = handle.call("init", init, timeout_s=spawn_timeout_s)
        except WorkerError as exc:
            handle.terminate(grace_s=0.5)
            raise WorkerSpawnError(
                f"worker {model}/{idx} failed to initialize: {exc} "
                f"(child log: {log_path})") from exc
        if expect_digest and ready.get("params_digest") != expect_digest:
            handle.terminate(grace_s=0.5)
            raise WorkerSpawnError(
                f"worker {model}/{idx} params digest "
                f"{ready.get('params_digest')} != parent {expect_digest} — "
                f"non-deterministic init or env drift would break parity")
        handle.ready = dict(ready or {})
        handle.spawn_s = time.perf_counter() - t_spawn
        # which version this child came up on — WorkerReplica.start_queue
        # compares it against current_checkpoint to catch a hot-swap that
        # deferred WHILE this spawn was in flight (the child captured the
        # pre-swap checkpoint seconds ago)
        handle.checkpoint = checkpoint
        with _LIVE_LOCK:
            _LIVE.add(handle)
        _obs_event("gateway/worker_spawn", model=model, replica=idx,
                   pid=handle.pid, params_digest=ready.get("params_digest"),
                   warmed=ready.get("warmed"), device=ready.get("device"),
                   device_name=ready.get("device_name"),
                   spawn_s=round(handle.spawn_s, 6),
                   init_s=ready.get("init_s"))
        return handle

    # ---- channel ---------------------------------------------------------
    def _read_loop(self) -> None:
        try:
            while True:
                kind, seq, obj = recv_frame(self._sock, None)
                self._last_frame = time.monotonic()
                if kind == FRAME_RESPONSE:
                    with self._plock:
                        slot = self._pending.pop(seq, None)
                    if slot is not None:
                        slot[1] = obj
                        slot[0].set()
                # FRAME_HEARTBEAT only refreshes _last_frame
        except WorkerError as exc:
            self._mark_lost(str(exc))

    def _mark_lost(self, reason: str) -> None:
        if self._lost is None:
            self._lost = reason
        with self._plock:
            pending, self._pending = self._pending, {}
        for slot in pending.values():
            slot[0].set()  # slot[1] stays None -> WorkerClosedError

    @property
    def lost_reason(self) -> Optional[str]:
        return self._lost

    def call(self, op: str, payload: Optional[dict] = None,
             timeout_s: float = 60.0):
        """One framed request/response round-trip with a hard deadline.
        Raises :class:`WorkerClosedError` (dead channel),
        :class:`WorkerTimeoutError` (deadline), or the remote error mapped
        back to its serve type when the child executed but failed."""
        if self._lost is not None:
            raise WorkerClosedError(
                f"worker {self.model}/{self.idx} (pid {self.pid}) channel "
                f"lost: {self._lost}")
        with self._plock:
            self._seq += 1
            seq = self._seq
            slot = [threading.Event(), None]
            self._pending[seq] = slot
        msg = {"op": op}
        if payload:
            msg.update(payload)
        try:
            send_frame(self._sock, self._wlock, FRAME_REQUEST, seq, msg)
        except WorkerError as exc:
            with self._plock:
                self._pending.pop(seq, None)
            self._mark_lost(str(exc))
            raise WorkerClosedError(
                f"worker {self.model}/{self.idx} (pid {self.pid}) channel "
                f"lost: {exc}") from None
        if not slot[0].wait(max(float(timeout_s), 0.001)):
            with self._plock:
                self._pending.pop(seq, None)
            raise WorkerTimeoutError(
                f"worker {self.model}/{self.idx} (pid {self.pid}) op "
                f"{op!r} exceeded its {float(timeout_s):.1f} s deadline")
        resp = slot[1]
        if resp is None:
            raise WorkerClosedError(
                f"worker {self.model}/{self.idx} (pid {self.pid}) channel "
                f"lost: {self._lost}")
        if not resp.get("ok"):
            raise self._remote_error(op, resp)
        return resp.get("result")

    def _remote_error(self, op: str, resp: dict) -> Exception:
        etype = str(resp.get("etype", "Exception"))
        emsg = str(resp.get("error", ""))
        known: Dict[str, type] = {"ValueError": ValueError}
        try:
            from distegnn_tpu_torch.serve import buckets as _bk
            from distegnn_tpu_torch.serve import engine as _eng

            known.update({
                "RolloutOverflowError": _eng.RolloutOverflowError,
                "MixedRolloutStepsError": _eng.MixedRolloutStepsError,
                "CanaryError": _eng.CanaryError,
                "BucketOverflowError": _bk.BucketOverflowError,
            })
        except Exception:
            pass
        cls = known.get(etype)
        prefix = f"worker {self.model}/{self.idx} op {op!r}: "
        if cls is not None:
            return cls(prefix + emsg)
        return WorkerRemoteError(prefix + f"{etype}: {emsg}")

    # ---- liveness --------------------------------------------------------
    def proc_alive(self) -> bool:
        return self.proc.poll() is None

    def heartbeat_age(self) -> float:
        """Seconds since the LAST frame of any kind arrived. A SIGSTOPped
        (or truly GIL-wedged) child stops beating; the supervisor reads this
        through WorkerQueue.heartbeat_age for staleness-based wedge
        detection."""
        return time.monotonic() - self._last_frame

    # ---- chaos (testing/serve_faults.py) ---------------------------------
    def kill9(self) -> None:
        """SIGKILL the child outright — the crash the isolation exists for."""
        try:
            os.kill(self.pid, signal.SIGKILL)
        except OSError:
            pass

    def sigstop(self) -> None:
        """SIGSTOP the child: heartbeats stop, the process stays alive — a
        true wedge only staleness detection can see."""
        try:
            os.kill(self.pid, signal.SIGSTOP)
        except OSError:
            pass

    def sigcont(self) -> None:
        try:
            os.kill(self.pid, signal.SIGCONT)
        except OSError:
            pass

    # ---- teardown --------------------------------------------------------
    def terminate(self, grace_s: Optional[float] = None) -> Optional[int]:
        """SIGTERM → bounded wait → SIGKILL → reap. Idempotent; always reaps
        the zombie (``proc.wait``) and closes the channel + log file.
        SIGKILL also takes down SIGSTOPped children (pending SIGTERM never
        delivers to a stopped process). Returns the child's returncode."""
        grace = self.kill_grace_s if grace_s is None else float(grace_s)
        with self._term_lock:
            if self.proc.poll() is None:
                try:
                    self.proc.terminate()
                except OSError:
                    pass
                try:
                    self.proc.wait(timeout=max(grace, 0.05))
                except subprocess.TimeoutExpired:
                    self._escalated = True
                    try:
                        self.proc.kill()
                    except OSError:
                        pass
                    try:
                        self.proc.wait(timeout=10.0)
                    except subprocess.TimeoutExpired:
                        pass
            else:
                try:
                    self.proc.wait(timeout=0.1)  # reap the zombie
                except subprocess.TimeoutExpired:
                    pass
            self._mark_lost("terminated")
            first = not self._closed
            self._closed = True
            if first:
                try:
                    self._sock.close()
                except OSError:
                    pass
                if self._log_file is not None:
                    try:
                        self._log_file.close()
                    except OSError:
                        pass
                with _LIVE_LOCK:
                    _LIVE.discard(self)
                _obs_event("gateway/worker_exit", model=self.model,
                           replica=self.idx, pid=self.pid,
                           returncode=self.proc.returncode,
                           escalated=self._escalated)
        return self.proc.returncode


# ---- child side -------------------------------------------------------------

def _device_stats(engine) -> Dict[str, Any]:
    """The child's device and its kernels' launch counts since spawn
    (``stats``): what a caller reads to see that the child ran on the card
    and through the kernels."""
    import torch

    dev = engine.device
    out: Dict[str, Any] = {
        "pid": os.getpid(), "device": str(dev),
        "params_digest": engine.params_digest(),
        # what rode into this process: the isolation check reads it
        "modules": sorted(m for m in sys.modules
                          if m.split(".")[0] in ("distegnn_tpu",
                                                 "distegnn_tpu_torch",
                                                 "jax", "flax"))}
    if dev.type == "cuda":
        out.update(
            device_name=torch.cuda.get_device_name(dev),
            memory_allocated=int(torch.cuda.memory_allocated(dev)),
            max_memory_allocated=int(torch.cuda.max_memory_allocated(dev)),
            memory_reserved=int(torch.cuda.memory_reserved(dev)))
    ep = sys.modules.get("distegnn_tpu_torch.ops.edge_pipeline")
    if ep is not None:
        f = ep.fused_edge_layer
        out["launches"] = {"fused_edge_fwd": int(f.launches),
                           "fused_edge_fwd_f32": int(f.f32_launches),
                           "fused_edge_fwd_tc": int(f.tc_launches)}
    return out


def _child_dispatch(engine, op: str, msg: dict, state: dict):
    if op == "ping":
        return {"pid": os.getpid()}
    if op == "stats":
        return _device_stats(engine)
    if op == "predict":
        from distegnn_tpu_torch.serve.buckets import Bucket

        b = msg.get("bucket")
        return engine.predict_batch(
            msg["graphs"], bucket=Bucket(*b) if b else None,
            request_ids=msg.get("request_ids") or None)
    if op == "rollout":
        return engine.rollout_batch(
            msg["scenes"], request_ids=msg.get("request_ids") or None)
    if op == "warmup":
        warmed = engine.warmup([tuple(s) for s in msg.get("sizes") or []])
        return [[b.n, b.e] for b in warmed]
    if op == "swap":
        # blue/green unit, child side: verified load into a copy of the
        # live module, canary on the warmed rungs, then the flip; the
        # pre-swap params stay held for swap_rollback. No checkpoint means
        # the config's seeded params (a version no file holds)
        import copy

        from distegnn_tpu_torch.serve import engine_with_params_from_config
        from distegnn_tpu_torch.serve.buckets import Bucket
        from distegnn_tpu_torch.train.checkpoint import load_params

        if msg.get("checkpoint") is None:
            new_params = engine_with_params_from_config(
                state["config"], device="cpu", checkpoint="")[0].state_dict()
        else:
            new_params = load_params(str(msg["checkpoint"]), copy.deepcopy(
                engine.model)).state_dict()
        rungs = [Bucket(*r) for r in msg.get("rungs") or []]
        checked = engine.canary(new_params, rungs)
        state["prev_params"] = engine.params
        engine.params = new_params
        return {"rungs": checked, "params_digest": engine.params_digest()}
    if op == "swap_rollback":
        prev = state.pop("prev_params", None)
        if prev is not None:
            engine.params = prev
        return {"params_digest": engine.params_digest(),
                "rolled_back": prev is not None}
    if op == "shutdown":
        # the exit record lands before the reply: the parent's SIGTERM
        # follows the reply at once
        _child_exit_record(engine, state)
        return {"pid": os.getpid()}
    raise ValueError(f"unknown worker op {op!r}")


def _child_exit_record(engine, state: dict) -> None:
    """Once per child: its totals (device, memory, kernel launches) into
    its own event stream, flushed — what a caller reads after the drain."""
    if state.get("exit_recorded"):
        return
    state["exit_recorded"] = True
    try:
        _obs_event("worker/exit", model=state.get("model"),
                   replica=state.get("idx"), **_device_stats(engine))
        from distegnn_tpu_torch import obs

        obs.flush()
    except Exception:
        pass


def _child_serve(sock: socket.socket) -> int:
    parent_pid = os.getppid()
    wlock = threading.Lock()
    # the parent-controlled drain governs shutdown: a Ctrl-C delivered to
    # the whole process group must not race it, and SIGTERM (the parent's
    # escalation step 1) exits cleanly so obs buffers flush
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))

    # The parent-death watchdog starts BEFORE the init handshake: the init
    # window (torch import, CUDA context, engine build) takes seconds, and a
    # parent that dies during it must still take the child down promptly —
    # "no orphans" cannot wait for the init recv deadline to expire. The
    # same thread upgrades to the heartbeat sender once init completes.
    stop_beat = threading.Event()
    beat = {"interval_s": 0.5, "send": False}

    def _beat() -> None:
        while not stop_beat.wait(beat["interval_s"]):
            if os.getppid() != parent_pid:
                os._exit(3)  # parent died: never orphan
            if beat["send"]:
                try:
                    send_frame(sock, wlock, FRAME_HEARTBEAT, 0,
                               {"ts": time.time()})
                except Exception:
                    os._exit(3)

    threading.Thread(target=_beat, daemon=True,
                     name="worker-heartbeat").start()

    kind, seq, init = recv_frame(sock, deadline=time.monotonic() + 300.0)
    if kind != FRAME_REQUEST or init.get("op") != "init":
        sys.stderr.write(f"worker: expected init frame, got {init!r}\n")
        return 1
    model_name = str(init.get("model", "default"))
    idx = int(init.get("idx", 0))
    heartbeat_s = max(float(init.get("heartbeat_s", 0.5)), 0.01)
    state: dict = {"model": model_name, "idx": idx}

    try:
        t_init = time.perf_counter()
        _apply_precision(init.get("precision"))
        obs_cfg = init.get("obs") or {}
        if obs_cfg.get("dir"):
            from distegnn_tpu_torch.obs import trace as _trace

            _trace.configure(
                log_dir=obs_cfg["dir"], enable=True,
                filename=f"events_worker_{model_name}_{idx}.jsonl",
                tags={"worker": f"{model_name}/{idx}"})
        from distegnn_tpu_torch.config import ConfigDict
        from distegnn_tpu_torch.serve import engine_with_params_from_config

        cfg = ConfigDict(init["config"])
        state["config"] = cfg
        # resolve_device raises on a CUDA device without a card: the spawn
        # fails typed, the child never serves on the CPU in its place
        _model, engine = engine_with_params_from_config(
            cfg, device=str(init.get("device") or "cuda"),
            checkpoint=init.get("checkpoint"))
        warm_sizes = [tuple(s) for s in init.get("warm_sizes") or []]
        warmed = engine.warmup(warm_sizes) if warm_sizes else []
        ready = _device_stats(engine)
        ready.update(params_digest=engine.params_digest(),
                     warmed=[[b.n, b.e] for b in warmed],
                     init_s=round(time.perf_counter() - t_init, 6))
        send_frame(sock, wlock, FRAME_RESPONSE, seq,
                   {"ok": True, "result": ready})
    except Exception as exc:
        sys.stderr.write("worker: init failed\n" + traceback.format_exc())
        try:
            send_frame(sock, wlock, FRAME_RESPONSE, seq,
                       {"ok": False, "etype": type(exc).__name__,
                        "error": str(exc)[:2000]})
        except WorkerError:
            pass
        return 1

    beat["interval_s"] = heartbeat_s
    beat["send"] = True

    try:
        while True:
            try:
                kind, seq, msg = recv_frame(sock, None)
            except WorkerClosedError:
                return 0  # parent closed the channel: clean exit
            if kind != FRAME_REQUEST:
                continue
            op = str(msg.get("op"))
            try:
                result = _child_dispatch(engine, op, msg, state)
                send_frame(sock, wlock, FRAME_RESPONSE, seq,
                           {"ok": True, "result": result})
            except Exception as exc:
                sys.stderr.write(f"worker: op {op!r} failed\n"
                                 + traceback.format_exc())
                try:
                    send_frame(sock, wlock, FRAME_RESPONSE, seq,
                               {"ok": False, "etype": type(exc).__name__,
                                "error": str(exc)[:2000]})
                except WorkerError:
                    return 1
            if op == "shutdown":
                return 0
    finally:
        stop_beat.set()
        _child_exit_record(engine, state)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="distegnn_tpu_torch.serve.worker",
        description="Serving worker child (spawned by WorkerHandle; not a "
                    "user-facing entry point)")
    parser.add_argument("--fd", type=int, required=True,
                        help="inherited socketpair fd (the IPC channel)")
    args = parser.parse_args(argv)
    sock = socket.socket(fileno=args.fd)
    return _child_serve(sock)


if __name__ == "__main__":
    sys.exit(main())
