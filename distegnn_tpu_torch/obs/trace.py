"""Structured tracing: spans and events into buffered JSONL (port of
``distegnn_tpu/obs/trace.py``).

One process-global :class:`Tracer` (swapped by :func:`configure`) serves
the trainer, the loaders and the checkpoint code. Until a run configures a
sink, and always under ``obs.enable: false``, every call is a no-op:
``span()`` returns a shared null context manager and ``event()`` returns at
once, so the hooks stay in the hot paths unconditionally.

Record layout (the JAX package's): one JSON object per line,
  {"ts": <unix seconds>, "kind": "span"|"event"|"log", "name": str,
   "proc": <rank>, "host": <hostname>, ["dur_s": float], ...attrs}

Writing is buffered (``buffer_events`` lines or ``flush_interval_s``
seconds, whichever comes first) behind one lock and appended to
``<dir>/events.jsonl``. Only rank 0 writes by default; ``per_host`` gives
every rank its own ``events_p<rank>.jsonl``. The rank is
``torch.distributed``'s where a process group is initialised, else 0.

``log()`` prints the message (with a ``[p<rank>] `` prefix on ranks > 0),
flushed, and mirrors it into the stream as a ``log`` record.
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import threading
import time
from typing import Any, Dict, Optional


def _process_index() -> int:
    """This process's rank in an initialised ``torch.distributed`` group,
    else 0."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


class EventWriter:
    """Thread-safe buffered JSONL appender, flushed by size or by time."""

    def __init__(self, path: str, buffer_events: int = 256,
                 flush_interval_s: float = 2.0):
        self.path = path
        self.buffer_events = max(int(buffer_events), 1)
        self.flush_interval_s = float(flush_interval_s)
        # reentrant: the preemption guard's signal handler logs from the
        # main thread, which the signal may interrupt inside write()
        self._lock = threading.RLock()
        self._buf: list = []
        self._last_flush = time.monotonic()
        self._closed = False
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # truncate: one writer per run directory; a run that reuses the
        # directory must not interleave with old events
        with open(path, "w"):
            pass
        # every writer flushes at interpreter exit, not only the one the
        # global tracer holds
        atexit.register(self.close)

    def write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, separators=(",", ":"), default=repr)
        with self._lock:
            if self._closed:
                return
            self._buf.append(line)
            if (len(self._buf) >= self.buffer_events
                    or time.monotonic() - self._last_flush
                    >= self.flush_interval_s):
                self._flush_locked()

    def _flush_locked(self) -> None:
        if self._buf:
            with open(self.path, "a") as f:
                f.write("\n".join(self._buf) + "\n")
            self._buf.clear()
        self._last_flush = time.monotonic()

    def flush(self) -> None:
        with self._lock:
            if not self._closed:
                self._flush_locked()

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._flush_locked()
                self._closed = True
        atexit.unregister(self.close)


class _NullSpan:
    """The shared no-op context manager of a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """Times a with-block and writes one ``span`` record at its exit;
    ``set(**attrs)`` adds attributes on the way."""

    __slots__ = ("_tracer", "name", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "_Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._emit("span", self.name, dur_s=round(dur, 6),
                           **self.attrs)
        return False


class Tracer:
    """Span / event / log emitter over an optional :class:`EventWriter`."""

    def __init__(self, writer: Optional[EventWriter] = None,
                 tags: Optional[Dict[str, Any]] = None,
                 process_index: int = 0):
        self.writer = writer
        self.tags = dict(tags or {})
        self.process_index = int(process_index)

    @property
    def enabled(self) -> bool:
        return self.writer is not None

    def _emit(self, kind: str, name: str, **attrs) -> None:
        w = self.writer
        if w is None:
            return
        rec = {"ts": round(time.time(), 6), "kind": kind, "name": name}
        rec.update(self.tags)
        rec.update(attrs)
        w.write(rec)

    def span(self, name: str, **attrs):
        """A context manager timing a block; a no-op without a sink."""
        if self.writer is None:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        self._emit("event", name, **attrs)

    def log(self, msg: str, **attrs) -> None:
        """Print ``msg`` (prefixed ``[p<rank>] `` on ranks > 0), flushed,
        and mirror it into the stream."""
        prefix = f"[p{self.process_index}] " if self.process_index else ""
        print(prefix + msg, flush=True)  # noqa: obs-print (the logger itself)
        self._emit("log", "log", msg=msg, **attrs)

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


# ---- the process-global tracer ---------------------------------------------

_tracer = Tracer()          # disabled until configure() runs
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    return _tracer


def configure(log_dir: Optional[str] = None, enable: bool = True,
              per_host: bool = False, buffer_events: int = 256,
              flush_interval_s: float = 2.0,
              tags: Optional[Dict[str, Any]] = None,
              filename: Optional[str] = None) -> Tracer:
    """(Re)bind the global tracer.

    ``enable=False`` or ``log_dir=None`` installs a sinkless tracer: spans
    and events are no-ops and no file is created; ``log()`` still prints.
    Rank 0 writes ``<log_dir>/events.jsonl``; with ``per_host`` every rank
    writes ``<log_dir>/events_p<rank>.jsonl``; ``filename`` names the file
    instead (a serving worker child's ``events_worker_<model>_<idx>.jsonl``
    beside its gateway's stream). Every record is tagged ``proc``/``host``
    (and ``tags``)."""
    global _tracer
    pidx = _process_index()
    writer = None
    if enable and log_dir is not None and (per_host or pidx == 0):
        name = filename or (f"events_p{pidx}.jsonl" if per_host
                            else "events.jsonl")
        writer = EventWriter(os.path.join(log_dir, name),
                             buffer_events=buffer_events,
                             flush_interval_s=flush_interval_s)
    all_tags = {"proc": pidx, "host": socket.gethostname()}
    all_tags.update(tags or {})
    with _tracer_lock:
        old, _tracer = _tracer, Tracer(writer, tags=all_tags,
                                       process_index=pidx)
        old.close()
    return _tracer


def configure_from_config(config, exp_dir: str, enabled_here: bool = True,
                          tags: Optional[Dict[str, Any]] = None) -> Tracer:
    """Bind the tracer from a run config's ``obs`` section (an absent
    section means its defaults: on) under ``<exp_dir>/obs``.
    ``enabled_here=False`` keeps this invocation sinkless."""
    o = config.get("obs") if hasattr(config, "get") else None

    def get(k, d):
        return o.get(k, d) if o is not None else d

    enable = bool(get("enable", True)) and enabled_here
    return configure(
        log_dir=os.path.join(exp_dir, "obs") if enable else None,
        enable=enable,
        per_host=bool(get("per_host", False)),
        buffer_events=int(get("buffer_events", 256)),
        flush_interval_s=float(get("flush_interval_s", 2.0)),
        tags=tags)


# module-level conveniences: they always reach the CURRENT global tracer

def span(name: str, **attrs):
    return _tracer.span(name, **attrs)


def event(name: str, **attrs) -> None:
    _tracer.event(name, **attrs)


def log(msg: str, **attrs) -> None:
    _tracer.log(msg, **attrs)


def flush() -> None:
    _tracer.flush()


@atexit.register
def _flush_at_exit() -> None:
    try:
        _tracer.close()
    except Exception:
        pass
