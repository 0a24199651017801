"""Serving-layer fault injectors (port of
``distegnn_tpu/testing/serve_faults.py``; docs/ROBUSTNESS.md, the serving
chaos harness).

Each injector reproduces ONE serving failure mode at an exact point in a
LIVE in-process gateway (they reach through the ModelRegistry into the
replica pool, over the queue hooks ``kill`` / ``wedge`` /
``inject_latency`` and the worker handles), so the tests and
``chip_smoke.py`` can prove the recovery path under real traffic:

  - :func:`kill_replica` — the dispatcher thread dies abruptly (a crashed
    device runtime / OOM-killed worker). The supervisor must detect the
    dead queue, fail in-flight work over to survivors, and restart it
    behind backoff.
  - :func:`wedge_replica` — the dispatcher stays alive but stops making
    batch progress for ``duration_s`` (a stuck collective / hung device
    call). Wedge detection must claim the in-flight work, abandon the
    queue, and restart.
  - :func:`inject_execute_latency` — every batch execute takes an extra
    ``seconds`` (slow device / thermal throttle), inflating queue delay
    without breaking anything: the SLO harness sees honest degradation.
  - :func:`corrupt_swap_checkpoint` — damage a checkpoint file that a
    blue/green swap is about to restore from (torn write / bit-rot); the
    swap must fail at the restore stage and roll back, never flipping a
    replica onto garbage params.

Process-level injectors (``serve.workers: process`` only — they target the
replica's worker CHILD, proving the process-isolation story end to end):

  - :func:`kill9_replica` — SIGKILL the child outright (the OOM killer, a
    segfaulting extension). The parent-side in-flight tracking must fail
    the work over to survivors; the supervisor respawns through backoff.
  - :func:`sigstop_replica` — freeze the child without killing it (a
    debugger attach, cgroup freezer, swap storm). Queue progress tracking
    can't see this when idle; heartbeat staleness must catch it and the
    supervisor must escalate to SIGKILL (the only signal a stopped
    process honors) before respawning.
  - :func:`spawn_failure` — arm the NEXT ``n`` respawn attempts to fail
    (exec failure, bad image, broken env). The replica must degrade to an
    in-process queue (``gateway/worker_degraded``) instead of shedding.

All injectors are process-local: they need the registry object, not a URL.
"""

from __future__ import annotations

import os
import signal

from distegnn_tpu_torch.testing.faults import corrupt_checkpoint


def _replica(registry, model: str, replica: int):
    entry = registry.get(model)
    rset = entry.replicas
    if not 0 <= int(replica) < len(rset.replicas):
        raise IndexError(
            f"model {model!r} has {len(rset.replicas)} replica(s); "
            f"no replica {replica}")
    return rset.replicas[int(replica)]


def kill_replica(registry, model: str, replica: int = 0) -> None:
    """Abruptly kill one replica's dispatcher: its queue fails all queued
    futures typed and the thread exits at its next wake-up. With
    ``serve.replicas >= 2`` the supervisor fails the in-flight work over to
    survivors; single-replica models shed with 503 until the restart."""
    _replica(registry, model, replica).queue.kill(
        reason=f"chaos: killed replica {replica}")


def wedge_replica(registry, model: str, duration_s: float,
                  replica: int = 0) -> None:
    """Freeze one replica's dispatcher for ``duration_s`` seconds without
    killing it — no batch progress, ``last_progress`` goes stale. Pick a
    duration beyond ``serve.supervisor.wedge_timeout_s`` to trigger wedge
    detection, or below it to exercise pure queueing delay."""
    _replica(registry, model, replica).queue.wedge(float(duration_s))


def inject_execute_latency(registry, model: str, seconds: float,
                           replica: int | None = None) -> None:
    """Add ``seconds`` of latency to every batch execute on one replica
    (or all replicas of the model when ``replica`` is None). Pass 0 to
    clear the injection."""
    entry = registry.get(model)
    targets = (entry.replicas.replicas if replica is None
               else [_replica(registry, model, replica)])
    for r in targets:
        r.queue.inject_latency(float(seconds))


def _worker_pid(r, model: str, replica: int, what: str) -> int:
    pid = getattr(r.queue, "pid", None)
    if pid is None:
        raise ValueError(
            f"{what} targets a worker child, but {model!r} replica "
            f"{replica} has no live worker process (thread backend or "
            f"degraded) — run under serve.workers: process")
    return int(pid)


def kill9_replica(registry, model: str, replica: int = 0) -> int:
    """SIGKILL one replica's worker child (the OOM killer's signature move).
    No cleanup runs in the child; the parent's reader thread sees EOF, fails
    in-flight work over to survivors, and the supervisor respawns the child
    behind backoff. Returns the pid killed."""
    r = _replica(registry, model, replica)
    pid = _worker_pid(r, model, replica, "kill9")
    os.kill(pid, signal.SIGKILL)
    return pid


def sigstop_replica(registry, model: str, replica: int = 0) -> int:
    """SIGSTOP one replica's worker child: the process stays alive but stops
    beating. Heartbeat staleness (``worker_heartbeat_timeout_s``) must mark
    it wedged; the supervisor's kill escalates SIGTERM → SIGKILL, which a
    stopped process does honor. Returns the pid stopped."""
    r = _replica(registry, model, replica)
    pid = _worker_pid(r, model, replica, "sigstop")
    os.kill(pid, signal.SIGSTOP)
    return pid


def spawn_failure(registry, model: str, n: int = 1,
                  replica: int = 0) -> None:
    """Arm the next ``n`` worker spawn attempts on one replica to fail
    (injected WorkerSpawnError). Combined with :func:`kill9_replica` this
    proves graceful degradation: the respawn fails, the replica falls back
    to an in-process queue with ``gateway/worker_degraded``, and the NEXT
    restart retries the worker backend."""
    r = _replica(registry, model, replica)
    fn = getattr(r, "fail_next_spawns", None)
    if fn is None:
        raise ValueError(
            f"spawn_failure needs a process-backed replica; {model!r} "
            f"replica {replica} is thread-backed")
    fn(int(n))


def corrupt_swap_checkpoint(path: str, mode: str = "garbage") -> None:
    """Damage the checkpoint a blue/green swap is about to load (modes as
    :func:`distegnn_tpu_torch.testing.faults.corrupt_checkpoint`): the
    swap's verified load must fail and the swap must report
    ``stage="restore", rolled_back=True`` without touching live params."""
    corrupt_checkpoint(path, mode=mode)
