"""The promotion conveyor's chaos drill and the worker-process fault drill
(the port's counterpart of ``scripts/traffic_gen.py --promote`` and of its
``kill9`` / ``sigstop`` chaos actions).

:func:`run_promote_drill` runs JAX's four phases against a LIVE in-process
gateway (a :class:`~distegnn_tpu_torch.serve.transport.Gateway` whose
``promote.enable`` promoter watches ``promote.watch_dir``) while a client
thread keeps predict traffic flowing over HTTP:

  1. a publisher CHILD PROCESS lands a good candidate -> it promotes
     fleet-wide through the canary + shadow gates;
  2. a second publisher is SIGKILLed mid-publish (tmp file open, no
     manifest) -> the conveyor must not move, and the next publish sweeps
     the orphan;
  3. a third candidate's canary replica is killed mid-promotion
     (:func:`~distegnn_tpu_torch.testing.serve_faults.kill9_replica` under
     ``serve.workers: process``, ``kill_replica`` under threads) ->
     immediate ``canary_died`` rollback, and the supervisor restores it;
  4. a drift candidate (the live params x 2.25) -> rolled back by the drift
     gauge, or rejected by the canary's finiteness check when the scaled
     net overflows: the record says which.

:func:`run_worker_faults` freezes one worker child (``sigstop_replica``:
heartbeat staleness, SIGTERM -> SIGKILL escalation, respawn), then arms one
spawn failure (``spawn_failure``: the replica degrades to an in-process
queue, and the next restart brings a real child back).

The publisher child is this module:
``python -m distegnn_tpu_torch.testing.promote_drill --publish-child <json>``.
The drill starts its four publishers together and releases each with a line
on its stdin when its phase begins, so only the first phase waits for a
publisher's interpreter and imports.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

DRIFT_SCALE = 2.25


def publish_child_main(spec_json: str) -> int:
    """The drill's stand-in trainer process: publish candidates through the
    REAL CandidatePublisher (tmp+fsync+rename, manifest last). A plan item
    with ``hang: true`` simulates dying INSIDE the atomic write — it leaves
    an orphan ``.tmp.`` file in the watch dir, announces itself on stdout,
    and waits for the parent's SIGKILL; the conveyor invariant under test is
    that no manifest ever points at a partial checkpoint. The plan runs once
    a line arrives on stdin: the drill starts a publisher ahead of its
    phase."""
    from distegnn_tpu_torch.promote.publish import CandidatePublisher

    spec = json.loads(spec_json)
    sys.stdin.readline()
    watch = spec["watch_dir"]
    pub = CandidatePublisher(watch, history=int(spec.get("history", 4)))
    for item in spec["plan"]:
        step = int(item["step"])
        if item.get("hang"):
            fd, _ = tempfile.mkstemp(
                dir=watch, prefix=f"step_{step:010d}.ckpt.tmp.")
            os.write(fd, b"partial-checkpoint-bytes")
            print(f"PUBLISH-HANG {step}", flush=True)
            time.sleep(600.0)
            os.close(fd)
            return 3  # unreachable under the drill's SIGKILL
        pub.publish(item["ckpt"], step=step, val_loss=item.get("val_loss"))
        print(f"PUBLISHED {step}", flush=True)
    return 0


def save_scaled(entry, path: str, scale: float) -> str:
    """A trainer checkpoint of the entry's live parameters times ``scale``
    (the drill's candidates)."""
    import torch

    from distegnn_tpu_torch.train.checkpoint import save_checkpoint
    from distegnn_tpu_torch.train.step import TrainState, make_optimizer

    model = copy.deepcopy(entry.engine.model).cpu()
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(scale)
    save_checkpoint(path, TrainState(model, make_optimizer(
        model.parameters(), 1e-3)), epoch=0)
    return path


def _http(port: int, method: str, path: str, body: Optional[bytes] = None,
          timeout: float = 60.0):
    """One request on its own connection -> (status, body bytes, ms)."""
    import http.client

    t0 = time.perf_counter()
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request(method, path, body=body,
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        data = r.read()
        return r.status, data, (time.perf_counter() - t0) * 1e3
    finally:
        c.close()


class LiveTraffic:
    """Closed-loop predict clients for the drill's duration: each sends the
    next body as soon as its last answer came back (after ``pause_s``).
    ``results`` holds (status, ms) per request; a request that got no
    response at all is ``(None, ms)`` — a lost request."""

    def __init__(self, port: int, model: str, bodies: List[bytes],
                 clients: int = 2, pause_s: float = 0.0,
                 timeout_s: float = 60.0):
        self.port, self.model, self.bodies = port, model, list(bodies)
        self.pause_s, self.timeout_s = float(pause_s), float(timeout_s)
        self.results: List[tuple] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(i,),
                                          daemon=True,
                                          name=f"drill-client-{i}")
                         for i in range(int(clients))]
        self.t0 = self.t1 = None

    def start(self) -> "LiveTraffic":
        self.t0 = time.perf_counter()
        for t in self._threads:
            t.start()
        return self

    def _run(self, i: int) -> None:
        k = i
        path = f"/v1/models/{self.model}/predict"
        while not self._stop.is_set():
            body = self.bodies[k % len(self.bodies)]
            k += len(self._threads)
            t0 = time.perf_counter()
            try:
                st, _, ms = _http(self.port, "POST", path, body,
                                  timeout=self.timeout_s)
            except OSError:
                st, ms = None, (time.perf_counter() - t0) * 1e3
            with self._lock:
                self.results.append((st, ms))
            if self.pause_s:
                self._stop.wait(self.pause_s)

    def stop(self) -> Dict[str, object]:
        self._stop.set()
        for t in self._threads:
            t.join(self.timeout_s + 5.0)
        self.t1 = time.perf_counter()
        with self._lock:
            res = list(self.results)
        ok = [ms for st, ms in res if st == 200]
        return {"requests": len(res), "completed": len(ok),
                "lost": sum(1 for st, _ in res if st is None),
                "errors": sum(1 for st, _ in res
                              if st is not None and st != 200),
                "statuses": sorted({st for st, _ in res if st != 200},
                                   key=str),
                "ms": ok, "wall_s": self.t1 - self.t0}


def run_promote_drill(gateway, registry, model: str, probe_body: bytes,
                      stage_dir: str, traffic: Optional[LiveTraffic] = None,
                      timeout_s: float = 60.0,
                      log: Callable[[str], None] = lambda m: None) -> dict:
    """JAX's four-phase promotion drill against ``gateway`` (see the module
    docstring). ``probe_body`` is a predict request body: probes keep shadow
    evidence flowing when ``traffic`` is quiet. Returns a record with each
    phase's outcome, ``tmp_swept``, the ``/readyz`` promote status and
    ``ok``; never raises (an exception lands in ``record['error']``)."""
    from distegnn_tpu_torch.promote.publish import candidate_manifest_name
    from distegnn_tpu_torch.testing import serve_faults

    promoter = gateway.promoter
    entry = registry.get(model)
    watch = promoter.watch_dir
    port = gateway.port
    os.makedirs(stage_dir, exist_ok=True)
    record: dict = {"ok": False, "phases": {}, "published": 0}
    children: List[subprocess.Popen] = []
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = (root + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else root)

    def spawn(plan):
        spec = json.dumps({"watch_dir": watch, "plan": plan})
        proc = subprocess.Popen(
            [sys.executable, "-m", "distegnn_tpu_torch.testing.promote_drill",
             "--publish-child", spec],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, env=env)
        children.append(proc)
        return proc

    def release(proc):
        proc.stdin.write("go\n")
        proc.stdin.flush()
        return proc

    def probe():
        try:
            _http(port, "POST", f"/v1/models/{model}/predict", probe_body,
                  timeout=timeout_s)
        except OSError:
            pass

    def outcome_for(step):
        for r in list(promoter.results):
            if r.get("step") == step:
                return r
        return None

    def wait_for(pred, limit_s, poke=False):
        deadline = time.perf_counter() + limit_s
        while time.perf_counter() < deadline:
            if pred():
                return True
            if poke:
                probe()
            time.sleep(0.05)
        return bool(pred())

    def healthy_replicas():
        return sum(1 for r in entry.replicas.replicas if r.healthy())

    n_replicas = len(entry.replicas.replicas)
    try:
        t_drill = time.perf_counter()
        good1 = save_scaled(entry, os.path.join(stage_dir, "good1.ckpt"),
                            1.0001)
        good2 = save_scaled(entry, os.path.join(stage_dir, "good2.ckpt"),
                            1.0002)
        drifted = save_scaled(entry, os.path.join(stage_dir, "drift.ckpt"),
                              DRIFT_SCALE)
        publishers = [spawn(plan) for plan in (
            [{"step": 10, "ckpt": good1, "val_loss": 0.5}],
            [{"step": 20, "hang": True}],
            [{"step": 30, "ckpt": good2, "val_loss": 0.4}],
            [{"step": 40, "ckpt": drifted, "val_loss": 0.1}])]

        # phase 1: a good candidate promotes fleet-wide
        t0 = time.perf_counter()
        proc = release(publishers[0])
        proc.wait(timeout=timeout_s)
        record["published"] += 1
        wait_for(lambda: outcome_for(10), timeout_s, poke=True)
        o1 = dict(outcome_for(10) or {})
        o1["s"] = round(time.perf_counter() - t0, 3)
        record["phases"]["promote"] = o1
        promote_ok = o1.get("outcome") == "promoted"
        log(f"drill phase 1 (good candidate): {o1}")

        # phase 2: the publisher SIGKILLed mid-publish — orphan tmp, no
        # manifest, conveyor position unchanged
        before = promoter.last_step
        proc = release(publishers[1])
        marker = proc.stdout.readline()
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=timeout_s)
        time.sleep(3 * promoter.interval_s + 0.1)
        orphan = any(".tmp." in f for f in os.listdir(watch))
        manifest20 = os.path.exists(
            os.path.join(watch, candidate_manifest_name(20)))
        kill_ok = orphan and not manifest20 and promoter.last_step == before
        record["phases"]["publisher_kill"] = {
            "marker": marker.strip(), "orphan_tmp": orphan,
            "manifest_appeared": manifest20,
            "conveyor_moved": promoter.last_step != before, "ok": kill_ok}
        log(f"drill phase 2 (publisher SIGKILL mid-publish): "
            f"{record['phases']['publisher_kill']}")

        # phase 3: kill the canary replica mid-promotion -> immediate
        # canary_died rollback; the supervisor restores the replica
        wait_for(lambda: healthy_replicas() >= n_replicas, timeout_s)
        hold = promoter.min_shadow
        promoter.min_shadow = 10 ** 6  # pin the canary open for the kill
        killed_via, idx, old_pid = None, None, None
        t0 = time.perf_counter()
        try:
            proc = release(publishers[2])
            proc.wait(timeout=timeout_s)
            record["published"] += 1

            def canary_up():
                c = promoter.status().get("canary")
                return c is not None and c["step"] == 30

            wait_for(canary_up, timeout_s, poke=True)
            idx = (promoter.status().get("canary") or {}).get("replica")
            if idx is not None:
                rep = entry.replicas.replicas[idx]
                if rep.backend == "process":
                    old_pid = serve_faults.kill9_replica(registry, model, idx)
                    killed_via = "kill9"
                else:
                    serve_faults.kill_replica(registry, model, idx)
                    killed_via = "kill"
            wait_for(lambda: outcome_for(30), timeout_s)
        finally:
            promoter.min_shadow = hold
        o3 = dict(outcome_for(30) or {})
        o3.update(killed_via=killed_via, replica=idx, killed_pid=old_pid)
        respawned = wait_for(lambda: healthy_replicas() >= n_replicas,
                             timeout_s)
        if idx is not None:
            rep = entry.replicas.replicas[idx]
            o3.update(restarts=rep.restarts,
                      new_pid=getattr(rep.queue, "pid", None),
                      degraded=bool(getattr(rep, "degraded", False)))
        o3.update(respawned=respawned, s=round(time.perf_counter() - t0, 3))
        record["phases"]["canary_kill"] = o3
        canary_ok = (o3.get("outcome") == "rolled_back"
                     and o3.get("reason") == "canary_died" and respawned
                     and o3.get("restarts", 0) >= 1)
        log(f"drill phase 3 (canary killed): {o3}")

        # phase 4: the drift candidate rolls back on the gauge (or is
        # rejected by the canary when the scaled net overflows)
        t0 = time.perf_counter()
        proc = release(publishers[3])
        proc.wait(timeout=timeout_s)
        record["published"] += 1
        wait_for(lambda: outcome_for(40), timeout_s, poke=True)
        o4 = dict(outcome_for(40) or {})
        o4["caught_by"] = ("drift gauge" if o4.get("reason") == "drift"
                           else "canary finiteness check"
                           if "CanaryError" in str(o4.get("reason"))
                           else "neither")
        o4["s"] = round(time.perf_counter() - t0, 3)
        record["phases"]["drift"] = o4
        drift_ok = (o4.get("outcome") == "rolled_back"
                    and o4.get("reason") == "drift")
        log(f"drill phase 4 (drift x{DRIFT_SCALE}): {o4}")

        # phase 4's publisher swept phase 2's orphan on its way in
        record["tmp_swept"] = not any(".tmp." in f for f in os.listdir(watch))
        st, body, _ = _http(port, "GET", "/readyz")
        rz = json.loads(body) if body else {}
        record["readyz"] = rz.get("promote")
        coherent = bool((rz.get("promote") or {}).get("fleet_coherent"))
        record["status"] = promoter.status()
        record["drill_s"] = round(time.perf_counter() - t_drill, 3)
        record["ok"] = bool(promote_ok and kill_ok and canary_ok and drift_ok
                            and record["tmp_swept"] and coherent)
    except Exception as exc:
        record["error"] = repr(exc)
    finally:
        for p in children:
            if p.poll() is None:
                try:
                    p.kill()
                    p.wait(timeout=10)
                except Exception:
                    pass
            for pipe in (p.stdin, p.stdout):
                try:
                    pipe.close()
                except Exception:
                    pass
    if traffic is not None:
        record["traffic"] = {k: v for k, v in traffic.stop().items()
                             if k != "ms"}
    return record


def _saw_event(name: str, since: float, **match) -> Optional[bool]:
    """Whether the live obs stream holds event ``name`` (with ``match``'s
    attributes) stamped after ``since``; None when tracing is off."""
    from distegnn_tpu_torch import obs
    from distegnn_tpu_torch.obs.report import load_events

    w = obs.get_tracer().writer
    if w is None:
        return None
    w.flush()
    return any(e.get("name") == name and float(e.get("ts", 0.0)) >= since
               and all(e.get(k) == v for k, v in match.items())
               for e in load_events(w.path)[0])


def run_worker_faults(registry, model: str, stop_replica: int,
                      fail_replica: int, timeout_s: float = 60.0,
                      log: Callable[[str], None] = lambda m: None) -> dict:
    """Two worker-process faults on a running process fleet: SIGSTOP on
    ``stop_replica`` (caught by heartbeat staleness, escalated to SIGKILL,
    respawned on a new pid), then one armed spawn failure on
    ``fail_replica`` (the restart degrades to an in-process queue with
    ``gateway/worker_degraded``; killing that queue makes the supervisor's
    next restart spawn a real child again). Two replicas, so neither
    collects the consecutive failures that open its circuit breaker.
    Returns a record with both drills' timings and ``ok``."""
    from distegnn_tpu_torch.testing import serve_faults

    entry = registry.get(model)
    r = entry.replicas.replicas[stop_replica]
    replica = stop_replica

    def wait_for(pred, limit_s):
        deadline = time.perf_counter() + limit_s
        while time.perf_counter() < deadline:
            if pred():
                return True
            time.sleep(0.02)
        return bool(pred())

    def is_dead(pid):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        except OSError:
            return False
        return False

    rec: dict = {}
    # SIGSTOP: the child stops beating; the supervisor marks it wedged and
    # its kill escalates SIGTERM -> SIGKILL, then the respawn
    old = r.queue.worker
    restarts0 = r.restarts
    t0 = time.perf_counter()
    pid = serve_faults.sigstop_replica(registry, model, replica)
    detected = wait_for(lambda: r.state != "running", timeout_s)
    t_detect = time.perf_counter() - t0
    back = wait_for(lambda: r.restarts > restarts0 and r.healthy()
                    and getattr(r.queue, "pid", None) not in (None, pid),
                    timeout_s)
    rec["sigstop"] = {
        "pid": pid, "detected": detected, "detect_s": round(t_detect, 3),
        "reason": r.last_reason, "escalated": bool(old._escalated),
        "old_dead": is_dead(pid), "new_pid": getattr(r.queue, "pid", None),
        "respawned": back, "respawn_s": round(time.perf_counter() - t0, 3)}
    log(f"worker fault sigstop: {rec['sigstop']}")

    # spawn failure: arm one, kill the child; the restart degrades
    r = entry.replicas.replicas[fail_replica]
    replica = fail_replica
    restarts0 = r.restarts
    t_arm = time.time()
    t0 = time.perf_counter()
    serve_faults.spawn_failure(registry, model, n=1, replica=replica)
    pid = serve_faults.kill9_replica(registry, model, replica)
    degraded = wait_for(lambda: r.restarts > restarts0 and r.degraded
                        and r.healthy(), timeout_s)
    t_degrade = time.perf_counter() - t0
    row = next(h for h in entry.replicas.health() if h["replica"] == r.idx)
    # the degraded replica serves in-process until its next restart: kill
    # that queue, and the supervisor spawns a real child again
    restarts1 = r.restarts
    serve_faults.kill_replica(registry, model, replica)
    back = wait_for(lambda: r.restarts > restarts1 and r.healthy()
                    and not r.degraded
                    and getattr(r.queue, "pid", None) is not None, timeout_s)
    rec["spawn_failure"] = {
        "killed_pid": pid, "degraded": degraded,
        "degrade_s": round(t_degrade, 3),
        "health_degraded": bool(row.get("degraded")),
        "degraded_event": _saw_event("gateway/worker_degraded", t_arm,
                                     model=model, replica=r.idx),
        "recovered": back, "new_pid": getattr(r.queue, "pid", None),
        "recover_s": round(time.perf_counter() - t0, 3)}
    log(f"worker fault spawn_failure: {rec['spawn_failure']}")
    s, f = rec["sigstop"], rec["spawn_failure"]
    rec["ok"] = bool(s["detected"] and s["reason"] == "wedge"
                     and s["escalated"] and s["old_dead"] and s["respawned"]
                     and f["degraded"] and f["health_degraded"]
                     and f["degraded_event"] is not False
                     and f["recovered"])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="distegnn_tpu_torch.testing.promote_drill",
        description="the promotion drill's publisher child (not a "
                    "user-facing entry point)")
    ap.add_argument("--publish-child", type=str, required=True,
                    help="JSON spec: {watch_dir, plan: [{step, ckpt | "
                         "hang}]}")
    args = ap.parse_args(argv)
    return publish_child_main(args.publish_child)


if __name__ == "__main__":
    sys.exit(main())
