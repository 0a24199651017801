"""The promotion control loop — the serving end of the conveyor (port of
``distegnn_tpu/promote/promoter.py``).

One :class:`Promoter` watches the conveyor directory the trainer publishes
into and walks each new candidate through the promotion lifecycle::

    candidate (manifest + CRC-verified ckpt)
      -> canary: quarantine ONE replica out of live round-robin, hot-swap
         the candidate onto it (the same restore/canary machinery a
         blue/green ``ModelEntry.swap`` uses, pinned to one replica)
      -> shadow: the gateway tees a sample of live predict traffic to the
         canary's queue; responses feed the drift gauge, never clients
      -> verdict: promote fleet-wide (``entry.swap`` — re-canaries every
         replica) or roll the canary back, purely on two gates:
           drift  — per-rung canary-vs-live divergence under the ceiling
           SLO    — the gateway's rolling window error rate stayed clean

A canary that dies mid-shadow (SIGKILLed worker, crashed dispatcher) rolls
back immediately: the supervisor restarts the replica as usual and the
rollback re-pins its params to the live version. A candidate that loses is
never retried — the trainer's next publish is the retry.

Structure mirrors :class:`~distegnn_tpu_torch.serve.autoscale.ReplicaAutoscaler`:
module ``_DEFAULTS`` in lockstep with ``config._DEFAULTS["promote"]``
(``tests/test_torch_promote.py`` asserts it), a public synchronous
``tick(now=...)`` for synthetic-clock tests, a daemon-thread loop, obs
events per decision, and a ``status()`` dict surfaced on ``/readyz``.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Any, Dict, List, Optional

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.promote.drift import DriftGauge
from distegnn_tpu_torch.promote.publish import list_candidates, read_candidate

# knob defaults — kept in lockstep with config._DEFAULTS["promote"] (the
# in-code fallback for hand-built configs)
_DEFAULTS: Dict[str, Any] = {
    "enable": False,
    "publish": False,
    "watch_dir": "",
    "model": "",
    "interval_s": 1.0,
    "history": 4,
    "shadow_sample": 0.25,
    "min_shadow": 8,
    "max_shadow_inflight": 8,
    "gate_timeout_s": 30.0,
    "drift_ceiling": 0.05,
    "max_error_rate": 0.0,
}


class _CanaryRun:
    """One candidate's trip through canary + shadow."""

    __slots__ = ("step", "manifest", "ckpt_path", "entry_name", "replica",
                 "old_params", "gauge", "started", "shadow_errors",
                 "shadow_teed", "shadow_skipped")

    def __init__(self, step, manifest, ckpt_path, entry_name, replica,
                 old_params, gauge, started):
        self.step = step
        self.manifest = manifest
        self.ckpt_path = ckpt_path
        self.entry_name = entry_name
        self.replica = replica
        self.old_params = old_params
        self.gauge = gauge
        self.started = started
        self.shadow_errors = 0
        self.shadow_teed = 0
        self.shadow_skipped = 0


def replica_on_live_version(entry, replica) -> bool:
    """Is one replica serving the entry's live version? Process-backed
    replicas compare checkpoints (their params live in the child); thread
    replicas compare the module (replicas built together share it) or the
    params object (a swap or a rollback hands every replica the same one:
    ``InferenceEngine.params`` keeps it)."""
    if replica.backend == "process":
        return str(replica.current_checkpoint) == str(entry.checkpoint)
    eng = replica.engine
    return (eng.model is entry.engine.model
            or eng.params is entry.engine.params)


def fleet_coherent(entry) -> bool:
    """True when every replica serves the entry's live version — the
    /readyz coherence signal the promotion drill asserts on."""
    return all(replica_on_live_version(entry, r)
               for r in entry.replicas.replicas)


class Promoter:
    """Candidate watcher + canary/shadow/gate state machine for one model.

    Args:
      registry: the ModelRegistry whose entry promotes.
      monitor: the gateway's SLOMonitor (``window_snapshot`` source); None
        disables the SLO gate (drift still decides).
      config: the ``promote:`` mapping (missing keys take defaults).
      metrics_registry: obs MetricsRegistry for the conveyor gauges (None
        skips gauge export).
    """

    def __init__(self, registry, monitor=None, *,
                 config: Optional[dict] = None, metrics_registry=None):
        knobs = dict(_DEFAULTS)
        knobs.update(dict(config or {}))
        self.enable = bool(knobs["enable"]) and bool(
            str(knobs["watch_dir"]).strip())
        self.watch_dir = str(knobs["watch_dir"])
        self.model = str(knobs["model"])
        self.interval_s = float(knobs["interval_s"])
        self.shadow_sample = float(knobs["shadow_sample"])
        self.min_shadow = max(1, int(knobs["min_shadow"]))
        self.max_shadow_inflight = max(1, int(knobs["max_shadow_inflight"]))
        self.gate_timeout_s = float(knobs["gate_timeout_s"])
        self.drift_ceiling = float(knobs["drift_ceiling"])
        self.max_error_rate = float(knobs["max_error_rate"])
        self.registry = registry
        self.monitor = monitor
        self._reg = metrics_registry
        self._lock = threading.Lock()   # one tick at a time (loop vs tests)
        self._canary: Optional[_CanaryRun] = None
        self._shadow_inflight = 0
        self._tee_seen = 0
        self.last_step = -1             # highest candidate step resolved
        self.fleet_step: Optional[int] = None
        self.promoted = 0
        self.rolled_back = 0
        self.rejected = 0
        self.results: List[dict] = []   # bounded decision history
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "Promoter":
        if self._thread is not None or not self.enable:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-promoter", daemon=True)
        self._thread.start()
        return self

    def stop(self, join_timeout_s: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=join_timeout_s)
        self._thread = None
        # leave no replica stranded out of rotation on shutdown
        with self._lock:
            run = self._canary
            if run is not None:
                self._rollback(run, reason="promoter_stopped")

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as exc:  # the loop must outlive any one tick
                obs.log(f"promote: tick failed: {exc!r}")
            self._stop.wait(self.interval_s)

    # ---- the control loop body -------------------------------------------
    def tick(self, now: Optional[float] = None) -> None:
        """One synchronous evaluation. ``now`` overrides the clock for the
        gate-timeout bookkeeping AND the SLO window snapshot, so tests
        drive the state machine with a synthetic clock."""
        with self._lock:
            t = time.monotonic() if now is None else float(now)
            if self._canary is None:
                self._scan(t)
            else:
                self._evaluate(t, now)
            self._export()

    def _entry(self):
        names = self.registry.names()
        if not names:
            return None
        name = self.model or names[0]
        try:
            return self.registry.get(name)
        except KeyError:
            return None

    def _scan(self, t: float) -> None:
        entry = self._entry()
        if entry is None or entry.state != "ready":
            return
        steps = [s for s in list_candidates(self.watch_dir)
                 if s > self.last_step]
        if not steps:
            return
        step = max(steps)
        if len(steps) > 1:
            obs.event("promote/candidates_skipped", model=entry.name,
                      skipped=steps[:-1], chosen=step)
        try:
            manifest = read_candidate(self.watch_dir, step)
        except ValueError as exc:
            self._resolve(None, entry, step, "rejected",
                          reason=f"verify: {exc}")
            return
        from distegnn_tpu_torch.train.checkpoint import load_params

        old_params = entry.engine.params
        try:
            new_params = load_params(
                manifest["ckpt_path"],
                copy.deepcopy(entry.engine.model)).state_dict()
        except Exception as exc:
            self._resolve(None, entry, step, "rejected",
                          reason=f"restore: {exc!r}"[:300])
            return
        replica = self._pick_canary(entry)
        if replica is None or not entry.replicas.quarantine(replica.idx):
            # single-replica fleet: no slice to spare — fall through to the
            # plain blue/green swap (its own canary still gates the flip)
            self._direct_promote(entry, step, manifest)
            return
        try:
            checked = replica.swap_params(manifest["ckpt_path"], new_params,
                                          list(entry.warmed))
        except Exception as exc:
            entry.replicas.release(replica.idx)
            self._resolve(None, entry, step, "rejected",
                          reason=f"canary: {exc!r}"[:300])
            return
        gauge = DriftGauge(ceiling=self.drift_ceiling,
                           min_samples=self.min_shadow)
        self._canary = _CanaryRun(step, manifest, manifest["ckpt_path"],
                                  entry.name, replica, old_params, gauge, t)
        self._tee_seen = 0
        obs.event("promote/canary_begin", model=entry.name, step=step,
                  replica=replica.idx, rungs=checked,
                  val_loss=manifest.get("val_loss"),
                  config_hash=manifest.get("config_hash"))

    def _pick_canary(self, entry):
        """Highest-index healthy replica that isn't replica 0 (the
        registry's engine handle stays live)."""
        cands = [r for r in entry.replicas.replicas
                 if r.healthy() and r is not entry.replicas.replicas[0]]
        return cands[-1] if cands else None

    def _evaluate(self, t: float, now: Optional[float]) -> None:
        run = self._canary
        entry = self._entry()
        if entry is None:
            self._rollback(run, reason="entry_gone")
            return
        if not run.replica.healthy():
            # the chaos case: canary SIGKILLed/crashed mid-promotion. Roll
            # back NOW — the supervisor restart re-enters through the
            # replica's normal lifecycle and the rollback re-pins the live
            # version; the candidate is spent.
            self._rollback(run, reason="canary_died")
            return
        if run.gauge.drifted():
            self._rollback(run, reason="drift")
            return
        timed_out = t - run.started >= self.gate_timeout_s
        if run.gauge.samples >= self.min_shadow or timed_out:
            if run.gauge.samples == 0:
                self._rollback(run, reason="insufficient_shadow")
                return
            if not self._slo_ok(now):
                self._rollback(run, reason="slo")
                return
            self._promote(run, entry)

    def _slo_ok(self, now: Optional[float]) -> bool:
        if self.monitor is None:
            return True
        snap = self.monitor.window_snapshot(now=now)
        return float(snap.get("error_rate", 0.0)) <= self.max_error_rate

    # ---- verdicts --------------------------------------------------------
    def _promote(self, run: _CanaryRun, entry) -> None:
        from distegnn_tpu_torch.serve.registry import (SwapError,
                                                       SwapInProgressError)
        try:
            result = entry.swap(run.ckpt_path)
        except SwapInProgressError:
            return  # a manual swap holds the lock; retry next tick
        except SwapError as exc:
            run.replica.swap_rollback(run.old_params)
            entry.replicas.release(run.replica.idx)
            self._resolve(run, entry, run.step, "rolled_back",
                          reason=f"fleet_swap: {exc}"[:300])
            return
        entry.replicas.release(run.replica.idx)
        self.fleet_step = run.step
        self._resolve(run, entry, run.step, "promoted",
                      version=result["version"])

    def _rollback(self, run: _CanaryRun, reason: str) -> None:
        try:
            run.replica.swap_rollback(run.old_params)
        except Exception as exc:
            obs.log(f"promote: canary rollback raised {exc!r}; the "
                    "supervisor restart restores the live version")
        entry = self._entry()
        if entry is not None:
            entry.replicas.release(run.replica.idx)
        self._resolve(run, entry, run.step, "rolled_back", reason=reason)

    def _resolve(self, run: Optional[_CanaryRun], entry, step: int,
                 outcome: str, **extra) -> None:
        self.last_step = max(self.last_step, int(step))
        self._canary = None
        if outcome == "promoted":
            self.promoted += 1
        elif outcome == "rolled_back":
            self.rolled_back += 1
        else:
            self.rejected += 1
        rec = {"step": int(step), "outcome": outcome, **extra}
        if run is not None:
            rec["shadow"] = {"teed": run.shadow_teed,
                             "errors": run.shadow_errors,
                             "skipped": run.shadow_skipped,
                             "drift": run.gauge.snapshot()}
        self.results.append(rec)
        del self.results[:-16]
        obs.event(f"promote/{outcome}",
                  model=None if entry is None else entry.name, **rec)

    def _direct_promote(self, entry, step: int, manifest: dict) -> None:
        from distegnn_tpu_torch.serve.registry import (SwapError,
                                                       SwapInProgressError)
        try:
            result = entry.swap(manifest["ckpt_path"])
        except SwapInProgressError:
            return  # retry next tick; last_step untouched
        except SwapError as exc:
            self._resolve(None, entry, step, "rolled_back",
                          reason=f"direct_swap: {exc}"[:300])
            return
        self.fleet_step = step
        self._resolve(None, entry, step, "promoted",
                      version=result["version"], direct=True)

    # ---- the shadow tee (called from the gateway's predict hot path) ------
    def tee(self, model: str, graph: dict, bucket, request_id: str,
            live_out) -> None:
        """Mirror one live predict to the canary. Sampled, bounded, and
        silent: nothing that happens here may perturb the live response
        (the caller already holds the client's result)."""
        run = self._canary
        if run is None or run.entry_name != model:
            return
        try:
            self._tee_seen += 1
            stride = max(1, round(1.0 / self.shadow_sample))
            if (self._tee_seen - 1) % stride:
                run.shadow_skipped += 1
                return
            if self._shadow_inflight >= self.max_shadow_inflight:
                run.shadow_skipped += 1
                return
            if bucket is not None:
                rung = f"n{bucket.n}"
            else:
                # plain predicts reach the queue unbucketed; rung by the
                # raw node count so the gauge still resolves per size
                loc = graph.get("loc") if isinstance(graph, dict) else None
                rung = f"g{len(loc)}" if loc is not None else "n?"
            fut = run.replica.queue.submit(
                graph, bucket=bucket, request_id=f"shadow-{request_id}")
            self._shadow_inflight += 1
            run.shadow_teed += 1
            fut.add_done_callback(
                lambda f, run=run, rung=rung, live=live_out:
                self._on_shadow_done(run, rung, live, f))
        except Exception:
            run.shadow_skipped += 1  # canary full/dying — never the client's
            # problem; the gate's evidence just accumulates slower

    def _on_shadow_done(self, run: _CanaryRun, rung: str, live, fut) -> None:
        with self._lock:
            self._shadow_inflight = max(0, self._shadow_inflight - 1)
            if self._canary is not run:
                return  # verdict already landed; late shadow is noise
            exc = fut.exception()
            if exc is not None:
                run.shadow_errors += 1
                return
            try:
                run.gauge.observe(rung, live, fut.result())
            except Exception as e:
                obs.log(f"promote: drift observe failed: {e!r}")
                run.shadow_errors += 1

    # ---- health / metrics surfaces ---------------------------------------
    def status(self) -> Dict[str, Any]:
        """Promotion state for /readyz: conveyor position, verdict counts,
        and the fleet-version coherence bit the drill asserts on."""
        entry = self._entry()
        run = self._canary
        out = {
            "enable": self.enable,
            "state": "canary" if run is not None else "idle",
            "watch_dir": self.watch_dir,
            "last_step": self.last_step,
            "fleet_step": self.fleet_step,
            "promoted": self.promoted,
            "rolled_back": self.rolled_back,
            "rejected": self.rejected,
            "results": list(self.results[-4:]),
        }
        if entry is not None:
            out["model"] = entry.name
            out["params_version"] = entry.params_version
            out["fleet_coherent"] = (run is None
                                     and fleet_coherent(entry))
        if run is not None:
            out["canary"] = {"step": run.step, "replica": run.replica.idx,
                             "teed": run.shadow_teed,
                             "errors": run.shadow_errors,
                             "samples": run.gauge.samples,
                             "drift": run.gauge.snapshot()}
        return out

    def export(self) -> None:
        """Refresh the conveyor gauges (called by the gateway's /metrics
        render so a scrape never sees stale verdict counters)."""
        with self._lock:
            self._export()

    def _export(self) -> None:
        if self._reg is None:
            return
        self._reg.gauge("promote/fleet_step").set(
            -1 if self.fleet_step is None else self.fleet_step)
        self._reg.gauge("promote/last_step").set(self.last_step)
        self._reg.gauge("promote/canary_active").set(
            0 if self._canary is None else 1)
        self._reg.gauge("promote/promoted_total").set(self.promoted)
        self._reg.gauge("promote/rolled_back_total").set(self.rolled_back)
        self._reg.gauge("promote/rejected_total").set(self.rejected)
        if self._canary is not None:
            self._canary.gauge.export(self._reg)


def watch_dir_from_config(cfg) -> str:
    """Resolve the conveyor directory from a config mapping (empty when
    promotion is unconfigured)."""
    pm = (cfg.get("promote") or {}) if hasattr(cfg, "get") else {}
    return str(pm.get("watch_dir", "") or "")


__all__ = ["Promoter", "fleet_coherent", "replica_on_live_version",
           "watch_dir_from_config"]
