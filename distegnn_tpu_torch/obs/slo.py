"""Declarative SLO specs, evaluated wherever the numbers already are (port
of ``distegnn_tpu/obs/slo.py``; pure Python, a copy of its own).

One spec (the ``slo:`` config section, or a YAML/JSON file handed to
``python -m distegnn_tpu_torch.obs.report --slo``) names the service-level
objectives of the serving stack: per-route latency ceilings, error- and
shed-rate ceilings, batch-fill and session-hit floors. Evaluation is a pure
function over a flat ``stats`` dict, so the same spec scores

  - the event stream (:func:`stats_from_events`, what ``obs.report --slo``
    does offline from ``events.jsonl`` alone),
  - a live ``GET /metrics`` scrape (:func:`stats_from_prometheus`),
  - any caller-built dict.

Stat keys (missing = NO DATA, which is reported but never a breach):

  ``<route>_p50_ms`` / ``<route>_p99_ms``  successful-response latency per
                                           route (predict / rollout)
  ``error_rate``       5xx fraction of inference requests (incl. 504)
  ``shed_rate``        429 fraction of inference requests
  ``batch_fill``       filled / capacity slots over executed micro-batches
  ``session_hit_rate`` session prep-cache hits / lookups

:class:`SLOMonitor` is the live half: a rolling window of gateway
observations exported as ``slo/window_*`` gauges on every ``GET /metrics``
render, which the autoscaler and priority admission read.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional

from distegnn_tpu_torch.obs.metrics import MetricsRegistry, _prom_name, percentile

# routes the SLO vocabulary covers: inference traffic only — operational
# scrapes (healthz/metrics/models) would dilute every rate
SLO_ROUTES = ("predict", "rollout")


class SLORule(NamedTuple):
    """One objective: ``stat`` must stay on the right side of ``threshold``
    (``bound`` is 'max' for ceilings, 'min' for floors)."""

    name: str
    stat: str
    bound: str          # "max" | "min"
    threshold: float


class SLOResult(NamedTuple):
    rule: SLORule
    observed: Optional[float]   # None = stat absent from stats (NO DATA)

    @property
    def ok(self) -> Optional[bool]:
        if self.observed is None:
            return None
        if self.rule.bound == "max":
            return self.observed <= self.rule.threshold
        return self.observed >= self.rule.threshold


class SLOSpec:
    """The declarative spec: thresholds only, no measurement."""

    def __init__(self, *, window_s: float = 60.0,
                 routes: Optional[Dict[str, Dict[str, float]]] = None,
                 error_rate_max: Optional[float] = None,
                 shed_rate_max: Optional[float] = None,
                 batch_fill_min: Optional[float] = None,
                 session_hit_min: Optional[float] = None):
        if window_s <= 0:
            raise ValueError(f"slo.window_s must be > 0 (got {window_s})")
        self.window_s = float(window_s)
        self.routes: Dict[str, Dict[str, float]] = {}
        for route, ceilings in (routes or {}).items():
            if route not in SLO_ROUTES:
                raise ValueError(f"slo.routes: unknown route {route!r} "
                                 f"(expected one of {SLO_ROUTES})")
            if not isinstance(ceilings, dict):
                raise ValueError(f"slo.routes.{route} must be a mapping of "
                                 f"p50_ms/p99_ms ceilings")
            for k, v in ceilings.items():
                if k not in ("p50_ms", "p99_ms"):
                    raise ValueError(f"slo.routes.{route}: unknown ceiling "
                                     f"{k!r} (expected p50_ms or p99_ms)")
                if v is not None and float(v) <= 0:
                    raise ValueError(f"slo.routes.{route}.{k} must be > 0 "
                                     f"(got {v})")
            self.routes[route] = {k: (None if v is None else float(v))
                                  for k, v in ceilings.items()}
        for label, v, lo, hi in (("error_rate_max", error_rate_max, 0, 1),
                                 ("shed_rate_max", shed_rate_max, 0, 1),
                                 ("batch_fill_min", batch_fill_min, 0, 1),
                                 ("session_hit_min", session_hit_min, 0, 1)):
            if v is not None and not (lo <= float(v) <= hi):
                raise ValueError(f"slo.{label} must be in [{lo}, {hi}] "
                                 f"(got {v})")
        self.error_rate_max = error_rate_max
        self.shed_rate_max = shed_rate_max
        self.batch_fill_min = batch_fill_min
        self.session_hit_min = session_hit_min

    @classmethod
    def from_mapping(cls, d: Dict[str, Any]) -> "SLOSpec":
        """Build from the ``slo:`` config section (or an equivalent dict);
        a nested ``{"slo": {...}}`` wrapper is unwrapped. Unknown keys are
        errors — a typo'd ceiling must not silently never fire."""
        if "slo" in d and isinstance(d["slo"], dict):
            d = d["slo"]
        known = {"enable", "window_s", "routes", "error_rate_max",
                 "shed_rate_max", "batch_fill_min", "session_hit_min"}
        extra = set(d) - known
        if extra:
            raise ValueError(f"slo: unknown key(s) {sorted(extra)} "
                             f"(known: {sorted(known)})")
        return cls(window_s=float(d.get("window_s", 60.0)),
                   routes=d.get("routes") or {},
                   error_rate_max=d.get("error_rate_max"),
                   shed_rate_max=d.get("shed_rate_max"),
                   batch_fill_min=d.get("batch_fill_min"),
                   session_hit_min=d.get("session_hit_min"))

    @classmethod
    def from_file(cls, path: str) -> "SLOSpec":
        """Load a YAML (or JSON — valid YAML) spec file."""
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f)
        if not isinstance(d, dict):
            raise ValueError(f"SLO spec {path}: expected a mapping, "
                             f"got {type(d).__name__}")
        return cls.from_mapping(d)

    def rules(self) -> List[SLORule]:
        out: List[SLORule] = []
        for route in sorted(self.routes):
            for q in ("p50_ms", "p99_ms"):
                thr = self.routes[route].get(q)
                if thr is not None:
                    out.append(SLORule(f"{route}_{q} <= {thr:g}",
                                       f"{route}_{q}", "max", thr))
        if self.error_rate_max is not None:
            out.append(SLORule(f"error_rate <= {self.error_rate_max:g}",
                               "error_rate", "max",
                               float(self.error_rate_max)))
        if self.shed_rate_max is not None:
            out.append(SLORule(f"shed_rate <= {self.shed_rate_max:g}",
                               "shed_rate", "max", float(self.shed_rate_max)))
        if self.batch_fill_min is not None:
            out.append(SLORule(f"batch_fill >= {self.batch_fill_min:g}",
                               "batch_fill", "min",
                               float(self.batch_fill_min)))
        if self.session_hit_min is not None:
            out.append(SLORule(f"session_hit_rate >= "
                               f"{self.session_hit_min:g}",
                               "session_hit_rate", "min",
                               float(self.session_hit_min)))
        return out


# ---- stat producers ---------------------------------------------------------

def stats_from_events(events: List[Dict[str, Any]]) -> Dict[str, float]:
    """The SLO stats vocabulary, computed from ``events.jsonl`` alone.

    Latency percentiles use SUCCESSFUL (status < 400) inference responses;
    error/shed rates are fractions of ALL inference requests. Keys with no
    underlying traffic are omitted (NO DATA), never zero-filled.
    """
    stats: Dict[str, float] = {}
    infer = [e for e in events if e.get("name") == "serve/http"
             and e.get("route") in SLO_ROUTES]
    for route in SLO_ROUTES:
        lat = sorted(1e3 * float(e.get("dur_s", 0.0)) for e in infer
                     if e.get("route") == route
                     and int(e.get("status") or 0) < 400)
        if lat:
            stats[f"{route}_p50_ms"] = round(percentile(lat, 50), 3)
            stats[f"{route}_p99_ms"] = round(percentile(lat, 99), 3)
    if infer:
        statuses = [int(e.get("status") or 0) for e in infer]
        stats["error_rate"] = round(
            sum(s >= 500 for s in statuses) / len(statuses), 6)
        stats["shed_rate"] = round(
            sum(s == 429 for s in statuses) / len(statuses), 6)
    batches = [e for e in events if e.get("name") == "serve/batch"]
    slots = sum(int(e.get("capacity", 0)) for e in batches)
    if slots:
        stats["batch_fill"] = round(
            sum(int(e.get("filled", 0)) for e in batches) / slots, 6)
    preps = [e for e in events if e.get("name") == "serve/prep"]
    if preps:
        stats["session_hit_rate"] = round(
            sum(bool(e.get("hit")) for e in preps) / len(preps), 6)
    return stats


_PROM_LINE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
                        r'(?:\{([^}]*)\})?\s+([^\s]+)$')


def parse_prometheus(text: str) -> Dict[str, float]:
    """Prometheus text -> {name or name{labels}: value} (comments skipped).
    Tolerates unparseable lines — a scrape is diagnostics, not input."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if not m:
            continue
        name, labels, val = m.groups()
        try:
            fval = float(val)
        except ValueError:
            continue
        out[f"{name}{{{labels}}}" if labels else name] = fval
    return out


def stats_from_prometheus(text: str,
                          models: Optional[List[str]] = None
                          ) -> Dict[str, float]:
    """The SLO stats vocabulary, from a live ``GET /metrics`` scrape.

    Uses the gateway's per-route reservoirs (all responses — the scrape has
    no per-status latency split) and counters; fill and session hits are
    summed over the per-model serve registries (``models`` limits which;
    default: every ``distegnn_model_*`` present).
    """
    vals = parse_prometheus(text)
    stats: Dict[str, float] = {}
    for route in SLO_ROUTES:
        base = f"distegnn_gateway_http_{route}_ms"
        if vals.get(f"{base}_count", 0.0) > 0:
            stats[f"{route}_p50_ms"] = vals.get(f'{base}{{quantile="0.50"}}',
                                                0.0)
            stats[f"{route}_p99_ms"] = vals.get(f'{base}{{quantile="0.99"}}',
                                                0.0)
    total = vals.get("distegnn_gateway_requests_total", 0.0)
    if total > 0:
        errors = (vals.get("distegnn_gateway_errors", 0.0)
                  + vals.get("distegnn_gateway_timeouts", 0.0))
        sheds = (vals.get("distegnn_gateway_shed_inflight", 0.0)
                 + vals.get("distegnn_gateway_shed_queue_full", 0.0))
        stats["error_rate"] = round(errors / total, 6)
        stats["shed_rate"] = round(sheds / total, 6)
    prefixes = ([f"distegnn_model_{_prom_name(m)}" for m in models]
                if models is not None else
                sorted({k.split("_serve_")[0] for k in vals
                        if k.startswith("distegnn_model_")
                        and "_serve_" in k}))
    filled = slots = hits = misses = 0.0
    for p in prefixes:
        filled += vals.get(f"{p}_serve_batch_slots_filled", 0.0)
        slots += vals.get(f"{p}_serve_batch_slots_total", 0.0)
        hits += vals.get(f"{p}_serve_session_hits", 0.0)
        misses += vals.get(f"{p}_serve_session_misses", 0.0)
    if slots > 0:
        stats["batch_fill"] = round(filled / slots, 6)
    if hits + misses > 0:
        stats["session_hit_rate"] = round(hits / (hits + misses), 6)
    return stats


# ---- evaluation -------------------------------------------------------------

def evaluate(spec: SLOSpec, stats: Dict[str, float]) -> List[SLOResult]:
    return [SLOResult(rule, (float(stats[rule.stat])
                             if rule.stat in stats else None))
            for rule in spec.rules()]


def breached(results: List[SLOResult]) -> bool:
    return any(r.ok is False for r in results)


def verdict_table(results: List[SLOResult], source: str = "") -> str:
    lines = [f"== SLO verdict{' — ' + source if source else ''} =="]
    if not results:
        lines.append("spec declares no objectives (all thresholds null)")
        return "\n".join(lines) + "\n"
    lines.append(f"  {'objective':<34} {'observed':>10}  verdict")
    n_breach = n_nodata = 0
    for r in results:
        if r.ok is None:
            verdict, obs_s = "NO DATA", "-"
            n_nodata += 1
        elif r.ok:
            verdict, obs_s = "OK", f"{r.observed:g}"
        else:
            verdict, obs_s = "BREACH", f"{r.observed:g}"
            n_breach += 1
        lines.append(f"  {r.rule.name:<34} {obs_s:>10}  {verdict}")
    overall = "FAIL" if n_breach else "PASS"
    lines.append(f"overall: {overall} ({len(results)} objective(s), "
                 f"{n_breach} breached, {n_nodata} without data)")
    return "\n".join(lines) + "\n"


def results_json(results: List[SLOResult]) -> Dict[str, Any]:
    """The verdict as a JSON-able dict."""
    return {
        "pass": not breached(results),
        "rules": len(results),
        "breached": [r.rule.name for r in results if r.ok is False],
        "no_data": [r.rule.name for r in results if r.ok is None],
    }


# ---- the live half: rolling-window gauges on GET /metrics -------------------

class SLOMonitor:
    """Rolling window over gateway observations, exported as gauges.

    The gateway feeds one ``observe_http`` per inference request;
    ``export`` (called from every ``render_metrics``) prunes the window and
    sets ``slo/window_*`` gauges — windowed p50/p99 per route, error and
    shed rates, and per-model queue depth + windowed batch fill (computed
    by differencing each model's cumulative slot counters across the
    window). Thread-safe; O(1) per observation.
    """

    def __init__(self, window_s: float = 60.0, max_samples: int = 8192):
        self.window_s = float(window_s)
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._http: deque = deque(maxlen=self.max_samples)  # (t, route, ms, status)
        self._fills: Dict[str, deque] = {}  # model -> (t, filled, slots)

    def observe_http(self, route: str, ms: float, status: int,
                     now: Optional[float] = None) -> None:
        if route not in SLO_ROUTES:
            return
        t = time.monotonic() if now is None else now
        with self._lock:
            self._http.append((t, route, float(ms), int(status)))

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._http and self._http[0][0] < cutoff:
            self._http.popleft()
        for dq in self._fills.values():
            # keep one sample older than the window as the diff baseline
            while len(dq) > 1 and dq[1][0] < cutoff:
                dq.popleft()

    def export(self, registry: MetricsRegistry,
               model_registry=None, now: Optional[float] = None) -> None:
        t = time.monotonic() if now is None else now
        with self._lock:
            self._prune(t)
            samples = list(self._http)
        registry.gauge("slo/window_requests").set(len(samples))
        for route in SLO_ROUTES:
            lat = sorted(ms for (_, r, ms, s) in samples
                         if r == route and s < 400)
            if lat:
                registry.gauge(f"slo/window_{route}_p50_ms").set(
                    percentile(lat, 50))
                registry.gauge(f"slo/window_{route}_p99_ms").set(
                    percentile(lat, 99))
        if samples:
            statuses = [s for (_, _, _, s) in samples]
            registry.gauge("slo/window_error_rate").set(
                sum(s >= 500 for s in statuses) / len(statuses))
            registry.gauge("slo/window_shed_rate").set(
                sum(s == 429 for s in statuses) / len(statuses))
        if model_registry is None:
            return
        for name, entry in model_registry.items():
            registry.gauge(f"slo/model_{name}_queue_depth").set(
                entry.queue.depth())
            # cumulative slot counters -> windowed fill by differencing
            filled = float(entry.engine.metrics.batch_slots_filled)
            slots = float(entry.engine.metrics.batch_slots_total)
            with self._lock:
                dq = self._fills.setdefault(name, deque())
                if dq and (filled < dq[-1][1] or slots < dq[-1][2]):
                    # a replica restart reset the cumulative counters — the
                    # old samples can't be differenced against the new line;
                    # restart the window baseline at the reset point
                    dq.clear()
                dq.append((t, filled, slots))
                if len(dq) > self.max_samples:
                    dq.popleft()
                t0, f0, s0 = dq[0]
            if slots > s0:
                registry.gauge(f"slo/window_model_{name}_fill").set(
                    max((filled - f0) / (slots - s0), 0.0))


    def window_snapshot(self, now: Optional[float] = None
                        ) -> Dict[str, float]:
        """The window as a flat stats dict (same vocabulary the offline
        verdict speaks, ``window_requests`` added) — the shared input for
        the autoscaler and priority admission, so scale/shed decisions read
        exactly the numbers ``/metrics`` exports."""
        t = time.monotonic() if now is None else now
        with self._lock:
            self._prune(t)
            samples = list(self._http)
        out: Dict[str, float] = {"window_requests": float(len(samples))}
        for route in SLO_ROUTES:
            lat = sorted(ms for (_, r, ms, s) in samples
                         if r == route and s < 400)
            if lat:
                out[f"{route}_p50_ms"] = percentile(lat, 50)
                out[f"{route}_p99_ms"] = percentile(lat, 99)
        if samples:
            statuses = [s for (_, _, _, s) in samples]
            out["error_rate"] = sum(s >= 500 for s in statuses) / len(statuses)
            out["shed_rate"] = sum(s == 429 for s in statuses) / len(statuses)
        return out


def bench_verdict(spec: SLOSpec, stats: Dict[str, float]) -> Dict[str, Any]:
    """One-call convenience: evaluate + JSON verdict."""
    return results_json(evaluate(spec, stats))


__all__ = [
    "SLO_ROUTES", "SLORule", "SLOResult", "SLOSpec", "SLOMonitor",
    "stats_from_events", "stats_from_prometheus", "parse_prometheus",
    "evaluate", "breached", "verdict_table", "results_json", "bench_verdict",
]
