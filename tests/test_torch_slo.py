"""The port's SLO layer (``obs/slo.py``) and the report's request waterfall
and SLO verdict (``obs/report.py``) on the CPU, held against the JAX
package's ``obs/slo.py`` and ``obs/report.py`` on the same inputs.

Bound: exact equality everywhere (stats, results, verdict text, window
snapshots under the same synthetic clock, the stitched waterfall).
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import json
import os

import numpy as np
import pytest

from distegnn_tpu.obs import report as jreport
from distegnn_tpu.obs import slo as jslo
from distegnn_tpu.obs.metrics import MetricsRegistry as JRegistry
from distegnn_tpu_torch.obs import report as preport
from distegnn_tpu_torch.obs import slo as pslo
from distegnn_tpu_torch.obs.metrics import MetricsRegistry as PRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(REPO, "configs", "slo_default.yaml")


def _stream(seed=0, n=60):
    """A synthetic gateway event stream: http spans on both routes with a
    mix of statuses, batch events carrying request ids and queue waits,
    execute spans and session prep events."""
    rng = np.random.default_rng(seed)
    ev, t = [], 100.0
    for i in range(n):
        rid = f"r{i:03d}"
        route = "predict" if i % 3 else "rollout"
        status = int(rng.choice([200, 200, 200, 200, 429, 504, 500, 400]))
        q = float(np.round(rng.uniform(0, 5), 3))
        dur = float(np.round(rng.uniform(0.001, 0.2), 6))
        t += dur
        if i % 4 == 0:
            ev.append({"ts": t - dur, "kind": "event", "name": "serve/prep",
                       "session": f"s{i % 5}", "hit": bool(i % 8),
                       "dur_s": 0.0004, "request_id": rid})
        ev.append({"ts": t - 0.001, "kind": "event", "name": "serve/batch",
                   "n": 64, "e": 256, "filled": 1 + i % 4, "capacity": 4,
                   "workload": route, "dur_s": dur / 2,
                   "request_ids": [rid, f"x{i}"], "queue_ms": [q, 0.5]})
        ev.append({"ts": t - 0.0005, "kind": "span", "name": "serve/execute",
                   "n": 64, "e": 256, "filled": 2, "capacity": 4,
                   "dur_s": dur / 3, "request_ids": [rid]})
        ev.append({"ts": t, "kind": "span", "name": "serve/http",
                   "route": route, "method": "POST", "status": status,
                   "dur_s": dur, "request_id": rid, "proc": 0})
    ev.append({"ts": t, "kind": "span", "name": "serve/http",
               "route": "metrics", "status": 200, "dur_s": 0.001})
    return ev


SPECS = [
    {"window_s": 30.0, "routes": {"predict": {"p50_ms": 80.0,
                                              "p99_ms": 150.0},
                                  "rollout": {"p99_ms": 500.0}},
     "error_rate_max": 0.1, "shed_rate_max": 0.2, "batch_fill_min": 0.5,
     "session_hit_min": 0.9},
    {"slo": {"routes": {}, "error_rate_max": 0.5}},
    {"routes": {"rollout": {"p50_ms": 1.0}}, "batch_fill_min": 0.99},
]

BAD = [{"window_s": 0},
       {"routes": {"train": {"p99_ms": 1.0}}},
       {"routes": {"predict": {"p95_ms": 1.0}}},
       {"routes": {"predict": {"p99_ms": -1.0}}},
       {"routes": {"predict": 5}},
       {"shed_rate_max": 1.5},
       {"batch_fill_min": -0.1},
       {"error_rate_maxx": 0.1}]


def _err(fn):
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("d", BAD, ids=[str(i) for i in range(len(BAD))])
def test_spec_validation_matches_jax(d):
    want = _err(lambda: jslo.SLOSpec.from_mapping(dict(d)))
    assert want is not None
    assert _err(lambda: pslo.SLOSpec.from_mapping(dict(d))) == want


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_stats_results_and_verdict_match_jax(i):
    events = _stream(seed=i)
    stats = pslo.stats_from_events(events)
    assert stats == jslo.stats_from_events(events)
    assert set(stats) == {"predict_p50_ms", "predict_p99_ms",
                          "rollout_p50_ms", "rollout_p99_ms", "error_rate",
                          "shed_rate", "batch_fill", "session_hit_rate"}
    pspec = pslo.SLOSpec.from_mapping(SPECS[i])
    jspec = jslo.SLOSpec.from_mapping(SPECS[i])
    assert [tuple(r) for r in pspec.rules()] == \
        [tuple(r) for r in jspec.rules()]
    pres, jres = pslo.evaluate(pspec, stats), jslo.evaluate(jspec, stats)
    assert [(tuple(r.rule), r.observed, r.ok) for r in pres] == \
        [(tuple(r.rule), r.observed, r.ok) for r in jres]
    assert pslo.verdict_table(pres, "s") == jslo.verdict_table(jres, "s")
    assert pslo.results_json(pres) == jslo.results_json(jres)
    assert pslo.bench_verdict(pspec, stats) == \
        jslo.bench_verdict(jspec, stats)
    assert pslo.breached(pres) == jslo.breached(jres)


def test_no_data_is_reported_never_a_breach():
    spec = pslo.SLOSpec.from_mapping(SPECS[0])
    res = pslo.evaluate(spec, {})
    assert all(r.ok is None for r in res) and not pslo.breached(res)
    assert pslo.verdict_table(res) == jslo.verdict_table(
        jslo.evaluate(jslo.SLOSpec.from_mapping(SPECS[0]), {}))


def test_prometheus_scrape_stats_match_jax():
    stats = {}
    for mod, Reg in ((pslo, PRegistry), (jslo, JRegistry)):
        reg = Reg()
        for name, v in (("gateway/requests_total", 40),
                        ("gateway/errors", 3), ("gateway/timeouts", 1),
                        ("gateway/shed_inflight", 2),
                        ("gateway/shed_queue_full", 4)):
            reg.counter(name).add(v)
        lat = reg.reservoir("gateway/http_predict_ms")
        lat.record_many([float(x) for x in range(1, 30)])
        model = Reg()
        model.counter("serve/batch_slots_filled").add(9)
        model.counter("serve/batch_slots_total").add(16)
        model.counter("serve/session_hits").add(3)
        model.counter("serve/session_misses").add(1)
        text = (reg.render_prometheus(prefix="distegnn")
                + model.render_prometheus(prefix="distegnn_model_nbody"))
        stats[mod.__name__] = (mod.parse_prometheus(text),
                               mod.stats_from_prometheus(text),
                               mod.stats_from_prometheus(text, ["nbody"]))
    assert stats[pslo.__name__] == stats[jslo.__name__]
    assert stats[pslo.__name__][1]["batch_fill"] == 0.5625


class _Entry:
    """A model entry as SLOMonitor.export reads it: queue depth and the
    cumulative slot counters of its metrics."""

    def __init__(self):
        self.queue = type("Q", (), {"depth": lambda s: 3})()
        self.engine = type("E", (), {})()
        self.engine.metrics = type("M", (), {})()


class _Registry:
    def __init__(self, entry):
        self.entry = entry

    def items(self):
        return [("nbody", self.entry)]


def test_monitor_window_under_a_synthetic_clock_matches_jax():
    out = {}
    for mod, Reg in ((pslo, PRegistry), (jslo, JRegistry)):
        mon = mod.SLOMonitor(window_s=10.0)
        reg, entry = Reg(), _Entry()
        snaps = []
        rng = np.random.default_rng(3)
        for step in range(40):
            now = 1000.0 + 0.5 * step
            route = ("predict", "rollout", "metrics")[step % 3]
            mon.observe_http(route, float(rng.uniform(1, 50)),
                             int(rng.choice([200, 429, 503])), now=now)
            entry.engine.metrics.batch_slots_filled = 2 * step
            entry.engine.metrics.batch_slots_total = 4 * step
            mon.export(reg, _Registry(entry), now=now)
            snaps.append(mon.window_snapshot(now=now + 0.25))
        out[mod.__name__] = (snaps, reg.snapshot())
    assert out[pslo.__name__] == out[jslo.__name__]
    assert out[pslo.__name__][1]["slo/model_nbody_queue_depth"] == 3


def test_request_waterfall_matches_jax():
    events = _stream(seed=7)
    for rid in ("r000", "r013", "missing"):
        ps = preport.stitch_request(events, rid)
        js = jreport.stitch_request(events, rid)
        assert ps == js
        assert preport.render_request(ps, "x") == \
            jreport.render_request(js, "x")
    assert preport.request_ids_seen(events) == \
        jreport.request_ids_seen(events)
    assert preport.stitch_request(events, "r004")["complete"]


def test_report_cli_scores_a_spec_and_renders_a_request(tmp_path, capsys):
    path = tmp_path / "events.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in _stream(seed=1)))
    want = jslo.bench_verdict(jslo.SLOSpec.from_file(SPEC),
                              jslo.stats_from_events(_stream(seed=1)))
    rc = preport.main([str(path), "--slo", SPEC, "--json"])
    assert json.loads(capsys.readouterr().out) == want
    assert rc == (0 if want["pass"] else 1)
    assert preport.main([str(path), "--request", "r002"]) == 0
    assert capsys.readouterr().out == jreport.render_request(
        jreport.stitch_request(_stream(seed=1), "r002"), str(path))
    assert preport.main([str(path), "--request", "nope"]) == 1
    assert "not found" in capsys.readouterr().err
    assert preport.main([str(path), "--slo", str(tmp_path / "no.yaml")]) == 2
