"""Turn an ``events.jsonl`` stream into a run report (port of
``distegnn_tpu/obs/report.py``; pure functions over parsed events, so tests
drive them without a file system):

  - :func:`load_events`: parse a JSONL file, counting (not failing on)
    garbage lines: a crashed run can tear its last line;
    :func:`load_run_events` adds the sibling ``events_worker_*.jsonl``
    streams of serving worker children, so a request that crossed the
    process boundary stitches into one waterfall (``--request``);
  - :func:`summarize`: step-time percentiles, the data-stall fraction,
    checkpoint activity, the fault timeline (divergence, rollback,
    preemption, resume, corrupt checkpoints) and per-rank event counts;
  - :func:`render_text`: the report;
  - :func:`check`: the gate: a zero-event stream fails (and a recompile
    after warmup, which the JAX package's streams can carry; an eager
    PyTorch run has none);
  - :func:`stitch_request` / :func:`render_request`: one gateway request's
    waterfall, every span and event carrying its ``request_id`` (directly
    or through a batch's ``request_ids``) stitched into the queue -> batch
    -> compute timeline;
  - ``--slo``: an SLO spec (``obs/slo.py``) scored against the stream.

Run it as::

    python -m distegnn_tpu_torch.obs.report <exp_dir>/obs/events.jsonl \
        [--json] [--check] [--request <id>] [--slo <spec.yaml>]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter as _CCounter
from collections import defaultdict
from typing import Any, Dict, List, Tuple

from distegnn_tpu_torch.obs.metrics import percentile

# fault-timeline event names, in the order a reader wants them labeled
_FAULT_EVENTS = ("train/divergence", "train/rollback", "train/preempt",
                 "train/resume", "ckpt/corrupt")


def load_events(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Parse one JSONL file -> (events, n_bad_lines). A torn final line (the
    writer died mid-append) is counted, not fatal."""
    events, bad = [], 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if isinstance(rec, dict):
                events.append(rec)
            else:
                bad += 1
    return events, bad


def load_run_events(path: str) -> Tuple[List[Dict[str, Any]], int,
                                        List[str]]:
    """Load one run's FULL stream: the named file plus any sibling
    ``events_worker_*.jsonl`` files (serving worker children write their
    own sinks next to the parent's — ``serve/worker.py``), merged and
    ts-sorted so a request that crossed the process boundary stitches into
    one waterfall. Returns (events, n_bad_lines, files)."""
    import glob

    files = [path]
    sibling_glob = os.path.join(os.path.dirname(path) or ".",
                                "events_worker_*.jsonl")
    files.extend(sorted(p for p in glob.glob(sibling_glob) if p != path))
    events: List[Dict[str, Any]] = []
    bad = 0
    for p in files:
        evs, b = load_events(p)
        events.extend(evs)
        bad += b
    events.sort(key=lambda e: float(e.get("ts", 0.0)))
    return events, bad, files


def _named(events, name):
    return [e for e in events if e.get("name") == name]


def summarize(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    steps = _named(events, "train/step")
    epochs = _named(events, "train/epoch")
    # compiles and serve batches: carried by the JAX package's streams, so
    # the summary reads both packages' files alike
    compiles = _named(events, "jax/compile")
    saves = _named(events, "ckpt/save")
    restores = _named(events, "ckpt/restore")
    serve_batches = _named(events, "serve/batch")

    step_s = sorted(float(e["dur_s"]) for e in steps if "dur_s" in e)
    # stall fraction: time blocked waiting on the loader over total
    # (stall + step) time. Step events carry their own stall; a run without
    # them (obs.step_events: false) falls back to the per-epoch aggregates.
    stall_s = sum(float(e.get("stall_s", 0.0)) for e in steps)
    busy_s = sum(step_s) + stall_s
    if not steps and epochs:
        stall_s = sum(float(e.get("stall_s", 0.0)) for e in epochs)
        busy_s = sum(float(e.get("dur_s", 0.0)) for e in epochs)

    by_phase: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "dur_s": 0.0, "after_warmup": 0})
    for c in compiles:
        row = by_phase[str(c.get("phase", "?"))]
        row["count"] += 1
        row["dur_s"] += float(c.get("dur_s", 0.0))
        row["after_warmup"] += bool(c.get("after_warmup"))
    recompiles = sum(r["after_warmup"] for r in by_phase.values())

    faults = sorted((e for e in events if e.get("name") in _FAULT_EVENTS),
                    key=lambda e: e.get("ts", 0.0))

    serve_exec_ms = sorted(1e3 * float(e["dur_s"])
                           for e in serve_batches if "dur_s" in e)

    return {
        "n_events": len(events),
        "by_kind": dict(_CCounter(e.get("kind", "?") for e in events)),
        "by_proc": dict(_CCounter(int(e.get("proc", 0)) for e in events)),
        "steps": {
            "count": len(step_s),
            "p50_ms": round(1e3 * percentile(step_s, 50), 3),
            "p99_ms": round(1e3 * percentile(step_s, 99), 3),
            "total_s": round(sum(step_s), 4),
        },
        "epochs": {
            "count": len(epochs),
            "time_p50_s": round(percentile(
                sorted(float(e.get("dur_s", 0.0)) for e in epochs), 50), 4),
            "last_loss_train": (epochs[-1].get("loss_train")
                                if epochs else None),
        },
        "stall": {
            "stall_s": round(stall_s, 4),
            "fraction": round(stall_s / busy_s, 6) if busy_s > 0 else 0.0,
        },
        "compiles": {
            "total": len(compiles),
            "after_warmup": int(recompiles),
            "by_phase": {k: {"count": int(v["count"]),
                             "dur_s": round(v["dur_s"], 4),
                             "after_warmup": int(v["after_warmup"])}
                         for k, v in sorted(by_phase.items())},
        },
        "checkpoints": {
            "saves": len(saves),
            "save_bytes": int(sum(int(e.get("bytes", 0)) for e in saves)),
            "save_s": round(sum(float(e.get("dur_s", 0.0)) for e in saves), 4),
            "restores": len(restores),
        },
        "serve": {
            "batches": len(serve_batches),
            "exec_p50_ms": round(percentile(serve_exec_ms, 50), 3),
            "exec_p99_ms": round(percentile(serve_exec_ms, 99), 3),
        },
        "faults": [{k: e.get(k) for k in
                    ("ts", "name", "epoch", "step", "msg", "reason",
                     "lr_scale", "path") if k in e} for e in faults],
    }


def render_text(summary: Dict[str, Any], source: str = "",
                bad_lines: int = 0) -> str:
    s = summary
    lines = []
    lines.append(f"== obs run report{' — ' + source if source else ''} ==")
    lines.append(f"events: {s['n_events']} "
                 f"({', '.join(f'{k}={v}' for k, v in sorted(s['by_kind'].items()))})"
                 + (f", {bad_lines} unparseable line(s)" if bad_lines else ""))
    if len(s["by_proc"]) > 1:
        lines.append("per-process events: " + ", ".join(
            f"p{k}={v}" for k, v in sorted(s["by_proc"].items())))
    st = s["steps"]
    if st["count"]:
        lines.append(f"steps: {st['count']}  p50 {st['p50_ms']} ms  "
                     f"p99 {st['p99_ms']} ms  (host-observed dispatch)")
    ep = s["epochs"]
    if ep["count"]:
        lines.append(f"epochs: {ep['count']}  median {ep['time_p50_s']} s"
                     + (f"  last train loss {ep['last_loss_train']}"
                        if ep["last_loss_train"] is not None else ""))
    lines.append(f"data stall: {s['stall']['stall_s']} s "
                 f"({100 * s['stall']['fraction']:.2f}% of busy time)")
    c = s["compiles"]
    lines.append(f"compiles: {c['total']} total, "
                 f"{c['after_warmup']} AFTER WARMUP"
                 + (" <-- recompile bug, see table" if c["after_warmup"] else ""))
    if c["by_phase"]:
        lines.append("  phase                     compiles  after-warmup  compile-time")
        for phase, row in c["by_phase"].items():
            lines.append(f"  {phase:<25} {row['count']:>8}  "
                         f"{row['after_warmup']:>12}  {row['dur_s']:>10.3f} s")
    ck = s["checkpoints"]
    if ck["saves"] or ck["restores"]:
        lines.append(f"checkpoints: {ck['saves']} save(s) "
                     f"({ck['save_bytes']} B, {ck['save_s']} s), "
                     f"{ck['restores']} restore(s)")
    sv = s["serve"]
    if sv["batches"]:
        lines.append(f"serve: {sv['batches']} batch(es)  "
                     f"exec p50 {sv['exec_p50_ms']} ms  "
                     f"p99 {sv['exec_p99_ms']} ms")
    if s["faults"]:
        lines.append("fault timeline:")
        t0 = s["faults"][0].get("ts") or 0.0
        for f in s["faults"]:
            extra = ", ".join(f"{k}={v}" for k, v in f.items()
                              if k not in ("ts", "name") and v is not None)
            lines.append(f"  +{(f.get('ts') or 0.0) - t0:8.2f}s  "
                         f"{f.get('name')}" + (f"  ({extra})" if extra else ""))
    else:
        lines.append("fault timeline: clean (no divergence/preempt/corrupt events)")
    return "\n".join(lines) + "\n"


def _touches(rec: Dict[str, Any], request_id: str) -> bool:
    """True when a record belongs to the request: its own ``request_id``
    attr (http span, prep event) or membership in a batch-level
    ``request_ids`` list (serve/batch, serve/execute)."""
    if rec.get("request_id") == request_id:
        return True
    ids = rec.get("request_ids")
    return isinstance(ids, (list, tuple)) and request_id in ids


def request_ids_seen(events: List[Dict[str, Any]]) -> List[str]:
    """All distinct request ids in the stream, in first-seen order."""
    seen: Dict[str, None] = {}
    for e in events:
        rid = e.get("request_id")
        if isinstance(rid, str):
            seen.setdefault(rid)
        for rid in (e.get("request_ids") or []):
            if isinstance(rid, str):
                seen.setdefault(rid)
    return list(seen)


def stitch_request(events: List[Dict[str, Any]],
                   request_id: str) -> Dict[str, Any]:
    """Reconstruct one request's life from the event stream alone.

    Returns records (ts-sorted), per-phase durations, and the stitched
    total. ``queue_ms`` comes out of the serve/batch event's per-member
    list (position-aligned with ``request_ids``); the stitched total is
    prep + queue-wait + batch compute, which the transport's reported
    ``total_ms`` upper-bounds (it adds response encode + thread wakeup).
    ``complete`` is True when the queue -> batch -> compute chain is all
    present (http span + batch event with a queue slot + execute span).
    """
    recs = sorted((e for e in events if _touches(e, request_id)),
                  key=lambda e: float(e.get("ts", 0.0)))
    http = next((e for e in recs if e.get("name") == "serve/http"), None)
    batches = [e for e in recs if e.get("name") == "serve/batch"]
    execs = [e for e in recs if e.get("name") == "serve/execute"]
    preps = [e for e in recs if e.get("name") == "serve/prep"]
    queue_ms = None
    for b in batches:
        ids = b.get("request_ids") or []
        qs = b.get("queue_ms") or []
        if request_id in ids and len(qs) == len(ids):
            queue_ms = float(qs[ids.index(request_id)])
            break
    prep_ms = round(sum(1e3 * float(e.get("dur_s", 0.0)) for e in preps), 3)
    compute_ms = round(sum(1e3 * float(e.get("dur_s", 0.0))
                           for e in batches), 3)
    execute_ms = round(sum(1e3 * float(e.get("dur_s", 0.0))
                           for e in execs), 3)
    http_ms = (round(1e3 * float(http.get("dur_s", 0.0)), 3)
               if http is not None else None)
    stitched_ms = round((queue_ms or 0.0) + prep_ms + compute_ms, 3)
    return {
        "request_id": request_id,
        "records": recs,
        "phases": {"prep_ms": prep_ms if preps else None,
                   "queue_ms": queue_ms, "compute_ms": compute_ms,
                   "execute_ms": execute_ms, "http_ms": http_ms},
        "stitched_ms": stitched_ms,
        "complete": bool(http is not None and queue_ms is not None
                         and batches and execs),
    }


def render_request(stitched: Dict[str, Any], source: str = "") -> str:
    """The waterfall: one row per record the request touched, offsets
    relative to the earliest span start (span ts is emitted at EXIT, so
    start = ts - dur_s), plus a synthetic queue-wait row ahead of the
    batch it resolved in."""
    rid = stitched["request_id"]
    recs = stitched["records"]
    lines = [f"== request {rid} — queue -> batch -> compute waterfall"
             f"{' — ' + source if source else ''} =="]
    if not recs:
        lines.append("no spans or events carry this request id")
        return "\n".join(lines) + "\n"
    http = next((e for e in recs if e.get("name") == "serve/http"), None)
    if http is not None:
        lines.append(f"route={http.get('route')} method={http.get('method')} "
                     f"status={http.get('status')} proc={http.get('proc')}")

    def _start(rec):
        return float(rec.get("ts", 0.0)) - float(rec.get("dur_s", 0.0))

    rows = []
    for rec in recs:
        detail = ", ".join(
            f"{k}={rec[k]}" for k in ("route", "status", "session", "hit",
                                      "filled", "capacity", "n", "e",
                                      "workload", "steps", "retry")
            if rec.get(k) is not None)
        rows.append((_start(rec), rec.get("name", "?"),
                     1e3 * float(rec.get("dur_s", 0.0)), detail))
        if rec.get("name") == "serve/batch":
            ids = rec.get("request_ids") or []
            qs = rec.get("queue_ms") or []
            if rid in ids and len(qs) == len(ids):
                q = float(qs[ids.index(rid)])
                rows.append((_start(rec) - q / 1e3, "[queue wait]", q, ""))
    rows.sort(key=lambda r: r[0])
    t0 = rows[0][0]
    lines.append(f"  {'offset':>12}  {'span/event':<16} {'dur':>11}  detail")
    for start, name, dur_ms, detail in rows:
        lines.append(f"  {1e3 * (start - t0):>+9.3f} ms  {name:<16} "
                     f"{dur_ms:>8.3f} ms" + (f"  {detail}" if detail else ""))
    ph = stitched["phases"]
    parts = [f"queue {ph['queue_ms']} ms" if ph["queue_ms"] is not None
             else "queue ?"]
    if ph["prep_ms"] is not None:
        parts.insert(0, f"prep {ph['prep_ms']} ms")
    parts.append(f"compute {ph['compute_ms']} ms")
    lines.append(f"stitched: {' + '.join(parts)} = {stitched['stitched_ms']}"
                 f" ms" + (f"  (http span {ph['http_ms']} ms)"
                           if ph["http_ms"] is not None else ""))
    lines.append("status: " + ("complete (queue -> batch -> compute all "
                               "reconstructed)" if stitched["complete"]
                               else "INCOMPLETE — a leg is missing from the "
                               "stream (shed/timeout, or obs was disabled "
                               "in part of the stack)"))
    return "\n".join(lines) + "\n"


def check(summary: Dict[str, Any]) -> List[str]:
    """The gate's failures (an empty list passes)."""
    fails = []
    if summary["n_events"] == 0:
        fails.append("zero events: the run produced no telemetry "
                     "(obs disabled, or the instrumented paths never ran)")
    after = summary["compiles"]["after_warmup"]
    if after:
        fails.append(f"{after} recompile(s) after warmup — a shape/dtype "
                     "drifted past its compiled bucket (see the recompile "
                     "table; recompiles silently eat step time)")
    return fails


def _report_request(events, rid: str, source: str, as_json: bool) -> int:
    stitched = stitch_request(events, rid)
    if not stitched["records"]:
        known = request_ids_seen(events)
        print(f"obs report: request {rid!r} not found in {source} "
              f"({len(known)} id(s) present"
              + (f", e.g. {known[0]!r}" if known else "") + ")",
              file=sys.stderr)
        return 1
    if as_json:
        print(json.dumps(stitched, sort_keys=True, default=str))
    else:
        print(render_request(stitched, source=source), end="")
    return 0


def _report_slo(events, spec_path: str, source: str, as_json: bool) -> int:
    from distegnn_tpu_torch.obs import slo as slomod

    if not os.path.exists(spec_path):
        print(f"obs report: no such SLO spec: {spec_path}", file=sys.stderr)
        return 2
    spec = slomod.SLOSpec.from_file(spec_path)
    results = slomod.evaluate(spec, slomod.stats_from_events(events))
    if as_json:
        print(json.dumps(slomod.results_json(results), sort_keys=True))
    else:
        print(slomod.verdict_table(results, source=source), end="")
    return 1 if slomod.breached(results) else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Render an obs events.jsonl stream as a run report.")
    ap.add_argument("events", help="path to an events.jsonl file")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the summary as JSON instead of text")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on zero events or recompiles after warmup")
    ap.add_argument("--request", metavar="ID", default=None,
                    help="render one gateway request's waterfall instead "
                         "(exit 1 when the stream does not carry it)")
    ap.add_argument("--slo", metavar="SPEC", default=None,
                    help="score an SLO spec (YAML/JSON, the slo: section) "
                         "against the stream (exit 1 on a breach)")
    args = ap.parse_args(argv)
    if not os.path.exists(args.events):
        print(f"obs report: no such file: {args.events}", file=sys.stderr)
        return 2
    events, bad = load_events(args.events)
    if args.request is not None:
        # the waterfall crosses into worker children: read their streams
        events = load_run_events(args.events)[0]
        return _report_request(events, args.request, args.events,
                               args.as_json)
    if args.slo is not None:
        return _report_slo(events, args.slo, args.events, args.as_json)
    summary = summarize(events)
    if args.as_json:
        print(json.dumps({**summary, "bad_lines": bad}, sort_keys=True))
    else:
        print(render_text(summary, source=args.events, bad_lines=bad),
              end="")
    if args.check:
        fails = check(summary)
        for f in fails:
            print(f"obs report --check FAIL: {f}", file=sys.stderr)
        if fails:
            return 1
        print("obs report --check: OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
