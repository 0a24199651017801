"""Turn an ``events.jsonl`` stream into a run report (port of
``distegnn_tpu/obs/report.py``; pure functions over parsed events, so tests
drive them without a file system):

  - :func:`load_events`: parse a JSONL file, counting (not failing on)
    garbage lines: a crashed run can tear its last line;
  - :func:`summarize`: step-time percentiles, the data-stall fraction,
    checkpoint activity, the fault timeline (divergence, rollback,
    preemption, resume, corrupt checkpoints) and per-rank event counts;
  - :func:`render_text`: the report;
  - :func:`check`: the gate: a zero-event stream fails (and a recompile
    after warmup, which the JAX package's streams can carry; an eager
    PyTorch run has none).

Run it as::

    python -m distegnn_tpu_torch.obs.report <exp_dir>/obs/events.jsonl \
        [--json] [--check]

The request waterfall and the SLO verdicts of ``scripts/obs_report.py``
wait for the serving fleet (ROADMAP.md queue 1 item 6).
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Render an obs events.jsonl stream as a run report.")
    ap.add_argument("events", help="path to an events.jsonl file")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the summary as JSON instead of text")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on zero events or recompiles after warmup")
    args = ap.parse_args(argv)
    if not os.path.exists(args.events):
        print(f"obs report: no such file: {args.events}", file=sys.stderr)
        return 2
    events, bad = load_events(args.events)
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
