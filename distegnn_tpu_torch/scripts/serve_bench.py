"""Serving benchmark: open-loop synthetic load through the serve stack (the
port's counterpart of ``scripts/serve_bench.py``).

Drives RequestQueue -> InferenceEngine with a fixed-rate arrival process
(OPEN loop: arrival k is scheduled at t0 + k/rate regardless of completions,
so queueing delay is measured honestly — a closed loop would self-throttle)
over graphs of several distinct sizes, then prints ONE BENCH-style JSON line:

  {"metric": "serve_throughput", "value": <req/s>, "unit": "req/s",
   "vs_baseline": null, "snapshot": {<ServeMetrics snapshot>}, ...}

    python -m distegnn_tpu_torch.scripts.serve_bench \\
        --config_path configs/nbody_serve.yaml --requests 64 --rate 200 \\
        --sizes 48,96,192 [--device cpu]

The model runs on the card unless ``--device cpu`` asks for the plain
PyTorch path; without a card the default raises. Its parameters are drawn
from the config's seed (``serve.engine_with_params_from_config``); the
synthetic graphs from ``--seed``.

``--transport http`` runs the SAME open loop through a real socket: an
in-process HTTP gateway (serve/transport.py) on an ephemeral port, each
arrival a POST /v1/models/bench/predict from a client thread (base64 f32
payloads), so the BENCH line includes JSON+HTTP+routing overhead — the
number a network client actually sees. Stdout stays exactly one line.

``--workload rollout`` benches the K-step rollout path instead: it first
measures a sequential B=1 baseline (engine.rollout per scene), then drives
the same scenes through RequestQueue.submit_rollout so the micro-batcher
coalesces them into batched forwards (engine.rollout_batch), and reports
batched scenes*steps/s with the B=1 number as the in-run baseline. Both
paths run once before the timed windows (the kernels build on first use).

The warmup boundary: eager PyTorch compiles nothing per shape, so where the
JAX script marks the end of its compile warmup this one writes a
``jax/memory`` event (``obs/cudaprobe.py``, phase ``serve_warmup_done``).

Obs: the run's structured event stream lands at
--obs-dir/obs/events.jsonl (default logs/serve_bench/); render it with
``python -m distegnn_tpu_torch.obs.report <path>``. Stdout stays EXACTLY
one JSON line — the obs pointer goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# the synthetic-graph geometry of the rollout workload when the config has
# no serve.rollout (max_degree clears the densest default scene, n=192 at
# degree 44, plus drift headroom)
ROLLOUT_DEFAULTS = {"radius": 0.35, "max_degree": 96, "max_per_cell": 128,
                    "edge_block": 256}


def _build(cfg, sizes, seed, device):
    from distegnn_tpu_torch.serve import (engine_with_params_from_config,
                                          queue_from_config, synthetic_graph)

    feat_nf = int(cfg.model.node_feat_nf)
    edge_nf = int(cfg.model.edge_attr_nf)
    graphs = [synthetic_graph(n, seed=seed + i, feat_nf=feat_nf,
                              edge_attr_nf=edge_nf)
              for i, n in enumerate(sizes)]
    _, engine = engine_with_params_from_config(cfg, device=device)
    return engine, queue_from_config(cfg, engine), graphs


def _b64_field(a, dtype):
    import base64

    import numpy as np

    a = np.ascontiguousarray(a, dtype=dtype)
    return {"b64": base64.b64encode(a.tobytes()).decode("ascii"),
            "shape": list(a.shape)}


def predict_payload(g, session_id=None) -> bytes:
    """A predict request body of graph ``g`` (base64 little-endian fields);
    ``session_id`` pins it to a session of the prep cache."""
    body = {
        "positions": _b64_field(g["loc"], "<f4"),
        "velocities": _b64_field(g["vel"], "<f4"),
        "node_feat": _b64_field(g["node_feat"], "<f4"),
        "edge_attr": _b64_field(g["edge_attr"], "<f4"),
        "edge_index": _b64_field(g["edge_index"], "<i4"),
        "encoding": "b64",
    }
    if session_id is not None:
        body["session_id"] = str(session_id)
    return json.dumps(body).encode()


def _open_loop(n, rate, fire):
    """Call ``fire(k)`` at t0 + k/rate for k < n; returns t0."""
    t0 = time.perf_counter()
    for k in range(n):
        delay = t0 + k / rate - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        fire(k)
    return t0


def _run_http(engine, q, graphs, requests, rate):
    """The same open loop, but every arrival is a POST through a live
    in-process gateway socket. Returns (wall_s, rejected_429, statuses)."""
    import threading
    import urllib.error
    import urllib.request

    from distegnn_tpu_torch.serve.registry import ModelRegistry
    from distegnn_tpu_torch.serve.transport import Gateway

    q.start()
    registry = ModelRegistry.single(
        "bench", engine, q, feat_nf=graphs[0]["node_feat"].shape[1],
        edge_attr_nf=graphs[0]["edge_attr"].shape[1])
    gw = Gateway(registry, port=0, max_inflight=max(64, requests))
    server = threading.Thread(target=gw.serve_forever,
                              name="bench-gateway", daemon=True)
    server.start()
    url = gw.url("/v1/models/bench/predict")
    payloads = [predict_payload(g) for g in graphs]
    statuses = [0] * requests

    def post(i, body):
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"},
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=120.0) as resp:
                statuses[i] = int(resp.status)
        except urllib.error.HTTPError as e:
            statuses[i] = int(e.code)
        except Exception:
            statuses[i] = -1

    threads = []

    def fire(k):
        t = threading.Thread(target=post,
                             args=(k, payloads[k % len(payloads)]),
                             daemon=True)
        t.start()
        threads.append(t)

    t0 = _open_loop(requests, rate, fire)
    for t in threads:
        t.join(timeout=180.0)
    wall = time.perf_counter() - t0
    gw.drain()               # also stops the queue (drain=True)
    server.join(timeout=30.0)
    gw.close()
    rejected = sum(1 for s in statuses if s == 429)
    return wall, rejected, statuses


def _mark_warmup_done():
    from distegnn_tpu_torch.obs import cudaprobe

    cudaprobe.emit_memory_event(phase="serve_warmup_done")


def _run_rollout(engine, q, graphs, scenes_n, steps, rate, warmup=True):
    """Rollout workload: same-run B=1 baseline, then the batched path.

    The B=1 baseline is the serve path WITHOUT request coalescing: each
    scene still runs the rung's max_batch-padded forward, filled by a
    single real scene. The batched window drives the same scenes through
    ``RequestQueue.submit_rollout`` so the micro-batcher fills the padded
    batches. A third number, ``solo``, is the unpadded single-scene call —
    the pre-batching client API — reported for transparency.

    Returns (batched_rate, b1_rate, solo_rate, wall_batched, wall_b1,
    rejected, completed) where rates are scenes*steps per second."""
    scenes = [{"loc": graphs[i % len(graphs)]["loc"],
               "vel": graphs[i % len(graphs)]["vel"], "steps": steps}
              for i in range(scenes_n)]
    if warmup:
        # build the kernels and run BOTH paths outside the timed windows
        engine.rollout(scenes[0]["loc"], scenes[0]["vel"], steps)
        engine.rollout_batch([scenes[0]])
    _mark_warmup_done()

    t0 = time.perf_counter()
    for s in scenes:
        engine.rollout(s["loc"], s["vel"], steps)
    wall_solo = time.perf_counter() - t0

    t0 = time.perf_counter()
    for s in scenes:
        engine.rollout_batch([s])    # fill=1: uncoalesced serve path
    wall_b1 = time.perf_counter() - t0

    rejected = 0
    completed = 0
    futures = []

    def fire(k):
        nonlocal rejected
        try:
            futures.append(q.submit_rollout(scenes[k]))
        except Exception:    # QueueFullError: open loop sheds
            rejected += 1

    with q:
        t0 = _open_loop(scenes_n, rate, fire)
        for f in futures:
            try:
                f.result(timeout=300.0)
                completed += 1
            except Exception:
                pass  # failures are visible in the snapshot counters
    wall_batched = time.perf_counter() - t0

    # the headline only credits scenes that actually finished — a queue that
    # sheds by timeout must not report the shed work as throughput
    work = scenes_n * steps
    return (completed * steps / max(wall_batched, 1e-9),
            work / max(wall_b1, 1e-9), work / max(wall_solo, 1e-9),
            wall_batched, wall_b1, rejected, completed)


def _point_at_events(obs):
    tracer = obs.get_tracer()
    tracer.flush()
    w = getattr(tracer, "writer", None)
    if w is not None:
        # stderr: stdout is contractually the single JSON line
        print(f"obs: events at {w.path}; render with python -m "
              f"distegnn_tpu_torch.obs.report {w.path}",
              file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distegnn_tpu_torch.scripts.serve_bench",
        description="serve-stack open-loop bench")
    ap.add_argument("--config_path", type=str, default=None,
                    help="YAML with a serve: section (default: built-ins)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="arrival rate, req/s (open loop)")
    ap.add_argument("--sizes", type=str, default="48,96,192",
                    help="comma-separated node counts of the synthetic mix")
    ap.add_argument("--seed", type=int, default=43)
    ap.add_argument("--no-warmup", action="store_true",
                    help="include the first requests (the kernels' build "
                         "and first launches) in the timed window")
    ap.add_argument("--obs-dir", type=str, default="logs/serve_bench",
                    help="event-stream sink dir (events land at <dir>/obs/"
                         "events.jsonl); '' disables tracing")
    ap.add_argument("--transport", choices=("inproc", "http"),
                    default="inproc",
                    help="inproc = RequestQueue.submit directly; http = "
                         "through a live gateway socket (serve/transport.py)")
    ap.add_argument("--workload", choices=("predict", "rollout"),
                    default="predict",
                    help="predict = one model step per request; rollout = "
                         "K-step scenes through the rollout batcher, with a "
                         "same-run B=1 baseline")
    ap.add_argument("--rollout-steps", type=int, default=8,
                    help="steps K of each rollout scene")
    ap.add_argument("--rollout-scenes", type=int, default=8,
                    help="number of rollout scenes per timed window")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="override serve.max_batch (the bound of every "
                         "padded batch)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from distegnn_tpu_torch import obs, resolve_device
    from distegnn_tpu_torch.config import (_DEFAULTS, ConfigDict,
                                           load_config)

    device = resolve_device(args.device)
    cfg = (load_config(args.config_path) if args.config_path
           else ConfigDict(_DEFAULTS))
    if args.max_batch is not None:
        cfg.serve.max_batch = int(args.max_batch)
    if args.workload == "rollout" and not cfg.serve.get("rollout"):
        cfg.serve.rollout = dict(ROLLOUT_DEFAULTS)
    if args.workload == "rollout":
        # the rollout bench measures coalescing, not SLO shedding: the
        # coalescing window must cover the whole submit ramp (scenes/rate)
        # and a K-step CPU batch can take minutes — a serving-tuned 1 s
        # request timeout would shed every queued scene mid-measure and
        # quietly turn the headline into a timeout benchmark
        ramp_ms = 1000.0 * args.rollout_scenes / max(args.rate, 1e-9)
        cfg.serve.batch_deadline_ms = max(
            float(cfg.serve.batch_deadline_ms), ramp_ms + 50.0)
        cfg.serve.request_timeout_ms = max(
            float(cfg.serve.request_timeout_ms), 600_000.0)
    if args.obs_dir:
        obs.configure_from_config(cfg, args.obs_dir,
                                  tags={"run": "serve_bench"})
    sizes = [int(s) for s in args.sizes.split(",") if s]
    engine, q, graphs = _build(cfg, sizes, args.seed, device)

    if args.workload == "rollout":
        if args.transport == "http":
            print("serve_bench: --workload rollout runs inproc "
                  "(submit_rollout); ignoring --transport http",
                  file=sys.stderr)
        obs.event("serve/bench_start", requests=args.rollout_scenes,
                  rate=args.rate, sizes=sizes, workload="rollout",
                  steps=args.rollout_steps)
        batched, base, solo, wall_b, wall_1, rejected, completed = \
            _run_rollout(
                engine, q, graphs, args.rollout_scenes, args.rollout_steps,
                args.rate, warmup=not args.no_warmup)
        snap = engine.metrics.snapshot()
        rec = {
            "metric": "serve_rollout_throughput",
            "value": round(batched, 3),
            "unit": "scenes*steps/s",
            # baseline_b1 = the uncoalesced serve path: one fill-1
            # max_batch-padded call per scene. baseline_solo = the unpadded
            # single-scene client API, for transparency.
            "vs_baseline": round(batched / max(base, 1e-9), 3),
            "baseline_b1": round(base, 3),
            "baseline_solo": round(solo, 3),
            "scenes": args.rollout_scenes,
            "scenes_completed": completed,
            "steps": args.rollout_steps,
            "max_batch": engine.max_batch,
            "rejected_at_submit": rejected,
            "offered_rate": args.rate,
            "sizes": sizes,
            "wall_s": round(wall_b, 4),
            "wall_b1_s": round(wall_1, 4),
            "platform": device.type,
            "snapshot": snap,
        }
        print(json.dumps(rec, sort_keys=True))
        obs.event("bench/result", **rec)
        _point_at_events(obs)
        return 0 if snap["requests_completed"] else 1

    if not args.no_warmup:
        engine.warmup([(g["loc"].shape[0], g["edge_index"].shape[1])
                       for g in graphs])
    _mark_warmup_done()
    obs.event("serve/bench_start", requests=args.requests, rate=args.rate,
              sizes=sizes, warmup=not args.no_warmup,
              transport=args.transport)

    if args.transport == "http":
        wall, rejected, _statuses = _run_http(engine, q, graphs,
                                              args.requests, args.rate)
    else:
        futures, rejected = [], 0

        def fire(k):
            nonlocal rejected
            try:
                futures.append(q.submit(graphs[k % len(graphs)]))
            except Exception:  # QueueFullError: open loop sheds
                rejected += 1

        with q:
            t0 = _open_loop(args.requests, args.rate, fire)
            for f in futures:
                try:
                    f.result(timeout=60.0)
                except Exception:
                    pass  # failures are visible in the snapshot counters
        wall = time.perf_counter() - t0

    snap = engine.metrics.snapshot()
    completed = snap["requests_completed"]
    rec = {
        "metric": "serve_throughput",
        "value": round(completed / max(wall, 1e-9), 3),
        "unit": "req/s",
        "vs_baseline": None,
        "requests": args.requests,
        "rejected_at_submit": rejected,
        "offered_rate": args.rate,
        "sizes": sizes,
        "transport": args.transport,
        "wall_s": round(wall, 4),
        "platform": device.type,
        "snapshot": snap,
    }
    print(json.dumps(rec, sort_keys=True))
    obs.event("bench/result", **rec)
    _point_at_events(obs)
    return 0 if completed else 1


if __name__ == "__main__":
    raise SystemExit(main())
