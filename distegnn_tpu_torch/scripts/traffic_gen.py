"""Mixed-traffic replay harness: open-loop predict/session/rollout load
against a live gateway socket (the port's counterpart of
``scripts/traffic_gen.py``).

Replays a configurable traffic mix (``--mix predict=0.6,session=0.3,
rollout=0.1``) across every served model, with heavy-tailed graph sizes
drawn from the shape ladder (``--sizes`` is the rung support; rung k is
picked with weight 1/(k+1)^--tail, so most traffic is small and the tail
is large) and BURSTY arrivals: a Poisson process (mean ``--rate`` req/s)
gated by an on/off modulator (exponential ON phases of mean
``--burst-on-s`` separated by exponential OFF gaps of mean
``--burst-off-s``; ``--burst-off-s 0`` degenerates to pure Poisson). The
loop is OPEN: arrival k fires at its scheduled time regardless of
completions, so queueing delay and shedding are measured honestly. The
schedule and the mix come from ``random.Random(--seed)`` exactly as the
JAX script draws them, so one seed gives both harnesses the same plan.

``--profile steady|ramp|spike10x`` replaces the burst modulator with a
phased schedule (steady: flat Poisson; ramp: 0.5x -> 1x -> 2x thirds;
spike10x: 1x -> 10x -> 1x with half the requests inside the spike), tags
every request with its phase, and adds per-phase p50/p99 — overall AND
interactive-only (predict+session; rollouts are the bulk class) — plus a
per-phase SLO verdict to the BENCH record. ``--autoscale
'max_replicas=3,queue_high=2'`` turns the in-process gateway's replica
autoscaler on (keys from serve.autoscale:, ``serve/autoscale.py``; bare
``--autoscale on`` enables it with config defaults) and
``--scale-settle-s`` holds the gateway open after the replay until the
fleet shrinks back to min_replicas.

Traffic classes:
  predict   fresh synthetic graph per request -> POST .../predict
  session   requests drawn from a pool of --sessions sticky ids, each
            pinned to ONE fixed graph -> POST .../predict with
            ``session_id`` (exercises the prep/session cache)
  rollout   K-step scene (--rollout-steps) -> POST .../rollout; routed
            only to rollout-capable models (folded into predict, with a
            stderr note, when none is)

Every request carries ``X-Request-Id: tg-<seed>-<k>``, so any request in
the run can be replayed as a waterfall: ``python -m
distegnn_tpu_torch.obs.report <events> --request tg-<seed>-<k>``.

Target: ``--url http://host:port`` drives an already-running gateway (for
instance ``python -m distegnn_tpu_torch.serve.gateway``; models discovered
via GET /v1/models); without ``--url`` the script boots an in-process
gateway from ``--config_path`` (default built-ins) on ``--device`` (the
card by default; ``cpu`` for the plain path) on an ephemeral port and still
drives it over the real socket.

Chaos: ``--chaos 'kill@0.3:replica=0;swap@1.0:ckpt=/p/b.ckpt'`` fires
serving faults at fixed offsets into the replay through
``distegnn_tpu_torch.testing.serve_faults`` (kill / wedge / latency /
corrupt; swap POSTs the blue/green hot-swap through the socket and then
fires a fixed probe predict whose prediction lands in a
``chaos/swap_probe`` event; under ``serve.workers: process`` also kill9 /
sigstop / spawn_fail). ``--promote`` runs the promotion conveyor's
four-phase drill (``testing/promote_drill.py`` ``run_promote_drill``)
alongside the replay. Both need the in-process gateway (no ``--url``).
Clients honor 429/503 ``Retry-After`` headers with bounded retries
(``--max-retries``).

Stdout is EXACTLY one BENCH JSON line:

  {"metric": "traffic_p99_ms", "value": <overall p99>, "unit": "ms",
   "classes": {<class>: {count, ok, p50_ms, p99_ms}}, "throughput_rps":
   ..., "shed": <429 fraction>, "batch_fill": ..., "slo": {<verdict>}}

plus the SLO verdict table on stderr (spec from ``--slo <file>``, else
the config's ``slo:`` section). A breach is REPORTED, not fatal — the
exit code is 0 iff any request completed. The run's event stream lands at
``--obs-dir/obs/events.jsonl`` (default logs/traffic_gen/).

    python -m distegnn_tpu_torch.scripts.traffic_gen \\
        --config_path configs/nbody_serve.yaml --profile spike10x \\
        --requests 96 --rate 10 [--url http://127.0.0.1:8008 | --device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import threading
import time

from distegnn_tpu_torch.scripts.serve_bench import (ROLLOUT_DEFAULTS,
                                                     _b64_field,
                                                     predict_payload)

CLASSES = ("predict", "session", "rollout")


# ---- plan construction ------------------------------------------------------

def parse_mix(spec: str) -> dict:
    """'predict=0.6,session=0.3,rollout=0.1' -> normalized class weights."""
    mix = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in CLASSES:
            raise ValueError(f"unknown traffic class {name!r} "
                             f"(known: {', '.join(CLASSES)})")
        try:
            mix[name] = float(val)
        except ValueError:
            raise ValueError(f"bad mix weight for {name!r}: {val!r}") from None
        if mix[name] < 0:
            raise ValueError(f"mix weight for {name!r} must be >= 0")
    total = sum(mix.values())
    if total <= 0:
        raise ValueError(f"traffic mix {spec!r} has no positive weight")
    return {k: mix.get(k, 0.0) / total for k in CLASSES}


CHAOS_ACTIONS = ("kill", "wedge", "latency", "swap", "corrupt",
                 "kill9", "sigstop", "spawn_fail")


def parse_chaos(spec: str):
    """'kill@0.3:replica=0;swap@1.0:ckpt=/p/b.ckpt' -> events sorted by
    firing offset, each ``{action, at, kw}``. Args per action: every one
    takes ``model=`` (default: first served model); kill/wedge/latency
    take ``replica=`` (kill/wedge default 0, latency default ALL); wedge
    takes ``dur=`` seconds; latency takes ``s=`` seconds; swap/corrupt
    take ``ckpt=`` and corrupt ``mode=`` (truncate|garbage|headerless);
    kill9/sigstop take ``replica=`` (default 0) and need process-backed
    replicas; spawn_fail takes ``replica=`` and ``n=`` (default 1)
    respawn attempts to sabotage."""
    events = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        head, _, tail = part.partition(":")
        action, _, at = head.partition("@")
        action = action.strip()
        if action not in CHAOS_ACTIONS:
            raise ValueError(f"unknown chaos action {action!r} "
                             f"(known: {', '.join(CHAOS_ACTIONS)})")
        try:
            at_s = float(at)
        except ValueError:
            raise ValueError(
                f"chaos action {action!r} needs '@<seconds>'") from None
        kw = {}
        for item in tail.split(","):
            item = item.strip()
            if not item:
                continue
            key, eq, val = item.partition("=")
            if not eq:
                raise ValueError(f"bad chaos arg {item!r} (want key=value)")
            kw[key.strip()] = val.strip()
        if action in ("swap", "corrupt") and not kw.get("ckpt"):
            raise ValueError(f"chaos action {action!r} needs ckpt=<path>")
        events.append({"action": action, "at": at_s, "kw": kw})
    return sorted(events, key=lambda e: e["at"])


def parse_scale(spec: str) -> dict:
    """--autoscale value -> serve.autoscale overrides. 'on'/'true'/'1' is
    bare enablement; otherwise 'key=val,...' with keys from the autoscaler's
    knob set, coerced against the knob's default type. Passing the flag at
    all implies enable=true unless the spec says enable=false."""
    from distegnn_tpu_torch.serve.autoscale import _DEFAULTS as knob_defaults

    spec = spec.strip()
    out: dict = {}
    if spec.lower() in ("on", "true", "1", "yes"):
        out["enable"] = True
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, eq, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if not eq or key not in knob_defaults:
            raise ValueError(
                f"bad autoscale override {part!r} (want key=value with keys "
                f"{', '.join(sorted(knob_defaults))})")
        ref = knob_defaults[key]
        if isinstance(ref, bool):
            out[key] = val.lower() in ("1", "true", "yes", "on")
        elif isinstance(ref, int):
            out[key] = int(val)
        else:                         # float knobs, incl. None-able p99 gate
            out[key] = float(val)
    out.setdefault("enable", True)
    return out


def size_sampler(sizes, alpha: float, rng: random.Random):
    """Heavy-tailed draw over ascending ladder sizes: rung k gets weight
    1/(k+1)^alpha — most traffic at the floor, a power-law tail of big
    graphs."""
    sizes = sorted(set(int(s) for s in sizes))
    weights = [1.0 / (k + 1) ** alpha for k in range(len(sizes))]
    return lambda: rng.choices(sizes, weights=weights, k=1)[0]


def arrival_times(n: int, rate: float, on_s: float, off_s: float,
                  rng: random.Random):
    """n arrival offsets (seconds from t0): Poisson at ``rate`` during
    exponential ON phases (mean on_s), jumping exponential OFF gaps (mean
    off_s). off_s <= 0 -> a pure Poisson process."""
    out, t = [], 0.0
    on_left = rng.expovariate(1.0 / on_s) if off_s > 0 else float("inf")
    for _ in range(n):
        dt = rng.expovariate(rate)
        while off_s > 0 and dt > on_left:
            dt -= on_left
            t += on_left + rng.expovariate(1.0 / off_s)  # jump the OFF gap
            on_left = rng.expovariate(1.0 / on_s)
        on_left -= dt
        t += dt
        out.append(t)
    return out


# name -> ordered (phase, request_fraction, rate_multiplier); arrivals inside
# a phase are pure Poisson at rate * multiplier, phases laid back-to-back
PROFILES = {
    "steady": (("steady", 1.0, 1.0),),
    "ramp": (("low", 1 / 3, 0.5), ("mid", 1 / 3, 1.0), ("high", 1 / 3, 2.0)),
    "spike10x": (("pre", 0.25, 1.0), ("spike", 0.5, 10.0),
                 ("post", 0.25, 1.0)),
}


def profile_arrivals(profile: str, n: int, rate: float, rng: random.Random):
    """(arrival offsets, per-request phase tags) for a named load profile.
    Each phase gets its request share as a pure Poisson stream at
    rate*multiplier — the spike really is 10x denser wall-clock traffic,
    not the same arrivals relabeled."""
    segs = PROFILES[profile]
    counts = [int(n * frac) for _, frac, _ in segs]
    counts[-1] += n - sum(counts)            # rounding drift -> last phase
    offsets, phases, t = [], [], 0.0
    for (name, _, mult), count in zip(segs, counts):
        for _ in range(count):
            t += rng.expovariate(rate * mult)
            offsets.append(t)
            phases.append(name)
    return offsets, phases


def rollout_payload(g, steps: int) -> bytes:
    return json.dumps({
        "positions": _b64_field(g["loc"], "<f4"),
        "velocities": _b64_field(g["vel"], "<f4"),
        "steps": int(steps),
        "encoding": "b64",
    }).encode()


def build_plan(args, models, rollout_models, feat_nf, edge_attr_nf):
    """The full replay plan, deterministic under --seed: a list of
    ``{cls, model, path, body, rid}`` plus the arrival offsets."""
    from distegnn_tpu_torch.serve.buckets import synthetic_graph

    rng = random.Random(args.seed)
    mix = parse_mix(args.mix)
    if mix["rollout"] > 0 and not rollout_models:
        print("traffic_gen: no rollout-capable model; folding the rollout "
              "share into predict", file=sys.stderr)
        mix["predict"] += mix["rollout"]
        mix["rollout"] = 0.0
    draw_size = size_sampler(args.size_list, args.tail, rng)

    # session pool: sticky id -> ONE fixed graph (same bytes every time, so
    # the prep cache's plan-reuse path is actually exercised)
    sessions = []
    for i in range(max(1, args.sessions)):
        n = draw_size()
        g = synthetic_graph(n, seed=10_000 + args.seed + i, feat_nf=feat_nf,
                            edge_attr_nf=edge_attr_nf)
        sessions.append((f"tg-sess-{i}", predict_payload(
            g, session_id=f"tg-sess-{i}")))

    names, weights = zip(*sorted(mix.items()))
    plan = []
    for k in range(args.requests):
        cls = rng.choices(names, weights=weights, k=1)[0]
        rid = f"tg-{args.seed}-{k}"
        if cls == "rollout":
            model = rng.choice(rollout_models)
            g = synthetic_graph(draw_size(), seed=args.seed + k,
                                feat_nf=feat_nf, edge_attr_nf=edge_attr_nf)
            body = rollout_payload(g, args.rollout_steps)
            path = f"/v1/models/{model}/rollout"
        elif cls == "session":
            model = rng.choice(models)
            _, body = sessions[rng.randrange(len(sessions))]
            path = f"/v1/models/{model}/predict"
        else:
            model = rng.choice(models)
            g = synthetic_graph(draw_size(), seed=args.seed + k,
                                feat_nf=feat_nf, edge_attr_nf=edge_attr_nf)
            body = predict_payload(g)
            path = f"/v1/models/{model}/predict"
        plan.append({"cls": cls, "model": model, "path": path, "body": body,
                     "rid": rid})
    if getattr(args, "profile", None):
        offsets, phases = profile_arrivals(args.profile, args.requests,
                                           args.rate, rng)
        for item, phase in zip(plan, phases):
            item["phase"] = phase
    else:
        offsets = arrival_times(args.requests, args.rate, args.burst_on_s,
                                args.burst_off_s, rng)
    return plan, offsets


# ---- target gateways --------------------------------------------------------

def discover_models(base_url: str, timeout: float = 10.0):
    """(all model names, rollout-capable names) from GET /v1/models."""
    import urllib.request

    with urllib.request.urlopen(base_url.rstrip("/") + "/v1/models",
                                timeout=timeout) as resp:
        desc = json.loads(resp.read().decode())
    models = [m["name"] for m in desc.get("models", [])]
    rollout = [m["name"] for m in desc.get("models", [])
               if m.get("rollout")]
    return models, rollout


def boot_gateway(args, cfg, device):
    """In-process gateway from the config on ``device``, on an ephemeral
    port; returns (gateway, server_thread, registry)."""
    from distegnn_tpu_torch.obs import cudaprobe
    from distegnn_tpu_torch.serve.registry import ModelRegistry
    from distegnn_tpu_torch.serve.transport import Gateway

    mix = parse_mix(args.mix)
    if (mix["rollout"] > 0 and not cfg.serve.get("rollout")
            and not cfg.serve.get("models")):
        # same geometry defaults as serve_bench's rollout workload. Not
        # under a serve.models list: every model would inherit it, and one
        # that cannot roll out (edge_impl fused) would answer 500s; there
        # the models' own serve.rollout decides (the JAX script sets it)
        cfg.serve.rollout = dict(ROLLOUT_DEFAULTS)
    if mix["rollout"] > 0:
        # K-step CPU batches take seconds; a serving-tuned 1 s request
        # timeout would shed every queued scene and bench the timeout path
        cfg.serve.request_timeout_ms = max(
            float(cfg.serve.request_timeout_ms), 600_000.0)
    if args.max_batch is not None:
        cfg.serve.max_batch = int(args.max_batch)
    if args.replicas is not None:
        cfg.serve.replicas = int(args.replicas)
    if args.workers is not None:
        cfg.serve.workers = str(args.workers)

    registry = ModelRegistry.from_config(cfg, device=device).start()
    registry.warmup(args.size_list)
    # the warmup boundary (JAX marks its compile watcher here)
    cudaprobe.emit_memory_event(phase="serve_warmup_done")
    slo_window = float((cfg.get("slo") or {}).get("window_s", 60.0) or 60.0)
    autoscale = dict(cfg.serve.autoscale)
    if getattr(args, "autoscale", None):
        autoscale.update(parse_scale(args.autoscale))
    gw = Gateway(registry, port=0,
                 max_inflight=max(64, args.requests),
                 slo_window_s=slo_window,
                 autoscale=autoscale,
                 priority=dict(cfg.serve.priority),
                 stream_chunk_steps=int(cfg.serve.stream.chunk_steps),
                 promote=dict(cfg.get("promote") or {}))
    server = threading.Thread(target=gw.serve_forever, name="tg-gateway",
                              daemon=True)
    server.start()
    return gw, server, registry


# ---- chaos ------------------------------------------------------------------

def _swap_over_socket(base_url: str, model: str, ckpt: str,
                      feat_nf: int, edge_attr_nf: int) -> dict:
    """POST the blue/green hot-swap through the live socket; on success
    fire one FIXED probe predict (n=24, seed=1234) and log its prediction
    bytes as a ``chaos/swap_probe`` event, so a test can compare them
    bitwise against a cold-started engine on the new checkpoint."""
    import urllib.error
    import urllib.request

    from distegnn_tpu_torch import obs
    from distegnn_tpu_torch.serve.buckets import synthetic_graph

    req = urllib.request.Request(
        base_url.rstrip("/") + f"/v1/models/{model}/swap",
        data=json.dumps({"checkpoint": str(ckpt)}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120.0) as resp:
            status, body = int(resp.status), json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        status = int(e.code)
        try:
            body = json.loads(e.read().decode() or "{}")
        except ValueError:
            body = {}
    out = {"ckpt": str(ckpt), "status": status, "ok": status == 200,
           "swap": {k: body[k] for k in ("version", "stage", "rolled_back")
                    if k in body}}
    if status == 200:
        g = synthetic_graph(24, seed=1234, feat_nf=feat_nf,
                            edge_attr_nf=edge_attr_nf)
        preq = urllib.request.Request(
            base_url.rstrip("/") + f"/v1/models/{model}/predict",
            data=predict_payload(g),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(preq, timeout=120.0) as resp:
            pred = json.loads(resp.read().decode())["prediction"]
        obs.event("chaos/swap_probe", model=model, ckpt=str(ckpt), n=24,
                  seed=1234, prediction=pred)
    return out


def run_chaos(events, t0: float, registry, base_url: str, models,
              feat_nf: int, edge_attr_nf: int, record: list) -> None:
    """Fire the parsed chaos events at their offsets from ``t0``; every
    firing (or failure to fire) lands in ``record`` and as a
    ``chaos/inject`` obs event. Injection errors are recorded, never
    raised — the replay must finish and report regardless."""
    from distegnn_tpu_torch import obs
    from distegnn_tpu_torch.testing import serve_faults

    for ev in events:
        delay = (t0 + ev["at"]) - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        action, kw = ev["action"], ev["kw"]
        model = kw.get("model") or models[0]
        outcome = {"action": action, "at_s": ev["at"], "model": model}
        try:
            if action == "kill":
                rep = int(kw.get("replica", 0))
                serve_faults.kill_replica(registry, model, rep)
                outcome.update(replica=rep, ok=True)
            elif action == "kill9":
                rep = int(kw.get("replica", 0))
                pid = serve_faults.kill9_replica(registry, model, rep)
                outcome.update(replica=rep, pid=pid, ok=True)
            elif action == "sigstop":
                rep = int(kw.get("replica", 0))
                pid = serve_faults.sigstop_replica(registry, model, rep)
                outcome.update(replica=rep, pid=pid, ok=True)
            elif action == "spawn_fail":
                rep = int(kw.get("replica", 0))
                n = int(kw.get("n", 1))
                serve_faults.spawn_failure(registry, model, n, rep)
                outcome.update(replica=rep, n=n, ok=True)
            elif action == "wedge":
                rep = int(kw.get("replica", 0))
                dur = float(kw.get("dur", 5.0))
                serve_faults.wedge_replica(registry, model, dur, rep)
                outcome.update(replica=rep, dur_s=dur, ok=True)
            elif action == "latency":
                rep = int(kw["replica"]) if "replica" in kw else None
                sec = float(kw.get("s", 0.05))
                serve_faults.inject_execute_latency(registry, model, sec,
                                                    replica=rep)
                outcome.update(replica=rep, seconds=sec, ok=True)
            elif action == "corrupt":
                mode = kw.get("mode", "garbage")
                serve_faults.corrupt_swap_checkpoint(kw["ckpt"], mode)
                outcome.update(ckpt=kw["ckpt"], mode=mode, ok=True)
            elif action == "swap":
                outcome.update(_swap_over_socket(
                    base_url, model, kw["ckpt"], feat_nf, edge_attr_nf))
        except Exception as exc:
            outcome.update(ok=False, error=repr(exc))
        obs.event("chaos/inject", **outcome)
        record.append(outcome)


# ---- replay -----------------------------------------------------------------

def replay(base_url: str, plan, offsets, timeout_s: float,
           max_retries: int = 3):
    """Fire the plan open-loop; returns per-request result dicts
    ``{cls, status, ms, rid, retries}`` (status -1 = transport error) and
    wall_s. A 429/503 carrying Retry-After is retried after honoring the
    header (capped at 5 s per wait, ``max_retries`` attempts), so a
    failover blip shows up as latency, not lost work."""
    import urllib.error
    import urllib.request

    results = [None] * len(plan)

    def post(i, item):
        t_req = time.perf_counter()
        status, echoed, retries = -1, None, 0
        while True:
            req = urllib.request.Request(
                base_url.rstrip("/") + item["path"], data=item["body"],
                headers={"Content-Type": "application/json",
                         "X-Request-Id": item["rid"]},
                method="POST")
            try:
                with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                    status = int(resp.status)
                    echoed = resp.headers.get("X-Request-Id")
                break
            except urllib.error.HTTPError as e:
                status = int(e.code)
                echoed = e.headers.get("X-Request-Id")
                after = e.headers.get("Retry-After")
                if status in (429, 503) and after and retries < max_retries:
                    try:
                        wait = min(max(float(after), 0.0), 5.0)
                    except ValueError:
                        wait = 0.5
                    retries += 1
                    time.sleep(wait)
                    continue
                break
            except Exception:
                break
        results[i] = {"cls": item["cls"], "phase": item.get("phase"),
                      "status": status,
                      "ms": (time.perf_counter() - t_req) * 1e3,
                      "rid": echoed or item["rid"], "retries": retries}

    threads = []
    t0 = time.perf_counter()
    for k, (item, off) in enumerate(zip(plan, offsets)):
        delay = (t0 + off) - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t = threading.Thread(target=post, args=(k, item), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=timeout_s + 60.0)
    wall = time.perf_counter() - t0
    for i, item in enumerate(plan):   # a thread that never returned = error
        if results[i] is None:
            results[i] = {"cls": item["cls"], "phase": item.get("phase"),
                          "status": -1, "ms": timeout_s * 1e3,
                          "rid": item["rid"], "retries": 0}
    return results, wall


def scrape_metrics(base_url: str, timeout: float = 10.0) -> str:
    import urllib.request

    try:
        with urllib.request.urlopen(base_url.rstrip("/") + "/metrics",
                                    timeout=timeout) as resp:
            return resp.read().decode()
    except Exception:
        return ""


# ---- scoring ----------------------------------------------------------------

def class_stats(results):
    """Per-class {count, ok, p50_ms, p99_ms} + the overall p50/p99 over
    successful requests."""
    from distegnn_tpu_torch.obs.metrics import percentile

    classes = {}
    ok_all = []
    for cls in CLASSES:
        rows = [r for r in results if r["cls"] == cls]
        if not rows:
            continue
        ok = sorted(r["ms"] for r in rows if 200 <= r["status"] < 400)
        ok_all.extend(ok)
        classes[cls] = {
            "count": len(rows),
            "ok": len(ok),
            "p50_ms": round(percentile(ok, 50), 3) if ok else None,
            "p99_ms": round(percentile(ok, 99), 3) if ok else None,
        }
    ok_all.sort()
    p50 = round(percentile(ok_all, 50), 3) if ok_all else None
    p99 = round(percentile(ok_all, 99), 3) if ok_all else None
    return classes, p50, p99


def phase_stats(results, spec=None):
    """Per-phase latency summary for profiled runs: overall AND
    interactive-only (predict+session) p50/p99, plus — when a spec is
    given — a per-phase SLO verdict over the phase's own route stats, so
    the BENCH line proves interactive latency held through EVERY load
    phase, not merely on average."""
    from distegnn_tpu_torch.obs import slo as slomod
    from distegnn_tpu_torch.obs.metrics import percentile

    order, rows_by = [], {}
    for r in results:
        phase = r.get("phase")
        if phase is None:
            continue
        if phase not in rows_by:
            order.append(phase)
            rows_by[phase] = []
        rows_by[phase].append(r)
    out = {}
    for phase in order:
        rows = rows_by[phase]
        ok = sorted(r["ms"] for r in rows if 200 <= r["status"] < 400)
        inter = sorted(r["ms"] for r in rows
                       if r["cls"] in ("predict", "session")
                       and 200 <= r["status"] < 400)
        rec = {
            "count": len(rows),
            "ok": len(ok),
            "p50_ms": round(percentile(ok, 50), 3) if ok else None,
            "p99_ms": round(percentile(ok, 99), 3) if ok else None,
            "interactive_p50_ms": (round(percentile(inter, 50), 3)
                                   if inter else None),
            "interactive_p99_ms": (round(percentile(inter, 99), 3)
                                   if inter else None),
        }
        if spec is not None:
            stats = {
                "error_rate": sum(1 for r in rows if r["status"] >= 500
                                  or r["status"] < 0) / len(rows),
                "shed_rate": sum(1 for r in rows
                                 if r["status"] == 429) / len(rows),
            }
            if inter:
                stats["predict_p50_ms"] = percentile(inter, 50)
                stats["predict_p99_ms"] = percentile(inter, 99)
            roll = sorted(r["ms"] for r in rows if r["cls"] == "rollout"
                          and 200 <= r["status"] < 400)
            if roll:
                stats["rollout_p50_ms"] = percentile(roll, 50)
                stats["rollout_p99_ms"] = percentile(roll, 99)
            rec["slo_pass"] = not slomod.breached(
                slomod.evaluate(spec, stats))
        out[phase] = rec
    return out


def slo_stats(results, prom_text: str):
    """Client-observed SLO stats vocabulary, merged with the scrape's
    server-side fill/session stats (the client can't see slot counters)."""
    from distegnn_tpu_torch.obs import slo as slomod
    from distegnn_tpu_torch.obs.metrics import percentile

    stats = {}
    # session requests ride the predict route; score them together
    by_route = {"predict": [r for r in results
                            if r["cls"] in ("predict", "session")],
                "rollout": [r for r in results if r["cls"] == "rollout"]}
    for route, rows in by_route.items():
        ok = sorted(r["ms"] for r in rows if 200 <= r["status"] < 400)
        if ok:
            stats[f"{route}_p50_ms"] = round(percentile(ok, 50), 3)
            stats[f"{route}_p99_ms"] = round(percentile(ok, 99), 3)
    if results:
        stats["error_rate"] = round(
            sum(1 for r in results if r["status"] >= 500
                or r["status"] < 0) / len(results), 6)
        stats["shed_rate"] = round(
            sum(1 for r in results if r["status"] == 429) / len(results), 6)
    scraped = slomod.stats_from_prometheus(prom_text) if prom_text else {}
    for key in ("batch_fill", "session_hit_rate"):
        if key in scraped:
            stats[key] = scraped[key]
    return stats


def load_slo_spec(args, cfg):
    from distegnn_tpu_torch.obs import slo as slomod

    if args.slo:
        return slomod.SLOSpec.from_file(args.slo)
    sl = cfg.get("slo") if cfg is not None else None
    if sl and sl.get("enable", True):
        return slomod.SLOSpec.from_mapping(dict(sl))
    return slomod.SLOSpec()


# ---- the promotion conveyor drill -------------------------------------------

def run_promote(gw, registry, model, size_list, feat_nf, edge_attr_nf,
                stage_dir, record: dict) -> None:
    """The conveyor's four-phase drill (``testing/promote_drill.py``)
    alongside the replay; fills ``record`` (the BENCH line's ``promote``
    field) and writes a ``chaos/promote_drill`` event."""
    from distegnn_tpu_torch import obs
    from distegnn_tpu_torch.serve.buckets import synthetic_graph
    from distegnn_tpu_torch.testing.promote_drill import run_promote_drill

    probe_body = predict_payload(synthetic_graph(
        min(size_list), seed=4321, feat_nf=feat_nf,
        edge_attr_nf=edge_attr_nf))
    record.update(run_promote_drill(gw, registry, model, probe_body,
                                    stage_dir))
    obs.event("chaos/promote_drill", ok=record["ok"],
              published=record["published"],
              phases={k: {kk: v.get(kk) for kk in ("outcome", "reason", "ok")}
                      for k, v in record["phases"].items()})


# ---- entry ------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distegnn_tpu_torch.scripts.traffic_gen",
        description="mixed-traffic open-loop replay against a live gateway")
    ap.add_argument("--url", type=str, default=None,
                    help="base URL of a running gateway (default: boot an "
                         "in-process one and drive it over its socket)")
    ap.add_argument("--config_path", type=str, default=None,
                    help="YAML config for the in-process gateway / SLO spec")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--rate", type=float, default=100.0,
                    help="mean arrival rate during ON phases, req/s")
    ap.add_argument("--mix", type=str,
                    default="predict=0.6,session=0.3,rollout=0.1",
                    help="class=weight list over predict/session/rollout")
    ap.add_argument("--sizes", type=str, default="24,48,96,192",
                    help="ladder-rung node counts the size tail draws from")
    ap.add_argument("--tail", type=float, default=1.5,
                    help="power-law exponent: rung k drawn with weight "
                         "1/(k+1)^tail (bigger = thinner tail)")
    ap.add_argument("--burst-on-s", type=float, default=0.5,
                    help="mean length of an ON burst, seconds")
    ap.add_argument("--burst-off-s", type=float, default=0.2,
                    help="mean OFF gap between bursts; 0 = pure Poisson")
    ap.add_argument("--sessions", type=int, default=4,
                    help="sticky session-id pool size for the session class")
    ap.add_argument("--rollout-steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=47)
    ap.add_argument("--timeout-s", type=float, default=300.0,
                    help="per-request client timeout")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="override serve.max_batch (in-process gateway only)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="override serve.replicas (in-process gateway only)")
    ap.add_argument("--workers", type=str, default=None,
                    choices=("thread", "process"),
                    help="override serve.workers (in-process gateway only): "
                         "'process' runs each replica in its own worker "
                         "child behind IPC supervision")
    ap.add_argument("--chaos", type=str, default=None,
                    help="serving fault schedule, e.g. 'kill@0.3:replica=0;"
                         "swap@1.0:ckpt=/p/b.ckpt' (in-process gateway only)")
    ap.add_argument("--promote", action="store_true",
                    help="run the continuous-promotion chaos drill alongside "
                         "the replay (testing/promote_drill.py): publisher "
                         "child processes land good / drift candidates into "
                         "the conveyor, a publisher is SIGKILLed "
                         "mid-publish, and the canary replica is killed "
                         "mid-promotion (in-process gateway only; forces "
                         ">= 3 replicas unless --replicas is given)")
    ap.add_argument("--publish-child", type=str, default=None,
                    help=argparse.SUPPRESS)  # internal: the drill's trainer
    ap.add_argument("--profile", type=str, default=None,
                    choices=tuple(PROFILES),
                    help="phased load shape (steady|ramp|spike10x); "
                         "replaces the burst modulator and adds per-phase "
                         "p50/p99 + SLO verdicts to the BENCH record")
    ap.add_argument("--autoscale", type=str, default=None,
                    help="enable the replica autoscaler on the in-process "
                         "gateway: 'on' or serve.autoscale overrides as "
                         "'key=val,...' (e.g. 'max_replicas=3,queue_high=2')")
    ap.add_argument("--scale-settle-s", type=float, default=0.0,
                    help="after the replay, wait up to this long for the "
                         "autoscaler to shrink back to min_replicas before "
                         "drain (one run then shows the full 1->N->1 cycle)")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="client retries per request on 429/503 that carry "
                         "Retry-After (0 disables)")
    ap.add_argument("--slo", type=str, default=None,
                    help="SLO spec file; default: the config's slo: section")
    ap.add_argument("--obs-dir", type=str, default="logs/traffic_gen",
                    help="event sink dir (<dir>/obs/events.jsonl); '' off")
    ap.add_argument("--device", type=str, default="cuda",
                    help="device of the in-process gateway: 'cuda' (the "
                         "default; raises without a card) or 'cpu'")
    return ap


def _refuse(msg: str) -> int:
    print(f"traffic_gen: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.publish_child:
        from distegnn_tpu_torch.testing.promote_drill import \
            publish_child_main

        return publish_child_main(args.publish_child)
    args.size_list = [int(s) for s in args.sizes.split(",") if s.strip()]
    if not args.size_list:
        return _refuse("--sizes is empty")
    try:
        chaos_events = parse_chaos(args.chaos) if args.chaos else []
    except ValueError as exc:
        return _refuse(str(exc))
    if chaos_events and args.url:
        return _refuse("--chaos needs the in-process gateway (the injectors "
                       "reach into the live registry); drop --url")
    if args.promote and args.url:
        return _refuse("--promote needs the in-process gateway (the drill "
                       "reaches into the live promoter); drop --url")
    if args.autoscale:
        if args.url:
            return _refuse("--autoscale configures the in-process gateway; "
                           "drop --url (a remote gateway scales itself)")
        try:
            parse_scale(args.autoscale)
        except ValueError as exc:
            return _refuse(str(exc))

    from distegnn_tpu_torch import obs, resolve_device
    from distegnn_tpu_torch.config import (_DEFAULTS, ConfigDict,
                                           load_config)
    from distegnn_tpu_torch.obs import slo as slomod

    # a remote gateway runs on its own device: the client needs none
    device = None if args.url else resolve_device(args.device)
    cfg = (load_config(args.config_path) if args.config_path
           else ConfigDict(_DEFAULTS))
    if args.obs_dir:
        obs.configure_from_config(cfg, args.obs_dir,
                                  tags={"run": "traffic_gen"})

    stage_dir = None
    if args.promote:
        # drill-tuned conveyor knobs: tee every request, a small shadow
        # quorum, and a fast scan so the whole lifecycle fits one replay
        import tempfile

        pm = cfg.promote
        pm.enable = True
        pm.publish = False
        # always a FRESH conveyor dir: leftovers from a previous run would
        # be scanned as live candidates by this run's promoter
        root = args.obs_dir or None
        if root:
            os.makedirs(root, exist_ok=True)
        pm.watch_dir = tempfile.mkdtemp(prefix="promote_watch_", dir=root)
        stage_dir = os.path.join(os.path.dirname(pm.watch_dir),
                                 "promote_ckpts")
        pm.interval_s = 0.05
        pm.shadow_sample = 1.0
        pm.min_shadow = 3
        pm.gate_timeout_s = 20.0
        # a first batch shape on the CPU takes seconds: a serving-tuned
        # sub-second timeout would 504 it and trip the SLO gate on that
        # noise rather than on the candidate's quality
        cfg.serve.request_timeout_ms = max(
            float(cfg.serve.request_timeout_ms), 60_000.0)
        if args.replicas is None:
            # one replica to quarantine as the canary, two staying live so
            # the canary-kill phase still leaves a real slice to pick next
            args.replicas = max(3, int(cfg.serve.replicas))

    gw = server = registry = None
    if args.url:
        base_url = args.url
        models, rollout_models = discover_models(base_url)
        if not models:
            return _refuse(f"{base_url} serves no models")
    else:
        gw, server, registry = boot_gateway(args, cfg, device)
        base_url = gw.url("")
        models = registry.names()
        rollout_models = [n for n, e in registry.items() if e.rollout_enabled]

    feat_nf = int(cfg.model.node_feat_nf)
    edge_attr_nf = int(cfg.model.edge_attr_nf)
    plan, offsets = build_plan(args, models, rollout_models, feat_nf,
                               edge_attr_nf)
    obs.event("traffic/start", requests=args.requests, rate=args.rate,
              mix=args.mix, sizes=args.size_list, models=models,
              burst_on_s=args.burst_on_s, burst_off_s=args.burst_off_s,
              target=("remote" if args.url else "inproc"))

    chaos_record: list = []
    chaos_thread = None
    if chaos_events:
        obs.event("chaos/plan", events=[{"action": e["action"],
                                         "at_s": e["at"]}
                                        for e in chaos_events])
        chaos_thread = threading.Thread(
            target=run_chaos,
            args=(chaos_events, time.perf_counter(), registry, base_url,
                  models, feat_nf, edge_attr_nf, chaos_record),
            name="tg-chaos", daemon=True)
        chaos_thread.start()
    promote_record = None
    promote_thread = None
    if args.promote:
        promote_record = {}
        promote_thread = threading.Thread(
            target=run_promote,
            args=(gw, registry, models[0], args.size_list, feat_nf,
                  edge_attr_nf, stage_dir, promote_record),
            name="tg-promote", daemon=True)
        promote_thread.start()
    results, wall = replay(base_url, plan, offsets, args.timeout_s,
                           max_retries=args.max_retries)
    if chaos_thread is not None:
        chaos_thread.join(timeout=args.timeout_s + 60.0)
    if promote_thread is not None:
        promote_thread.join(timeout=300.0)
    scale_state = None
    if gw is not None and gw.autoscaler.enable:
        # hold the gateway open while the calm-streak logic walks the fleet
        # back down, so this run's event stream carries scale_down too.
        # calm_rounds >= 1 guards the at-min check: it is 0 while an
        # up-trigger is firing or a grow (warmup included) is still inside
        # the tick lock, so the loop can't slip out mid-scale-up
        deadline = time.perf_counter() + max(0.0, args.scale_settle_s)
        while time.perf_counter() < deadline:
            if all(s["replicas"] <= s["min"] and s["calm_rounds"] >= 1
                   for s in gw.autoscaler.status().values()):
                break
            time.sleep(0.25)
        scale_state = gw.autoscaler.status()
    prom_text = scrape_metrics(base_url)
    if gw is not None:
        gw.drain()
        server.join(timeout=30.0)
        gw.close()

    classes, p50, p99 = class_stats(results)
    completed = sum(1 for r in results if 200 <= r["status"] < 400)
    stats = slo_stats(results, prom_text)
    spec = load_slo_spec(args, cfg)
    slo_results = slomod.evaluate(spec, stats)
    phases = phase_stats(results, spec) if args.profile else None
    print(slomod.verdict_table(slo_results, source="traffic_gen"),
          end="", file=sys.stderr)

    rec = {
        "metric": "traffic_p99_ms",
        "value": p99,
        "unit": "ms",
        "vs_baseline": None,
        "p50_ms": p50,
        "classes": classes,
        "requests": args.requests,
        "completed": completed,
        "throughput_rps": round(completed / max(wall, 1e-9), 3),
        "shed": round(sum(1 for r in results if r["status"] == 429)
                      / max(len(results), 1), 6),
        "errors": sum(1 for r in results if r["status"] >= 500
                      or r["status"] < 0),
        "lost": sum(1 for r in results if r["status"] < 0),
        "retries_total": sum(r.get("retries", 0) for r in results),
        "chaos": chaos_record or None,
        "promote": promote_record,
        "profile": args.profile,
        "phases": phases,
        "autoscale": scale_state,
        "batch_fill": stats.get("batch_fill"),
        "session_hit_rate": stats.get("session_hit_rate"),
        "offered_rate": args.rate,
        "mix": parse_mix(args.mix),
        "sizes": args.size_list,
        "models": models,
        "wall_s": round(wall, 4),
        "platform": "remote" if device is None else device.type,
        "slo": slomod.results_json(slo_results),
    }
    print(json.dumps(rec, sort_keys=True, default=str))
    obs.event("bench/result", **{k: v for k, v in rec.items()
                                 if k != "classes"}, classes=classes)

    tracer = obs.get_tracer()
    tracer.flush()
    w = getattr(tracer, "writer", None)
    if w is not None:
        print(f"obs: events at {w.path}; replay a request with python -m "
              f"distegnn_tpu_torch.obs.report {w.path} --request tg-"
              f"{args.seed}-0", file=sys.stderr, flush=True)
    return 0 if completed else 1


if __name__ == "__main__":
    raise SystemExit(main())
