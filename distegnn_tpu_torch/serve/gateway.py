"""Serving gateway entry point (the port's counterpart of
``scripts/serve_gateway.py``): config -> ModelRegistry -> HTTP serve loop.

Boots every model named by the config's ``serve.models:`` list (or one
model from the config itself when the list is absent) on the card, warms
each engine's rungs (the CUDA kernels build on first use, before traffic),
then serves the JSON predict and rollout APIs and the operational endpoints
of ``serve/transport.py``:

  POST /v1/models/<name>/predict   POST /v1/models/<name>/rollout[?stream=1]
  POST /v1/models/<name>/swap      GET  /v1/models
  GET  /metrics   GET /healthz   GET /readyz

SIGTERM/SIGINT drain gracefully: /readyz flips to 503, the queues flush
(every accepted request gets a real response), then the process exits 0.

``serve.workers: process`` runs each replica in a worker child on the same
device (``serve/worker.py``); ``promote.enable`` starts the promotion
conveyor's promoter over ``promote.watch_dir`` (``promote/promoter.py``).

    python -m distegnn_tpu_torch.serve.gateway \\
        --config_path configs/nbody_serve.yaml [--device cpu]

The models run on the card unless ``--device cpu`` asks for the plain
PyTorch path; without a card the default raises. ``--port 0`` binds an
ephemeral port, printed in the "listening on http://host:port" line. Obs
events land at ``--obs-dir/obs/events.jsonl``, with a ``jax/memory`` event
(``obs/cudaprobe.py``) after warmup in place of JAX's compile watcher.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="distegnn serving gateway (PyTorch + CUDA port)")
    ap.add_argument("--config_path", type=str, default=None,
                    help="YAML with serve:/serve.models: sections "
                         "(default: built-ins)")
    ap.add_argument("--host", type=str, default=None,
                    help="bind host (default: serve.gateway.host)")
    ap.add_argument("--port", type=int, default=None,
                    help="bind port, 0 = ephemeral "
                         "(default: serve.gateway.port)")
    ap.add_argument("--max-inflight", type=int, default=None,
                    help="gateway shed gate (default: "
                         "serve.gateway.max_inflight)")
    ap.add_argument("--warmup-nodes", type=str, default=None,
                    help="comma-separated node counts warmed per model "
                         "(default: serve.gateway.warmup_nodes)")
    ap.add_argument("--obs-dir", type=str, default="logs/serve_gateway",
                    help="event-stream sink dir (events land at <dir>/obs/"
                         "events.jsonl); '' disables tracing")
    ap.add_argument("--device", type=str, default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    from distegnn_tpu_torch import obs, resolve_device
    from distegnn_tpu_torch.config import (_DEFAULTS, ConfigDict,
                                           load_config, validate_config)
    from distegnn_tpu_torch.obs import cudaprobe
    from distegnn_tpu_torch.serve.registry import ModelRegistry
    from distegnn_tpu_torch.serve.transport import Gateway

    if args.config_path:
        cfg = load_config(args.config_path)
    else:
        cfg = ConfigDict(_DEFAULTS)
        validate_config(cfg)
    device = resolve_device(args.device)
    if args.obs_dir:
        obs.configure_from_config(cfg, args.obs_dir,
                                  tags={"run": "serve_gateway"})
    cudaprobe.configure(
        enabled=bool((cfg.get("obs") or {}).get("jax_probe", True)),
        device=device)
    g = cfg.serve.gateway
    warmup_nodes = ([int(n) for n in args.warmup_nodes.split(",") if n]
                    if args.warmup_nodes else [int(n) for n in
                                               g.warmup_nodes])

    registry = ModelRegistry.from_config(cfg, device=device)
    registry.start()
    obs.log(f"gateway: warming {len(registry)} model(s) at node sizes "
            f"{warmup_nodes}")
    registry.warmup(warmup_nodes)
    cudaprobe.emit_memory_event(phase="serve_warmup_done")

    s = cfg.serve
    gateway = Gateway(
        registry,
        host=args.host if args.host is not None else str(g.host),
        port=args.port if args.port is not None else int(g.port),
        max_inflight=(args.max_inflight if args.max_inflight is not None
                      else int(g.max_inflight)),
        drain_grace_s=float(g.drain_grace_s),
        slo_window_s=float((cfg.get("slo") or {}).get("window_s", 60.0)
                           or 60.0),
        autoscale=dict(s.autoscale),
        priority=dict(s.priority),
        stream_chunk_steps=int(s.stream.chunk_steps),
        promote=dict(cfg.get("promote") or {}))
    gateway.install_signal_handlers()
    host, port = gateway.address
    obs.log(f"gateway: listening on http://{host}:{port} "
            f"(models: {', '.join(registry.names())}; "
            f"ready={gateway.ready()}; device={device})")
    gateway.serve_forever()          # returns after a signal-driven drain

    gateway.close()
    registry.stop(drain=True)        # idempotent: drain already ran this
    cudaprobe.emit_memory_event(phase="serve_drained")
    obs.log("gateway: drained and stopped; exiting 0")
    obs.get_tracer().flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
