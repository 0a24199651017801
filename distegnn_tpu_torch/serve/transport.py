"""HTTP transport front-end (port of ``distegnn_tpu/serve/transport.py``):
the serving stack's network edge.

A stdlib-only gateway (``http.server.ThreadingHTTPServer``) over one or more
request queues routed by a
:class:`~distegnn_tpu_torch.serve.registry.ModelRegistry`:

  POST /v1/models/<name>/predict   JSON graph -> prediction (+ bucket,
                                   queue_ms, compute_ms, batch_filled);
                                   an optional ``session_id`` routes graph
                                   prep through the engine's session cache
  POST /v1/models/<name>/rollout   JSON scene (positions, steps, optional
                                   velocities/node_mask) -> K-step
                                   trajectory; 501 unless the model was
                                   built with serve.rollout; ``?stream=1``
                                   answers NDJSON over chunked transfer
  POST /v1/models/<name>/swap      {"checkpoint": path} -> blue/green swap
  GET  /v1/models                  routing table: rungs, warmup state, depth
  GET  /metrics                    Prometheus text: the process-wide obs
                                   MetricsRegistry + each model's serve
                                   registry (per-model name prefix)
  GET  /healthz                    process up (always 200)
  GET  /readyz                     200 only when accepting AND every model
                                   is warmed with a live dispatcher

Routes, status codes and JSON bodies are the JAX gateway's. Admission is
layered: a gateway-level ``max_inflight`` gate sheds (429) before a request
touches a queue; a full ingress maps ``QueueFullError`` -> 429; an oversize
graph maps ``BucketOverflowError`` -> 413 (a scene above the ladder cap is
served through the tiled executor when ``serve.tiled.enable`` is set, and is
a 413 above ``serve.tiled.max_nodes``); a queued- or hard-deadline expiry
maps ``RequestTimeoutError`` -> 504. Every error body is JSON (``{"error": str, "type": str}``). A kernel
fault is a 500: no handler answers with a plain-PyTorch fallback.

Graceful drain: SIGTERM flips ``/readyz`` to 503 and stops admitting (503),
drains every queue (``RequestQueue.stop(drain=True)``) so every accepted
request resolves with a real status, waits for in-flight handlers, then
stops the accept loop.

Streamed rollouts answer one NDJSON line per ``chunk_steps``-step slice; a
client disconnect cancels the remaining compute at the next chunk
boundary. Admission is priority-aware: predicts are ``interactive``,
rollouts ``bulk`` (header-overridable); bulk is capped at
``bulk_max_inflight_frac`` of the slots and deferred while the rolling SLO
window is degraded. A
:class:`~distegnn_tpu_torch.serve.autoscale.ReplicaAutoscaler` (opt-in via
``serve.autoscale.enable``) grows and shrinks each model's replicas from the
same window, and a :class:`~distegnn_tpu_torch.promote.promoter.Promoter`
(opt-in via ``promote.enable``) canaries published candidates on one
quarantined replica, fed by a sample of live predicts teed off the hot
path after each live answer is in hand; ``/readyz`` carries its status and
``/metrics`` its ``promote/*`` gauges. Over process-worker replicas
(``serve.workers: process``) a streamed rollout is served buffered and
re-chunked at the edge: same lines, no early first chunk.

Every request runs inside an obs span (``serve/http`` with route and status)
and lands in per-route latency reservoirs and shed/timeout counters of the
metrics registry (the process-global obs registry by default).
"""

from __future__ import annotations

import base64
import json
import queue as _pyqueue
import signal
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlsplit

import numpy as np

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.obs.metrics import MetricsRegistry, _prom_name
from distegnn_tpu_torch.serve.autoscale import ReplicaAutoscaler
from distegnn_tpu_torch.serve.buckets import BucketOverflowError
from distegnn_tpu_torch.serve.engine import RolloutOverflowError
from distegnn_tpu_torch.serve.queue import (QueueFullError,
                                            RequestTimeoutError, StreamSink)
from distegnn_tpu_torch.serve.registry import (ModelRegistry, SwapError,
                                               SwapInProgressError)
from distegnn_tpu_torch.serve.replica import ModelUnavailableError


class PayloadError(ValueError):
    """Malformed request body — the transport's 400."""


_RID_MAX_LEN = 64


def mint_request_id(supplied: Optional[str] = None) -> str:
    """Return the request id for one HTTP request: the client's
    ``X-Request-Id`` when it is a sane token, else a fresh one. Client ids
    are clamped to printable non-space ASCII so they can round-trip through
    headers and the JSONL event stream unescaped."""
    if supplied:
        rid = "".join(c for c in str(supplied).strip()
                      if c.isprintable() and not c.isspace())
        if rid:
            return rid[:_RID_MAX_LEN]
    return uuid.uuid4().hex[:16]


# ---- payload <-> graph dict -------------------------------------------------

def decode_array(spec, dtype: str, name: str) -> np.ndarray:
    """JSON array spec -> numpy: nested lists, or ``{"b64": <base64 of
    little-endian raw bytes>, "shape": [...]}`` for dense payloads."""
    if spec is None:
        raise PayloadError(f"missing '{name}'")
    if isinstance(spec, dict):
        if "b64" not in spec:
            raise PayloadError(f"'{name}': object form needs 'b64' "
                               f"(+ optional 'shape')")
        try:
            raw = base64.b64decode(spec["b64"], validate=True)
        except Exception:
            raise PayloadError(f"'{name}': invalid base64") from None
        try:
            arr = np.frombuffer(raw, dtype=np.dtype(dtype))
            shape = spec.get("shape")
            if shape is not None:
                arr = arr.reshape([int(s) for s in shape])
        except Exception as exc:
            raise PayloadError(f"'{name}': {exc}") from None
        return arr.copy()           # frombuffer views are read-only
    try:
        return np.asarray(spec, dtype=np.dtype(dtype))
    except Exception:
        raise PayloadError(f"'{name}': not a numeric array") from None


def encode_array(arr: np.ndarray, encoding: str):
    if encoding == "b64":
        a = np.ascontiguousarray(arr, dtype="<f4")
        return {"b64": base64.b64encode(a.tobytes()).decode("ascii"),
                "shape": list(a.shape)}
    return np.asarray(arr, dtype=np.float64).tolist()


def graph_from_payload(payload: dict, feat_nf: int,
                       edge_attr_nf: int) -> dict:
    """Validate a predict body and build the pad_graphs-style graph dict
    the queue consumes. Required: ``positions`` [n,3] and either
    ``edge_index`` [2,E] or a ``radius`` (server-side radius graph).
    Optional: ``velocities`` (default zeros), ``node_feat`` (default |v|
    replicated to the model's width), ``edge_attr`` (default pairwise
    distances replicated)."""
    if not isinstance(payload, dict):
        raise PayloadError("body must be a JSON object")
    loc = decode_array(payload.get("positions", payload.get("loc")),
                       "<f4", "positions")
    if loc.ndim != 2 or loc.shape[1] != 3 or loc.shape[0] < 1:
        raise PayloadError(f"'positions' must be [n, 3] "
                           f"(got {list(loc.shape)})")
    n = int(loc.shape[0])
    vel_spec = payload.get("velocities", payload.get("vel"))
    if vel_spec is None:
        vel = np.zeros((n, 3), np.float32)
    else:
        vel = decode_array(vel_spec, "<f4", "velocities")
        if vel.shape != loc.shape:
            raise PayloadError(f"'velocities' must match positions shape "
                               f"(got {list(vel.shape)})")
    ei_spec = payload.get("edge_index")
    if ei_spec is not None:
        ei = decode_array(ei_spec, "<i4", "edge_index")
        if ei.ndim != 2 or ei.shape[0] != 2 or ei.shape[1] < 1:
            raise PayloadError(f"'edge_index' must be [2, E], E >= 1 "
                               f"(got {list(ei.shape)})")
        if int(ei.min()) < 0 or int(ei.max()) >= n:
            raise PayloadError("'edge_index' references nodes outside "
                               f"[0, {n})")
    elif payload.get("radius") is not None:
        from distegnn_tpu_torch.ops.radius import radius_graph_np

        ei = radius_graph_np(loc, float(payload["radius"]))
        if ei.shape[1] == 0:
            if n < 2:
                raise PayloadError("radius graph is empty and n < 2; "
                                   "send 'edge_index' explicitly")
            ei = np.array([[0, 1], [1, 0]], np.int32).T.reshape(2, 2)
    else:
        raise PayloadError("provide 'edge_index' or 'radius'")
    ei = ei.astype(np.int32)

    feat_spec = payload.get("node_feat")
    if feat_spec is None:
        feat = np.linalg.norm(vel, axis=1, keepdims=True).astype(np.float32)
        feat = np.repeat(feat, max(feat_nf, 1), axis=1)[:, :max(feat_nf, 1)]
    else:
        feat = decode_array(feat_spec, "<f4", "node_feat")
        if feat.ndim != 2 or feat.shape[0] != n or feat.shape[1] != feat_nf:
            raise PayloadError(f"'node_feat' must be [{n}, {feat_nf}] "
                               f"(got {list(feat.shape)})")
    attr_spec = payload.get("edge_attr")
    if attr_spec is None:
        d = np.linalg.norm(loc[ei[0]] - loc[ei[1]], axis=1)[:, None]
        attr = np.repeat(d, max(edge_attr_nf, 1),
                         axis=1).astype(np.float32)[:, :max(edge_attr_nf, 1)]
    else:
        attr = decode_array(attr_spec, "<f4", "edge_attr")
        if (attr.ndim != 2 or attr.shape[0] != ei.shape[1]
                or attr.shape[1] != edge_attr_nf):
            raise PayloadError(
                f"'edge_attr' must be [{ei.shape[1]}, {edge_attr_nf}] "
                f"(got {list(attr.shape)})")
    return {"node_feat": feat.astype(np.float32),
            "loc": loc.astype(np.float32), "vel": vel.astype(np.float32),
            "target": loc.astype(np.float32), "edge_index": ei,
            "edge_attr": attr.astype(np.float32)}


def scene_from_payload(payload: dict) -> dict:
    """Validate a rollout body and build the scene dict
    ``RequestQueue.submit_rollout`` consumes. Required: ``positions`` [n,3]
    and ``steps`` (int >= 1). Optional: ``velocities`` (default zeros) and
    ``node_mask`` [n] (default all ones). No edge topology: the rollout
    rebuilds its radius graph on device every step."""
    if not isinstance(payload, dict):
        raise PayloadError("body must be a JSON object")
    loc = decode_array(payload.get("positions", payload.get("loc")),
                       "<f4", "positions")
    if loc.ndim != 2 or loc.shape[1] != 3 or loc.shape[0] < 1:
        raise PayloadError(f"'positions' must be [n, 3] "
                           f"(got {list(loc.shape)})")
    n = int(loc.shape[0])
    try:
        steps = int(payload.get("steps"))
    except (TypeError, ValueError):
        raise PayloadError("'steps' must be an integer >= 1") from None
    if steps < 1:
        raise PayloadError(f"'steps' must be >= 1 (got {steps})")
    vel_spec = payload.get("velocities", payload.get("vel"))
    if vel_spec is None:
        vel = np.zeros((n, 3), np.float32)
    else:
        vel = decode_array(vel_spec, "<f4", "velocities")
        if vel.shape != loc.shape:
            raise PayloadError(f"'velocities' must match positions shape "
                               f"(got {list(vel.shape)})")
    scene = {"loc": loc.astype(np.float32), "vel": vel.astype(np.float32),
             "steps": steps}
    mask_spec = payload.get("node_mask")
    if mask_spec is not None:
        mask = decode_array(mask_spec, "<f4", "node_mask")
        if mask.shape != (n,):
            raise PayloadError(f"'node_mask' must be [{n}] "
                               f"(got {list(mask.shape)})")
        scene["node_mask"] = mask.astype(np.float32)
    return scene


# ---- the gateway ------------------------------------------------------------

_GATEWAY_COUNTERS = (
    "requests_total", "predict_ok", "rollout_ok", "shed_inflight",
    "shed_bulk", "shed_queue_full", "timeouts", "bad_requests",
    "unknown_model", "overflow_rejected", "draining_rejected",
    "rollout_overflow", "model_unavailable", "swap_ok", "swap_failed",
    "stream_ok", "stream_cancelled",
    "errors",
)

# priority classes: interactive (predicts — a human is waiting) outranks
# bulk (rollouts — batch trajectory generation). Clients override with the
# priority header (serve.priority.header, default X-Priority).
_PRIORITY_CLASSES = ("interactive", "bulk")

_PRIORITY_DEFAULTS = {
    "enable": True,
    "header": "X-Priority",
    "bulk_max_inflight_frac": 0.75,
    "degrade_shed_rate": 0.05,
    "degrade_p99_ms": None,
    "bulk_retry_factor": 4.0,
    # predicts whose request body is at least this many bytes default to the
    # bulk class (giant scenes hold an executor for long — they must not
    # starve interactive traffic); 0 disables the heuristic
    "bulk_content_bytes": 4_194_304,
}


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # 0.0.0.0 binds are deliberate (serve.gateway.host); rebinding a
    # lingering TIME_WAIT port must not fail a restart
    allow_reuse_address = True

    def handle_error(self, request, client_address):
        # socketserver's default prints a traceback to stderr; keep the
        # event stream as the error surface instead
        obs.event("gateway/socket_error", client=str(client_address))


class Gateway:
    """The HTTP front-end: routing, admission, drain, metrics.

    Handler logic lives on this class (the request handler is a thin
    dispatcher) so tests can drive pieces without sockets.
    """

    def __init__(self, registry: ModelRegistry, *, host: str = "127.0.0.1",
                 port: int = 0, max_inflight: int = 64,
                 drain_grace_s: float = 10.0,
                 metrics_registry: Optional[MetricsRegistry] = None,
                 slo_window_s: float = 60.0,
                 autoscale: Optional[dict] = None,
                 priority: Optional[dict] = None,
                 stream_chunk_steps: int = 8,
                 promote: Optional[dict] = None):
        from distegnn_tpu_torch.obs.slo import SLOMonitor

        self.registry = registry
        self.max_inflight = int(max_inflight)
        self.drain_grace_s = float(drain_grace_s)
        self._reg = metrics_registry or obs.get_registry()
        # rolling-window SLO gauges (slo/window_*): fed per inference
        # request, exported on every GET /metrics render
        self.slo_monitor = SLOMonitor(window_s=slo_window_s)
        self._c = {n: self._reg.counter("gateway/" + n)
                   for n in _GATEWAY_COUNTERS}
        self._inflight_gauge = self._reg.gauge("gateway/inflight")
        self._ready_gauge = self._reg.gauge("gateway/ready")
        self._inflight = 0
        self._inflight_bulk = 0
        self._inflight_lock = threading.Lock()
        self._accepting = True
        self._draining = False
        self._drain_lock = threading.Lock()
        # priority admission: bulk (rollouts) is capped at a fraction of
        # max_inflight so interactive predicts always find headroom, and is
        # deferred outright while the SLO window is degraded
        pk = dict(_PRIORITY_DEFAULTS)
        pk.update(dict(priority or {}))
        self.priority_enable = bool(pk["enable"])
        self.priority_header = str(pk["header"])
        frac = float(pk["bulk_max_inflight_frac"])
        self.bulk_max_inflight = max(1, int(self.max_inflight * frac))
        self.degrade_shed_rate = float(pk["degrade_shed_rate"])
        self.degrade_p99_ms = (None if pk["degrade_p99_ms"] is None
                               else float(pk["degrade_p99_ms"]))
        self.bulk_retry_factor = float(pk["bulk_retry_factor"])
        self.bulk_content_bytes = int(pk["bulk_content_bytes"] or 0)
        self._degraded_cache = (0.0, False)   # (checked_at, degraded)
        self._degraded_lock = threading.Lock()
        # streaming rollouts: server-side chunk size (per-request
        # "chunk_steps" in the body overrides)
        self.stream_chunk_steps = max(1, int(stream_chunk_steps))
        # the elasticity control loop (no-op thread unless autoscale.enable)
        self.autoscaler = ReplicaAutoscaler(
            registry, self.slo_monitor, config=autoscale,
            metrics_registry=self._reg)
        self.autoscaler.start()
        # the promotion conveyor's serving end (no-op unless promote.enable):
        # watches the candidate directory, canaries on a quarantined replica,
        # and reads its shadow sample off this gateway's predict hot path
        from distegnn_tpu_torch.promote.promoter import Promoter
        self.promoter = Promoter(
            registry, self.slo_monitor, config=promote,
            metrics_registry=self._reg)
        self.promoter.start()
        self.httpd = _Server((host, int(port)), _make_handler(self))

    # ---- addresses -------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        host, port = self.httpd.server_address[:2]
        return str(host), int(port)

    @property
    def port(self) -> int:
        return self.address[1]

    def url(self, path: str = "") -> str:
        host, port = self.address
        return f"http://{host}:{port}{path}"

    # ---- lifecycle -------------------------------------------------------
    def serve_forever(self) -> None:
        self._ready_gauge.set(1.0 if self.ready() else 0.0)
        self.httpd.serve_forever(poll_interval=0.1)

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> graceful drain. The handler only spawns the
        drain thread (queue.stop joins a thread — never block the main
        thread's serve loop from its own signal frame)."""
        def _on_signal(signum, frame):
            obs.event("gateway/signal", signum=int(signum))
            threading.Thread(target=self.drain, name="gateway-drain",
                             daemon=True).start()

        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)

    def drain(self) -> None:
        """Stop accepting, flush every queue, wait for in-flight responses,
        then stop the accept loop. Idempotent."""
        with self._drain_lock:
            if self._draining:
                return
            self._draining = True
        self._accepting = False
        self._ready_gauge.set(0.0)
        # the autoscaler must not grow/shrink a fleet that is draining, and
        # the promoter must not start (or hold) a canary across the drain
        self.autoscaler.stop()
        self.promoter.stop()
        obs.event("gateway/drain_begin", inflight=self._inflight)
        # every admitted future resolves; models drain CONCURRENTLY, each
        # bounded by the grace budget (registry.stop). Signature-aware so a
        # wrapped/monkeypatched stop(drain=...) still works.
        stop_kwargs = {"drain": True}
        try:
            import inspect

            if "grace_s" in inspect.signature(self.registry.stop).parameters:
                stop_kwargs["grace_s"] = self.drain_grace_s
        except (TypeError, ValueError):
            pass
        self.registry.stop(**stop_kwargs)
        deadline = time.monotonic() + self.drain_grace_s
        while time.monotonic() < deadline:
            with self._inflight_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.02)
        obs.event("gateway/drain_done", inflight=self._inflight)
        self.httpd.shutdown()

    def close(self) -> None:
        self.autoscaler.stop()
        self.promoter.stop()
        self.httpd.server_close()

    def ready(self) -> bool:
        return self._accepting and self.registry.ready()

    # ---- request handling ------------------------------------------------
    def _route_name(self, method: str, path: str) -> str:
        if method == "POST" and path.startswith("/v1/models/"):
            if path.endswith("/predict"):
                return "predict"
            if path.endswith("/rollout"):
                return "rollout"
            if path.endswith("/swap"):
                return "swap"
        return {"/v1/models": "models", "/metrics": "metrics",
                "/healthz": "healthz", "/readyz": "readyz"}.get(path,
                                                                "unknown")

    def dispatch(self, handler, method: str) -> None:
        path = handler.path.split("?", 1)[0]
        route = self._route_name(method, path)
        # every request gets an id at the edge: echoed back as X-Request-Id
        # and attached to every span/event the request touches downstream
        rid = mint_request_id(handler.headers.get("X-Request-Id"))
        handler.request_id = rid
        self._c["requests_total"].add(1)
        t0 = time.perf_counter()
        with obs.span("serve/http", route=route, method=method,
                      request_id=rid) as sp:
            try:
                status = self._handle(handler, method, path, route)
            except PayloadError as exc:
                self._c["bad_requests"].add(1)
                status = self._send_json(handler, 400, {
                    "error": str(exc), "type": "PayloadError"})
            except ConnectionError:
                status = 499        # client went away mid-response
            except Exception as exc:
                self._c["errors"].add(1)
                obs.event("gateway/handler_error", route=route,
                          error=repr(exc))
                status = self._send_json(handler, 500, {
                    "error": repr(exc), "type": type(exc).__name__})
            sp.set(status=status)
        ms = (time.perf_counter() - t0) * 1e3
        self._reg.reservoir(f"gateway/http_{route}_ms").record(ms)
        self.slo_monitor.observe_http(route, ms, status)

    def _handle(self, h, method: str, path: str, route: str) -> int:
        if route in ("predict", "rollout"):
            if method != "POST":
                return self._send_json(h, 405, {"error": "POST only",
                                                "type": "MethodNotAllowed"})
            return self._infer(h, path, route)
        if route == "swap":
            if method != "POST":
                return self._send_json(h, 405, {"error": "POST only",
                                                "type": "MethodNotAllowed"})
            if not self._accepting:
                self._c["draining_rejected"].add(1)
                return self._send_json(h, 503, {
                    "error": "gateway draining", "type": "Draining"},
                    retry_after=self.drain_grace_s)
            return self._swap(h, path)
        if method != "GET":
            return self._send_json(h, 405, {"error": "GET only",
                                            "type": "MethodNotAllowed"})
        if route == "healthz":
            return self._send_json(h, 200, {"status": "ok"})
        if route == "readyz":
            fully_ready = self.ready()
            self._ready_gauge.set(1.0 if fully_ready else 0.0)
            if not self._accepting:
                return self._send_json(h, 503, {
                    "ready": False, "reason": "draining"},
                    retry_after=self.drain_grace_s)
            health = self.registry.health()
            scale = (self.autoscaler.status()
                     if self.autoscaler.enable else None)
            promo = (self.promoter.status()
                     if self.promoter.enable else None)
            if fully_ready:
                body = {"ready": True, "models": health}
                if scale is not None:
                    body["autoscale"] = scale
                if promo is not None:
                    body["promote"] = promo
                return self._send_json(h, 200, body)
            if self.registry.any_ready():
                # degraded: the broken model 503s on its own routes while
                # every ready model keeps serving — report which is which
                body = {"ready": True, "degraded": True, "models": health}
                if scale is not None:
                    body["autoscale"] = scale
                if promo is not None:
                    body["promote"] = promo
                return self._send_json(h, 200, body)
            return self._send_json(h, 503, {
                "ready": False,
                "reason": "models not warmed or dispatcher down",
                "models": health}, retry_after=1.0)
        if route == "metrics":
            return self._send_text(h, 200, self.render_metrics(),
                                   content_type="text/plain; version=0.0.4")
        if route == "models":
            return self._send_json(h, 200, self.registry.describe())
        return self._send_json(h, 404, {"error": f"no route {path}",
                                        "type": "NotFound"})

    def _priority_of(self, h, route: str) -> str:
        """Admission class for one inference request: the priority header
        when present and sane, else predicts are interactive (a caller is
        blocked on the answer) and rollouts are bulk (batch trajectory
        generation that can wait). Always interactive when priority
        admission is disabled."""
        if not self.priority_enable:
            return "interactive"
        supplied = h.headers.get(self.priority_header)
        if supplied:
            val = str(supplied).strip().lower()
            if val in _PRIORITY_CLASSES:
                return val
        if route == "rollout":
            return "bulk"
        if self.bulk_content_bytes:
            # giant predicts ride the bulk class: they hold an executor for
            # long and must not crowd out latency-sensitive traffic
            try:
                clen = int(h.headers.get("Content-Length") or 0)
            except (TypeError, ValueError):
                clen = 0
            if clen >= self.bulk_content_bytes:
                return "bulk"
        return "interactive"

    def _window_degraded(self) -> bool:
        """True while the rolling SLO window says the gateway is hurting
        (shed rate or predict p99 past the priority thresholds). Cached for
        250ms — admission is on the hot path, the window math is not."""
        now = time.monotonic()
        with self._degraded_lock:
            checked_at, val = self._degraded_cache
            if now - checked_at < 0.25:
                return val
        snap = self.slo_monitor.window_snapshot()
        deg = snap.get("shed_rate", 0.0) > self.degrade_shed_rate
        if not deg and self.degrade_p99_ms is not None:
            p99 = snap.get("predict_p99_ms")
            deg = p99 is not None and p99 > self.degrade_p99_ms
        with self._degraded_lock:
            self._degraded_cache = (now, deg)
        return deg

    def _infer(self, h, path: str, route: str) -> int:
        name = path[len("/v1/models/"):-(len(route) + 1)]
        pri = self._priority_of(h, route)
        if pri == "bulk" and self._window_degraded():
            # the window says interactive traffic is hurting: defer bulk
            # outright so every freed slot goes to interactive work
            self._c["shed_bulk"].add(1)
            return self._send_json(h, 429, {
                "error": "SLO window degraded; bulk work deferred — retry "
                         "with backoff", "type": "BulkDeferred",
                "priority": "bulk"},
                retry_after=1.0 * self.bulk_retry_factor)
        if not self._try_acquire(pri):
            if pri == "bulk":
                # interactive still has headroom; only the bulk share is
                # spoken for — back bulk clients off harder
                self._c["shed_bulk"].add(1)
                return self._send_json(h, 429, {
                    "error": f"bulk admission at "
                             f"bulk_max_inflight={self.bulk_max_inflight}; "
                             "retry with backoff", "type": "Overloaded",
                    "priority": "bulk"},
                    retry_after=0.5 * self.bulk_retry_factor)
            self._c["shed_inflight"].add(1)
            return self._send_json(h, 429, {
                "error": f"gateway at max_inflight={self.max_inflight}; "
                         "retry with backoff", "type": "Overloaded"},
                retry_after=0.5)
        try:
            if not self._accepting:
                self._c["draining_rejected"].add(1)
                return self._send_json(h, 503, {
                    "error": "gateway draining", "type": "Draining"},
                    retry_after=self.drain_grace_s)
            try:
                entry = self.registry.get(name)
            except KeyError:
                self._c["unknown_model"].add(1)
                return self._send_json(h, 404, {
                    "error": f"unknown model {name!r}; "
                             f"see GET /v1/models", "type": "UnknownModel"})
            if entry.state == "failed":
                # per-model shed: THIS model failed warmup; every other
                # model keeps serving (see /readyz degraded detail)
                self._c["model_unavailable"].add(1)
                return self._send_json(h, 503, {
                    "error": f"model {name!r} failed warmup: {entry.error}",
                    "type": "ModelFailed"}, retry_after=30.0)
            if route == "rollout":
                return self._rollout_admitted(h, name, entry)
            return self._predict_admitted(h, name, entry)
        finally:
            self._release(pri)

    def _submit_guarded(self, h, submit_fn, entry=None):
        """Run one queue submit, mapping the admission errors to their HTTP
        statuses. Returns (future, None) or (None, status)."""
        try:
            return submit_fn(), None
        except QueueFullError as exc:
            self._c["shed_queue_full"].add(1)
            return None, self._send_json(
                h, 429, {"error": str(exc), "type": "QueueFull"},
                retry_after=self._queue_retry_after(entry))
        except BucketOverflowError as exc:
            self._c["overflow_rejected"].add(1)
            return None, self._send_json(h, 413, {"error": str(exc),
                                                  "type": "BucketOverflow"})
        except ModelUnavailableError as exc:
            # all replicas of THIS model are down; others keep serving
            self._c["model_unavailable"].add(1)
            return None, self._send_json(
                h, 503, {"error": str(exc), "type": "ModelUnavailable",
                         "model": exc.model},
                retry_after=exc.retry_after_s)
        except RuntimeError as exc:       # queue stopped under our feet
            self._c["draining_rejected"].add(1)
            return None, self._send_json(h, 503, {"error": str(exc),
                                                  "type": "Draining"},
                                         retry_after=1.0)

    @staticmethod
    def _queue_retry_after(entry) -> Optional[float]:
        """429 Retry-After hint from the model's backlog (replica sets
        estimate drain time from queue depth; plain queues get a floor)."""
        if entry is None:
            return 1.0
        hint = getattr(entry.queue, "queue_retry_after_s", None)
        return hint() if callable(hint) else 1.0

    def _predict_admitted(self, h, name: str, entry) -> int:
        payload = self._read_json(h)
        graph = graph_from_payload(payload, entry.feat_nf,
                                   entry.edge_attr_nf)
        encoding = str(payload.get("encoding", "list"))
        if encoding not in ("list", "b64"):
            raise PayloadError("'encoding' must be 'list' or 'b64'")
        t0 = time.perf_counter()
        rid = getattr(h, "request_id", None)
        if (int(graph["loc"].shape[0]) > entry.engine.ladder.max_nodes
                and getattr(entry.engine, "tiled_enabled", False)):
            # above the ladder cap: serve through the tiled executor (one
            # fixed-shape tile program) instead of 413-rejecting. Branch
            # BEFORE session prep — the monolithic prepare would raise
            # BucketOverflowError while bucketing the plan.
            return self._predict_tiled(h, name, entry, payload, graph,
                                       encoding, rid, t0)
        session = None
        bucket = perm = None
        session_id = payload.get("session_id")
        cache = getattr(entry.engine, "prep_cache", None)
        if session_id is not None and cache is not None:
            prepped = cache.prepare(str(session_id), graph, request_id=rid)
            graph, bucket, perm = prepped.graph, prepped.bucket, prepped.perm
            session = {"id": str(session_id), "hit": prepped.hit,
                       "prep_ms": round((time.perf_counter() - t0) * 1e3, 3)}
        fut, status = self._submit_guarded(
            h, lambda: entry.queue.submit(graph, bucket=bucket,
                                          request_id=rid), entry)
        if fut is None:
            return status
        try:
            out = fut.result()            # bounded by the hard deadline
        except RequestTimeoutError as exc:
            self._c["timeouts"].add(1)
            return self._send_json(h, 504, {"error": str(exc),
                                            "type": "RequestTimeout"})
        except ModelUnavailableError as exc:
            # admitted, then every replica (and failover) died under it
            self._c["model_unavailable"].add(1)
            return self._send_json(
                h, 503, {"error": str(exc), "type": "ModelUnavailable",
                         "model": exc.model},
                retry_after=exc.retry_after_s)
        if self.promoter.enable:
            # promotion shadow tee: mirror this (graph, live output) pair to
            # the canary replica. Sampled + bounded inside tee, and the
            # shadow response never reaches this client — the live `out` is
            # already in hand and is what gets encoded below.
            self.promoter.tee(name, graph, bucket, rid, out)
        if perm is not None:
            # the session plan served the model a Morton-relabeled graph;
            # answer in the client's original node order
            unperm = np.empty_like(out)
            unperm[perm] = out
            out = unperm
        meta = dict(fut.meta)
        self._c["predict_ok"].add(1)
        body = {
            "request_id": rid,
            "model": name,
            "n": int(graph["loc"].shape[0]),
            "prediction": encode_array(out, encoding),
            "bucket": {"n": meta.get("bucket_n"), "e": meta.get("bucket_e")},
            "queue_ms": meta.get("queue_ms"),
            "compute_ms": meta.get("compute_ms"),
            "batch_filled": meta.get("batch_filled"),
            "total_ms": round((time.perf_counter() - t0) * 1e3, 3),
        }
        if session is not None:
            body["session"] = session
        return self._send_json(h, 200, body)

    # ---- tiled predicts (above the ladder cap) ---------------------------
    @staticmethod
    def _tiled_stats(out: dict) -> dict:
        stats = {
            "tiles": out.get("tiles"),
            "layers": out.get("layers"),
            "devices": out.get("devices", 1),
            "rounds": out.get("rounds"),
            "padded_nodes": out.get("padded_nodes"),
            "halo_fraction": round(float(out.get("halo_fraction", 0.0)), 6),
            "work_imbalance": round(float(out.get("work_imbalance", 0.0)), 4),
            "stall_fraction": round(float(out.get("stall_fraction", 0.0)), 6),
            "prep_ms": out.get("prep_ms"),
            "compute_ms": out.get("total_ms"),
        }
        # mesh-round extras (serve/mesh_tiled.py) when devices > 1
        for key in ("round_ms", "halo_gather_ms", "round_imbalance"):
            if key in out:
                stats[key] = round(float(out[key]), 4)
        return stats

    def _predict_tiled(self, h, name: str, entry, payload: dict, graph: dict,
                       encoding: str, rid, t0) -> int:
        """Predict for a scene above the ladder cap: tile plan (session-
        cached), tiled executor, buffered JSON — or NDJSON per-tile progress
        on ``?stream=1``."""
        engine = entry.engine
        session = None
        session_id = payload.get("session_id")
        cache = getattr(engine, "prep_cache", None)
        if session_id is not None and cache is not None:
            plan, hit = cache.prepare_tile(
                str(session_id), graph,
                lambda: engine.tiled.plan(graph), request_id=rid)
            graph["_tile_plan"] = plan
            session = {"id": str(session_id), "hit": hit,
                       "prep_ms": round((time.perf_counter() - t0) * 1e3, 3)}
        stream = self._wants_stream(h)
        supports = getattr(entry.queue, "supports_streaming", None)
        if stream and callable(supports) and not supports():
            # no in-process replica to push progress chunks: fall back to a
            # buffered response (same result, no per-tile lines)
            stream = False
        if not stream:
            fut, status = self._submit_guarded(
                h, lambda: entry.queue.submit_tiled(graph, request_id=rid),
                entry)
            if fut is None:
                return status
            try:
                out = fut.result()        # bounded by the scaled deadline
            except RequestTimeoutError as exc:
                self._c["timeouts"].add(1)
                return self._send_json(h, 504, {"error": str(exc),
                                                "type": "RequestTimeout"})
            except ModelUnavailableError as exc:
                self._c["model_unavailable"].add(1)
                return self._send_json(
                    h, 503, {"error": str(exc), "type": "ModelUnavailable",
                             "model": exc.model},
                    retry_after=exc.retry_after_s)
            meta = dict(fut.meta)
            self._c["predict_ok"].add(1)
            body = {
                "request_id": rid,
                "model": name,
                "n": int(out["n"]),
                "prediction": encode_array(out["prediction"], encoding),
                "tiled": self._tiled_stats(out),
                "queue_ms": meta.get("queue_ms"),
                "compute_ms": meta.get("compute_ms"),
                "total_ms": round((time.perf_counter() - t0) * 1e3, 3),
            }
            if session is not None:
                body["session"] = session
            return self._send_json(h, 200, body)
        return self._tiled_streamed(h, name, entry, graph, encoding, rid,
                                    t0, session)

    def _tiled_streamed(self, h, name: str, entry, graph: dict,
                        encoding: str, rid, t0, session) -> int:
        """``POST .../predict?stream=1`` above the ladder cap: one NDJSON
        progress line per completed tile (sequential) or per completed
        ROUND of D tiles (serve.tiled.devices > 1), then a final line
        carrying the prediction. A client disconnect cancels the executor
        at the next tile/round boundary."""
        sink = StreamSink()
        fut, status = self._submit_guarded(
            h, lambda: entry.queue.submit_tiled(graph, request_id=rid,
                                                stream=sink), entry)
        if fut is None:
            return status
        tiled = getattr(entry.engine, "tiled", None)
        factor = max(float(getattr(tiled, "timeout_factor", 1.0) or 1.0), 1.0)
        deadline = time.monotonic() + factor * (
            float(getattr(entry.queue, "request_timeout", 30.0))
            + float(getattr(entry.queue, "result_margin", 5.0)))
        self._begin_chunked(h, rid)
        err_line = None
        try:
            while True:
                try:
                    kind, a, b = sink.next(timeout=0.25)
                except _pyqueue.Empty:
                    if time.monotonic() > deadline:
                        sink.cancel()
                        self._c["timeouts"].add(1)
                        err_line = {"error": "tiled stream timed out",
                                    "type": "RequestTimeout"}
                        break
                    continue
                if kind == "chunk":
                    # per-tile lines from the sequential executor carry
                    # "tile"; per-ROUND lines from the mesh executor
                    # (serve.tiled.devices > 1) carry "round"/"n_rounds"
                    info = dict(b or {})
                    self._write_chunk(h, json.dumps(
                        {k: info[k] for k in
                         ("layer", "tile", "round", "n_layers", "n_tiles",
                          "n_rounds") if k in info}) + "\n")
                elif kind == "done":
                    out = a or {}
                    pred = out.get("prediction")
                    self._c["predict_ok"].add(1)
                    self._c["stream_ok"].add(1)
                    line = {
                        "done": True, "request_id": rid, "model": name,
                        "n": out.get("n"),
                        "prediction": (encode_array(pred, encoding)
                                       if pred is not None else None),
                        "tiled": self._tiled_stats(out),
                        "cancelled": bool(out.get("cancelled", False)),
                        "total_ms": round((time.perf_counter() - t0) * 1e3,
                                          3),
                    }
                    if session is not None:
                        line["session"] = session
                    self._write_chunk(h, json.dumps(line) + "\n")
                    break
                else:           # ("error", exc, None)
                    self._count_stream_error(a)
                    err_line = {"error": str(a), "type": type(a).__name__}
                    break
            if err_line is not None:
                err_line["request_id"] = rid
                self._write_chunk(h, json.dumps(err_line) + "\n")
            self._end_chunked(h)
        except ConnectionError:
            sink.cancel()
            self._c["stream_cancelled"].add(1)
            raise
        return 200

    def _rollout_admitted(self, h, name: str, entry) -> int:
        if not entry.engine.rollout_enabled:
            return self._send_json(h, 501, {
                "error": f"model {name!r} was built without serve.rollout; "
                         "set serve.rollout in its config to enable the "
                         "endpoint", "type": "RolloutDisabled"})
        payload = self._read_json(h)
        scene = scene_from_payload(payload)
        encoding = str(payload.get("encoding", "list"))
        if encoding not in ("list", "b64"):
            raise PayloadError("'encoding' must be 'list' or 'b64'")
        t0 = time.perf_counter()
        rid = getattr(h, "request_id", None)
        if self._wants_stream(h):
            return self._rollout_streamed(h, name, entry, payload, scene,
                                          encoding, rid, t0)
        fut, status = self._submit_guarded(
            h, lambda: entry.queue.submit_rollout(scene, request_id=rid),
            entry)
        if fut is None:
            return status
        try:
            traj = fut.result()           # bounded by the hard deadline
        except RequestTimeoutError as exc:
            self._c["timeouts"].add(1)
            return self._send_json(h, 504, {"error": str(exc),
                                            "type": "RequestTimeout"})
        except ModelUnavailableError as exc:
            self._c["model_unavailable"].add(1)
            return self._send_json(
                h, 503, {"error": str(exc), "type": "ModelUnavailable",
                         "model": exc.model},
                retry_after=exc.retry_after_s)
        except RolloutOverflowError as exc:
            # a well-formed request whose scene outgrew the model's static
            # neighbor capacity — the client's to fix, not a server error
            self._c["rollout_overflow"].add(1)
            return self._send_json(h, 422, {"error": str(exc),
                                            "type": "RolloutOverflow"})
        meta = dict(fut.meta)
        self._c["rollout_ok"].add(1)
        return self._send_json(h, 200, {
            "request_id": rid,
            "model": name,
            "n": int(scene["loc"].shape[0]),
            "steps": int(scene["steps"]),
            "trajectory": encode_array(traj, encoding),
            "bucket": {"n": meta.get("bucket_n")},
            "queue_ms": meta.get("queue_ms"),
            "compute_ms": meta.get("compute_ms"),
            "batch_filled": meta.get("batch_filled"),
            "total_ms": round((time.perf_counter() - t0) * 1e3, 3),
        })

    # ---- chunked streaming rollouts --------------------------------------
    @staticmethod
    def _wants_stream(h) -> bool:
        """``?stream=1`` on the rollout URL (dispatch strips the query
        before routing; the raw handler path still carries it)."""
        vals = parse_qs(urlsplit(h.path).query).get("stream")
        return bool(vals) and vals[-1].lower() in ("1", "true", "yes", "on")

    def _stream_chunk(self, payload: dict) -> int:
        chunk = payload.get("chunk_steps")
        if chunk is None:
            return self.stream_chunk_steps
        try:
            chunk = int(chunk)
        except (TypeError, ValueError):
            raise PayloadError("'chunk_steps' must be an integer >= 1") \
                from None
        if chunk < 1:
            raise PayloadError(f"'chunk_steps' must be >= 1 (got {chunk})")
        return chunk

    def _rollout_streamed(self, h, name: str, entry, payload: dict,
                          scene: dict, encoding: str, rid, t0) -> int:
        """``POST .../rollout?stream=1``: HTTP chunked transfer, one NDJSON
        line per trajectory chunk so step 1 arrives while step 500 is still
        computing, then a summary line. A client disconnect (detected at the
        next chunk write) cancels the remaining compute at the next chunk
        boundary and frees the admission slot."""
        chunk = self._stream_chunk(payload)
        scene = dict(scene)
        scene["chunk_steps"] = chunk
        supports = getattr(entry.queue, "supports_streaming", None)
        if callable(supports) and not supports():
            # process-worker replicas can't push chunks over the IPC
            # channel: serve one buffered rollout re-chunked at the edge —
            # same wire contract, just without the early first chunk
            return self._rollout_stream_fallback(h, name, entry, scene,
                                                 encoding, rid, t0, chunk)
        sink = StreamSink()
        fut, status = self._submit_guarded(
            h, lambda: entry.queue.submit_rollout(scene, request_id=rid,
                                                  stream=sink), entry)
        if fut is None:
            return status
        # admitted: from here the response is chunked NDJSON. Bound the
        # consumer loop by the queue's own hard deadline so a wedged
        # replica can't hold the socket forever.
        deadline = time.monotonic() \
            + float(getattr(entry.queue, "request_timeout", 30.0)) \
            + float(getattr(entry.queue, "result_margin", 5.0))
        self._begin_chunked(h, rid)
        steps_done = 0
        err_line = None
        try:
            while True:
                try:
                    kind, a, b = sink.next(timeout=0.25)
                except _pyqueue.Empty:
                    if time.monotonic() > deadline:
                        sink.cancel()
                        self._c["timeouts"].add(1)
                        err_line = {"error": "stream timed out",
                                    "type": "RequestTimeout"}
                        break
                    continue
                if kind == "chunk":
                    start, traj = int(a), b
                    self._write_chunk(h, json.dumps({
                        "start_step": start,
                        "steps": int(traj.shape[0]),
                        "chunk": encode_array(traj, encoding)}) + "\n")
                    steps_done = start + int(traj.shape[0])
                elif kind == "done":
                    summary = a or {}
                    self._c["rollout_ok"].add(1)
                    self._c["stream_ok"].add(1)
                    self._write_chunk(h, json.dumps({
                        "done": True, "request_id": rid, "model": name,
                        "n": int(scene["loc"].shape[0]),
                        "steps": int(summary.get("steps_done", steps_done)),
                        "steps_total": int(summary.get("steps_total",
                                                       scene["steps"])),
                        "cancelled": bool(summary.get("cancelled", False)),
                        "total_ms": round((time.perf_counter() - t0) * 1e3,
                                          3)}) + "\n")
                    break
                else:           # ("error", exc, None)
                    self._count_stream_error(a)
                    err_line = {"error": str(a), "type": type(a).__name__}
                    break
            if err_line is not None:
                err_line["request_id"] = rid
                self._write_chunk(h, json.dumps(err_line) + "\n")
            self._end_chunked(h)
        except ConnectionError:
            # the client went away mid-stream (EPIPE or RST, depending on
            # timing): flag the sink so the engine stops at the next chunk
            # boundary (it emits serve/stream_cancelled with the
            # skipped-step count), free the slot, and let dispatch record
            # the 499
            sink.cancel()
            self._c["stream_cancelled"].add(1)
            raise
        return 200

    def _rollout_stream_fallback(self, h, name: str, entry, scene: dict,
                                 encoding: str, rid, t0, chunk: int) -> int:
        """Streaming contract over a non-streaming backend: run the buffered
        rollout, then replay it as NDJSON chunks. The same chunk lines, no
        early first chunk (the backend can't provide one)."""
        fut, status = self._submit_guarded(
            h, lambda: entry.queue.submit_rollout(scene, request_id=rid),
            entry)
        if fut is None:
            return status
        try:
            traj = fut.result()
        except RequestTimeoutError as exc:
            self._c["timeouts"].add(1)
            return self._send_json(h, 504, {"error": str(exc),
                                            "type": "RequestTimeout"})
        except ModelUnavailableError as exc:
            self._c["model_unavailable"].add(1)
            return self._send_json(
                h, 503, {"error": str(exc), "type": "ModelUnavailable",
                         "model": exc.model},
                retry_after=exc.retry_after_s)
        except RolloutOverflowError as exc:
            self._c["rollout_overflow"].add(1)
            return self._send_json(h, 422, {"error": str(exc),
                                            "type": "RolloutOverflow"})
        steps = int(traj.shape[0])
        self._begin_chunked(h, rid)
        try:
            done = 0
            while done < steps:
                c = min(chunk, steps - done)
                self._write_chunk(h, json.dumps({
                    "start_step": done, "steps": c,
                    "chunk": encode_array(traj[done:done + c],
                                          encoding)}) + "\n")
                done += c
            self._c["rollout_ok"].add(1)
            self._c["stream_ok"].add(1)
            self._write_chunk(h, json.dumps({
                "done": True, "request_id": rid, "model": name,
                "n": int(scene["loc"].shape[0]), "steps": steps,
                "steps_total": steps, "cancelled": False,
                "total_ms": round((time.perf_counter() - t0) * 1e3,
                                  3)}) + "\n")
            self._end_chunked(h)
        except ConnectionError:
            self._c["stream_cancelled"].add(1)
            raise
        return 200

    def _count_stream_error(self, exc) -> None:
        if isinstance(exc, RequestTimeoutError):
            self._c["timeouts"].add(1)
        elif isinstance(exc, RolloutOverflowError):
            self._c["rollout_overflow"].add(1)
        elif isinstance(exc, ModelUnavailableError):
            self._c["model_unavailable"].add(1)
        else:
            self._c["errors"].add(1)

    @staticmethod
    def _begin_chunked(h, rid) -> None:
        h.send_response(200)
        h.send_header("Content-Type", "application/x-ndjson")
        h.send_header("Transfer-Encoding", "chunked")
        if rid is not None:
            h.send_header("X-Request-Id", rid)
        h.end_headers()

    @staticmethod
    def _write_chunk(h, text: str) -> None:
        data = text.encode("utf-8")
        h.wfile.write(f"{len(data):x}\r\n".encode("ascii"))
        h.wfile.write(data)
        h.wfile.write(b"\r\n")
        h.wfile.flush()

    @staticmethod
    def _end_chunked(h) -> None:
        h.wfile.write(b"0\r\n\r\n")
        h.wfile.flush()

    # ---- blue/green hot-swap --------------------------------------------
    def _swap(self, h, path: str) -> int:
        """POST /v1/models/<name>/swap {"checkpoint": <path>} — blue/green
        params swap under load (registry.swap: checksummed restore, per-rung
        canary, one-at-a-time replica flips, auto-rollback)."""
        name = path[len("/v1/models/"):-len("/swap")]
        try:
            entry = self.registry.get(name)
        except KeyError:
            self._c["unknown_model"].add(1)
            return self._send_json(h, 404, {
                "error": f"unknown model {name!r}; see GET /v1/models",
                "type": "UnknownModel"})
        payload = self._read_json(h)
        ckpt = payload.get("checkpoint")
        if not ckpt or not isinstance(ckpt, str):
            raise PayloadError("'checkpoint' (a path string) is required")
        try:
            info = entry.swap(ckpt)
        except SwapInProgressError as exc:
            self._c["swap_failed"].add(1)
            return self._send_json(h, 409, {"error": str(exc),
                                            "type": "SwapInProgress"},
                                   retry_after=1.0)
        except SwapError as exc:
            # the swap REJECTED the checkpoint and rolled back — serving
            # params are unchanged; the client's checkpoint is the problem
            self._c["swap_failed"].add(1)
            return self._send_json(h, 422, {
                "error": str(exc), "type": "SwapFailed",
                "stage": exc.stage, "rolled_back": exc.rolled_back})
        self._c["swap_ok"].add(1)
        info["request_id"] = getattr(h, "request_id", None)
        return self._send_json(h, 200, info)

    # ---- metrics ---------------------------------------------------------
    def render_metrics(self) -> str:
        """Prometheus text: the gateway/process-wide registry, then each
        model's serve registry under a per-model name prefix (distinct
        names instead of labels — the renderer is label-free)."""
        with self._inflight_lock:
            self._inflight_gauge.set(self._inflight)
        self._ready_gauge.set(1.0 if self.ready() else 0.0)
        self.slo_monitor.export(self._reg, self.registry)
        if self.promoter.enable:
            self.promoter.export()   # conveyor + drift gauges stay fresh
        # per-replica health gauges: 1 = running with a live dispatcher
        for name, entry in self.registry.items():
            for rh in entry.replicas.health():
                up = 1.0 if (rh["state"] == "running" and rh["alive"]) else 0.0
                self._reg.gauge(
                    f"gateway/replica_{name}_{rh['replica']}_up").set(up)
                if rh.get("backend") == "process":
                    # per-worker liveness detail: a climbing heartbeat age
                    # is the early-warning signal for a wedging child
                    age = rh.get("heartbeat_age_s")
                    self._reg.gauge(
                        f"gateway/worker_{name}_{rh['replica']}_"
                        f"heartbeat_age_s").set(
                            float(age) if age is not None else -1.0)
                    self._reg.gauge(
                        f"gateway/worker_{name}_{rh['replica']}_"
                        f"restarts").set(float(rh.get("restarts", 0)))
            self._reg.gauge(f"gateway/replicas_{name}_available").set(
                entry.replicas.available())
        parts = [self._reg.render_prometheus(prefix="distegnn")]
        for name, entry in self.registry.items():
            parts.append(entry.engine.metrics.registry.render_prometheus(
                prefix=_prom_name(f"distegnn_model_{name}")))
        return "".join(parts)

    # ---- plumbing --------------------------------------------------------
    def _try_acquire(self, priority: str = "interactive") -> bool:
        bulk = self.priority_enable and priority == "bulk"
        with self._inflight_lock:
            if self._inflight >= self.max_inflight:
                return False
            if bulk and self._inflight_bulk >= self.bulk_max_inflight:
                return False
            self._inflight += 1
            if bulk:
                self._inflight_bulk += 1
            return True

    def _release(self, priority: str = "interactive") -> None:
        bulk = self.priority_enable and priority == "bulk"
        with self._inflight_lock:
            self._inflight -= 1
            if bulk:
                self._inflight_bulk -= 1

    @staticmethod
    def _read_json(h) -> dict:
        try:
            length = int(h.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            raise PayloadError("bad Content-Length") from None
        if length <= 0:
            raise PayloadError("empty body (Content-Length required)")
        body = h.rfile.read(length)
        try:
            return json.loads(body)
        except json.JSONDecodeError as exc:
            raise PayloadError(f"invalid JSON: {exc}") from None

    @staticmethod
    def _send_text(h, status: int, text: str,
                   content_type: str = "text/plain",
                   retry_after: Optional[float] = None) -> int:
        body = text.encode("utf-8")
        h.send_response(status)
        h.send_header("Content-Type", content_type)
        h.send_header("Content-Length", str(len(body)))
        rid = getattr(h, "request_id", None)
        if rid is not None:
            h.send_header("X-Request-Id", rid)
        if retry_after is not None:
            # decimal seconds (spec allows integers; our client and most
            # libraries parse floats) — derived from queue depth / breaker
            # cooldown so clients back off instead of hammering a shed
            h.send_header("Retry-After", str(round(max(retry_after, 0.1), 3)))
        h.end_headers()
        h.wfile.write(body)
        return status

    @classmethod
    def _send_json(cls, h, status: int, obj,
                   retry_after: Optional[float] = None) -> int:
        return cls._send_text(h, status, json.dumps(obj),
                              content_type="application/json",
                              retry_after=retry_after)


def _make_handler(gateway: Gateway):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "distegnn-gateway"

        def log_message(self, format, *args):
            pass    # access logging is the serve/http span, not stderr

        def do_GET(self):
            gateway.dispatch(self, "GET")

        def do_POST(self):
            gateway.dispatch(self, "POST")

    return Handler
