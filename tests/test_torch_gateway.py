"""The port's HTTP gateway (``serve/transport.py``, ``serve/registry.py``,
``serve/gateway.py``) on the CPU, held against the JAX package's gateway.

One gateway of each package boots once for the file, at the narrow
``nbody_serve`` width (H=16, L=2, C=3) with two models routed by
``serve.models``: ``nbody`` (rollouts, a session cache, a queue of 4) and
``plain`` (no ``serve.rollout``, ``max_nodes`` 256). The JAX parameters are
carried into the port. The same requests go through both, over real
sockets.

Bounds: predicted coordinates and trajectories within 1e-5 absolute;
everything else exact — status codes, JSON keys, error types, the swap's
bodies and the set of ``/metrics`` names (their values may differ).
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import base64
import http.client
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from distegnn_tpu.config import ConfigDict as JConfig
from distegnn_tpu.config import _merge as jmerge
from distegnn_tpu.obs.metrics import MetricsRegistry as JRegistry
from distegnn_tpu.serve.registry import ModelEntry as JEntry
from distegnn_tpu.serve.registry import ModelRegistry as JModels
from distegnn_tpu.serve.transport import Gateway as JGateway
from distegnn_tpu.train.checkpoint import save_checkpoint as jax_save
from distegnn_tpu_torch.convert import params_from_jax
from distegnn_tpu_torch.obs.metrics import MetricsRegistry as PRegistry
from distegnn_tpu_torch.serve.registry import ModelRegistry as PModels
from distegnn_tpu_torch.serve.transport import Gateway as PGateway
from distegnn_tpu_torch.serve.transport import graph_from_payload
from distegnn_tpu_torch.train.checkpoint import save_checkpoint as port_save
from distegnn_tpu_torch.train.step import TrainState, make_optimizer
from torch_serve_pair import (ATOL, ROLLOUT, carry_params, configs,
                              jax_engine, scene)

MODELS = [
    {"name": "nbody", "overrides": {"serve": {"rollout": ROLLOUT,
                                              "queue_capacity": 4}}},
    {"name": "plain", "overrides": {"serve": {"max_nodes": 256}}},
]


class _Client:
    def __init__(self, gw):
        self.host, self.port = gw.address

    def call(self, method, path, body=None, raw=None, headers=None):
        c = http.client.HTTPConnection(self.host, self.port, timeout=120)
        data = raw if raw is not None else (
            None if body is None else json.dumps(body).encode())
        hdr = {"Content-Type": "application/json", **(headers or {})}
        c.request(method, path, body=data, headers=hdr)
        r = c.getresponse()
        text = r.read().decode()
        c.close()
        try:
            return r.status, json.loads(text), dict(r.getheaders())
        except json.JSONDecodeError:
            return r.status, text, dict(r.getheaders())


@pytest.fixture(scope="module")
def live():
    jcfg, pcfg = configs({"serve.models": MODELS})
    preg = PModels.from_config(pcfg, device="cpu")
    # the JAX registry as its from_config builds it, with numpy-drawn
    # parameters in place of a compiled flax init
    jentries = {}
    for i, item in enumerate(MODELS):
        cfg = JConfig(jmerge(jcfg.to_dict(), item["overrides"]))
        eng, q = jax_engine(cfg, seed=i)
        jentries[item["name"]] = JEntry(item["name"], eng, q, 1, 2,
                                        config=cfg)
    jreg = JModels(jentries)
    for name in jreg.names():
        carry_params(jreg.get(name).engine,
                     [r.engine for r in preg.get(name).replicas.replicas])
    gws = []
    for reg, Gw, Reg in ((jreg, JGateway, JRegistry),
                         (preg, PGateway, PRegistry)):
        reg.start()
        reg.warmup([48])
        gw = Gw(reg, port=0, max_inflight=16, drain_grace_s=10.0,
                metrics_registry=Reg())
        threading.Thread(target=gw.serve_forever, daemon=True).start()
        gws.append(gw)
    yield SimpleNamespace(jgw=gws[0], pgw=gws[1], jreg=jreg, preg=preg,
                          j=_Client(gws[0]), p=_Client(gws[1]))
    for gw in gws:
        gw.drain()
        gw.close()


def _both(live, method, path, body=None, **kw):
    return live.j.call(method, path, body, **kw), \
        live.p.call(method, path, body, **kw)


def _same_shape(a, b):
    """Same status, same JSON keys (recursively for dicts), same error
    type."""
    assert a[0] == b[0], (a, b)
    if isinstance(a[1], dict):
        assert set(a[1]) == set(b[1]), (sorted(a[1]), sorted(b[1]))
        if "type" in a[1]:
            assert a[1]["type"] == b[1]["type"]


def _payload(g, encoding="list"):
    if encoding == "b64":
        def enc(a, dt="<f4"):
            a = np.ascontiguousarray(a, dtype=dt)
            return {"b64": base64.b64encode(a.tobytes()).decode(),
                    "shape": list(a.shape)}

        return {"positions": enc(g["loc"]), "velocities": enc(g["vel"]),
                "node_feat": enc(g["node_feat"]),
                "edge_attr": enc(g["edge_attr"]),
                "edge_index": enc(g["edge_index"], "<i4"), "encoding": "b64"}
    return {"positions": g["loc"].tolist(), "velocities": g["vel"].tolist(),
            "node_feat": g["node_feat"].tolist(),
            "edge_index": g["edge_index"].tolist(),
            "edge_attr": g["edge_attr"].tolist()}


def _decode(spec):
    if isinstance(spec, dict):
        return np.frombuffer(base64.b64decode(spec["b64"]),
                             "<f4").reshape(spec["shape"])
    return np.asarray(spec, np.float32)


PREDICTS = [("nbody", 40, "list", None), ("nbody", 100, "b64", None),
            ("plain", 40, "list", None), ("nbody", 44, "list", "s1"),
            ("nbody", 44, "list", "s1")]


@pytest.mark.parametrize("i", range(len(PREDICTS)))
def test_predict_matches_jax(live, i):
    model, n, encoding, session = PREDICTS[i]
    body = _payload(scene(n, 7 + n), encoding)
    if session:
        body["session_id"] = session
    a, b = _both(live, "POST", f"/v1/models/{model}/predict", body)
    _same_shape(a, b)
    assert a[0] == 200
    for k in ("model", "n", "bucket", "batch_filled"):
        assert a[1][k] == b[1][k], k
    if session:
        assert a[1]["session"]["hit"] == b[1]["session"]["hit"] == (i == 4)
    assert b[2]["X-Request-Id"] == b[1]["request_id"]
    np.testing.assert_allclose(_decode(b[1]["prediction"]),
                               _decode(a[1]["prediction"]), rtol=0,
                               atol=ATOL)


def test_predict_from_a_radius_matches_jax(live):
    rng = np.random.default_rng(3)
    body = {"positions": rng.uniform(0, 1, (50, 3)).tolist(), "radius": 0.3}
    a, b = _both(live, "POST", "/v1/models/nbody/predict", body)
    _same_shape(a, b)
    np.testing.assert_allclose(_decode(b[1]["prediction"]),
                               _decode(a[1]["prediction"]), rtol=0,
                               atol=ATOL)
    g = graph_from_payload(body, 1, 2)
    assert g["edge_index"].shape[1] > 50


def _rollout_body(n=60, steps=2, seed=5):
    rng = np.random.default_rng(seed)
    return {"positions": rng.uniform(0, 1, (n, 3)).tolist(),
            "velocities": (rng.normal(size=(n, 3)) * 0.01).tolist(),
            "steps": steps}


def _stream(client, path, body):
    c = http.client.HTTPConnection(client.host, client.port, timeout=120)
    c.request("POST", path, body=json.dumps(body).encode(),
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    lines = [json.loads(x) for x in r.read().decode().splitlines() if x]
    c.close()
    return r.status, r.getheader("Transfer-Encoding"), lines


def test_rollout_and_stream_match_jax(live):
    body = _rollout_body()
    a, b = _both(live, "POST", "/v1/models/nbody/rollout", body)
    _same_shape(a, b)
    assert a[0] == 200 and b[1]["steps"] == 2
    whole = _decode(b[1]["trajectory"])
    np.testing.assert_allclose(whole, _decode(a[1]["trajectory"]), rtol=0,
                               atol=ATOL)
    path = "/v1/models/nbody/rollout?stream=1"
    sbody = dict(body, chunk_steps=1)
    js, ps = _stream(live.j, path, sbody), _stream(live.p, path, sbody)
    assert ps[:2] == js[:2] == (200, "chunked")
    assert [sorted(x) for x in ps[2]] == [sorted(x) for x in js[2]]
    assert [x.get("start_step") for x in ps[2]] == [0, 1, None]
    assert ps[2][-1]["done"] and not ps[2][-1]["cancelled"]
    chunks = np.concatenate([_decode(x["chunk"]) for x in ps[2][:-1]])
    np.testing.assert_allclose(chunks, np.concatenate(
        [_decode(x["chunk"]) for x in js[2][:-1]]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(chunks, whole, rtol=0, atol=ATOL)


ERRORS = [
    ("POST", "/v1/models/nbody/predict", None, b"{not json", 400),
    ("POST", "/v1/models/nbody/predict", {"radius": 0.3}, None, 400),
    ("POST", "/v1/models/nbody/predict", {"positions": [[0, 0, 0]],
                                          "edge_index": [[0], [5]]}, None,
     400),
    ("POST", "/v1/models/nope/predict", {"positions": [[0, 0, 0]],
                                         "radius": 0.1}, None, 404),
    ("GET", "/nope", None, None, 404),
    ("GET", "/v1/models/nbody/predict", None, None, 404),
    ("POST", "/v1/models/plain/predict", "big", None, 413),
    ("POST", "/v1/models/plain/rollout", _rollout_body(), None, 501),
    ("POST", "/v1/models/nbody/rollout", {"positions": [[0, 0, 0]],
                                          "steps": 0}, None, 400),
]


@pytest.mark.parametrize("i", range(len(ERRORS)))
def test_errors_match_jax(live, i):
    method, path, body, raw, status = ERRORS[i]
    if body == "big":
        g = scene(300, 1)
        body = _payload(g)
    a, b = _both(live, method, path, body, raw=raw)
    _same_shape(a, b)
    assert b[0] == status


def test_queue_full_is_429_in_both(live):
    """A wedged dispatcher fills the 4-slot ingress: the overflow sheds with
    429 QueueFull and a Retry-After; every admitted request gets its 200.

    The order is fixed, not timed: the first request goes alone, and the
    other six follow once the dispatcher holds it (an idle dispatcher
    absorbs what has arrived before it sees the wedge, and four absorbed
    together would run as a full batch); the dispatcher stays wedged until
    each of the 7 is either queued or answered, then ``wedge(0)`` releases
    it. The queued deadline is raised for this test alone, so a loaded host
    cannot turn the admitted requests into 504s before the release."""
    out = {}
    for side, reg in (("j", live.jreg), ("p", live.preg)):
        client = getattr(live, side)
        queue = reg.get("nbody").replicas.replicas[0].queue
        hold = queue.request_timeout
        queue.request_timeout = 60.0
        queue.wedge(3600.0)
        res = [None] * 7
        body = _payload(scene(40, 11))

        def go(k):
            res[k] = client.call("POST", "/v1/models/nbody/predict", body)

        def wait_for(pred):
            deadline = time.perf_counter() + 60.0
            while not pred() and time.perf_counter() < deadline:
                time.sleep(0.005)

        ts = [threading.Thread(target=go, args=(k,)) for k in range(7)]
        try:
            ts[0].start()
            wait_for(lambda: res[0] is not None or (
                queue.depth() == 1 and queue._ingress.empty()))
            for t in ts[1:]:
                t.start()
            wait_for(lambda: sum(r is not None for r in res)
                     + queue.depth() >= 7)
        finally:
            queue.wedge(0)
            for t in ts:
                t.join(60)
            queue.request_timeout = hold
        out[side] = res
    codes = {s: [None if r is None else r[0] for r in out[s]] for s in "jp"}
    for side in "jp":
        assert set(codes[side]) == {200, 429}, codes
    shed = [next(r for r in out[s] if r[0] == 429) for s in "jp"]
    _same_shape(*shed)
    assert shed[1][1]["type"] == "QueueFull" and "Retry-After" in shed[1][2]


def test_ops_routes_match_jax(live):
    for path in ("/healthz", "/readyz", "/v1/models"):
        a, b = _both(live, "GET", path)
        _same_shape(a, b)
        assert a[0] == 200
    a, b = _both(live, "GET", "/v1/models")
    for ja, pa in zip(a[1]["models"], b[1]["models"]):
        assert set(ja) == set(pa)
        for k in ("name", "state", "warmed_rungs", "max_batch", "ladder",
                  "rollout", "replicas_available", "params_version"):
            assert ja[k] == pa[k], k
        assert [sorted(r) for r in ja["replicas"]] == \
            [sorted(r) for r in pa["replicas"]]
    a, b = _both(live, "GET", "/readyz")
    assert a[1]["models"].keys() == b[1]["models"].keys()
    for name in a[1]["models"]:
        assert a[1]["models"][name] == b[1]["models"][name]


def _ckpts(live, tmp_path):
    """(JAX checkpoint, port checkpoint) of the same new parameters, and of
    a copy with a NaN in every leaf."""
    import jax

    jparams = jax.tree.map(lambda x: np.asarray(x) * 1.5,
                           live.jreg.get("nbody").engine.params)
    module = live.preg.get("nbody").engine.model
    out = []
    for tag, tree in (("new", jparams),
                      ("nan", jax.tree.map(lambda x: np.full_like(x, np.nan),
                                           jparams))):
        jpath = str(tmp_path / f"jax_{tag}.ckpt")
        jax_save(jpath, SimpleNamespace(params=tree, opt_state={}, step=0),
                 epoch=0)
        ppath = str(tmp_path / f"port_{tag}" / f"{tag}.ckpt")
        model = _with(module, params_from_jax(tree))
        port_save(ppath, TrainState(model, make_optimizer(
            model.parameters(), 1e-3)), epoch=0)
        out.append((jpath, ppath))
    return out


def _with(module, sd):
    import copy

    m = copy.deepcopy(module)
    m.load_state_dict(sd)
    return m


def test_swap_and_canary_rollback_match_jax(live, tmp_path):
    (jnew, pnew), (jnan, pnan) = _ckpts(live, tmp_path)
    a = live.j.call("POST", "/v1/models/nbody/swap", {"checkpoint": jnew})
    b = live.p.call("POST", "/v1/models/nbody/swap", {"checkpoint": pnew})
    _same_shape(a, b)
    assert b[0] == 200 and b[1]["version"] == a[1]["version"] == 1
    assert b[1]["rungs_canaried"] == a[1]["rungs_canaried"] >= 1
    body = _payload(scene(40, 21))
    a, b = _both(live, "POST", "/v1/models/nbody/predict", body)
    np.testing.assert_allclose(_decode(b[1]["prediction"]),
                               _decode(a[1]["prediction"]), rtol=0,
                               atol=ATOL)
    a = live.j.call("POST", "/v1/models/nbody/swap", {"checkpoint": jnan})
    b = live.p.call("POST", "/v1/models/nbody/swap", {"checkpoint": pnan})
    _same_shape(a, b)
    assert b[0] == 422 and b[1]["stage"] == a[1]["stage"] == "canary"
    assert b[1]["rolled_back"] and a[1]["rolled_back"]
    a2, b2 = _both(live, "POST", "/v1/models/nbody/predict", body)
    np.testing.assert_allclose(_decode(b2[1]["prediction"]),
                               _decode(a2[1]["prediction"]), rtol=0,
                               atol=ATOL)
    a, b = _both(live, "POST", "/v1/models/nbody/swap",
                 {"checkpoint": str(tmp_path / "missing.ckpt")})
    _same_shape(a, b)
    assert b[1]["stage"] == "restore"
    a, b = _both(live, "POST", "/v1/models/nope/swap", {"checkpoint": "x"})
    _same_shape(a, b)


class _Headers(dict):
    def get(self, key, default=None):
        return super().get(key.lower(), default)


PRIORITY = [("predict", {}), ("rollout", {}),
            ("predict", {"x-priority": "bulk"}),
            ("rollout", {"x-priority": " Interactive "}),
            ("rollout", {"x-priority": "urgent"}),
            ("predict", {"content-length": str(5 << 20)})]


@pytest.mark.parametrize("i", range(len(PRIORITY)))
def test_priority_classes_match_jax(live, i):
    """Admission classes: predicts interactive, rollouts bulk, the header
    overrides, a giant body rides bulk."""
    route, headers = PRIORITY[i]
    h = SimpleNamespace(headers=_Headers(headers))
    assert live.pgw._priority_of(h, route) == live.jgw._priority_of(h, route)
    assert live.pgw.bulk_max_inflight == live.jgw.bulk_max_inflight == 12


def _names(text):
    return {line.split("{")[0].split()[0] for line in text.splitlines()
            if line and not line.startswith("#")}


def test_metrics_names_match_jax(live):
    a, b = _both(live, "GET", "/metrics")
    assert a[0] == b[0] == 200
    assert _names(b[1]) == _names(a[1])
    assert "distegnn_model_nbody_serve_batch_slots_filled" in _names(b[1])


def test_drain_answers_every_accepted_request(live):
    """Last in the file: SIGTERM's drain path. An accepted request in
    flight gets its 200, a new one 503 Draining, /readyz 503."""
    seen = {}
    for side, gw, reg in (("j", live.jgw, live.jreg),
                          ("p", live.pgw, live.preg)):
        client = getattr(live, side)
        reg.get("nbody").replicas.replicas[0].queue.wedge(0.3)
        res = {}
        t = threading.Thread(target=lambda: res.setdefault(
            "inflight", client.call("POST", "/v1/models/nbody/predict",
                                    _payload(scene(40, 31)))))
        t.start()
        time.sleep(0.1)
        d = threading.Thread(target=gw.drain)
        d.start()
        while gw.ready():
            time.sleep(0.005)
        late = client.call("POST", "/v1/models/nbody/predict",
                           _payload(scene(40, 32)))
        ready = client.call("GET", "/readyz")
        t.join(60)
        d.join(60)
        seen[side] = (res["inflight"], late, ready)
    for k in range(3):
        _same_shape(seen["j"][k], seen["p"][k])
    assert [seen["p"][k][0] for k in range(3)] == [200, 503, 503]
    assert seen["p"][1][1]["type"] == "Draining"
