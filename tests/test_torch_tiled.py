"""Tiled serving in the port (``ops/tiling.py``, ``serve/tiled.py``, the tile
mode of ``models/fast_egnn.py``, ``SessionPrepCache.prepare_tile`` and the
gateway's dispatch above the ladder cap) on the CPU, held against the JAX
package.

The sizes are JAX's own tests' (``tests/test_tiled.py``: H=16, L=2, C=2,
400-900 nodes, ``tile_nodes`` 128-256), plus one fused case whose tiles are
wide enough (1536 own nodes, 4 blocks) that halo edges fall outside the
fused kernel's 3-block window and ride the remote tail. Parameters are drawn
by numpy in the JAX tree and carried into the port by ``convert.py``.

Bounds: tile plans and round schedules EQUAL to JAX's; one layer's tile
partials and the virtual closure within 1e-6 of JAX's, scale-normalized;
the tiled prediction within 1e-5 scale-normalized of JAX's monolithic
forward, with at least 2 tiles. On the CPU the fused path runs the kernel's
plain version (the wrapper picks it for CPU tensors), JAX's its interpret
mode.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import base64
import functools
import http.client
import json
import threading

import jax
import numpy as np
import pytest
import torch

from distegnn_tpu.models.fast_egnn import FastEGNN as JaxFastEGNN
from distegnn_tpu.models.fast_egnn import \
    tiled_virtual_update as jax_tiled_virtual_update
from distegnn_tpu.ops.graph import pad_graphs as jax_pad_graphs
from distegnn_tpu.ops.tiling import plan_rounds as jax_plan_rounds
from distegnn_tpu.ops.tiling import plan_tiles as jax_plan_tiles
from distegnn_tpu.ops.tiling import tile_work as jax_tile_work
from distegnn_tpu.serve import InferenceEngine as JaxEngine
from distegnn_tpu.serve import TiledExecutor as JaxTiled
from distegnn_tpu.serve.buckets import synthetic_graph
from distegnn_tpu_torch.convert import params_from_jax
from distegnn_tpu_torch.models.fast_egnn import FastEGNN, tiled_virtual_update
from distegnn_tpu_torch.obs.metrics import MetricsRegistry
from distegnn_tpu_torch.ops import edge_pipeline
from distegnn_tpu_torch.ops.edge_pipeline import count_remote_edges
from distegnn_tpu_torch.ops.tiling import plan_rounds, plan_tiles, tile_work
from distegnn_tpu_torch.serve import (BucketLadder, BucketOverflowError,
                                      InferenceEngine, ServeMetrics,
                                      SessionPrepCache, TiledOverflowError)
from distegnn_tpu_torch.serve.registry import ModelRegistry
from distegnn_tpu_torch.serve.transport import Gateway
from test_torch_fast_egnn import numpy_params
from torch_serve_pair import carry_params, configs, jax_engine

H, L, C = 16, 2, 2
BLOCK = 512

# name -> (edge impl, nodes, radius, monolithic max_nodes, serve.tiled)
CASES = {
    "plain": ("plain", 400, 0.2, None,
              {"tile_nodes": 128, "halo_floor": 16, "edge_floor": 256}),
    "fused": ("fused", 900, 0.2, 1536,
              {"tile_nodes": 256, "halo_floor": 64, "edge_floor": 512}),
    "fused_remote": ("fused", 3200, 0.09, 3584,
                     {"tile_nodes": 1536, "halo_floor": 256,
                      "edge_floor": 512}),
}


def norm_err(pred, ref):
    return float(np.abs(np.asarray(pred) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


def plan_kwargs(name):
    impl, _, _, _, tiled = CASES[name]
    return dict(tiled, edge_block=BLOCK if impl == "fused" else 0)


@functools.lru_cache(maxsize=None)
def case(name):
    """(scene, JAX model, JAX params, JAX monolithic prediction [n, 3],
    port model holding the same parameters) of one case."""
    impl, n, radius, max_nodes, _ = CASES[name]
    g = synthetic_graph(n, radius=radius, seed=5)
    jm = JaxFastEGNN(node_feat_nf=1, edge_attr_nf=2, hidden_nf=H,
                     virtual_channels=C, n_layers=L, edge_impl=impl)
    if impl == "fused":
        batch = jax_pad_graphs([dict(g)], max_nodes=max_nodes,
                               edge_block=BLOCK, edge_tile=BLOCK,
                               split_remote=True, compute_pair=False)
    else:
        batch = jax_pad_graphs([g], node_bucket=1, edge_bucket=1)
    params = numpy_params(jm, batch, seed=0)
    ref = np.asarray(jax.jit(jm.apply)(params, batch)[0])[0, :n]
    pm = FastEGNN(node_feat_nf=1, edge_attr_nf=2, hidden_nf=H,
                  virtual_channels=C, n_layers=L, edge_impl=impl)
    pm.load_state_dict(params_from_jax(params["params"]))
    return g, jm, params, ref, pm


def port_engine(name, model=None, **kw):
    impl = CASES[name][0]
    layout = ({"edge_block": BLOCK, "split_remote": True}
              if impl == "fused" else None)
    return InferenceEngine(model or case(name)[4], "cpu", layout_opts=layout,
                           tiled=CASES[name][4], **kw)


# ------------------------------------------------------------ tile planning

def assert_plans_equal(p, j):
    for f in ("n_nodes", "n_edges", "tile_nodes", "halo_pad", "edge_pad",
              "edge_block", "edge_tile", "edges_per_block", "remote_pad",
              "halo_total", "work_imbalance", "padded_nodes",
              "halo_fraction", "shape_key", "n_tiles"):
        assert getattr(p, f) == getattr(j, f), f
    np.testing.assert_array_equal(p.perm, j.perm)
    np.testing.assert_array_equal(p.inv_perm, j.inv_perm)
    for a, b in zip(p.tiles, j.tiles):
        assert (a.start, a.stop) == (b.start, b.stop)
        np.testing.assert_array_equal(a.halo, b.halo)
        np.testing.assert_array_equal(a.edge_index, b.edge_index)
        np.testing.assert_array_equal(a.edge_attr, b.edge_attr)


def lattice(side):
    """JAX ``tests/test_tiled.py`` ``_lattice_scene``: side^3 nodes, +/-x
    neighbour edges, a seeded jitter."""
    n = side ** 3
    idx = np.arange(n, dtype=np.int64)
    x, y, z = idx // (side * side), (idx // side) % side, idx % side
    loc = np.stack([x, y, z], axis=1).astype(np.float32)
    loc += np.random.default_rng(0).uniform(-0.1, 0.1, loc.shape
                                            ).astype(np.float32)
    src = idx[x < side - 1]
    dst = src + side * side
    ei = np.concatenate([np.stack([src, dst]), np.stack([dst, src])],
                        axis=1).astype(np.int32)
    d = np.linalg.norm(loc[ei[0]] - loc[ei[1]], axis=1)[:, None]
    vel = np.zeros_like(loc)
    vel[:, 0] = 0.01
    return {"node_feat": np.ones((n, 1), np.float32), "loc": loc,
            "vel": vel, "edge_index": ei,
            "edge_attr": np.repeat(d, 2, axis=1).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(CASES) + ["lattice"])
def test_tile_plans_equal_jax(name):
    if name == "lattice":
        g, kw = lattice(14), {"tile_nodes": 512, "edge_block": BLOCK}
    else:
        impl, n, radius, _, _ = CASES[name]
        g, kw = synthetic_graph(n, radius=radius, seed=5), plan_kwargs(name)
    args = (g["edge_index"], g["loc"], g["edge_attr"])
    p, j = plan_tiles(*args, **kw), jax_plan_tiles(*args, **kw)
    assert p.n_tiles >= 2
    assert_plans_equal(p, j)
    np.testing.assert_array_equal(tile_work(p), jax_tile_work(j))


def test_round_schedules_equal_jax():
    g = synthetic_graph(600, radius=0.2, seed=3)
    args = (g["edge_index"], g["loc"], g["edge_attr"])
    kw = {"tile_nodes": 128, "halo_floor": 16, "edge_floor": 256}
    p, j = plan_tiles(*args, **kw), jax_plan_tiles(*args, **kw)
    work = np.ones(p.n_tiles)
    work[:2] = (100.0, 90.0)               # skewed: LPT splits the heavies
    for D, w in ((1, None), (2, None), (3, None), (8, None), (2, work)):
        a, b = plan_rounds(p, D, work=w), jax_plan_rounds(j, D, work=w)
        assert a == b, D


# ---------------------------------------------- one layer over one tile

@pytest.mark.parametrize("name", ["plain", "fused_remote"])
def test_tile_partials_and_virtual_update_match_jax(name):
    """``EGCLVel(tile_partials=True)`` over one tile batch (the second
    tile: it has halo on both sides) and ``tiled_virtual_update``: within
    1e-6 of JAX's, scale-normalized."""
    g, jm, params, _, pm = case(name)
    jeng = JaxEngine(jm, params, layout_opts=port_engine(name)._layout_opts)
    jtx = JaxTiled(jeng, CASES[name][4])
    ptx = port_engine(name).tiled
    plan = ptx.plan(g)
    s = plan.tiles[1]
    assert s.n_halo > 0
    if name == "fused_remote":
        # halo senders beyond the receiver's 3-block window: the remote tail
        assert count_remote_edges(s.edge_index, block=BLOCK,
                                  n_nodes=plan.padded_nodes) > 0
    rng = np.random.default_rng(1)
    n = g["loc"].shape[0]
    loc = g["loc"][plan.perm]
    vel, feat = g["vel"][plan.perm], g["node_feat"][plan.perm]
    lm = g["loc"].mean(axis=0)[None]
    jb = jtx._tile_batch(plan, s, loc, vel, feat, None, lm)
    pb = ptx._tile_batch(plan, s, loc, vel, feat, None, lm)
    np.testing.assert_array_equal(np.asarray(jb.node_mask),
                                  pb.node_mask.numpy())
    nd = pb.max_nodes
    h = np.zeros((1, nd, H), np.float32)
    h[0, :s.n_own] = rng.normal(size=(s.n_own, H))
    h[0, plan.tile_nodes:plan.tile_nodes + s.n_halo] = rng.normal(
        size=(s.n_halo, H))
    x = np.asarray(pb.loc)
    X = rng.normal(size=(1, 3, C)).astype(np.float32)
    Hv = rng.normal(size=(1, H, C)).astype(np.float32)
    cm = rng.normal(size=(1, 3)).astype(np.float32)
    gcl = params["params"]["gcl_1"]
    jout = jtx._layer_callable(plan)(gcl, h, x, jb, X, Hv, cm)
    with torch.no_grad():
        pout = ptx.run_layer(pm, 1, torch.from_numpy(h), torch.from_numpy(x),
                             pb, torch.from_numpy(X), torch.from_numpy(Hv),
                             torch.from_numpy(cm))
        jv = jax_tiled_virtual_update(gcl, Hv, X, *jout[2:])
        pv = tiled_virtual_update(pm.gcl[1], torch.from_numpy(Hv),
                                  torch.from_numpy(X), *pout[2:])
    for k, (a, b) in enumerate(zip(pout, jout)):
        assert norm_err(a.numpy(), b) <= 1e-6, k
    assert float(pout[4]) == s.n_own
    for a, b in zip(pv, jv):
        assert norm_err(a.numpy(), b) <= 1e-6


# --------------------------------------------------- the tiled predict

@pytest.mark.parametrize("name", sorted(CASES))
def test_tiled_predict_matches_jax_monolithic(name):
    g, _, _, ref, _ = case(name)
    eng = port_engine(name)
    before = edge_pipeline.fused_edge_layer.launches
    out = eng.predict_tiled(dict(g))
    assert out["tiles"] >= 2 and out["devices"] == 1
    assert out["rounds"] == out["tiles"] and not out["cancelled"]
    assert norm_err(out["prediction"], ref) <= 1e-5
    assert 0.0 < out["halo_fraction"] < 1.0
    assert 0.0 <= out["stall_fraction"] <= 1.0
    # CPU tensors: the kernel's plain version, no launch
    assert edge_pipeline.fused_edge_layer.launches == before
    # one tile-layer key for every layer of every tile, and again on a
    # second scene of the same rung
    eng.predict_tiled(dict(g))
    keys = [k for k in eng.shapes_seen if k[0] == "tile_layer"]
    assert keys == [("tile_layer",) + eng.tiled.plan(g).shape_key
                    + (CASES[name][0], H, C)]
    gv = eng.metrics.registry.gauge
    assert gv("serve/tiled_tiles").value == out["tiles"]
    assert gv("serve/tiled_devices").value == 1


def test_fused_stack_serves_through_the_per_layer_fused_path():
    _, _, _, _, pm = case("fused")
    stack = FastEGNN(node_feat_nf=1, edge_attr_nf=2, hidden_nf=H,
                     virtual_channels=C, n_layers=L, edge_impl="fused_stack")
    stack.load_state_dict(pm.state_dict())
    g = case("fused")[0]
    a = port_engine("fused").predict_tiled(dict(g))
    eng = port_engine("fused", model=stack)
    assert eng.tiled.edge_impl == "fused"
    b = eng.predict_tiled(dict(g))
    np.testing.assert_array_equal(a["prediction"], b["prediction"])


def test_tiled_overflow_is_typed_413_material():
    eng = InferenceEngine(case("plain")[4], "cpu",
                          tiled={"max_nodes": 40, "tile_nodes": 16})
    with pytest.raises(TiledOverflowError, match="serve.tiled.max_nodes"):
        eng.predict_tiled(dict(synthetic_graph(50, seed=0)))
    assert issubclass(TiledOverflowError, BucketOverflowError)
    with pytest.raises(BucketOverflowError, match="serve.tiled"):
        BucketLadder(max_nodes=64).bucket_for(65, 256)


# --------------------------------------------- session-cached tile plans

def test_prepare_tile_invalidates_on_a_new_fingerprint():
    cache = SessionPrepCache(capacity=8, ladder=BucketLadder())
    g = synthetic_graph(20, seed=3)
    calls = []

    def build():
        calls.append(1)
        return {"plan": np.ones(4)}

    assert [cache.prepare_tile("s", g, build)[1] for _ in range(2)] == \
        [False, True] and len(calls) == 1
    g2 = dict(g, edge_index=g["edge_index"][:, :-2])   # new topology
    assert cache.prepare_tile("s", g2, build)[1] is False
    assert len(calls) == 2


def test_prepare_tile_evicts_to_fit_its_byte_budget():
    metrics = ServeMetrics()
    cache = SessionPrepCache(capacity=64, ladder=BucketLadder(),
                             metrics=metrics, max_bytes=4096)
    g = synthetic_graph(10, seed=0)

    def build():
        return np.zeros(1500, np.uint8)     # three do not fit in 4096

    for sid in ("a", "b", "c"):
        cache.prepare_tile(sid, g, build)
    assert len(cache) == 2 and cache.bytes_used <= 4096
    assert cache.prepare_tile("b", g, build)[1] is True
    assert cache.prepare_tile("a", g, build)[1] is False   # was evicted
    reg = metrics.registry
    assert reg.gauge("serve/session_cache_bytes").value == cache.bytes_used
    ev = reg.counter("serve/session_evictions").value
    assert ev >= 2
    # a same-session replacement is not an eviction
    cache.prepare_tile("a", synthetic_graph(12, seed=1), build)
    assert reg.counter("serve/session_evictions").value == ev


# --------------------------------------------------------- the gateway

TILED_CFG = {"enable": True, "tile_nodes": 96, "halo_floor": 16,
             "edge_floor": 256}


def _post(gw, path, payload):
    host, port = gw.address
    c = http.client.HTTPConnection(host, port, timeout=120)
    c.request("POST", path, body=json.dumps(payload).encode(),
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    text = r.read().decode()
    c.close()
    return r.status, text


def _payload(g, **extra):
    p = {"positions": g["loc"].tolist(), "velocities": g["vel"].tolist(),
         "node_feat": g["node_feat"].tolist(),
         "edge_index": g["edge_index"].tolist(),
         "edge_attr": g["edge_attr"].tolist()}
    p.update(extra)
    return p


@pytest.fixture(scope="module")
def gateway():
    """configs/nbody_serve.yaml at the narrow width with a 64-node ladder
    cap and ``serve.tiled`` on: a 300-node scene lies above the cap. The
    JAX parameters are carried in; the reference is JAX's monolithic
    forward of the same scene."""
    jcfg, pcfg = configs({"serve.max_nodes": 64, "serve.tiled": TILED_CFG,
                          "serve.request_timeout_ms": 120_000.0})
    reg = ModelRegistry.from_config(pcfg, device="cpu")
    jeng, _ = jax_engine(jcfg)
    engines = [r.engine for r in reg.get("default").replicas.replicas]
    carry_params(jeng, engines)
    g = synthetic_graph(300, radius=0.2, seed=7)
    batch = jax_pad_graphs([g], node_bucket=1, edge_bucket=1)
    ref = np.asarray(jeng.model.apply(jeng.params, batch)[0])[0]
    reg.start()
    gw = Gateway(reg, port=0, metrics_registry=MetricsRegistry())
    threading.Thread(target=gw.serve_forever, daemon=True).start()
    yield gw, g, ref, engines[0]
    gw.drain()
    gw.close()


def test_gateway_serves_a_scene_above_the_cap_through_tiles(gateway):
    gw, g, ref, eng = gateway
    assert eng.tiled_enabled and g["loc"].shape[0] > eng.ladder.max_nodes
    status, body = _post(gw, "/v1/models/default/predict",
                         _payload(g, session_id="sc"))
    assert status == 200, body[:400]
    resp = json.loads(body)
    assert norm_err(np.asarray(resp["prediction"], np.float32), ref) <= 1e-5
    assert resp["tiled"]["tiles"] >= 2
    assert 0.0 < resp["tiled"]["halo_fraction"] < 1.0
    assert resp["session"]["hit"] is False
    # the session cache serves the tile plan back; b64 answers the same
    status, body = _post(gw, "/v1/models/default/predict",
                         _payload(g, session_id="sc", encoding="b64"))
    resp2 = json.loads(body)
    assert resp2["session"]["hit"] is True
    pred = np.frombuffer(base64.b64decode(resp2["prediction"]["b64"]),
                         "<f4").reshape(resp2["prediction"]["shape"])
    np.testing.assert_array_equal(
        pred, np.asarray(resp["prediction"], np.float32))
    assert len([k for k in eng.shapes_seen if k[0] == "tile_layer"]) == 1


def test_gateway_streams_one_line_per_tile_and_layer(gateway):
    gw, g, ref, _ = gateway
    status, body = _post(gw, "/v1/models/default/predict?stream=1",
                         _payload(g))
    assert status == 200, body[:400]
    lines = [json.loads(ln) for ln in body.strip().split("\n")]
    done = lines[-1]
    assert done["done"] is True and done["cancelled"] is False
    assert norm_err(np.asarray(done["prediction"], np.float32), ref) <= 1e-5
    progress = [ln for ln in lines[:-1] if "tile" in ln]
    assert len(progress) == done["tiled"]["tiles"] * done["tiled"]["layers"]
    assert [(p["layer"], p["tile"]) for p in progress] == [
        (li, ti) for li in range(L) for ti in range(done["tiled"]["tiles"])]


def test_gateway_answers_413_above_the_tiled_bound_and_when_off(gateway):
    gw, g, _, eng = gateway
    eng.tiled.max_nodes = 200              # below the 300-node scene
    try:
        status, body = _post(gw, "/v1/models/default/predict", _payload(g))
    finally:
        eng.tiled.max_nodes = 4_194_304
    resp = json.loads(body)
    assert status == 413 and resp["type"] == "BucketOverflow"
    assert "serve.tiled.max_nodes" in resp["error"]
    eng.tiled.enable = False               # the ladder's own 413
    try:
        status, body = _post(gw, "/v1/models/default/predict", _payload(g))
    finally:
        eng.tiled.enable = True
    resp = json.loads(body)
    assert status == 413 and "serve.max_nodes" in resp["error"]
    assert "serve.tiled" in resp["error"]


# ------------------------------------------------- the million-node scene

@pytest.mark.slow
def test_million_node_scene_serves_through_one_tile_layer_key():
    """JAX's slow lane in the port: 10^6 nodes (~1.98 M edges) through the
    gateway with one tile-layer key and no 413."""
    g = lattice(100)
    assert g["loc"].shape[0] == 1_000_000
    model = FastEGNN(node_feat_nf=1, edge_attr_nf=2, hidden_nf=H,
                     virtual_channels=C, n_layers=L,
                     generator=torch.Generator().manual_seed(0))
    eng = InferenceEngine(model, "cpu", session_cache=4,
                          session_cache_bytes=1 << 30,
                          tiled={"tile_nodes": 262_144,
                                 "timeout_factor": 16.0})
    reg = ModelRegistry.single("nbody", eng, _queue(eng))
    reg.start()
    gw = Gateway(reg, port=0, metrics_registry=MetricsRegistry())
    threading.Thread(target=gw.serve_forever, daemon=True).start()
    try:
        def f32(a, dt="<f4"):
            a = np.ascontiguousarray(a, dtype=dt)
            return {"b64": base64.b64encode(a.tobytes()).decode(),
                    "shape": list(a.shape)}

        payload = {"positions": f32(g["loc"]), "velocities": f32(g["vel"]),
                   "node_feat": f32(g["node_feat"]),
                   "edge_attr": f32(g["edge_attr"]),
                   "edge_index": f32(g["edge_index"], "<i4"),
                   "encoding": "b64", "session_id": "giant"}
        status, body = _post(gw, "/v1/models/nbody/predict", payload)
        assert status == 200, body[:400]
        resp = json.loads(body)
        assert resp["prediction"]["shape"] == [1_000_000, 3]
        pred = np.frombuffer(base64.b64decode(resp["prediction"]["b64"]),
                             "<f4")
        assert np.isfinite(pred).all() and resp["tiled"]["tiles"] >= 2
        assert len([k for k in eng.shapes_seen
                    if k[0] == "tile_layer"]) == 1
    finally:
        gw.drain()
        gw.close()


def _queue(eng):
    from distegnn_tpu_torch.serve import RequestQueue

    return RequestQueue(eng, request_timeout_ms=600_000.0,
                        metrics=eng.metrics)
