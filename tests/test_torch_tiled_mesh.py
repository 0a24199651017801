"""Tile rounds over several devices in the port (``serve/mesh_tiled.py``)
and the tiled path's cancel contract, on the CPU.

The chip machine has one card, so D > 1 is held here only: the executor is
given the CPU device D times (``device_list``), and the rounds run the same
per-tile layer on each slot, with a ragged last round's pad slots masked
out. Bounds: D = 2 and 3 (ragged) within 1e-5 scale-normalized of the
sequential path on the same plan, plain and fused; one tile-layer key per
(rung, D); a cancel stops at the first tile boundary (sequential) or round
boundary (rounds); ``resolve_devices`` clamps with an event and never
raises. The sizes and models are ``tests/test_torch_tiled.py``'s."""

import torch_threads  # noqa: F401  (first: one torch thread)
import pytest
import torch

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.serve import RequestQueue, StreamSink
from distegnn_tpu_torch.serve.mesh_tiled import (local_devices,
                                                 resolve_devices)
from test_torch_tiled import case, norm_err, port_engine

CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=["plain", "fused"])
def sequential(request):
    """(case name, scene, the sequential tiled result) of one case."""
    g = case(request.param)[0]
    seq = port_engine(request.param).predict_tiled(dict(g))
    assert seq["tiles"] == 4 and seq["devices"] == 1
    return request.param, g, seq


@pytest.mark.parametrize("D", [2, 3])
def test_rounds_equal_the_sequential_path(sequential, D):
    name, g, seq = sequential
    eng = port_engine(name)
    eng.tiled.device_list = [CPU] * D
    eng.tiled.devices = D
    out = eng.predict_tiled(dict(g))
    T = seq["tiles"]
    assert out["devices"] == D and out["rounds"] == -(-T // D)
    if D == 3:
        assert T % D != 0                  # a ragged last round
    assert norm_err(out["prediction"], seq["prediction"]) <= 1e-5
    assert out["round_ms"] > 0 and out["halo_gather_ms"] >= 0
    gv = eng.metrics.registry.gauge
    assert gv("serve/tiled_devices").value == D
    assert gv("serve/tiled_round_ms").value > 0
    # one layer key, the sequential rung key extended with D
    keys = [k for k in eng.shapes_seen if k[0] == "tile_layer"]
    assert len(keys) == 1 and keys[0][-1] == D


def test_a_plan_built_for_one_device_serves_rounds_unchanged():
    g, eng = case("plain")[0], port_engine("plain")
    plan = eng.tiled.plan(g)
    eng.tiled.device_list, eng.tiled.devices = [CPU] * 2, 2
    out = eng.tiled.predict(dict(g), plan=plan)
    seq = port_engine("plain").tiled.predict(dict(g), plan=plan)
    assert out["rounds"] == 2
    assert norm_err(out["prediction"], seq["prediction"]) <= 1e-5


def test_resolve_devices_auto_clamp_and_degenerate():
    events = []
    orig = obs.event
    obs.event = lambda name, **kw: events.append((name, kw))
    try:
        assert resolve_devices("auto", available=1) == 1
        assert resolve_devices("auto", available=4) == 4
        assert resolve_devices(3, available=4) == 3
        assert resolve_devices(99, available=2) == 2      # clamped
        assert resolve_devices("auto", n_tiles=1, available=4) == 1
        assert resolve_devices(4, n_tiles=0, available=4) == 1
    finally:
        obs.event = orig
    assert events == [("serve/tiled_devices_clamped",
                       {"requested": 99, "available": 2})]
    # the CPU engine's own list is the CPU; 'auto' there is sequential
    assert local_devices(CPU) == [CPU]
    eng = port_engine("plain")
    eng.tiled.devices = "auto"
    assert eng.predict_tiled(dict(case("plain")[0]))["devices"] == 1


@pytest.mark.parametrize("D", [1, 2])
def test_a_cancel_stops_at_the_next_tile_or_round_boundary(D):
    g, eng = case("plain")[0], port_engine("plain")
    eng.tiled.device_list, eng.tiled.devices = [CPU] * D, D
    seen = []

    def progress(**info):
        seen.append(info)
        return False                       # the client went away

    out = eng.predict_tiled(dict(g), progress=progress)
    assert out["cancelled"] is True and out["prediction"] is None
    assert len(seen) == 1
    assert seen[0] == ({"layer": 0, "tile": 0, "n_layers": 2, "n_tiles": 4}
                       if D == 1 else
                       {"layer": 0, "round": 0, "n_layers": 2,
                        "n_rounds": 2, "n_tiles": 4})


def test_a_queued_stream_cancel_ends_the_tiled_request():
    """``RequestQueue.submit_tiled`` with a stream whose consumer cancels
    while the request waits: the executor stops at the first tile boundary,
    the sink finishes with ``cancelled`` and ``serve/tiled_cancelled`` is
    recorded."""
    g, eng = case("plain")[0], port_engine("plain")
    events = []
    orig = obs.event
    obs.event = lambda name, **kw: events.append(name)
    q = RequestQueue(eng, request_timeout_ms=60_000.0, metrics=eng.metrics)
    q.wedge(0.2)
    q.start()
    try:
        sink = StreamSink()
        fut = q.submit_tiled(dict(g), stream=sink)
        sink.cancel()                      # before the first tile ends
        out = fut.result()
        assert out["cancelled"] is True and out["prediction"] is None
        kinds = []
        while True:
            kind, a, _ = sink.next(timeout=5.0)
            kinds.append(kind)
            if kind != "chunk":
                break
        assert kinds[-1] == "done" and a["cancelled"] is True
    finally:
        q.stop()
        obs.event = orig
    assert "serve/tiled_cancelled" in events
