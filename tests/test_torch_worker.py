"""The port's process-isolated serving workers (``distegnn_tpu_torch/serve/
worker.py`` + ``WorkerReplica``) on the CPU: the IPC framing held byte for
byte against the JAX package's, its typed errors, the child's import
isolation (module-level stdlib only, and what a live child has loaded), one
real child on the CPU serving bitwise what the in-process engine serves,
spawn-failure degradation, and — under ``slow`` — the kill9 / sigstop drill
and a swap racing a spawn.

The ``process`` marker flags tests that spawn a real child; one stays
tier-1 as the smoke test, the drills are additionally ``slow`` (as
``tests/test_worker.py`` marks JAX's).

Bounds: frames byte-identical; predictions bitwise equal; the params digest
equal; no child alive after teardown.
"""

import ast
import os
import pickle
import signal
import socket
import struct
import sys
import threading
import time
import zlib

import numpy as np
import pytest

from distegnn_tpu.serve import worker as jwmod
from distegnn_tpu_torch.serve import synthetic_graph
from distegnn_tpu_torch.serve import worker as wmod
from distegnn_tpu_torch.serve.registry import ModelRegistry
from torch_serve_pair import configs

pytestmark = pytest.mark.serve

WORKER_PY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "distegnn_tpu_torch", "serve", "worker.py")


@pytest.fixture(autouse=True)
def _reap_port_children():
    """No child of the port's outlives its test (the shared conftest reaps
    the JAX package's)."""
    yield
    wmod.reap_live_workers(join_timeout_s=10.0)


# ---- framing ------------------------------------------------------------------

def _raw_frame(mod, kind, seq, obj):
    a, b = socket.socketpair()
    try:
        mod.send_frame(a, threading.Lock(), kind, seq, obj)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            c = b.recv(65536)
            if not c:
                return b"".join(chunks)
            chunks.append(c)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("kind, seq, obj", [
    (1, 7, {"op": "predict", "graphs": [
        {"loc": np.arange(12, dtype=np.float32).reshape(4, 3),
         "edge_index": np.array([[0, 1], [1, 0]], np.int32)}],
        "bucket": [64, 256], "request_ids": ["r1"]}),
    (2, 7, {"ok": True, "result": [np.linspace(0, 1, 9,
                                               dtype=np.float32)]}),
    (3, 0, {"ts": 1.5})], ids=["request", "response", "heartbeat"])
def test_frame_bytes_equal_jax(kind, seq, obj):
    """The same numpy payload frames to the same bytes in both packages, and
    each side reads the other's frame."""
    mine, theirs = _raw_frame(wmod, kind, seq, obj), _raw_frame(jwmod, kind,
                                                               seq, obj)
    assert mine == theirs
    a, b = socket.socketpair()
    try:
        a.sendall(theirs)
        k, s, payload = wmod.recv_frame(b, deadline=time.monotonic() + 5.0)
        assert (k, s) == (kind, seq)
        assert pickle.dumps(payload, protocol=4) == \
            pickle.dumps(obj, protocol=4)
    finally:
        a.close()
        b.close()


def test_frame_roundtrip_all_kinds():
    a, b = socket.socketpair()
    lock = threading.Lock()
    try:
        for kind, seq, obj in ((wmod.FRAME_REQUEST, 1, {"op": "ping"}),
                               (wmod.FRAME_RESPONSE, 1, {"ok": True,
                                                         "result": [1, 2]}),
                               (wmod.FRAME_HEARTBEAT, 0, {"ts": 1.5})):
            wmod.send_frame(a, lock, kind, seq, obj)
            assert wmod.recv_frame(b, deadline=time.monotonic() + 5.0) == \
                (kind, seq, obj)
    finally:
        a.close()
        b.close()


def test_frame_checksum_and_magic_are_typed():
    a, b = socket.socketpair()
    try:
        payload = pickle.dumps({"op": "predict"}, protocol=4)
        header = wmod._HEADER.pack(wmod._MAGIC, wmod.FRAME_REQUEST, 7,
                                   len(payload),
                                   zlib.crc32(payload) & 0xFFFFFFFF)
        a.sendall(header + bytes([payload[0] ^ 0x40]) + payload[1:])
        with pytest.raises(wmod.FrameError, match="checksum"):
            wmod.recv_frame(b, deadline=time.monotonic() + 5.0)
        a.sendall(struct.pack("!2sBIII", b"XX", 1, 0, 0, 0))
        with pytest.raises(wmod.FrameError, match="magic"):
            wmod.recv_frame(b, deadline=time.monotonic() + 5.0)
    finally:
        a.close()
        b.close()


def test_frame_eof_and_deadline_are_typed():
    a, b = socket.socketpair()
    a.close()
    try:
        with pytest.raises(wmod.WorkerClosedError):
            wmod.recv_frame(b, deadline=time.monotonic() + 5.0)
    finally:
        b.close()
    a, b = socket.socketpair()
    try:
        t0 = time.monotonic()
        with pytest.raises(wmod.WorkerTimeoutError):
            wmod.recv_frame(b, deadline=time.monotonic() + 0.2)
        assert time.monotonic() - t0 < 5.0
    finally:
        a.close()
        b.close()


# ---- import isolation ----------------------------------------------------------

def test_worker_module_level_imports_are_stdlib_only():
    """Only stdlib at module level: the child is a thin engine host, and a
    broken torch surfaces as a typed init failure, not an exec death."""
    with open(WORKER_PY) as f:
        tree = ast.parse(f.read())
    tops = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            tops += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.append(node.module.split(".")[0])
    bad = [m for m in tops if m != "__future__"
           and m not in sys.stdlib_module_names]
    assert tops and bad == []


# ---- one real child --------------------------------------------------------------

def _cfg(replicas=1, request_timeout_ms=500.0, **supervisor):
    _, cfg = configs({"serve.workers": "process",
                      "serve.replicas": replicas,
                      "serve.request_timeout_ms": request_timeout_ms,
                      "serve.worker": {"spawn_timeout_s": 120.0,
                                       "heartbeat_s": 0.2,
                                       "kill_grace_s": 2.0}})
    if supervisor:
        cfg.serve.supervisor = type(cfg)(dict(cfg.serve.supervisor,
                                              **supervisor))
    return cfg


def _graph(cfg, n=24, seed=11):
    return synthetic_graph(n, seed=seed, feat_nf=int(cfg.model.node_feat_nf),
                           edge_attr_nf=int(cfg.model.edge_attr_nf))


def _gone(pid, limit_s=10.0):
    deadline = time.monotonic() + limit_s
    while os.path.exists(f"/proc/{pid}") and time.monotonic() < deadline:
        time.sleep(0.05)
    return not os.path.exists(f"/proc/{pid}")


@pytest.mark.process
def test_worker_spawn_parity_isolation_and_clean_teardown():
    """One process-backed replica on the CPU, passed explicitly: the child's
    digest equals the parent's, its prediction equals the in-process
    engine's bitwise, it never loaded jax, the JAX package, the transport,
    the registry or the supervisor, health carries its pid and heartbeat,
    and teardown leaves no child and no handle."""
    cfg = _cfg()
    reg = ModelRegistry.from_config(cfg, device="cpu").start()
    pid = None
    try:
        e = reg.get("default")
        r = e.replicas.replicas[0]
        assert r.backend == "process" and not r.degraded
        w = r.queue.worker
        pid = r.queue.pid
        assert pid not in (None, os.getpid()) and os.path.exists(
            f"/proc/{pid}")
        assert w.ready["params_digest"] == e.engine.params_digest()
        assert w.ready["device"] == "cpu" and w.spawn_s > 0
        g = _graph(cfg)
        out = np.asarray(e.replicas.submit(dict(g)).result(timeout=120.0))
        ref = np.asarray(e.engine.predict(dict(g)))
        np.testing.assert_array_equal(out, ref)
        mods = w.call("stats")["modules"]
        assert "distegnn_tpu_torch.serve.engine" in mods
        forbidden = [m for m in mods if m.split(".")[0] in ("jax", "flax",
                                                            "distegnn_tpu")
                     or m in ("distegnn_tpu_torch.serve.transport",
                              "distegnn_tpu_torch.serve.registry",
                              "distegnn_tpu_torch.serve.supervisor",
                              "distegnn_tpu_torch.serve.replica")]
        assert forbidden == []
        row = e.replicas.health()[0]
        assert row["backend"] == "process" and row["pid"] == pid
        assert row["heartbeat_age_s"] is not None and not row["degraded"]
        assert reg.health()["default"]["workers"][0]["pid"] == pid
    finally:
        reg.stop()
    assert not wmod._LIVE, "a WorkerHandle leaked past registry.stop()"
    assert _gone(pid), "the worker child outlived stop()"


def test_spawn_failure_degrades_to_in_process():
    """A spawn failure at start degrades, it does not shed: the replica
    serves from an in-process queue on the parent's module (bitwise the
    same predictions), and health says degraded."""
    cfg = _cfg()
    reg = ModelRegistry.from_config(cfg, device="cpu")
    e = reg.get("default")
    r = e.replicas.replicas[0]
    r.fail_next_spawns(1)
    reg.start()
    try:
        assert r.degraded and r.queue.backend == "thread"
        g = _graph(cfg)
        out = np.asarray(e.replicas.submit(dict(g)).result(timeout=120.0))
        np.testing.assert_array_equal(out, e.engine.predict(dict(g)))
        row = e.replicas.health()[0]
        assert row["degraded"] is True and row["pid"] is None
    finally:
        reg.stop()
    assert not wmod._LIVE


def test_child_without_its_card_fails_the_spawn(monkeypatch):
    """A child sent to a card it does not have fails its init typed
    (WorkerSpawnError); the replica degrades instead of serving on the
    CPU in the child."""
    calls = []

    def fake_spawn(*a, **kw):
        calls.append(kw["device"])
        raise wmod.WorkerSpawnError("worker default/0 failed to initialize: "
                                    "CUDA is not available")

    monkeypatch.setattr(wmod.WorkerHandle, "spawn", fake_spawn)
    cfg = _cfg()
    reg = ModelRegistry.from_config(cfg, device="cpu").start()
    try:
        r = reg.get("default").replicas.replicas[0]
        assert calls == ["cpu"] and r.degraded
    finally:
        reg.stop()


@pytest.mark.process
def test_real_child_sent_to_a_missing_card_refuses_to_serve(monkeypatch):
    """A real child sent to ``cuda`` on a host without a card: its init
    fails in the child (``resolve_device``), the init reply carries the
    error, the spawn raises WorkerSpawnError naming CUDA, the child is gone,
    and the replica degrades to an in-process queue on the parent's
    device."""
    procs, errors = [], []
    real_popen, real_spawn = wmod.subprocess.Popen, wmod.WorkerHandle.spawn

    def popen(*a, **kw):
        procs.append(real_popen(*a, **kw))
        return procs[-1]

    def spawn_on_the_card(*a, **kw):
        kw["device"] = "cuda"
        try:
            return real_spawn(*a, **kw)
        except wmod.WorkerSpawnError as exc:
            errors.append(exc)
            raise

    monkeypatch.setattr(wmod.subprocess, "Popen", popen)
    monkeypatch.setattr(wmod.WorkerHandle, "spawn", spawn_on_the_card)
    cfg = _cfg()
    reg = ModelRegistry.from_config(cfg, device="cpu").start()
    try:
        e = reg.get("default")
        r = e.replicas.replicas[0]
        assert len(procs) == 1 and len(errors) == 1
        assert "CUDA is not available" in str(errors[0])
        assert _gone(procs[0].pid) and not wmod._LIVE
        assert r.degraded and e.replicas.health()[0]["pid"] is None
        assert r.queue.engine.device.type == e.engine.device.type == "cpu"
        g = _graph(cfg)
        out = np.asarray(e.replicas.submit(dict(g)).result(timeout=120.0))
        np.testing.assert_array_equal(out, e.engine.predict(dict(g)))
    finally:
        reg.stop()


def test_respawn_on_another_checkpoint_expects_that_checkpoints_digest(
        monkeypatch, tmp_path):
    """A canary killed before the promoter's rollback respawns on the
    CANDIDATE while the parent holds the live version: the spawn must
    expect the candidate's digest (JAX expects the parent's, so the child
    fails its handshake and the replica degrades). Spawns are recorded, no
    child runs."""
    import copy

    import torch

    from distegnn_tpu_torch.serve.engine import params_digest
    from distegnn_tpu_torch.train.checkpoint import save_checkpoint
    from distegnn_tpu_torch.train.step import TrainState, make_optimizer

    seen = []

    def fake_spawn(*a, checkpoint=None, expect_digest=None, **kw):
        seen.append((checkpoint, expect_digest))
        raise wmod.WorkerSpawnError("recorded")

    monkeypatch.setattr(wmod.WorkerHandle, "spawn", fake_spawn)
    reg = ModelRegistry.from_config(_cfg(), device="cpu")
    e = reg.get("default")
    r = e.replicas.replicas[0]
    cand = copy.deepcopy(e.engine.model)
    with torch.no_grad():
        for p in cand.parameters():
            p.mul_(1.25)
    ck = str(tmp_path / "cand.ckpt")
    save_checkpoint(ck, TrainState(cand, make_optimizer(cand.parameters(),
                                                        1e-3)), epoch=0)
    for want_ck in (None, ck):
        r.current_checkpoint = want_ck
        with pytest.raises(wmod.WorkerSpawnError):
            r._spawn_worker()
    live = e.engine.params_digest()
    assert seen == [(None, live), (ck, params_digest(cand.state_dict()))]
    assert seen[1][1] != live


# ---- the process drills (slow) -----------------------------------------------------

@pytest.mark.slow
@pytest.mark.process
def test_kill9_and_sigstop_drill_process_workers():
    """Two children on the CPU: SIGKILL one mid-traffic (every request still
    answered, the supervisor respawns it), SIGSTOP the other (heartbeat
    staleness, SIGKILL escalation, respawn), then one armed spawn failure
    (degraded, then a real child again)."""
    from distegnn_tpu_torch.testing import serve_faults
    from distegnn_tpu_torch.testing.promote_drill import run_worker_faults

    cfg = _cfg(replicas=2, request_timeout_ms=120_000.0, heartbeat_s=0.1,
               worker_heartbeat_timeout_s=1.5,
               backoff_base_s=0.25, backoff_max_s=2.0, breaker_threshold=5)
    reg = ModelRegistry.from_config(cfg, device="cpu").start()
    try:
        e = reg.get("default")
        g = _graph(cfg)
        ref = e.engine.predict(dict(g))
        futs = [e.replicas.submit(dict(g)) for _ in range(8)]
        old = serve_faults.kill9_replica(reg, "default", 0)
        futs += [e.replicas.submit(dict(g)) for _ in range(8)]
        for f in futs:
            np.testing.assert_array_equal(f.result(timeout=120.0), ref)
        r0 = e.replicas.replicas[0]
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and not (
                r0.healthy() and r0.queue.pid not in (None, old)):
            time.sleep(0.05)
        assert r0.restarts >= 1 and r0.queue.pid not in (None, old)
        assert _gone(old)
        rec = run_worker_faults(reg, "default", 1, 0, timeout_s=60.0)
        assert rec["ok"], rec
    finally:
        reg.stop()
    assert not wmod._LIVE


@pytest.mark.slow
@pytest.mark.process
def test_swap_racing_inflight_spawn_is_caught_up(tmp_path):
    """A hot-swap that defers WHILE a respawn is in flight must not strand
    the fresh worker on the pre-swap params: the post-spawn catch-up swaps
    it over IPC, and the supervisor's reconcile heals a later deferral."""
    import copy

    import torch

    from distegnn_tpu_torch.serve import engine_from_config
    from distegnn_tpu_torch.train.checkpoint import save_checkpoint
    from distegnn_tpu_torch.train.step import TrainState, make_optimizer

    cfg = _cfg()
    reg = ModelRegistry.from_config(cfg, device="cpu")
    e = reg.get("default")
    r = e.replicas.replicas[0]
    reg.start()
    try:
        model_b = copy.deepcopy(e.engine.model)
        with torch.no_grad():
            for p in model_b.parameters():
                p.mul_(1.0625)
        ck = str(tmp_path / "b.ckpt")
        save_checkpoint(ck, TrainState(model_b, make_optimizer(
            model_b.parameters(), 1e-3)), epoch=0)
        g = _graph(cfg, n=6, seed=5)
        ref_b = engine_from_config(cfg, model_b, "cpu").predict(dict(g))
        orig_spawn = r._spawn_worker

        def racing_spawn():
            h = orig_spawn()
            r.current_checkpoint = ck
            e.engine.params = model_b.state_dict()
            return h

        r._spawn_worker = racing_spawn
        old_pid = r.queue.pid
        os.kill(old_pid, signal.SIGKILL)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and not (
                r.healthy() and r.state == "running"
                and getattr(r.queue, "pid", None) not in (None, old_pid)):
            time.sleep(0.05)
        w = r.queue.worker
        assert w is not None and w.checkpoint == ck
        out = e.replicas.submit(dict(g)).result(timeout=120.0)
        np.testing.assert_array_equal(out, ref_b)
        w.checkpoint = None
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and w.checkpoint != ck:
            time.sleep(0.05)
        assert w.checkpoint == ck
    finally:
        reg.stop()
    assert not wmod._LIVE


@pytest.mark.slow
@pytest.mark.process
def test_rolled_back_canary_child_serves_the_live_params(tmp_path):
    """The promoter's canary on a process replica, with the supervisor
    ticking between the canary swap and its rollback: after the drift
    rollback the canary CHILD's params digest is the live one (JAX's
    supervisor re-swaps the canary to the candidate at its next tick, the
    child's held params become the candidate's, and the rollback restores
    the candidate; with no earlier swap nothing heals it)."""
    import copy

    import torch

    from distegnn_tpu_torch.promote.promoter import Promoter
    from distegnn_tpu_torch.promote.publish import CandidatePublisher
    from distegnn_tpu_torch.train.checkpoint import save_checkpoint
    from distegnn_tpu_torch.train.step import TrainState, make_optimizer

    cfg = _cfg(replicas=2, heartbeat_s=0.05)
    reg = ModelRegistry.from_config(cfg, device="cpu").start()
    try:
        e = reg.get("default")
        e.warmup([24])
        live = e.engine.params_digest()
        cand = copy.deepcopy(e.engine.model)
        with torch.no_grad():
            for p in cand.parameters():
                p.mul_(1.0001)
        src = str(tmp_path / "cand.ckpt")
        save_checkpoint(src, TrainState(cand, make_optimizer(
            cand.parameters(), 1e-3)), epoch=0)
        watch = tmp_path / "conveyor"
        CandidatePublisher(str(watch)).publish(src, step=5)
        names = {"default": e}
        pm = Promoter(type("R", (), {"names": lambda self: ["default"],
                                     "get": lambda self, n: names[n]})(),
                      None, config=dict(enable=True, watch_dir=str(watch),
                                        interval_s=3600.0, shadow_sample=1.0,
                                        min_shadow=2, gate_timeout_s=10.0))
        pm.tick(now=0.0)
        run = pm._canary
        w = run.replica.queue.worker
        assert w.call("stats")["params_digest"] != live
        time.sleep(0.5)          # supervisor ticks with the canary swapped
        g = _graph(cfg)
        for i in range(2):
            out = e.replicas.submit(dict(g)).result(timeout=60.0)
            pm.tee("default", dict(g), None, f"r{i}", np.asarray(out) * 2.0)
        deadline = time.monotonic() + 30.0
        while run.gauge.samples < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        pm.tick(now=1.0)
        assert pm.results[-1]["reason"] == "drift"
        time.sleep(0.5)
        assert run.replica.current_checkpoint is None
        assert run.replica.queue.worker is w
        assert w.call("stats")["params_digest"] == live
        pm.stop()
    finally:
        reg.stop()
    assert not wmod._LIVE
