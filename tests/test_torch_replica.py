"""The port's replicas (``serve/replica.py``, the thread backend), replica
supervisor (``serve/supervisor.py``) and autoscaler (``serve/autoscale.py``)
on the CPU, held against the JAX package's under the same synthetic clocks.

Both packages' replica sets run over the port's engines (the narrow
``nbody_serve`` model, H=16, L=2, C=3, the JAX parameters carried across):
what is compared is the replica layer's behaviour, and the coordinates are
held against the JAX engine's own predictions.

Bounds: coordinates within 1e-5 absolute; everything else exact — which
requests fail over and where they land, each request resolving exactly
once, the supervisor's states, failure counts, restart times and breaker,
and the autoscaler's decisions and gauges.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import time

import numpy as np
import pytest

from distegnn_tpu.obs.metrics import MetricsRegistry as JRegistry
from distegnn_tpu.serve import RequestQueue as JQueue
from distegnn_tpu.serve import ServeMetrics as JMetrics
from distegnn_tpu.serve.autoscale import ReplicaAutoscaler as JScaler
from distegnn_tpu.serve.replica import ModelUnavailableError as JUnavail
from distegnn_tpu.serve.replica import Replica as JReplica
from distegnn_tpu.serve.replica import ReplicaSet as JSet
from distegnn_tpu_torch.obs.metrics import MetricsRegistry as PRegistry
from distegnn_tpu_torch.serve import RequestQueue as PQueue
from distegnn_tpu_torch.serve import ServeMetrics as PMetrics
from distegnn_tpu_torch.serve import engine_from_config
from distegnn_tpu_torch.serve import engine_with_params_from_config
from distegnn_tpu_torch.serve.autoscale import ReplicaAutoscaler as PScaler
from distegnn_tpu_torch.serve.replica import ModelUnavailableError as PUnavail
from distegnn_tpu_torch.serve.replica import Replica as PReplica
from distegnn_tpu_torch.serve.replica import ReplicaSet as PSet
from torch_serve_pair import (ATOL, carry_params, configs, jax_engine,
                              scene)

JAX = dict(Queue=JQueue, Metrics=JMetrics, Set=JSet, Replica=JReplica,
           Unavail=JUnavail)
PORT = dict(Queue=PQueue, Metrics=PMetrics, Set=PSet, Replica=PReplica,
            Unavail=PUnavail)


@pytest.fixture(scope="module")
def pair():
    jcfg, pcfg = configs()
    jeng, _ = jax_engine(jcfg)
    model, peng = engine_with_params_from_config(pcfg, device="cpu")
    carry_params(jeng, [peng])
    graphs = [scene(50, 100 + i) for i in range(6)]
    want = [jeng.predict(g) for g in graphs]
    return pcfg, peng.model, graphs, want


def _rset(pair, pkg, n=2, **sup):
    """N replicas (each its own port engine on the shared module and its
    own queue of package ``pkg``), one metrics; the supervisor's heartbeat
    parked so the tests drive tick() with synthetic clocks."""
    cfg, module = pair[0], pair[1]
    metrics = pkg["Metrics"]()
    pairs = []
    for _ in range(n):
        eng = engine_from_config(cfg, module, "cpu", metrics=metrics)
        pairs.append((eng, pkg["Queue"](
            eng, batch_deadline_ms=2.0, queue_capacity=32,
            request_timeout_ms=30_000.0, metrics=metrics)))
    return pkg["Set"]("m", pairs,
                      supervisor_opts=dict(heartbeat_s=3600.0, **sup))


def _row(r, now):
    return (r.idx, r.state, r.failures, r.restarts, r.last_reason,
            round(r.next_restart_at - now, 9) if r.next_restart_at else 0.0)


def _kill_mid_batch(pair, pkg):
    graphs, want = pair[2], pair[3]
    rset = _rset(pair, pkg)
    for r in rset.replicas:
        r.queue.wedge(0.5)      # before start: the batch stays claimable
    rset.start()
    resolved = []
    try:
        futs = [rset.submit(dict(g)) for g in graphs]
        for i, f in enumerate(futs):
            f.add_done_callback(lambda fut, i=i: resolved.append(i))
        rset.replicas[0].queue.kill(reason="chaos")
        outs = [f.result(timeout=60) for f in futs]
        for out, w in zip(outs, want):
            np.testing.assert_allclose(out, w, rtol=0, atol=ATOL)
        served = [f.meta["replica"] for f in futs]
        # the crash pass finds nothing left to claim, then restarts
        now = time.perf_counter()
        rset.supervisor.tick(now=now)
        rows = [_row(r, now) for r in rset.replicas]
        rset.supervisor.tick(now=now + 0.6)
        rows += [_row(r, now) for r in rset.replicas]
        snap = rset.metrics.snapshot()
    finally:
        rset.stop()
    return (sorted(resolved), served, rows,
            snap["requests_failed_over"], snap["replica_restarts"])


def test_kill_mid_batch_resolves_every_request_once(pair):
    got = _kill_mid_batch(pair, PORT)
    assert got == _kill_mid_batch(pair, JAX)
    resolved, served, rows, failed_over, restarts = got
    assert resolved == list(range(6))            # each exactly once
    assert set(served) == {1} and failed_over == 3 and restarts == 1
    assert rows[0][1] == "backoff" and rows[2][1] == "running"


def _breaker_and_wedge(pair, pkg):
    rset = _rset(pair, pkg, n=2, backoff_base_s=0.5, backoff_max_s=4.0,
                 breaker_threshold=3, breaker_cooldown_s=30.0,
                 healthy_reset_s=60.0, wedge_timeout_s=5.0)
    rset.start()
    log = []
    try:
        t = 1000.0
        sup, r0, r1 = rset.supervisor, rset.replicas[0], rset.replicas[1]
        for k in range(4):              # crash loop: backoff -> breaker
            r0.queue.kill(reason=f"crash {k}")
            sup.tick(now=t)
            log.append(_row(r0, t))
            sup.tick(now=t + 0.1)       # before the restart time: waits
            log.append(_row(r0, t))
            t += 31.0
            sup.tick(now=t)             # past any backoff or cooldown
            log.append(_row(r0, t))
        log.append(rset.retry_after_s() > 0)
        sup.tick(now=t + 61.0)          # healthy long enough: breaker closes
        log.append(_row(r0, t + 61.0))
        # wedge: depth > 0 with no batch progress past wedge_timeout_s
        r0.queue.wedge(60.0)
        r1.queue.wedge(60.0)
        fut = rset.submit(dict(pair[2][0]))
        stuck = r0 if r0.inflight_count() else r1
        (r1 if stuck is r0 else r0).queue.wedge(0.0)
        sup.tick(now=time.perf_counter() + 6.0)
        log.append((stuck.idx, stuck.state, stuck.last_reason))
        out = fut.result(timeout=60)
        np.testing.assert_allclose(out, pair[3][0], rtol=0, atol=ATOL)
        log.append(rset.metrics.snapshot()["requests_failed_over"])
    finally:
        rset.stop(drain=False, join_timeout_s=2.0)
    return log


def test_backoff_breaker_and_wedge_match_jax(pair):
    got = _breaker_and_wedge(pair, PORT)
    assert got == _breaker_and_wedge(pair, JAX)
    states = [row[1] for row in got[:12]]
    assert states[:3] == ["backoff", "backoff", "running"]
    assert "broken" in states
    assert got[-2][1:] == ("backoff", "wedge") and got[-1] == 1


def _all_down(pair, pkg):
    rset = _rset(pair, pkg)
    rset.start()
    try:
        now = time.perf_counter()
        for r in rset.replicas:
            r.queue.kill(reason="down")
        rset.supervisor.tick(now=now)
        with pytest.raises(pkg["Unavail"]) as err:
            rset.submit(dict(pair[2][0]))
        return (err.value.model, rset.available(),
                [h["state"] for h in rset.health()],
                sorted(rset.health()[0]))
    finally:
        rset.stop(drain=False, join_timeout_s=2.0)


def test_all_replicas_down_is_model_unavailable(pair):
    got = _all_down(pair, PORT)
    assert got == _all_down(pair, JAX)
    assert got[1] == 0 and got[2] == ["backoff", "backoff"]


def _grow_and_retire(pair, pkg):
    rset = _rset(pair, pkg, n=1)
    rset.start()
    try:
        base = rset.replicas[0]

        def build(idx):
            eng = engine_from_config(pair[0], pair[1], "cpu",
                                     metrics=rset.metrics)
            return pkg["Replica"](idx, eng, base.queue.__class__(
                eng, batch_deadline_ms=2.0, metrics=rset.metrics))

        added = [rset.add_replica(build).idx for _ in range(2)]
        futs = [rset.submit(dict(g)) for g in pair[2][:4]]
        for f, w in zip(futs, pair[3]):
            np.testing.assert_allclose(f.result(timeout=60), w, rtol=0,
                                       atol=ATOL)
        served = [f.meta["replica"] for f in futs]
        retired = [getattr(rset.retire_replica(drain_timeout_s=5.0), "idx",
                           None) for _ in range(3)]
        return added, served, retired, [r.idx for r in rset.replicas]
    finally:
        rset.stop()


def test_grow_and_retire_match_jax(pair):
    got = _grow_and_retire(pair, PORT)
    assert got == _grow_and_retire(pair, JAX)
    assert got[0] == [1, 2] and got[2] == [2, 1, None] and got[3] == [0]


class _StubSet:
    def __init__(self):
        self.replicas = [object()]
        self.healthy = 1

    def available(self):
        return min(self.healthy, len(self.replicas))

    def retire_replica(self, drain_timeout_s):
        if len(self.replicas) <= 1:
            return None
        return self.replicas.pop()


class _StubEntry:
    """What the autoscaler reads of a registry entry."""

    def __init__(self, depth):
        self.replicas = _StubSet()
        self.queued = depth
        self.queue = self
        self.warmed = []
        self.replica_factory = object()

    def depth(self):
        return self.queued

    def add_replica(self, warm_sizes=None):
        self.replicas.replicas.append(object())


class _StubRegistry:
    def __init__(self, entries):
        self.entries = entries

    def items(self):
        return sorted(self.entries.items())


class _Window:
    def __init__(self):
        self.snap = {}

    def window_snapshot(self, now=None):
        return dict(self.snap)


def _autoscale(Scaler, Registry):
    depths = [0, 9, 9, 12, 30, 30, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    sheds = [0, 0, 0, 0, 0.2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    entry = _StubEntry(0)
    quiet = _StubEntry(0)
    reg = Registry()
    win = _Window()
    scaler = Scaler(_StubRegistry({"a": entry, "b": quiet}), win,
                    config=dict(enable=True, max_replicas=3,
                                scale_up_cooldown_s=2.0,
                                scale_down_cooldown_s=5.0, queue_high=4.0,
                                idle_rounds=3, p99_high_ms=100.0),
                    metrics_registry=reg)
    out = []
    for i, (d, s) in enumerate(zip(depths, sheds)):
        entry.queued = d
        win.snap = {"shed_rate": s, "predict_p99_ms": 150.0 if i == 2
                    else 20.0}
        scaler.tick(now=100.0 + 1.5 * i)
        out.append((len(entry.replicas.replicas),
                    len(quiet.replicas.replicas), scaler.status(),
                    reg.snapshot()))
    return out


def test_autoscaler_decisions_match_jax():
    got = _autoscale(PScaler, PRegistry)
    assert got == _autoscale(JScaler, JRegistry)
    sizes = [g[0] for g in got]
    assert max(sizes) == 3 and sizes[-1] == 1 and 2 in sizes


def test_supervisor_thread_ticks_on_its_own(pair):
    """The supervisor's heartbeat thread, not only tick(): a killed replica
    is restarted without a caller."""
    rset = _rset(pair, PORT, backoff_base_s=0.01)
    rset.supervisor.heartbeat_s = 0.02
    rset.start()
    try:
        rset.replicas[1].queue.kill(reason="chaos")
        deadline = time.monotonic() + 10.0
        while not (rset.replicas[1].restarts and rset.replicas[1].healthy()):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert rset.replicas[1].restarts == 1
        assert rset.replicas[1].healthy()
        out = rset.submit(dict(pair[2][1])).result(timeout=60)
        np.testing.assert_allclose(out, pair[3][1], rtol=0, atol=ATOL)
    finally:
        rset.stop()
