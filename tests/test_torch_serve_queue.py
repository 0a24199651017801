"""The port's request queue and micro-batcher (``serve/queue.py``), session
prep cache (``serve/prep.py``, ``ops/blocked.py`` ``repack_blocked``) and
serving metrics (``serve/metrics.py``) on the CPU, held against the JAX
package's on the same inputs: the narrow ``nbody_serve`` model (H=16, L=2,
C=3), the JAX parameters carried into the port.

Bounds: predicted coordinates and trajectories within 1e-5 absolute;
everything else exact — batch compositions, error types, the metrics'
counters and names, the cache and session hit/miss/eviction counts, the
``RepackPlan`` arrays and the prepared dicts.
"""

import time
from collections import OrderedDict

import numpy as np
import pytest

from distegnn_tpu.ops.blocked import repack_blocked as jax_repack
from distegnn_tpu.serve import RequestQueue as JQueue
from distegnn_tpu.serve import ServeMetrics as JMetrics
from distegnn_tpu.serve.prep import SessionPrepCache as JPrep
from distegnn_tpu.serve.queue import DispatcherCrashError as JCrash
from distegnn_tpu.serve.queue import QueueFullError as JFull
from distegnn_tpu.serve.queue import RequestTimeoutError as JTimeout
from distegnn_tpu_torch.ops.blocked import repack_blocked as port_repack
from distegnn_tpu_torch.serve import RequestQueue as PQueue
from distegnn_tpu_torch.serve import ServeMetrics as PMetrics
from distegnn_tpu_torch.serve import engine_with_params_from_config
from distegnn_tpu_torch.serve.prep import SessionPrepCache as PPrep
from distegnn_tpu_torch.serve.queue import DispatcherCrashError as PCrash
from distegnn_tpu_torch.serve.queue import QueueFullError as PFull
from distegnn_tpu_torch.serve.queue import RequestTimeoutError as PTimeout
from torch_serve_pair import (ATOL, ROLLOUT, carry_params, configs,
                              jax_engine, rollout_scene, scene)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) of the narrow model with rollouts, the
    port carrying the JAX parameters; one per file, so JAX compiles each
    shape once."""
    jcfg, pcfg = configs({"serve.rollout": ROLLOUT})
    jeng, _ = jax_engine(jcfg)
    _, peng = engine_with_params_from_config(pcfg, device="cpu")
    carry_params(jeng, [peng])
    return jeng, peng


class _Spy:
    """Records each engine call's members (by the ``tag`` key of the graph
    dicts) before delegating."""

    def __init__(self, engine):
        self.engine, self.calls = engine, []
        self._predict, self._rollout = engine.predict_batch, \
            engine.rollout_batch

    def install(self):
        def predict_batch(graphs, bucket=None, request_ids=None):
            self.calls.append(("predict", tuple(g["tag"] for g in graphs)))
            return self._predict(graphs, bucket=bucket,
                                 request_ids=request_ids)

        def rollout_batch(scenes, request_ids=None):
            self.calls.append(("rollout", tuple(s["tag"] for s in scenes)))
            return self._rollout(scenes, request_ids=request_ids)

        self.engine.predict_batch = predict_batch
        self.engine.rollout_batch = rollout_batch
        return self

    def remove(self):
        del self.engine.predict_batch, self.engine.rollout_batch


def _traffic():
    """Predicts on two rungs and rollouts of two lengths, interleaved."""
    reqs = []
    for i, n in enumerate((50, 50, 100, 50, 100, 50, 50)):
        g = scene(n, 10 + i)
        g["tag"] = f"p{i}"
        reqs.append(("predict", g))
    for i, steps in enumerate((2, 1, 2)):
        s = rollout_scene(60 + 10 * i, 20 + i, steps)
        s["tag"] = f"r{i}"
        reqs.append(("rollout", s))
    order = [0, 7, 1, 2, 8, 3, 4, 9, 5, 6]
    return [reqs[i] for i in order]


def _drive(engine, Queue, traffic):
    """Submit the traffic while the dispatcher is wedged, so it absorbs the
    whole wave in one pass: the batches then depend on the keys alone.
    ``Queue`` is either package's RequestQueue (both take any engine with
    the InferenceEngine surface)."""
    spy = _Spy(engine).install()
    q = Queue(engine, batch_deadline_ms=20.0, queue_capacity=64,
              request_timeout_ms=60_000.0, metrics=engine.metrics)
    q.wedge(0.4)        # before start: the first get() must not race it
    q.start()
    try:
        futs = [q.submit(p) if kind == "predict" else q.submit_rollout(p)
                for kind, p in traffic]
        outs = [f.result(timeout=120) for f in futs]
        metas = [{k: f.meta[k] for k in ("batch_filled", "bucket_n",
                                         "bucket_e")} for f in futs]
    finally:
        q.stop()
        spy.remove()
    return spy.calls, outs, metas


def test_batch_compositions_and_results_match_jax(engines):
    """Both packages' queues over the same (port) engine form the same
    batches; the port's predictions match the JAX engine's."""
    jeng, peng = engines
    traffic = _traffic()
    jcalls, _, jmeta = _drive(peng, JQueue, traffic)
    pcalls, pouts, pmeta = _drive(peng, PQueue, traffic)
    assert pcalls == jcalls
    # predicts coalesce per rung up to max_batch 4; rollouts per (rung, K)
    assert sorted(len(m) for _, m in pcalls) == [1, 1, 2, 2, 4]
    assert pmeta == jmeta
    for (kind, g), out in zip(traffic, pouts):
        if kind == "predict":
            np.testing.assert_allclose(out, jeng.predict(g), rtol=0,
                                       atol=ATOL)
        else:
            assert out.shape == (g["steps"], g["loc"].shape[0], 3)
            assert np.isfinite(out).all()


def test_shape_lru_counts_as_jax_cache(engines):
    """Hits, misses and evictions of the port's shape-key LRU equal the JAX
    compile cache's over the same request sequence."""
    jeng, peng = engines
    # the same live keys on both sides to start from (the port engine has
    # also served the rollouts of the test above)
    peng.shapes_seen = OrderedDict((k, None) for k in jeng._cache)
    graphs = [scene(n, 40 + n) for n in (50, 100, 50, 200, 50, 100)]
    stats = []
    for eng in (jeng, peng):
        size, eng.cache_size = eng.cache_size, 2
        try:
            before = eng.cache_stats()
            for g in graphs:
                eng.predict(g)
            after = eng.cache_stats()
        finally:
            eng.cache_size = size
        stats.append({k: after[k] - before[k] for k in after})
    assert stats[1] == stats[0]
    assert stats[1]["evictions"] > 0 and stats[1]["hits"] > 0
    assert list(peng.shapes_seen) == list(jeng._cache)


def _settled_depth(q, limit_s=10.0):
    """The queue's depth once its dispatcher has finished the pass that
    resolved the futures (it answers a request before it drops it from
    its pending map)."""
    deadline = time.monotonic() + limit_s
    while q.depth() and time.monotonic() < deadline:
        time.sleep(0.01)
    return q.depth()


def test_queue_errors_match_jax(engines):
    jeng, peng = engines
    seen = {}
    for eng, Queue, Full, Timeout, Crash in (
            (jeng, JQueue, JFull, JTimeout, JCrash),
            (peng, PQueue, PFull, PTimeout, PCrash)):
        got = []
        # capacity: a wedged dispatcher absorbs nothing, the ingress fills
        q = Queue(eng, batch_deadline_ms=1.0, queue_capacity=2,
                  request_timeout_ms=60.0, metrics=eng.metrics)
        # (held until released, however slowly this host runs the test)
        q.wedge(60.0)
        q.start()
        futs = [q.submit(scene(50, 1)), q.submit(scene(50, 2))]
        with pytest.raises(Full):
            q.submit(scene(50, 3))
        # the queued deadline passes while wedged
        time.sleep(0.1)
        q.wedge(0.0)
        for f in futs:
            with pytest.raises(Timeout):
                f.result(timeout=60)
        got.append(_settled_depth(q))
        # kill: every outstanding future fails typed, submits raise
        q.wedge(30.0)
        f = q.submit(scene(50, 4))
        q.kill(reason="test")
        with pytest.raises(Crash):
            f.result(timeout=10)
        with pytest.raises(RuntimeError, match="not started"):
            q.submit(scene(50, 5))
        q.stop()
        # poison: a batch that fails is retried one request at a time
        q = Queue(eng, batch_deadline_ms=20.0, queue_capacity=8,
                  request_timeout_ms=60_000.0, metrics=eng.metrics)
        bad = scene(50, 6)
        bad["node_feat"] = np.ones((50, 3), np.float32)
        q.wedge(60.0)
        q.start()
        good, poison = q.submit(scene(50, 7)), q.submit(bad)
        q.wedge(0.0)  # both wait in the ingress: one batch takes them
        good.result(timeout=60)
        with pytest.raises(Exception):
            poison.result(timeout=60)
        q.stop()
        snap = eng.metrics.snapshot()
        got.append({k: snap[k] for k in ("requests_rejected",
                                         "requests_timeout",
                                         "requests_retried",
                                         "requests_poison")})
        seen[Queue.__module__] = got
    assert seen[PQueue.__module__] == seen[JQueue.__module__]


def test_metrics_snapshot_and_names_match_jax():
    snaps, names, prom = [], [], []
    for Metrics in (JMetrics, PMetrics):
        m = Metrics(reservoir=16)
        m.submitted(5)
        m.rejected()
        m.timed_out(2)
        m.failed()
        m.retried(3)
        m.poison()
        m.worker_restarted()
        m.failed_over(2)
        m.replica_restarted()
        m.batch_done(3, 4, [1.0, 2.0, 30.0], [0.5, 0.25, 0.125])
        m.cache_event(hit=False, evicted=2)
        m.cache_event(hit=True)
        m.session_event(hit=False, evicted=1)
        m.set_queue_depth(7)
        s = m.snapshot()
        s.pop("uptime_s"), s.pop("requests_per_sec")
        snaps.append(s)
        names.append(m.registry.names())
        prom.append([line.split()[0] for line in
                     m.render_prometheus().splitlines()])
        assert m.requests_submitted == 5 and m.queue_depth == 7
    assert snaps[1] == snaps[0]
    assert names[1] == names[0] and prom[1] == prom[0]


def _edges(n, e, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, size=(2, e)).astype(np.int32),
            rng.uniform(0, 1, size=(n, 3)).astype(np.float32))


@pytest.mark.parametrize("with_loc", [False, True])
def test_repack_plan_matches_jax(with_loc):
    ei, loc = _edges(700, 5000, 3)
    kw = dict(n_nodes_padded=768, epb=2048, block=256)
    a = jax_repack(ei, loc if with_loc else None, **kw)
    b = port_repack(ei, loc if with_loc else None, **kw)
    assert a._fields == b._fields
    for name in ("perm", "edge_index", "edge_mask", "src", "dst"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.stamp == b.stamp
    attr = np.random.default_rng(4).normal(size=(5000, 2)).astype(np.float32)
    assert np.array_equal(a.apply_edge_attr(attr), b.apply_edge_attr(attr))


LAYOUTS = [{}, {"edge_block": 256, "split_remote": True}]


@pytest.mark.parametrize("layout", LAYOUTS, ids=["plain", "blocked"])
def test_session_prep_cache_matches_jax(layout):
    jcfg, pcfg = configs()
    from distegnn_tpu.serve.buckets import BucketLadder as JLadder
    from distegnn_tpu_torch.serve.buckets import BucketLadder as PLadder

    g1, g2, g3 = scene(300, 1), scene(400, 2), scene(350, 3)
    g1b = dict(g1, loc=g1["loc"] + 0.01)             # frame 2, same topology
    g2b = scene(400, 9)                              # session 2 re-meshed
    seq = [("s1", g1), ("s1", g1b), ("s2", g2), ("s3", g3), ("s1", g1),
           ("s2", g2b), ("s3", g3)]
    runs = []
    for Prep, Ladder, Metrics in ((JPrep, JLadder, JMetrics),
                                  (PPrep, PLadder, PMetrics)):
        m = Metrics()
        cache = Prep(2, ladder=Ladder(max_nodes=16384, max_edges=262144),
                     layout_opts=layout, metrics=m)
        outs = [cache.prepare(sid, g) for sid, g in seq]
        s = m.snapshot()
        runs.append((outs, {k: s[k] for k in ("session_hits",
                                              "session_misses",
                                              "session_evictions")},
                     cache.bytes_used, len(cache)))
    (jo, jc, jb, jn), (po, pc, pb, pn) = runs
    assert pc == jc and pb == jb and pn == jn
    assert pc["session_hits"] >= 1 and pc["session_evictions"] >= 1
    for a, b in zip(jo, po):
        assert a.hit == b.hit and tuple(a.bucket) == tuple(b.bucket)
        assert (a.perm is None) == (b.perm is None)
        if a.perm is not None:
            assert np.array_equal(a.perm, b.perm)
        assert set(a.graph) == set(b.graph)
        for k, v in a.graph.items():
            w = b.graph[k]
            if isinstance(v, np.ndarray):
                assert v.dtype == w.dtype and np.array_equal(v, w), k
            else:
                assert v == w, k


def test_session_cache_byte_bound_evicts_to_fit():
    from distegnn_tpu_torch.serve.buckets import BucketLadder

    m = PMetrics()
    cache = PPrep(8, ladder=BucketLadder(), metrics=m, max_bytes=1)
    for i in range(3):
        cache.prepare(f"s{i}", scene(100, i))
    # each plan alone exceeds the bound: every insert evicts the last one
    assert len(cache) == 1 and m.snapshot()["session_evictions"] == 2
    assert m.registry.snapshot()["serve/session_cache_bytes"] == \
        cache.bytes_used > 0


def test_stream_sink_delivers_chunks_and_cancels(engines):
    _, peng = engines
    from distegnn_tpu_torch.serve.queue import StreamSink

    s = rollout_scene(60, 5, 5)
    whole = peng.rollout(s["loc"], s["vel"], 5)
    sink = StreamSink()
    summary = peng.rollout_stream(dict(s, chunk_steps=2), sink)
    chunks = []
    while not sink._q.empty():
        kind, start, traj = sink.next(timeout=1)
        chunks.append((start, traj))
    assert [c[0] for c in chunks] == [0, 2, 4]
    np.testing.assert_allclose(np.concatenate([c[1] for c in chunks]),
                               whole, rtol=0, atol=ATOL)
    assert summary == {"steps_total": 5, "steps_done": 5,
                       "cancelled": False, "chunk_steps": 2}
    # a cancel between chunks stops the rest

    class _CancelAfterFirst:
        cancelled = False

        def put_chunk(self, start, traj):
            self.cancelled = True

    out = peng.rollout_stream(dict(s, chunk_steps=2), _CancelAfterFirst())
    assert out == {"steps_total": 5, "steps_done": 2, "cancelled": True,
                   "chunk_steps": 2}


def test_params_digest_follows_the_parameters(engines):
    """The digest is a function of the parameters alone: equal for an
    engine carrying the same ones, different once one value changes, and
    back after a rollback to the old dict."""
    jeng, peng = engines
    _, other = engine_with_params_from_config(configs()[1], device="cpu")
    assert other.params_digest() != peng.params_digest()
    carry_params(jeng, [other])
    assert other.params_digest() == peng.params_digest()
    old = other.params
    bumped = {k: v.clone() for k, v in old.items()}
    next(iter(bumped.values())).view(-1)[0] += 1.0
    other.params = bumped
    assert other.params_digest() != peng.params_digest()
    other.params = old
    assert other.params_digest() == peng.params_digest()
