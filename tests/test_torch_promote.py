"""The port's promotion conveyor (``distegnn_tpu_torch/promote``) on the CPU,
held against the JAX package's: the publisher's on-disk format read across
packages, ``config_hash``, the drift gauge, the promoter's state machine on
a synthetic clock over a tiny thread fleet (H=16, L=2), the trainer's
publish-on-rotation hook, and JAX's four-phase drill through a live
in-process gateway.

Bounds: manifests equal field by field but ``time``, ``config_hash`` and
every drift-gauge number exactly equal; the promoter's outcome sequence and
the keys of its ``status()`` equal JAX's on the same inputs; the drill's
four outcomes as in ``tests/test_promote.py``, 0 lost requests, 0 errors.
"""

import copy
import glob
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from distegnn_tpu.obs.metrics import MetricsRegistry as JRegistry
from distegnn_tpu.promote import drift as jdrift
from distegnn_tpu.promote import promoter as jpromoter
from distegnn_tpu.promote import publish as jpublish
from distegnn_tpu.train.checkpoint import save_checkpoint as jax_save
from distegnn_tpu_torch.obs.metrics import MetricsRegistry as PRegistry
from distegnn_tpu_torch.promote import drift as pdrift
from distegnn_tpu_torch.promote import promoter as ppromoter
from distegnn_tpu_torch.promote import publish as ppublish
from distegnn_tpu_torch.serve import RequestQueue as PQueue
from distegnn_tpu_torch.serve import ServeMetrics as PMetrics
from distegnn_tpu_torch.serve import (engine_from_config,
                                      engine_with_params_from_config)
from distegnn_tpu_torch.serve.registry import ModelEntry as PEntry
from distegnn_tpu_torch.train.checkpoint import save_checkpoint as port_save
from distegnn_tpu_torch.train.step import TrainState, make_optimizer
from torch_serve_pair import REPO, carry_params, configs, jax_engine, scene

pytestmark = pytest.mark.serve

CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
PROMOTE = os.path.join(REPO, "configs", "nbody_promote.yaml")


def _save_port(module, path, scale=1.0):
    m = copy.deepcopy(module).cpu()
    with torch.no_grad():
        for p in m.parameters():
            p.mul_(scale)
    port_save(str(path), TrainState(m, make_optimizer(m.parameters(), 1e-3)),
              epoch=0)
    return str(path)


# ---- the publisher ----------------------------------------------------------------

def _manifest(path):
    with open(path) as f:
        text = f.read()
    return json.loads(text), text


def test_publishers_write_the_same_manifest_and_read_each_other(tmp_path):
    """The same checkpoint published by each package: the manifests agree
    field by field and byte for byte but ``time``; each package lists and
    verifies the other's candidate."""
    src = tmp_path / "src.ckpt"
    src.write_bytes(os.urandom(4096))
    config = {"model": {"hidden_nf": 16}, "seed": 43}
    mp = ppublish.CandidatePublisher(str(tmp_path / "p")).publish(
        str(src), step=12, val_loss=0.25, config=config)
    mj = jpublish.CandidatePublisher(str(tmp_path / "j")).publish(
        str(src), step=12, val_loss=0.25, config=config)
    assert os.path.basename(mp) == os.path.basename(mj) == \
        ppublish.candidate_manifest_name(12) == \
        jpublish.candidate_manifest_name(12)
    (p, ptext), (j, jtext) = _manifest(mp), _manifest(mj)
    assert p.pop("time") > 0 and j.pop("time") > 0
    assert p == j
    assert ptext.replace(repr(json.loads(ptext)["time"]), "T") == \
        jtext.replace(repr(json.loads(jtext)["time"]), "T")
    for reader, d in ((ppublish, "j"), (jpublish, "p")):
        assert reader.list_candidates(str(tmp_path / d)) == [12]
        man = reader.read_candidate(str(tmp_path / d), 12)
        assert man["ckpt_path"] == str(tmp_path / d / "step_0000000012.ckpt")
        assert (man["crc32"], man["size"]) == (j["crc32"], j["size"])
    assert not any(".tmp." in f for d in ("p", "j")
                   for f in os.listdir(tmp_path / d))


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_config_hash_equals_jax_for_every_shipped_config(path):
    from distegnn_tpu.config import load_config as jax_load_config

    with open(path) as f:
        raw = yaml.safe_load(f)
    loaded = jax_load_config(path).to_dict()
    for cfg in (raw, loaded):
        assert ppublish.config_hash(cfg) == jpublish.config_hash(cfg)
    assert ppublish.config_hash(None) is None


def test_publish_prunes_manifest_first_and_sweeps_orphans(tmp_path):
    src = tmp_path / "src.ckpt"
    src.write_bytes(b"x" * 100)
    watch = tmp_path / "conveyor"
    os.makedirs(watch)
    orphan = watch / "step_0000000007.ckpt.tmp.abc123"
    orphan.write_bytes(b"torn")
    pub = ppublish.CandidatePublisher(str(watch), history=2)
    removed = []
    real_unlink = os.unlink

    def spy(path):
        removed.append(os.path.basename(path))
        real_unlink(path)

    for step in (1, 2, 3):
        pub.publish(str(src), step=step)
    assert not orphan.exists()
    try:
        ppublish.os.unlink = spy
        pub.publish(str(src), step=4)
    finally:
        ppublish.os.unlink = real_unlink
    assert ppublish.list_candidates(str(watch)) == [3, 4]
    assert removed == [ppublish.candidate_manifest_name(2),
                       "step_0000000002.ckpt"]
    assert sorted(os.listdir(watch)) == [
        "step_0000000003.ckpt", ppublish.candidate_manifest_name(3),
        "step_0000000004.ckpt", ppublish.candidate_manifest_name(4)]


def test_read_candidate_rejects_torn_and_missing_as_jax(tmp_path):
    src = tmp_path / "src.ckpt"
    src.write_bytes(os.urandom(256))
    watch = tmp_path / "conveyor"
    ppublish.CandidatePublisher(str(watch)).publish(str(src), step=5)
    ckpt = watch / "step_0000000005.ckpt"
    blob = ckpt.read_bytes()
    cases = [("size mismatch", lambda: ckpt.write_bytes(blob[:-16]), 5),
             ("crc32 mismatch",
              lambda: ckpt.write_bytes(blob[:-1] + bytes([blob[-1] ^ 0xFF])),
              5),
             ("missing checkpoint", lambda: ckpt.unlink(), 5),
             ("unreadable manifest",
              lambda: (watch / ppublish.candidate_manifest_name(5))
              .write_text("{not json"), 5),
             ("unreadable manifest", lambda: None, 99)]
    for what, damage, step in cases:
        damage()
        with pytest.raises(ValueError, match=what) as perr:
            ppublish.read_candidate(str(watch), step)
        with pytest.raises(ValueError) as jerr:
            jpublish.read_candidate(str(watch), step)
        assert str(perr.value) == str(jerr.value)


# ---- the drift gauge ----------------------------------------------------------------

def test_drift_gauge_equals_jax_exactly():
    """One seeded sequence of observations — small and large divergences,
    non-finite canaries and lives, shape mismatches, three rungs — through
    both gauges: every returned divergence, verdict, snapshot and exported
    gauge exactly equal."""
    rng = np.random.default_rng(7)
    gauges = (pdrift.DriftGauge(ceiling=0.05, min_samples=6),
              jdrift.DriftGauge(ceiling=0.05, min_samples=6))
    for i in range(40):
        rung = f"n{[64, 128, 256][i % 3]}"
        n = 4 + i % 5
        live = rng.normal(size=(n, 3))
        canary = live * (1 + rng.uniform(0, 0.09)) + \
            rng.normal(scale=1e-3, size=(n, 3))
        if i == 17:
            canary[0, 1] = np.nan
        elif i == 23:
            live[2, 0] = np.inf
        elif i == 31:
            canary = np.ones((n + 1, 3))
        outs = [g.observe(rung, live, canary) for g in gauges]
        assert outs[0] == outs[1] or (np.isinf(outs[0]) and
                                      np.isinf(outs[1]))
        views = [(g.samples, g.decided(), g.drifted(), g.snapshot())
                 for g in gauges]
        assert views[0] == views[1], i
    regs = (PRegistry(), JRegistry())
    for g, reg in zip(gauges, regs):
        g.export(reg)
    for rung in gauges[0].snapshot():
        for stat in ("mean", "max"):
            name = f"promote/drift_{rung}_{stat}"
            assert regs[0].gauge(name).value == regs[1].gauge(name).value
    for g in gauges:
        g.reset()
    assert gauges[0].snapshot() == gauges[1].snapshot() == {}


def test_promoter_defaults_in_lockstep_with_config_and_jax():
    from distegnn_tpu_torch.config import _DEFAULTS

    assert ppromoter._DEFAULTS == _DEFAULTS["promote"] == \
        jpromoter._DEFAULTS
    assert ppromoter.watch_dir_from_config({"promote": {"watch_dir": "/c"}}) \
        == "/c"
    assert ppromoter.watch_dir_from_config({}) == ""
    assert ppromoter.watch_dir_from_config(SimpleNamespace()) == ""


# ---- the promoter on a synthetic clock -----------------------------------------------

@pytest.fixture(scope="module")
def fleet():
    """The narrow nbody_serve model in both packages, the JAX parameters
    carried into the port, and the shadow graph."""
    jcfg, pcfg = configs()
    jeng, _ = jax_engine(jcfg)
    model, peng = engine_with_params_from_config(pcfg, device="cpu")
    carry_params(jeng, [peng])
    return SimpleNamespace(jcfg=jcfg, pcfg=pcfg, jeng=jeng,
                           module=peng.model, graph=scene(50, 7))


def _port_entry(fleet, n=2, name="m"):
    metrics = PMetrics()
    pairs = []
    for _ in range(n):
        eng = engine_from_config(fleet.pcfg, fleet.module, "cpu",
                                 metrics=metrics)
        pairs.append((eng, PQueue(eng, batch_deadline_ms=2.0,
                                  request_timeout_ms=30_000.0,
                                  metrics=metrics)))
    (e0, q0), extra = pairs[0], pairs[1:]
    entry = PEntry(name, e0, q0, feat_nf=1, edge_attr_nf=2,
                   extra_replicas=extra,
                   supervisor_opts=dict(heartbeat_s=3600.0))
    entry.start()
    entry.warmup([50])
    return entry


def _jax_entry(fleet, n=2, name="m"):
    from distegnn_tpu.serve import RequestQueue, ServeMetrics
    from distegnn_tpu.serve import engine_from_config as jengine_from_config
    from distegnn_tpu.serve.registry import ModelEntry

    metrics = ServeMetrics()
    pairs = []
    for _ in range(n):
        eng, _ = jengine_from_config(fleet.jcfg, fleet.jeng.model,
                                     params=fleet.jeng.params,
                                     metrics=metrics)
        pairs.append((eng, RequestQueue(eng, batch_deadline_ms=2.0,
                                        request_timeout_ms=30_000.0,
                                        metrics=metrics)))
    (e0, q0), extra = pairs[0], pairs[1:]
    entry = ModelEntry(name, e0, q0, feat_nf=1, edge_attr_nf=2,
                       extra_replicas=extra,
                       supervisor_opts=dict(heartbeat_s=3600.0))
    entry.start()
    entry.warmup([50])
    return entry


def _promoter(mod, entry, watch, monitor=None, **over):
    reg = SimpleNamespace(names=lambda: [entry.name],
                          get=lambda n: {entry.name: entry}[n])
    knobs = dict(enable=True, watch_dir=str(watch), interval_s=3600.0,
                 shadow_sample=1.0, min_shadow=2, gate_timeout_s=10.0,
                 drift_ceiling=0.05, max_error_rate=0.0)
    knobs.update(over)
    return mod.Promoter(reg, monitor, config=knobs)


def _publish_port(fleet, tmp_path, watch, step, scale=1.0001,
                  name="cand.ckpt"):
    ppublish.CandidatePublisher(str(watch)).publish(
        _save_port(fleet.module, tmp_path / name, scale), step=step)


def _publish_jax(fleet, tmp_path, watch, step, scale=1.0001,
                 name="jcand.ckpt"):
    import jax

    params = jax.tree.map(lambda x: x * scale, fleet.jeng.params)
    path = tmp_path / name
    jax_save(str(path), SimpleNamespace(params=params, opt_state={}, step=0),
             epoch=0)
    jpublish.CandidatePublisher(str(watch)).publish(str(path), step=step)


def _feed_shadows(pm, entry, graph, n, live_scale=1.0):
    run = pm._canary
    for i in range(n):
        out = entry.queue.submit(dict(graph)).result(timeout=60.0)
        pm.tee(entry.name, dict(graph), None, f"r{i}",
               np.asarray(out) * live_scale)
    deadline = time.monotonic() + 30.0
    while (run.gauge.samples + run.shadow_errors < n
           and time.monotonic() < deadline):
        time.sleep(0.02)


def _scenario(pkg, fleet, tmp_path, live_scale):
    """Publish one candidate, canary it, feed two shadows, decide: the
    outcome sequence and the status keys at each point."""
    mod, entry, publish = pkg
    watch = tmp_path / f"{mod.__name__}_conveyor"
    pm = _promoter(mod, entry, watch)
    try:
        publish(fleet, tmp_path, watch, step=5)
        pm.tick(now=0.0)
        mid = pm.status()
        quarantined = entry.replicas.quarantined()
        _feed_shadows(pm, entry, fleet.graph, 2, live_scale)
        pm.tick(now=1.0)
        end = pm.status()
        return {"outcomes": [(r["step"], r["outcome"], r.get("reason"))
                             for r in pm.results],
                "mid_keys": sorted(mid), "canary_keys": sorted(mid["canary"]),
                "end_keys": sorted(end), "mid_state": mid["state"],
                "mid_coherent": mid["fleet_coherent"],
                "end_coherent": end["fleet_coherent"],
                "quarantined": sorted(quarantined),
                "result_keys": sorted(pm.results[-1]),
                "shadow_keys": sorted(pm.results[-1]["shadow"]),
                "teed": pm.results[-1]["shadow"]["teed"],
                "version": entry.params_version,
                "released": not entry.replicas.quarantined()}
    finally:
        pm.stop()
        entry.stop()


@pytest.mark.parametrize("scenario, live_scale",
                         [("promote", 1.0), ("drift", 2.0)])
def test_promoter_outcomes_and_status_keys_equal_jax(fleet, tmp_path,
                                                     scenario, live_scale):
    """JAX's promote and drift scenarios, each package's Promoter over its
    own two-replica thread fleet, fed the same candidate and shadows."""
    port = _scenario((ppromoter, _port_entry(fleet), _publish_port), fleet,
                     tmp_path, live_scale)
    jax_ = _scenario((jpromoter, _jax_entry(fleet), _publish_jax), fleet,
                     tmp_path, live_scale)
    assert port == jax_
    want = ("promoted", None) if scenario == "promote" else ("rolled_back",
                                                             "drift")
    assert port["outcomes"] == [(5, *want)]
    assert port["mid_state"] == "canary" and port["mid_coherent"] is False
    assert port["end_coherent"] is True and port["released"]
    assert port["version"] == (1 if scenario == "promote" else 0)


def test_promoter_drift_rollback_repins_the_canary(fleet, tmp_path):
    entry = _port_entry(fleet)
    pm = _promoter(ppromoter, entry, tmp_path / "conveyor")
    old = entry.engine.params
    try:
        _publish_port(fleet, tmp_path, tmp_path / "conveyor", step=5)
        pm.tick(now=0.0)
        cidx = pm.status()["canary"]["replica"]
        _feed_shadows(pm, entry, fleet.graph, 2, live_scale=2.0)
        pm.tick(now=1.0)
        assert pm.results[-1]["reason"] == "drift"
        assert entry.replicas.replicas[cidx].engine.params is old
        assert ppromoter.fleet_coherent(entry)
    finally:
        pm.stop()
        entry.stop()


def test_promoter_rolls_back_when_canary_dies(fleet, tmp_path):
    entry = _port_entry(fleet)
    pm = _promoter(ppromoter, entry, tmp_path / "conveyor")
    try:
        _publish_port(fleet, tmp_path, tmp_path / "conveyor", step=5)
        pm.tick(now=0.0)
        run = pm._canary
        run.replica.healthy = lambda: False   # SIGKILL's observable effect
        pm.tick(now=0.5)
        assert pm.results[-1] == {"step": 5, "outcome": "rolled_back",
                                  "reason": "canary_died",
                                  "shadow": pm.results[-1]["shadow"]}
        assert not entry.replicas.quarantined()
        assert entry.params_version == 0
    finally:
        pm.stop()
        entry.stop()


def test_promoter_insufficient_shadow_and_slo_gate(fleet, tmp_path):
    entry = _port_entry(fleet)
    pm = _promoter(ppromoter, entry, tmp_path / "a", gate_timeout_s=5.0)
    try:
        _publish_port(fleet, tmp_path, tmp_path / "a", step=5)
        pm.tick(now=0.0)
        pm.tick(now=4.9)     # inside the gate window: still canarying
        assert pm.status()["state"] == "canary"
        pm.tick(now=5.1)     # timed out with ZERO shadow evidence
        assert pm.results[-1]["outcome"] == "rolled_back"
        assert pm.results[-1]["reason"] == "insufficient_shadow"
    finally:
        pm.stop()
    monitor = SimpleNamespace(
        window_snapshot=lambda now=None: {"error_rate": 0.5})
    pm = _promoter(ppromoter, entry, tmp_path / "b", monitor=monitor)
    try:
        _publish_port(fleet, tmp_path, tmp_path / "b", step=6)
        pm.tick(now=0.0)
        _feed_shadows(pm, entry, fleet.graph, 2)
        pm.tick(now=1.0)
        assert pm.results[-1]["outcome"] == "rolled_back"
        assert pm.results[-1]["reason"] == "slo"
        assert entry.params_version == 0
        assert ppromoter.fleet_coherent(entry)
    finally:
        pm.stop()
        entry.stop()


def test_promoter_rejects_torn_and_newest_candidate_wins(fleet, tmp_path,
                                                          monkeypatch):
    entry = _port_entry(fleet)
    watch = tmp_path / "conveyor"
    pm = _promoter(ppromoter, entry, watch)
    events = []
    monkeypatch.setattr(ppromoter.obs, "event",
                        lambda name, **kw: events.append((name, kw)))
    try:
        _publish_port(fleet, tmp_path, watch, step=5)
        ckpt = watch / "step_0000000005.ckpt"
        ckpt.write_bytes(ckpt.read_bytes()[:-8])
        pm.tick(now=0.0)
        assert pm.rejected == 1 and pm.results[-1]["outcome"] == "rejected"
        assert pm.results[-1]["reason"].startswith("verify:")
        assert pm.last_step == 5 and pm.status()["state"] == "idle"
        assert not entry.replicas.quarantined()
        _publish_port(fleet, tmp_path, watch, step=7, name="a.ckpt")
        _publish_port(fleet, tmp_path, watch, step=9, name="b.ckpt")
        pm.tick(now=1.0)
        assert pm.status()["canary"]["step"] == 9
        skips = [kw for n, kw in events if n == "promote/candidates_skipped"]
        assert skips and skips[0]["skipped"] == [7] and \
            skips[0]["chosen"] == 9
    finally:
        pm.stop()
        entry.stop()


def test_promoter_single_replica_swaps_directly_a_jax_candidate(fleet,
                                                                tmp_path):
    """One replica has no canary slice to spare: the plain blue/green swap
    promotes — here a candidate the JAX trainer's format carries, which the
    port loads through ``load_params`` (served bitwise as the carried
    params scaled in numpy)."""
    entry = _port_entry(fleet, n=1)
    pm = _promoter(ppromoter, entry, tmp_path / "conveyor")
    try:
        _publish_jax(fleet, tmp_path, tmp_path / "conveyor", step=5,
                     scale=1.5)
        pm.tick(now=0.0)
        assert pm.promoted == 1 and entry.params_version == 1
        assert pm.results[-1].get("direct") is True
        assert ppromoter.fleet_coherent(entry)
        want = {k: v * 1.5 for k, v in fleet.module.state_dict().items()}
        got = entry.engine.model.state_dict()
        for k, v in want.items():
            assert torch.equal(got[k], v.to(torch.float32)), k
    finally:
        pm.stop()
        entry.stop()


# ---- the trainer end ----------------------------------------------------------------

def test_cadence_saver_publishes_and_survives_a_failed_publish(fleet,
                                                               tmp_path):
    from distegnn_tpu_torch.train.trainer import CadenceSaver

    watch = tmp_path / "conveyor"
    model = copy.deepcopy(fleet.module)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-3))
    state.step = 42
    saver = CadenceSaver(str(tmp_path / "ckpts"), interval_s=1e-9, keep=3,
                         config={"seed": 1}, seed=1, enabled=True,
                         publisher=ppublish.CandidatePublisher(str(watch)))
    saver.last_val_loss = 0.125
    saver._last = float("-inf")
    saver.maybe_save(state, completed_epoch=0, step_in_epoch=3)
    assert saver.saves == 1 and ppublish.list_candidates(str(watch)) == [42]
    man = jpublish.read_candidate(str(watch), 42)   # JAX reads it too
    assert man["val_loss"] == 0.125
    assert man["config_hash"] == jpublish.config_hash({"seed": 1})
    with open(man["ckpt_path"], "rb") as f, \
            open(tmp_path / "ckpts" / "step_0000000042.ckpt", "rb") as g:
        assert f.read() == g.read()

    class _Exploding:
        def publish(self, *a, **kw):
            raise OSError("conveyor full")

    saver = CadenceSaver(str(tmp_path / "ckpts2"), interval_s=1e-9, keep=3,
                         config=None, seed=1, enabled=True,
                         publisher=_Exploding())
    saver._last = float("-inf")
    state.step = 7
    saver.maybe_save(state, completed_epoch=0, step_in_epoch=0)  # no raise
    assert saver.saves == 1


# ---- the four-phase drill, thread backend --------------------------------------------

def _body(g):
    return json.dumps({"positions": g["loc"].tolist(),
                       "velocities": g["vel"].tolist(),
                       "node_feat": g["node_feat"].tolist(),
                       "edge_index": g["edge_index"].tolist(),
                       "edge_attr": g["edge_attr"].tolist()}).encode()


def test_promotion_drill_thread_backend_in_process(tmp_path):
    """JAX's acceptance drill on configs/nbody_promote.yaml (narrowed to
    H=16, L=2; the CPU's deadline raised, the promoter ticking every 0.25 s)
    through a live in-process gateway of three thread replicas: a promoted
    candidate, a publisher killed mid-publish, a killed canary rolled back
    and restarted, a drift candidate rolled back — with predict traffic
    flowing throughout: 0 lost, 0 errors, the fleet coherent at the end."""
    from distegnn_tpu_torch import obs
    from distegnn_tpu_torch.serve.registry import ModelRegistry
    from distegnn_tpu_torch.serve.transport import Gateway
    from distegnn_tpu_torch.testing.promote_drill import (LiveTraffic,
                                                          run_promote_drill)

    _, cfg = configs({"serve.request_timeout_ms": 30_000.0,
                      "promote.watch_dir": str(tmp_path / "conveyor"),
                      "promote.interval_s": 0.25,
                      "serve.supervisor": {"heartbeat_s": 0.1,
                                           "backoff_base_s": 0.2}},
                     path=PROMOTE)
    obs.configure(log_dir=str(tmp_path / "obs"))
    reg = ModelRegistry.from_config(cfg, device="cpu").start()
    reg.warmup([48, 96])
    gw = Gateway(reg, port=0, promote=dict(cfg.promote))
    server = threading.Thread(target=gw.serve_forever, daemon=True)
    server.start()
    try:
        bodies = [_body(scene(n, 900 + i)) for i, n in
                  enumerate((40, 60, 90))]
        traffic = LiveTraffic(gw.port, "default", bodies, clients=2,
                              pause_s=0.01).start()
        rec = run_promote_drill(gw, reg, "default", bodies[0],
                                str(tmp_path / "stage"), traffic=traffic)
    finally:
        gw.drain()
        gw.close()
        server.join(30)
        obs.configure(enable=False)
    assert rec.get("error") is None, rec
    ph = rec["phases"]
    assert ph["promote"]["outcome"] == "promoted"
    assert ph["publisher_kill"]["ok"] and ph["publisher_kill"]["orphan_tmp"]
    assert ph["publisher_kill"]["manifest_appeared"] is False
    assert (ph["canary_kill"]["outcome"], ph["canary_kill"]["reason"]) == \
        ("rolled_back", "canary_died")
    assert ph["canary_kill"]["killed_via"] == "kill"
    assert ph["canary_kill"]["respawned"] and \
        ph["canary_kill"]["restarts"] >= 1
    assert (ph["drift"]["outcome"], ph["drift"]["reason"]) == \
        ("rolled_back", "drift")
    assert rec["tmp_swept"] and rec["readyz"]["fleet_coherent"] is True
    assert rec["ok"] is True
    t = rec["traffic"]
    assert t["requests"] > 0 and t["lost"] == 0 and t["errors"] == 0, t
