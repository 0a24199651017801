"""The port's open-loop load tools (``distegnn_tpu_torch/scripts/
serve_bench.py`` and ``traffic_gen.py``) on the CPU, held against the JAX
package's ``scripts/serve_bench.py`` and ``scripts/traffic_gen.py``.

Both packages run the same arguments on the ``nbody_serve`` config at the
narrow width (H=16, L=2, ``max_batch`` 2, the queued deadline raised for
the CPU). Bounds: the replay plan bit for bit under one seed (arrival
offsets, classes, models, paths, request ids, phases and every request
body, hence the sizes and the session ids); the parsers' results and
refusals equal; the scoring functions equal on the same results; the BENCH
records with the same keys (the ServeMetrics snapshot's too) and the same
counts (requests, completed, classes, phases). Latencies are not compared.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import argparse
import contextlib
import io
import json
import os
import threading

import pytest
import yaml

import scripts.serve_bench as jsb
import scripts.traffic_gen as jtg
from distegnn_tpu_torch.scripts import serve_bench as psb
from distegnn_tpu_torch.scripts import traffic_gen as ptg

pytestmark = pytest.mark.serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    with open(os.path.join(REPO, "configs", "nbody_serve.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"].update(hidden_nf=16, n_layers=2)
    raw["serve"].update(request_timeout_ms=30000.0, max_batch=2)
    path = tmp_path_factory.mktemp("tools") / "narrow.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _run(main, argv):
    """(rc, the JSON record of the one stdout line, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1, out.getvalue()
    return rc, json.loads(lines[0]), err.getvalue()


# ---- serve_bench ----------------------------------------------------------------------

def test_serve_bench_predict_record_matches_jax(narrow):
    argv = ["--config_path", narrow, "--requests", "12", "--rate", "500",
            "--sizes", "24,48", "--seed", "7", "--obs-dir", ""]
    jrc, j, _ = _run(jsb.main, argv)
    prc, p, _ = _run(psb.main, argv + ["--device", "cpu"])
    assert jrc == prc == 0
    assert set(p) == set(j)
    assert set(p["snapshot"]) == set(j["snapshot"])
    assert p["platform"] == "cpu" and p["transport"] == "inproc"
    for k in ("metric", "unit", "requests", "rejected_at_submit", "sizes",
              "offered_rate", "vs_baseline"):
        assert p[k] == j[k], k
    assert (p["snapshot"]["requests_completed"]
            == j["snapshot"]["requests_completed"] == 12)
    assert p["value"] > 0


def test_serve_bench_http_transport_one_json_line(narrow):
    rc, rec, _ = _run(psb.main, [
        "--config_path", narrow, "--requests", "8", "--rate", "500",
        "--sizes", "24", "--seed", "11", "--transport", "http",
        "--obs-dir", "", "--device", "cpu"])
    assert rc == 0
    assert rec["metric"] == "serve_throughput" and rec["transport"] == "http"
    assert rec["value"] > 0 and rec["rejected_at_submit"] == 0
    assert rec["snapshot"]["requests_completed"] == 8


def test_serve_bench_rollout_record_matches_jax(narrow):
    argv = ["--config_path", narrow, "--workload", "rollout",
            "--rollout-scenes", "2", "--rollout-steps", "2", "--sizes", "24",
            "--max-batch", "2", "--rate", "500", "--obs-dir", "",
            "--seed", "7"]
    jrc, j, _ = _run(jsb.main, argv)
    prc, p, _ = _run(psb.main, argv + ["--device", "cpu"])
    assert jrc == prc == 0
    assert set(p) == set(j) and set(p["snapshot"]) == set(j["snapshot"])
    for k in ("metric", "unit", "scenes", "scenes_completed", "steps",
              "max_batch", "rejected_at_submit", "sizes"):
        assert p[k] == j[k], k
    assert p["scenes_completed"] == 2
    assert p["snapshot"]["requests_completed"] == 2
    assert p["value"] > 0 and p["baseline_b1"] > 0 and p["baseline_solo"] > 0


def test_serve_bench_refuses_a_missing_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        psb.main(["--requests", "1"])


# ---- traffic_gen: the plan ------------------------------------------------------------

def _plan_args(**kw):
    a = dict(seed=47, mix="predict=0.6,session=0.3,rollout=0.1",
             size_list=[24, 48, 96, 192], tail=1.5, sessions=4, requests=40,
             rollout_steps=4, profile=None, rate=100.0, burst_on_s=0.5,
             burst_off_s=0.2)
    a.update(kw)
    return argparse.Namespace(**a)


@pytest.mark.parametrize("kw", [
    {},
    {"profile": "spike10x", "requests": 96, "rate": 10.0},
    {"profile": "ramp", "seed": 3, "tail": 0.5},
    {"burst_off_s": 0.0, "mix": "predict=1", "sessions": 1},
])
def test_replay_plan_is_jax_bit_for_bit(kw):
    args = _plan_args(**kw)
    models, rollout_models = ["fused", "rollout"], ["rollout"]
    jplan, joff = jtg.build_plan(args, models, rollout_models, 1, 2)
    pplan, poff = ptg.build_plan(args, models, rollout_models, 1, 2)
    assert poff == joff
    assert pplan == jplan      # classes, models, paths, rids, phases, bodies


def test_rollout_share_folds_into_predict_without_a_rollout_model():
    args = _plan_args(requests=20)
    with contextlib.redirect_stderr(io.StringIO()):
        jplan, _ = jtg.build_plan(args, ["m"], [], 1, 2)
        pplan, _ = ptg.build_plan(args, ["m"], [], 1, 2)
    assert pplan == jplan
    assert {it["cls"] for it in pplan} <= {"predict", "session"}


def test_arrival_processes_match_jax():
    import random

    for args in ((50, 20.0, 0.5, 0.2), (50, 20.0, 0.5, 0.0)):
        assert (ptg.arrival_times(*args, random.Random(5))
                == jtg.arrival_times(*args, random.Random(5)))
    for prof in ptg.PROFILES:
        assert (ptg.profile_arrivals(prof, 31, 7.0, random.Random(9))
                == jtg.profile_arrivals(prof, 31, 7.0, random.Random(9)))
    assert ptg.PROFILES == jtg.PROFILES and ptg.CLASSES == jtg.CLASSES


@pytest.mark.parametrize("spec", [
    "predict=0.6,session=0.3,rollout=0.1", "predict=2", " session=1, ",
    "bogus=1", "predict=x", "predict=-1", "predict=0"])
def test_parse_mix_matches_jax(spec):
    _same_outcome(jtg.parse_mix, ptg.parse_mix, spec)


@pytest.mark.parametrize("spec", [
    "kill@0.3:replica=0;swap@1.0:ckpt=/p/b.ckpt",
    "latency@0.5:s=0.1;wedge@0.2:dur=2,replica=1", "kill9@1;sigstop@2",
    "nuke@1", "kill", "swap@1", "kill@1:replica"])
def test_parse_chaos_matches_jax(spec):
    _same_outcome(jtg.parse_chaos, ptg.parse_chaos, spec)


@pytest.mark.parametrize("spec", [
    "on", "max_replicas=3,queue_high=2", "enable=false,min_replicas=1",
    "bogus=1", "max_replicas"])
def test_parse_scale_matches_jax(spec):
    _same_outcome(jtg.parse_scale, ptg.parse_scale, spec)


def _same_outcome(jfn, pfn, arg):
    try:
        want = ("ok", jfn(arg))
    except ValueError as e:
        want = ("error", str(e))
    try:
        got = ("ok", pfn(arg))
    except ValueError as e:
        got = ("error", str(e))
    assert got == want


def test_scoring_matches_jax():
    from distegnn_tpu.obs import slo as jslo
    from distegnn_tpu_torch.obs import slo as pslo

    results = []
    for k in range(60):
        cls = ("predict", "session", "rollout")[k % 3]
        status = 429 if k % 11 == 0 else 504 if k % 17 == 0 else 200
        results.append({"cls": cls, "phase": ("pre", "spike", "post")[k // 20],
                        "status": status, "ms": 3.0 + 1.7 * ((k * 7) % 23),
                        "rid": f"r{k}", "retries": k % 2})
    assert ptg.class_stats(results) == jtg.class_stats(results)
    prom = "gateway_batch_fill 0.5\n"
    assert ptg.slo_stats(results, prom) == jtg.slo_stats(results, prom)
    spec = {"routes": {"predict": {"p99_ms": 40.0}}, "error_rate_max": 0.1}
    assert (ptg.phase_stats(results, pslo.SLOSpec.from_mapping(spec))
            == jtg.phase_stats(results, jslo.SLOSpec.from_mapping(spec)))
    assert ptg.phase_stats(results) == jtg.phase_stats(results)


# ---- traffic_gen: end to end ----------------------------------------------------------

def test_traffic_gen_inproc_record_matches_jax(narrow, tmp_path):
    spec = tmp_path / "slo.yaml"
    spec.write_text("slo:\n  routes:\n    predict:\n      p99_ms: 60000\n"
                    "  error_rate_max: 0.0\n")
    argv = ["--config_path", narrow, "--requests", "14", "--rate", "60",
            "--mix", "predict=0.6,session=0.4", "--sizes", "24,48",
            "--sessions", "2", "--seed", "31", "--slo", str(spec)]
    jrc, j, _ = _run(jtg.main, argv + ["--obs-dir", ""])
    prc, p, err = _run(ptg.main, argv + ["--obs-dir", str(tmp_path / "tg"),
                                         "--device", "cpu"])
    assert jrc == prc == 0
    assert set(p) == set(j)
    assert set(p["slo"]) == set(j["slo"])
    assert p["completed"] == j["completed"] == 14
    assert {c: v["count"] for c, v in p["classes"].items()} == \
        {c: v["count"] for c, v in j["classes"].items()}
    for k in ("requests", "shed", "errors", "lost", "mix", "sizes", "models",
              "offered_rate"):
        assert p[k] == j[k], k
    assert p["slo"]["pass"] is True and p["slo"]["rules"] == 2
    assert "overall: PASS" in err
    # every request's id reached the event stream
    from distegnn_tpu_torch.obs.report import load_events

    events, _ = load_events(str(tmp_path / "tg" / "obs" / "events.jsonl"))
    assert any(e.get("name") == "bench/result" for e in events)
    rids = {e.get("request_id") for e in events}
    assert {f"tg-31-{k}" for k in range(14)} <= rids


def test_traffic_gen_url_spike_phases(narrow):
    """``--url`` against a running port gateway (booted here in process) with
    the spike10x profile: the per-phase counts are the plan's, the same plan
    as JAX's under the seed."""
    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.serve.registry import ModelRegistry
    from distegnn_tpu_torch.serve.transport import Gateway

    reg = ModelRegistry.from_config(load_config(narrow), device="cpu").start()
    reg.warmup([24, 48])
    gw = Gateway(reg, port=0)
    server = threading.Thread(target=gw.serve_forever, daemon=True)
    server.start()
    try:
        argv = ["--url", gw.url(""), "--config_path", narrow, "--profile",
                "spike10x", "--requests", "24", "--rate", "40", "--mix",
                "predict=0.7,session=0.3", "--sizes", "24,48", "--sessions",
                "2", "--seed", "5", "--obs-dir", ""]
        rc, rec, _ = _run(ptg.main, argv)
    finally:
        gw.drain()
        gw.close()
        server.join(30)
    assert rc == 0 and rec["completed"] == 24 and rec["models"] == ["default"]
    args = _plan_args(seed=5, mix="predict=0.7,session=0.3", size_list=[24, 48],
                      sessions=2, requests=24, profile="spike10x", rate=40.0)
    jplan, _ = jtg.build_plan(args, ["default"], [], 1, 2)
    want = {}
    for it in jplan:
        want[it["phase"]] = want.get(it["phase"], 0) + 1
    assert {ph: v["count"] for ph, v in rec["phases"].items()} == want
    assert all("slo_pass" in v and "interactive_p99_ms" in v
               for v in rec["phases"].values())


def test_traffic_gen_refusals_match_jax():
    for argv in (["--url", "http://x", "--chaos", "kill@1"],
                 ["--url", "http://x", "--promote"],
                 ["--url", "http://x", "--autoscale", "on"],
                 ["--autoscale", "bogus=1"], ["--chaos", "nuke@1"],
                 ["--sizes", ","]):
        jerr, perr = io.StringIO(), io.StringIO()
        with contextlib.redirect_stderr(jerr):
            jrc = jtg.main(argv)
        with contextlib.redirect_stderr(perr):
            prc = ptg.main(argv)
        assert jrc == prc == 2, argv
        assert perr.getvalue() == jerr.getvalue(), argv


def test_rollout_default_stays_off_a_served_model_list(narrow, tmp_path):
    """With a rollout share and a ``serve.models`` list, the in-process
    gateway leaves the models' own ``serve.rollout`` in charge: a fused
    model, which cannot roll out, gets no rollout route. (JAX's
    ``boot_gateway`` sets the default on the base config, which every
    listed model inherits.)"""
    with open(narrow) as f:
        raw = yaml.safe_load(f)
    raw["serve"]["models"] = [
        {"name": "fused", "overrides": {"model": {"edge_impl": "fused"},
                                        "data": {"edge_block": 512}}},
        {"name": "rollout", "overrides": {"serve": {"rollout": {
            "radius": 0.3, "max_degree": 32, "max_per_cell": 32,
            "edge_block": 256}}}}]
    path = tmp_path / "two.yaml"
    path.write_text(yaml.safe_dump(raw))
    from distegnn_tpu_torch.config import load_config

    args = argparse.Namespace(mix="predict=0.6,session=0.3,rollout=0.1",
                              max_batch=None, replicas=None, workers=None,
                              size_list=[24], requests=4, autoscale=None)
    gw, server, reg = ptg.boot_gateway(args, load_config(str(path)), "cpu")
    try:
        assert [n for n, e in reg.items() if e.rollout_enabled] == ["rollout"]
    finally:
        gw.drain()
        gw.close()
        server.join(30)


def test_traffic_gen_chaos_kill_and_latency_through_the_replay(narrow):
    """``--chaos`` reaches ``testing/serve_faults.py`` in the live registry:
    a replica killed mid-replay and a latency injection are both recorded
    as fired, and the second replica and the supervisor keep every request
    answered (JAX's chaos leg, ``tests/test_tracing.py``)."""
    rc, rec, _ = _run(ptg.main, [
        "--config_path", narrow, "--chaos", "latency@0.1:s=0.01;"
        "kill@0.3:replica=0", "--replicas", "2", "--requests", "16",
        "--rate", "20", "--mix", "predict=0.7,session=0.3", "--sizes",
        "24,48", "--obs-dir", "", "--device", "cpu"])
    assert rc == 0
    assert [(c["action"], c["ok"]) for c in rec["chaos"]] == \
        [("latency", True), ("kill", True)]
    assert rec["completed"] == 16 and rec["lost"] == 0 and rec["errors"] == 0
