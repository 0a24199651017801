"""The port's serving entry points on the CPU: the engine built from
configs/nbody_serve.yaml (+ model.edge_impl=fused, data.edge_block=512)
predicts what the JAX package's engine predicts with the same parameters,
batching does not change a graph's answer, ``serve.cache_size`` bounds the
engine's shape LRU, the package never imports JAX, and the entry points
(the engine factory and ``python -m distegnn_tpu_torch.serve.gateway``)
refuse to fall back to the CPU silently.

Tolerance: 1e-5 absolute on predicted coordinates (unit-cube scenes), the
model parity bound of tests/test_torch_fast_egnn.py.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distegnn_tpu.config import load_config as jax_load_config
from distegnn_tpu.models.registry import get_model as jax_get_model
from distegnn_tpu.serve import engine_from_config as jax_engine_from_config
from distegnn_tpu_torch import config as pconfig
from distegnn_tpu_torch.convert import params_from_jax
from distegnn_tpu_torch.ops.order import morton_perm, reorder_graph
from distegnn_tpu_torch.ops.radius import radius_graph_np
from distegnn_tpu_torch.serve import engine_with_params_from_config
from distegnn_tpu_torch.serve.buckets import Bucket
from test_torch_fast_egnn import numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "nbody_serve.yaml")
FUSED = {"model.edge_impl": "fused", "data.edge_block": 512}
ATOL = 1e-5


def scene(n, seed, radius=0.15):
    """A Morton-ordered radius-graph scene in pad_graphs dict form."""
    rng = np.random.default_rng(seed)
    loc = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 0.05).astype(np.float32)
    ei = radius_graph_np(loc, radius)
    d = np.linalg.norm(loc[ei[0]] - loc[ei[1]], axis=1)[:, None]
    g = {"node_feat": np.linalg.norm(vel, axis=1, keepdims=True),
         "loc": loc, "vel": vel,
         "edge_index": ei.astype(np.int32),
         "edge_attr": np.repeat(d, 2, axis=1).astype(np.float32)}
    return reorder_graph(g, morton_perm(loc))


def test_config_loads_with_fused_overrides():
    cfg = pconfig.load_config(CONFIG, FUSED)
    assert cfg.model.edge_impl == "fused" and cfg.data.edge_block == 512
    assert (cfg.model.hidden_nf, cfg.model.n_layers,
            cfg.model.virtual_channels, cfg.serve.max_batch) == (64, 4, 3, 4)
    with pytest.raises(ValueError, match="edge_block"):
        pconfig.load_config(CONFIG, {"model.edge_impl": "fused"})
    with pytest.raises(KeyError):
        pconfig.load_config(CONFIG, {"no_such_field": 1})


def test_engine_matches_jax_engine():
    jcfg = jax_load_config(CONFIG)
    jcfg.model.edge_impl, jcfg.data.edge_block = "fused", 512
    jmodel = jax_get_model(jcfg.model, dataset_name=jcfg.data.dataset_name)
    graphs = [scene(700, 1), scene(1100, 2)]
    jeng, _ = jax_engine_from_config(jcfg, jmodel, params=None)
    batch, _ = jeng.ladder.pad_batch(graphs[:1], jeng.ladder.bucket_of_graph(
        graphs[0]), 1, **jeng._layout_opts)
    params = numpy_params(jmodel, batch, seed=5)
    jeng.params = params
    want = jeng.predict_batch(graphs)

    cfg = pconfig.load_config(CONFIG, FUSED)
    model, eng = engine_with_params_from_config(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    got = eng.predict_batch(graphs)
    assert len(got) == len(want) == 2
    for g, a, b in zip(graphs, want, got):
        assert b.shape == (g["loc"].shape[0], 3)
        np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)


def test_batch_of_two_equals_each_graph_alone():
    cfg = pconfig.load_config(CONFIG, FUSED)
    cfg.model.hidden_nf, cfg.model.n_layers = 16, 2
    _, eng = engine_with_params_from_config(cfg, device="cpu")
    graphs = [scene(600, 3), scene(900, 4)]
    pair = eng.predict_batch(graphs)
    bucket = Bucket(*map(max, zip(*[eng.ladder.bucket_of_graph(g)
                                    for g in graphs])))
    for g, out in zip(graphs, pair):
        alone = eng.predict_batch([g], bucket=bucket)[0]
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, alone, rtol=0, atol=ATOL)
    # the pair pads like the denser graph alone (edges_per_block follows
    # the batch's densest block); the sparser graph alone adds one shape,
    # and the warmup probe one more
    assert len(eng.shapes_seen) == 2
    eng.warmup([(48, 256)])
    assert len(eng.shapes_seen) == 3


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pconfig.load_config(CONFIG, FUSED)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine_with_params_from_config(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine_with_params_from_config(cfg, device="cuda")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, importlib, sys\n"
        "import distegnn_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'distegnn_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', "
        "'distegnn_tpu') or m.startswith(('jax.', 'jaxlib', 'flax.', "
        "'distegnn_tpu.')))\n"
        "assert len(mods) >= 15, mods\n"
        "need = {'distegnn_tpu_torch.' + m for m in ('main', 'train.loss', "
        "'train.step', 'train.checkpoint', 'train.trainer', 'data.loader', "
        "'data.nbody', 'data.fluid113k', 'utils.seed', 'ops.cumsum', "
        "'ops.segment', 'ops.blocked', 'ops.layer_pipeline', "
        "'ops.radius_dev', 'rollout', 'serve.engine', 'data.water3d', "
        "'data.protein', 'data.stream', 'data.nbody_sim', 'utils.rotate', "
        "'serve.queue', 'serve.replica', 'serve.supervisor', "
        "'serve.registry', 'serve.autoscale', 'serve.metrics', "
        "'serve.prep', 'serve.transport', 'serve.gateway', 'obs.slo', "
        "'models.fast_rf', 'models.fast_schnet', 'models.fast_tfn', "
        "'models.schnet', 'models.basic', 'models.eghn', 'models.se3', "
        "'models.se3.so3', 'models.se3.fibers', 'models.se3.basis', "
        "'models.se3.tfn', 'models.se3.attention', "
        "'models.se3.dynamics', 'data.bgeo', 'data.fluid_scenes', "
        "'testing.faults', 'testing.tiny_run', 'scripts.serve_bench', "
        "'scripts.traffic_gen', 'scripts.check_no_print', "
        "'scripts.check_route_spans', 'scripts.check_config_keys', "
        "'scripts.measure_remat_memory', 'scripts.partition_quality', "
        "'scripts.evaluate_rollout', "
        "'scripts.evaluate_protein_equivariance')}\n"
        "assert need <= set(mods), sorted(need - set(mods))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_cache_size_bounds_the_shape_lru():
    cfg = pconfig.load_config(CONFIG, {"model.hidden_nf": 16,
                                       "model.n_layers": 2})
    _, eng = engine_with_params_from_config(cfg, device="cpu")
    assert eng.cache_size == cfg.serve.cache_size == 16
    eng.cache_size = 2
    for n in (60, 130, 300, 60):
        eng.predict(scene(n, n, radius=0.3))
        assert len(eng.shapes_seen) <= 2
    assert eng.cache_stats() == {"live": 2, "hits": 0, "misses": 4,
                                 "evictions": 2}


def test_gateway_entry_point_refuses_cpu_fallback_and_drains(tmp_path):
    """``python -m distegnn_tpu_torch.serve.gateway`` without a card and
    without ``--device cpu`` raises; with ``--device cpu`` it prints the
    listening line, answers /readyz and a predict, and on SIGTERM drains
    and exits 0."""
    import http.client
    import json
    import signal

    from distegnn_tpu_torch.serve import gateway

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gateway.main(["--config_path", CONFIG, "--port", "0",
                          "--obs-dir", ""])
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "distegnn_tpu_torch.serve.gateway",
         "--config_path", CONFIG, "--port", "0", "--device", "cpu",
         "--obs-dir", str(tmp_path), "--warmup-nodes", "48"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        port = None
        for line in proc.stdout:
            if "listening on http://" in line:
                port = int(line.split("http://")[1].split()[0]
                           .rsplit(":", 1)[1])
                break
        assert port is not None, proc.stderr.read()
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("GET", "/readyz")
        r = c.getresponse()
        assert r.status == 200 and json.loads(r.read())["ready"]
        g = scene(50, 5, radius=0.3)
        c.request("POST", "/v1/models/default/predict", json.dumps(
            {"positions": g["loc"].tolist(),
             "edge_index": g["edge_index"].tolist()}))
        r = c.getresponse()
        body = json.loads(r.read())
        assert r.status == 200 and np.isfinite(body["prediction"]).all()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        events = (tmp_path / "obs" / "events.jsonl").read_text()
        assert "gateway/drain_done" in events and "jax/memory" in events
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
