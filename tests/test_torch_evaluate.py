"""The port's measurement and evaluation command lines on the CPU, held
against the JAX package's scripts: ``measure_remat_memory``,
``partition_quality``, ``evaluate_rollout`` (n-body, Water-3D and
Fluid113K legs) and ``evaluate_protein_equivariance``.

Bounds:
- remat: the residual sets of JAX's and PyTorch's autodiff are different
  arrays, so what is held is what compares: the same node and edge counts
  and record keys, saved bytes with remat below those without in both, and
  the no-remat bytes growing with E by the same ratio within 5 %;
- partition quality: the JSON equal to JAX's but ``seconds``, for random,
  kmeans and metis;
- rollout MSE per horizon within 1e-5 of its scale (f32), the parameters
  carried from a JAX checkpoint; the JSON line's keys and counts equal;
- protein: the plain / test_rot / test_trans MSEs within 1e-5 relative.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import contextlib
import io
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import yaml

from distegnn_tpu_torch.config import ConfigDict
from distegnn_tpu_torch.scripts import evaluate_protein_equivariance as pprot
from distegnn_tpu_torch.scripts import evaluate_rollout as pro
from distegnn_tpu_torch.scripts import measure_remat_memory as premat
from distegnn_tpu_torch.scripts import partition_quality as ppq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)        # the JAX scripts import bench / scripts.*

import scripts.evaluate_rollout as jro  # noqa: E402


def _jax_checkpoint(model_cfg, dataset_name, path, seed=3):
    """A JAX training checkpoint of seeded parameters (what the JAX
    evaluator's init draws), read by both packages' loaders."""
    from distegnn_tpu.config import ConfigDict as JConfig
    from distegnn_tpu.models.registry import get_model
    from distegnn_tpu.train.checkpoint import save_checkpoint

    jcfg = JConfig({"model": model_cfg})
    params = jro._init_params(get_model(jcfg.model,
                                        dataset_name=dataset_name),
                              None, jcfg, seed)
    save_checkpoint(str(path), SimpleNamespace(params=params, opt_state={},
                                               step=0), epoch=0)
    return str(path)


def _close(port, jax_):
    assert sorted(port) == sorted(jax_)
    scale = max(abs(v) for v in jax_.values())
    for k in jax_:
        assert abs(port[k] - jax_[k]) <= 1e-5 * scale, (k, port[k], jax_[k])


# ---- measure_remat_memory ----------------------------------------------------------

def test_remat_saved_bytes_against_jax():
    import scripts.measure_remat_memory as jremat

    jax_rows = {n: jremat.vjp_residual_bytes(n, False) for n in (600, 1500)}
    port = {(n, remat): premat.saved_bytes(n, remat, device="cpu")
            for n in (600, 1500) for remat in (False, True)}
    for (n, remat), p in port.items():
        assert set(p) == set(jax_rows[n])
        assert (p["n_nodes"], p["n_edges"]) == (jax_rows[n]["n_nodes"],
                                                jax_rows[n]["n_edges"])
        assert p["remat"] is remat
    for n in (600, 1500):
        assert port[n, True]["residual_bytes"] < \
            port[n, False]["residual_bytes"]
    growth = (port[1500, False]["residual_bytes"]
              / port[600, False]["residual_bytes"],
              jax_rows[1500]["residual_bytes"]
              / jax_rows[600]["residual_bytes"])
    assert abs(growth[0] / growth[1] - 1.0) <= 0.05, growth


def test_remat_command_line_writes_the_jax_record(tmp_path):
    out = tmp_path / "remat.json"
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        premat.main(["--nodes", "300", "--device", "cpu", "--json",
                     str(out)])
    assert "remat residual reduction" in buf.getvalue()
    rec = json.loads(out.read_text())
    assert set(rec) == {"backend", "method", "rows"} and rec["backend"] == "cpu"
    assert [r["remat"] for r in rec["rows"]] == [False, True]
    with pytest.raises(ValueError, match="--device cuda"):
        premat.card_peak_bytes(300, True, device="cpu")


# ---- partition_quality -------------------------------------------------------------

def test_partition_quality_json_equals_jax(tmp_path, monkeypatch):
    import scripts.partition_quality as jpq

    argv = ["--n", "2000", "--parts", "8", "--methods", "random,kmeans,metis"]
    monkeypatch.setattr(sys, "argv", ["partition_quality", *argv, "--json",
                                      str(tmp_path / "j.json")])
    with contextlib.redirect_stdout(io.StringIO()):
        jpq.main()
        ppq.main(argv + ["--json", str(tmp_path / "p.json")])
    j = json.loads((tmp_path / "j.json").read_text())
    p = json.loads((tmp_path / "p.json").read_text())
    for rec in (j, p):
        for m in rec["methods"].values():
            m.pop("seconds")
    assert p == j
    assert p["methods"]["metis"]["cut_fraction"] < \
        p["methods"]["random"]["cut_fraction"]


# ---- evaluate_rollout --------------------------------------------------------------

NBODY_MODEL = {"model_name": "FastEGNN", "node_feat_nf": 2, "node_attr_nf": 0,
               "edge_attr_nf": 2, "hidden_nf": 16, "virtual_channels": 2,
               "n_layers": 2, "normalize": False}


def test_nbody_rollout_matches_jax(tmp_path):
    """JAX's own CLI case (``tests/test_rollout.py``), two horizons, with the
    parameters of one JAX checkpoint on both sides."""
    rng = np.random.default_rng(1)
    num, T, n = 2, 50, 12
    base = tmp_path / "nbody_tiny"
    base.mkdir()
    arrays = {"loc": rng.normal(size=(num, T, n, 3)),
              "vel": rng.normal(size=(num, T, n, 3)) * 0.1,
              "charges": rng.choice([-1.0, 1.0], size=(num, n, 1))}
    for name, arr in arrays.items():
        np.save(base / f"{name}_test_tiny.npy", arr.astype(np.float32))
    cfg = {"model": NBODY_MODEL,
           "data": {"data_dir": str(tmp_path), "dataset_name": "nbody_tiny",
                    "radius": -1.0, "frame_0": 20, "frame_T": 30}}
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    ckpt = _jax_checkpoint(NBODY_MODEL, "nbody_tiny", tmp_path / "j.ckpt")
    argv = ["--config_path", str(cfg_path), "--samples", "5",
            "--checkpoint", ckpt]
    outs, mse = [], []
    for mod, extra in ((jro, []), (pro, ["--device", "cpu"])):
        # the unrounded MSEs too: the JSON keeps 4 significant figures
        def recording(*a, _real=mod.evaluate_nbody_rollout, **kw):
            out = _real(*a, **kw)
            mse.append(out[0])
            return out

        buf = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(buf):
            mp.setattr(mod, "evaluate_nbody_rollout", recording)
            mod.main(argv + extra)
        outs.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    j, p = outs
    assert set(p) == set(j) and p["metric"] == "rollout_mse"
    for k in ("dataset", "split", "samples", "steps", "checkpoint"):
        assert p[k] == j[k], k
    assert p["samples"] == 2 and p["steps"] == 2
    assert sorted(p["horizons"]) == sorted(j["horizons"]) == ["30", "40"]
    _close(mse[1], mse[0])


def test_water3d_rollout_matches_jax(tmp_path):
    from distegnn_tpu.config import ConfigDict as JConfig
    from distegnn_tpu_torch.data.hdf5 import write_groups

    rng = np.random.default_rng(2)
    base = tmp_path / "Water-3D"
    base.mkdir()
    T, n, groups = 14, 20, {}
    for i in range(2):
        pos0 = rng.uniform(0, 0.4, size=(n, 3)).astype(np.float32)
        drift = rng.normal(size=(1, n, 3)).astype(np.float32) * 0.002
        groups[f"traj_{i}"] = {
            "position": pos0[None] + drift * np.arange(T)[:, None, None],
            "particle_type": np.full((n,), 5.0, np.float32)}
    write_groups(str(base / "test.h5"), groups)
    model = dict(NBODY_MODEL, hidden_nf=8, n_layers=1)
    raw = {"model": model,
           "data": {"data_dir": str(tmp_path), "dataset_name": "Water-3D",
                    "radius": 0.12, "delta_t": 4}}
    ckpt = _jax_checkpoint(model, "Water-3D", tmp_path / "w.ckpt")
    jh, js, jn = jro.evaluate_water3d_rollout(JConfig(raw), checkpoint=ckpt,
                                              samples=2, max_steps=3)
    ph, ps, pn = pro.evaluate_water3d_rollout(ConfigDict(raw),
                                              checkpoint=ckpt, samples=2,
                                              max_steps=3, device="cpu")
    assert (ps, pn) == (js, jn) == (3, 2)
    _close(ph, jh)


def _fluid_sims(root, n=60, frames=13, radius=0.25):
    from distegnn_tpu_torch.data.fluid113k import SIM_SPLITS, write_fluid_sim
    from scripts.generate_fluid_synthetic import synth_sim

    rng = np.random.default_rng(3)
    lo, _ = SIM_SPLITS["test"]
    for i in range(2):
        pos, vel = synth_sim(rng, n, frames, radius)
        write_fluid_sim(str(root), "Fluid113K", lo + i, pos, vel,
                        np.full((n,), 0.01, np.float32),
                        np.full((n,), 0.1, np.float32))
    return {"model": {"model_name": "FastEGNN", "node_feat_nf": 3,
                      "node_attr_nf": 2, "edge_attr_nf": 2, "hidden_nf": 8,
                      "virtual_channels": 2, "n_layers": 1,
                      "normalize": False},
            "data": {"data_dir": str(root), "dataset_name": "Fluid113K",
                     "radius": radius, "inner_radius": radius, "delta_t": 4}}


def test_fluid113k_rollout_matches_jax(tmp_path):
    from distegnn_tpu.config import ConfigDict as JConfig

    raw = _fluid_sims(tmp_path)
    ckpt = _jax_checkpoint(raw["model"], "Fluid113K", tmp_path / "f.ckpt")
    jh, js, jn = jro.evaluate_fluid113k_rollout(JConfig(raw), checkpoint=ckpt,
                                                samples=2, max_steps=2)
    ph, ps, pn = pro.evaluate_fluid113k_rollout(ConfigDict(raw),
                                                checkpoint=ckpt, samples=2,
                                                max_steps=2, device="cpu")
    assert (ps, pn) == (js, jn) == (2, 2)
    _close(ph, jh)


def test_fluid113k_leg_is_refused_without_zstandard(tmp_path, monkeypatch):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "zstandard"
                        else real(name, *a))
    with pytest.raises(RuntimeError, match="'zstandard'"):
        pro.evaluate_fluid113k_rollout(ConfigDict(_fluid_sims(tmp_path)),
                                       device="cpu")


def test_evaluate_rollout_refuses_a_missing_card(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pro.main(["--config_path", os.path.join(REPO, "configs",
                                                 "nbody_fastegnn.yaml")])


# ---- evaluate_protein_equivariance -------------------------------------------------

def test_protein_equivariance_matches_jax(tmp_path):
    import jax

    import scripts.evaluate_protein_equivariance as jprot
    from distegnn_tpu.config import load_config as jload
    from distegnn_tpu.models.registry import get_model
    from distegnn_tpu.train import make_eval_step
    from distegnn_tpu.train.checkpoint import save_checkpoint
    from test_torch_fast_egnn import numpy_params
    from test_torch_protein import write_npz

    with open(os.path.join(REPO, "configs", "protein_cpu_slice.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["data"].update(data_dir=write_npz(tmp_path / "data"), max_samples=10)
    raw["model"].update(hidden_nf=16, n_layers=2)
    cfg_path = tmp_path / "protein.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))

    jcfg = jload(str(cfg_path))
    jm = get_model(jcfg.model, dataset_name="protein")
    batch = next(iter(jprot.GraphLoader(
        jprot.GraphDataset(jprot.process_protein_cutoff(
            jcfg.data.data_dir, "protein", 10, jcfg.data.radius,
            jcfg.data.delta_t, jcfg.data.cutoff_rate, backbone=True,
            seed=jcfg.seed)[2]), jcfg.data.batch_size)))
    params = numpy_params(jm, batch, seed=5)
    ckpt = str(tmp_path / "p.ckpt")
    save_checkpoint(ckpt, SimpleNamespace(params=params, opt_state={},
                                          step=0), epoch=0)
    jstep = jax.jit(make_eval_step(jm))
    want = {v: jprot.test_mse(jcfg, jm, params, jstep, v)
            for v in ("plain", "rot", "trans")}
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        got = pprot.main(["--config_path", str(cfg_path), "--checkpoint",
                          ckpt, "--device", "cpu", "--json",
                          str(tmp_path / "out.json")])
    assert "test MSE (rot)" in buf.getvalue()
    for v in ("plain", "rot", "trans"):
        assert abs(got[f"test_mse_{v}"] - want[v]) <= 1e-5 * want[v], v
    rec = json.loads((tmp_path / "out.json").read_text())
    assert set(rec) == {"checkpoint", "test_mse_plain", "test_mse_rot",
                        "test_mse_trans", "max_abs_deviation"}
