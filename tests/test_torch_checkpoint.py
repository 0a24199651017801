"""Serving a checkpoint, on the CPU: the port's trainer writes a checkpoint
(a verified payload of epoch, model, optimizer, ...) that the port's
serving entry point loads, as the JAX package's does through
``restore_params`` (distegnn_tpu/train/checkpoint.py); a bare ``state_dict``
of ``convert.params_from_jax`` still loads; a damaged file raises
``CheckpointCorruptError`` and a checkpoint of another width raises with the
config hint of the JAX function, the model untouched either way.

Tolerance: 0. The served model is the trained one, so the predictions are
bitwise equal.
"""

import os

import jax
import numpy as np
import pytest
import torch

from distegnn_tpu.config import load_config as jax_load_config
from distegnn_tpu.models.registry import get_model as jax_get_model
from distegnn_tpu.serve import engine_from_config as jax_engine_from_config
from distegnn_tpu_torch import main as pmain
from distegnn_tpu_torch.config import load_config
from distegnn_tpu_torch.convert import params_from_jax
from distegnn_tpu_torch.data.loader import GraphDataset
from distegnn_tpu_torch.models.registry import get_model
from distegnn_tpu_torch.serve import (engine_from_config,
                                      engine_with_params_from_config,
                                      synthetic_graph)
from distegnn_tpu_torch.train.checkpoint import (CheckpointCorruptError,
                                                 restore_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "nbody_serve.yaml")
SMALL = {"model.hidden_nf": 16, "model.n_layers": 2}


def _graphs(seeds, n=24):
    return [synthetic_graph(n, radius=0.45, seed=s) for s in seeds]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """configs/nbody_serve.yaml (hidden 16, 2 layers) trained for two
    epochs on eight 24-node scenes (4 train, 2 valid, 2 test); returns
    (config, final model, the run's checkpoint directory)."""
    log_dir = tmp_path_factory.mktemp("ckpt_run")
    cfg = load_config(CONFIG, {**SMALL, "train.epochs": 2,
                               "log.test_interval": 1, "data.batch_size": 2,
                               "log.log_dir": str(log_dir)})
    ds = [GraphDataset(_graphs(range(k, k + n))) for k, n in
          ((0, 4), (10, 2), (20, 2))]
    state, _, _ = pmain.run(cfg, *ds, device="cpu")
    ckpt_dir = os.path.join(str(log_dir), cfg.log.exp_name, "state_dict")
    return cfg, state.model, ckpt_dir


def _predict(model, cfg, graphs):
    eng = engine_from_config(cfg, model.eval(), "cpu")
    return eng.predict_batch(graphs)


def test_serving_a_trainer_checkpoint_answers_with_the_trained_model(
        trained):
    cfg, model, ckpt_dir = trained
    graphs = _graphs((100, 101))
    want = _predict(model, cfg, graphs)
    served, eng = engine_with_params_from_config(
        cfg, device="cpu", checkpoint=os.path.join(ckpt_dir,
                                                   "last_model.ckpt"))
    for k, v in model.state_dict().items():
        assert torch.equal(served.state_dict()[k], v), k
    for a, b in zip(eng.predict_batch(graphs), want):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)
    # the best epoch's checkpoint serves too (and differs from the seeded
    # initial parameters)
    best, _ = engine_with_params_from_config(
        cfg, device="cpu", checkpoint=os.path.join(ckpt_dir,
                                                   "best_model.ckpt"))
    init = get_model(cfg.model, generator=torch.Generator().manual_seed(
        int(cfg.seed)))
    assert any(not torch.equal(best.state_dict()[k], v)
               for k, v in init.state_dict().items())


def test_serving_a_damaged_trainer_checkpoint_raises(trained, tmp_path):
    cfg, _, ckpt_dir = trained
    import shutil

    bad_dir = tmp_path / "state_dict"
    shutil.copytree(ckpt_dir, bad_dir)
    path = str(bad_dir / "last_model.ckpt")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(CheckpointCorruptError, match="last_model.ckpt"):
        engine_with_params_from_config(cfg, device="cpu", checkpoint=path)
    model = get_model(cfg.model, generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(CheckpointCorruptError):
        restore_params(path, model)
    for k, v in model.state_dict().items():
        assert torch.equal(before[k], v), k


def test_restore_params_refuses_another_width_untouched(trained):
    cfg, _, ckpt_dir = trained
    wide = load_config(CONFIG, {**SMALL, "model.hidden_nf": 32})
    model = get_model(wide.model, generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="written with model config"):
        restore_params(os.path.join(ckpt_dir, "last_model.ckpt"), model)
    for k, v in model.state_dict().items():
        assert torch.equal(before[k], v), k


def test_a_bare_state_dict_of_jax_params_still_serves(tmp_path):
    """convert.params_from_jax of the JAX engine's parameters, saved with
    torch.save, serves what the JAX engine predicts (the serving parity
    bound of tests/test_torch_serve.py, 1e-5)."""
    jcfg = jax_load_config(CONFIG)
    jcfg.model.hidden_nf, jcfg.model.n_layers = 16, 2
    jmodel = jax_get_model(jcfg.model, dataset_name=jcfg.data.dataset_name)
    jeng, _ = jax_engine_from_config(jcfg, jmodel, params=None)
    g = _graphs((7,), n=30)
    b0 = jeng.ladder.bucket_of_graph(g[0])
    batch, _ = jeng.ladder.pad_batch(g, b0, 1)
    params = jmodel.init(jax.random.PRNGKey(3), batch)
    jeng.params = params
    want = jeng.predict_batch(g)[0]
    path = str(tmp_path / "params.pt")
    torch.save(params_from_jax(params), path)
    _, eng = engine_with_params_from_config(load_config(CONFIG, SMALL),
                                            device="cpu", checkpoint=path)
    np.testing.assert_allclose(eng.predict_batch(g)[0], np.asarray(want),
                               rtol=0, atol=1e-5)
