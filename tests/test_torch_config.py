"""The port's config checks on the CPU: every published config loads and
validates in the port as in the JAX package; the keys the JAX package acts
on and the port does not port yet raise ``NotImplementedError`` naming the
key when a YAML or an override sets them off their JAX defaults, and pass
at those defaults."""

import glob
import os

import pytest
import yaml

from distegnn_tpu.config import load_config as jax_load_config
from distegnn_tpu_torch.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
SERVE = os.path.join(REPO, "configs", "nbody_serve.yaml")

# (dotted key, a value off the JAX default)
UNPORTED = [("train.resume", "auto"),
            ("train.resume", "logs/run/state_dict/last_model.ckpt"),
            ("train.checkpoint_interval_s", 600),
            ("train.scan_epochs", True),
            ("train.scan_epochs", False),
            ("parallel.mesh.data", 2),
            ("parallel.mesh.graph", 4),
            ("parallel.mesh.tensor", 2),
            ("log.wandb.enable", True)]


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_every_published_config_validates(path):
    cfg = load_config(path)
    jcfg = jax_load_config(path)
    for key in ("resume", "checkpoint_interval_s", "scan_epochs",
                "divergence_retries", "divergence_lr_decay"):
        assert cfg.train[key] == jcfg.train[key], key
    assert cfg.parallel.mesh == dict(jcfg.parallel.mesh)
    assert cfg.log.wandb.enable == jcfg.log.wandb.enable


# the divergence rollback is ported: any value loads and reaches cfg.train
DIVERGENCE = [("train.divergence_retries", 0),
              ("train.divergence_retries", 5),
              ("train.divergence_lr_decay", 0.25),
              ("train.divergence_lr_decay", 0.9)]


@pytest.mark.parametrize("key, value", DIVERGENCE)
def test_divergence_keys_load_and_land_in_train(key, value):
    cfg = load_config(SERVE, {key: value})
    assert cfg.train[key.split(".")[1]] == value


@pytest.mark.parametrize("key, value", UNPORTED)
def test_unported_key_off_its_default_raises(key, value):
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        load_config(SERVE, {key: value})


def test_unported_key_off_its_default_raises_from_yaml(tmp_path):
    with open(SERVE) as f:
        raw = yaml.safe_load(f)
    raw["parallel"] = {"mesh": {"data": 1, "graph": 1, "tensor": 4}}
    path = tmp_path / "tp.yaml"
    path.write_text(yaml.safe_dump(raw))
    with pytest.raises(NotImplementedError, match=r"parallel\.mesh\.tensor"):
        load_config(str(path))


def test_unported_keys_pass_at_their_jax_defaults():
    cfg = load_config(SERVE, {"train.resume": None,
                              "train.checkpoint_interval_s": 0,
                              "train.scan_epochs": "auto",
                              "train.divergence_retries": 2,
                              "train.divergence_lr_decay": 0.5,
                              "parallel.mesh.data": 1,
                              "parallel.mesh.graph": 1,
                              "parallel.mesh.tensor": 1,
                              "log.wandb.enable": False})
    assert cfg.train.divergence_retries == 2
