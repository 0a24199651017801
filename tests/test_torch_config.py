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
UNPORTED = [("train.scan_epochs", True),
            ("train.scan_epochs", False),
            ("parallel.mesh.data", 2),
            ("data.data_parallel", 2),
            ("parallel.mesh.tensor", 2),
            ("log.wandb.enable", True),
            ("serve.tiled.enable", True),
            ("promote.publish", True)]


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


def _yaml_with(tmp_path, key, value):
    """configs/nbody_serve.yaml with ``key`` set (the JAX package takes
    overrides of its command-line flags only)."""
    with open(SERVE) as f:
        raw = yaml.safe_load(f)
    section, name = key.split(".")
    raw.setdefault(section, {})[name] = value
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


# the durability, trace and obs keys are ported: (key, value, whether the
# JAX package's checks refuse it); every case is loaded by both packages
PORTED = [("train.resume", "auto", False),
          ("train.resume", "logs/run/state_dict/last_model.ckpt", False),
          ("train.resume", 3, True),
          ("train.checkpoint_interval_s", 600, False),
          ("train.checkpoint_interval_s", -1, True),
          ("train.keep_checkpoints", 1, False),
          ("train.keep_checkpoints", 0, True),
          ("log.trace_epoch", 2, False),
          ("log.trace_epoch", -1, True),
          ("log.check_consistency", False, False),
          ("log.check_consistency", "yes", True),
          ("obs.enable", False, False),
          ("obs.per_host", 1, True),
          ("obs.buffer_events", 0, True),
          ("obs.flush_interval_s", -0.5, True)]


@pytest.mark.parametrize("key, value, refused", PORTED)
def test_ported_keys_load_and_are_checked_as_in_jax(tmp_path, key, value,
                                                    refused):
    path = _yaml_with(tmp_path, key, value)
    section, name = key.split(".")
    if refused:
        with pytest.raises(ValueError, match=name):
            jax_load_config(path)
        with pytest.raises(ValueError, match=name):
            load_config(path)
        return
    assert load_config(path)[section][name] == value
    assert jax_load_config(path)[section][name] == value
    assert load_config(SERVE, {key: value})[section][name] == value


def test_ported_defaults_are_the_jax_defaults():
    cfg, jcfg = load_config(SERVE), jax_load_config(SERVE)
    assert cfg.train.keep_checkpoints == jcfg.train.keep_checkpoints == 3
    for key in ("trace_epoch", "check_consistency"):
        assert cfg.log[key] == jcfg.log[key], key
    assert dict(cfg.obs) == dict(jcfg.obs)


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


DISTRIBUTE = ["largefluid_distegnn.yaml", "simulation_distegnn.yaml",
              "fluid_synth_ell.yaml"]


@pytest.mark.parametrize("name", DISTRIBUTE)
def test_published_distribute_configs_derive_the_world_size(name,
                                                            monkeypatch):
    """The graph-partition configs as published: the port reads their
    distribute keys as the JAX package does, and derives the world size
    from data.world_size, parallel.mesh.graph or the card count, naming it
    in exp_name as JAX's derive_runtime_fields does."""
    import torch

    from distegnn_tpu.config import derive_runtime_fields as jax_derive
    from distegnn_tpu_torch.config import derive_runtime_fields

    path = os.path.join(REPO, "configs", name)
    cfg, jcfg = load_config(path), jax_load_config(path)
    for key in ("accelerate_mode", "split_mode", "outer_radius",
                "inner_radius", "delta_t", "data_parallel",
                "prefetch_depth"):
        assert cfg.data[key] == jcfg.data[key], key
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    for over, ws in (({}, 3), ({"parallel.mesh.graph": 4}, 4),
                     ({"data.world_size": 2}, 2)):
        c = load_config(path, over)
        derive_runtime_fields(c)
        assert c.data.world_size == ws
        j = jax_derive(jax_load_config(path), world_size=ws)
        assert c.log.exp_name[:-15] == j.log.exp_name[:-15]
        assert f"_ws{ws}_C" in c.log.exp_name


def test_graph_axis_is_accepted_and_must_agree_with_world_size():
    assert load_config(SERVE, {"parallel.mesh.graph": 4}).parallel.mesh \
        .graph == 4
    with pytest.raises(ValueError, match="conflicts with data.world_size"):
        load_config(SERVE, {"parallel.mesh.graph": 4,
                            "data.world_size": 2})
