"""The port's config checks on the CPU: every published config loads and
validates in the port as in the JAX package; the keys the JAX package acts
on and the port does not port yet raise ``NotImplementedError`` naming the
key when a YAML or an override sets them off their JAX defaults, and pass
at those defaults. The mesh keys (``parallel.mesh.{data,graph,tensor}``,
``data.data_parallel``, the ``--data_parallel`` / ``--tensor_parallel``
flags) are checked as JAX checks them, and a checkpoint crosses meshes as
in JAX (the tensor degree must divide the saved hidden width)."""

import glob
import os

import pytest
import yaml

from distegnn_tpu.config import load_config as jax_load_config
from distegnn_tpu_torch.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
SERVE = os.path.join(REPO, "configs", "nbody_serve.yaml")

# the data keys of the protein pipeline and the shard directories
DATA_KEYS = ("backbone", "test_rot", "test_trans", "stream_shard_cache")

# (dotted key, a value off the JAX default)
UNPORTED = [("train.scan_epochs", True),
            ("log.wandb.enable", True),
            ("serve.donate", True)]


# published configs that set a key the port refuses: (file, the key)
REFUSED = {}


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_every_published_config_validates(path):
    jcfg = jax_load_config(path)
    key = REFUSED.get(os.path.basename(path))
    if key is not None:
        with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
            load_config(path)
        return
    cfg = load_config(path)
    for key in ("resume", "checkpoint_interval_s", "scan_epochs",
                "divergence_retries", "divergence_lr_decay"):
        assert cfg.train[key] == jcfg.train[key], key
    assert cfg.parallel.mesh == dict(jcfg.parallel.mesh)
    assert cfg.log.wandb.enable == jcfg.log.wandb.enable
    for key in DATA_KEYS:
        assert cfg.data[key] == jcfg.data[key], key


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
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")) \
            as err:
        load_config(SERVE, {key: value})
    assert "ROADMAP.md" in str(err.value)


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
PORTED = [("train.scan_epochs", False, False),
          ("train.resume", "auto", False),
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
          ("obs.flush_interval_s", -0.5, True),
          ("data.backbone", False, False),
          ("data.test_rot", True, False),
          ("data.test_trans", True, False),
          ("data.stream_shard_cache", 1, False),
          ("data.stream_shard_cache", 0, True)]


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
    assert {k: cfg.data[k] for k in DATA_KEYS} == \
        {k: jcfg.data[k] for k in DATA_KEYS} == \
        {"backbone": True, "test_rot": False, "test_trans": False,
         "stream_shard_cache": 4}


def test_unported_key_off_its_default_raises_from_yaml(tmp_path):
    with open(SERVE) as f:
        raw = yaml.safe_load(f)
    raw.setdefault("train", {})["scan_epochs"] = True
    path = tmp_path / "scan.yaml"
    path.write_text(yaml.safe_dump(raw))
    with pytest.raises(NotImplementedError, match=r"train\.scan_epochs"):
        load_config(str(path))


NBODY = os.path.join(REPO, "configs", "nbody_fastegnn.yaml")

# JAX's mesh checks (tests/test_tensor_parallel.py): (edits to
# nbody_fastegnn.yaml, H=64; the error both packages raise, or None)
MESH_CASES = {
    "tensor_divides_hidden": ({"parallel": {"mesh": {"tensor": 2}}}, None),
    "tensor_must_divide": ({"parallel": {"mesh": {"tensor": 3}}},
                           "must divide"),
    "unknown_key": ({"parallel": {"mesh": {"pipeline": 2}}}, "unknown key"),
    "at_least_one": ({"parallel": {"mesh": {"data": 0}}}, ">= 1"),
    "fastegnn_only": ({"parallel": {"mesh": {"tensor": 2}},
                       "model": {"model_name": "EGNN"}}, "FastEGNN"),
    "hoisted_phi_e": ({"parallel": {"mesh": {"tensor": 2}},
                       "model": {"hoist_edge_mlp": False}}, "hoist_edge_mlp"),
    "no_tanh": ({"parallel": {"mesh": {"tensor": 2}},
                 "model": {"tanh": True}}, "tanh"),
    "data_conflicts": ({"parallel": {"mesh": {"data": 2}},
                        "data": {"data_parallel": 4}}, "conflicts"),
    "data_agrees": ({"parallel": {"mesh": {"data": 2}},
                     "data": {"data_parallel": 2}}, None),
    "data_parallel": ({"data": {"data_parallel": 2}}, None),
    "mesh_3d": ({"parallel": {"mesh": {"data": 2, "graph": 2,
                                       "tensor": 4}}}, None),
}


def _merged(raw, edits):
    for k, v in edits.items():
        if isinstance(v, dict):
            raw[k] = _merged(dict(raw.get(k) or {}), v)
        else:
            raw[k] = v
    return raw


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_keys_are_checked_as_in_jax(tmp_path, case):
    edits, error = MESH_CASES[case]
    with open(NBODY) as f:
        raw = _merged(yaml.safe_load(f), edits)
    path = tmp_path / "mesh.yaml"
    path.write_text(yaml.safe_dump(raw))
    if error is not None:
        with pytest.raises(ValueError, match=error):
            jax_load_config(str(path))
        with pytest.raises(ValueError, match=error):
            load_config(str(path))
        return
    j, p = jax_load_config(str(path)), load_config(str(path))
    assert dict(p.parallel.mesh) == dict(j.parallel.mesh)
    assert p.data.data_parallel == j.data.data_parallel


@pytest.mark.parametrize("flag, path", [
    ("data_parallel", ("data", "data_parallel")),
    ("tensor_parallel", ("parallel", "mesh", "tensor"))])
def test_mesh_cli_flags_set_the_keys_as_in_jax(flag, path):
    from distegnn_tpu_torch.config import build_arg_parser, cli_overrides

    args = build_arg_parser().parse_args(["--config_path", NBODY,
                                          f"--{flag}", "2"])
    p = load_config(NBODY, cli_overrides(args))
    j = jax_load_config(NBODY, overrides={flag: 2})
    for node in (p, j):
        for k in path:
            node = node[k]
        assert int(node) == 2


def test_checkpoint_crosses_meshes_and_gates_the_tensor_degree(tmp_path,
                                                               monkeypatch):
    """Saved at 2 x 2 x 2: restores at 1 x 2 x 1 (a plain load, the
    parameters equal, a ckpt/reshard event with both meshes, as JAX's
    test_checkpoint_records_mesh_and_restores_across_meshes); a tensor
    degree that does not divide the saved hidden width raises before any
    state changes (JAX's test_restore_rejects_indivisible_tensor_degree)."""
    import torch

    from distegnn_tpu_torch.train import checkpoint as ckpt
    from distegnn_tpu_torch.train.step import TrainState, make_optimizer

    def cfg(d, g, t):
        return {"parallel": {"mesh": {"data": d, "graph": g, "tensor": t}},
                "model": {"hidden_nf": 16}}

    def state(fill):
        m = torch.nn.Linear(3, 2)
        with torch.no_grad():
            for p in m.parameters():
                p.fill_(fill)
        return TrainState(m, make_optimizer(m.parameters(), 1e-3))

    events = []
    monkeypatch.setattr(ckpt.obs, "event",
                        lambda name, **kw: events.append((name, kw)))
    path = str(tmp_path / "last_model.ckpt")
    ckpt.save_checkpoint(path, state(2.5), epoch=4, seed=7, step_in_epoch=2,
                         config=cfg(2, 2, 2))
    assert ckpt.verify_checkpoint(path)["mesh"] == {"data": 2, "graph": 2,
                                                     "tensor": 2}
    target = state(0.0)
    r = ckpt.restore_for_resume(path, target, config=cfg(1, 2, 1))
    assert (r.epoch, r.step_in_epoch, r.seed) == (4, 2, 7)
    assert all(torch.equal(p, torch.full_like(p, 2.5))
               for p in target.model.parameters())
    reshard = [kw for name, kw in events if name == "ckpt/reshard"]
    assert reshard == [{"saved": {"data": 2, "graph": 2, "tensor": 2},
                        "target": {"data": 1, "graph": 2, "tensor": 1}}]
    untouched = state(0.0)
    with pytest.raises(ValueError, match="not divisible"):
        ckpt.restore_for_resume(path, untouched, config=cfg(1, 2, 3))
    assert all(torch.equal(p, torch.zeros_like(p))
               for p in untouched.model.parameters())
    with pytest.raises(ValueError, match="hidden_nf"):
        ckpt.check_mesh_restore_compat({"config": {"model": {
            "hidden_nf": 16}}}, config=cfg(1, 1, 5))


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


# the published configs of the Water-3D and protein datasets
DATASET_CONFIGS = ["water3d_fastegnn.yaml", "water3d_cpu_slice.yaml",
                   "protein_fastegnn.yaml", "protein_cpu_slice.yaml",
                   "simulation_distegnn.yaml"]


@pytest.mark.parametrize("name", DATASET_CONFIGS)
def test_published_dataset_configs_reach_their_processors(name, tmp_path):
    """Each config as published, its data_dir pointed at small synthetic
    raw files: the port's dispatch (main's cutoff mode, the launcher's
    distribute mode) processes them where it raised NotImplementedError."""
    import numpy as np

    from distegnn_tpu_torch.main import process_dataset_edge_cutoff
    from distegnn_tpu_torch.parallel.launch import _dispatch_preprocess
    from tests.conftest import make_water3d_h5

    cfg = load_config(os.path.join(REPO, "configs", name))
    if cfg.data.dataset_name == "Water-3D":
        cfg.data.data_dir = make_water3d_h5(tmp_path, 30, 30, 0.003, seed=1)
        cfg.data.max_samples, cfg.data.delta_t = 4, 5
    else:
        rng = np.random.default_rng(0)
        os.makedirs(tmp_path / "protein")
        np.savez(tmp_path / "protein" / "adk_backbone.npz",
                 positions=rng.uniform(0, 30, (3330, 20, 3)).astype("f4"),
                 charges=rng.uniform(0.1, 1, 20).astype("f4"))
        cfg.data.data_dir, cfg.data.max_samples = str(tmp_path), 4
    if cfg.data.accelerate_mode == "distribute":
        splits = _dispatch_preprocess(cfg, 2)
        assert [len(s) for s in splits] == [2, 2, 2]
        paths = [p for s in splits for p in s]
    else:
        paths = process_dataset_edge_cutoff(cfg.data, seed=cfg.seed)
        assert len(paths) == 3
    assert all(os.path.exists(p) for p in paths)
    assert f"_s{cfg.seed}" in os.path.basename(paths[0])


def test_main_trains_a_water3d_cpu_slice_shaped_config(tmp_path):
    """configs/water3d_cpu_slice.yaml at narrow widths (H=16, L=2), 1
    epoch, on synthetic h5 files, through the port's command line."""
    import numpy as np

    from distegnn_tpu_torch import main as pmain
    from tests.conftest import make_water3d_h5

    with open(os.path.join(REPO, "configs", "water3d_cpu_slice.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["data"].update(
        data_dir=make_water3d_h5(tmp_path / "data", 40, 40, 0.003, seed=5),
        max_samples=10, batch_size=5, delta_t=5, radius=0.12)
    raw["model"].update(hidden_nf=16, n_layers=2)
    raw["train"].update(epochs=1)
    raw["log"].update(log_dir=str(tmp_path / "logs"), test_interval=1)
    path = tmp_path / "water3d.yaml"
    path.write_text(yaml.safe_dump(raw))
    best = pmain.main(["--config_path", str(path), "--device", "cpu"])
    assert np.isfinite(best["loss_valid"]) and np.isfinite(best["loss_test"])


def test_serving_defaults_are_the_jax_defaults():
    """serve (the tiled executor's block included), slo and promote: the
    port's defaults equal JAX's key for key."""
    from distegnn_tpu.config import _DEFAULTS as JAX_DEFAULTS
    from distegnn_tpu_torch.config import _DEFAULTS
    from distegnn_tpu_torch.serve.tiled import TILED_DEFAULTS

    assert _DEFAULTS["serve"] == JAX_DEFAULTS["serve"]
    assert _DEFAULTS["serve"]["tiled"] == dict(TILED_DEFAULTS, enable=False)
    for section in ("slo", "promote"):
        assert _DEFAULTS[section] == JAX_DEFAULTS[section], section
    cfg, jcfg = load_config(SERVE), jax_load_config(SERVE)
    for key in ("batch_deadline_ms", "queue_capacity", "request_timeout_ms",
                "cache_size", "donate", "gateway"):
        assert cfg.serve[key] == jcfg.serve[key], key
    assert (cfg.serve.cache_size, cfg.serve.queue_capacity) == (16, 128)


def _yaml_deep(tmp_path, key, value):
    """configs/nbody_serve.yaml with the dotted ``key`` (any depth) set."""
    with open(SERVE) as f:
        raw = yaml.safe_load(f)
    *path, last = key.split(".")
    node = raw
    for p in path:
        node = node.setdefault(p, {})
    node[last] = value
    out = tmp_path / "cfg.yaml"
    out.write_text(yaml.safe_dump(raw))
    return str(out)


# the serving, slo and promote checks: (key, value, whether JAX refuses it)
SERVING = [("serve.queue_capacity", 0, True),
           ("serve.batch_deadline_ms", -1.0, True),
           ("serve.request_timeout_ms", 0.0, True),
           ("serve.cache_size", 0, True),
           ("serve.cache_size", 4, False),
           ("serve.result_margin_s", 0.0, True),
           ("serve.session_cache", -1, True),
           ("serve.session_cache", 0, False),
           ("serve.replicas", 0, False),
           ("serve.replicas", 2, False),
           ("serve.supervisor.wedge_timeout_s", 0.0, True),
           ("serve.supervisor.no_such_knob", 1.0, True),
           ("serve.supervisor.wedge_timeout_s", 5.0, False),
           ("serve.autoscale.min_replicas", 9, True),
           ("serve.autoscale.enable", True, False),
           ("serve.priority.bulk_max_inflight_frac", 0.0, True),
           ("serve.stream.chunk_steps", 0, True),
           ("serve.stream.chunk_steps", 4, False),
           ("serve.models", [{"name": "a"}, {"name": "a"}], True),
           ("serve.models", [{"name": "a", "overrides": {"seed": 1}}], False),
           ("serve.gateway.port", 70000, True),
           ("serve.gateway.warmup_nodes", [1], True),
           ("serve.worker.spawn_timeout_s", 0.0, True),
           ("serve.tiled.enable", True, False),
           ("serve.tiled.enable", "yes", True),
           ("serve.tiled.tile_nodes", 0, True),
           ("serve.tiled.tile_nodes", 8192, False),
           ("serve.tiled.devices", "auto", False),
           ("serve.tiled.devices", 0, True),
           ("serve.tiled.growth", 1.0, True),
           ("serve.tiled.no_such_knob", 1, True),
           ("slo.routes", {"train": {"p99_ms": 1.0}}, True),
           ("slo.batch_fill_min", 0.5, False),
           ("slo.enable", "yes", True),
           ("promote.history", 0, True),
           ("promote.no_such_knob", 1, True)]


@pytest.mark.parametrize("key, value, refused", SERVING)
def test_serving_keys_are_checked_as_in_jax(tmp_path, key, value, refused):
    path = _yaml_deep(tmp_path, key, value)
    if refused:
        with pytest.raises(ValueError) as jerr:
            jax_load_config(path)
        with pytest.raises(ValueError) as perr:
            load_config(path)
        assert str(perr.value) == str(jerr.value)
        return
    cfg, jcfg = load_config(path), jax_load_config(path)
    node, jnode = cfg, jcfg
    for p in key.split("."):
        node, jnode = node[p], jnode[p]
    assert node == jnode == value


# the promotion conveyor and the process backend are ported: (dotted keys
# and values, whether the JAX package's checks refuse them)
CONVEYOR = [({"promote.enable": True}, True),
            ({"promote.publish": True}, True),
            ({"promote.enable": True,
              "promote.watch_dir": "logs/promote/conveyor"}, False),
            ({"promote.publish": True,
              "promote.watch_dir": "logs/promote/conveyor"}, False),
            ({"serve.workers": "process"}, False),
            ({"serve.workers": "fork"}, True),
            ({"serve.workers": "process", "serve.worker.kill_grace_s": 0.5},
             False),
            ({"serve.supervisor.worker_heartbeat_timeout_s": 2.0}, False)]


@pytest.mark.parametrize("keys, refused", CONVEYOR)
def test_conveyor_and_worker_keys_load_and_are_checked_as_in_jax(
        tmp_path, keys, refused):
    with open(SERVE) as f:
        raw = yaml.safe_load(f)
    for key, value in keys.items():
        *path, last = key.split(".")
        node = raw
        for p in path:
            node = node.setdefault(p, {})
        node[last] = value
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    if refused:
        with pytest.raises(ValueError) as jerr:
            jax_load_config(str(path))
        with pytest.raises(ValueError) as perr:
            load_config(str(path))
        assert str(perr.value) == str(jerr.value)
        return
    cfg, jcfg = load_config(str(path)), jax_load_config(str(path))
    for key, value in keys.items():
        node, jnode = cfg, jcfg
        for p in key.split("."):
            node, jnode = node[p], jnode[p]
        assert node == jnode == value


def test_promote_config_builds_a_gateway_with_its_promoter(tmp_path):
    """configs/nbody_promote.yaml as published (its watch directory moved
    under the test's) builds a three-replica gateway whose promoter runs,
    and /readyz-shaped status reports the fleet coherent."""
    from distegnn_tpu_torch.serve.registry import ModelRegistry
    from distegnn_tpu_torch.serve.transport import Gateway

    cfg = load_config(os.path.join(REPO, "configs", "nbody_promote.yaml"),
                      {"promote.watch_dir": str(tmp_path / "conveyor"),
                       "model.hidden_nf": 16, "model.n_layers": 2})
    assert cfg.promote.enable and cfg.serve.replicas == 3
    reg = ModelRegistry.from_config(cfg, device="cpu")
    gw = Gateway(reg, port=0, promote=dict(cfg.promote))
    try:
        assert gw.promoter.enable and gw.promoter._thread is not None
        reg.start()
        reg.warmup([48])
        gw.promoter.tick()
        st = gw.promoter.status()
        assert st["state"] == "idle" and st["fleet_coherent"] is True
        assert len(reg.get("default").replicas.replicas) == 3
    finally:
        gw.close()
        reg.stop()
