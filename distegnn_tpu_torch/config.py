"""Config loading for the port — the slice of ``distegnn_tpu/config.py`` that
the serving and training paths read: YAML merged over defaults, overrides,
the ``model``/``data``/``train``/``log``/``serve`` checks, the trainer's
command-line flags and its derived run name (pure Python, no jax).

Sections the port does not read yet (promote, slo, ...) are carried through
from the YAML unchanged. The keys that the JAX package acts on and the port
does not port yet (``train.scan_epochs``, the data and tensor axes
``parallel.mesh.data`` / ``data.data_parallel`` and ``parallel.mesh.tensor``,
``log.wandb.enable``, ``serve.tiled.enable``, ``promote.publish``) must keep
their JAX defaults: any other value raises ``NotImplementedError`` naming the
key and the ROADMAP item that will port it, rather than run another program
without a word. At their defaults the port runs the JAX program.
``train.divergence_retries`` / ``divergence_lr_decay`` (the trainer's
rollback), ``train.resume`` / ``checkpoint_interval_s`` /
``keep_checkpoints`` (preemption, cadence saves and the resume scan),
``log.trace_epoch`` / ``check_consistency`` and the ``obs`` section are
ported and checked as in JAX.
"""

from __future__ import annotations

import argparse
import copy
import time
from typing import Any, Mapping, Optional

import yaml

OH_CHUNK = 512   # smallest legal fused edge block (ops/edge_pipeline.py)


class ConfigDict(dict):
    """dict with attribute access, recursively."""

    def __init__(self, data: Optional[Mapping] = None):
        super().__init__()
        for k, v in (data or {}).items():
            self[k] = (ConfigDict(v) if isinstance(v, Mapping)
                       and not isinstance(v, ConfigDict) else v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = (ConfigDict(value) if isinstance(value, Mapping)
                      and not isinstance(value, ConfigDict) else value)

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, ConfigDict) else v
                for k, v in self.items()}


# The defaults of the JAX package for the fields the serving and training
# paths read.
_DEFAULTS: dict = {
    "seed": 43,
    "model": {
        "model_name": "FastEGNN",
        "normalize": False,
        "hidden_nf": 64,
        "n_layers": 4,
        "virtual_channels": 3,
        "node_feat_nf": 2,
        "node_attr_nf": 0,
        "edge_attr_nf": 2,
        "checkpoint": None,
        "compute_dtype": None,
        # recompute each layer's activations in the backward pass
        "remat": False,
        # the plain path's knobs (models/fast_egnn.py): the blocked
        # lowering ('einsum' | 'pallas'), the hoisted edge MLP, the aggregation
        # lowering ('scatter' | 'cumsum' | 'ell'), one packed aggregation
        # per layer, and its stream dtype (None = f32, 'bf16')
        "blocked_impl": "einsum",
        "hoist_edge_mlp": True,
        "segment_impl": "scatter",
        "fuse_agg": True,
        "agg_dtype": None,
        "edge_impl": "plain",
        # the fused_stack residency budget in bytes (0 = the 16 MiB default)
        "stack_vmem_budget": 0,
    },
    "data": {
        "data_dir": "./data",
        "dataset_name": "nbody_100",
        "max_samples": 5000,
        "batch_size": 1,
        "accelerate_mode": "cutoff_edges",
        "radius": -1.0,
        "cutoff_rate": 0.0,
        # distribute mode: graph parts of outer_radius partitions, local
        # inner_radius edges (data/partition.py)
        "outer_radius": None,
        "inner_radius": None,
        "split_mode": "metis",
        # graph parts = ranks; None derives it (derive_runtime_fields)
        "world_size": None,
        "frame_0": 30,
        "frame_T": 40,
        "delta_t": 20,
        # the protein pipeline (data/protein.py): backbone atoms only, and
        # the test split rotated / translated
        "backbone": True,
        "test_rot": False,
        "test_trans": False,
        "node_order": "none",
        "node_bucket": 8,
        "edge_bucket": 128,
        "edge_block": 0,
        # the data axis of the JAX mesh: not ported (see _UNPORTED)
        "data_parallel": 1,
        # batches collated and copied ahead by a background thread in a
        # distributed run (0 = synchronous)
        "prefetch_depth": 2,
        # decoded shards resident per StreamedGraphDataset when a dataset
        # path is a shard directory (data/stream.py)
        "stream_shard_cache": 4,
    },
    "train": {
        "learning_rate": 5e-4,
        "weight_decay": 1e-12,
        "epochs": 2500,
        "early_stop": 2500,
        "mmd": {"sigma": 1.5, "weight": 0.03, "samples": 3},
        "accumulation_steps": 1,
        "warmup_epochs": 0,
        "scheduler": "None",
        # the divergence rollback (train/trainer.py)
        "divergence_retries": 2,
        "divergence_lr_decay": 0.5,
        # the epoch as one device program: not ported (see _UNPORTED)
        "scan_epochs": "auto",
        # resume: null (a fresh run) | 'auto' (the newest valid checkpoint
        # under log.log_dir) | a checkpoint path
        "resume": None,
        # seconds between mid-epoch step_<n>.ckpt saves (0 = off), keeping
        # the newest keep_checkpoints
        "checkpoint_interval_s": 0,
        "keep_checkpoints": 3,
    },
    "log": {
        "log_dir": "./logs",
        "test_interval": 2,
        # assert the parameters bitwise replicated over the graph axis at
        # every eval epoch (parallel/checks.py)
        "check_consistency": True,
        # a torch.profiler trace of this epoch (0 = off) under
        # <exp_dir>/trace/
        "trace_epoch": 0,
        "wandb": {"enable": False, "offline": True, "api_key": "",
                  "project": "", "entity": ""},
    },
    # the event stream (obs/): rank 0 writes <exp_dir>/obs/events.jsonl;
    # enable: false turns every hook into a no-op and writes no file
    "obs": {
        "enable": True,
        # every rank writes its own events_p<rank>.jsonl
        "per_host": False,
        # the device memory probe (obs/cudaprobe.py; the JAX package's key)
        "jax_probe": True,
        # one train/step event per micro-step
        "step_events": True,
        # the writer flushes every buffer_events events or
        # flush_interval_s seconds
        "buffer_events": 256,
        "flush_interval_s": 2.0,
    },
    "parallel": {
        "mesh": {"data": None, "graph": None, "tensor": 1},
    },
    "serve": {
        "node_floor": 64,
        "edge_floor": 256,
        "growth": 2.0,
        "node_multiple": 8,
        "edge_multiple": 128,
        "max_nodes": 65536,
        "max_edges": 1 << 20,
        "max_batch": 8,
        # optional K-step rollout serving (rollout.make_rollout_fn kwargs);
        # null disables rollouts
        "rollout": None,
        # the tiled executor: not ported (see _UNPORTED)
        "tiled": {"enable": False},
    },
    # the promotion conveyor's trainer end: not ported (see _UNPORTED)
    "promote": {"publish": False},
}

def _merge(base: dict, override: Mapping) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if v is None and isinstance(out.get(k), dict):
            continue  # bare `section:` header in YAML — keep the defaults
        if isinstance(v, Mapping) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str, overrides: Optional[Mapping] = None) -> ConfigDict:
    """Load YAML, merge over defaults, apply overrides, validate."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = ConfigDict(_merge(_DEFAULTS, raw))
    if overrides:
        apply_overrides(cfg, overrides)
    validate_config(cfg)
    return cfg


def apply_overrides(cfg: ConfigDict, overrides: Mapping) -> None:
    """Apply ``{path: value}`` overrides; ``None`` values are skipped.

    ``path`` is a top-level key (``seed``) or a dotted path into an existing
    section (``data.edge_block``)."""
    for name, value in overrides.items():
        if value is None:
            continue
        *sections, key = name.split(".")
        node = cfg
        for p in sections:
            if not isinstance(node.get(p), dict):
                raise KeyError(f"unknown override {name!r}: no section {p!r}")
            node = node[p]
        if not sections and key not in node:
            raise KeyError(f"unknown override {name!r}: no top-level key")
        node[key] = value


# Keys the JAX package acts on that the port does not port yet: (dotted
# path, the values that run the JAX program on the port too, what ports it)
_UNPORTED = (
    ("train.scan_epochs", ("auto",),
     "the epoch as CUDA graphs of the micro-step, ROADMAP.md queue 1 item "
     "1.3; the port's eager loop is its only mode"),
    ("parallel.mesh.data", (None, 1),
     "the data axis, ROADMAP.md queue 1 item 2.3; the port's distributed "
     "run has the graph axis only"),
    ("data.data_parallel", (1, None),
     "the data axis, ROADMAP.md queue 1 item 2.3; the port's distributed "
     "run has the graph axis only"),
    ("parallel.mesh.tensor", (1, None),
     "tensor parallelism, ROADMAP.md queue 1 item 7"),
    ("log.wandb.enable", (False,),
     "wandb logging, not queued in ROADMAP.md: wandb is not installed"),
    ("serve.tiled.enable", (False, None),
     "the tiled executor, ROADMAP.md queue 1 item 6"),
    ("promote.publish", (False, None),
     "the promotion publisher (promote/), ROADMAP.md queue 1 item 6"),
)


def _get(cfg: Mapping, path: str):
    node = cfg
    for p in path.split("."):
        if not isinstance(node, Mapping) or p not in node:
            return None
        node = node[p]
    return node


def _check_unported(cfg: ConfigDict) -> None:
    for path, ok, what in _UNPORTED:
        v = _get(cfg, path)
        # bool is an int: True must not pass for 1 (nor False for 0)
        if not any(v is a or (a is not None and v is not None
                              and isinstance(v, bool) == isinstance(a, bool)
                              and v == a) for a in ok):
            raise NotImplementedError(
                f"{path}={v!r}: the port does not act on this key yet "
                f"({what}); leave it at {ok[0]!r}")


_VALID_ACCEL_MODES = ("cutoff_edges", "distribute")
_VALID_NODE_ORDERS = ("none", "morton")
_VALID_SPLIT_MODES = ("random", "metis", "spectral", "kmeans")


def validate_config(cfg: ConfigDict) -> None:
    """The model/data/train/log/serve checks of the JAX package's
    validate_config, for the keys the port reads, and the refusal of the
    keys it does not port yet (``_UNPORTED``)."""
    _check_unported(cfg)
    d = cfg.data
    if d.accelerate_mode not in _VALID_ACCEL_MODES:
        raise ValueError(
            f"data.accelerate_mode must be one of {_VALID_ACCEL_MODES}")
    if d.accelerate_mode == "distribute":
        if d.split_mode not in _VALID_SPLIT_MODES:
            raise ValueError(
                f"data.split_mode must be one of {_VALID_SPLIT_MODES}")
        if d.outer_radius is None or d.inner_radius is None:
            raise ValueError("distribute mode requires data.outer_radius and "
                             "data.inner_radius")
    if int(d.get("prefetch_depth", 2)) < 0:
        raise ValueError("data.prefetch_depth must be >= 0 (0 = synchronous)")
    if int(d.get("stream_shard_cache", 4)) < 1:
        raise ValueError("data.stream_shard_cache must be >= 1")
    graph = _get(cfg, "parallel.mesh.graph")
    ws = d.get("world_size")
    if graph is not None and ws is not None and int(graph) != int(ws):
        raise ValueError(f"parallel.mesh.graph={int(graph)} conflicts with "
                         f"data.world_size={int(ws)} — set one of them")
    for key, v in (("parallel.mesh.graph", graph), ("data.world_size", ws)):
        if v is not None and int(v) < 1:
            raise ValueError(f"{key} must be >= 1")
    if not 0.0 <= float(d.cutoff_rate) < 1.0:
        raise ValueError("data.cutoff_rate must be in [0, 1)")
    if int(d.batch_size) < 1:
        raise ValueError("data.batch_size must be >= 1")
    if (d.node_order or "none") not in _VALID_NODE_ORDERS:
        raise ValueError(f"data.node_order must be one of {_VALID_NODE_ORDERS}")
    t = cfg.train
    if int(t.accumulation_steps) < 1:
        raise ValueError("train.accumulation_steps must be >= 1")
    resume = t.get("resume")
    if resume is not None and not isinstance(resume, str):
        raise ValueError("train.resume must be null, 'auto', or a checkpoint "
                         "path")
    if float(t.get("checkpoint_interval_s", 0) or 0) < 0:
        raise ValueError("train.checkpoint_interval_s must be >= 0")
    if int(t.get("keep_checkpoints", 3)) < 1:
        raise ValueError("train.keep_checkpoints must be >= 1")
    if int(t.epochs) < 0 or int(t.early_stop) < 1:
        raise ValueError("train.epochs must be >= 0 and train.early_stop >= 1")
    if float(t.mmd.sigma) <= 0 or int(t.mmd.samples) < 1:
        raise ValueError("train.mmd.sigma must be > 0 and train.mmd.samples "
                         ">= 1")
    lg = cfg.log
    if not isinstance(lg.get("log_dir", ""), str):
        raise ValueError("log.log_dir must be a string path")
    if int(lg.get("test_interval", 2)) < 1:
        raise ValueError("log.test_interval must be >= 1")
    if not isinstance(lg.get("check_consistency", True), bool):
        raise ValueError("log.check_consistency must be a boolean")
    if int(lg.get("trace_epoch", 0) or 0) < 0:
        raise ValueError("log.trace_epoch must be >= 0")
    o = cfg.get("obs")
    if o is not None:
        for flag in ("enable", "per_host", "jax_probe", "step_events"):
            if not isinstance(o.get(flag, False), bool):
                raise ValueError(f"obs.{flag} must be a boolean")
        if int(o.get("buffer_events", 256)) < 1:
            raise ValueError("obs.buffer_events must be >= 1")
        if float(o.get("flush_interval_s", 2.0)) < 0:
            raise ValueError("obs.flush_interval_s must be >= 0")
    if int(cfg.model.virtual_channels) < 1:
        raise ValueError("model.virtual_channels must be >= 1")
    edge_impl = cfg.model.get("edge_impl", "plain")
    if edge_impl not in ("plain", "fused", "fused_stack"):
        raise ValueError(
            "model.edge_impl must be 'plain', 'fused', or 'fused_stack'")
    if edge_impl in ("fused", "fused_stack"):
        blk = int(cfg.data.edge_block)
        if blk < OH_CHUNK or blk % OH_CHUNK:
            raise ValueError(
                f"model.edge_impl='{edge_impl}' requires data.edge_block >= "
                f"{OH_CHUNK} and a multiple of {OH_CHUNK} (got {blk})")
        if int(cfg.model.edge_attr_nf) != 2:
            raise ValueError(f"model.edge_impl='{edge_impl}' requires "
                             "edge_attr_nf == 2 "
                             "(the kernel's scalar lane layout is fixed)")
        if bool(cfg.model.normalize):
            raise ValueError(f"model.edge_impl='{edge_impl}' does not support "
                             "model.normalize (flagship EGCL only)")
    if edge_impl == "fused_stack":
        # what the config alone can know; the shape-dependent residency
        # check raises StackVmemBudgetError before the kernel's launch
        if int(cfg.model.n_layers) < 1:
            raise ValueError(
                "model.edge_impl='fused_stack' requires model.n_layers >= 1 "
                "(the megakernel grid runs one step per layer)")
        budget = int(cfg.model.get("stack_vmem_budget", 0) or 0)
        if budget < 0:
            raise ValueError(
                "model.stack_vmem_budget must be >= 0 bytes (0 = the "
                "16 MiB/core default; the fused_stack megakernel raises "
                "StackVmemBudgetError at trace time when the VMEM-resident "
                "graph exceeds this bound)")
    s = cfg.get("serve")
    if s is None:
        return
    if float(s.growth) <= 1.0:
        raise ValueError("serve.growth must be > 1")
    if int(s.max_batch) < 1:
        raise ValueError("serve.max_batch must be >= 1")
    r = s.get("rollout")
    if r is not None:
        if not isinstance(r, Mapping):
            raise ValueError("serve.rollout must be null or a mapping of "
                             "make_rollout_fn kwargs (radius, max_degree, ...)")
        if float(r.get("radius", 0.0)) <= 0:
            raise ValueError("serve.rollout.radius must be > 0")
        if int(r.get("max_degree", 0)) < 1:
            raise ValueError("serve.rollout.max_degree must be >= 1")
        if int(r.get("max_per_cell", 16)) < 1:
            raise ValueError("serve.rollout.max_per_cell must be >= 1")
        if (int(r.get("max_degree", 0))
                * int(r.get("edge_block", 256))) % 512:
            raise ValueError("serve.rollout: max_degree * edge_block must be "
                             "a multiple of 512 (the kernel edge tile)")


# Command-line flags of the trainer: name -> (dotted config path, type), the
# JAX package's flags for the keys the port reads.
CLI_FIELDS = {
    "lr": ("train.learning_rate", float),
    "seed": ("seed", int),
    "model_name": ("model.model_name", str),
    "batch_size": ("data.batch_size", int),
    "early_stop": ("train.early_stop", int),
    "checkpoint": ("model.checkpoint", str),
    "cutoff_rate": ("data.cutoff_rate", float),
    "virtual_channels": ("model.virtual_channels", int),
    "epochs": ("train.epochs", int),
    "edge_impl": ("model.edge_impl", str),
    "resume": ("train.resume", str),
    "split_mode": ("data.split_mode", str),
    "outer_radius": ("data.outer_radius", float),
    "inner_radius": ("data.inner_radius", float),
    "world_size": ("data.world_size", int),
}


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="DistEGNN trainer (PyTorch + CUDA port)")
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--device", type=str, default=None,
                        help="'cuda' (the default) or 'cpu'")
    for name, (_, typ) in CLI_FIELDS.items():
        parser.add_argument(f"--{name}", type=typ, default=None)
    return parser


def cli_overrides(args: argparse.Namespace) -> dict:
    """Parsed flags -> ``{dotted path: value}`` for :func:`load_config`."""
    return {path: getattr(args, name)
            for name, (path, _) in CLI_FIELDS.items()}


def derive_runtime_fields(cfg: ConfigDict,
                          world_size: Optional[int] = None) -> ConfigDict:
    """Set ``data.world_size`` and ``log.exp_name`` as the JAX package does
    (dataset, the radii and split mode or the radius and cutoff, model,
    world size, channels and a time stamp). ``cutoff_edges`` trains on one
    device: world size 1. ``distribute``: ``world_size``, else
    ``data.world_size`` or ``parallel.mesh.graph`` when set, else the
    number of CUDA cards (at least 1)."""
    d = cfg.data
    if d.accelerate_mode != "distribute":
        world_size = 1
    if world_size is None:
        world_size = d.get("world_size") or _get(cfg, "parallel.mesh.graph")
    if world_size is None:
        import torch

        world_size = max(1, torch.cuda.device_count())
    d.world_size = int(world_size)
    if d.accelerate_mode == "distribute":
        geo = f"{d.split_mode}_o{d.outer_radius}_i{d.inner_radius}"
    else:
        geo = f"r{d.radius}_cut{d.cutoff_rate}"
    stamp = time.strftime("%Y%m%d_%H%M%S")
    cfg.log.exp_name = (
        f"{d.dataset_name}_{geo}_{cfg.model.model_name}"
        f"_ws{d.world_size}_C{cfg.model.virtual_channels}_{stamp}")
    return cfg
