"""Config loading for the port — the slice of ``distegnn_tpu/config.py`` that
the serving and training paths read: YAML merged over defaults, overrides,
the ``model``/``data``/``train``/``log``/``serve`` checks, the trainer's
command-line flags and its derived run name (pure Python, no jax).

Sections the port does not read yet (obs, promote, ...) are carried through
from the YAML unchanged. The keys that the JAX package acts on and the port
does not port yet (``train.resume``, ``train.checkpoint_interval_s``,
``train.scan_epochs``, ``parallel.mesh``, ``log.wandb.enable``) must keep
their JAX defaults: any other value raises ``NotImplementedError`` naming the
key and the ROADMAP item that will port it, rather than run another program
without a word. At their defaults the port runs the JAX program.
``train.divergence_retries`` / ``divergence_lr_decay`` are ported (the
trainer's rollback) and take any value.
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
        "frame_0": 30,
        "frame_T": 40,
        "node_order": "none",
        "node_bucket": 8,
        "edge_bucket": 128,
        "edge_block": 0,
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
        # acted on by the JAX package, not ported yet: only their defaults
        # are accepted (see _UNPORTED)
        "scan_epochs": "auto",
        "resume": None,
        "checkpoint_interval_s": 0,
    },
    "log": {
        "log_dir": "./logs",
        "test_interval": 2,
        "wandb": {"enable": False, "offline": True, "api_key": "",
                  "project": "", "entity": ""},
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
    },
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
    ("train.resume", (None,),
     "the resume scan, ROADMAP.md queue 1 item 3.2"),
    ("train.checkpoint_interval_s", (0,),
     "the cadence saves, ROADMAP.md queue 1 item 3.2"),
    ("train.scan_epochs", ("auto",),
     "the epoch as one device program, ROADMAP.md queue 1 item 3.4; the "
     "port's eager loop is its only mode"),
    ("parallel.mesh.data", (None, 1),
     "the distributed slice, ROADMAP.md queue 1 item 2; the port trains on "
     "one device"),
    ("parallel.mesh.graph", (None, 1),
     "the distributed slice, ROADMAP.md queue 1 item 2; the port trains on "
     "one device"),
    ("parallel.mesh.tensor", (1, None),
     "tensor parallelism, ROADMAP.md queue 1 item 6"),
    ("log.wandb.enable", (False,),
     "wandb logging, ROADMAP.md queue 1 item 3.6; wandb is not installed"),
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


def validate_config(cfg: ConfigDict) -> None:
    """The model/data/train/log/serve checks of the JAX package's
    validate_config, for the keys the port reads, and the refusal of the
    keys it does not port yet (``_UNPORTED``)."""
    _check_unported(cfg)
    d = cfg.data
    if d.accelerate_mode not in _VALID_ACCEL_MODES:
        raise ValueError(
            f"data.accelerate_mode must be one of {_VALID_ACCEL_MODES}")
    if not 0.0 <= float(d.cutoff_rate) < 1.0:
        raise ValueError("data.cutoff_rate must be in [0, 1)")
    if int(d.batch_size) < 1:
        raise ValueError("data.batch_size must be >= 1")
    if (d.node_order or "none") not in _VALID_NODE_ORDERS:
        raise ValueError(f"data.node_order must be one of {_VALID_NODE_ORDERS}")
    t = cfg.train
    if int(t.accumulation_steps) < 1:
        raise ValueError("train.accumulation_steps must be >= 1")
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


def derive_runtime_fields(cfg: ConfigDict) -> ConfigDict:
    """Set ``data.world_size`` (1: the port trains on one device) and
    ``log.exp_name`` as the JAX package does for ``cutoff_edges``: dataset,
    radius and cutoff, model, world size, channels and a time stamp."""
    cfg.data.world_size = 1
    d = cfg.data
    stamp = time.strftime("%Y%m%d_%H%M%S")
    cfg.log.exp_name = (
        f"{d.dataset_name}_r{d.radius}_cut{d.cutoff_rate}"
        f"_{cfg.model.model_name}_ws1_C{cfg.model.virtual_channels}_{stamp}")
    return cfg
