"""Config loading for the port — the slice of ``distegnn_tpu/config.py`` that
the serving path reads: YAML merged over defaults, overrides, and the
``model``/``data``/``serve`` checks (pure Python, no jax).

Sections the port does not read yet (train, log, obs, ...) are carried through
from the YAML unchanged, without defaults or validation.
"""

from __future__ import annotations

import copy
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


# The defaults of the JAX package for the fields the serving path reads.
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
        "edge_impl": "plain",
    },
    "data": {
        "dataset_name": "nbody_100",
        "radius": -1.0,
        "edge_block": 0,
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


def validate_config(cfg: ConfigDict) -> None:
    """The model/data/serve checks of the JAX package's validate_config."""
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
    s = cfg.get("serve")
    if s is None:
        return
    if float(s.growth) <= 1.0:
        raise ValueError("serve.growth must be > 1")
    if int(s.max_batch) < 1:
        raise ValueError("serve.max_batch must be >= 1")
