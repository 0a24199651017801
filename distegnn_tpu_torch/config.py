"""Config loading for the port — the slice of ``distegnn_tpu/config.py`` that
the serving and training paths read: YAML merged over defaults, overrides,
the ``model``/``data``/``train``/``log``/``obs``/``serve``/``slo``/
``promote`` checks, the trainer's command-line flags and its derived run
name (pure Python, no jax).

The keys that the JAX package acts on and the port does not port yet
(``log.wandb.enable`` and ``serve.donate: true``) must keep values that
run the JAX program: any other value raises
``NotImplementedError`` naming the key and why, rather than run another
program without a word. The mesh (``parallel.mesh.{data,graph,tensor}``,
``data.data_parallel``, ``data.world_size``) is checked as JAX checks it
and acts in ``parallel/launch.py``.
``train.scan_epochs`` acts as in JAX (train/scan_epoch.py): ``true`` runs
the epochs on staged device data (replayed from CUDA graphs on the card),
``false`` the eager loop, ``'auto'`` the former on the card when the data
fit and the latter on the CPU. Every other serving key acts as in JAX: the queue and
gateway keys in ``serve/queue.py`` and ``serve/transport.py``,
``serve.cache_size`` as the engine's LRU of shape keys, ``serve.tiled`` in
``serve/tiled.py`` and ``serve/mesh_tiled.py`` (scenes above
``serve.max_nodes`` served as Morton tiles), ``serve.replicas`` /
``workers`` / ``worker`` / ``supervisor`` / ``autoscale`` in
``serve/replica.py``, ``serve/worker.py`` and their neighbours, ``slo`` in
``obs/slo.py``, ``promote`` in ``promote/`` (the publisher in the trainer,
the promoter in the gateway).
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
        # the data axis of the mesh: data shards of every draw
        # (parallel/launch.py); ranks = world_size x data_parallel x tensor
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
        # the epoch on staged device data (train/scan_epoch.py): 'auto' on
        # the card when the data fit, never on the CPU
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
        # micro-batcher (serve/queue.py): coalesce same-rung requests up to
        # max_batch or until the oldest has waited batch_deadline_ms; every
        # forward runs at exactly max_batch graphs
        "max_batch": 8,
        "batch_deadline_ms": 5.0,
        # bounded ingress (submits beyond it fail fast) and the per-request
        # queued-time deadline
        "queue_capacity": 256,
        "request_timeout_ms": 1000.0,
        # the engine's LRU of shape keys (serve/engine.py: hits, misses and
        # evictions as the JAX compile cache counts them) and buffer
        # donation ('auto' is JAX's no-op off a TPU; true is refused)
        "cache_size": 32,
        "donate": "auto",
        # hard-deadline headroom over request_timeout_ms: a ServeFuture
        # waits at most timeout + margin (the gateway's 504)
        "result_margin_s": 30.0,
        # optional K-step rollout serving (rollout.make_rollout_fn kwargs);
        # null disables rollouts
        "rollout": None,
        # the session-affinity prep cache (serve/prep.py): entries (0
        # disables) and a byte bound (0 = entries only)
        "session_cache": 64,
        "session_cache_bytes": 1 << 30,
        # the tiled executor (serve/tiled.py): requests above
        # serve.max_nodes served as fixed-shape Morton tiles with a host-side
        # halo exchange instead of a 413; the values are
        # serve/tiled.py TILED_DEFAULTS but for enable
        "tiled": {
            "enable": False,
            # the tiled path's own bound (a 413 naming this knob above it)
            "max_nodes": 4_194_304,
            # own-node slots per tile; the halo and edge axes grow
            # geometrically above their floors, so scenes share tile shapes
            "tile_nodes": 65536,
            "halo_floor": 1024,
            "edge_floor": 8192,
            "growth": 2.0,
            # a tiled request's deadlines stretch by this factor
            "timeout_factor": 8.0,
            # tile rounds over devices (serve/mesh_tiled.py): 'auto' = every
            # visible card, N clamped to what exists, 1 = one tile at a time
            "devices": 1,
        },
        # engine replicas per model (serve/replica.py): threads of the
        # gateway, or one worker child process each ('process',
        # serve/worker.py)
        "replicas": 1,
        "workers": "thread",
        # the process backend's knobs (serve/worker.py)
        "worker": {
            "spawn_timeout_s": 120.0,
            "heartbeat_s": 0.5,
            "kill_grace_s": 3.0,
        },
        # ReplicaSupervisor kwargs (serve/supervisor.py)
        "supervisor": {
            "heartbeat_s": 0.25,
            "wedge_timeout_s": 60.0,
            "worker_heartbeat_timeout_s": 10.0,
            "backoff_base_s": 0.5,
            "backoff_max_s": 30.0,
            "breaker_threshold": 3,
            "breaker_cooldown_s": 30.0,
            "healthy_reset_s": 60.0,
        },
        # ReplicaAutoscaler knobs (serve/autoscale.py); off by default
        "autoscale": {
            "enable": False,
            "min_replicas": 1,
            "max_replicas": 4,
            "interval_s": 0.5,
            "scale_up_cooldown_s": 2.0,
            "scale_down_cooldown_s": 10.0,
            "step": 1,
            "queue_high": 4.0,
            "shed_high": 0.01,
            "p99_high_ms": None,
            "queue_low": 0.5,
            "idle_rounds": 3,
            "drain_timeout_s": 30.0,
        },
        # priority admission (serve/transport.py): bulk rollouts capped at a
        # share of max_inflight, deferred while the SLO window is degraded
        "priority": {
            "enable": True,
            "header": "X-Priority",
            "bulk_max_inflight_frac": 0.75,
            "degrade_shed_rate": 0.05,
            "degrade_p99_ms": None,
            "bulk_retry_factor": 4.0,
            "bulk_content_bytes": 4_194_304,
        },
        # streamed rollouts (POST .../rollout?stream=1): steps per chunk
        "stream": {"chunk_steps": 8},
        # multi-model routing (serve/registry.py): null = one model from
        # this config, else a list of {name, config_path?, overrides?}
        "models": None,
        # the HTTP gateway (serve/transport.py, serve/gateway.py)
        "gateway": {
            "host": "127.0.0.1",
            "port": 8008,
            "max_inflight": 64,
            "drain_grace_s": 10.0,
            "warmup_nodes": [48, 96],
        },
    },
    # service-level objectives (obs/slo.py): thresholds scored against the
    # event stream or a GET /metrics scrape; window_s sizes the gateway's
    # rolling slo/window_* gauges
    "slo": {
        "enable": True,
        "window_s": 60.0,
        "routes": {},
        "error_rate_max": None,
        "shed_rate_max": None,
        "batch_fill_min": None,
        "session_hit_min": None,
    },
    # the promotion conveyor (promote/): the trainer's publisher and the
    # gateway's promoter
    "promote": {
        "enable": False,
        "publish": False,
        "watch_dir": "",
        "model": "",
        "interval_s": 1.0,
        "history": 4,
        "shadow_sample": 0.25,
        "min_shadow": 8,
        "max_shadow_inflight": 8,
        "gate_timeout_s": 30.0,
        "drift_ceiling": 0.05,
        "max_error_rate": 0.0,
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
    ("log.wandb.enable", (False,),
     "wandb logging, not queued in ROADMAP.md: wandb is not installed"),
    ("serve.donate", ("auto", False),
     "buffer donation: eager PyTorch has none to give, not queued in "
     "ROADMAP.md; 'auto' is JAX's own no-op off a TPU"),
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


def _check_mesh(cfg: ConfigDict) -> None:
    """The JAX package's checks of ``parallel.mesh``: its keys, values >= 1,
    and the tensor axis's constraints (T divides the hidden width, FastEGNN
    with the hoisted phi_e and no tanh); ``parallel.mesh.data`` against
    ``data.data_parallel``."""
    par = cfg.get("parallel")
    mesh = par.get("mesh") if par is not None else None
    if mesh is None:
        return
    if not isinstance(mesh, Mapping):
        raise ValueError("parallel.mesh must be a mapping with optional "
                         "keys data/graph/tensor")
    for key in mesh:
        if key not in ("data", "graph", "tensor"):
            raise ValueError(f"parallel.mesh: unknown key {key!r} "
                             "(valid: data, graph, tensor)")
    for key in ("data", "graph", "tensor"):
        val = mesh.get(key, None if key != "tensor" else 1)
        if val is not None and int(val) < 1:
            raise ValueError(f"parallel.mesh.{key} must be >= 1")
    tensor = int(mesh.get("tensor", 1) or 1)
    if tensor > 1:
        hidden = int(cfg.model.hidden_nf)
        if hidden % tensor:
            raise ValueError(
                f"parallel.mesh.tensor={tensor} must divide "
                f"model.hidden_nf={hidden} (each rank owns a contiguous 1/T "
                f"hidden slice)")
        if cfg.model.model_name != "FastEGNN":
            raise ValueError(
                f"parallel.mesh.tensor > 1 is only implemented for "
                f"FastEGNN, not model.model_name={cfg.model.model_name!r}")
        if not bool(cfg.model.get("hoist_edge_mlp", True)):
            raise ValueError(
                "parallel.mesh.tensor > 1 requires model.hoist_edge_mlp=true "
                "(phi_e's tensor collective is the node-level gather of the "
                "hoisted products)")
        if bool(cfg.model.get("tanh", False)):
            raise ValueError(
                "parallel.mesh.tensor > 1 does not support model.tanh "
                "(phi_x's psum is deferred through linear ops only)")
    mdata = mesh.get("data")
    dp = int(cfg.data.data_parallel)
    if mdata is not None and dp != 1 and int(mdata) != dp:
        raise ValueError(
            f"parallel.mesh.data={int(mdata)} conflicts with "
            f"data.data_parallel={dp} — set one of them")


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
    _check_mesh(cfg)
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
    tr = cfg.train
    if int(tr.accumulation_steps) < 1:
        raise ValueError("train.accumulation_steps must be >= 1")
    resume = tr.get("resume")
    if resume is not None and not isinstance(resume, str):
        raise ValueError("train.resume must be null, 'auto', or a checkpoint "
                         "path")
    if float(tr.get("checkpoint_interval_s", 0) or 0) < 0:
        raise ValueError("train.checkpoint_interval_s must be >= 0")
    if int(tr.get("keep_checkpoints", 3)) < 1:
        raise ValueError("train.keep_checkpoints must be >= 1")
    if int(tr.epochs) < 0 or int(tr.early_stop) < 1:
        raise ValueError("train.epochs must be >= 0 and train.early_stop >= 1")
    if float(tr.mmd.sigma) <= 0 or int(tr.mmd.samples) < 1:
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
    sl = cfg.get("slo")
    if sl is not None:
        if not isinstance(sl.get("enable", True), bool):
            raise ValueError("slo.enable must be a boolean")
        from distegnn_tpu_torch.obs.slo import SLOSpec

        try:
            # SLOSpec.from_mapping owns the threshold/route validation;
            # surface its message under the config-section idiom
            SLOSpec.from_mapping(dict(sl))
        except ValueError as exc:
            raise ValueError(str(exc)) from None
    s = cfg.get("serve")
    if s is None:
        return  # hand-built config without the serving section
    if float(s.growth) <= 1.0:
        raise ValueError("serve.growth must be > 1")
    if int(s.max_batch) < 1 or int(s.cache_size) < 1:
        raise ValueError("serve.max_batch and serve.cache_size must be >= 1")
    if int(s.queue_capacity) < 1:
        raise ValueError("serve.queue_capacity must be >= 1")
    if float(s.batch_deadline_ms) < 0 or float(s.request_timeout_ms) <= 0:
        raise ValueError("serve.batch_deadline_ms must be >= 0 and "
                         "serve.request_timeout_ms > 0")
    if s.donate not in (True, False, "auto"):
        raise ValueError("serve.donate must be true, false, or 'auto'")
    if float(s.get("result_margin_s", 30.0)) <= 0:
        raise ValueError("serve.result_margin_s must be > 0")
    if int(s.get("session_cache", 0)) < 0:
        raise ValueError("serve.session_cache must be >= 0 (0 disables)")
    if int(s.get("session_cache_bytes", 0) or 0) < 0:
        raise ValueError("serve.session_cache_bytes must be >= 0 "
                         "(0 = unbounded by bytes)")
    t = s.get("tiled")
    if t is not None:
        if not isinstance(t, Mapping):
            raise ValueError("serve.tiled must be null or a mapping of "
                             "tiled-executor knobs")
        tknown = ("enable", "max_nodes", "tile_nodes", "halo_floor",
                  "edge_floor", "growth", "timeout_factor", "devices")
        for key in t:
            if key not in tknown:
                raise ValueError(f"serve.tiled: unknown key {key!r} "
                                 f"(accepted: {', '.join(tknown)})")
        if not isinstance(t.get("enable", False), bool):
            raise ValueError("serve.tiled.enable must be a boolean")
        for key in ("max_nodes", "tile_nodes", "halo_floor", "edge_floor"):
            if int(t.get(key, 1)) < 1:
                raise ValueError(f"serve.tiled.{key} must be >= 1")
        if int(t.get("tile_nodes", 65536)) > int(t.get("max_nodes",
                                                       4_194_304)):
            raise ValueError("serve.tiled.tile_nodes must be <= "
                             "serve.tiled.max_nodes")
        if float(t.get("growth", 2.0)) <= 1.0:
            raise ValueError("serve.tiled.growth must be > 1")
        if float(t.get("timeout_factor", 8.0)) < 1.0:
            raise ValueError("serve.tiled.timeout_factor must be >= 1")
        td = t.get("devices", 1)
        if td != "auto" and (isinstance(td, bool) or not isinstance(td, int)
                             or td < 1):
            raise ValueError("serve.tiled.devices must be 'auto' or an "
                             "int >= 1")
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
    if int(s.get("replicas", 1) or 1) < 1:
        raise ValueError("serve.replicas must be >= 1")
    if str(s.get("workers", "thread") or "thread") not in ("thread",
                                                           "process"):
        raise ValueError("serve.workers must be 'thread' or 'process'")
    w = s.get("worker")
    if w is not None:
        if not isinstance(w, Mapping):
            raise ValueError("serve.worker must be null or a mapping of "
                             "process-worker knobs")
        wknown = ("spawn_timeout_s", "heartbeat_s", "kill_grace_s")
        for key in w:
            if key not in wknown:
                raise ValueError(f"serve.worker: unknown key {key!r} "
                                 f"(accepted: {', '.join(wknown)})")
        for key in wknown:
            if key in w and float(w[key]) <= 0:
                raise ValueError(f"serve.worker.{key} must be > 0")
    sup = s.get("supervisor")
    if sup is not None:
        if not isinstance(sup, Mapping):
            raise ValueError("serve.supervisor must be null or a mapping of "
                             "ReplicaSupervisor kwargs")
        known = ("heartbeat_s", "wedge_timeout_s",
                 "worker_heartbeat_timeout_s", "backoff_base_s",
                 "backoff_max_s", "breaker_threshold", "breaker_cooldown_s",
                 "healthy_reset_s")
        for key in sup:
            if key not in known:
                raise ValueError(f"serve.supervisor: unknown key {key!r} "
                                 f"(accepted: {', '.join(known)})")
        for key in known:
            if key in sup and float(sup[key]) <= 0:
                raise ValueError(f"serve.supervisor.{key} must be > 0")
        if int(sup.get("breaker_threshold", 3)) < 1:
            raise ValueError("serve.supervisor.breaker_threshold must be >= 1")
    a = s.get("autoscale")
    if a is not None:
        if not isinstance(a, Mapping):
            raise ValueError("serve.autoscale must be null or a mapping of "
                             "ReplicaAutoscaler knobs")
        aknown = ("enable", "min_replicas", "max_replicas", "interval_s",
                  "scale_up_cooldown_s", "scale_down_cooldown_s", "step",
                  "queue_high", "shed_high", "p99_high_ms", "queue_low",
                  "idle_rounds", "drain_timeout_s")
        for key in a:
            if key not in aknown:
                raise ValueError(f"serve.autoscale: unknown key {key!r} "
                                 f"(accepted: {', '.join(aknown)})")
        if not isinstance(a.get("enable", False), bool):
            raise ValueError("serve.autoscale.enable must be a boolean")
        lo = int(a.get("min_replicas", 1))
        hi = int(a.get("max_replicas", 4))
        if lo < 1 or hi < lo:
            raise ValueError("serve.autoscale needs 1 <= min_replicas "
                             "<= max_replicas")
        if int(a.get("step", 1)) < 1 or int(a.get("idle_rounds", 3)) < 1:
            raise ValueError("serve.autoscale.step and "
                             "serve.autoscale.idle_rounds must be >= 1")
        for key in ("interval_s", "drain_timeout_s", "queue_high"):
            if float(a.get(key, 1.0)) <= 0:
                raise ValueError(f"serve.autoscale.{key} must be > 0")
        for key in ("scale_up_cooldown_s", "scale_down_cooldown_s",
                    "shed_high", "queue_low"):
            if float(a.get(key, 0.0)) < 0:
                raise ValueError(f"serve.autoscale.{key} must be >= 0")
        if a.get("p99_high_ms") is not None and float(a["p99_high_ms"]) <= 0:
            raise ValueError("serve.autoscale.p99_high_ms must be null "
                             "or > 0")
    p = s.get("priority")
    if p is not None:
        if not isinstance(p, Mapping):
            raise ValueError("serve.priority must be null or a mapping of "
                             "priority-admission knobs")
        pknown = ("enable", "header", "bulk_max_inflight_frac",
                  "degrade_shed_rate", "degrade_p99_ms", "bulk_retry_factor",
                  "bulk_content_bytes")
        for key in p:
            if key not in pknown:
                raise ValueError(f"serve.priority: unknown key {key!r} "
                                 f"(accepted: {', '.join(pknown)})")
        if not isinstance(p.get("enable", True), bool):
            raise ValueError("serve.priority.enable must be a boolean")
        if not str(p.get("header", "X-Priority")).strip():
            raise ValueError("serve.priority.header must be non-empty")
        frac = float(p.get("bulk_max_inflight_frac", 0.75))
        if not 0.0 < frac <= 1.0:
            raise ValueError("serve.priority.bulk_max_inflight_frac must be "
                             "in (0, 1]")
        if float(p.get("degrade_shed_rate", 0.05)) < 0:
            raise ValueError("serve.priority.degrade_shed_rate must be >= 0")
        if (p.get("degrade_p99_ms") is not None
                and float(p["degrade_p99_ms"]) <= 0):
            raise ValueError("serve.priority.degrade_p99_ms must be null "
                             "or > 0")
        if float(p.get("bulk_retry_factor", 4.0)) < 1:
            raise ValueError("serve.priority.bulk_retry_factor must be >= 1")
        if int(p.get("bulk_content_bytes", 0) or 0) < 0:
            raise ValueError("serve.priority.bulk_content_bytes must be "
                             ">= 0 (0 disables)")
    st = s.get("stream")
    if st is not None:
        if not isinstance(st, Mapping):
            raise ValueError("serve.stream must be null or a mapping of "
                             "streaming-rollout knobs")
        for key in st:
            if key not in ("chunk_steps",):
                raise ValueError(f"serve.stream: unknown key {key!r} "
                                 f"(accepted: chunk_steps)")
        if int(st.get("chunk_steps", 8)) < 1:
            raise ValueError("serve.stream.chunk_steps must be >= 1")
    models = s.get("models")
    if models is not None:
        if not isinstance(models, (list, tuple)) or not models:
            raise ValueError("serve.models must be null or a non-empty list "
                             "of {name, config_path?, overrides?} entries")
        seen = set()
        for item in models:
            if not isinstance(item, Mapping) or not item.get("name"):
                raise ValueError("each serve.models entry needs a 'name'")
            name = str(item["name"])
            if name in seen:
                raise ValueError(f"duplicate serve.models name {name!r}")
            seen.add(name)
            for key in item:
                if key not in ("name", "config_path", "overrides"):
                    raise ValueError(f"serve.models[{name!r}]: unknown key "
                                     f"{key!r}")
            if item.get("overrides") is not None and not isinstance(
                    item["overrides"], Mapping):
                raise ValueError(f"serve.models[{name!r}].overrides must be "
                                 "a mapping")
    g = s.get("gateway")
    if g is not None:
        if int(g.get("max_inflight", 64)) < 1:
            raise ValueError("serve.gateway.max_inflight must be >= 1")
        if not 0 <= int(g.get("port", 8008)) <= 65535:
            raise ValueError("serve.gateway.port must be in [0, 65535]")
        if float(g.get("drain_grace_s", 10.0)) < 0:
            raise ValueError("serve.gateway.drain_grace_s must be >= 0")
        nodes = g.get("warmup_nodes", [48, 96])
        if (not isinstance(nodes, (list, tuple)) or not nodes
                or any(int(n) < 2 for n in nodes)):
            raise ValueError("serve.gateway.warmup_nodes must be a "
                             "non-empty list of node counts >= 2")
    pm = cfg.get("promote")
    if pm is not None:
        if not isinstance(pm, Mapping):
            raise ValueError("promote must be null or a mapping of "
                             "promotion-conveyor knobs")
        pmknown = ("enable", "publish", "watch_dir", "model", "interval_s",
                   "history", "shadow_sample", "min_shadow",
                   "max_shadow_inflight", "gate_timeout_s", "drift_ceiling",
                   "max_error_rate")
        for key in pm:
            if key not in pmknown:
                raise ValueError(f"promote: unknown key {key!r} "
                                 f"(accepted: {', '.join(pmknown)})")
        for flag in ("enable", "publish"):
            if not isinstance(pm.get(flag, False), bool):
                raise ValueError(f"promote.{flag} must be a boolean")
        for skey in ("watch_dir", "model"):
            if not isinstance(pm.get(skey, ""), str):
                raise ValueError(f"promote.{skey} must be a string")
        for key in ("interval_s", "gate_timeout_s", "drift_ceiling"):
            if float(pm.get(key, 1.0)) <= 0:
                raise ValueError(f"promote.{key} must be > 0")
        for key in ("history", "min_shadow", "max_shadow_inflight"):
            if int(pm.get(key, 1)) < 1:
                raise ValueError(f"promote.{key} must be >= 1")
        if not 0.0 < float(pm.get("shadow_sample", 0.25)) <= 1.0:
            raise ValueError("promote.shadow_sample must be in (0, 1]")
        if float(pm.get("max_error_rate", 0.0)) < 0:
            raise ValueError("promote.max_error_rate must be >= 0")
        if ((pm.get("enable") or pm.get("publish"))
                and not str(pm.get("watch_dir", "")).strip()):
            raise ValueError("promote.watch_dir is required when "
                             "promote.enable or promote.publish is set")


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
    # the data axis's size (data.data_parallel) and the tensor axis's
    # (parallel.mesh.tensor)
    "data_parallel": ("data.data_parallel", int),
    "tensor_parallel": ("parallel.mesh.tensor", int),
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
