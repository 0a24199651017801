"""Multi-model routing (port of ``distegnn_tpu/serve/registry.py``):
name -> (replica set, warmup state).

One gateway process fronts N independently configured models (the
``serve.models:`` config list): each :class:`ModelEntry` owns a
:class:`~distegnn_tpu_torch.serve.replica.ReplicaSet` of ``serve.replicas``
(engine, queue) pairs sharing one ServeMetrics, plus warmup state. One
model's traffic, kernel builds or replica loss never perturbs another's
entries: the registry reports per-model health and the transport sheds ONLY
the broken model (typed 503 + Retry-After).

The registry is the routing table the HTTP transport resolves
``/v1/models/<name>/...`` against, and the lifecycle handle the gateway's
SIGTERM drain walks. ``stop(drain=True)`` drains every model CONCURRENTLY,
each bounded by the grace budget.

Parameters come from ``model.checkpoint`` when set (``train/checkpoint.py``
``load_params``); otherwise the entry draws them from the config seed
(``serve.engine_with_params_from_config``). :meth:`ModelRegistry.swap` is
the blue/green path: a params-only load, a per-rung canary, one-replica-at-
a-time flips and a rollback on any failure, without dropping the queue.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Dict, List, Optional, Sequence

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.serve.buckets import Bucket, synthetic_graph
from distegnn_tpu_torch.serve.engine import InferenceEngine
from distegnn_tpu_torch.serve.queue import RequestQueue
from distegnn_tpu_torch.serve.replica import ReplicaSet


class SwapError(RuntimeError):
    """A blue/green swap failed (restore or canary stage). ``rolled_back``
    is True when serving params are back to the pre-swap version — the
    gateway reports it so operators know nothing is half-flipped."""

    def __init__(self, msg: str, stage: str, rolled_back: bool):
        super().__init__(msg)
        self.stage = stage
        self.rolled_back = bool(rolled_back)


class SwapInProgressError(RuntimeError):
    """A swap is already running for this model (one at a time)."""


class ModelEntry:
    """One served model: a replica set + warmup/swap state, owned by a name.

    ``engine`` is the PRIMARY replica's engine — the stable handle for
    feature widths, the session prep cache, and capability flags (engines
    survive replica restarts; only queues are rebuilt). ``queue`` is the
    replica set itself, which duck-types RequestQueue, so the transport's
    routes work unchanged.
    """

    def __init__(self, name: str, engine: InferenceEngine,
                 queue: RequestQueue, feat_nf: int, edge_attr_nf: int,
                 config=None, extra_replicas: Sequence = (),
                 supervisor_opts: Optional[dict] = None):
        self.name = name
        self.engine = engine
        members = [(engine, queue)] + list(extra_replicas)
        self.replicas = ReplicaSet(name, members,
                                   supervisor_opts=supervisor_opts)
        self.feat_nf = int(feat_nf)
        self.edge_attr_nf = int(edge_attr_nf)
        self.config = config
        self.warmed: List[Bucket] = []
        self.state = "cold"            # cold -> ready | failed
        self.error: Optional[str] = None
        self.checkpoint: Optional[str] = None
        self.params_version = 0
        self._swap_lock = threading.Lock()
        # ``replica_factory(idx) -> Replica``: the autoscaler's scale-up
        # recipe, set by _build_entry (None for hand-built entries — those
        # sets are not elastically growable). Reads the entry's CURRENT
        # module at call time, so replicas added after a blue/green swap
        # come up on the live version.
        self.replica_factory = None

    @property
    def queue(self) -> ReplicaSet:
        return self.replicas

    def start(self) -> None:
        self.replicas.start()

    def stop(self, drain: bool = True, join_timeout_s: float = 30.0) -> None:
        self.replicas.stop(drain=drain, join_timeout_s=join_timeout_s)

    def warmup(self, nodes: Sequence[int]) -> None:
        """Run the rungs admitting synthetic graphs of the given node counts
        on EVERY replica engine (the CUDA kernels build on first use);
        flips state to 'ready' (or 'failed', kept servable so /v1/models
        can show WHY readiness is down)."""
        try:
            sizes = []
            for n in nodes:
                g = synthetic_graph(int(n), seed=0, feat_nf=self.feat_nf,
                                    edge_attr_nf=self.edge_attr_nf)
                sizes.append((int(g["loc"].shape[0]),
                              int(g["edge_index"].shape[1])))
            for r in self.replicas.replicas:
                warmed = r.warmup(sizes)
            self.warmed = warmed
            self.state = "ready"
        except Exception as exc:
            self.state, self.error = "failed", repr(exc)
            obs.event("gateway/warmup_failed", model=self.name,
                      error=repr(exc))

    def alive(self) -> bool:
        return self.replicas.alive()

    def add_replica(self, warm_sizes=None):
        """The autoscaler's scale-up unit. ``replica_factory`` reads the
        entry's module at build time, so a blue/green swap racing the build
        could hand the new replica the version the flip loop already
        retired — and never revisit it (the loop iterates the list as it
        was while the replica was still unappended). The post-append re-pin
        below runs under the swap lock, where the live version is stable,
        closing that window for every interleaving."""
        if self.replica_factory is None:
            raise RuntimeError(f"model '{self.name}' has no replica "
                               f"factory; its set is not growable")
        replica = self.replicas.add_replica(self.replica_factory,
                                            warm_sizes=warm_sizes)
        with self._swap_lock:   # blocks until any in-flight swap lands
            if replica.engine.model is not self.engine.model:
                replica.swap_params(str(self.checkpoint),
                                    self.engine.params, list(self.warmed))
                obs.event("gateway/scale_up_repin", model=self.name,
                          replica=replica.idx,
                          version=self.params_version)
        return replica

    @property
    def rollout_enabled(self) -> bool:
        return self.engine.rollout_enabled

    # ---- blue/green hot-swap ---------------------------------------------
    def swap(self, checkpoint) -> dict:
        """Swap serving params to ``checkpoint`` under load, blue/green:

        1. params-only load into a copy of the module
           (``train/checkpoint.py`` ``load_params``: a trainer checkpoint is
           verified first) — corrupt or shape-mismatched checkpoints fail
           HERE, serving params untouched;
        2. per-replica canary: forward the CANDIDATE params through every
           warmed rung on a synthetic graph (NaN/shape check) before that
           replica flips;
        3. one-at-a-time flips (each engine installs a new module; a batch
           running on the old one finishes on it — the queue never drops);
        4. any canary failure rolls every already-flipped replica back to
           the old params and raises :class:`SwapError` (rolled_back=True).
        """
        from distegnn_tpu_torch.train.checkpoint import load_params

        if not self._swap_lock.acquire(blocking=False):
            raise SwapInProgressError(
                f"a swap is already in progress for model '{self.name}'")
        try:
            obs.event("gateway/swap_begin", model=self.name,
                      path=str(checkpoint))
            old_params = self.engine.params
            try:
                cand = load_params(str(checkpoint),
                                   copy.deepcopy(self.engine.model))
                new_params = cand.state_dict()
            except Exception as exc:
                obs.event("gateway/swap_rollback", model=self.name,
                          stage="restore", flipped=0, error=repr(exc)[:300])
                raise SwapError(
                    f"swap restore failed for '{self.name}': {exc}",
                    stage="restore", rolled_back=True) from exc
            rungs = list(self.warmed)
            flipped: List = []
            try:
                for r in self.replicas.replicas:
                    # per-replica blue/green unit: the replica canaries and
                    # flips its OWN engine
                    checked = r.swap_params(str(checkpoint), new_params,
                                            rungs)
                    obs.event("gateway/swap_canary", model=self.name,
                              replica=r.idx, rungs=checked)
                    flipped.append(r)
                    obs.event("gateway/swap_flip", model=self.name,
                              replica=r.idx)
            except Exception as exc:
                for r in flipped:
                    r.swap_rollback(old_params)
                obs.event("gateway/swap_rollback", model=self.name,
                          stage="canary", flipped=len(flipped),
                          error=repr(exc)[:300])
                raise SwapError(
                    f"swap canary failed for '{self.name}': {exc}; rolled "
                    f"back {len(flipped)} flipped replica(s)",
                    stage="canary", rolled_back=True) from exc
            # ``self.engine`` is replica 0's engine: already flipped above
            self.checkpoint = str(checkpoint)
            self.params_version += 1
            obs.event("gateway/swap_done", model=self.name,
                      path=str(checkpoint), version=self.params_version,
                      replicas=len(self.replicas.replicas),
                      rungs_canaried=len(rungs))
            return {"model": self.name, "checkpoint": str(checkpoint),
                    "version": self.params_version,
                    "replicas": len(self.replicas.replicas),
                    "rungs_canaried": len(rungs)}
        finally:
            self._swap_lock.release()

    def describe(self) -> dict:
        snap = self.engine.metrics.snapshot()
        return {
            "name": self.name,
            "state": self.state,
            "error": self.error,
            "dispatcher_alive": self.alive(),
            "warmed_rungs": [[b.n, b.e] for b in self.warmed],
            "max_batch": self.engine.max_batch,
            "ladder": {"max_nodes": self.engine.ladder.max_nodes,
                       "max_edges": self.engine.ladder.max_edges},
            "queue_depth": self.replicas.depth(),
            "requests_completed": snap["requests_completed"],
            # clients read this to know whether rollout traffic is
            # servable or would 501
            "rollout": self.rollout_enabled,
            "replicas": self.replicas.health(),
            "replicas_available": self.replicas.available(),
            "params_version": self.params_version,
            "checkpoint": self.checkpoint,
        }


class ModelRegistry:
    """name -> ModelEntry routing table + one lifecycle handle."""

    def __init__(self, entries: Dict[str, ModelEntry]):
        if not entries:
            raise ValueError("ModelRegistry needs at least one model entry")
        self._entries = dict(entries)

    # ---- construction ----------------------------------------------------
    @classmethod
    def from_config(cls, cfg, default_name: str = "default",
                    device=None) -> "ModelRegistry":
        """Build from a config: the ``serve.models:`` list (each item a
        mapping with ``name`` + optional ``config_path``/``overrides``), or
        — when the list is absent — ONE entry from the config itself.
        ``device`` defaults to the card (and raises without one); pass
        ``"cpu"`` for the plain path."""
        from distegnn_tpu_torch.config import (ConfigDict, _merge,
                                               load_config, validate_config)

        models = cfg.serve.get("models") or None
        entries: Dict[str, ModelEntry] = {}
        if not models:
            entries[default_name] = cls._build_entry(default_name, cfg,
                                                     device)
            return cls(entries)
        for item in models:
            name = str(item["name"])
            if item.get("config_path"):
                m_cfg = load_config(str(item["config_path"]))
            else:
                m_cfg = ConfigDict(copy.deepcopy(cfg.to_dict()))
            overrides = item.get("overrides")
            if overrides:
                m_cfg = ConfigDict(_merge(m_cfg.to_dict(),
                                          dict(overrides)))
                validate_config(m_cfg)
            entries[name] = cls._build_entry(name, m_cfg, device)
        return cls(entries)

    @staticmethod
    def _build_entry(name: str, cfg, device=None) -> ModelEntry:
        from distegnn_tpu_torch.serve import (engine_from_config,
                                              engine_with_params_from_config,
                                              queue_from_config)
        from distegnn_tpu_torch.serve.metrics import ServeMetrics
        from distegnn_tpu_torch.serve.replica import Replica

        n_replicas = max(1, int(cfg.serve.get("replicas", 1) or 1))
        metrics = ServeMetrics()  # shared by every replica of this model
        # the deterministic recipe: seeded init, then an optional checkpoint
        model, engine = engine_with_params_from_config(cfg, device=device,
                                                       metrics=metrics)
        queue = queue_from_config(cfg, engine)
        feat_nf = int(cfg.model.node_feat_nf)
        edge_nf = int(cfg.model.edge_attr_nf)
        ckpt = cfg.model.get("checkpoint")
        if ckpt:
            obs.event("gateway/params_restored", model=name, path=str(ckpt))
        supervisor_opts = dict(cfg.serve.get("supervisor") or {})

        def replica_pair(module):
            # an engine + queue serving ``module`` (replicas share the
            # module object until a swap installs a new one per engine),
            # sharing the primary's prep cache so failed-over sessions keep
            # their hit rate
            eng_i = engine_from_config(cfg, module, engine.device,
                                       metrics=metrics)
            eng_i.prep_cache = engine.prep_cache
            return eng_i, queue_from_config(cfg, eng_i)

        extra = [replica_pair(model) for _ in range(n_replicas - 1)]
        entry = ModelEntry(name, engine, queue, feat_nf, edge_nf,
                           config=cfg, extra_replicas=extra,
                           supervisor_opts=supervisor_opts)
        if ckpt:
            entry.checkpoint = str(ckpt)

        def replica_factory(idx, _entry=entry):
            # a fresh engine + queue on the entry's CURRENT module
            # (post-swap correct)
            return Replica(idx, *replica_pair(_entry.engine.model))

        entry.replica_factory = replica_factory
        return entry

    @classmethod
    def single(cls, name: str, engine: InferenceEngine, queue: RequestQueue,
               feat_nf: int = 1, edge_attr_nf: int = 2) -> "ModelRegistry":
        """Wrap one pre-built engine/queue pair (the tests)."""
        return cls({name: ModelEntry(name, engine, queue, feat_nf,
                                     edge_attr_nf)})

    # ---- routing ---------------------------------------------------------
    def get(self, name: str) -> ModelEntry:
        return self._entries[name]      # KeyError -> the transport's 404

    def names(self) -> List[str]:
        return sorted(self._entries)

    def items(self):
        return sorted(self._entries.items())

    def __len__(self) -> int:
        return len(self._entries)

    # ---- blue/green hot-swap ---------------------------------------------
    def swap(self, name: str, checkpoint) -> dict:
        """Blue/green swap one model's params under load (KeyError -> the
        transport's 404; see :meth:`ModelEntry.swap`)."""
        return self._entries[name].swap(checkpoint)

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "ModelRegistry":
        for _, e in self.items():
            e.start()
        return self

    def warmup(self, nodes: Sequence[int]) -> None:
        for _, e in self.items():
            e.warmup(nodes)

    def stop(self, drain: bool = True,
             grace_s: Optional[float] = None) -> None:
        """Stop every model CONCURRENTLY (idempotent; safe from a SIGTERM
        handler thread racing other shutdown paths). Each model drains in
        parallel bounded by ``grace_s`` (default 30 s), so one wedged
        queue can't consume every other model's drain window."""
        budget = 30.0 if grace_s is None else max(float(grace_s), 0.1)
        entries = self.items()
        # phase 1 for EVERY model before any drain: stop the supervisors so
        # an in-flight restart can't revive a queue after its drain begins
        # (the supervisor also rechecks _supervised after any blocking
        # claim, covering a restart already past the flag)
        for _, e in entries:
            e.replicas.begin_stop()
        if len(entries) == 1:
            entries[0][1].stop(drain=drain, join_timeout_s=budget)
            return
        threads = []
        for _, e in entries:
            t = threading.Thread(target=e.stop, name=f"drain-{e.name}",
                                 kwargs=dict(drain=drain,
                                             join_timeout_s=budget),
                                 daemon=True)
            t.start()
            threads.append(t)
        deadline = time.monotonic() + budget + 5.0
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.1))

    # ---- health -----------------------------------------------------------
    def ready(self) -> bool:
        """All models warmed and their dispatcher threads alive."""
        return all(e.state == "ready" and e.alive()
                   for e in self._entries.values())

    def any_ready(self) -> bool:
        """At least one model is servable — the gateway keeps routing in
        degraded mode instead of flipping the whole fleet to 503."""
        return any(e.state == "ready" and e.alive()
                   for e in self._entries.values())

    def health(self) -> Dict[str, dict]:
        """Per-model readiness detail for /readyz's degraded reporting."""
        out: Dict[str, dict] = {}
        for name, e in self.items():
            out[name] = {
                "state": e.state,
                "ready": e.state == "ready" and e.alive(),
                "error": e.error,
                "replicas_available": e.replicas.available(),
                "replicas_total": len(e.replicas.replicas),
                # per-worker detail (threads report backend only; JAX's
                # process backend adds pid and heartbeat)
                "workers": [
                    {"replica": h["replica"],
                     "backend": h.get("backend", "thread"),
                     "pid": h.get("pid"),
                     "heartbeat_age_s": h.get("heartbeat_age_s"),
                     "restarts": h["restarts"],
                     "degraded": h.get("degraded", False)}
                    for h in e.replicas.health()],
            }
        return out

    def describe(self) -> dict:
        return {"models": [e.describe() for _, e in self.items()]}
