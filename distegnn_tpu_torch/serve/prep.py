"""Session-affinity graph-prep cache (port of ``distegnn_tpu/serve/prep.py``):
skip the re-layout of repeat topologies.

Interactive clients stream many requests for the SAME scene: positions move
every frame, but the edge topology, and so everything expensive about graph
prep (Morton relabel, blocked re-pack, remote-edge classification, bucket
assignment), is identical or changes rarely.

:class:`SessionPrepCache` is a per-model LRU keyed on the client's
``session_id``. Each entry holds a :class:`PrepPlan`: the topology-only
layout (``ops.blocked.RepackPlan``, the remote selection indices, the ladder
bucket). A hit re-applies the plan to the fresh arrays with fancy-index
gathers only, and the produced dict carries the ``_blockified`` stamp so
``prepare_blocked_graph`` inside ``pad_graphs`` is a no-op.

Correctness:
  - The plan is validated against a topology fingerprint (n, e, dtype and a
    digest of the edge_index bytes); a changed topology is a clean miss.
  - Hit and miss produce identical prepared dicts: the cache changes
    latency, never results.
  - The Morton perm is computed from the positions seen when the plan was
    built; any permutation is correct (the gateway inverts it before it
    answers), later frames only drift from the spatially best one.

Plan arrays are shared across requests and never written: the apply path
allocates fresh per-request arrays.

Hits, misses and evictions are recorded on the engine's ``ServeMetrics``
(``session_hits`` / ``session_misses`` / ``session_evictions``). Capacity is
bounded by an entry count (``serve.session_cache``) and, independently, by
the plans' bytes (``serve.session_cache_bytes``, :func:`nbytes_of`), exported
as the ``serve/session_cache_bytes`` gauge. The tile plans of JAX's
``prepare_tile`` wait with the tiled executor.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.ops.blocked import (RepackPlan, max_block_degree,
                                      repack_blocked)
from distegnn_tpu_torch.serve.buckets import Bucket, BucketLadder
from distegnn_tpu_torch.serve.metrics import ServeMetrics


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def nbytes_of(obj) -> int:
    """Recursive host-memory estimate of a cached plan: every numpy array's
    ``nbytes``, walked through tuples/NamedTuples/lists/dicts. Scalars and
    tiny metadata round to 0 — arrays are what dominate a plan."""
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    if isinstance(obj, dict):
        return sum(nbytes_of(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(nbytes_of(v) for v in obj)
    return 0


def topology_fingerprint(edge_index: np.ndarray, n_nodes: int) -> tuple:
    """(n, e, digest) — positions excluded on purpose: a session's frames
    move, its topology (usually) doesn't."""
    ei = np.ascontiguousarray(edge_index)
    digest = hashlib.blake2b(ei.tobytes(), digest_size=16).digest()
    return (int(n_nodes), int(ei.shape[1]), ei.dtype.str, digest)


class PrepPlan(NamedTuple):
    """Topology-only prep artifacts for one session (one cache entry)."""

    fingerprint: tuple
    bucket: Bucket                   # from the RAW (n, e) — the submit rung
    repack: Optional[RepackPlan]     # blocked layouts; None for plain
    remote_sel: Optional[np.ndarray]  # row-sorted remote slot indices
    sort: Optional[np.ndarray]       # plain layouts: row-sort of raw edges
    edge_index: Optional[np.ndarray]  # plain layouts: the sorted edge list

    @property
    def perm(self) -> Optional[np.ndarray]:
        return self.repack.perm if self.repack is not None else None


class PrepResult(NamedTuple):
    graph: dict
    bucket: Bucket
    perm: Optional[np.ndarray]       # perm[new] = old; None for plain plans
    hit: bool


class SessionPrepCache:
    """LRU of `PrepPlan`s keyed by session id. Thread-safe (HTTP handlers
    call `prepare` concurrently); plan building runs outside the lock, so a
    slow build never blocks other sessions — two racing builds of the same
    session are both correct and the later insert wins."""

    def __init__(self, capacity: int, *, ladder: BucketLadder,
                 layout_opts: Optional[dict] = None,
                 metrics: Optional[ServeMetrics] = None, bits: int = 16,
                 max_bytes: int = 0):
        if capacity < 1:
            raise ValueError("SessionPrepCache: capacity must be >= 1")
        self.capacity = int(capacity)
        self.max_bytes = int(max_bytes)   # 0 = entry-count bound only
        self.ladder = ladder
        self.metrics = metrics
        self.bits = int(bits)
        opts = dict(layout_opts or {})
        self.edge_block = int(opts.get("edge_block", 0))
        self.edge_tile = int(opts.get("edge_tile", 512))
        self.split_remote = bool(opts.get("split_remote", False))
        self._plans: "OrderedDict[str, object]" = OrderedDict()
        self._sizes: dict = {}
        self._bytes = 0
        self._g_bytes = (metrics.registry.gauge("serve/session_cache_bytes")
                         if metrics is not None else None)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def _insert(self, key: str, plan) -> int:
        """LRU insert with byte accounting: frees the key's old entry (a
        same-session replace is not an eviction), then evicts from the LRU
        tail until both the entry-count and byte bounds admit the new plan.
        Returns the number of OTHER entries evicted."""
        size = nbytes_of(plan)
        with self._lock:
            if key in self._plans:
                self._bytes -= self._sizes.pop(key, 0)
                self._plans.pop(key)
            evicted = 0
            while self._plans and (
                    len(self._plans) >= self.capacity
                    or (self.max_bytes
                        and self._bytes + size > self.max_bytes)):
                k, _ = self._plans.popitem(last=False)
                self._bytes -= self._sizes.pop(k, 0)
                evicted += 1
            self._plans[key] = plan
            self._sizes[key] = size
            self._bytes += size
            if self._g_bytes is not None:
                self._g_bytes.set(self._bytes)
        return evicted

    # ---- plan building ---------------------------------------------------
    def _build(self, graph: dict, fp: tuple) -> PrepPlan:
        ei = np.asarray(graph["edge_index"])
        n = int(graph["loc"].shape[0])
        bucket = self.ladder.bucket_for(n, int(ei.shape[1]))
        if not self.edge_block:
            # plain layout: stable row-sort keeps pad_graphs on the
            # sorted-scatter lowering; nothing else is topology-derived
            sort = np.argsort(ei[0], kind="stable")
            return PrepPlan(fingerprint=fp, bucket=bucket, repack=None,
                            remote_sel=None, sort=sort,
                            edge_index=np.ascontiguousarray(ei[:, sort]))
        # blocked layout: mirror pad_batch's node snap exactly, then relabel
        # along the Morton curve and derive epb from the RELABELED rows (the
        # perm moves edges between blocks, so degree must be measured after)
        from distegnn_tpu_torch.ops.order import morton_perm

        nb = -(-bucket.n // self.edge_block)
        if self.split_remote:
            nb = max(nb, 3)  # the fused kernel's window spans 3 blocks
        N = nb * self.edge_block
        perm = morton_perm(np.asarray(graph["loc"]), bits=self.bits)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n, dtype=perm.dtype)
        ei2 = inv[ei.astype(np.int64, copy=False)]
        deg = max_block_degree(np.sort(ei2[0]), N, self.edge_block)
        epb = _round_up(max(deg, 1), self.edge_tile)
        plan = repack_blocked(ei2, None, n_nodes_padded=N, epb=epb,
                              block=self.edge_block)._replace(perm=perm)
        remote_sel = None
        if self.split_remote:
            from distegnn_tpu_torch.ops.edge_pipeline import remote_selection

            remote_sel = remote_selection(plan.edge_index,
                                          block=self.edge_block, n_nodes=N)
        return PrepPlan(fingerprint=fp, bucket=bucket, repack=plan,
                        remote_sel=remote_sel, sort=None, edge_index=None)

    # ---- plan application ------------------------------------------------
    def _apply(self, graph: dict, plan: PrepPlan) -> dict:
        g = dict(graph)
        loc = np.asarray(graph["loc"])
        # loc_mean is permutation-invariant; pin it before reordering so the
        # prepared dict never falls back to a mean over permuted copies
        if g.get("loc_mean") is None:
            g["loc_mean"] = loc.mean(axis=0)
        if plan.repack is None:
            g["edge_index"] = plan.edge_index
            if graph.get("edge_attr") is not None:
                g["edge_attr"] = np.ascontiguousarray(
                    np.asarray(graph["edge_attr"])[plan.sort])
            return g
        p = plan.repack
        for key in ("node_feat", "loc", "vel", "target", "node_attr"):
            if graph.get(key) is not None:
                g[key] = np.ascontiguousarray(np.asarray(graph[key])[p.perm])
        ea = graph.get("edge_attr")
        if ea is None:
            ea = np.zeros((graph["edge_index"].shape[1], 0), np.float32)
        g["edge_index"] = p.edge_index
        g["edge_attr"] = p.apply_edge_attr(np.asarray(ea))
        g["_edge_mask"] = p.edge_mask
        g["_edge_pair"] = None       # serve batches run compute_pair=False
        g["_blockified"] = p.stamp
        if plan.remote_sel is not None:
            g["_remote_sel"] = plan.remote_sel
        return g

    # ---- the entry point -------------------------------------------------
    def prepare(self, session_id: str, graph: dict,
                request_id: Optional[str] = None) -> PrepResult:
        """Lay out ``graph`` for the serve path, reusing the session's plan
        when its topology fingerprint still matches. ``request_id`` (the
        gateway's trace id) tags the ``serve/prep`` event so the waterfall
        stitcher sees the prep leg of a traced request."""
        t0 = time.perf_counter()
        fp = topology_fingerprint(graph["edge_index"], graph["loc"].shape[0])
        with self._lock:
            plan = self._plans.get(session_id)
            if plan is not None and plan.fingerprint == fp:
                self._plans.move_to_end(session_id)
                hit, evicted = True, 0
            else:
                plan = None
        if plan is None:
            plan = self._build(graph, fp)
            evicted = self._insert(session_id, plan)
            hit = False
        if self.metrics is not None:
            self.metrics.session_event(hit=hit, evicted=evicted)
        result = PrepResult(graph=self._apply(graph, plan),
                            bucket=plan.bucket, perm=plan.perm, hit=hit)
        attrs = {"request_id": request_id} if request_id is not None else {}
        obs.event("serve/prep", session=str(session_id), hit=hit,
                  dur_s=round(time.perf_counter() - t0, 6), **attrs)
        return result
