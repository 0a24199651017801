"""InferenceEngine — bucketed one-step prediction and K-step rollouts (port
of ``distegnn_tpu/serve/engine.py``).

Every request batch is padded to a BucketLadder rung and its batch axis to
``max_batch`` by replicating the first graph, exactly as in the JAX engine.
PyTorch runs eagerly, so there is no compile cache to hold. The engine keeps
the JAX cache's bookkeeping all the same: an LRU of ``cache_size`` shape
keys (``shapes_seen``, the keys JAX compiles one executable for), with the
hits, misses and evictions that JAX's cache would count for the same
request sequence (:meth:`cache_stats`, the ``serve/cache_*`` counters).

``rollout`` / ``rollout_batch`` run K autoregressive steps through
``rollout.make_rollout_fn`` / ``make_batched_rollout_fn`` (the radius graph
rebuilt on the device every step, in the blocked layout); the per-step
capacity overflow flags are read once after the K steps and raised as
RolloutOverflowError, never dropped. ``rollout_stream`` runs one scene in
chunks with the carry threaded on the host, so a consumer sees the first
chunk early and can cancel between chunks.

The parameters live in ``self.model``; ``params`` reads them as a
``state_dict`` and assigning ``params`` installs a new module holding the
given values (the old module is never written, so a blue/green rollback to
the old dict is exact, and a dispatcher mid-forward keeps the module it
started with). :meth:`canary` runs candidate parameters on a copy of the
module without installing them.

Later slices of the port: CUDA graphs per (rung, steps) in place of the JAX
engine's per-(rung, steps) jit cache, and the tiled executor.
"""

from __future__ import annotations

import copy
import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.serve.buckets import (Bucket, BucketLadder,
                                              synthetic_graph)
from distegnn_tpu_torch.serve.metrics import ServeMetrics


def _rid_attrs(request_ids: Optional[Sequence[str]]) -> dict:
    """serve/execute span attrs for a batch's trace ids; {} when the batch
    carries none (in-process callers), so untraced events stay compact."""
    ids = [r for r in (request_ids or []) if r is not None]
    return {"request_ids": ids} if ids else {}


class RolloutOverflowError(RuntimeError):
    """A rollout step overflowed the static radius-graph capacity bounds
    (max_per_cell / max_degree) — results would silently drop edges."""


class CanaryError(RuntimeError):
    """The blue/green canary forward rejected candidate parameters
    (non-finite outputs or a shape mismatch): the swap must roll back."""


class MixedRolloutStepsError(ValueError):
    """A rollout micro-batch mixed different steps-K: scenes with different
    K never share a batch (the batcher keys on (rung, steps)); hitting it
    through ``rollout_batch`` directly is a caller bug."""




class InferenceEngine:
    """Bucketed inference over one model on one device.

    Args:
      model: a module whose ``forward(GraphBatch)`` returns a tuple with the
        predicted positions ``[B, N, 3]`` first; it is moved to ``device``.
      device: where the model runs (``torch.device``).
      ladder: BucketLadder (default: serving defaults).
      max_batch: the padded batch of every forward.
      cache_size: the LRU bound on shape keys (JAX's live executables).
      metrics: the ServeMetrics the engine records into (shared with the
        queue and the other replicas of the model).
      layout_opts: kwargs forwarded to ``ladder.pad_batch`` (edge_block,
        edge_tile, split_remote) — a model with ``edge_impl='fused'`` needs
        ``{'edge_block': 512, 'split_remote': True}``.
      rollout_opts: kwargs forwarded to ``make_rollout_fn`` (radius,
        max_degree, max_per_cell, edge_block, ...) — required for
        ``rollout``.
      session_cache / session_cache_bytes: the session prep cache
        (serve/prep.py) as ``engine.prep_cache``; 0 entries disables it.
    """

    def __init__(self, model: torch.nn.Module, device: torch.device, *,
                 ladder: Optional[BucketLadder] = None, max_batch: int = 8,
                 cache_size: int = 32,
                 metrics: Optional[ServeMetrics] = None,
                 layout_opts: Optional[dict] = None,
                 rollout_opts: Optional[dict] = None,
                 session_cache: int = 0, session_cache_bytes: int = 0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if cache_size < 1:
            raise ValueError("cache_size must be >= 1")
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.ladder = ladder or BucketLadder()
        self.max_batch = int(max_batch)
        self.cache_size = int(cache_size)
        self.metrics = metrics or ServeMetrics()
        self._layout_opts = dict(layout_opts or {})
        self._rollout_opts = dict(rollout_opts or {})
        if session_cache:
            from distegnn_tpu_torch.serve.prep import SessionPrepCache

            self.prep_cache = SessionPrepCache(
                int(session_cache), ladder=self.ladder,
                layout_opts=self._layout_opts, metrics=self.metrics,
                max_bytes=int(session_cache_bytes))
        else:
            self.prep_cache = None
        # the shape key includes the edge path and, for fused_stack, the
        # depth, as the JAX executable's identity does
        impl = str(getattr(model, "edge_impl", "plain") or "plain")
        self._stack_key: Tuple = (
            impl, int(getattr(model, "n_layers", 0) or 0)
            if impl == "fused_stack" else 0)
        self.shapes_seen: "OrderedDict[Tuple, None]" = OrderedDict()
        self._lock = threading.Lock()

    # ---- the shape-key LRU (JAX's compile cache, counted) ---------------
    def _touch(self, key: Tuple) -> None:
        with self._lock:
            if key in self.shapes_seen:
                self.shapes_seen.move_to_end(key)
                self.metrics.cache_event(hit=True)
                return
            evicted = 0
            while len(self.shapes_seen) >= self.cache_size:
                self.shapes_seen.popitem(last=False)
                evicted += 1
            self.shapes_seen[key] = None
            self.metrics.cache_event(hit=False, evicted=evicted)
            obs.event("serve/cache_miss", key=repr(key), evicted=evicted)

    def cache_stats(self) -> Dict[str, int]:
        with self._lock:
            live = len(self.shapes_seen)
        snap = self.metrics.snapshot()
        return {"live": live, "hits": int(snap["cache_hits"]),
                "misses": int(snap["cache_misses"]),
                "evictions": int(snap["cache_evictions"])}

    def _predict_key(self, batch) -> Tuple:
        rpad = (batch.remote_edge_mask.shape[-1]
                if batch.remote_edge_mask is not None else 0)
        return (("predict", batch.max_nodes, batch.max_edges,
                 batch.edge_block, rpad, self.max_batch) + self._stack_key)

    # ---- parameters -------------------------------------------------------
    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The serving parameters (the module's ``state_dict``)."""
        return self.model.state_dict()

    @params.setter
    def params(self, new: Dict[str, torch.Tensor]) -> None:
        self.model = self._module_with(new)

    def _module_with(self, params: Dict[str, torch.Tensor]) -> torch.nn.Module:
        """A copy of the module holding ``params`` (the served one is never
        written: a forward running on it keeps its parameters)."""
        m = copy.deepcopy(self.model)
        m.load_state_dict(params)
        return m.to(self.device).eval()

    def params_digest(self) -> str:
        """16-byte blake2b over the parameters (shape- and dtype-tagged, in
        the ``state_dict``'s fixed order): the cross-replica fingerprint."""
        h = hashlib.blake2b(digest_size=16)
        for name, t in self.model.state_dict().items():
            arr = t.detach().cpu().numpy()
            h.update(name.encode())
            h.update(str(arr.shape).encode())
            h.update(str(arr.dtype).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()

    # ---- one-step prediction ---------------------------------------------
    def predict_batch(self, graphs: Sequence[dict],
                      bucket: Optional[Bucket] = None,
                      request_ids: Optional[Sequence[str]] = None,
                      ) -> List[np.ndarray]:
        """One model step over same-bucket graphs; returns the UNPADDED
        per-graph predicted positions ``[n_i, 3]`` (numpy, host-synced).
        ``request_ids`` (gateway trace ids, aligned with ``graphs``) are
        stamped on the ``serve/execute`` span."""
        if not graphs:
            return []
        if len(graphs) > self.max_batch:
            raise ValueError(
                f"{len(graphs)} graphs > max_batch {self.max_batch}")
        if bucket is None:
            bs = [self.ladder.bucket_of_graph(g) for g in graphs]
            # elementwise max: the rung admitting every graph on both axes
            bucket = Bucket(max(b.n for b in bs), max(b.e for b in bs))
        batch, n_real = self.ladder.pad_batch(graphs, bucket, self.max_batch,
                                              **self._layout_opts)
        self._touch(self._predict_key(batch))
        model = self.model
        with obs.span("serve/execute", n=batch.max_nodes, e=batch.max_edges,
                      filled=n_real, capacity=self.max_batch,
                      **_rid_attrs(request_ids)):
            with torch.no_grad():
                x = model(batch.to(self.device))[0]          # [B, N, 3]
            x = x.cpu().numpy()
        return [x[i, : graphs[i]["loc"].shape[0]].copy()
                for i in range(n_real)]

    def predict(self, graph: dict) -> np.ndarray:
        """Single-graph convenience wrapper over ``predict_batch``."""
        return self.predict_batch([graph])[0]

    def warmup(self, sizes: Sequence[Tuple[int, int]]) -> List[Bucket]:
        """Run one probe batch per distinct rung admitting the given
        (n_nodes, n_edges) sizes: kernel builds and library handles are
        set up before the first request. Returns the warmed buckets."""
        warmed: List[Bucket] = []
        with obs.span("serve/warmup", rungs=0) as sp:
            for n, e in sizes:
                b = self.ladder.bucket_for(n, e)
                if b in warmed:
                    continue
                g = synthetic_graph(2, seed=0, feat_nf=self._probe_feat_nf(),
                                    edge_attr_nf=self._probe_edge_attr_nf())
                self.predict_batch([g], bucket=b)
                warmed.append(b)
            sp.set(rungs=len(warmed))
        return warmed

    def _probe_feat_nf(self) -> int:
        return int(getattr(self.model, "node_feat_nf", 1) or 1)

    def _probe_edge_attr_nf(self) -> int:
        return int(getattr(self.model, "edge_attr_nf", 2) or 0)

    # ---- blue/green canary ------------------------------------------------
    def canary(self, params: Dict[str, torch.Tensor],
               buckets: Sequence[Bucket]) -> int:
        """Forward CANDIDATE parameters through each bucket on a synthetic
        graph without installing them (a copy of the module holds them).

        Touches the same shape keys as ``predict_batch``, so canarying the
        warmed rungs adds no key. Raises :class:`CanaryError` on non-finite
        outputs or a shape mismatch; returns the number of rungs checked."""
        g = synthetic_graph(2, seed=0, feat_nf=self._probe_feat_nf(),
                            edge_attr_nf=self._probe_edge_attr_nf())
        cand = self._module_with(params)
        checked = 0
        for b in buckets or [self.ladder.bucket_of_graph(g)]:
            batch, _ = self.ladder.pad_batch([g], b, self.max_batch,
                                             **self._layout_opts)
            self._touch(self._predict_key(batch))
            with torch.no_grad():
                out = cand(batch.to(self.device))[0].cpu().numpy()
            if out.shape != (self.max_batch, batch.max_nodes, 3):
                raise CanaryError(
                    f"canary output shape {out.shape} != expected "
                    f"{(self.max_batch, batch.max_nodes, 3)} on rung {b}")
            n_real = int(g["loc"].shape[0])
            if not np.isfinite(out[0, :n_real]).all():
                raise CanaryError(
                    f"canary produced non-finite outputs on rung {b} "
                    f"(candidate params are poisoned)")
            checked += 1
        return checked

    # ---- K-step rollout ------------------------------------------------
    @property
    def rollout_enabled(self) -> bool:
        """True when the engine was built with rollout_opts."""
        return bool(self._rollout_opts)

    def _rollout_fn_opts(self) -> dict:
        """rollout_opts resolved against the MODEL's feature widths: the
        rollout defaults (speed [N, 1], distance twice [E, 2]) fit only
        models of those widths, so when the config pins no feature_fn /
        edge_attr_fn they are widened to match."""
        opts = dict(self._rollout_opts)
        nf = self._probe_feat_nf()
        if "feature_fn" not in opts and nf != 1:
            opts["feature_fn"] = lambda v: torch.linalg.norm(
                v, dim=-1, keepdim=True).repeat_interleave(nf, dim=-1)
        ef = self._probe_edge_attr_nf()
        if "edge_attr_fn" not in opts and ef != 2:
            def edge_attr_fn(x, ei, em, _ef=max(ef, 1)):
                d = torch.linalg.norm(x[ei[0].long()] - x[ei[1].long()],
                                      dim=-1, keepdim=True)
                return d.repeat_interleave(_ef, dim=-1) * em[:, None]

            opts["edge_attr_fn"] = edge_attr_fn
        return opts

    def rollout_rung(self, n: int) -> int:
        """Padded node count of the rollout path for a scene of ``n``
        nodes: the node-ladder rung rounded up to a multiple of the rollout
        edge_block. The batcher groups rollouts on it (and steps)."""
        if not self._rollout_opts:
            raise ValueError("engine built without rollout_opts; pass "
                             "rollout_opts={'radius': ..., 'max_degree': ...}")
        edge_block = int(self._rollout_opts.get("edge_block", 256))
        rung = self.ladder._rung(n, self.ladder.node_floor,
                                 self.ladder.node_multiple,
                                 self.ladder.max_nodes, "nodes")
        return -(-max(rung, edge_block) // edge_block) * edge_block

    def _scene_arrays(self, loc0, vel0, node_mask, n_pad: int):
        n = int(loc0.shape[0])
        loc_p = np.zeros((n_pad, 3), np.float32)
        vel_p = np.zeros((n_pad, 3), np.float32)
        mask = np.zeros((n_pad,), np.float32)
        loc_p[:n], vel_p[:n] = loc0, vel0
        mask[:n] = (node_mask if node_mask is not None
                    else np.ones(n)).astype(np.float32)
        return loc_p, vel_p, mask

    def _run_rollout(self, loc_p, vel_p, mask, steps: int):
        """One unbatched K-step rollout on the device -> (traj, over) numpy."""
        from distegnn_tpu_torch.rollout import make_rollout_fn

        ro = make_rollout_fn(self.model, **self._rollout_fn_opts())
        traj, over = ro(*(torch.from_numpy(a).to(self.device)
                          for a in (loc_p, vel_p, mask)), steps=int(steps))
        return traj.cpu().numpy(), over.cpu().numpy()

    def rollout(self, loc0: np.ndarray, vel0: np.ndarray, steps: int,
                node_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """K-step autoregressive rollout of one graph; returns the UNPADDED
        trajectory [steps, n, 3]. Raises RolloutOverflowError if any step
        overflowed the static neighbour-capacity bounds."""
        n = int(loc0.shape[0])
        n_pad = self.rollout_rung(n)
        arrays = self._scene_arrays(loc0, vel0, node_mask, n_pad)
        self._touch(("rollout", n_pad, int(steps)) + self._stack_key)
        traj, over = self._run_rollout(*arrays, steps=int(steps))
        if over.any():
            self.metrics.failed()
            raise RolloutOverflowError(
                f"rollout overflowed radius-graph capacity at steps "
                f"{np.nonzero(over)[0].tolist()}; raise "
                f"max_degree/max_per_cell in rollout_opts")
        return traj[:, :n]

    def rollout_batch(self, scenes: Sequence[dict],
                      request_ids: Optional[Sequence[str]] = None,
                      ) -> List[np.ndarray]:
        """Batched K-step rollout over same-rung scenes.

        Each scene dict carries ``loc`` [n, 3], ``vel`` [n, 3], ``steps``
        (int), and optionally ``node_mask`` [n]. All scenes MUST share the
        same ``steps`` — mixing raises :class:`MixedRolloutStepsError`.
        Scenes are padded to one common node rung and the scene axis to
        ``max_batch`` (replicating scene 0, copies discarded). Returns the
        per-scene UNPADDED trajectories [steps, n_i, 3]."""
        if not scenes:
            return []
        if len(scenes) > self.max_batch:
            raise ValueError(
                f"{len(scenes)} scenes > max_batch {self.max_batch}")
        from distegnn_tpu_torch.rollout import make_batched_rollout_fn

        steps_set = {int(s["steps"]) for s in scenes}
        if len(steps_set) != 1:
            raise MixedRolloutStepsError(
                f"rollout batch mixes steps {sorted(steps_set)}; scenes with "
                f"different K cannot share a compiled scan")
        steps = steps_set.pop()
        ns = [int(s["loc"].shape[0]) for s in scenes]
        n_pad = max(self.rollout_rung(n) for n in ns)
        B = self.max_batch
        loc_p = np.zeros((B, n_pad, 3), np.float32)
        vel_p = np.zeros((B, n_pad, 3), np.float32)
        mask = np.zeros((B, n_pad), np.float32)
        for i, (s, n) in enumerate(zip(scenes, ns)):
            loc_p[i, :n], vel_p[i, :n] = s["loc"], s["vel"]
            nm = s.get("node_mask")
            mask[i, :n] = (nm if nm is not None
                           else np.ones(n)).astype(np.float32)
        # fill the pad slots with scene 0 so the replicated work is
        # well-posed (an all-zero scene would pile every node into one cell)
        for i in range(len(scenes), B):
            loc_p[i], vel_p[i], mask[i] = loc_p[0], vel_p[0], mask[0]
        self._touch(("rollout_batch", n_pad, steps, B) + self._stack_key)
        ro = make_batched_rollout_fn(self.model, **self._rollout_fn_opts())
        with obs.span("serve/execute", n=n_pad, e=0, filled=len(scenes),
                      capacity=B, workload="rollout", steps=steps,
                      **_rid_attrs(request_ids)):
            traj, over = ro(*(torch.from_numpy(a).to(self.device)
                              for a in (loc_p, vel_p, mask)), steps=steps)
            traj = traj.cpu().numpy()                # [B, steps, n_pad, 3]
        over = over.cpu().numpy()[: len(scenes)]     # replicas don't count
        if over.any():
            self.metrics.failed()
            bad = [(int(i), np.nonzero(over[i])[0].tolist())
                   for i in np.nonzero(over.any(axis=1))[0]]
            raise RolloutOverflowError(
                f"batched rollout overflowed radius-graph capacity "
                f"(scene, steps): {bad}; raise max_degree/max_per_cell in "
                f"rollout_opts")
        return [traj[i, :, :n].copy() for i, n in enumerate(ns)]

    def rollout_stream(self, scene: dict, emit,
                       request_id: Optional[str] = None) -> dict:
        """Chunked K-step rollout of ONE scene, delivering the trajectory
        through ``emit`` (a ``serve.queue.StreamSink``-shaped object:
        ``put_chunk(start_step, traj)`` and a ``cancelled`` flag polled
        between chunks).

        The steps run as successive ``chunk_steps``-long rollouts with the
        (loc, vel) carry threaded on the host — the per-step update of one
        long rollout (``v_next = (x_next - x) * velocity_scale`` under
        ``velocity_from_delta``) — so the first chunk arrives after ~chunk/K
        of the work and a cancel stops the rest at the next chunk boundary.
        The shape key is the single-scene ``("rollout", n_pad, chunk)``.
        Returns a summary dict (steps_total / steps_done / cancelled /
        chunk_steps)."""
        steps = int(scene["steps"])
        chunk = max(1, int(scene.get("chunk_steps", 8) or 8))
        n = int(scene["loc"].shape[0])
        n_pad = self.rollout_rung(n)
        opts = self._rollout_fn_opts()
        vel_from_delta = bool(opts.get("velocity_from_delta", True))
        vscale = float(opts.get("velocity_scale", 1.0))
        loc_p, vel_p, mask = self._scene_arrays(
            scene["loc"], scene["vel"], scene.get("node_mask"), n_pad)

        done = 0
        while done < steps:
            if getattr(emit, "cancelled", False):
                break
            c = min(chunk, steps - done)
            self._touch(("rollout", n_pad, c) + self._stack_key)
            with obs.span("serve/execute", n=n_pad, e=0, filled=1,
                          capacity=1, workload="rollout_stream", steps=c,
                          **_rid_attrs([request_id])):
                traj, over = self._run_rollout(loc_p, vel_p, mask, steps=c)
            if over.any():
                self.metrics.failed()
                raise RolloutOverflowError(
                    f"streamed rollout overflowed radius-graph capacity at "
                    f"steps {(done + np.nonzero(over)[0]).tolist()}"
                    f"; raise max_degree/max_per_cell in rollout_opts")
            # thread the carry exactly as the rollout's step would have
            prev = loc_p if c == 1 else traj[c - 2]
            new_loc = traj[c - 1].copy()
            if vel_from_delta:
                vel_p = ((new_loc - prev) * vscale).astype(np.float32)
            loc_p = new_loc
            emit.put_chunk(done, traj[:, :n].copy())
            done += c
        return {"steps_total": steps, "steps_done": done,
                "cancelled": done < steps, "chunk_steps": chunk}
