"""InferenceEngine — bucketed one-step prediction and K-step rollouts (port
of the predict and rollout paths of ``distegnn_tpu/serve/engine.py``).

Every request batch is padded to a BucketLadder rung and its batch axis to
``max_batch`` by replicating the first graph, exactly as in the JAX engine.
PyTorch runs eagerly, so there is no compile cache: the engine keeps the
shape key of each batch and counts the distinct shapes it has run
(``shapes_seen``), which is what the JAX engine's cache size would be.

``rollout`` / ``rollout_batch`` run K autoregressive steps through
``rollout.make_rollout_fn`` / ``make_batched_rollout_fn`` (the radius graph
rebuilt on the device every step, in the blocked layout); the per-step
capacity overflow flags are read once after the K steps and raised as
RolloutOverflowError, never dropped.

Later slices of the port: CUDA graphs per (rung, steps) in place of the JAX
engine's per-(rung, steps) jit cache, ``rollout_stream``, the tiled executor
and the blue/green canary.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from distegnn_tpu_torch.serve.buckets import (Bucket, BucketLadder,
                                              synthetic_graph)


class RolloutOverflowError(RuntimeError):
    """A rollout step overflowed the static radius-graph capacity bounds
    (max_per_cell / max_degree) — results would silently drop edges."""


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
      layout_opts: kwargs forwarded to ``ladder.pad_batch`` (edge_block,
        edge_tile, split_remote) — a model with ``edge_impl='fused'`` needs
        ``{'edge_block': 512, 'split_remote': True}``.
      rollout_opts: kwargs forwarded to ``make_rollout_fn`` (radius,
        max_degree, max_per_cell, edge_block, ...) — required for
        ``rollout``.
    """

    def __init__(self, model: torch.nn.Module, device: torch.device, *,
                 ladder: Optional[BucketLadder] = None, max_batch: int = 8,
                 layout_opts: Optional[dict] = None,
                 rollout_opts: Optional[dict] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.ladder = ladder or BucketLadder()
        self.max_batch = int(max_batch)
        self._layout_opts = dict(layout_opts or {})
        self._rollout_opts = dict(rollout_opts or {})
        self.shapes_seen: Set[Tuple] = set()

    def predict_batch(self, graphs: Sequence[dict],
                      bucket: Optional[Bucket] = None) -> List[np.ndarray]:
        """One model step over same-bucket graphs; returns the UNPADDED
        per-graph predicted positions ``[n_i, 3]`` (numpy, host-synced)."""
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
        rpad = (batch.remote_edge_mask.shape[-1]
                if batch.remote_edge_mask is not None else 0)
        self.shapes_seen.add(("predict", batch.max_nodes, batch.max_edges,
                              batch.edge_block, rpad, self.max_batch))
        with torch.no_grad():
            x = self.model(batch.to(self.device))[0]            # [B, N, 3]
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
        for n, e in sizes:
            b = self.ladder.bucket_for(n, e)
            if b in warmed:
                continue
            g = synthetic_graph(2, seed=0, feat_nf=self._probe_feat_nf(),
                                edge_attr_nf=self._probe_edge_attr_nf())
            self.predict_batch([g], bucket=b)
            warmed.append(b)
        return warmed

    def _probe_feat_nf(self) -> int:
        return int(getattr(self.model, "node_feat_nf", 1) or 1)

    def _probe_edge_attr_nf(self) -> int:
        return int(getattr(self.model, "edge_attr_nf", 2) or 0)

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
        edge_block."""
        if not self._rollout_opts:
            raise ValueError("engine built without rollout_opts; pass "
                             "rollout_opts={'radius': ..., 'max_degree': ...}")
        edge_block = int(self._rollout_opts.get("edge_block", 256))
        rung = self.ladder._rung(n, self.ladder.node_floor,
                                 self.ladder.node_multiple,
                                 self.ladder.max_nodes, "nodes")
        return -(-max(rung, edge_block) // edge_block) * edge_block

    def rollout(self, loc0: np.ndarray, vel0: np.ndarray, steps: int,
                node_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """K-step autoregressive rollout of one graph; returns the UNPADDED
        trajectory [steps, n, 3]. Raises RolloutOverflowError if any step
        overflowed the static neighbour-capacity bounds."""
        from distegnn_tpu_torch.rollout import make_rollout_fn

        n = int(loc0.shape[0])
        n_pad = self.rollout_rung(n)
        loc_p = np.zeros((n_pad, 3), np.float32)
        vel_p = np.zeros((n_pad, 3), np.float32)
        mask = np.zeros((n_pad,), np.float32)
        loc_p[:n], vel_p[:n] = loc0, vel0
        mask[:n] = (node_mask if node_mask is not None
                    else np.ones(n)).astype(np.float32)
        self.shapes_seen.add(("rollout", n_pad, int(steps)))
        ro = make_rollout_fn(self.model, **self._rollout_fn_opts())
        traj, over = ro(*(torch.from_numpy(a).to(self.device)
                          for a in (loc_p, vel_p, mask)), steps=int(steps))
        over = over.cpu().numpy()
        if over.any():
            raise RolloutOverflowError(
                f"rollout overflowed radius-graph capacity at steps "
                f"{np.nonzero(over)[0].tolist()}; raise "
                f"max_degree/max_per_cell in rollout_opts")
        return traj.cpu().numpy()[:, :n]

    def rollout_batch(self, scenes: Sequence[dict]) -> List[np.ndarray]:
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
        self.shapes_seen.add(("rollout_batch", n_pad, steps, B))
        ro = make_batched_rollout_fn(self.model, **self._rollout_fn_opts())
        traj, over = ro(*(torch.from_numpy(a).to(self.device)
                          for a in (loc_p, vel_p, mask)), steps=steps)
        traj = traj.cpu().numpy()                    # [B, steps, n_pad, 3]
        over = over.cpu().numpy()[: len(scenes)]     # replicas don't count
        if over.any():
            bad = [(int(i), np.nonzero(over[i])[0].tolist())
                   for i in np.nonzero(over.any(axis=1))[0]]
            raise RolloutOverflowError(
                f"batched rollout overflowed radius-graph capacity "
                f"(scene, steps): {bad}; raise max_degree/max_per_cell in "
                f"rollout_opts")
        return [traj[i, :, :n].copy() for i, n in enumerate(ns)]
