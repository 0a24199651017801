"""InferenceEngine — one-step bucketed prediction (port of the predict path
of ``distegnn_tpu/serve/engine.py``).

Every request batch is padded to a BucketLadder rung and its batch axis to
``max_batch`` by replicating the first graph, exactly as in the JAX engine.
PyTorch runs eagerly, so there is no compile cache: the engine keeps the
shape key of each batch and counts the distinct shapes it has run
(``shapes_seen``), which is what the JAX engine's cache size would be.

K-step rollout, the tiled executor and the blue/green canary are later
slices of the port.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from distegnn_tpu_torch.serve.buckets import (Bucket, BucketLadder,
                                              synthetic_graph)


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
    """

    def __init__(self, model: torch.nn.Module, device: torch.device, *,
                 ladder: Optional[BucketLadder] = None, max_batch: int = 8,
                 layout_opts: Optional[dict] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.ladder = ladder or BucketLadder()
        self.max_batch = int(max_batch)
        self._layout_opts = dict(layout_opts or {})
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
