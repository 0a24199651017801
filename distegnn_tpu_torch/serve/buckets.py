"""Shape bucketing (port of ``distegnn_tpu/serve/buckets.py``) — map an
incoming graph's (N, E) to a geometric ladder of padded shapes.

Rung k holds

    n_k = round_up(floor_n * growth^k, node_multiple)
    e_k = round_up(floor_e * growth^k, edge_multiple)

with N and E bucketed independently. The ladder bounds admission
(larger requests raise BucketOverflowError) and keeps the number of distinct
batch shapes logarithmic in the admitted size range. Padding is
``ops/graph.pad_graphs``: the layout the models are tested on.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np

from distegnn_tpu_torch.ops.graph import GraphBatch, pad_graphs
from distegnn_tpu_torch.ops.radius import radius_graph_np


class Bucket(NamedTuple):
    """One rung of the ladder: the padded (nodes, edges) of a batch shape."""

    n: int
    e: int


class BucketOverflowError(ValueError):
    """Request exceeds the largest admitted shape — surfaced, never truncated."""


class BucketLadder:
    """Geometric (N, E) ladder with linear rounding at each rung.

    Args:
      node_floor/edge_floor: size of rung 0 (smallest padded shape).
      growth: geometric step between rungs (> 1). 2.0 halves the rung count
        of 1.5 at the price of up to 2x pad waste on each axis.
      node_multiple/edge_multiple: every rung rounds up to these (the
        training bucket quanta — keeps rungs aligned with loader shapes).
      max_nodes/max_edges: admission bound; larger requests raise
        BucketOverflowError instead of padding to an unbounded shape.
    """

    def __init__(self, node_floor: int = 64, edge_floor: int = 256,
                 growth: float = 2.0, node_multiple: int = 8,
                 edge_multiple: int = 128, max_nodes: int = 65536,
                 max_edges: int = 1 << 20):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1 (got {growth})")
        if node_floor < 1 or edge_floor < 1:
            raise ValueError("node_floor/edge_floor must be >= 1")
        self.node_floor = int(node_floor)
        self.edge_floor = int(edge_floor)
        self.growth = float(growth)
        self.node_multiple = int(node_multiple)
        self.edge_multiple = int(edge_multiple)
        self.max_nodes = int(max_nodes)
        self.max_edges = int(max_edges)

    def _rung(self, size: int, floor: int, multiple: int, cap: int,
              axis: str) -> int:
        if size > cap:
            raise BucketOverflowError(
                f"request {axis}={size} exceeds the ladder cap {cap}; raise "
                f"serve.max_{axis}, enable the tiled executor (serve.tiled, "
                f"serves any node count through fixed-shape tiles), or "
                f"shard the request")
        k = max(0, math.ceil(math.log(max(size, 1) / floor, self.growth)))
        # float log can land one rung low on exact powers — fix up locally
        while floor * self.growth ** k < size:
            k += 1
        r = int(math.ceil(floor * self.growth ** k))
        r = ((r + multiple - 1) // multiple) * multiple
        return min(r, ((cap + multiple - 1) // multiple) * multiple)

    def bucket_for(self, n_nodes: int, n_edges: int) -> Bucket:
        """Smallest rung admitting an (n_nodes, n_edges) graph."""
        return Bucket(
            self._rung(n_nodes, self.node_floor, self.node_multiple,
                       self.max_nodes, "nodes"),
            self._rung(n_edges, self.edge_floor, self.edge_multiple,
                       self.max_edges, "edges"),
        )

    def bucket_of_graph(self, graph: dict) -> Bucket:
        """Bucket for a pad_graphs-style graph dict."""
        return self.bucket_for(int(graph["loc"].shape[0]),
                               int(graph["edge_index"].shape[1]))

    # ---- padding ---------------------------------------------------------
    def pad_batch(self, graphs: Sequence[dict], bucket: Bucket,
                  batch_pad: int, *, edge_block: int = 0, edge_tile: int = 512,
                  split_remote: bool = False) -> Tuple[GraphBatch, int]:
        """Pack ``graphs`` (all admitted by ``bucket``) into one GraphBatch
        of EXACTLY (batch_pad, bucket.n, bucket.e) (CPU tensors).

        The batch axis is padded by replicating the first graph — replicas
        are valid graphs (no NaN hazards from empty-graph means) and their
        outputs are simply discarded; returns (batch, n_real).

        ``edge_block > 0`` emits the BLOCKED layout instead (the fused edge
        pipeline's input; ``split_remote`` adds the compact out-of-window
        list). Node count snaps up from bucket.n to a block multiple;
        edges_per_block and the remote width auto-derive per batch, so the
        engine keys its shape count on the resulting batch shapes.
        """
        n_real = len(graphs)
        if n_real == 0:
            raise ValueError("pad_batch: empty batch")
        if n_real > batch_pad:
            raise ValueError(f"pad_batch: {n_real} graphs > batch_pad {batch_pad}")
        filled = list(graphs) + [graphs[0]] * (batch_pad - n_real)
        if edge_block:
            nb = (bucket.n + edge_block - 1) // edge_block
            if split_remote:
                nb = max(nb, 3)  # fused kernel's VMEM window spans 3 blocks
            batch = pad_graphs(filled, max_nodes=nb * edge_block,
                               edge_block=edge_block, edge_tile=edge_tile,
                               compute_pair=False, split_remote=split_remote)
        else:
            batch = pad_graphs(filled, max_nodes=bucket.n, max_edges=bucket.e,
                               node_bucket=1, edge_bucket=1)
        return batch, n_real


def synthetic_graph(n: int, radius: float = 0.35, seed: int = 0,
                    feat_nf: int = 1, edge_attr_nf: int = 2) -> dict:
    """A random radius graph in pad_graphs dict form — shared by the serve
    tests and the bench harness (kept here so both draw the same workload)."""
    rng = np.random.default_rng(seed)
    loc = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 0.05).astype(np.float32)
    ei = radius_graph_np(loc, radius)
    if ei.shape[1] == 0:  # guarantee at least one edge (self-loop-free pair)
        ei = np.array([[0, 1], [1, 0]], np.int32).T.reshape(2, 2)
    d = np.linalg.norm(loc[ei[0]] - loc[ei[1]], axis=1)[:, None]
    feat = np.linalg.norm(vel, axis=1, keepdims=True).astype(np.float32)
    feat = np.repeat(feat, feat_nf, axis=1)[:, :feat_nf]
    return {
        "node_feat": feat,
        "loc": loc, "vel": vel, "target": loc,
        "edge_index": ei.astype(np.int32),
        "edge_attr": np.repeat(d, edge_attr_nf, axis=1).astype(np.float32),
    }
