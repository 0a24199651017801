"""Spatial node ordering (host-side numpy) — copy of
``distegnn_tpu/ops/order.py``.

Sorting nodes along a Z-order (Morton) curve of their positions puts
spatially-near nodes into the same node blocks, so most radius-graph edges
fall inside the fused edge kernel's 3-block window. It is a relabelling:
FastEGNN is permutation-equivariant.
"""

from __future__ import annotations

import numpy as np

# node-indexed arrays a graph dict may carry ([n, ...] leading axis)
_NODE_KEYS = ("node_feat", "node_attr", "loc", "vel", "target")


def morton_codes(loc: np.ndarray, bits: int = 16) -> np.ndarray:
    """Z-order curve code per row of ``loc`` [n, d<=3] -> uint64 [n].

    Coordinates are quantized to ``bits`` levels per axis over the cloud's
    bounding box; codes interleave the axis bits (x bit 0, y bit 0, z bit 0,
    x bit 1, ...), so sorting by code orders points along the Z curve."""
    loc = np.asarray(loc, np.float64)
    n, d = loc.shape
    if d > 3 or bits * d > 63:
        raise ValueError(f"morton_codes: unsupported shape/bits ({d}, {bits})")
    lo = loc.min(axis=0)
    span = np.maximum(loc.max(axis=0) - lo, 1e-300)
    q = ((loc - lo) / span * (2**bits - 1) + 0.5).astype(np.uint64)
    code = np.zeros(n, np.uint64)
    for b in range(bits):
        for ax in range(d):
            code |= ((q[:, ax] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                b * d + ax)
    return code


def morton_perm(loc: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation (new order -> old index) sorting nodes along the Z curve."""
    return np.argsort(morton_codes(loc, bits), kind="stable")


def reorder_graph(g: dict, perm: np.ndarray) -> dict:
    """Apply a node permutation to a graph dict: permute node arrays, remap
    edge_index, and re-sort edges by (row, col) so the row-sorted invariant
    every lowering relies on (GraphBatch.edges_sorted) still holds.

    ``perm[new] = old``; graph-level keys (loc_mean, ...) pass through."""
    known = set(_NODE_KEYS) | {"loc_mean", "edge_index", "edge_attr"}
    for k, v in g.items():
        if k not in known and isinstance(v, np.ndarray):
            # refuse silently-inconsistent output: an unknown array might be
            # node-indexed and would keep its OLD order
            raise ValueError(f"reorder_graph: unknown array key {k!r} — add "
                             "it to _NODE_KEYS (node-indexed) or the "
                             "pass-through set")
    n = g["loc"].shape[0]
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    out = dict(g)
    for k in _NODE_KEYS:
        v = g.get(k)
        if v is not None:
            if v.shape[0] != n:
                raise ValueError(f"reorder_graph: {k} has leading dim "
                                 f"{v.shape[0]}, expected {n}")
            out[k] = np.ascontiguousarray(v[perm])
    ei = inv[np.asarray(g["edge_index"], np.int64)]
    order = np.lexsort((ei[1], ei[0]))
    out["edge_index"] = np.ascontiguousarray(ei[:, order]).astype(np.int32)
    ea = g.get("edge_attr")
    if ea is not None:
        out["edge_attr"] = np.ascontiguousarray(ea[order])
    return out
