"""Neighbour search (host-side numpy) — copy of ``distegnn_tpu/ops/radius.py``.

A uniform-grid cell list builds radius graphs on the host. Directed edge
(row, col) carries a message TO ``row`` FROM ``col``; both directions are
emitted, ordered by (row, col).
"""

from __future__ import annotations

import numpy as np


def full_graph_np(n: int) -> np.ndarray:
    """All ordered pairs i != j — the reference's radius=-1 n-body graph
    (N=100 -> E=9900, dataset_generation/README.md:10-11)."""
    row, col = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    mask = row != col
    return np.stack([row[mask], col[mask]]).astype(np.int64)


def radius_graph_np(pos: np.ndarray, r: float, loop: bool = False) -> np.ndarray:
    """Edges (i, j) for all pairs with ||pos_i - pos_j|| < r, via a uniform grid.

    pos: [n, 3] float. Returns edge_index [2, E] int64, both directions included,
    ordered by (i, j). O(n * avg_neighbors) instead of O(n^2).
    """
    pos = np.asarray(pos, dtype=np.float64)
    n = pos.shape[0]
    if n == 0:
        return np.zeros((2, 0), np.int64)
    if r <= 0:
        return full_graph_np(n)

    cell = np.floor(pos / r).astype(np.int64)
    cell -= cell.min(axis=0)
    dims = cell.max(axis=0) + 1
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    # cell id -> contiguous range in `order`
    uniq, starts = np.unique(key_sorted, return_index=True)
    ends = np.append(starts[1:], n)
    cell_lookup = {k: (s, e) for k, s, e in zip(uniq.tolist(), starts.tolist(), ends.tolist())}

    offsets = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)]
    rows, cols = [], []
    r2 = r * r
    # one iteration per OCCUPIED CELL (not per node): gather the 27-cell
    # candidate set once, then a vectorized [members x candidates] distance check
    for k, s, e in zip(uniq.tolist(), starts.tolist(), ends.tolist()):
        members = order[s:e]
        kz = k % dims[2]
        ky = (k // dims[2]) % dims[1]
        kx = k // (dims[1] * dims[2])
        cand = []
        for ox, oy, oz in offsets:
            cx, cy, cz = kx + ox, ky + oy, kz + oz
            if not (0 <= cx < dims[0] and 0 <= cy < dims[1] and 0 <= cz < dims[2]):
                continue
            rng = cell_lookup.get((cx * dims[1] + cy) * dims[2] + cz)
            if rng is not None:
                cand.append(order[rng[0]:rng[1]])
        cand = np.concatenate(cand)
        d2 = np.sum((pos[members][:, None, :] - pos[cand][None, :, :]) ** 2, axis=-1)
        hit = d2 < r2
        if not loop:
            hit &= members[:, None] != cand[None, :]
        mi, ci = np.nonzero(hit)
        if mi.size:
            rows.append(members[mi])
            cols.append(cand[ci])
    if not rows:
        return np.zeros((2, 0), np.int64)
    row = np.concatenate(rows)
    col = np.concatenate(cols)
    perm = np.lexsort((col, row))
    return np.stack([row[perm], col[perm]])


def cutoff_edges_np(edge_index: np.ndarray, pos: np.ndarray,
                    cutoff_rate: float) -> np.ndarray:
    """Drop the longest ``cutoff_rate`` fraction of edges: sort by length,
    keep the shortest ``int(E * (1 - rate))`` in their original order."""
    if cutoff_rate <= 0 or edge_index.shape[1] == 0:
        return edge_index
    d = np.linalg.norm(pos[edge_index[0]] - pos[edge_index[1]], axis=1)
    keep = int(edge_index.shape[1] * (1.0 - cutoff_rate))
    idx = np.argsort(d, kind="stable")[:keep]
    idx.sort()
    return edge_index[:, idx]
