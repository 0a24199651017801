"""Blocked edge layout, host half — copy of the numpy layout builder in
``distegnn_tpu/ops/blocked.py``.

Edge lists are sorted by receiver row and padded so that every node block of
``block`` nodes owns a fixed slice of ``epb`` edge slots:

    edge slice [b*epb, (b+1)*epb)  holds exactly the edges whose receiver
    row lies in node block [b*block, (b+1)*block), padded with masked slots.

Padding slots carry row = col = (their block's last node), so the whole edge
list stays row-sorted. The fused edge kernel (ops/edge_pipeline.py) reads
this layout.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _blockify_plan(edge_index: np.ndarray, n_nodes_padded: int, epb: int,
                   block: int):
    """Arbitrary edge order -> (src, dst, blocked index, mask) in one pass.

    ``src`` are input-edge positions sorted stably by receiver row (so sorted
    input keeps its order bit for bit); ``dst`` is each sorted edge's slot
    ``block_idx*epb + rank_within_block``."""
    row = edge_index[0]
    e = int(row.shape[0])
    nb = n_nodes_padded // block
    src = np.argsort(row, kind="stable")
    rows = row[src]
    bounds = np.searchsorted(rows, np.arange(nb + 1) * block)
    counts = np.diff(bounds)
    if counts.max(initial=0) > epb:
        raise ValueError(
            f"blockify_edges: epb={epb} < max block degree {counts.max()}")
    if bounds[-1] != e:
        raise ValueError("blockify_edges: edge rows exceed n_nodes_padded")
    dst = (np.repeat(np.arange(nb, dtype=np.int64) * epb, counts)
           + np.arange(e, dtype=np.int64)
           - np.repeat(bounds[:-1].astype(np.int64), counts))
    E = nb * epb
    new_index = np.empty((2, E), np.int32)
    pad_rows = np.arange(1, nb + 1, dtype=np.int32) * block - 1
    new_index[0] = np.repeat(pad_rows, epb)
    new_index[1] = new_index[0]
    new_index[:, dst] = edge_index[:, src]
    new_mask = np.zeros((E,), np.float32)
    new_mask[dst] = 1.0
    return src, dst, new_index, new_mask


def max_block_degree(rows_sorted: np.ndarray, n_nodes_padded: int,
                     block: int) -> int:
    """Max number of edges landing in any single node block (sorted rows)."""
    nb = n_nodes_padded // block
    bounds = np.searchsorted(rows_sorted, np.arange(nb + 1) * block)
    return int(np.diff(bounds).max(initial=0))


def prepare_blocked_graph(g: dict, n_nodes_padded: int, epb: int,
                          block: int) -> dict:
    """Blockify one graph dict (returns a copy): row-sort if needed, then
    re-lay the edges per block. The copy carries ``_edge_mask`` (real slots)
    and the ``_blockified`` stamp; a dict already stamped with the same
    layout is returned unchanged."""
    stamp = (n_nodes_padded, epb, block)
    if g.get("_blockified") == stamp:
        return g
    if g.get("_blockified") is not None:
        raise ValueError("prepare_blocked_graph: graph already blocked under "
                         f"{g['_blockified']}, requested {stamp}")
    g = dict(g)
    if np.any(np.diff(g["edge_index"][0]) < 0):
        order = np.argsort(g["edge_index"][0], kind="stable")
        g["edge_index"] = g["edge_index"][:, order]
        if g.get("edge_attr") is not None:
            g["edge_attr"] = g["edge_attr"][order]
    src, dst, ei, em = _blockify_plan(g["edge_index"].astype(np.int64),
                                      n_nodes_padded, epb, block)
    ea_in = g.get("edge_attr")
    D = ea_in.shape[1] if ea_in is not None else 0
    ea = np.zeros((em.shape[0], D), np.float32)
    if D:
        ea[dst] = ea_in[src]
    g["edge_index"], g["edge_attr"], g["_edge_mask"] = ei, ea, em
    g["_blockified"] = stamp
    return g


def pairing_perm(edge_index: np.ndarray) -> Optional[np.ndarray]:
    """Reverse-edge involution P with edge_index[:, P[e]] == (col[e],
    row[e]), or None when the edge list is not symmetric."""
    r, c = edge_index[0], edge_index[1]
    by_rc = np.lexsort((c, r))
    by_cr = np.lexsort((r, c))
    pair = np.empty(r.shape[0], np.int64)
    pair[by_rc] = by_cr
    if not (np.array_equal(r[pair], c) and np.array_equal(c[pair], r)):
        return None
    return pair


def scan_dataset_for_blocking(dataset, n_nodes_padded: int, block: int):
    """One pass over a dataset: (max block degree, every-graph-symmetric).
    Both are layout decisions made once per dataset, so every batch of a run
    has one shape."""
    deg, symmetric = 1, True
    for i in range(len(dataset)):
        ei = dataset[i]["edge_index"]
        deg = max(deg, max_block_degree(np.sort(ei[0]), n_nodes_padded, block))
        symmetric = symmetric and pairing_perm(ei) is not None
    return deg, symmetric
