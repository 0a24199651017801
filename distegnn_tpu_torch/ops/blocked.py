"""Blocked edge layout, host half — copy of the numpy layout builder in
``distegnn_tpu/ops/blocked.py``.

Edge lists are sorted by receiver row and padded so that every node block of
``block`` nodes owns a fixed slice of ``epb`` edge slots:

    edge slice [b*epb, (b+1)*epb)  holds exactly the edges whose receiver
    row lies in node block [b*block, (b+1)*block), padded with masked slots.

Padding slots carry row = col = (their block's last node), so the whole edge
list stays row-sorted. The fused edge kernel (ops/edge_pipeline.py) reads
this layout.

``EdgeOps`` is the edge-op dispatch of the plain (``edge_impl='plain'``)
path: row/column gathers and per-destination aggregations of a plain
row-sorted batch, lowered as ``scatter``, ``cumsum`` or ``ell``
(ops/segment.py). Its blocked branches (the one-hot kernels) come with port
slice 5.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distegnn_tpu_torch.ops import segment as S

_SLICE_BLOCKED = "port slice 5 (the blocked one-hot kernels)"


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


def pairing_perm_fast(edge_index: np.ndarray) -> Optional[np.ndarray]:
    """:func:`pairing_perm`. The JAX package routes this through a native
    C++ binding (native/blockify.cpp) when it is built; that binding is
    ported with the ``native/`` slice, and until then this is the numpy
    version, which gives the same permutation."""
    return pairing_perm(edge_index)


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


class EdgeOps:
    """Row/column gathers and per-destination aggregations of one batch
    (port of the JAX package's ``EdgeOps``), lowered as

      cumsum   ``seg_impl='cumsum'`` on a row-sorted batch: prefix-sum
               differences (the CUDA scan kernel on the card) with
               gather-only backwards, and the column gathers' backward
               through the reverse-edge pairing when the batch carries it;
      ell      ``seg_impl='ell'`` on a row-sorted batch carrying
               ``max_in_degree``: fixed-degree chained gathers (exact);
      scatter  ``index_add_`` otherwise (the exact reference lowering).

    As in the JAX package, a lowering the batch cannot support (unsorted
    rows, no ``max_in_degree``) falls to ``scatter``. The blocked one-hot
    lowerings of the JAX package's ``EdgeOps`` (``blocked_impl`` einsum /
    pallas, for batches with ``edge_block > 0``) come with port slice 5."""

    def __init__(self, g, seg_impl: str = "scatter",
                 blocked_impl: str = "einsum"):
        if seg_impl not in ("scatter", "cumsum", "ell"):
            raise ValueError(f"unknown seg_impl {seg_impl!r}")
        if g.edge_block > 0:
            raise NotImplementedError(
                f"EdgeOps over a blocked batch (edge_block={g.edge_block}, "
                f"blocked_impl={blocked_impl!r}) comes with {_SLICE_BLOCKED}; "
                "the plain path takes data.edge_block: 0")
        self.g = g
        self.cumsum = seg_impl == "cumsum" and g.edges_sorted
        self.ell = (seg_impl == "ell" and g.edges_sorted
                    and g.max_in_degree > 0)

    def gather_rows(self, data):
        if self.cumsum:
            return S.gather_rows_cs(data, self.g.row)
        if self.ell:
            return S.gather_rows_ell(data, self.g.row, self.g.max_in_degree)
        return S.take_rows(data, self.g.row)

    def gather_cols(self, data):
        g = self.g
        if self.cumsum and g.edge_pair is not None:
            return S.paired_gather_cols_cs(data, g.col, g.edge_pair, g.row,
                                           g.edge_mask)
        if self.ell and g.edge_pair is not None:
            return S.paired_gather_cols_ell(data, g.col, g.edge_pair, g.row,
                                            g.edge_mask, g.max_in_degree)
        return S.take_rows(data, g.col)

    def _agg(self, data, mean: bool):
        g = self.g
        N = g.max_nodes
        if self.cumsum:
            fn = S.segment_mean_cs if mean else S.segment_sum_cs
            return fn(data, g.row, N, mask=g.edge_mask)
        if self.ell:
            fn = S.segment_mean_ell if mean else S.segment_sum_ell
            return fn(data, g.row, N, g.max_in_degree, mask=g.edge_mask)
        fn = S.segment_mean if mean else S.segment_sum
        return fn(data, g.row, N, mask=g.edge_mask)

    def agg_rows_mean(self, data):
        """Per-destination mean over real edges (count clamped >= 1)."""
        return self._agg(data, mean=True)

    def agg_rows_sum(self, data):
        return self._agg(data, mean=False)

    def agg_rows_pair(self, a, b, a_mean: bool, agg_dtype=None):
        """Aggregate TWO edge streams in ONE pass: returns
        (sum or mean of ``a``, mean of ``b``), both f32. ``a`` [B, E, Sa],
        ``b`` [B, E, Sb] and the count ride one packed [B, E, Sa + Sb + 1]
        stream (one prefix scan per layer on the cumsum lowering).

        ``agg_dtype='bf16'`` casts the packed stream to bf16 first (half the
        bytes; the sums still accumulate in f32, and the coordinate
        translations in ``a`` are rounded — equivariance becomes
        approximate)."""
        g = self.g
        B, E = b.shape[0], b.shape[1]
        sa = a.shape[-1]
        dt = (torch.bfloat16 if agg_dtype in ("bf16", "bfloat16",
                                              torch.bfloat16)
              else torch.float32)
        em = g.edge_mask[..., None].to(dt)
        packed = torch.cat([a.to(dt), b.to(dt),
                            a.new_ones((B, E, 1), dtype=dt)], dim=-1) * em
        N = g.max_nodes
        if self.cumsum:
            out = S.sorted_segment_sum_cs(packed, g.row, N).to(torch.float32)
        elif self.ell:
            out = S.sorted_segment_sum_ell(packed, g.row, N,
                                           g.max_in_degree).to(torch.float32)
        else:
            # an f32 accumulator whatever the stream type
            out = S.segment_sum(packed.to(torch.float32), g.row, N)
        cnt = torch.clamp(out[..., -1:], min=1.0)
        out_a = out[..., :sa] / cnt if a_mean else out[..., :sa]
        return out_a, out[..., sa:-1] / cnt
