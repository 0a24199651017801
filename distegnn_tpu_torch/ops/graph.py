"""GraphBatch — the padded batched graph container (port of
``distegnn_tpu/ops/graph.py``).

Dense layout, as in the JAX package:

  node arrays  [B, N, ...]   padded to N, with node_mask
  edge arrays  [B, E, ...]   padded edge list (per-graph node ids), with
                             edge_mask; padded edges are masked out of every
                             aggregation
  graph arrays [B, ...]      e.g. loc_mean

``pad_graphs`` builds the arrays with numpy exactly as the JAX package does
and hands them over as CPU tensors; ``GraphBatch.to(device)`` moves them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from distegnn_tpu_torch.ops.blocked import (max_block_degree,
                                            pairing_perm_fast,
                                            prepare_blocked_graph)
from distegnn_tpu_torch.ops.edge_pipeline import (pad_remote_list,
                                                  split_remote_edges)


@dataclasses.dataclass
class GraphBatch:
    """A batch of B padded graphs.

    Shapes (F node features, A node attrs, D edge attrs, R remote slots):
      node_feat [B, N, F]   node_attr [B, N, A]   node_mask [B, N] 0/1
      loc/vel/target [B, N, 3]                    loc_mean  [B, 3]
      edge_index [B, 2, E] int32 (row = receiver, col = sender)
      edge_attr  [B, E, D]  edge_mask [B, E] 0/1
      remote_edge_index [B, 2, R] int32, remote_edge_attr [B, R, D],
      remote_edge_mask [B, R] — the compact out-of-window edge list of the
      fused edge kernel (present only with ``split_remote=True``).
      edge_pair [B, E] int32 — the reverse-edge involution of a symmetric
      batch (``compute_pair``): edge_index[:, pair[e]] == (col[e], row[e]);
      padded slots pair with themselves (plain layout) or among themselves
      (blocked layout, where they carry row == col).

    ``edges_sorted``: every graph's rows ascend, the padded tail included.
    ``edge_block`` is 0 or the node-block size of the blocked layout.
    ``max_in_degree``: the batch's max real in-degree rounded up to 8 (0 =
    not computed; set together with the plain pairing), the D of the ELL
    lowering.
    """

    node_feat: torch.Tensor
    node_attr: torch.Tensor
    loc: torch.Tensor
    vel: torch.Tensor
    target: torch.Tensor
    loc_mean: torch.Tensor
    node_mask: torch.Tensor
    edge_index: torch.Tensor
    edge_attr: torch.Tensor
    edge_mask: torch.Tensor
    remote_edge_index: Optional[torch.Tensor] = None
    remote_edge_attr: Optional[torch.Tensor] = None
    remote_edge_mask: Optional[torch.Tensor] = None
    edge_pair: Optional[torch.Tensor] = None
    edges_sorted: bool = False
    edge_block: int = 0
    edge_tile: int = 0
    max_in_degree: int = 0

    def _map(self, fn) -> "GraphBatch":
        return GraphBatch(**{
            f.name: (fn(v) if isinstance(v, torch.Tensor) else v)
            for f in dataclasses.fields(self)
            for v in (getattr(self, f.name),)})

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        """A copy with every tensor on ``device``."""
        return self._map(lambda v: v.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "GraphBatch":
        """A copy in page-locked host memory (for non-blocking copies)."""
        return self._map(lambda v: v.pin_memory())

    @property
    def batch_size(self) -> int:
        return self.node_feat.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.node_feat.shape[1]

    @property
    def max_edges(self) -> int:
        return self.edge_index.shape[2]

    @property
    def edges_per_block(self) -> int:
        """Edge slots per node block (blocked layout only)."""
        if self.edge_block <= 0:
            raise ValueError("edges_per_block: not a blocked layout")
        return self.max_edges // (self.max_nodes // self.edge_block)

    @property
    def row(self) -> torch.Tensor:
        return self.edge_index[:, 0, :]

    @property
    def col(self) -> torch.Tensor:
        return self.edge_index[:, 1, :]


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def pad_graphs(
    graphs: Sequence[dict],
    max_nodes: Optional[int] = None,
    max_edges: Optional[int] = None,
    node_bucket: int = 8,
    edge_bucket: int = 128,
    dtype=np.float32,
    edge_block: int = 0,
    edges_per_block: Optional[int] = None,
    edge_tile: int = 512,
    compute_pair: Optional[bool] = None,
    max_in_degree: Optional[int] = None,
    split_remote: bool = False,
    remote_pad: Optional[int] = None,
) -> GraphBatch:
    """Pack per-graph numpy dicts into one padded GraphBatch (CPU tensors).

    Each dict has keys node_feat [n,F], loc/vel/target [n,3], edge_index
    [2,e], edge_attr [e,D], optional node_attr [n,A] and loc_mean [3].

    ``edge_block > 0`` emits the blocked layout (ops/blocked.py): N rounds up
    to a multiple of edge_block and each node block owns ``edges_per_block``
    edge slots (auto: the batch's max block degree rounded to edge_tile).
    ``split_remote`` additionally extracts the edges whose sender lies
    outside the fused kernel's 3-block window into the compact
    ``remote_edge_*`` arrays, padded to ``remote_pad`` (auto: the batch max
    rounded to 128). The arrays are those of the JAX package's pad_graphs.

    ``compute_pair`` attaches the reverse-edge pairing ``edge_pair`` when
    every graph is symmetric (all or nothing across the batch). ``None``
    (auto) is on for blocked batches and off for plain ones, as in the JAX
    package. Blocked: each graph's pairing of its blocked edge list
    (``prepare_blocked_graph``). Plain: with it ``max_in_degree`` (auto: the
    batch's max in-degree rounded up to 8; loaders pass a dataset-stable
    value, which is validated); each graph's pairing is cached on its dict
    as ``_plain_pair``.
    """
    bsz = len(graphs)
    n_max = max(g["loc"].shape[0] for g in graphs)
    if compute_pair is None:
        compute_pair = edge_block > 0
    if split_remote and not edge_block:
        raise ValueError("pad_graphs: split_remote requires edge_block > 0 "
                         "(the remote/in-window partition is defined by the "
                         "blocked layout)")
    remote = None
    edge_pair = None
    if edge_block:
        if max_nodes is not None and max_nodes < n_max:
            raise ValueError(
                f"pad_graphs: max_nodes {max_nodes} < actual {n_max}")
        if max_edges is not None:
            raise ValueError("pad_graphs: max_edges is unsupported with "
                             "edge_block; pass edges_per_block instead")
        if edges_per_block is not None and edges_per_block % edge_tile:
            raise ValueError(f"pad_graphs: edges_per_block {edges_per_block} "
                             f"not a multiple of edge_tile {edge_tile}")
        N = _round_up(max(max_nodes or 0, n_max, 1), edge_block)
        if edges_per_block is None:
            deg = max(max_block_degree(np.sort(g["edge_index"][0]), N,
                                       edge_block) for g in graphs)
            edges_per_block = _round_up(max(deg, 1), edge_tile)
        graphs = [prepare_blocked_graph(g, N, edges_per_block, edge_block,
                                        compute_pair=compute_pair)
                  for g in graphs]
        pairs = [g["_edge_pair"] for g in graphs]
        if all(p is not None for p in pairs):
            edge_pair = np.stack(pairs).astype(np.int32)
        E = (N // edge_block) * edges_per_block
        if split_remote:
            # classify each graph's REAL blockified edges (padding slots
            # carry row == col inside their own block: never remote)
            outs = []
            for g in graphs:
                sel = g.get("_remote_sel")
                if (sel is not None
                        and g.get("_blockified") == (N, edges_per_block,
                                                     edge_block)):
                    # a session-cached selection (serve/prep.py): the
                    # classify and sort were done at prep time
                    outs.append(pad_remote_list(
                        g["edge_index"][:, sel], g["edge_attr"][sel],
                        n_pad=remote_pad))
                    continue
                keep = g["_edge_mask"] > 0
                outs.append(split_remote_edges(
                    g["edge_index"][:, keep], g["edge_attr"][keep],
                    block=edge_block, n_nodes=N, n_pad=remote_pad))
            R = max(o[0].shape[1] for o in outs)
            rei = np.zeros((bsz, 2, R), np.int32)
            rea = np.zeros((bsz, R, outs[0][1].shape[1]), dtype)
            rem = np.zeros((bsz, R), dtype)
            for b, (ei_r, ea_r, m_r) in enumerate(outs):
                r = ei_r.shape[1]
                rei[b, :, :r], rea[b, :r], rem[b, :r] = ei_r, ea_r, m_r
            remote = (rei, rea, rem)
    else:
        e_max = max(g["edge_index"].shape[1] for g in graphs)
        E = (max_edges if max_edges is not None
             else _round_up(max(e_max, 1), edge_bucket))
        N = (max_nodes if max_nodes is not None
             else _round_up(max(n_max, 1), node_bucket))
        if N < n_max or E < e_max:
            raise ValueError(f"pad_graphs: max_nodes/max_edges ({N},{E}) < "
                             f"actual ({n_max},{e_max})")

    F = graphs[0]["node_feat"].shape[1]
    A = (graphs[0]["node_attr"].shape[1]
         if graphs[0].get("node_attr") is not None else 0)
    D = (graphs[0]["edge_attr"].shape[1]
         if graphs[0].get("edge_attr") is not None else 0)

    node_feat = np.zeros((bsz, N, F), dtype)
    node_attr = np.zeros((bsz, N, A), dtype)
    loc = np.zeros((bsz, N, 3), dtype)
    vel = np.zeros((bsz, N, 3), dtype)
    target = np.zeros((bsz, N, 3), dtype)
    loc_mean = np.zeros((bsz, 3), dtype)
    node_mask = np.zeros((bsz, N), dtype)
    # padded edges point at the last padded slot (N-1): masked out of every
    # aggregation, and row indices stay ascending
    edge_index = np.full((bsz, 2, E), N - 1, np.int32)
    edge_attr = np.zeros((bsz, E, D), dtype)
    edge_mask = np.zeros((bsz, E), dtype)
    edges_sorted = True

    for b, g in enumerate(graphs):
        n = g["loc"].shape[0]
        e = g["edge_index"].shape[1]
        node_feat[b, :n] = g["node_feat"]
        if A:
            node_attr[b, :n] = g["node_attr"]
        loc[b, :n] = g["loc"]
        vel[b, :n] = g["vel"]
        if g.get("target") is not None:
            target[b, :n] = g["target"]
        loc_mean[b] = (g["loc_mean"] if g.get("loc_mean") is not None
                       else g["loc"].mean(axis=0))
        node_mask[b, :n] = 1.0
        edge_index[b, :, :e] = g["edge_index"]
        if (not edge_block) and e and (
                np.any(np.diff(g["edge_index"][0]) < 0)
                or g["edge_index"][0][-1] > N - 1):
            edges_sorted = False
        if D and g.get("edge_attr") is not None:
            edge_attr[b, :e] = g["edge_attr"]
        edge_mask[b, :e] = g["_edge_mask"] if edge_block else 1.0

    if edge_block or not (compute_pair and edges_sorted):
        max_in_degree = 0
    else:
        deg = max(int(np.bincount(g["edge_index"][0], minlength=1).max())
                  for g in graphs)
        if max_in_degree is None:
            max_in_degree = _round_up(max(deg, 1), 8)
        elif max_in_degree < deg:
            raise ValueError(f"pad_graphs: max_in_degree {max_in_degree} < "
                             f"actual batch max in-degree {deg}")
        # each graph's pairing on its raw edge list, cached on its dict (it
        # is index-stable: padding is appended after the real edges); the
        # padded tail pairs with itself; all or nothing across the batch
        pairs = []
        for g in graphs:
            e = g["edge_index"].shape[1]
            p = g.get("_plain_pair")
            if p is None or p.shape[0] != e:
                p = pairing_perm_fast(g["edge_index"].astype(np.int64))
                if p is not None:
                    g["_plain_pair"] = p
            if p is None:
                pairs = None
                break
            full = np.arange(E, dtype=np.int32)
            full[:e] = p
            pairs.append(full)
        if pairs is not None:
            edge_pair = np.stack(pairs).astype(np.int32)

    t = torch.from_numpy
    return GraphBatch(
        node_feat=t(node_feat), node_attr=t(node_attr), loc=t(loc),
        vel=t(vel), target=t(target), loc_mean=t(loc_mean),
        node_mask=t(node_mask), edge_index=t(edge_index),
        edge_attr=t(edge_attr), edge_mask=t(edge_mask),
        remote_edge_index=t(remote[0]) if remote else None,
        remote_edge_attr=t(remote[1]) if remote else None,
        remote_edge_mask=t(remote[2]) if remote else None,
        edge_pair=t(edge_pair) if edge_pair is not None else None,
        edges_sorted=edges_sorted, edge_block=edge_block,
        edge_tile=edge_tile if edge_block else 0,
        max_in_degree=max_in_degree)
