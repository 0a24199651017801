"""Static-shape graph loaders (port of the single-device half of
``distegnn_tpu/data/loader.py``).

``GraphDataset`` holds graph dicts in memory (or reads them from a pickle);
``GraphLoader`` collates them into padded ``GraphBatch``es whose node count,
edges per block and remote pad are fixed once per dataset, so every batch of
a run has one shape. The permutation of an epoch is numpy's
``default_rng([seed, epoch])``, so the batches are bitwise those of the JAX
loader. Two layouts: the plain row-sorted one (``edge_block`` 0, the
``edge_impl='plain'`` path; optionally with the reverse-edge pairing and
``max_in_degree`` of the scatter-free lowerings) and the blocked one (the
one-hot kernels of the plain path, with the pairing when the dataset is
symmetric; with ``split_remote`` the fused edge kernel's).
"""

from __future__ import annotations

import pickle
from typing import List, Optional, Sequence, Union

import numpy as np

from distegnn_tpu_torch.ops.blocked import (prepare_blocked_graph,
                                            scan_dataset_for_blocking)
from distegnn_tpu_torch.ops.edge_pipeline import count_remote_edges
from distegnn_tpu_torch.ops.graph import _round_up, pad_graphs
from distegnn_tpu_torch.ops.order import morton_perm, reorder_graph

class GraphDataset:
    """A list of graph dicts, from a pickle file or in memory.

    ``node_order='morton'`` relabels each graph's nodes along a Z curve of
    its positions (the caller's list is not modified)."""

    def __init__(self, source: Union[str, Sequence[dict]],
                 node_order: Optional[str] = "none"):
        if isinstance(source, str):
            with open(source, "rb") as f:
                self.graphs: List[dict] = pickle.load(f)
        else:
            self.graphs = list(source)
        if node_order == "morton":
            self.graphs = [reorder_graph(g, morton_perm(g["loc"]))
                           for g in self.graphs]
        elif node_order not in ("none", None):
            raise ValueError(f"GraphDataset: unknown node_order {node_order!r}")

    def __len__(self) -> int:
        return len(self.graphs)

    def __getitem__(self, i: int) -> dict:
        return self.graphs[i]

    def size_maxima(self):
        n = max(g["loc"].shape[0] for g in self.graphs)
        e = max(g["edge_index"].shape[1] for g in self.graphs)
        return n, e


class GraphLoader:
    """Deterministic batching over a GraphDataset: the order of an epoch
    derives from (seed, epoch) only; drop_last always.

    Batches are CPU ``GraphBatch``es with one shape for the whole dataset.
    ``edge_block`` 0: the plain layout, ``max_nodes``/``max_edges`` the
    dataset maxima rounded up to ``node_bucket``/``edge_bucket``;
    ``pairing=True`` attaches the reverse-edge pairing to every batch with a
    dataset-stable ``max_in_degree`` (the cumsum and ELL lowerings use
    them). ``edge_block`` > 0: the blocked layout of ``edge_block`` nodes per
    block, with one ``max_nodes`` and one ``edges_per_block``; ``pairing``
    ``None`` decides by a symmetry scan of the dataset (the blocked column
    gathers' backward uses the pairing). ``split_remote`` adds the compact
    remote list of the fused edge kernel, with one ``remote_pad``, and then
    at least 3 blocks. The blockified graphs are cached across epochs while
    they fit ``CACHE_BYTES``."""

    EDGE_TILE = 512
    CACHE_BYTES = 2 << 30

    def __init__(self, dataset: GraphDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0, edge_block: int = 0,
                 pairing: Optional[bool] = None, node_bucket: int = 8,
                 edge_bucket: int = 128, split_remote: bool = False):
        if split_remote and not edge_block:
            raise ValueError("GraphLoader: split_remote requires edge_block "
                             "> 0 (the fused pipeline's window is defined on "
                             "the blocked layout)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.edge_block = edge_block
        self.split_remote = bool(split_remote)
        self._prepared_cache = None
        if len(self) == 0:
            raise ValueError(f"batch_size {batch_size} > dataset size "
                             f"{len(dataset)}: drop_last leaves zero batches")
        n, e = dataset.size_maxima()
        if not edge_block:
            self.pairing = bool(pairing)
            self.max_nodes = _round_up(max(n, 1), node_bucket)
            self.max_edges = _round_up(max(e, 1), edge_bucket)
            self.max_in_degree = None
            if self.pairing:
                # one ELL degree for the run, so every batch has one shape
                deg = max(int(np.bincount(dataset[i]["edge_index"][0],
                                          minlength=1).max())
                          for i in range(len(dataset)))
                self.max_in_degree = _round_up(max(deg, 1), 8)
            return
        self.max_nodes = _round_up(max(n, 1), edge_block)
        if split_remote:
            # the fused kernel's 3-block window needs nb >= 3; small graphs
            # pay all-padding blocks rather than failing
            self.max_nodes = max(self.max_nodes, 3 * edge_block)
        deg, sym = scan_dataset_for_blocking(dataset, self.max_nodes,
                                             edge_block)
        self.pairing = sym if pairing is None else bool(pairing)
        self.edges_per_block = _round_up(deg, self.EDGE_TILE)
        self.max_edges = (self.max_nodes // edge_block) * self.edges_per_block
        self.remote_pad = None
        if split_remote:
            # blockify never adds out-of-window edges (its padding slots sit
            # in their own block): scan the raw lists, pad to 128 lanes
            er = max(count_remote_edges(dataset[i]["edge_index"],
                                        block=edge_block,
                                        n_nodes=self.max_nodes)
                     for i in range(len(dataset)))
            self.remote_pad = max(_round_up(er, 128), 128)
        d0 = dataset[0].get("edge_attr")
        per = self.max_edges * (8 + 4 + 8 + (d0.shape[1] * 4
                                             if d0 is not None else 0))
        self._prepared_cache = ({} if per * len(dataset) <= self.CACHE_BYTES
                                else None)

    def pad_kwargs(self) -> dict:
        """kwargs that make pad_graphs emit this loader's layout."""
        if not self.edge_block:
            return dict(max_nodes=self.max_nodes, max_edges=self.max_edges,
                        compute_pair=self.pairing,
                        max_in_degree=self.max_in_degree)
        return dict(edge_block=self.edge_block, edge_tile=self.EDGE_TILE,
                    edges_per_block=self.edges_per_block,
                    max_nodes=self.max_nodes, compute_pair=self.pairing,
                    split_remote=self.split_remote,
                    remote_pad=self.remote_pad)

    def _graph(self, i: int) -> dict:
        if not self.edge_block:
            return self.dataset[i]
        cache = self._prepared_cache
        if cache is not None and i in cache:
            return cache[i]
        g = prepare_blocked_graph(self.dataset[i], self.max_nodes,
                                  self.edges_per_block, self.edge_block,
                                  compute_pair=self.pairing)
        if cache is not None:
            cache[i] = g
        return g

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _order(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(len(self.dataset))
        return np.random.default_rng([self.seed, self.epoch]).permutation(
            len(self.dataset))

    def __iter__(self):
        order = self._order()
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield pad_graphs([self._graph(int(i)) for i in idx],
                             **self.pad_kwargs())
