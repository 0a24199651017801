"""Spatial graph partitioners (port of ``distegnn_tpu/data/partition.py``):
split one large graph into the parts of the ``graph`` axis.

A partitioner gives every node one of P labels; each part keeps only its
own nodes, rebuilds its edges locally at ``inner_radius`` (edges between
parts are dropped: the parts couple only through the virtual nodes) and
carries the *global* position mean as ``loc_mean``, so every part seeds the
same virtual coordinates.

Methods: ``random`` (seeded permutation chunks), ``kmeans`` and
``spectral`` (scikit-learn, imported when called), ``metis`` (the in-tree
C++ multilevel partitioner of ``native/partition.cpp`` over the
``outer_radius`` graph, with a numpy BFS recursive bisection where the
library cannot be built: balanced too, but other labels).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.ops.radius import radius_graph_np


def _log(msg: str) -> None:
    obs.log(f"[partition] {msg}")


def random_labels(n: int, n_parts: int, rng: np.random.Generator) -> np.ndarray:
    """Random chunks of a node permutation, balanced to +-1."""
    labels = np.empty(n, np.int32)
    for p, chunk in enumerate(np.array_split(rng.permutation(n), n_parts)):
        labels[chunk] = p
    return labels


def kmeans_labels(pos: np.ndarray, n_parts: int, seed: int = 0) -> np.ndarray:
    from sklearn.cluster import KMeans

    km = KMeans(n_clusters=n_parts, random_state=seed, n_init="auto")
    return km.fit_predict(np.asarray(pos, np.float32)).astype(np.int32)


def spectral_labels(pos: np.ndarray, n_parts: int, seed: int = 0,
                    sigma: Optional[float] = None) -> np.ndarray:
    """Spectral clustering, RBF affinity; ``sigma`` defaults to the median
    pairwise distance of a <= 2000-node subsample."""
    from sklearn.cluster import SpectralClustering

    X = np.asarray(pos, np.float32)
    n = X.shape[0]
    if sigma is None:
        m = min(n, 2000)
        idx = np.random.RandomState(seed).choice(n, size=m, replace=False)
        D = np.linalg.norm(X[idx, None, :] - X[None, idx, :], axis=2)
        sigma = float(np.median(D[D > 0])) + 1e-12
    sc = SpectralClustering(
        n_clusters=n_parts, affinity="rbf", gamma=1.0 / (2.0 * sigma * sigma),
        assign_labels="kmeans", random_state=seed, eigen_solver="arpack")
    return sc.fit_predict(X).astype(np.int32)


def _bfs_bisect(adj_indptr: np.ndarray, adj_indices: np.ndarray,
                nodes: np.ndarray, take: int,
                rng: np.random.Generator) -> np.ndarray:
    """Grow a region of exactly ``take`` nodes from a random seed by BFS over
    the induced subgraph; a bool mask over ``nodes``."""
    n = nodes.shape[0]
    local = {int(g): i for i, g in enumerate(nodes)}
    picked = np.zeros(n, bool)
    frontier = [int(rng.integers(n))]
    picked[frontier[0]] = True
    count = 1
    qi = 0
    while count < take:
        if qi >= len(frontier):
            # disconnected remainder: jump to an unpicked node
            rest = np.nonzero(~picked)[0]
            frontier.append(int(rest[0]))
            picked[rest[0]] = True
            count += 1
            continue
        u = frontier[qi]
        qi += 1
        gu = nodes[u]
        for gv in adj_indices[adj_indptr[gu]:adj_indptr[gu + 1]]:
            lv = local.get(int(gv))
            if lv is not None and not picked[lv] and count < take:
                picked[lv] = True
                frontier.append(lv)
                count += 1
    return picked


def _csr_from_edges(edge_index: np.ndarray, n: int):
    order = np.argsort(edge_index[0], kind="stable")
    row, col = edge_index[0][order], edge_index[1][order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, row + 1, 1)
    return np.cumsum(indptr), col.astype(np.int64)


def metis_labels(pos: np.ndarray, n_parts: int, outer_radius: float,
                 seed: int = 0) -> np.ndarray:
    """Balanced edge-cut partition of the ``outer_radius`` graph: the C++
    partitioner where the library builds, else the numpy BFS bisection.
    ``metis_labels.partitioner`` names the one of the last call ('native'
    or 'numpy'), and each is logged the first time it runs in a process."""
    from distegnn_tpu_torch.native import native_partition

    pos = np.asarray(pos)
    n = pos.shape[0]
    if n_parts <= 1:
        return np.zeros(n, np.int32)
    edge_index = radius_graph_np(pos, outer_radius)
    indptr, col = _csr_from_edges(edge_index, n)
    labels = native_partition(indptr, col, n_parts, seed=seed)
    which = "native" if labels is not None else "numpy"
    metis_labels.partitioner = which
    if which not in metis_labels.logged:
        metis_labels.logged.add(which)
        _log("metis: the C++ partitioner (native/partition.cpp)"
             if labels is not None else
             "metis: no C++ library (g++ missing or failed); the numpy BFS "
             "bisection runs instead and gives other labels")
    if labels is not None:
        return labels
    rng = np.random.default_rng(seed)
    labels = np.zeros(n, np.int32)

    def recurse(nodes: np.ndarray, parts: int, base: int):
        if parts == 1:
            labels[nodes] = base
            return
        if nodes.shape[0] <= parts:
            # one node per part, surplus parts stay empty
            for i, g in enumerate(nodes):
                labels[g] = base + i
            return
        left = parts // 2
        take = int(round(nodes.shape[0] * left / parts))
        picked = _bfs_bisect(indptr, col, nodes, take, rng)
        recurse(nodes[picked], left, base)
        recurse(nodes[~picked], parts - left, base + left)

    recurse(np.arange(n), n_parts, 0)
    return labels


metis_labels.partitioner = None
metis_labels.logged = set()


def assign_partitions(pos: np.ndarray, n_parts: int, method: str,
                      outer_radius: Optional[float] = None,
                      seed: int = 0) -> np.ndarray:
    """Node -> part labels [n] by ``split_mode``."""
    if method == "random":
        return random_labels(pos.shape[0], n_parts,
                             np.random.default_rng(seed))
    if method == "kmeans":
        return kmeans_labels(pos, n_parts, seed)
    if method == "spectral":
        return spectral_labels(pos, n_parts, seed)
    if method == "metis":
        if outer_radius is None:
            raise ValueError("metis split needs outer_radius")
        return metis_labels(pos, n_parts, outer_radius, seed)
    raise NotImplementedError(f"split_mode {method!r}")


# The partitioners balance node counts; a step's cost is closer to
# a * nodes + b * edges, and a dense region makes one part the step's
# critical path. The pass below scores each node's work by its inner-radius
# degree and, past a max/mean threshold, reassigns Morton-ordered chunks
# greedily (LPT) so that parts stay spatially compact.
WORK_NODE_COST = 1.0
WORK_EDGE_COST = 1.0


def node_work(pos: np.ndarray, inner_radius: float,
              a: float = WORK_NODE_COST, b: float = WORK_EDGE_COST,
              edge_index: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-node work ``a + b * degree`` [n] on the whole graph's
    inner-radius edges (an upper bound of each part's local work)."""
    pos = np.asarray(pos)
    if edge_index is None:
        edge_index = radius_graph_np(pos, inner_radius)
    deg = np.bincount(edge_index[0], minlength=pos.shape[0])
    return a + b * deg.astype(np.float64)


def partition_work(labels: np.ndarray, work: np.ndarray,
                   n_parts: int) -> np.ndarray:
    """Summed work per part [P]."""
    return np.bincount(labels, weights=work, minlength=n_parts)


def imbalance_ratio(part_work: np.ndarray) -> float:
    """max / mean part work (1.0 is perfect)."""
    pw = np.asarray(part_work, np.float64)
    return float(pw.max() / pw.mean())


def rebalance_morton(pos: np.ndarray, work: np.ndarray, n_parts: int,
                     chunks_per_part: int = 32) -> np.ndarray:
    """Work-balanced labels: the nodes in Z-curve order, cut into
    ``n_parts * chunks_per_part`` contiguous chunks, each chunk (heaviest
    first) to the currently lightest part."""
    from distegnn_tpu_torch.ops.order import morton_perm

    pos = np.asarray(pos)
    n = pos.shape[0]
    perm = morton_perm(pos)
    n_chunks = min(n, n_parts * max(1, chunks_per_part))
    chunks = np.array_split(perm, n_chunks)
    chunk_work = np.array([work[c].sum() for c in chunks])
    labels = np.empty(n, np.int32)
    load = np.zeros(n_parts, np.float64)
    for ci in np.argsort(chunk_work, kind="stable")[::-1]:
        p = int(np.argmin(load))
        labels[chunks[ci]] = p
        load[p] += chunk_work[ci]
    return labels


def balance_partitions(pos: np.ndarray, labels: np.ndarray, n_parts: int,
                       inner_radius: float, balance_ratio: float = 1.15,
                       chunks_per_part: int = 32,
                       edge_index: Optional[np.ndarray] = None
                       ) -> Tuple[np.ndarray, float, float]:
    """Rebalance by :func:`rebalance_morton` when the work imbalance exceeds
    ``balance_ratio``, keeping the original labels when that is no better.
    Returns (labels, ratio before, ratio after)."""
    work = node_work(pos, inner_radius, edge_index=edge_index)
    before = imbalance_ratio(partition_work(labels, work, n_parts))
    after = before
    if before > balance_ratio and n_parts > 1:
        new = rebalance_morton(pos, work, n_parts,
                               chunks_per_part=chunks_per_part)
        after = imbalance_ratio(partition_work(new, work, n_parts))
        if after < before:
            labels = new
            _log(f"work imbalance {before:.3f} -> {after:.3f} (max/mean over "
                 f"{n_parts} parts, threshold {balance_ratio})")
        else:
            after = before
    return labels, before, after


def split_graph(graph: dict, n_parts: int, method: str, inner_radius: float,
                outer_radius: Optional[float] = None, seed: int = 0,
                balance: bool = False,
                balance_ratio: float = 1.15) -> List[dict]:
    """One graph dict -> ``n_parts`` part dicts: each part's nodes, its
    local ``inner_radius`` edges with the distance in 2 channels as
    ``edge_attr``, and the whole graph's ``loc_mean``. ``balance`` adds the
    work-balance pass of :func:`balance_partitions`. A part may be empty."""
    pos = graph["loc"]
    labels = assign_partitions(pos, n_parts, method,
                               outer_radius=outer_radius, seed=seed)
    if balance:
        labels, _, _ = balance_partitions(pos, labels, n_parts, inner_radius,
                                          balance_ratio=balance_ratio)
    loc_mean = pos.mean(axis=0).astype(np.float32)

    def pick(key, sel):
        return None if graph.get(key) is None else graph[key][sel]

    parts = []
    for p in range(n_parts):
        sel = labels == p
        pos_p = pos[sel]
        edge_index = radius_graph_np(pos_p, inner_radius)
        dist = np.linalg.norm(pos_p[edge_index[0]] - pos_p[edge_index[1]],
                              axis=1)
        parts.append({
            "node_feat": graph["node_feat"][sel],
            "node_attr": pick("node_attr", sel),
            "loc": pos_p.astype(np.float32),
            "vel": graph["vel"][sel],
            "target": pick("target", sel),
            "loc_mean": loc_mean,
            "edge_index": edge_index.astype(np.int32),
            "edge_attr": np.repeat(dist[:, None], 2, axis=1).astype(
                np.float32),
        })
    return parts
