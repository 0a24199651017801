"""On-device radius graph with fixed shapes (port of
``distegnn_tpu/ops/radius_dev.py``).

A rollout rebuilds the graph from predicted positions every step without a
host round-trip. Plain PyTorch tensor code on the positions' device (the JAX
version has no kernel either), giving neighbour lists bitwise equal to the
JAX package's:

  1. spatial hash: cell = floor((pos - min) / r), bucket = hash(cell) mod H
     (H a power of two, ~2N buckets); the int32 hash wraps on overflow;
  2. one stable argsort groups nodes by bucket; searchsorted gives bucket
     ranges;
  3. each node probes its 27 neighbouring cells, reading at most
     ``max_per_cell`` candidates per bucket; hash-collision candidates are
     rejected by an exact integer cell compare;
  4. candidates are distance-filtered and sorted (valid first, nearest
     first, ties by candidate position: the stable sort); the first
     ``max_degree`` survive.

Shapes are fixed: [N, 27*max_per_cell] candidates, [N, max_degree]
neighbours. The output is also a blocked edge layout (ops/blocked.py):
row-major [2, N*max_degree] with per-node uniform slots, so every node block
owns a fixed edge slice (edges_per_block = max_degree * edge_block).

Capacity bounds are static; overflow DROPS the farthest neighbours, and the
returned ``cell_overflow`` / ``degree_overflow`` flags say so.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_P1, _P2, _P3 = 73856093, 19349663, 83492791  # classic spatial-hash primes


class DeviceRadiusGraph(NamedTuple):
    neighbors: torch.Tensor        # [N, K] int32 col per slot (self when padded)
    nbr_mask: torch.Tensor         # [N, K] float32 0/1
    # [N] int32 found-neighbour count (exact iff cell_overflow is False)
    degree: torch.Tensor
    cell_overflow: torch.Tensor    # [] bool: a real cell exceeded max_per_cell
    degree_overflow: torch.Tensor  # [] bool: a node exceeded max_degree


def _bucket_of(c: torch.Tensor, H: int) -> torch.Tensor:
    """int32 spatial hash of cells [..., 3] -> [..., ] in [0, H). The
    products wrap in int32 as XLA's do, and ``%`` is a floor modulo (the
    result is non-negative, also for abs(INT_MIN) == INT_MIN)."""
    h = ((c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3))
    return torch.remainder(torch.abs(h), H)


def radius_graph_dev(pos: torch.Tensor, r: float, max_degree: int,
                     max_per_cell: int = 8,
                     node_mask: Optional[torch.Tensor] = None,
                     num_buckets: Optional[int] = None) -> DeviceRadiusGraph:
    """All neighbours within ``r`` (strict) of pos [N, 3] f32, ELL layout;
    masked nodes are isolated."""
    N = pos.shape[0]
    dev = pos.device
    H = num_buckets or max(1 << (2 * N - 1).bit_length(), 16)
    valid = (torch.ones((N,), dtype=torch.float32, device=dev)
             if node_mask is None else node_mask.to(torch.float32))
    big = torch.tensor(1e30, dtype=torch.float32, device=dev)

    # cells relative to the masked min corner
    anchor = torch.where(valid[:, None] > 0, pos, big).amin(dim=0)
    cell = torch.floor((pos - anchor) / r).to(torch.int32)      # [N, 3]
    # each masked node gets its own unreachable cell: never a candidate,
    # and no pile-up in one bucket
    me = torch.arange(N, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(me)
    far = torch.stack([-(1 << 20) - me, zero, zero], dim=-1)
    cell = torch.where(valid[:, None] > 0, cell, far)

    bucket = _bucket_of(cell, H)                                # [N]
    order = torch.argsort(bucket, stable=True)                  # [N]
    sorted_bucket = bucket[order].contiguous()

    # 27 neighbouring cells per node, in the JAX meshgrid('ij') order
    ax = torch.arange(-1, 2, dtype=torch.int32, device=dev)
    off = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                      dim=-1).reshape(27, 3)
    probe_cell = cell[:, None, :] + off[None, :, :]             # [N, 27, 3]
    probe_bucket = _bucket_of(probe_cell, H).contiguous()       # [N, 27]

    start = torch.searchsorted(sorted_bucket, probe_bucket)     # [N, 27]
    end = torch.searchsorted(sorted_bucket, probe_bucket, right=True)
    M = max_per_cell
    slots = start[..., None] + torch.arange(M, device=dev)      # [N, 27, M]
    in_range = slots < end[..., None]
    cand = order[torch.clamp(slots, 0, N - 1)]                  # [N, 27, M]

    # exact cell compare: kills hash-collision candidates (and duplicates)
    same_cell = torch.all(cell[cand] == probe_cell[:, :, None, :], dim=-1)
    cand_ok = in_range & same_cell
    # only probes of real nodes count toward overflow
    cell_overflow = torch.any(((end - start) > M) & (valid[:, None] > 0))

    cand = cand.reshape(N, 27 * M)
    cand_ok = cand_ok.reshape(N, 27 * M)
    diff = pos[:, None, :] - pos[cand]                          # [N, 27M, 3]
    sq = diff * diff
    d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]                 # [N, 27M]
    hit = (cand_ok & (d2 < r * r) & (cand != me[:, None].long())
           & (valid[cand] > 0) & (valid[:, None] > 0))

    degree = torch.sum(hit, dim=1).to(torch.int32)
    degree_overflow = torch.any(degree > max_degree)

    # valid-first, nearest-first; keep the first max_degree
    key = torch.where(hit, d2, big)
    sel = torch.argsort(key, dim=1, stable=True)[:, :max_degree]
    neighbors = torch.gather(cand, 1, sel).to(torch.int32)
    nbr_mask = (torch.gather(key, 1, sel) < big).to(torch.float32)
    neighbors = torch.where(nbr_mask > 0, neighbors, me[:, None])

    return DeviceRadiusGraph(neighbors, nbr_mask, degree, cell_overflow,
                             degree_overflow)


def ell_to_edge_list(g: DeviceRadiusGraph):
    """[N, K] adjacency -> row-major edge list [2, N*K] int32 + mask
    [N*K]. Row-sorted with per-node uniform slots, so for any edge_block
    dividing N it is a blocked layout with edges_per_block = K * edge_block."""
    N, K = g.neighbors.shape
    row = torch.arange(N, dtype=torch.int32,
                       device=g.neighbors.device).repeat_interleave(K)
    col = g.neighbors.reshape(-1)
    return torch.stack([row, col]), g.nbr_mask.reshape(-1)
