"""Morton-ordered fixed-shape tile plans (port of
``distegnn_tpu/ops/tiling.py``, numpy only) — serving scenes above the
bucket ladder's cap.

A scene too large for one padded batch is cut into contiguous segments of
the Morton curve ("tiles"). Each tile owns a node range plus the edges
RECEIVED by those nodes; senders outside the range form a compact *halo* —
the only cross-tile coupling, because every per-edge quantity in the EGCL
layer reads sender state from the LAYER INPUT (models/fast_egnn.py).
Running layer l over all tiles, then exchanging halo features on the host,
is therefore exactly the monolithic forward in a different summation order.

Every tile of every scene pads to ONE (tile_nodes + halo_pad, edge_pad)
shape whose free axes are quantized to a geometric ladder (growth rungs from
fixed floors, like serve/buckets.py), so the tile shape is
scene-independent: a fleet serving many giant scenes runs one tile shape per
rung (``TilePlan.shape_key``, one key of the engine's shape LRU).

Work balance reuses the data/partition.py model (``node_work``: a + b*deg):
tile boundaries sweep the Morton order accumulating work until the
per-tile budget is met, so a dense cluster lands in more, smaller-span
tiles instead of one overloaded one.

The plans are equal to the JAX package's for the same scene: the same
permutation, bounds, halos, tile-local edges, pads and shape key.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np

from distegnn_tpu_torch.data.partition import node_work
from distegnn_tpu_torch.ops.order import morton_perm


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def shape_rung(size: int, floor: int, growth: float = 2.0,
               multiple: int = 1) -> int:
    """Smallest ``floor * growth^k`` (rounded up to ``multiple``) admitting
    ``size`` — the scene-independent quantizer for every free tile axis.
    Mirrors BucketLadder._rung without a cap: tiles never reject, they are
    the path requests land on AFTER the ladder cap rejected them."""
    size = max(int(size), 1)
    floor = max(int(floor), 1)
    k = max(0, math.ceil(math.log(size / floor, growth)))
    while floor * growth ** k < size:   # float-log fixup on exact powers
        k += 1
    r = int(math.ceil(floor * growth ** k))
    return _round_up(r, max(int(multiple), 1))


class TileSpec(NamedTuple):
    """One tile: a contiguous Morton-order node range + its received edges."""

    start: int                 # own range [start, stop) in Morton order
    stop: int
    halo: np.ndarray           # [h] int32 Morton-order ids of halo senders
    edge_index: np.ndarray     # [2, e] int32 tile-LOCAL (own: i-start;
                               #   halo sender: tile_nodes + halo rank)
    edge_attr: np.ndarray      # [e, D] float32

    @property
    def n_own(self) -> int:
        return self.stop - self.start

    @property
    def n_halo(self) -> int:
        return int(self.halo.shape[0])


class TilePlan(NamedTuple):
    """A scene's full tile decomposition + the ONE padded tile shape."""

    n_nodes: int
    n_edges: int
    perm: np.ndarray           # [n] Morton relabel, perm[new] = old
    inv_perm: np.ndarray       # [n] inverse (inv_perm[old] = new)
    tiles: Tuple[TileSpec, ...]
    tile_nodes: int            # own-node slots per tile (halo local base)
    halo_pad: int              # rung-quantized halo slots (common to tiles)
    edge_pad: int              # rung-quantized edge slots (plain layout)
    edge_block: int            # 0 = plain layout
    edge_tile: int             # blocked layouts: epb rounding quantum
    edges_per_block: int       # blocked layouts: pinned epb (0 when plain)
    remote_pad: int            # blocked layouts: pinned remote width
    halo_total: int            # sum of per-tile halo counts
    work_imbalance: float      # max/mean per-tile work under the node_work model

    @property
    def n_tiles(self) -> int:
        return len(self.tiles)

    @property
    def padded_nodes(self) -> int:
        """Per-tile padded node count — the tile batch's node axis."""
        n = self.tile_nodes + self.halo_pad
        if self.edge_block:
            # fused kernel wants a block multiple and a full 3-block window
            n = max(_round_up(n, self.edge_block), 3 * self.edge_block)
        return n

    @property
    def halo_fraction(self) -> float:
        """Fraction of gathered node slots that are halo duplicates — the
        cross-tile traffic overhead vs. a monolithic forward."""
        return self.halo_total / max(self.halo_total + self.n_nodes, 1)

    @property
    def shape_key(self) -> tuple:
        """The tile program's shape axes: equal keys => one tile shape, one
    entry of the engine's shape-key LRU."""
        return (self.padded_nodes, self.edge_pad, self.edge_block,
                self.edges_per_block, self.remote_pad)


class RoundSchedule(NamedTuple):
    """Device-parallel execution order for one :class:`TilePlan`: the plan's
    tiles grouped into ``ceil(T / D)`` *rounds* of at most ``n_devices``
    tiles each. Every tile of a round runs at once, one per device, through
    the same per-tile layer (serve/mesh_tiled.py) — legal because all tiles
    share the plan's single padded shape, and exact
    because every tile reads LAYER-INPUT state (tile order never matters
    within a layer). Rounds are LPT-balanced on the plan's work model so the
    host-side halo gather + readback cost of the heaviest round never
    dominates; a round with fewer than ``n_devices`` tiles (``T % D != 0``)
    pads its free slots with zero-masked filler tiles, hard-masked by a
    per-slot validity flag."""

    rounds: Tuple[Tuple[int, ...], ...]   # tile indices per round, each <= D
    n_devices: int
    round_imbalance: float    # max/mean per-round work under the work model

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)


def tile_work(plan: TilePlan) -> np.ndarray:
    """Per-tile work under the ``node_work`` model with unit costs
    (``a + b*deg`` summed over a tile = own nodes + received edges).
    Recomputed from the tile specs — NOT stored on the plan — so plans stay
    device-count-independent (a plan cached at ``devices: 1`` schedules at
    any D without a rebuild)."""
    return np.asarray(
        [s.n_own + s.edge_index.shape[1] for s in plan.tiles], np.float64)


def plan_rounds(plan: TilePlan, n_devices: int,
                work: Optional[np.ndarray] = None) -> RoundSchedule:
    """Group ``plan``'s tiles into ``ceil(T / D)`` rounds of at most
    ``n_devices`` via LPT (longest-processing-time-first): tiles in
    descending work order each land in the least-loaded round with a free
    slot. Deterministic (stable sort + first-min tie-break). The per-tile
    COMPUTE is shape-identical by construction; what LPT balances is the
    per-round host work — halo gather bytes and result readback scale with
    a round's real (unpadded) nodes + edges."""
    D = max(int(n_devices), 1)
    T = plan.n_tiles
    if work is None:
        work = tile_work(plan)
    work = np.asarray(work, np.float64)
    if work.shape[0] != T:
        raise ValueError(f"plan_rounds: work has {work.shape[0]} entries "
                         f"for {T} tiles")
    R = -(-T // D)
    loads = np.zeros(R, np.float64)
    slots: list = [[] for _ in range(R)]
    for t in np.argsort(-work, kind="stable"):
        free = [r for r in range(R) if len(slots[r]) < D]
        ri = min(free, key=lambda r: (loads[r], r))
        slots[ri].append(int(t))
        loads[ri] += work[t]
    rounds = tuple(tuple(sorted(s)) for s in slots)
    imb = float(loads.max() / max(loads.mean(), 1e-30))
    return RoundSchedule(rounds=rounds, n_devices=D, round_imbalance=imb)


def plan_tiles(edge_index: np.ndarray, loc: np.ndarray,
               edge_attr: Optional[np.ndarray] = None, *,
               tile_nodes: int = 65536, halo_floor: int = 1024,
               edge_floor: int = 8192, growth: float = 2.0,
               edge_block: int = 0, edge_tile: int = 512,
               bits: int = 16, work_node_cost: float = 1.0,
               work_edge_cost: float = 1.0) -> TilePlan:
    """Compute a work-balanced Morton tile plan for one scene.

    ``edge_index`` [2, E] (row=receiver, col=sender) and ``loc`` [n, 3] are
    the scene's ORIGINAL node ids; the plan carries the Morton relabel
    (``perm``/``inv_perm``) and every tile's edges in tile-local ids, so the
    executor only gathers. ``edge_block > 0`` plans for the blocked/fused
    layout and pins ``edges_per_block`` and the remote width across tiles —
    pad_graphs must not re-derive them per tile or every tile would have
    its own shape.
    """
    loc = np.asarray(loc)
    edge_index = np.asarray(edge_index)
    n = int(loc.shape[0])
    e_total = int(edge_index.shape[1])
    if n < 1:
        raise ValueError("plan_tiles: empty scene")
    if edge_attr is None:
        edge_attr = np.zeros((e_total, 0), np.float32)
    edge_attr = np.asarray(edge_attr, np.float32)
    tile_nodes = int(tile_nodes)
    if tile_nodes < 1:
        raise ValueError(f"plan_tiles: tile_nodes must be >= 1 (got {tile_nodes})")

    # Morton relabel: contiguous id ranges become compact curve segments, so
    # cross-tile (halo) edges stay a small fraction of E
    perm = morton_perm(loc, bits=bits)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(n, dtype=perm.dtype)
    row = inv_perm[edge_index[0].astype(np.int64, copy=False)]
    col = inv_perm[edge_index[1].astype(np.int64, copy=False)]
    order = np.argsort(row, kind="stable")
    row, col = row[order], col[order]
    ea = np.ascontiguousarray(edge_attr[order])

    # tile boundaries: greedy work-budget sweep along the Morton order,
    # capped at tile_nodes own slots (the data/partition.py skew model)
    work = node_work(loc[perm], 0.0, a=work_node_cost, b=work_edge_cost,
                     edge_index=np.stack([row, col]))
    cum = np.cumsum(work)
    budget = cum[-1] / max(-(-n // tile_nodes), 1)
    starts = [0]
    while starts[-1] < n:
        s = starts[-1]
        base = cum[s - 1] if s else 0.0
        e = int(np.searchsorted(cum, base + budget, side="left")) + 1
        starts.append(min(max(e, s + 1), s + tile_nodes, n))

    # per-tile edge slices (rows are sorted) + halo extraction
    tiles = []
    halo_total = 0
    max_halo = max_edges = 0
    tile_work = []
    for s, t in zip(starts[:-1], starts[1:]):
        es, ee = np.searchsorted(row, s), np.searchsorted(row, t)
        r_t, c_t = row[es:ee], col[es:ee]
        outside = (c_t < s) | (c_t >= t)
        halo = np.unique(c_t[outside]).astype(np.int32)
        lrow = (r_t - s).astype(np.int32)
        lcol = np.where(outside,
                        tile_nodes + np.searchsorted(halo, c_t),
                        c_t - s).astype(np.int32)
        tiles.append(TileSpec(start=int(s), stop=int(t), halo=halo,
                              edge_index=np.stack([lrow, lcol]),
                              edge_attr=np.ascontiguousarray(ea[es:ee])))
        halo_total += int(halo.shape[0])
        max_halo = max(max_halo, int(halo.shape[0]))
        max_edges = max(max_edges, int(ee - es))
        base = cum[s - 1] if s else 0.0
        tile_work.append(cum[t - 1] - base)

    halo_pad = shape_rung(max(max_halo, 1), halo_floor, growth)
    edge_pad = shape_rung(max(max_edges, 1), edge_floor, growth)
    tw = np.asarray(tile_work, np.float64)
    imbalance = float(tw.max() / max(tw.mean(), 1e-30))

    epb = rpad = 0
    if edge_block:
        from distegnn_tpu_torch.ops.blocked import max_block_degree
        from distegnn_tpu_torch.ops.edge_pipeline import count_remote_edges

        padded = max(_round_up(tile_nodes + halo_pad, edge_block),
                     3 * edge_block)
        deg = max(max_block_degree(t.edge_index[0], padded, edge_block)
                  for t in tiles)
        epb = shape_rung(max(deg, 1), edge_tile, growth, multiple=edge_tile)
        rmax = max(count_remote_edges(t.edge_index, block=edge_block,
                                      n_nodes=padded) for t in tiles)
        rpad = shape_rung(max(rmax, 1), 128, growth, multiple=128)
        edge_pad = 0    # blocked layouts size edges via epb, not edge_pad

    return TilePlan(n_nodes=n, n_edges=e_total, perm=perm, inv_perm=inv_perm,
                    tiles=tuple(tiles), tile_nodes=tile_nodes,
                    halo_pad=halo_pad, edge_pad=edge_pad,
                    edge_block=int(edge_block), edge_tile=int(edge_tile),
                    edges_per_block=int(epb), remote_pad=int(rpad),
                    halo_total=halo_total, work_imbalance=imbalance)
