"""Tile rounds over several devices (port of
``distegnn_tpu/serve/mesh_tiled.py``).

The sequential tiled executor (serve/tiled.py) walks a scene's tiles one at
a time on one device. All tiles of a plan share one padded shape
(``TilePlan.shape_key``), so they group into *rounds* of D
(``ops/tiling.plan_rounds``, LPT over the plan's work model): a round runs
one tile on each of D devices at once, through the same per-tile layer, and
sums the slots' masked partials (``models/fast_egnn.reduce_tile_partials``).
The shape key is the sequential ``("tile_layer",) + shape_key`` tuple
extended with D: one key a rung, whatever the scene.

What stays the same, by the exactness argument of ops/tiling.py:

  - Every tile reads LAYER-INPUT state (the host's h / x snapshots and the
    layer-input X / Hv), so the tiles of one layer commute: running D of
    them at once is the same sum in another order.
  - The halo exchange stays a host-side gather between layers, staged per
    round; round k+1's copies (one side stream per device) overlap round
    k's compute, and device residency stays two staged rounds.
  - The virtual-node closure is exact: each round sums its slots' masked
    partials, the rounds' sums accumulate in round order, and
    ``tiled_virtual_update`` closes the layer once.

Ragged last round (``T % D != 0``): free slots carry zero inputs, an
all-zero node mask and a 0.0 validity flag, so they add nothing to the
partials, and their outputs are discarded.

``resolve_devices`` resolves ``serve.tiled.devices`` against the cards this
process sees; on one card ``'auto'`` is 1, the sequential path. The
executor can be given an explicit device list instead (the CPU tests give
the CPU device D times).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.ops.tiling import TilePlan, plan_rounds


def same_device(a: torch.device, b: torch.device) -> bool:
    """``a`` and ``b`` name one device (``cuda`` is the current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a.index == b.index
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def local_devices(device: torch.device) -> List[torch.device]:
    """The devices tile rounds may use: ``device`` first, then (for a card)
    every other visible card."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    first = device.index if device.index is not None \
        else torch.cuda.current_device()
    return [torch.device("cuda", first)] + [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())
        if i != first]


def resolve_devices(spec, n_tiles: Optional[int] = None,
                    available: Optional[int] = None) -> int:
    """Resolve the ``serve.tiled.devices`` knob to a usable device count.

    ``"auto"`` takes every available device; an int is clamped (with a
    ``serve/tiled_devices_clamped`` event, never an error: a config written
    for four cards must still serve on one) to what there is.
    ``available`` defaults to the visible cards (at least 1). Returns 1
    when there is nothing to parallelize over (``n_tiles`` <= 1
    included)."""
    avail = (int(available) if available is not None
             else max(torch.cuda.device_count(), 1))
    if spec == "auto":
        d = avail
    else:
        d = int(spec)
        if d > avail:
            obs.event("serve/tiled_devices_clamped", requested=d,
                      available=avail)
            d = avail
    if n_tiles is not None and n_tiles <= 1:
        return 1
    return max(1, d)


def run_rounds(ex, model, plan: TilePlan, batches, h_full: np.ndarray,
               x_full: np.ndarray, X, Hv, n_layers: int,
               progress: Optional[Callable] = None,
               devices: Sequence[torch.device] = ()):
    """Run all layers of one tiled scene as rounds of ``len(devices)``
    tiles.

    Mirrors the sequential loop of ``TiledExecutor`` (the same host-side
    halo gather, staging and virtual closure) with the tile axis folded
    into rounds. ``progress(layer=..., round=..., n_layers=...,
    n_rounds=..., n_tiles=...)`` fires after each ROUND; returning False
    cancels the remaining compute at the next round boundary. Returns
    ``(h_full, x_full, stats, cancelled)``, stats carrying
    rounds / devices / round_imbalance and the stall, halo-gather and
    per-round times."""
    from distegnn_tpu_torch.models.fast_egnn import (reduce_tile_partials,
                                                     tiled_virtual_update)
    from distegnn_tpu_torch.serve.tiled import TileStager

    devices = [torch.device(d) for d in devices]
    D = len(devices)
    sched = plan_rounds(plan, D)
    rounds = sched.rounds
    R = sched.n_rounds
    L = int(n_layers)
    tn = plan.tile_nodes
    H = h_full.shape[1]
    nd = batches[0].max_nodes
    ex.engine._touch(ex.layer_key(plan, D))
    models = [ex.model_on(model, d) for d in devices]
    stagers = [TileStager(d, nd, H) for d in devices]
    home = devices[0]
    X, Hv = X.to(home), Hv.to(home)

    # ragged-round filler: tile 0's batch with an all-zero node mask, zero
    # inputs (finite math, zero masked partials) and a 0.0 validity flag
    pad_batch = dataclasses.replace(
        batches[0], node_mask=torch.zeros_like(batches[0].node_mask))
    halo_gather_s = 0.0

    def stage_round(ri: int, h_src: np.ndarray, x_src: np.ndarray):
        """Gather round ri's tile inputs from the layer-input snapshot and
        start their copies, one side stream per device."""
        nonlocal halo_gather_s
        t0 = time.perf_counter()
        tiles_r = rounds[ri]
        staged = []
        for slot, st in enumerate(stagers):
            if slot < len(tiles_r):
                t = tiles_r[slot]
                staged.append(st.stage(plan.tiles[t], tn, h_src, x_src,
                                       batches[t]))
            else:
                staged.append(st.stage(None, tn, None, None, pad_batch))
        halo_gather_s += time.perf_counter() - t0
        return staged

    stall_s = 0.0
    round_s = 0.0
    rounds_done = 0
    cancelled = False
    t_loop = time.perf_counter()
    for li in range(L):
        # the scene's coordinate mean of the layer input, as sequentially
        cm = torch.from_numpy(x_full.mean(axis=0, dtype=np.float64)
                              .astype(np.float32)[None])
        h_next = np.empty_like(h_full)
        x_next = np.empty_like(x_full)
        parts = None
        staged = stage_round(0, h_full, x_full)
        for ri, tiles_r in enumerate(rounds):
            t_round = time.perf_counter()
            outs = []
            for slot, (st, m, d) in enumerate(zip(stagers, models,
                                                  devices)):
                stall_s += st.wait(staged[slot])
                h_d, x_d, b_d, _ = staged[slot]
                # every slot's layer is queued before any is read back:
                # on D cards the D tiles compute at once
                outs.append(ex.run_layer(m, li, h_d, x_d, b_d, X.to(d),
                                         Hv.to(d), cm.to(d)))
            # round ri+1's copies overlap this round's compute. Later rounds
            # read h_full / x_full (the LAYER INPUT), never h_next
            staged = (stage_round(ri + 1, h_full, x_full)
                      if ri + 1 < R else None)
            for slot, t in enumerate(tiles_r):
                s = plan.tiles[t]
                torch.from_numpy(h_next)[s.start:s.stop].copy_(
                    outs[slot][0][0, :s.n_own])
                torch.from_numpy(x_next)[s.start:s.stop].copy_(
                    outs[slot][1][0, :s.n_own])
            valid = torch.tensor([1.0 if slot < len(tiles_r) else 0.0
                                  for slot in range(D)], device=home)
            part = reduce_tile_partials(
                *(torch.stack([o[k].to(home) for o in outs])
                  for k in (2, 3, 4)), valid)
            parts = list(part) if parts is None else [
                a + b for a, b in zip(parts, part)]
            round_s += time.perf_counter() - t_round
            rounds_done += 1
            if progress is not None:
                ok = progress(layer=li, round=ri, n_layers=L, n_rounds=R,
                              n_tiles=plan.n_tiles)
                if ok is False:
                    cancelled = True
                    break
        if cancelled:
            break
        h_full, x_full = h_next, x_next
        # close the layer's virtual state from the accumulated round sums
        Hv, X = tiled_virtual_update(models[0].gcl[li], Hv, X, *parts)
    loop_s = max(time.perf_counter() - t_loop, 1e-9)
    stats = {
        "devices": D,
        "rounds": R,
        "round_imbalance": sched.round_imbalance,
        "stall_fraction": min(stall_s / loop_s, 1.0),
        "round_ms": round_s / max(rounds_done, 1) * 1e3,
        "halo_gather_ms": halo_gather_s * 1e3,
    }
    return h_full, x_full, stats, cancelled
