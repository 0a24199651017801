"""Tiled inference executor (port of ``distegnn_tpu/serve/tiled.py``) —
scenes above the bucket ladder's cap served as fixed-shape tiles with a
host-side halo exchange.

A scene above ``serve.max_nodes`` is cut into the tiles of a Morton plan
(ops/tiling.py). Every layer runs the model's own EGCL layer over every
tile, one tile batch at a time, reading the cross-tile senders (the halo)
from the layer-input snapshot held on the host; the virtual-node state
(X, Hv), the model's only global coupling, is closed once a layer from the
tiles' masked partial sums (``EGCLVel(tile_partials=True)`` +
``tiled_virtual_update``, models/fast_egnn.py). That is the monolithic
forward in another summation order: every cross-node quantity of the layer
derives from LAYER-INPUT state (tests/test_torch_tiled.py holds it at 1e-5
scale-normalized against JAX's monolithic forward).

  - One tile shape per tile rung (``TilePlan.shape_key``), whatever the
    scene's size: the engine's shape-key LRU holds one ``tile_layer`` key
    per rung, as JAX's compile cache holds one executable.
  - Device residency is two staged tiles plus the model and the tiny
    virtual state, never O(N): the tile batches are built on the host, and
    tile t+1's inputs are copied to the card from page-locked host buffers
    on a side CUDA stream while tile t computes. The host's wait for a
    staged copy is measured and exported as the stall fraction.
  - ``edge_impl: fused`` runs the per-layer fused edge kernel on every tile
    (one launch a layer and tile); ``fused_stack`` lowers to the same
    per-layer path, whose parameters it shares: the megakernel's
    whole-loop launch cannot host a halo exchange between layers.
  - ``serve.tiled.devices`` > 1 runs rounds of D tiles over D devices
    (serve/mesh_tiled.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.ops.graph import GraphBatch, pad_graphs
from distegnn_tpu_torch.ops.tiling import TilePlan, TileSpec, plan_tiles
from distegnn_tpu_torch.serve.buckets import BucketOverflowError

#: serve.tiled: config defaults (config.py mirrors these but for enable)
TILED_DEFAULTS = {
    "enable": True,
    "max_nodes": 4_194_304,     # TiledOverflowError beyond this
    "tile_nodes": 65536,        # own-node slots per tile
    "halo_floor": 1024,         # halo rung floor (geometric growth above)
    "edge_floor": 8192,         # plain-layout edge rung floor
    "growth": 2.0,              # rung growth factor (matches the ladder)
    "timeout_factor": 8.0,      # tiled deadline = factor * request_timeout
    "devices": 1,               # 'auto'|N: tile rounds over devices
                                # (serve/mesh_tiled.py); 1 = sequential
}


class TiledOverflowError(BucketOverflowError):
    """The scene exceeds even the tiled executor's bound
    (``serve.tiled.max_nodes``). Subclasses BucketOverflowError so the
    gateway's 413 mapping applies unchanged."""


def _batch_tensors(batch: GraphBatch) -> List[torch.Tensor]:
    return [v for f in dataclasses.fields(batch)
            for v in (getattr(batch, f.name),) if isinstance(v, torch.Tensor)]


def fill_tile_inputs(h_t: np.ndarray, x_t: np.ndarray, spec: TileSpec,
                     tile_nodes: int, h_src: np.ndarray,
                     x_src: np.ndarray) -> None:
    """Gather tile ``spec``'s layer inputs from the scene's layer-input
    snapshot into ``h_t`` [nd, H] / ``x_t`` [nd, 3]: own nodes at
    [0, n_own), halo senders at [tile_nodes, tile_nodes + h), zeros
    elsewhere."""
    n_own, hh = spec.n_own, int(spec.halo.shape[0])
    for dst, src in ((h_t, h_src), (x_t, x_src)):
        dst[:n_own] = src[spec.start:spec.stop]
        dst[n_own:tile_nodes] = 0.0
        if hh:
            np.take(src, spec.halo, axis=0,
                    out=dst[tile_nodes:tile_nodes + hh])
        dst[tile_nodes + hh:] = 0.0


class TileStager:
    """Double-buffered staging of one tile's inputs onto one device.

    :meth:`stage` gathers a tile's (h, x) into the next of two host buffers
    (page-locked on a CUDA device) and starts the copies of (h, x, batch)
    on a side CUDA stream; :meth:`wait` blocks the host until they landed
    (the time it returns is the stall) and hands the tensors to the
    compute stream. A buffer is rewritten two stages later, after its copy
    was waited for. On the CPU the copies are the host arrays themselves."""

    def __init__(self, device: torch.device, nd: int, H: int):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._h = [torch.zeros((1, nd, H), pin_memory=self.cuda)
                   for _ in range(2)]
        self._x = [torch.zeros((1, nd, 3), pin_memory=self.cuda)
                   for _ in range(2)]
        self._next = 0
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def stage(self, spec: Optional[TileSpec], tile_nodes: int,
              h_src: Optional[np.ndarray], x_src: Optional[np.ndarray],
              batch: GraphBatch):
        """Start staging ``spec``'s inputs (``spec`` None: all zeros, a
        ragged round's pad slot); returns the staged handle."""
        i, self._next = self._next, self._next ^ 1
        h_t, x_t = self._h[i], self._x[i]
        if spec is None:
            h_t.zero_()
            x_t.zero_()
        else:
            fill_tile_inputs(h_t.numpy()[0], x_t.numpy()[0], spec,
                             tile_nodes, h_src, x_src)
        if not self.cuda:
            return h_t, x_t, batch, None
        with torch.cuda.stream(self.stream):
            h_d = h_t.to(self.device, non_blocking=True)
            x_d = x_t.to(self.device, non_blocking=True)
            b_d = batch.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        return h_d, x_d, b_d, ev

    def wait(self, staged) -> float:
        """Block until ``staged`` is on the device; returns the seconds
        waited. The tensors are then owned by the compute stream."""
        h_d, x_d, b_d, ev = staged
        if ev is None:
            return 0.0
        t0 = time.perf_counter()
        ev.synchronize()
        waited = time.perf_counter() - t0
        cur = torch.cuda.current_stream(self.device)
        for t in [h_d, x_d] + _batch_tensors(b_d):
            t.record_stream(cur)
        return waited


class TiledExecutor:
    """Runs one engine's model over a :class:`~distegnn_tpu_torch.ops.
    tiling.TilePlan`, sharing the engine's model, shape-key LRU and
    metrics.

    Built by :class:`~distegnn_tpu_torch.serve.engine.InferenceEngine`
    when a ``serve.tiled`` config block is enabled; the gateway dispatches
    ``n_nodes > ladder.max_nodes`` requests here (serve/transport.py routes
    them under bulk-priority admission). ``device_list``, when set, names
    the devices of tile rounds in place of the engine's device and the
    other visible cards (the CPU tests set the CPU device D times)."""

    def __init__(self, engine, cfg: Optional[dict] = None):
        c = dict(TILED_DEFAULTS)
        c.update(cfg or {})
        self.engine = engine
        self.enable = bool(c["enable"])
        self.max_nodes = int(c["max_nodes"])
        self.tile_nodes = int(c["tile_nodes"])
        self.halo_floor = int(c["halo_floor"])
        self.edge_floor = int(c["edge_floor"])
        self.growth = float(c["growth"])
        self.timeout_factor = float(c["timeout_factor"])
        # 'auto' | int, resolved per predict against the devices present:
        # plans and shape keys carry no device count, so one (possibly
        # session-cached) plan serves at any setting
        self.devices = c["devices"] if c["devices"] == "auto" \
            else int(c["devices"])
        self.device_list: Optional[Sequence[torch.device]] = None
        layout = dict(getattr(engine, "_layout_opts", {}) or {})
        impl = str(getattr(engine.model, "edge_impl", "plain") or "plain")
        # fused_stack lowers to the per-layer fused path (identical params)
        self.edge_impl = "fused" if impl in ("fused", "fused_stack") \
            else "plain"
        self.edge_block = (int(layout.get("edge_block", 512) or 512)
                           if self.edge_impl == "fused" else 0)
        self.edge_tile = int(layout.get("edge_tile", 512) or 512)
        # per-device copies of the served module for tile rounds
        self._replicas: dict = {}
        g = self.engine.metrics.registry.gauge
        self._g_tiles = g("serve/tiled_tiles")
        self._g_halo = g("serve/tiled_halo_fraction")
        self._g_stall = g("serve/tiled_stall_fraction")
        # tile-round gauges (serve/mesh_tiled.py): devices used by the last
        # tiled predict, mean ms per round, host halo-gather ms
        self._g_devices = g("serve/tiled_devices")
        self._g_round_ms = g("serve/tiled_round_ms")
        self._g_halo_gather = g("serve/tiled_halo_gather_ms")

    # ---- admission -------------------------------------------------------
    def check_admit(self, n: int) -> None:
        if int(n) > self.max_nodes:
            raise TiledOverflowError(
                f"request nodes={int(n)} exceeds the tiled serving bound "
                f"{self.max_nodes}; raise serve.tiled.max_nodes or shard "
                f"the request")

    # ---- planning --------------------------------------------------------
    def plan(self, graph: dict) -> TilePlan:
        """Morton tile plan for one scene (ops/tiling.plan_tiles with this
        engine's layout). Cacheable per session (serve/prep.py)."""
        return plan_tiles(
            np.asarray(graph["edge_index"]), np.asarray(graph["loc"]),
            np.asarray(graph["edge_attr"])
            if graph.get("edge_attr") is not None else None,
            tile_nodes=self.tile_nodes, halo_floor=self.halo_floor,
            edge_floor=self.edge_floor, growth=self.growth,
            edge_block=self.edge_block, edge_tile=self.edge_tile)

    def _plan_ok(self, plan: TilePlan, n: int) -> bool:
        """A cached plan is reusable only if it was built for this layout
        and scene size (a blue/green swap can change the edge impl)."""
        return (plan.n_nodes == n and plan.edge_block == self.edge_block
                and plan.tile_nodes == self.tile_nodes)

    # ---- tile batch construction ----------------------------------------
    def _tile_batch(self, plan: TilePlan, spec: TileSpec, loc, vel, feat,
                    node_attr, loc_mean) -> GraphBatch:
        """One tile's padded host GraphBatch: own nodes at [0, n_own), halo
        senders at [tile_nodes, tile_nodes + h), node_mask OWN-ONLY so the
        tile's partials count each scene node exactly once. Halo senders
        still send: no edge lowering masks a message by its sender's node
        mask, only by the edge mask."""
        nd = plan.tile_nodes + plan.halo_pad
        n_own, halo = spec.n_own, spec.halo
        h = int(halo.shape[0])
        tn = plan.tile_nodes

        def rows(src):
            out = np.zeros((nd, src.shape[1]), np.float32)
            out[:n_own] = src[spec.start:spec.stop]
            if h:
                out[tn:tn + h] = src[halo]
            return out

        d = {"node_feat": rows(feat), "loc": rows(loc), "vel": rows(vel),
             "edge_index": spec.edge_index, "edge_attr": spec.edge_attr,
             "loc_mean": loc_mean}
        if node_attr is not None:
            d["node_attr"] = rows(node_attr)
        if plan.edge_block:
            batch = pad_graphs([d], max_nodes=plan.padded_nodes,
                               edge_block=plan.edge_block,
                               edges_per_block=plan.edges_per_block,
                               edge_tile=plan.edge_tile, compute_pair=False,
                               split_remote=True, remote_pad=plan.remote_pad)
        else:
            batch = pad_graphs([d], max_nodes=plan.padded_nodes,
                               max_edges=plan.edge_pad, node_bucket=1,
                               edge_bucket=1)
        own = torch.zeros((1, batch.max_nodes), dtype=torch.float32)
        own[0, :n_own] = 1.0
        return dataclasses.replace(batch, node_mask=own)

    # ---- the per-tile pieces ---------------------------------------------
    def layer_key(self, plan: TilePlan, *extra) -> tuple:
        """The shape key of the per-tile layer: one per tile rung and layer
        config (the tile-round path appends its device count)."""
        model = self.engine.model
        return ("tile_layer",) + plan.shape_key + (
            self.edge_impl, int(model.hidden_nf),
            int(model.virtual_channels)) + tuple(extra)

    def run_layer(self, model, li: int, h, x, batch: GraphBatch, X, Hv, cm):
        """Layer ``li`` of ``model`` over one staged tile batch ->
        ``(h', x', transX_part, vef_part, count)``; shared by the
        sequential loop and the tile rounds (serve/mesh_tiled.py)."""
        from distegnn_tpu_torch.ops.blocked import blocked_slot_inv_deg
        from distegnn_tpu_torch.ops.edge_pipeline import build_edge_blocks

        layer = model.gcl[li]
        fused_arrs = None
        blocked = (None,) * 4
        if self.edge_impl == "fused":
            fused_arrs = build_edge_blocks(
                batch.row, batch.col, batch.edge_attr, batch.edge_mask,
                block=batch.edge_block, n_nodes=batch.max_nodes)
        else:
            blocked = blocked_slot_inv_deg(batch, model.blocked_impl)
        gravity = model.gravity if model.has_gravity else None
        return layer(h, x, batch.vel, X, Hv, batch, fused_arrs, gravity,
                     *blocked, tile_coord_mean=cm, tile_partials=True)

    def model_on(self, model, device: torch.device):
        """``model`` on ``device``: the served module itself on its own
        device, else a copy kept until the served module changes."""
        from distegnn_tpu_torch.serve.mesh_tiled import same_device

        if same_device(device, self.engine.device):
            return model
        key = (id(model), device)
        m = self._replicas.get(key)
        if m is None:
            import copy

            self._replicas = {k: v for k, v in self._replicas.items()
                              if k[0] == id(model)}
            m = copy.deepcopy(model).to(device).eval()
            self._replicas[key] = m
        return m

    # ---- execution -------------------------------------------------------
    def predict(self, graph: dict, *, plan: Optional[TilePlan] = None,
                request_id: Optional[str] = None,
                progress: Optional[Callable[..., Optional[bool]]] = None,
                ) -> dict:
        """Serve one giant scene. Returns a dict with the UNPADDED predicted
        positions (original node order) and the tiling stats the NDJSON
        progress stream reports.

        ``progress(layer=..., tile=..., n_layers=..., n_tiles=...)`` is
        called after each tile completes; returning False cancels the
        remaining compute at the next tile boundary (the streamed-rollout
        disconnect contract, applied to tiles)."""
        engine = self.engine
        model = engine.model
        dev = engine.device
        n = int(graph["loc"].shape[0])
        self.check_admit(n)
        t0 = time.perf_counter()
        if plan is None or not self._plan_ok(plan, n):
            plan = self.plan(graph)
        L = int(model.n_layers)
        T = plan.n_tiles
        H = int(model.hidden_nf)
        C = int(model.virtual_channels)

        # scene arrays in Morton order (plan.perm[new] = old)
        p = plan.perm
        loc = np.ascontiguousarray(np.asarray(graph["loc"], np.float32)[p])
        vel = np.ascontiguousarray(np.asarray(graph["vel"], np.float32)[p])
        feat = np.ascontiguousarray(
            np.asarray(graph["node_feat"], np.float32)[p])
        na = graph.get("node_attr")
        node_attr = (np.ascontiguousarray(np.asarray(na, np.float32)[p])
                     if na is not None and np.asarray(na).size else None)
        loc_mean = np.asarray(graph["loc"], np.float32).mean(axis=0)[None]

        with obs.span("serve/tiled", n=n, tiles=T, layers=L,
                      padded_nodes=plan.padded_nodes,
                      halo_fraction=round(plan.halo_fraction, 4),
                      work_imbalance=round(plan.work_imbalance, 4),
                      request_id=request_id or "") as sp, \
                torch.no_grad():
            # the tile batches live on the host (page-locked on a card),
            # never all on the device
            batches = [self._tile_batch(plan, s, loc, vel, feat, node_attr,
                                        loc_mean) for s in plan.tiles]
            if dev.type == "cuda":
                batches = [b.pin_memory() for b in batches]
            prep_ms = (time.perf_counter() - t0) * 1e3

            # bootstrap: h0 = embedding(node_feat) tile by tile (one shape)
            engine._touch(("tile_embed", self.tile_nodes, feat.shape[1], H))
            h_full = np.empty((n, H), np.float32)
            buf = np.zeros((self.tile_nodes, feat.shape[1]), np.float32)
            for s in plan.tiles:
                buf[:] = 0.0
                buf[:s.n_own] = feat[s.start:s.stop]
                emb = model.embedding_in(torch.from_numpy(buf).to(dev))
                torch.from_numpy(h_full)[s.start:s.stop].copy_(
                    emb[:s.n_own])
            x_full = loc.copy()
            X = torch.from_numpy(loc_mean).to(dev)[:, :, None].repeat(
                1, 1, C)                                     # [1, 3, C]
            Hv = model.virtual_node_feat.detach().clone()    # [1, H, C]
            engine._touch(("tile_virtual", H, C))

            from distegnn_tpu_torch.serve import mesh_tiled

            avail = (self.device_list if self.device_list is not None
                     else mesh_tiled.local_devices(dev))
            D = mesh_tiled.resolve_devices(self.devices, n_tiles=T,
                                           available=len(avail))
            mesh_stats = None
            if D > 1:
                h_full, x_full, mesh_stats, cancelled = mesh_tiled.run_rounds(
                    self, model, plan, batches, h_full, x_full, X, Hv, L,
                    progress=progress, devices=avail[:D])
                stall_frac = mesh_stats["stall_fraction"]
                rounds = mesh_stats["rounds"]
                sp.set(stall_fraction=round(stall_frac, 4),
                       cancelled=cancelled, devices=D, rounds=rounds,
                       round_ms=round(mesh_stats["round_ms"], 3))
            else:
                h_full, x_full, stall_frac, cancelled = self._run_sequential(
                    model, plan, batches, h_full, x_full, X, Hv, L, progress)
                rounds = T      # each sequential tile is its own round
                sp.set(stall_fraction=round(stall_frac, 4),
                       cancelled=cancelled)

        self._g_tiles.set(T)
        self._g_halo.set(round(plan.halo_fraction, 6))
        self._g_stall.set(round(stall_frac, 6))
        self._g_devices.set(D)
        if mesh_stats is not None:
            self._g_round_ms.set(round(mesh_stats["round_ms"], 3))
            self._g_halo_gather.set(round(mesh_stats["halo_gather_ms"], 3))
        out = None
        if not cancelled:
            out = np.ascontiguousarray(x_full[plan.inv_perm])
        result = {
            "prediction": out,
            "n": n,
            "tiles": T,
            "layers": L,
            "devices": D,
            "rounds": rounds,
            "padded_nodes": plan.padded_nodes,
            "halo_fraction": plan.halo_fraction,
            "work_imbalance": plan.work_imbalance,
            "stall_fraction": stall_frac,
            "prep_ms": prep_ms,
            "total_ms": (time.perf_counter() - t0) * 1e3,
            "cancelled": cancelled,
        }
        if mesh_stats is not None:
            result["round_ms"] = mesh_stats["round_ms"]
            result["halo_gather_ms"] = mesh_stats["halo_gather_ms"]
            result["round_imbalance"] = mesh_stats["round_imbalance"]
        return result

    def _run_sequential(self, model, plan: TilePlan, batches, h_full, x_full,
                        X, Hv, L: int, progress):
        """The single-device tile loop: one tile at a time through the
        model's layer, tile t+1's inputs staged while tile t computes,
        per-tile progress. The partials are summed on the device in f32 and
        in tile order, so the loop is deterministic."""
        from distegnn_tpu_torch.models.fast_egnn import tiled_virtual_update

        engine = self.engine
        dev = engine.device
        T = plan.n_tiles
        engine._touch(self.layer_key(plan))
        stager = TileStager(dev, batches[0].max_nodes, h_full.shape[1])
        stall_s = 0.0
        cancelled = False
        t_loop = time.perf_counter()
        for li in range(L):
            # the SCENE's coordinate mean of the layer input (a tile-local
            # mean would be wrong)
            cm = torch.from_numpy(x_full.mean(axis=0, dtype=np.float64)
                                  .astype(np.float32)[None]).to(dev)
            h_next = np.empty_like(h_full)
            x_next = np.empty_like(x_full)
            parts = None
            staged = stager.stage(plan.tiles[0], plan.tile_nodes, h_full,
                                  x_full, batches[0])
            for ti, s in enumerate(plan.tiles):
                stall_s += stager.wait(staged)
                h_d, x_d, b_d, _ = staged
                h_o, x_o, *part = self.run_layer(model, li, h_d, x_d, b_d,
                                                 X, Hv, cm)
                # tile ti+1's copies overlap this compute. Later tiles read
                # h_full / x_full (the LAYER INPUT), never h_next: that is
                # what makes tiling exact
                staged = (stager.stage(plan.tiles[ti + 1], plan.tile_nodes,
                                       h_full, x_full, batches[ti + 1])
                          if ti + 1 < T else None)
                torch.from_numpy(h_next)[s.start:s.stop].copy_(
                    h_o[0, :s.n_own])
                torch.from_numpy(x_next)[s.start:s.stop].copy_(
                    x_o[0, :s.n_own])
                parts = part if parts is None else [
                    a + b for a, b in zip(parts, part)]
                if progress is not None:
                    ok = progress(layer=li, tile=ti, n_layers=L, n_tiles=T)
                    if ok is False:
                        cancelled = True
                        break
            if cancelled:
                break
            h_full, x_full = h_next, x_next
            # close the layer's virtual state from the tile partials, once
            Hv, X = tiled_virtual_update(model.gcl[li], Hv, X, *parts)
        loop_s = max(time.perf_counter() - t_loop, 1e-9)
        return h_full, x_full, min(stall_s / loop_s, 1.0), cancelled
