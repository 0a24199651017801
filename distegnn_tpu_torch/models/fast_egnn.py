"""FastEGNN — EGNN with C learnable virtual nodes per graph (port of
``distegnn_tpu/models/fast_egnn.py``).

Two lowerings of each layer's real edges, as in the JAX package
(``edge_impl``):

  plain  (the default) per-edge streams through ``EdgeOps``
         (ops/blocked.py): gathers, the edge MLP phi_e (hoisted to the node
         axis, or the reference concat MLP), the coordinate head phi_x,
         optional attention gate, and the aggregations. On a plain
         row-sorted batch one packed aggregation per layer, lowered as
         ``scatter`` (``index_add_``), ``cumsum`` (the CUDA prefix-scan
         kernel on the card) or ``ell``; on a blocked batch (``edge_block``
         > 0) the blocked one-hot ops, lowered by ``blocked_impl`` as
         ``pallas`` (the CUDA kernels ``csrc/blocked_onehot.cu`` on the
         card) or ``einsum`` (plain PyTorch contractions);
  fused  in-window edges through ``fused_edge_layer`` (the CUDA kernels on
         the card) over a blocked ``split_remote`` batch, the remote tail as
         plain tensor code plus ``index_add_``.

The virtual-node section is dense tensor code either way. Gradients flow
through every path; ``remat=True`` checkpoints each layer, as
``nn.remat(EGCLVel)`` does in the JAX package: its activations are
recomputed in the backward pass instead of kept.

``FastEGNN(edge_impl='fused_stack')`` builds the same ``'fused'`` layers
(the ``state_dict`` is identical) but runs the whole layer loop of the whole
batch as ONE launch of the megakernel ``fused_egnn_stack_batch``
(ops/layer_pipeline.py), with the per-layer parameters stacked at run time.

``axis_name`` (the ``graph`` axis of a distributed run, parallel/mesh.py)
makes the three node means of every layer global across the graph parts
(parallel/collectives.py). ``tensor_axis`` (the ``tensor`` axis) splits the
hidden width of phi_e, phi_x and phi_h over the tensor ranks, one
collective an MLP, as the JAX package does: phi_e gathers its two hoisted
node-axis products; phi_x's partial scalar rides coord_diff and the row
aggregation to the node axis, where one sum of [B, N, 3] closes it; phi_h
is split by columns, then rows, closed by one sum of [B, N, H]. The fused
path feeds the same kernel 1/T slices of phi_x's weights (w3 [H, H/T], b3
and w4 [H/T]). The virtual-node MLPs stay replicated, and the parameters
stay full on every rank. A collective cannot run inside the megakernel, so
under either axis ``fused_stack`` runs the per-layer ``fused`` path, as the
JAX package does; the parameters are the same.

Tiled serving (serve/tiled.py) runs one ``EGCLVel`` over one tile of a
larger scene with ``tile_coord_mean`` / ``tile_partials=True``; the
executor sums the tiles' partials and closes the virtual nodes once a layer
with :func:`tiled_virtual_update` (:func:`reduce_tile_partials` sums one
round of tiles over several devices).

Layouts follow the JAX package at every public boundary: ``[B, N, ...]``
node arrays, virtual coordinates ``[B, 3, C]`` and virtual features
``[B, H, C]``. Shape legend: B graphs, N padded nodes, E padded edges,
H hidden, C virtual channels.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from distegnn_tpu_torch.models.common import (MLP, CoordMLP, HoistedEdgeMLP,
                                              TorchDense, gather_nodes,
                                              resolve_dtype, uniform_)
from distegnn_tpu_torch.ops.blocked import EdgeOps, blocked_slot_inv_deg
from distegnn_tpu_torch.ops.edge_pipeline import (EdgeWeights,
                                                  build_edge_blocks,
                                                  fused_edge_layer)
from distegnn_tpu_torch.ops.graph import GraphBatch
from distegnn_tpu_torch.ops.layer_pipeline import (DEFAULT_STACK_VMEM_BUDGET,
                                                   StackConfig,
                                                   fused_egnn_stack_batch,
                                                   stack_weight_shapes)
from distegnn_tpu_torch.ops.segment import masked_sum, segment_sum
from distegnn_tpu_torch.parallel.collectives import (global_node_mean,
                                                     tp_copy, tp_gather,
                                                     tp_once, tp_reduce,
                                                     tp_slice)

_FUSED_HEADS = ("edge_impl='fused' supports the flagship EGCL only: "
                "attention/normalize/tanh are baked out of the kernel — use "
                "edge_impl='plain' with those heads")


class FusedEdgeParams(nn.Module):
    """Raw phi_e + phi_x parameters of ``edge_impl='fused'``, in the JAX
    package's ``[in, out]`` orientation: w1 [2H+S, H], b1 [H], w2/w3 [H, H],
    b2/b3 [H], w4 [H, 1] (coordinate head, no bias)."""

    def __init__(self, hidden_nf: int, scalar_nf: int, *, generator=None):
        super().__init__()
        H, fan1 = hidden_nf, 2 * hidden_nf + scalar_nf

        def p(*shape):
            return nn.Parameter(torch.empty(shape))

        self.w1, self.b1 = p(fan1, H), p(H)
        self.w2, self.b2 = p(H, H), p(H)
        self.w3, self.b3 = p(H, H), p(H)
        self.w4 = p(H, 1)
        for w, b, fan in ((self.w1, self.b1, fan1), (self.w2, self.b2, H),
                          (self.w3, self.b3, H)):
            uniform_(w, 1.0 / math.sqrt(fan), generator)
            uniform_(b, 1.0 / math.sqrt(fan), generator)
        uniform_(self.w4, 1e-3 * math.sqrt(6.0 / (H + 1)), generator)


class EGCLVel(nn.Module):
    """E(n)-equivariant layer with velocity and virtual-node channels
    (reference E_GCL_vel): MLPs phi_e, phi_ev, phi_x, phi_xv, phi_X, phi_v,
    phi_h, phi_hv, the optional attention gates ``att``/``att_v``, the
    gravity head ``phi_g`` (``has_gravity``), and the real edges through
    ``edge_impl`` (see the module docstring)."""

    def __init__(self, hidden_nf: int, virtual_channels: int,
                 node_attr_nf: int = 0, edge_attr_nf: int = 2, *,
                 residual: bool = True, attention: bool = False,
                 normalize: bool = False, coords_agg: str = "mean",
                 tanh: bool = False, has_gravity: bool = False,
                 epsilon: float = 1e-8, compute_dtype=None,
                 hoist_edge_mlp: bool = True,
                 seg_impl: str = "scatter", fuse_agg: bool = True,
                 agg_dtype=None, edge_impl: str = "plain",
                 blocked_impl: str = "einsum",
                 axis_name: Optional[str] = None,
                 tensor_axis: Optional[str] = None, generator=None):
        super().__init__()
        if edge_impl not in ("plain", "fused"):
            raise ValueError(f"unknown edge_impl {edge_impl!r}")
        if coords_agg not in ("sum", "mean"):
            raise ValueError(f"Wrong coords_agg parameter {coords_agg!r}")
        if seg_impl not in ("scatter", "cumsum", "ell"):
            raise ValueError(f"unknown seg_impl {seg_impl!r}")
        if blocked_impl not in ("einsum", "pallas"):
            raise ValueError(f"unknown blocked impl {blocked_impl!r}")
        fused = edge_impl == "fused"
        if fused and (attention or normalize or tanh):
            raise ValueError(_FUSED_HEADS)
        if fused and edge_attr_nf != 2:
            raise ValueError(
                f"edge_impl='fused' requires edge_attr_nf=2 (the kernel "
                f"scalar lanes are [radial, attr0, attr1]); got {edge_attr_nf}")
        if tensor_axis is not None and not fused and not hoist_edge_mlp:
            raise ValueError(
                "tensor parallelism requires hoist_edge_mlp=True (phi_e's "
                "collective is the node-level gather of the hoisted "
                "products; the concat-shaped phi_e would need a per-edge "
                "gather)")
        H, C = hidden_nf, virtual_channels
        self.hidden_nf, self.virtual_channels = H, C
        self.node_attr_nf, self.edge_attr_nf = node_attr_nf, edge_attr_nf
        self.residual, self.attention = residual, attention
        self.normalize, self.coords_agg = normalize, coords_agg
        self.has_gravity = has_gravity
        self.epsilon = epsilon
        self.hoist_edge_mlp, self.seg_impl = hoist_edge_mlp, seg_impl
        self.fuse_agg, self.agg_dtype = fuse_agg, agg_dtype
        self.edge_impl, self.blocked_impl = edge_impl, blocked_impl
        self.axis_name, self.tensor_axis = axis_name, tensor_axis
        self.dt = resolve_dtype(compute_dtype)
        kw = dict(dtype=self.dt, generator=generator)
        tp = dict(tensor_axis=tensor_axis)
        if fused:
            self.phi_e_fused = FusedEdgeParams(H, 1 + edge_attr_nf,
                                               generator=generator)
        else:
            S = 1 + edge_attr_nf
            self.phi_e = (HoistedEdgeMLP(H, S, **kw, **tp) if hoist_edge_mlp
                          else MLP(2 * H + S, [H, H], act_last=True, **kw))
            if attention:
                self.att = TorchDense(H, 1, **kw)
            self.phi_x = CoordMLP(H, H, tanh=tanh, **kw, **tp)
        self.phi_ev = MLP(2 * H + 1 + C, [H, H], act_last=True, **kw)
        if attention:
            self.att_v = TorchDense(H, 1, **kw)
        self.phi_xv = CoordMLP(H, H, tanh=tanh, **kw)
        self.phi_X = CoordMLP(H, H, tanh=tanh, **kw)
        self.phi_v = MLP(H, [H, 1], **kw)
        self.phi_h = MLP(3 * H + node_attr_nf, [H, H], **kw, **tp)
        self.phi_hv = MLP(2 * H, [H, H], **kw)
        if has_gravity:
            self.phi_g = MLP(H, [H, 1], **kw)

    def _c(self, a: torch.Tensor) -> torch.Tensor:
        return a.to(self.dt) if self.dt is not None else a

    def _fused_edges(self, h, x, g: GraphBatch, fused_arrs):
        """In-window kernel sums plus the remote tail -> (agg, agg_h).

        Under ``tensor_axis`` the same kernel takes 1/T slices of phi_x's
        weights (w3 [H, H/T], b3 and w4 [H/T]), so its trans_sum is the
        rank's partial (closed by one sum over the axis) while count and
        ef_sum come out alike on every rank. The kernel's inputs that carry
        gradients are ``tp_copy`` wrapped (its cotangents mix the partial
        phi_x path with the replicated phi_e path), and the replicated
        outputs ``tp_once`` wrapped, so that the copies' sums count their
        cotangent once. The remote tail runs under the same slicing."""
        H, c, p, tx = self.hidden_nf, self._c, self.phi_e_fused, \
            self.tensor_axis
        w1 = p.w1
        if tx is not None:
            hcp = tp_copy(c(h), tx)
            hr = tp_copy(tp_gather(hcp @ tp_slice(c(w1[:H]), tx), tx), tx)
            hc = tp_copy(tp_gather(hcp @ tp_slice(c(w1[H:2 * H]), tx), tx),
                         tx)
            kw = EdgeWeights(ws=tp_copy(w1[2 * H:], tx),
                             b1=tp_copy(p.b1, tx)[None],
                             w2=tp_copy(p.w2, tx),
                             b2=tp_copy(p.b2, tx)[None],
                             w3=tp_slice(p.w3, tx),
                             b3=tp_slice(p.b3, tx)[None],
                             w4=tp_slice(p.w4.T, tx))
            x = tp_copy(x, tx)
            # the remote tail's weights, cast then wrapped as JAX does
            cws, cb1 = tp_copy(c(w1[2 * H:]), tx), tp_copy(c(p.b1), tx)
            cw2, cb2 = tp_copy(c(p.w2), tx), tp_copy(c(p.b2), tx)
            cw3, cb3 = tp_slice(c(p.w3), tx), tp_slice(c(p.b3), tx)
            w4r = tp_slice(p.w4.T, tx).T                       # [H/T, 1]
        else:
            hr = c(h) @ c(w1[:H])            # hoisted node-axis products
            hc = c(h) @ c(w1[H:2 * H])
            kw = EdgeWeights(ws=w1[2 * H:], b1=p.b1[None], w2=p.w2,
                             b2=p.b2[None], w3=p.w3, b3=p.b3[None],
                             w4=p.w4.T)
            cws, cb1, cw2, cb2, cw3, cb3, w4r = (
                c(w1[2 * H:]), c(p.b1), c(p.w2), c(p.b2), c(p.w3), c(p.b3),
                p.w4)
        dname = "bf16" if self.dt is torch.bfloat16 else "f32"
        row_t, col_l, kblk, scal = fused_arrs
        outs = [fused_edge_layer(x[b], hr[b], hc[b], row_t[b], col_l[b],
                                 kblk[b], scal[b], kw, g.edge_block, dname)
                for b in range(h.shape[0])]
        trans_sum = torch.stack([o[0] for o in outs])          # [B, N, 3]
        count = torch.stack([o[1] for o in outs])              # [B, N]
        ef_sum = torch.stack([o[2] for o in outs])             # [B, N, H]

        # remote tail: the same math, dense over the compact out-of-window
        # edge list, summed with index_add_
        rr, rc = g.remote_edge_index[:, 0], g.remote_edge_index[:, 1]
        rm = g.remote_edge_mask[..., None]                     # [B, R, 1]
        cd_r = (gather_nodes(x, rr) - gather_nodes(x, rc)) * rm
        radial_r = torch.sum(cd_r * cd_r, dim=-1, keepdim=True)
        sfeat = c(torch.cat([radial_r, g.remote_edge_attr[..., :2]], dim=-1))
        t1 = (gather_nodes(hr, rr) + gather_nodes(hc, rc)
              + sfeat @ cws + cb1)
        y1 = t1 * torch.sigmoid(t1)
        t2 = y1 @ cw2 + cb2
        ef_r = t2 * torch.sigmoid(t2)                          # [B, R, H]
        t3 = ef_r @ cw3 + cb3
        y2 = t3 * torch.sigmoid(t3)
        g_r = (y2.to(torch.float32) @ w4r) * rm                # [B, R, 1]
        N = h.shape[1]
        trans_sum = trans_sum + segment_sum(cd_r * g_r, rr, N)
        count = count + segment_sum(g.remote_edge_mask, rr, N)
        ef_sum = ef_sum + segment_sum(ef_r.to(torch.float32) * rm, rr, N)
        if tx is not None:
            # phi_x closes with its one node-level sum; ef_sum and count
            # are the same on every tensor rank
            trans_sum = tp_reduce(trans_sum, tx)
            ef_sum = tp_once(ef_sum, tx)
            count = tp_once(count, tx)
        cnt = torch.clamp(count, min=1.0)[..., None]
        agg = trans_sum / cnt if self.coords_agg == "mean" else trans_sum
        return agg, ef_sum / cnt

    def _plain_edges(self, h, x, g: GraphBatch, blocked):
        """Per-edge streams through EdgeOps -> (agg, agg_h). ``blocked`` is
        FastEGNN's once-per-forward (slot, inv_deg, oh, plan) of a blocked
        batch, or Nones."""
        ops = EdgeOps(g, *blocked, seg_impl=self.seg_impl)
        coord_diff = ops.gather_rows(x) - ops.gather_cols(x)   # [B, E, 3]
        radial = torch.sum(coord_diff ** 2, dim=-1, keepdim=True)
        if self.normalize:
            norm = torch.sqrt(radial).detach() + self.epsilon
            coord_diff = coord_diff / norm
        if self.hoist_edge_mlp:
            scalars = (torch.cat([radial, g.edge_attr], dim=-1)
                       if self.edge_attr_nf else radial)
            edge_feat = self.phi_e(h, scalars, ops)
        else:
            e_in = [ops.gather_rows(h), ops.gather_cols(h), radial]
            if self.edge_attr_nf:
                e_in.append(g.edge_attr)
            edge_feat = self.phi_e(torch.cat(e_in, dim=-1))
        if self.attention:
            edge_feat = edge_feat * torch.sigmoid(self.att(edge_feat))
        edge_feat = edge_feat * g.edge_mask[..., None].to(edge_feat.dtype)

        # under the tensor axis phi_x's scalar is the rank's partial: it
        # rides coord_diff (whose cotangent is then a partial, summed by
        # tp_copy) and the row aggregation, all linear, and one sum of the
        # [B, N, 3] aggregate closes it
        tx = self.tensor_axis
        trans = tp_copy(coord_diff, tx) * self.phi_x(edge_feat)   # [B, E, 3]
        if self.fuse_agg:
            # both per-layer aggregations and the count in one pass
            agg, agg_h = ops.agg_rows_pair(trans, edge_feat,
                                           a_mean=self.coords_agg == "mean",
                                           agg_dtype=self.agg_dtype)
        else:
            agg = (ops.agg_rows_sum(trans) if self.coords_agg == "sum"
                   else ops.agg_rows_mean(trans))
            agg_h = ops.agg_rows_mean(edge_feat)
        return tp_reduce(agg, tx), agg_h

    def forward(self, h, x, v, X, Hv, g: GraphBatch, fused_arrs=None,
                gravity=None, slot=None, inv_deg=None, oh=None, plan=None,
                tile_coord_mean=None, tile_partials: bool = False):
        """h [B,N,H], x/v [B,N,3], X [B,3,C], Hv [B,H,C], gravity [3] (with
        ``has_gravity``), and on a blocked batch the layer-invariant slot
        ids [B,E], 1/in-degree [B,N,1], einsum one-hot (or None) and the
        slots' plan (or None) -> (h, x, Hv, X).

        Tiled serving (serve/tiled.py) runs the layer over ONE tile of a
        larger scene: ``tile_coord_mean`` [B,3] is the scene's coordinate
        mean of the layer input (a tile-local mean would be wrong), and
        ``tile_partials=True`` returns ``(h, x, transX_part [B,3,C],
        vef_part [B,C,H], count [B])``, the tile's masked sums towards the
        two virtual-node means, without applying them: the executor sums
        them over the tiles and closes X and Hv once a layer
        (:func:`tiled_virtual_update`). Exact, because every cross-node
        quantity of the layer derives from the layer-input X, Hv and x."""
        H, C = self.hidden_nf, self.virtual_channels
        node_mask = g.node_mask
        nm = node_mask[..., None]
        if self.edge_impl == "fused":
            agg, agg_h = self._fused_edges(h, x, g, fused_arrs)
        else:
            agg, agg_h = self._plain_edges(h, x, g,
                                           (slot, inv_deg, oh, plan))

        # virtual-edge geometry: every node sees all C virtual nodes
        vcd = X[:, None, :, :] - x[..., None]                  # [B, N, 3, C]
        virtual_radial = torch.linalg.norm(vcd, dim=2, keepdim=True)

        ax = self.axis_name
        coord_mean = (tile_coord_mean if tile_coord_mean is not None
                      else global_node_mean(x, node_mask, ax))  # [B, 3]
        Xc = X - coord_mean[:, :, None]                        # [B, 3, C]
        m_X = torch.einsum("bdc,bde->bce", Xc, Xc)             # [B, C, C]

        B, N = h.shape[0], h.shape[1]
        v_in = torch.cat([
            h[:, :, None, :].expand(B, N, C, H),
            Hv.transpose(1, 2)[:, None, :, :].expand(B, N, C, H),
            virtual_radial.transpose(2, 3),                    # [B, N, C, 1]
            m_X[:, None, :, :].expand(B, N, C, C),
        ], dim=-1)
        vef = self.phi_ev(v_in)                                # [B, N, C, H]
        if self.attention:
            vef = vef * torch.sigmoid(self.att_v(vef))
        vef = vef * node_mask[:, :, None, None].to(vef.dtype)

        x = x + agg
        phi_xv = self.phi_xv(vef)                              # [B, N, C, 1]
        x = x + torch.mean(-vcd * phi_xv.transpose(2, 3), dim=-1)
        x = x + self.phi_v(h).to(torch.float32) * v
        if self.has_gravity:
            x = x + self.phi_g(h).to(torch.float32) * gravity
        x = x * nm

        trans_X = vcd * self.phi_X(vef).transpose(2, 3)        # [B, N, 3, C]
        if tile_partials:
            transX_part = masked_sum(trans_X, node_mask, axis=1)  # [B, 3, C]
        else:
            X = X + global_node_mean(trans_X, node_mask, ax)

        agg_v = torch.mean(vef, dim=2)                         # [B, N, H]
        n_in = [h, agg_h, agg_v]
        if self.node_attr_nf:
            n_in.append(g.node_attr)
        out = self.phi_h(torch.cat([a.to(torch.float32) for a in n_in],
                                   dim=-1))
        h = (h + out) if self.residual else out
        h = h * nm

        if tile_partials:
            # the numerators and the denominator of the two means, summed
            # over the tiles by the executor; phi_hv is applied there
            vef_part = masked_sum(vef.to(torch.float32), node_mask,
                                  axis=1)                      # [B, C, H]
            count = torch.sum(node_mask.to(torch.float32), dim=1)  # [B]
            return h, x, transX_part, vef_part, count
        agg_Hv = global_node_mean(vef.to(torch.float32), node_mask,
                                  ax)                          # [B, C, H]
        hv_in = torch.cat([Hv.transpose(1, 2), agg_Hv], dim=-1)
        out_v = self.phi_hv(hv_in).transpose(1, 2)             # [B, H, C]
        Hv = (Hv + out_v) if self.residual else out_v
        return h, x, Hv, X


def tiled_virtual_update(layer: EGCLVel, Hv, X, transX_sum, vef_sum, count):
    """Close one tiled layer's virtual-node state from its tile partials.

    ``transX_sum`` [B,3,C], ``vef_sum`` [B,C,H] and ``count`` [B] are the
    sums of the ``tile_partials=True`` outputs over ALL tiles of the scene;
    dividing by the total count gives the monolithic layer's two node means
    (same numerator, same denominator, another summation order). Then the
    layer's own ``phi_hv`` (the parameters of the monolithic forward) is
    applied, once a layer instead of once a tile."""
    cnt = torch.clamp(count, min=1.0)[:, None, None]
    X = X + transX_sum / cnt
    agg_Hv = vef_sum / cnt                                     # [B, C, H]
    hv_in = torch.cat([Hv.transpose(1, 2), agg_Hv], dim=-1)
    out_v = layer.phi_hv(hv_in).transpose(1, 2)                # [B, H, C]
    Hv = (Hv + out_v) if layer.residual else out_v
    return Hv, X


def reduce_tile_partials(transX_part, vef_part, count, valid):
    """One tile ROUND's virtual-node partials (serve/mesh_tiled.py): slot d
    of the leading axis holds the ``tile_partials=True`` outputs of the tile
    that ran on device d; masking by each slot's validity flag ``valid``
    [D] (a ragged round's pad slots carry 0, and their node mask is all
    zero as well) and summing over the slots gives the round's partials.
    The JAX package sums across the round's devices with ``psum``; here the
    slots have been gathered to one device, so it is a plain masked sum."""
    v = valid.to(torch.float32)
    return tuple(torch.sum(a * v.reshape((-1,) + (1,) * (a.ndim - 1)), dim=0)
                 for a in (transX_part, vef_part, count))


class FastEGNN(nn.Module):
    """FastEGNN: ``forward(batch) -> (loc_pred [B,N,3], virtual_loc
    [B,3,C])``. ``edge_impl='plain'`` takes a plain batch (``edge_block``
    0), ``'fused'`` and ``'fused_stack'`` a blocked ``split_remote`` batch.
    The arguments are the JAX package's; ``segment_impl`` ('scatter',
    'cumsum', 'ell'), ``fuse_agg``, ``agg_dtype`` and ``hoist_edge_mlp``
    shape the plain path, and ``blocked_impl`` ('einsum', 'pallas') its
    blocked lowering, taken when the batch is blocked. ``gravity`` (a 3-vector or
    None) adds each layer's gravity head. ``stack_vmem_budget`` (bytes, 0 =
    the 16 MiB default) bounds the ``fused_stack`` residency estimate;
    ``remat`` does not apply to ``fused_stack``, whose backward reruns each
    layer from its checkpoint anyway. ``axis_name`` makes the model one part
    of a graph split over the process group of that axis, ``tensor_axis``
    one slice of its hidden width (the module docstring; ``hidden_nf`` must
    be divisible by the axis size)."""

    def __init__(self, node_feat_nf: int, node_attr_nf: int = 0,
                 edge_attr_nf: int = 0, hidden_nf: int = 64,
                 virtual_channels: int = 3, n_layers: int = 4,
                 residual: bool = True, attention: bool = False,
                 normalize: bool = False, tanh: bool = False,
                 gravity: Optional[Tuple[float, float, float]] = None,
                 compute_dtype=None, hoist_edge_mlp: bool = True,
                 blocked_impl: str = "einsum", segment_impl: str = "scatter",
                 remat: bool = False, fuse_agg: bool = True, agg_dtype=None,
                 edge_impl: str = "plain", stack_vmem_budget: int = 0,
                 axis_name: Optional[str] = None,
                 tensor_axis: Optional[str] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if virtual_channels < 1:
            raise ValueError("virtual_channels must be > 0")
        H, C = hidden_nf, virtual_channels
        self.node_feat_nf, self.node_attr_nf = node_feat_nf, node_attr_nf
        self.edge_attr_nf = edge_attr_nf
        self.hidden_nf, self.virtual_channels = H, C
        self.n_layers = n_layers
        self.residual = residual
        self.edge_impl, self.blocked_impl = edge_impl, blocked_impl
        self.remat = bool(remat)
        self.axis_name, self.tensor_axis = axis_name, tensor_axis
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.stack_vmem_budget = int(stack_vmem_budget)
        if edge_impl == "fused_stack":
            self._check_stack_model(attention, normalize, tanh)
        # gravity rides as a non-persistent buffer: the state_dict is the
        # same with or without it, and .to(device) moves it
        self.has_gravity = gravity is not None
        self.register_buffer(
            "gravity", torch.tensor(gravity if self.has_gravity
                                    else (0.0, 0.0, 0.0), dtype=torch.float32),
            persistent=False)
        # learnable virtual feature seed, shared across graphs (randn init)
        self.virtual_node_feat = nn.Parameter(
            torch.randn((1, H, C), generator=generator))
        self.embedding_in = TorchDense(node_feat_nf, H, generator=generator)
        layer_impl = "fused" if edge_impl == "fused_stack" else edge_impl
        self.gcl = nn.ModuleList([
            EGCLVel(H, C, node_attr_nf, edge_attr_nf, residual=residual,
                    attention=attention, normalize=normalize, tanh=tanh,
                    has_gravity=self.has_gravity,
                    compute_dtype=compute_dtype,
                    hoist_edge_mlp=hoist_edge_mlp, seg_impl=segment_impl,
                    fuse_agg=fuse_agg, agg_dtype=agg_dtype,
                    edge_impl=layer_impl, blocked_impl=blocked_impl,
                    axis_name=axis_name, tensor_axis=tensor_axis,
                    generator=generator)
            for _ in range(n_layers)])

    def _check_stack_model(self, attention, normalize, tanh):
        """The megakernel's model constraints, with the JAX messages."""
        if attention or normalize or tanh:
            raise ValueError(
                "edge_impl='fused_stack' supports the flagship EGCL "
                "only: attention/normalize/tanh are baked out of the "
                "megakernel — use edge_impl='plain' with those heads")
        if self.edge_attr_nf != 2:
            raise ValueError(
                f"edge_impl='fused_stack' requires edge_attr_nf=2 (the "
                f"kernel scalar lanes are [radial, attr0, attr1]); got "
                f"{self.edge_attr_nf}")
        if self.n_layers < 1:
            raise ValueError(
                f"edge_impl='fused_stack' needs n_layers >= 1 (the "
                f"megakernel grid is (n_layers,)); got {self.n_layers}")

    def forward(self, g: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        fused_arrs = None
        if self.edge_impl == "fused" and (g.edge_block <= 0
                                          or g.remote_edge_index is None):
            raise ValueError(
                "edge_impl='fused' needs a blocked batch built with "
                "split_remote=True (data.edge_block >= 512, a multiple "
                "of 512)")
        if self.edge_impl == "fused_stack":
            # the JAX package's messages
            if g.edge_block <= 0:
                raise ValueError(
                    "edge_impl='fused_stack' requires a blocked batch "
                    "(data.edge_block >= 512, a multiple of 512)")
            if g.remote_edge_index is None:
                raise ValueError(
                    "edge_impl='fused_stack' needs a blocked batch built "
                    "with split_remote=True (the megakernel folds the "
                    "compact remote tail in per layer) — check "
                    "data.edge_block and the loader's split_remote flag")
        if self.edge_impl in ("fused", "fused_stack"):
            # the kernel's edge layout is layer-invariant: built once
            fused_arrs = build_edge_blocks(g.row, g.col, g.edge_attr,
                                           g.edge_mask, block=g.edge_block,
                                           n_nodes=g.max_nodes)
        B = g.batch_size
        H, C = self.hidden_nf, self.virtual_channels
        Hv = self.virtual_node_feat.expand(B, H, C)
        # virtual coords start at the global location mean, C copies
        X = g.loc_mean[:, :, None].repeat(1, 1, C)                # [B, 3, C]
        h = self.embedding_in(g.node_feat)
        x, v = g.loc, g.vel
        gravity = self.gravity if self.has_gravity else None
        # under a mesh axis fused_stack runs its layers one by one (fused)
        if (self.edge_impl == "fused_stack" and self.axis_name is None
                and self.tensor_axis is None):
            return self._fused_stack_forward(g, h, x, v, X, Hv, gravity,
                                             fused_arrs)
        # blocked layout: slot ids + in-degree reciprocal (+ the einsum
        # one-hot, or the kernels' plan), shared by all layers and their
        # backward
        blocked = (blocked_slot_inv_deg(g, self.blocked_impl)
                   if self.edge_impl == "plain" else (None,) * 4)
        for layer in self.gcl:
            if self.remat and torch.is_grad_enabled():
                # keep only the layer's inputs; the backward reruns it.
                # The layers draw no random numbers, so no RNG state is
                # saved (reading it is refused while a CUDA graph captures)
                h, x, Hv, X = checkpoint(layer, h, x, v, X, Hv, g,
                                         fused_arrs, gravity, *blocked,
                                         use_reentrant=False,
                                         preserve_rng_state=False)
            else:
                h, x, Hv, X = layer(h, x, v, X, Hv, g, fused_arrs, gravity,
                                    *blocked)
        return x, X

    def stack_config(self, g: GraphBatch) -> StackConfig:
        """The megakernel configuration of this model over batch ``g``."""
        return StackConfig(
            n_layers=self.n_layers, block=g.edge_block, hidden=self.hidden_nf,
            channels=self.virtual_channels, node_attr_nf=self.node_attr_nf,
            has_gravity=self.has_gravity, residual=self.residual,
            coords_mean=True,  # FastEGNN always aggregates with 'mean'
            dtype_name="bf16" if self.compute_dtype is torch.bfloat16
            else "f32",
            vmem_budget=self.stack_vmem_budget or DEFAULT_STACK_VMEM_BUDGET)

    def stacked_weights(self) -> dict:
        """The per-layer parameters as the megakernel's ``{key: [L, a, b]}``
        (``stack_weight_shapes``): ``torch.stack`` of ``[in, out]`` views,
        so gradients reach each layer's parameters."""
        def layer_weights(m: EGCLVel) -> dict:
            p = m.phi_e_fused
            w = {"e_w1": p.w1, "e_b1": p.b1[None], "e_w2": p.w2,
                 "e_b2": p.b2[None], "e_w3": p.w3, "e_b3": p.b3[None],
                 "e_w4": p.w4.T}
            for pre, mlp in (("ev", m.phi_ev), ("xv", m.phi_xv),
                             ("X", m.phi_X), ("v", m.phi_v), ("h", m.phi_h),
                             ("hv", m.phi_hv)) + (
                                 (("g", m.phi_g),) if m.has_gravity else ()):
                for i, lin in enumerate(mlp.layers):
                    w[f"{pre}_k{i}"] = lin.weight.T
                    if lin.bias is not None:
                        w[f"{pre}_b{i}"] = lin.bias[None]
            return w

        per = [layer_weights(m) for m in self.gcl]
        return {k: torch.stack([w[k] for w in per]) for k in per[0]}

    def _fused_stack_forward(self, g: GraphBatch, h, x, v, X, Hv, gravity,
                             fused_arrs):
        """The whole layer loop of the whole batch as ONE megakernel
        launch."""
        cfg = self.stack_config(g)
        wstack = self.stacked_weights()
        shapes = stack_weight_shapes(cfg)
        if wstack.keys() != shapes.keys():
            raise ValueError(f"stacked weights {sorted(wstack)} do not match "
                             f"the megakernel's {sorted(shapes)}")
        remote_arrs = (g.remote_edge_index[:, 0], g.remote_edge_index[:, 1],
                       g.remote_edge_attr, g.remote_edge_mask)
        _, x, X, _ = fused_egnn_stack_batch(
            cfg, h, x, v, X, Hv, g.node_mask,
            g.node_attr if self.node_attr_nf else None, gravity,
            tuple(fused_arrs), remote_arrs, wstack)
        return x, X
