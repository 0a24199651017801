"""FastEGNN — EGNN with C learnable virtual nodes per graph (port of
``distegnn_tpu/models/fast_egnn.py``).

Two lowerings of each layer's real edges, as in the JAX package
(``edge_impl``):

  plain  (the default) per-edge streams through ``EdgeOps``
         (ops/blocked.py) on a plain row-sorted batch: gathers, the edge MLP
         phi_e (hoisted to the node axis, or the reference concat MLP), the
         coordinate head phi_x, optional attention gate, and one packed
         aggregation per layer lowered as ``scatter`` (``index_add_``),
         ``cumsum`` (the CUDA prefix-scan kernel on the card) or ``ell``;
  fused  in-window edges through ``fused_edge_layer`` (the CUDA kernels on
         the card) over a blocked ``split_remote`` batch, the remote tail as
         plain tensor code plus ``index_add_``.

The virtual-node section is dense tensor code either way. Gradients flow
through every path; ``remat=True`` checkpoints each layer, as
``nn.remat(EGCLVel)`` does in the JAX package: its activations are
recomputed in the backward pass instead of kept.

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
from distegnn_tpu_torch.ops.blocked import EdgeOps
from distegnn_tpu_torch.ops.edge_pipeline import (EdgeWeights,
                                                  build_edge_blocks,
                                                  fused_edge_layer)
from distegnn_tpu_torch.ops.graph import GraphBatch
from distegnn_tpu_torch.ops.segment import segment_sum
from distegnn_tpu_torch.parallel.collectives import global_node_mean

# the slice of the port that brings what this one refuses (ROADMAP.md, queue 1)
_SLICE_STACK = "port slice 4 (the fused_stack megakernel)"
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
    phi_h, phi_hv, the optional attention gates ``att``/``att_v``, and the
    real edges through ``edge_impl`` (see the module docstring)."""

    def __init__(self, hidden_nf: int, virtual_channels: int,
                 node_attr_nf: int = 0, edge_attr_nf: int = 2, *,
                 residual: bool = True, attention: bool = False,
                 normalize: bool = False, coords_agg: str = "mean",
                 tanh: bool = False, epsilon: float = 1e-8,
                 compute_dtype=None, hoist_edge_mlp: bool = True,
                 seg_impl: str = "scatter", fuse_agg: bool = True,
                 agg_dtype=None, edge_impl: str = "plain",
                 blocked_impl: str = "einsum", generator=None):
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
        H, C = hidden_nf, virtual_channels
        self.hidden_nf, self.virtual_channels = H, C
        self.node_attr_nf, self.edge_attr_nf = node_attr_nf, edge_attr_nf
        self.residual, self.attention = residual, attention
        self.normalize, self.coords_agg = normalize, coords_agg
        self.epsilon = epsilon
        self.hoist_edge_mlp, self.seg_impl = hoist_edge_mlp, seg_impl
        self.fuse_agg, self.agg_dtype = fuse_agg, agg_dtype
        self.edge_impl, self.blocked_impl = edge_impl, blocked_impl
        self.dt = resolve_dtype(compute_dtype)
        kw = dict(dtype=self.dt, generator=generator)
        if fused:
            self.phi_e_fused = FusedEdgeParams(H, 1 + edge_attr_nf,
                                               generator=generator)
        else:
            S = 1 + edge_attr_nf
            self.phi_e = (HoistedEdgeMLP(H, S, **kw) if hoist_edge_mlp
                          else MLP(2 * H + S, [H, H], act_last=True, **kw))
            if attention:
                self.att = TorchDense(H, 1, **kw)
            self.phi_x = CoordMLP(H, H, tanh=tanh, **kw)
        self.phi_ev = MLP(2 * H + 1 + C, [H, H], act_last=True, **kw)
        if attention:
            self.att_v = TorchDense(H, 1, **kw)
        self.phi_xv = CoordMLP(H, H, tanh=tanh, **kw)
        self.phi_X = CoordMLP(H, H, tanh=tanh, **kw)
        self.phi_v = MLP(H, [H, 1], **kw)
        self.phi_h = MLP(3 * H + node_attr_nf, [H, H], **kw)
        self.phi_hv = MLP(2 * H, [H, H], **kw)

    def _c(self, a: torch.Tensor) -> torch.Tensor:
        return a.to(self.dt) if self.dt is not None else a

    def _fused_edges(self, h, x, g: GraphBatch, fused_arrs):
        """In-window kernel sums plus the remote tail -> (agg, agg_h)."""
        H, c, p = self.hidden_nf, self._c, self.phi_e_fused
        hr = c(h) @ c(p.w1[:H])              # hoisted node-axis products
        hc = c(h) @ c(p.w1[H:2 * H])
        kw = EdgeWeights(ws=p.w1[2 * H:], b1=p.b1[None], w2=p.w2,
                         b2=p.b2[None], w3=p.w3, b3=p.b3[None], w4=p.w4.T)
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
              + sfeat @ c(p.w1[2 * H:]) + c(p.b1))
        y1 = t1 * torch.sigmoid(t1)
        t2 = y1 @ c(p.w2) + c(p.b2)
        ef_r = t2 * torch.sigmoid(t2)                          # [B, R, H]
        t3 = ef_r @ c(p.w3) + c(p.b3)
        y2 = t3 * torch.sigmoid(t3)
        g_r = (y2.to(torch.float32) @ p.w4) * rm               # [B, R, 1]
        N = h.shape[1]
        trans_sum = trans_sum + segment_sum(cd_r * g_r, rr, N)
        count = count + segment_sum(g.remote_edge_mask, rr, N)
        ef_sum = ef_sum + segment_sum(ef_r.to(torch.float32) * rm, rr, N)
        cnt = torch.clamp(count, min=1.0)[..., None]
        agg = trans_sum / cnt if self.coords_agg == "mean" else trans_sum
        return agg, ef_sum / cnt

    def _plain_edges(self, h, x, g: GraphBatch):
        """Per-edge streams through EdgeOps -> (agg, agg_h)."""
        ops = EdgeOps(g, self.seg_impl, self.blocked_impl)
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

        trans = coord_diff * self.phi_x(edge_feat)             # [B, E, 3]
        if self.fuse_agg:
            # both per-layer aggregations and the count in one pass
            return ops.agg_rows_pair(trans, edge_feat,
                                     a_mean=self.coords_agg == "mean",
                                     agg_dtype=self.agg_dtype)
        agg = (ops.agg_rows_sum(trans) if self.coords_agg == "sum"
               else ops.agg_rows_mean(trans))
        return agg, ops.agg_rows_mean(edge_feat)

    def forward(self, h, x, v, X, Hv, g: GraphBatch, fused_arrs=None):
        """h [B,N,H], x/v [B,N,3], X [B,3,C], Hv [B,H,C] -> (h, x, Hv, X)."""
        H, C = self.hidden_nf, self.virtual_channels
        node_mask = g.node_mask
        nm = node_mask[..., None]
        if self.edge_impl == "fused":
            agg, agg_h = self._fused_edges(h, x, g, fused_arrs)
        else:
            agg, agg_h = self._plain_edges(h, x, g)

        # virtual-edge geometry: every node sees all C virtual nodes
        vcd = X[:, None, :, :] - x[..., None]                  # [B, N, 3, C]
        virtual_radial = torch.linalg.norm(vcd, dim=2, keepdim=True)

        coord_mean = global_node_mean(x, node_mask)            # [B, 3]
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
        x = x * nm

        trans_X = vcd * self.phi_X(vef).transpose(2, 3)        # [B, N, 3, C]
        X = X + global_node_mean(trans_X, node_mask)

        agg_v = torch.mean(vef, dim=2)                         # [B, N, H]
        n_in = [h, agg_h, agg_v]
        if self.node_attr_nf:
            n_in.append(g.node_attr)
        out = self.phi_h(torch.cat([a.to(torch.float32) for a in n_in],
                                   dim=-1))
        h = (h + out) if self.residual else out
        h = h * nm

        agg_Hv = global_node_mean(vef.to(torch.float32), node_mask)  # [B,C,H]
        hv_in = torch.cat([Hv.transpose(1, 2), agg_Hv], dim=-1)
        out_v = self.phi_hv(hv_in).transpose(1, 2)             # [B, H, C]
        Hv = (Hv + out_v) if self.residual else out_v
        return h, x, Hv, X


class FastEGNN(nn.Module):
    """FastEGNN: ``forward(batch) -> (loc_pred [B,N,3], virtual_loc
    [B,3,C])``. ``edge_impl='plain'`` takes a plain batch (``edge_block``
    0), ``'fused'`` a blocked ``split_remote`` batch. The arguments are the
    JAX package's; ``segment_impl`` ('scatter', 'cumsum', 'ell'),
    ``fuse_agg``, ``agg_dtype`` and ``hoist_edge_mlp`` shape the plain path.
    ``blocked_impl`` is accepted for the blocked plain lowerings, which
    come with port slice 5; ``edge_impl='fused_stack'`` raises and names
    port slice 4."""

    def __init__(self, node_feat_nf: int, node_attr_nf: int = 0,
                 edge_attr_nf: int = 0, hidden_nf: int = 64,
                 virtual_channels: int = 3, n_layers: int = 4,
                 residual: bool = True, attention: bool = False,
                 normalize: bool = False, tanh: bool = False,
                 compute_dtype=None, hoist_edge_mlp: bool = True,
                 blocked_impl: str = "einsum", segment_impl: str = "scatter",
                 remat: bool = False, fuse_agg: bool = True, agg_dtype=None,
                 edge_impl: str = "plain", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if edge_impl == "fused_stack":
            raise NotImplementedError(
                f"edge_impl='fused_stack' comes with {_SLICE_STACK}; "
                "'plain' and 'fused' are ported")
        if virtual_channels < 1:
            raise ValueError("virtual_channels must be > 0")
        H, C = hidden_nf, virtual_channels
        self.node_feat_nf, self.node_attr_nf = node_feat_nf, node_attr_nf
        self.edge_attr_nf = edge_attr_nf
        self.hidden_nf, self.virtual_channels = H, C
        self.n_layers = n_layers
        self.edge_impl = edge_impl
        self.remat = bool(remat)
        # learnable virtual feature seed, shared across graphs (randn init)
        self.virtual_node_feat = nn.Parameter(
            torch.randn((1, H, C), generator=generator))
        self.embedding_in = TorchDense(node_feat_nf, H, generator=generator)
        self.gcl = nn.ModuleList([
            EGCLVel(H, C, node_attr_nf, edge_attr_nf, residual=residual,
                    attention=attention, normalize=normalize, tanh=tanh,
                    compute_dtype=compute_dtype,
                    hoist_edge_mlp=hoist_edge_mlp, seg_impl=segment_impl,
                    fuse_agg=fuse_agg, agg_dtype=agg_dtype,
                    edge_impl=edge_impl, blocked_impl=blocked_impl,
                    generator=generator)
            for _ in range(n_layers)])

    def forward(self, g: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        fused_arrs = None
        if self.edge_impl == "fused":
            if g.edge_block <= 0 or g.remote_edge_index is None:
                raise ValueError(
                    "edge_impl='fused' needs a blocked batch built with "
                    "split_remote=True (data.edge_block >= 512, a multiple "
                    "of 512)")
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
        for layer in self.gcl:
            if self.remat and torch.is_grad_enabled():
                # keep only the layer's inputs; the backward reruns it
                h, x, Hv, X = checkpoint(layer, h, x, v, X, Hv, g,
                                         fused_arrs, use_reentrant=False)
            else:
                h, x, Hv, X = layer(h, x, v, X, Hv, g, fused_arrs)
        return x, X
