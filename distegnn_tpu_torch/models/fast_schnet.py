"""FastSchNet (port of ``distegnn_tpu/models/fast_schnet.py``): the
FastEGNN virtual-node skeleton whose real-node coordinate update is a
1-interaction SchNet.

Per layer: (a) the real coordinates move by the SchNet equivariant update
(its gate a Dense over [gauss(|x_i - x_j|), h_i, h_j]); (b) the virtual-node
machinery is FastEGNN's (phi_ev / phi_xv / phi_X / phi_h / phi_hv) without
the real phi_x / phi_v paths; (c) the coordinate mean entering the virtual
Gram is LOCAL to a graph part, as the reference keeps it, while the virtual
coordinate and feature means are global under ``axis_name``.

The real edges go through ``EdgeOps`` (ops/blocked.py) as FastEGNN's plain
path does: ``hoist_edge_mlp`` evaluates phi_e's and the gate's first Dense
on the node axis, ``fuse_agg`` aggregates the translations and the edge
features in one packed pass (``agg_rows_pair``), and the lowering is
``segment_impl`` on a plain batch (``cumsum``: the CUDA prefix scan on the
card) or ``blocked_impl`` on a blocked one (``pallas``: the CUDA one-hot
kernels on the card). ``normalize`` is accepted and, as in the reference,
changes nothing: the SchNet update reads raw positions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from distegnn_tpu_torch.models.common import (MLP, CoordMLP, HoistedEdgeMLP,
                                              HoistedGate, TorchDense)
from distegnn_tpu_torch.models.schnet import GaussianSmearing
from distegnn_tpu_torch.ops.blocked import EdgeOps, blocked_slot_inv_deg
from distegnn_tpu_torch.ops.graph import GraphBatch
from distegnn_tpu_torch.parallel.collectives import global_node_mean


class SchNetGCLVel(nn.Module):
    """One FastSchNet layer."""

    def __init__(self, hidden_nf: int, virtual_channels: int,
                 node_attr_nf: int = 0, edge_attr_nf: int = 0, *,
                 cutoff: float = 10.0, num_gaussians: int = 50,
                 residual: bool = True, attention: bool = False,
                 normalize: bool = False, tanh: bool = False,
                 has_gravity: bool = False, axis_name: Optional[str] = None,
                 hoist_edge_mlp: bool = True, seg_impl: str = "scatter",
                 fuse_agg: bool = True, agg_dtype=None, generator=None):
        super().__init__()
        H, C = hidden_nf, virtual_channels
        self.hidden_nf, self.virtual_channels = H, C
        self.node_attr_nf, self.edge_attr_nf = node_attr_nf, edge_attr_nf
        self.residual, self.attention = residual, attention
        self.has_gravity, self.axis_name = has_gravity, axis_name
        self.hoist_edge_mlp, self.seg_impl = hoist_edge_mlp, seg_impl
        self.fuse_agg, self.agg_dtype = fuse_agg, agg_dtype
        kw = dict(generator=generator)
        S, G = 1 + edge_attr_nf, num_gaussians
        self.phi_e = (HoistedEdgeMLP(H, S, **kw) if hoist_edge_mlp
                      else MLP(2 * H + S, [H, H], act_last=True, **kw))
        if attention:
            self.att = TorchDense(H, 1, **kw)
        self.phi_ev = MLP(2 * H + 1 + C, [H, H], act_last=True, **kw)
        if attention:
            self.att_v = TorchDense(H, 1, **kw)
        self.smearing = GaussianSmearing(0.0, cutoff, G)
        self.schnet_coord_update = (HoistedGate(1, G, H, **kw)
                                    if hoist_edge_mlp
                                    else TorchDense(G + 2 * H, 1, **kw))
        self.phi_xv = CoordMLP(H, H, tanh=tanh, **kw)
        if has_gravity:
            self.phi_g = MLP(H, [H, 1], **kw)
        self.phi_X = CoordMLP(H, H, tanh=tanh, **kw)
        self.phi_h = MLP(3 * H + node_attr_nf, [H, H], **kw)
        self.phi_hv = MLP(2 * H, [H, H], **kw)

    def forward(self, h, x, v, X, Hv, g: GraphBatch, gravity=None,
                slot=None, inv_deg=None, oh=None, plan=None):
        """h [B,N,H], x/v [B,N,3], X [B,3,C], Hv [B,H,C] (and a blocked
        batch's slots, 1/in-degree, einsum one-hot and plan) -> (h, x, Hv,
        X)."""
        H, C = self.hidden_nf, self.virtual_channels
        node_mask = g.node_mask
        nm = node_mask[..., None]
        B, N = h.shape[0], h.shape[1]
        ops = EdgeOps(g, slot, inv_deg, oh, plan, seg_impl=self.seg_impl)

        raw_diff = ops.gather_rows(x) - ops.gather_cols(x)        # [B, E, 3]
        radial = torch.sum(raw_diff ** 2, dim=-1, keepdim=True)
        vcd = X[:, None, :, :] - x[..., None]                     # [B,N,3,C]
        virtual_radial = torch.linalg.norm(vcd, dim=2, keepdim=True)

        e_scalars = (torch.cat([radial, g.edge_attr], dim=-1)
                     if self.edge_attr_nf else radial)
        if self.hoist_edge_mlp:
            edge_feat = self.phi_e(h, e_scalars, ops)
        else:
            h_row, h_col = ops.gather_rows(h), ops.gather_cols(h)
            edge_feat = self.phi_e(torch.cat([h_row, h_col, e_scalars],
                                             dim=-1))
        if self.attention:
            edge_feat = edge_feat * torch.sigmoid(self.att(edge_feat))
        edge_feat = edge_feat * g.edge_mask[..., None]

        # LOCAL coordinate mean + virtual Gram
        coord_mean = global_node_mean(x, node_mask, None)
        Xc = X - coord_mean[:, :, None]
        m_X = torch.einsum("bdc,bde->bce", Xc, Xc)

        v_in = torch.cat([
            h[:, :, None, :].expand(B, N, C, H),
            Hv.transpose(1, 2)[:, None, :, :].expand(B, N, C, H),
            virtual_radial.transpose(2, 3),
            m_X[:, None, :, :].expand(B, N, C, C)], dim=-1)
        vef = self.phi_ev(v_in)
        if self.attention:
            vef = vef * torch.sigmoid(self.att_v(vef))
        vef = vef * node_mask[:, :, None, None]

        # the real coordinate update, a 1-interaction SchNet on the RAW
        # interatomic distances and directions
        edge_weight = torch.linalg.norm(raw_diff + 1e-30, dim=-1)
        gauss = self.smearing(edge_weight)
        if self.hoist_edge_mlp:
            gate = self.schnet_coord_update(h, gauss, ops)
        else:
            gate = self.schnet_coord_update(torch.cat([gauss, h_row, h_col],
                                                      dim=-1))
        if self.fuse_agg:
            agg_x, agg_h = ops.agg_rows_pair(raw_diff * gate, edge_feat,
                                             a_mean=True,
                                             agg_dtype=self.agg_dtype)
        else:
            agg_x = ops.agg_rows_mean(raw_diff * gate)
            agg_h = ops.agg_rows_mean(edge_feat)
        x = x + agg_x

        # the virtual pull on the real nodes
        phi_xv = self.phi_xv(vef)
        x = x + torch.mean(-vcd * phi_xv.transpose(2, 3), dim=-1)
        if self.has_gravity:
            x = x + self.phi_g(h) * gravity
        x = x * nm

        trans_X = vcd * self.phi_X(vef).transpose(2, 3)
        X = X + global_node_mean(trans_X, node_mask, self.axis_name)

        agg_v = torch.mean(vef, dim=2)
        n_in = [h, agg_h, agg_v]
        if self.node_attr_nf:
            n_in.append(g.node_attr)
        out = self.phi_h(torch.cat(n_in, dim=-1))
        h = ((h + out) if self.residual else out) * nm

        agg_Hv = global_node_mean(vef, node_mask, self.axis_name)  # [B,C,H]
        hv_in = torch.cat([Hv.transpose(1, 2), agg_Hv], dim=-1)
        out_v = self.phi_hv(hv_in).transpose(1, 2)
        Hv = (Hv + out_v) if self.residual else out_v
        return h, x, Hv, X


class FastSchNet(nn.Module):
    """FastSchNet: ``forward(batch) -> (loc_pred [B,N,3], virtual_loc
    [B,3,C])``. The arguments are the JAX package's; the parameters are
    drawn from ``generator``."""

    def __init__(self, node_feat_nf: int, node_attr_nf: int = 0,
                 edge_attr_nf: int = 0, hidden_nf: int = 64,
                 virtual_channels: int = 3, n_layers: int = 4,
                 cutoff: float = 10.0, residual: bool = True,
                 attention: bool = False, normalize: bool = False,
                 tanh: bool = False,
                 gravity: Optional[Tuple[float, float, float]] = None,
                 axis_name: Optional[str] = None,
                 blocked_impl: str = "einsum", hoist_edge_mlp: bool = True,
                 segment_impl: str = "scatter", fuse_agg: bool = True,
                 agg_dtype=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if virtual_channels < 1:
            raise ValueError("virtual_channels must be > 0")
        H, C = hidden_nf, virtual_channels
        self.node_feat_nf, self.node_attr_nf = node_feat_nf, node_attr_nf
        self.edge_attr_nf = edge_attr_nf
        self.hidden_nf, self.virtual_channels = H, C
        self.n_layers, self.blocked_impl = n_layers, blocked_impl
        self.axis_name = axis_name
        self.has_gravity = gravity is not None
        self.register_buffer(
            "gravity", torch.tensor(gravity if self.has_gravity
                                    else (0.0, 0.0, 0.0), dtype=torch.float32),
            persistent=False)
        self.virtual_node_feat = nn.Parameter(
            torch.randn((1, H, C), generator=generator))
        self.embedding_in = TorchDense(node_feat_nf, H, generator=generator)
        self.gcl = nn.ModuleList([
            SchNetGCLVel(H, C, node_attr_nf, edge_attr_nf, cutoff=cutoff,
                         residual=residual, attention=attention,
                         normalize=normalize, tanh=tanh,
                         has_gravity=self.has_gravity, axis_name=axis_name,
                         hoist_edge_mlp=hoist_edge_mlp,
                         seg_impl=segment_impl, fuse_agg=fuse_agg,
                         agg_dtype=agg_dtype, generator=generator)
            for _ in range(n_layers)])

    def forward(self, g: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        B = g.batch_size
        H, C = self.hidden_nf, self.virtual_channels
        Hv = self.virtual_node_feat.expand(B, H, C)
        X = g.loc_mean[:, :, None].repeat(1, 1, C)
        h = self.embedding_in(g.node_feat)
        x, v = g.loc, g.vel
        gravity = self.gravity if self.has_gravity else None
        # a blocked batch's slots, 1/in-degree and one-hot or plan, once
        # for all layers
        blocked = blocked_slot_inv_deg(g, self.blocked_impl)
        for layer in self.gcl:
            h, x, Hv, X = layer(h, x, v, X, Hv, g, gravity, *blocked)
        return x, X
