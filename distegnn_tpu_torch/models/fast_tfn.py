"""FastTFN (port of ``distegnn_tpu/models/fast_tfn.py``): the FastEGNN
virtual-node skeleton whose real-node coordinate update is a 1-layer TFN.

Per layer the real coordinates move by a small TFN (one layer, one channel,
degrees 0 and 1) fed with the charges (degree 0) and the velocity (degree
1) over the same edges, at the CURRENT positions; the virtual-node
machinery is FastEGNN's. The charges are ``node_attr``'s first channel, else
the last node feature. Under ``axis_name`` the coordinate mean and the
virtual means are global.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from distegnn_tpu_torch.models.common import MLP, CoordMLP, TorchDense
from distegnn_tpu_torch.models.se3.basis import cart_to_deg1, deg1_to_cart
from distegnn_tpu_torch.models.se3.tfn import TFN
from distegnn_tpu_torch.ops.graph import GraphBatch
from distegnn_tpu_torch.ops.segment import segment_mean, take_rows
from distegnn_tpu_torch.parallel.collectives import global_node_mean


class TFNGCLVel(nn.Module):
    """One FastTFN layer."""

    def __init__(self, hidden_nf: int, virtual_channels: int,
                 node_attr_nf: int = 0, edge_attr_nf: int = 0, *,
                 residual: bool = True, attention: bool = False,
                 normalize: bool = False, tanh: bool = False,
                 has_gravity: bool = False, axis_name: Optional[str] = None,
                 generator=None):
        super().__init__()
        H, C = hidden_nf, virtual_channels
        self.hidden_nf, self.virtual_channels = H, C
        self.node_attr_nf, self.edge_attr_nf = node_attr_nf, edge_attr_nf
        self.residual, self.attention = residual, attention
        self.has_gravity, self.axis_name = has_gravity, axis_name
        kw = dict(generator=generator)
        self.phi_e = MLP(2 * H + 1 + edge_attr_nf, [H, H], act_last=True,
                         **kw)
        if attention:
            self.att = TorchDense(H, 1, **kw)
        self.phi_ev = MLP(2 * H + 1 + C, [H, H], act_last=True, **kw)
        if attention:
            self.att_v = TorchDense(H, 1, **kw)
        self.tfn_layer = TFN(num_layers=1, num_channels=1, num_degrees=2,
                             in_types={0: 1, 1: 1}, out_types={1: 1}, **kw)
        self.phi_xv = CoordMLP(H, H, tanh=tanh, **kw)
        if has_gravity:
            self.phi_g = MLP(H, [H, 1], **kw)
        self.phi_X = CoordMLP(H, H, tanh=tanh, **kw)
        self.phi_h = MLP(3 * H + node_attr_nf, [H, H], **kw)
        self.phi_hv = MLP(2 * H, [H, H], **kw)

    def forward(self, h, x, v, X, Hv, g: GraphBatch, charges, gravity=None):
        H, C = self.hidden_nf, self.virtual_channels
        row, col = g.row, g.col
        node_mask, edge_mask = g.node_mask, g.edge_mask
        nm = node_mask[..., None]
        B, N = h.shape[0], h.shape[1]

        raw_diff = take_rows(x, row) - take_rows(x, col)
        radial = torch.sum(raw_diff ** 2, dim=-1, keepdim=True)
        vcd = X[:, None, :, :] - x[..., None]
        virtual_radial = torch.linalg.norm(vcd, dim=2, keepdim=True)

        e_in = [take_rows(h, row), take_rows(h, col), radial]
        if self.edge_attr_nf:
            e_in.append(g.edge_attr)
        edge_feat = self.phi_e(torch.cat(e_in, dim=-1))
        if self.attention:
            edge_feat = edge_feat * torch.sigmoid(self.att(edge_feat))
        edge_feat = edge_feat * edge_mask[..., None]

        coord_mean = global_node_mean(x, node_mask, self.axis_name)
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

        # the real coordinate update: a 1-layer TFN over the same graph at
        # the current positions, {charges: 0, vel: 1} -> {1: 1}
        g_now = dataclasses.replace(g, loc=x)
        tfn_in = {0: charges[..., None, None],
                  1: cart_to_deg1(v)[:, :, None, :]}
        x = x + deg1_to_cart(self.tfn_layer(tfn_in, g_now)[1][:, :, 0, :])

        phi_xv = self.phi_xv(vef)
        x = x + torch.mean(-vcd * phi_xv.transpose(2, 3), dim=-1)
        if self.has_gravity:
            x = x + self.phi_g(h) * gravity
        x = x * nm

        trans_X = vcd * self.phi_X(vef).transpose(2, 3)
        X = X + global_node_mean(trans_X, node_mask, self.axis_name)

        agg_h = segment_mean(edge_feat, row, N, mask=edge_mask)
        agg_v = torch.mean(vef, dim=2)
        n_in = [h, agg_h, agg_v]
        if self.node_attr_nf:
            n_in.append(g.node_attr)
        out = self.phi_h(torch.cat(n_in, dim=-1))
        h = ((h + out) if self.residual else out) * nm

        agg_Hv = global_node_mean(vef, node_mask, self.axis_name)
        hv_in = torch.cat([Hv.transpose(1, 2), agg_Hv], dim=-1)
        out_v = self.phi_hv(hv_in).transpose(1, 2)
        Hv = (Hv + out_v) if self.residual else out_v
        return h, x, Hv, X


class FastTFN(nn.Module):
    """FastTFN: ``forward(batch) -> (loc_pred [B,N,3], virtual_loc
    [B,3,C])``."""

    def __init__(self, node_feat_nf: int, node_attr_nf: int = 0,
                 edge_attr_nf: int = 0, hidden_nf: int = 64,
                 virtual_channels: int = 3, n_layers: int = 4,
                 residual: bool = True, attention: bool = False,
                 normalize: bool = False, tanh: bool = False,
                 gravity: Optional[Tuple[float, float, float]] = None,
                 axis_name: Optional[str] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if virtual_channels < 1:
            raise ValueError("virtual_channels must be > 0")
        H, C = hidden_nf, virtual_channels
        self.node_feat_nf, self.node_attr_nf = node_feat_nf, node_attr_nf
        self.edge_attr_nf = edge_attr_nf
        self.hidden_nf, self.virtual_channels = H, C
        self.n_layers, self.axis_name = n_layers, axis_name
        self.has_gravity = gravity is not None
        self.register_buffer(
            "gravity", torch.tensor(gravity if self.has_gravity
                                    else (0.0, 0.0, 0.0), dtype=torch.float32),
            persistent=False)
        self.virtual_node_feat = nn.Parameter(
            torch.randn((1, H, C), generator=generator))
        self.embedding_in = TorchDense(node_feat_nf, H, generator=generator)
        self.gcl = nn.ModuleList([
            TFNGCLVel(H, C, node_attr_nf, edge_attr_nf, residual=residual,
                      attention=attention, normalize=normalize, tanh=tanh,
                      has_gravity=self.has_gravity, axis_name=axis_name,
                      generator=generator)
            for _ in range(n_layers)])

    def forward(self, g: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        B = g.batch_size
        H, C = self.hidden_nf, self.virtual_channels
        charges = (g.node_attr[..., 0] if g.node_attr.shape[-1]
                   else g.node_feat[..., -1])
        Hv = self.virtual_node_feat.expand(B, H, C)
        X = g.loc_mean[:, :, None].repeat(1, 1, C)
        h = self.embedding_in(g.node_feat)
        x, v = g.loc, g.vel
        gravity = self.gravity if self.has_gravity else None
        for layer in self.gcl:
            h, x, Hv, X = layer(h, x, v, X, Hv, g, charges, gravity)
        return x, X
