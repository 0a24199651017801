"""FastRF (port of ``distegnn_tpu/models/fast_rf.py``): radial-field
dynamics with C global virtual nodes.

A radial-field layer has no node features: its messages are functions of
the geometry alone. Under a graph axis the virtual coordinate update is the
only cross-part channel. Two reference quirks are kept, as in the JAX
package: the coordinate mean entering the virtual Gram is the LOCAL (per
part) mean, and the activation is LeakyReLU(0.2).

The real edges go through ``EdgeOps`` (ops/blocked.py): the coordinate
gathers and one mean aggregation of the 3-wide translations a layer,
lowered by ``segment_impl`` on a plain batch (``cumsum``: the CUDA prefix
scan on the card) or by ``blocked_impl`` on a blocked one (``pallas``: the
CUDA one-hot kernels on the card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from distegnn_tpu_torch.models.common import MLP, leaky
from distegnn_tpu_torch.ops.blocked import EdgeOps, blocked_slot_inv_deg
from distegnn_tpu_torch.ops.graph import GraphBatch
from distegnn_tpu_torch.parallel.collectives import global_node_mean


class _RadialField(MLP):
    """phi: invariants -> tanh'd H-vector; the last Dense bias-free with
    the coordinate-head init."""

    FLAX_PREFIX = ("MLP_0",)

    def __init__(self, fan_in: int, hidden_nf: int, generator=None):
        super().__init__(fan_in, [hidden_nf, hidden_nf], act=leaky,
                         use_bias_last=False, coord_head_last=True,
                         generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(super().forward(x))


class _ScalarHead(MLP):
    """Linear(H) -> LeakyReLU -> Linear(1)."""

    FLAX_PREFIX = ("MLP_0",)

    def __init__(self, hidden_nf: int, generator=None):
        super().__init__(hidden_nf, [hidden_nf, 1], act=leaky,
                         generator=generator)


class GCLRFVel(nn.Module):
    """One radial-field layer with velocity and virtual channels."""

    def __init__(self, hidden_nf: int, virtual_channels: int,
                 edge_attr_nf: int = 0, axis_name: Optional[str] = None,
                 seg_impl: str = "scatter", generator=None):
        super().__init__()
        H, C = hidden_nf, virtual_channels
        self.virtual_channels, self.edge_attr_nf = C, edge_attr_nf
        self.axis_name, self.seg_impl = axis_name, seg_impl
        kw = dict(generator=generator)
        self.phi = _RadialField(1 + edge_attr_nf, H, **kw)
        self.phi_v = _RadialField(1 + C, H, **kw)
        self.edge_mlp = _ScalarHead(H, **kw)
        self.edge_mlp_rv = _ScalarHead(H, **kw)
        self.coord_mlp_vel = MLP(1, [H, 1], act=leaky, **kw)
        self.edge_mlp_vr = _ScalarHead(H, **kw)

    def forward(self, x, v, X, g: GraphBatch, slot=None, inv_deg=None,
                oh=None, plan=None):
        """x/v [B,N,3], X [B,3,C] -> (x, X)."""
        C = self.virtual_channels
        node_mask = g.node_mask
        B, N = x.shape[0], x.shape[1]
        ops = EdgeOps(g, slot, inv_deg, oh, plan, seg_impl=self.seg_impl)

        coord_diff = ops.gather_rows(x) - ops.gather_cols(x)      # [B, E, 3]
        radial = torch.sum(coord_diff ** 2, dim=-1, keepdim=True)
        vcd = X[:, None, :, :] - x[..., None]                     # [B,N,3,C]
        virtual_radial = torch.linalg.norm(vcd, dim=2, keepdim=True)

        e_in = (torch.cat([radial, g.edge_attr], dim=-1)
                if self.edge_attr_nf else radial)
        edge_feat = self.phi(e_in)                                # [B, E, H]

        # LOCAL per-graph coordinate mean (the reference keeps it unreduced)
        coord_mean = global_node_mean(x, node_mask, None)         # [B, 3]
        Xc = X - coord_mean[:, :, None]
        m_X = torch.einsum("bdc,bde->bce", Xc, Xc)                # [B, C, C]
        v_in = torch.cat([virtual_radial.transpose(2, 3),         # [B,N,C,1]
                          m_X[:, None, :, :].expand(B, N, C, C)], dim=-1)
        vef = self.phi_v(v_in) * node_mask[:, :, None, None]      # [B,N,C,H]

        # the real coordinate update
        agg = ops.agg_rows_mean(coord_diff * self.edge_mlp(edge_feat))
        trans_v = torch.mean(-vcd * self.edge_mlp_rv(vef).transpose(2, 3),
                             dim=-1)
        speed = torch.linalg.norm(v, dim=-1, keepdim=True)
        x = x + agg + trans_v + v * self.coord_mlp_vel(speed)
        x = x * node_mask[..., None]

        # the virtual coordinate update: the one cross-part sum
        trans_X = vcd * self.edge_mlp_vr(vef).transpose(2, 3)
        X = X + global_node_mean(trans_X, node_mask, self.axis_name)
        return x, X


class FastRF(nn.Module):
    """FastRF: ``forward(batch) -> (loc_pred [B,N,3], virtual_loc
    [B,3,C])``; no embeddings and no node features, n_layers radial-field
    layers over (loc, vel, virtual loc)."""

    def __init__(self, edge_attr_nf: int = 0, hidden_nf: int = 64,
                 virtual_channels: int = 3, n_layers: int = 4,
                 axis_name: Optional[str] = None,
                 blocked_impl: str = "einsum", segment_impl: str = "scatter",
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        if virtual_channels < 1:
            raise ValueError("virtual_channels must be > 0")
        self.edge_attr_nf, self.hidden_nf = edge_attr_nf, hidden_nf
        self.virtual_channels, self.n_layers = virtual_channels, n_layers
        self.axis_name, self.blocked_impl = axis_name, blocked_impl
        self.gcl = nn.ModuleList([
            GCLRFVel(hidden_nf, virtual_channels, edge_attr_nf,
                     axis_name=axis_name, seg_impl=segment_impl,
                     generator=generator)
            for _ in range(n_layers)])

    def forward(self, g: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        X = g.loc_mean[:, :, None].repeat(1, 1, self.virtual_channels)
        x, v = g.loc, g.vel
        blocked = blocked_slot_inv_deg(g, self.blocked_impl)
        for layer in self.gcl:
            x, X = layer(x, v, X, g, *blocked)
        return x, X
