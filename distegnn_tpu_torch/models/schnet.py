"""SchNet with equivariant coordinate updates (port of
``distegnn_tpu/models/schnet.py``).

Per interaction block the continuous-filter feature update PLUS the
equivariant coordinate update ``pos += mean_j (pos_i - pos_j) *
Linear([gauss(d_ij), h_i, h_j])``. The feature path keeps PyG's pieces:
the Gaussian distance expansion, CFConv with the cosine cutoff window,
the shifted softplus, xavier kernels and zero biases. The embedding is a
Linear over the node features. ``forward`` returns ``(loc_pred, None)``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from distegnn_tpu_torch.models.common import Dense, TorchDense
from distegnn_tpu_torch.ops.graph import GraphBatch
from distegnn_tpu_torch.ops.segment import segment_mean, segment_sum, take_rows

_LOG2 = math.log(2.0)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.softplus(x) - _LOG2


class GaussianSmearing(nn.Module):
    """exp(-gamma (d - mu_k)^2) distance expansion (no parameters)."""

    def __init__(self, start: float = 0.0, stop: float = 5.0,
                 num_gaussians: int = 50):
        super().__init__()
        self.register_buffer("offset", torch.linspace(start, stop,
                                                      num_gaussians),
                             persistent=False)
        self.coeff = -0.5 / float((stop - start) / (num_gaussians - 1)) ** 2

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.coeff * (dist[..., None] - self.offset) ** 2)


class CFConv(nn.Module):
    """Continuous-filter conv x_i' = lin2(sum_j lin1(x_j) * W(d_ij)) with the
    cosine cutoff window; ``filter1``/``filter2`` make W from the Gaussian
    expansion."""

    FLAX_CHILD = {"filter1": ("Dense_0",), "filter2": ("Dense_1",),
                  "lin1": ("Dense_2",), "lin2": ("Dense_3",)}

    def __init__(self, hidden_channels: int, num_filters: int,
                 num_gaussians: int, cutoff: float, generator=None):
        super().__init__()
        kw = dict(generator=generator)
        self.cutoff = cutoff
        self.filter1 = Dense(num_gaussians, num_filters, **kw)
        self.filter2 = Dense(num_filters, num_filters, **kw)
        self.lin1 = Dense(hidden_channels, num_filters, bias=False, **kw)
        self.lin2 = Dense(num_filters, hidden_channels, **kw)

    def forward(self, h, g: GraphBatch, edge_weight, edge_attr):
        W = self.filter2(shifted_softplus(self.filter1(edge_attr)))
        C = 0.5 * (torch.cos(edge_weight * math.pi / self.cutoff) + 1.0)
        W = W * C[..., None] * g.edge_mask[..., None]
        msg = take_rows(self.lin1(h), g.col) * W
        agg = segment_sum(msg, g.row, h.shape[1])               # aggr='add'
        return self.lin2(agg)


class InteractionBlock(nn.Module):
    """CFConv -> shifted softplus -> Linear."""

    FLAX_CHILD = {"conv": ("CFConv_0",), "lin": ("Dense_0",)}

    def __init__(self, hidden_channels: int, num_filters: int,
                 num_gaussians: int, cutoff: float, generator=None):
        super().__init__()
        self.conv = CFConv(hidden_channels, num_filters, num_gaussians,
                           cutoff, generator=generator)
        self.lin = Dense(hidden_channels, hidden_channels,
                         generator=generator)

    def forward(self, h, g: GraphBatch, edge_weight, edge_attr):
        return self.lin(shifted_softplus(self.conv(h, g, edge_weight,
                                                   edge_attr)))


class SchNet(nn.Module):
    """The SchNet baseline (the factory: hidden_channels = hidden_nf, the
    cutoff by dataset; 6 interactions, 128 filters, 50 Gaussians). The
    distances and their expansion come from the INITIAL positions; only
    the direction vector tracks the updated ones."""

    def __init__(self, in_node_nf: int, hidden_channels: int = 128,
                 num_filters: int = 128, num_interactions: int = 6,
                 num_gaussians: int = 50, cutoff: float = 10.0,
                 embed_input: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H = hidden_channels
        self.node_feat_nf = in_node_nf
        self.embedding = (TorchDense(in_node_nf, H, generator=generator)
                          if embed_input else None)
        self.smearing = GaussianSmearing(0.0, cutoff, num_gaussians)
        self.coord_update = nn.ModuleList([
            TorchDense(num_gaussians + 2 * H, 1, generator=generator)
            for _ in range(num_interactions)])
        self.interaction = nn.ModuleList([
            InteractionBlock(H, num_filters, num_gaussians, cutoff,
                             generator=generator)
            for _ in range(num_interactions)])

    def forward(self, g: GraphBatch, h: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, None]:
        h = g.node_feat if h is None else h
        if self.embedding is not None:
            h = self.embedding(h)
        pos, _ = self.run_interactions(h, g.loc, g)
        return pos, None

    def run_interactions(self, h, pos, g: GraphBatch):
        N = pos.shape[1]
        row, col = g.row, g.col
        diff0 = take_rows(pos, row) - take_rows(pos, col)
        edge_weight = torch.linalg.norm(diff0 + 1e-30, dim=-1)
        edge_attr = self.smearing(edge_weight)
        nm = g.node_mask[..., None]
        for gate_fn, block in zip(self.coord_update, self.interaction):
            diff = take_rows(pos, row) - take_rows(pos, col)
            gate = gate_fn(torch.cat([edge_attr, take_rows(h, row),
                                      take_rows(h, col)], dim=-1))
            upd = segment_mean(diff * gate, row, N, mask=g.edge_mask)
            pos = pos + upd * nm
            h = (h + block(h, g, edge_weight, edge_attr)) * nm
        return pos, h
