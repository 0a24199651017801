"""TFN layers (port of ``distegnn_tpu/models/se3/tfn.py``): SE(3)-equivariant
graph convolution over padded edge arrays.

Features are dicts degree -> [B, N, m, 2d+1]; a message is one contraction
per degree pair over [B, E, ...] arrays, followed by a masked segment mean.
As in the JAX package, LayerNorm over the channel axis stands in for the
reference's BatchNorm (batch statistics over a padded, partitioned axis are
ill-defined).

Parameter names follow the flax tree (``radial_{d_in}_{d_out}``,
``self_{d}``, ``ln_{d}``, ``lin_{d}_{i}``, ``w_{d}``), so that
``convert.params_from_jax`` maps them by name.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from distegnn_tpu_torch.models.common import Dense, LayerNorm
from distegnn_tpu_torch.models.se3.basis import compute_basis_and_r
from distegnn_tpu_torch.models.se3.fibers import Fiber
from distegnn_tpu_torch.ops.graph import GraphBatch
from distegnn_tpu_torch.ops.segment import segment_mean, take_rows


def _normal(shape, std: float, generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


class RadialFunc(nn.Module):
    """Radial profile R(r, w) -> [B, E, m_out, m_in, num_freq]: Dense ->
    LayerNorm -> relu, twice, then Dense (he_uniform kernels, zero
    biases)."""

    FLAX_CHILD = {"d0": ("Dense_0",), "ln0": ("LayerNorm_0",),
                  "d1": ("Dense_1",), "ln1": ("LayerNorm_1",),
                  "d2": ("Dense_2",)}

    def __init__(self, num_freq: int, in_dim: int, out_dim: int,
                 feat_dim: int = 1, mid_dim: int = 32, generator=None):
        super().__init__()
        self.shape = (out_dim, in_dim, num_freq)
        kw = dict(init="kaiming", generator=generator)
        self.d0 = Dense(feat_dim, mid_dim, **kw)
        self.ln0 = LayerNorm(mid_dim)
        self.d1 = Dense(mid_dim, mid_dim, **kw)
        self.ln1 = LayerNorm(mid_dim)
        self.d2 = Dense(mid_dim, num_freq * in_dim * out_dim, **kw)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.ln0(self.d0(feat)))
        y = torch.relu(self.ln1(self.d1(y)))
        y = self.d2(y)
        return y.reshape(tuple(y.shape[:-1]) + self.shape)


def gather_degree(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """h [B, N, m, 2d+1] at the nodes idx [B, E] -> [B, E, m, 2d+1]."""
    return take_rows(h, idx)


def pair_message(R: torch.Tensor, basis: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """The kernel applied to the source features: einsum('beoif,bepqf,
    beiq->beop'), contracted basis-with-source first (the [B, E, o, i, p,
    q] product of R and the basis would be the largest array)."""
    bs = torch.einsum("bepqf,beiq->bepif", basis, src)
    return torch.einsum("beoif,bepif->beop", R, bs)


class GConvSE3(nn.Module):
    """Tensor-field conv f_in -> f_out with mean aggregation and optional
    per-edge self-interaction."""

    def __init__(self, f_in: Fiber, f_out: Fiber,
                 self_interaction: bool = False, edge_dim: int = 0,
                 generator=None):
        super().__init__()
        self.f_in, self.f_out = f_in, f_out
        self.self_interaction, self.edge_dim = self_interaction, edge_dim
        for m_out, d_out in f_out.structure:
            for m_in, d_in in f_in.structure:
                self.add_module(f"radial_{d_in}_{d_out}", RadialFunc(
                    2 * min(d_in, d_out) + 1, m_in, m_out,
                    feat_dim=edge_dim + 1, generator=generator))
            if self_interaction and d_out in f_in.structure_dict:
                m_in = f_in.structure_dict[d_out]
                self.register_parameter(f"self_{d_out}", _normal(
                    (m_out, m_in), 1.0 / math.sqrt(m_in), generator))

    def forward(self, h: Dict[int, torch.Tensor], g: GraphBatch, r, basis):
        row, col = g.row, g.col                    # dst, src
        N = g.loc.shape[1]
        feat = torch.cat([g.edge_attr, r], dim=-1) if self.edge_dim else r
        out = {}
        for m_out, d_out in self.f_out.structure:
            msg = 0.0
            for m_in, d_in in self.f_in.structure:
                R = getattr(self, f"radial_{d_in}_{d_out}")(feat)
                msg = msg + pair_message(R, basis[(d_in, d_out)],
                                         gather_degree(h[d_in], col))
            if self.self_interaction and d_out in self.f_in.structure_dict:
                W = getattr(self, f"self_{d_out}")
                msg = msg + torch.einsum("oi,beip->beop", W,
                                         gather_degree(h[d_out], row))
            # masked mean over incoming edges
            em = g.edge_mask[..., None, None].to(msg.dtype)
            flat = (msg * em).reshape(tuple(msg.shape[:2]) + (-1,))
            agg = segment_mean(flat, row, N, mask=g.edge_mask)
            out[d_out] = agg.reshape(tuple(agg.shape[:2])
                                     + (m_out, 2 * d_out + 1))
        return out


class GNormSE3(nn.Module):
    """Norm nonlinearity: out = fnc(|v|) * v / |v| per degree."""

    def __init__(self, fiber: Fiber, num_layers: int = 0, generator=None):
        super().__init__()
        self.fiber, self.num_layers = fiber, num_layers
        for m, d in fiber.structure:
            if num_layers == 0:
                self.add_module(f"ln_{d}", LayerNorm(m))
            for i in range(num_layers):
                self.add_module(f"ln_{d}_{i}", LayerNorm(m))
                self.add_module(f"lin_{d}_{i}", Dense(
                    m, m, bias=i == num_layers - 1, init="kaiming",
                    generator=generator))

    def forward(self, h: Dict[int, torch.Tensor]):
        out = {}
        for m, d in self.fiber.structure:
            v = h[d]
            norm = torch.clamp(torch.linalg.norm(v + 1e-30, dim=-1,
                                                 keepdim=True), min=1e-12)
            phase = v / norm
            s = norm[..., 0]                                     # [B, N, m]
            if self.num_layers == 0:
                s = torch.relu(getattr(self, f"ln_{d}")(s))
            for i in range(self.num_layers):
                s = torch.relu(getattr(self, f"ln_{d}_{i}")(s))
                s = getattr(self, f"lin_{d}_{i}")(s)
            out[d] = s[..., None] * phase
        return out


class G1x1SE3(nn.Module):
    """Per-degree linear mixing of the channels."""

    def __init__(self, f_in: Fiber, f_out: Fiber, generator=None):
        super().__init__()
        self.f_in, self.f_out = f_in, f_out
        for m_out, d in f_out.structure:
            if d in f_in.structure_dict:
                m_in = f_in.structure_dict[d]
                self.register_parameter(f"w_{d}", _normal(
                    (m_out, m_in), 1.0 / math.sqrt(m_in), generator))

    def forward(self, h: Dict[int, torch.Tensor]):
        return {d: torch.einsum("oi,bnip->bnop", getattr(self, f"w_{d}"),
                                h[d])
                for _, d in self.f_out.structure
                if d in self.f_in.structure_dict}


class TFN(nn.Module):
    """(num_layers - 1) x [GConvSE3 (self-interaction) -> GNormSE3], then
    a final GConvSE3 to the out fiber. ``in_types`` / ``out_types`` are
    degree -> multiplicity dicts; call with a feature dict and a
    GraphBatch."""

    def __init__(self, num_layers: int, num_channels: int,
                 num_degrees: int = 4, num_nlayers: int = 1,
                 edge_dim: int = 0, in_types: Optional[dict] = None,
                 out_types: Optional[dict] = None, generator=None):
        super().__init__()
        self.num_degrees = num_degrees
        fin = Fiber(dictionary=in_types or {0: 1, 1: 1})
        fmid = Fiber(num_degrees, num_channels)
        fout = Fiber(dictionary=out_types or {1: 1})
        kw = dict(edge_dim=edge_dim, generator=generator)
        convs, norms, f = [], [], fin
        for _ in range(num_layers - 1):
            convs.append(GConvSE3(f, fmid, self_interaction=True, **kw))
            norms.append(GNormSE3(fmid, num_layers=num_nlayers,
                                  generator=generator))
            f = fmid
        convs.append(GConvSE3(f, fout, self_interaction=True, **kw))
        self.conv, self.norm = nn.ModuleList(convs), nn.ModuleList(norms)

    def forward(self, h: Dict[int, torch.Tensor], g: GraphBatch):
        rel = take_rows(g.loc, g.row) - take_rows(g.loc, g.col)  # dst - src
        basis, r = compute_basis_and_r(rel, self.num_degrees - 1)
        for conv, norm in zip(self.conv, self.norm):
            h = norm(conv(h, g, r, basis))
        return self.conv[-1](h, g, r, basis)
