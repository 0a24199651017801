"""SE(3)-equivariant attention, the SE(3)-Transformer (port of
``distegnn_tpu/models/se3/attention.py``).

GConvSE3Partial (per-edge kernel values), GMABSE3 (multi-head attention with
a masked segment softmax in place of DGL's edge_softmax), GSE3Res (the
attention block), the fiber sum / concat and the pools, and the
SE3Transformer assembly with its learnable output scale ``scalar_trick``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from distegnn_tpu_torch.models.se3.basis import compute_basis_and_r
from distegnn_tpu_torch.models.se3.fibers import Fiber
from distegnn_tpu_torch.models.se3.tfn import (G1x1SE3, GConvSE3, GNormSE3,
                                               RadialFunc, gather_degree,
                                               pair_message)
from distegnn_tpu_torch.ops.graph import GraphBatch
from distegnn_tpu_torch.ops.segment import (segment_softmax, segment_sum,
                                            take_rows)


class GConvSE3Partial(nn.Module):
    """Node -> edge partial conv: the per-edge kernel values WITHOUT the
    aggregation (the value and key embeddings of the attention)."""

    def __init__(self, f_in: Fiber, f_out: Fiber, edge_dim: int = 0,
                 generator=None):
        super().__init__()
        self.f_in, self.f_out, self.edge_dim = f_in, f_out, edge_dim
        for m_out, d_out in f_out.structure:
            for m_in, d_in in f_in.structure:
                self.add_module(f"radial_{d_in}_{d_out}", RadialFunc(
                    2 * min(d_in, d_out) + 1, m_in, m_out,
                    feat_dim=edge_dim + 1, generator=generator))

    def forward(self, h: Dict[int, torch.Tensor], g: GraphBatch, r, basis):
        feat = torch.cat([g.edge_attr, r], dim=-1) if self.edge_dim else r
        out = {}
        for m_out, d_out in self.f_out.structure:
            msg = 0.0
            for m_in, d_in in self.f_in.structure:
                R = getattr(self, f"radial_{d_in}_{d_out}")(feat)
                msg = msg + pair_message(R, basis[(d_in, d_out)],
                                         gather_degree(h[d_in], g.col))
            out[d_out] = msg                     # [B, E, m_out, 2d_out+1]
        return out


def fiber2head(F: Dict[int, torch.Tensor], n_heads: int,
               structure: Fiber) -> torch.Tensor:
    """Stack a fiber dict into per-head flat vectors [..., heads, feat]."""
    return torch.cat([F[d].reshape(tuple(F[d].shape[:-2]) + (n_heads, -1))
                      for d in structure.degrees], dim=-1)


class GMABSE3(nn.Module):
    """Multi-head attention: score = <k_edge, q_dst> / sqrt(F); a masked
    softmax over each node's incoming edges; the attention-weighted sum of
    the values. No parameters."""

    def __init__(self, f_value: Fiber, f_key: Fiber, n_heads: int = 1):
        super().__init__()
        self.f_value, self.f_key, self.n_heads = f_value, f_key, n_heads

    def forward(self, v: Dict, k: Dict, q: Dict, g: GraphBatch):
        N, row = g.loc.shape[1], g.row
        k_h = fiber2head(k, self.n_heads, self.f_key)              # [B,E,H,F]
        q_h = fiber2head(q, self.n_heads, self.f_key)              # [B,N,H,F]
        q_edge = take_rows(q_h, row)
        scores = torch.sum(k_h * q_edge, dim=-1) / math.sqrt(
            self.f_key.n_features)                                 # [B,E,H]
        attn = segment_softmax(scores, row, N, mask=g.edge_mask)
        out = {}
        for m, d in self.f_value.structure:
            val = v[d].reshape(tuple(v[d].shape[:2])
                               + (self.n_heads, m // self.n_heads, 2 * d + 1))
            weighted = attn[..., None, None] * val
            flat = weighted.reshape(tuple(weighted.shape[:2]) + (-1,))
            agg = segment_sum(flat, row, N, mask=g.edge_mask)
            out[d] = agg.reshape(tuple(agg.shape[:2]) + (m, 2 * d + 1))
        return out


class GSE3Res(nn.Module):
    """Attention block: value / key partial convs, the query projection and
    GMABSE3 (the reference's skip connection is commented out upstream and
    omitted, as in the JAX package)."""

    def __init__(self, f_in: Fiber, f_out: Fiber, edge_dim: int = 0,
                 div: float = 1, n_heads: int = 1, generator=None):
        super().__init__()
        f_mid_out = Fiber(dictionary={d: int(m // div) for d, m in
                                      f_out.structure_dict.items()})
        f_mid_in = Fiber(dictionary={d: m for d, m in
                                     f_mid_out.structure_dict.items()
                                     if d in f_in.structure_dict})
        kw = dict(edge_dim=edge_dim, generator=generator)
        self.v = GConvSE3Partial(f_in, f_mid_out, **kw)
        self.k = GConvSE3Partial(f_in, f_mid_in, **kw)
        self.q = G1x1SE3(f_in, f_mid_in, generator=generator)
        self.attn = GMABSE3(f_mid_out, f_mid_in, n_heads=n_heads)

    def forward(self, h: Dict, g: GraphBatch, r, basis):
        return self.attn(self.v(h, g, r, basis), self.k(h, g, r, basis),
                         self.q(h), g)


def gsum(x: Dict, y: Dict) -> Dict:
    """Residual sum, zero-padding mismatched multiplicities."""
    out = {}
    for d in set(x) | set(y):
        if d in x and d in y:
            a, b = x[d], y[d]
            m = max(a.shape[-2], b.shape[-2])
            pad = (lambda t: torch.nn.functional.pad(
                t, (0, 0, 0, m - t.shape[-2])))
            out[d] = pad(a) + pad(b)
        else:
            out[d] = x.get(d, y.get(d))
    return out


def gcat(x: Dict, y: Dict) -> Dict:
    """Concatenate the multiplicities of the degrees present in x."""
    return {d: (torch.cat([x[d], y[d]], dim=-2) if d in y else x[d])
            for d in x}


def g_avg_pool(features: Dict, g: GraphBatch, degree: int = 0):
    """Masked mean over the nodes."""
    h = features[degree]
    m = g.node_mask[..., None, None].to(h.dtype)
    return torch.sum(h * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                 min=1.0)


def g_max_pool(features: Dict, g: GraphBatch):
    """Masked max over the nodes of the last degree-0 channel."""
    h = features[0][..., -1]
    return torch.amax(torch.where(g.node_mask[:, :, None] > 0, h,
                                  h.new_full((), -1e30)), dim=1)


class SE3Transformer(nn.Module):
    """num_layers x [GSE3Res -> GNormSE3], then GConvSE3 to the out fiber;
    every output degree scaled by the learnable ``scalar_trick`` (0.01 at
    init)."""

    def __init__(self, num_layers: int, num_channels: int,
                 num_degrees: int = 4, edge_dim: int = 0, div: float = 1,
                 n_heads: int = 1, in_types: Optional[dict] = None,
                 out_types: Optional[dict] = None, generator=None):
        super().__init__()
        self.num_degrees = num_degrees
        fin = Fiber(dictionary=in_types or {0: 1, 1: 1})
        fmid = Fiber(num_degrees, num_channels)
        fout = Fiber(dictionary=out_types or {1: 1})
        res, norms, f = [], [], fin
        for _ in range(num_layers):
            res.append(GSE3Res(f, fmid, edge_dim=edge_dim, div=div,
                               n_heads=n_heads, generator=generator))
            norms.append(GNormSE3(fmid, generator=generator))
            f = fmid
        self.res, self.norm = nn.ModuleList(res), nn.ModuleList(norms)
        self.conv_out = GConvSE3(f, fout, self_interaction=True,
                                 edge_dim=edge_dim, generator=generator)
        self.scalar_trick = nn.Parameter(torch.full((1,), 0.01))

    def forward(self, h: Dict[int, torch.Tensor], g: GraphBatch):
        rel = take_rows(g.loc, g.row) - take_rows(g.loc, g.col)
        basis, r = compute_basis_and_r(rel, self.num_degrees - 1)
        for res, norm in zip(self.res, self.norm):
            h = norm(res(h, g, r, basis))
        h = self.conv_out(h, g, r, basis)
        return {d: v * self.scalar_trick for d, v in h.items()}
