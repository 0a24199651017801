"""Baseline models (port of ``distegnn_tpu/models/basic.py``): the
scalarization O(n)-equivariant nets and the factory's baselines, EGNN (with
velocity), RF_vel and the linear dynamics, plus the plain GNN and the flat
MLP.

The scalarization trick: stack input vectors Z [.., 3, K], form the Gram
matrix Z^T Z [.., K, K] (rotation invariant), run MLPs on it, and recombine
the vectors with predicted coefficients: O(n)-equivariant by construction.

Batched GraphBatch layout, every aggregation masked (``index_add_``: these
families reach no kernel of the JAX package). The baselines return
``(loc_pred, None)``: no virtual nodes, so the trainer adds no MMD term.
Input widths are explicit arguments where flax infers them.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from distegnn_tpu_torch.models.common import MLP, TorchDense, silu
from distegnn_tpu_torch.ops.graph import GraphBatch
from distegnn_tpu_torch.ops.segment import segment_mean, segment_sum, take_rows


class BaseMLP(nn.Module):
    """2-layer MLP; ``flat`` switches to tanh with 4x the hidden width."""

    FLAX_CHILD = {"mlp": ("MLP_0",)}

    def __init__(self, fan_in: int, hidden_dim: int, output_dim: int, *,
                 act: Callable = silu, last_act: bool = False,
                 residual: bool = False, flat: bool = False, generator=None):
        super().__init__()
        self.residual = residual
        hidden = 4 * hidden_dim if flat else hidden_dim
        self.mlp = MLP(fan_in, [hidden, output_dim],
                       act=torch.tanh if flat else act, act_last=last_act,
                       generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.mlp(x)
        return x + out if self.residual else out


def _gram(Z: torch.Tensor, norm: bool) -> torch.Tensor:
    """Z [..., 3, K] -> the flattened Gram [..., K*K], optionally
    L2-normalised."""
    K = Z.shape[-1]
    s = torch.einsum("...dk,...de->...ke", Z, Z)
    s = s.reshape(tuple(s.shape[:-2]) + (K * K,))
    if norm:
        s = s / torch.clamp(torch.linalg.norm(s, dim=-1, keepdim=True),
                            min=1e-12)
    return s


def _stack(vectors) -> torch.Tensor:
    return (torch.stack(list(vectors), dim=-1)
            if isinstance(vectors, (list, tuple)) else vectors)


class EquivariantScalarNet(nn.Module):
    """vectors [.., 3, K] (+ scalars [.., S]) -> (equivariant vector
    [.., 3], invariant scalar [.., H])."""

    def __init__(self, n_vector_input: int, hidden_dim: int,
                 scalar_nf: int = 0, norm: bool = True, flat: bool = True,
                 generator=None):
        super().__init__()
        self.norm = norm
        kw = dict(flat=flat, generator=generator)
        H = hidden_dim
        self.in_scalar_net = BaseMLP(n_vector_input ** 2 + scalar_nf, H, H,
                                     last_act=True, **kw)
        self.out_vector_net = BaseMLP(H, H, n_vector_input, **kw)
        self.out_scalar_net = BaseMLP(H, H, H, **kw)

    def forward(self, vectors, scalars=None):
        Z = _stack(vectors)
        s = _gram(Z, self.norm)
        if scalars is not None:
            s = torch.cat([s, scalars], dim=-1)
        s = self.in_scalar_net(s)
        coef = self.out_vector_net(s)
        vector = torch.einsum("...dk,...k->...d", Z, coef)
        return vector, self.out_scalar_net(s)


class InvariantScalarNet(nn.Module):
    """vectors [.., 3, K] (+ scalars) -> invariant [.., output_dim]."""

    def __init__(self, n_vector_input: int, hidden_dim: int, output_dim: int,
                 scalar_nf: int = 0, norm: bool = True,
                 last_act: bool = False, flat: bool = False, generator=None):
        super().__init__()
        self.norm = norm
        self.scalar_net = BaseMLP(n_vector_input ** 2 + scalar_nf,
                                  hidden_dim, output_dim, last_act=last_act,
                                  flat=flat, generator=generator)

    def forward(self, vectors, scalars=None):
        s = _gram(_stack(vectors), self.norm)
        if scalars is not None:
            s = torch.cat([s, scalars], dim=-1)
        return self.scalar_net(s)


class EquivariantEdgeScalarNet(nn.Module):
    """Per-edge O(n)-equivariant net: the cross Gram Z_j^T Z_i -> MLP ->
    a K x K recombination applied to Z_j. Returns (vectors [.., 3, K],
    scalars [.., H])."""

    def __init__(self, n_vector: int, hidden_dim: int, scalar_nf: int = 0,
                 norm: bool = True, flat: bool = False, generator=None):
        super().__init__()
        K, H = n_vector, hidden_dim
        self.norm = norm
        kw = dict(flat=flat, generator=generator)
        self.in_scalar_net = BaseMLP(K * K + scalar_nf, H, H, last_act=True,
                                     **kw)
        self.out_vector_net = BaseMLP(H, H, K * K, **kw)

    def forward(self, vectors_i, vectors_j, scalars=None):
        K = vectors_i.shape[-1]
        s = torch.einsum("...dj,...dk->...jk", vectors_j, vectors_i)
        s = s.reshape(tuple(s.shape[:-2]) + (K * K,))
        if self.norm:
            s = s / torch.clamp(torch.linalg.norm(s, dim=-1, keepdim=True),
                                min=1e-12)
        if scalars is not None:
            s = torch.cat([s, scalars], dim=-1)
        s = self.in_scalar_net(s)
        coef = self.out_vector_net(s)
        coef = coef.reshape(tuple(coef.shape[:-1]) + (K, K))
        return torch.einsum("...dj,...jk->...dk", vectors_j, coef), s


class EGMN(nn.Module):
    """Stacked EquivariantScalarNets over a growing vector list."""

    def __init__(self, n_layers: int, n_vector_input: int, hidden_dim: int,
                 scalar_nf: int = 0, norm: bool = False, flat: bool = False,
                 generator=None):
        super().__init__()
        self.layer = nn.ModuleList([
            EquivariantScalarNet(n_vector_input + i, hidden_dim,
                                 scalar_nf if i == 0 else hidden_dim,
                                 norm=norm, flat=flat, generator=generator)
            for i in range(n_layers)])

    def forward(self, vectors, scalars):
        cur = list(vectors)
        for net in self.layer:
            vector, scalars = net(cur, scalars)
            cur.append(vector)
        return cur[-1], scalars


class EGCLClassic(nn.Module):
    """The classic EGNN conv: sum-aggregated edge messages,
    (1 + |r|)-normalised coordinate differences, residual node update.
    ``h`` is [.., hidden_nf]."""

    def __init__(self, hidden_nf: int, edge_attr_nf: int = 0,
                 recurrent: bool = True, attention: bool = False,
                 clamp: bool = False, tanh: bool = False,
                 coords_weight: float = 1.0, generator=None):
        super().__init__()
        H = hidden_nf
        self.edge_attr_nf, self.recurrent = edge_attr_nf, recurrent
        self.attention, self.clamp, self.tanh = attention, clamp, tanh
        self.coords_weight = coords_weight
        kw = dict(generator=generator)
        self.edge_mlp = MLP(2 * H + 1 + edge_attr_nf, [H, H], act_last=True,
                            **kw)
        if attention:
            self.att_mlp = TorchDense(H, 1, **kw)
        self.coord_mlp = MLP(H, [H, 1], use_bias_last=False,
                             coord_head_last=True, **kw)
        self.node_mlp = MLP(2 * H, [H, H], **kw)

    def forward(self, h, x, g: GraphBatch):
        N, row, col = x.shape[1], g.row, g.col
        coord_diff = take_rows(x, row) - take_rows(x, col)
        radial = torch.sum(coord_diff ** 2, dim=-1, keepdim=True)
        coord_diff = coord_diff / (torch.sqrt(radial + 1e-8) + 1.0)
        e_in = [take_rows(h, row), take_rows(h, col), radial]
        if self.edge_attr_nf:
            e_in.append(g.edge_attr)
        ef = self.edge_mlp(torch.cat(e_in, dim=-1))
        if self.attention:
            ef = ef * torch.sigmoid(self.att_mlp(ef))
        ef = ef * g.edge_mask[..., None]
        gate = self.coord_mlp(ef)
        if self.tanh:
            gate = torch.tanh(gate)
        trans = coord_diff * gate
        if self.clamp:
            trans = torch.clamp(trans, -100.0, 100.0)
        x = x + segment_mean(trans, row, N, mask=g.edge_mask) \
            * self.coords_weight
        agg_h = segment_sum(ef, row, N, mask=g.edge_mask)
        out = self.node_mlp(torch.cat([h, agg_h], dim=-1))
        h = h + out if self.recurrent else out
        nm = g.node_mask[..., None]
        return h * nm, x * nm


class EGNNLayer(nn.Module):
    """Scalarization-based EGNN conv with the velocity head (``with_v``:
    the layer is called with velocities) and the +-100 force clamp. ``h``
    is [.., hidden_nf]."""

    def __init__(self, hidden_nf: int, edge_attr_nf: int = 0,
                 with_v: bool = False, flat: bool = False, norm: bool = False,
                 generator=None):
        super().__init__()
        H = hidden_nf
        self.edge_attr_nf, self.with_v = edge_attr_nf, with_v
        kw = dict(flat=flat, generator=generator)
        self.edge_message_net = InvariantScalarNet(
            1, H, H, scalar_nf=2 * H + edge_attr_nf, norm=norm,
            last_act=True, **kw)
        self.coord_net = BaseMLP(H, H, 1, **kw)
        if with_v:
            self.node_v_net = BaseMLP(H, H, 1, **kw)
        self.node_net = BaseMLP(2 * H, H, H, **kw)

    def forward(self, x, h, v, g: GraphBatch):
        N, row, col = x.shape[1], g.row, g.col
        rij = take_rows(x, row) - take_rows(x, col)               # [B, E, 3]
        hij = [take_rows(h, row), take_rows(h, col)]
        if self.edge_attr_nf:
            hij.append(g.edge_attr)
        message = self.edge_message_net(rij[..., None],
                                        scalars=torch.cat(hij, dim=-1))
        message = message * g.edge_mask[..., None]
        f = rij * self.coord_net(message)
        tot_f = torch.clamp(segment_mean(f, row, N, mask=g.edge_mask),
                            -100.0, 100.0)
        if v is not None:
            x = x + self.node_v_net(h) * v + tot_f
        else:
            x = x + tot_f
        nm = g.node_mask[..., None]
        x = x * nm
        tot_message = segment_mean(message, row, N, mask=g.edge_mask)
        h = self.node_net(torch.cat([h, tot_message], dim=-1)) * nm
        return x, v, h


class EGNN(nn.Module):
    """The EGNN baseline (the factory builds it with ``with_v=True``)."""

    def __init__(self, n_layers: int, in_node_nf: int, in_edge_nf: int,
                 hidden_nf: int, with_v: bool = True, flat: bool = False,
                 norm: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.node_feat_nf, self.edge_attr_nf = in_node_nf, in_edge_nf
        self.with_v = with_v
        self.embedding = TorchDense(in_node_nf, hidden_nf,
                                    generator=generator)
        self.layer = nn.ModuleList([
            EGNNLayer(hidden_nf, in_edge_nf, with_v=with_v, flat=flat,
                      norm=norm, generator=generator)
            for _ in range(n_layers)])

    def forward(self, g: GraphBatch) -> Tuple[torch.Tensor, None]:
        h = self.embedding(g.node_feat)
        x, v = g.loc, (g.vel if self.with_v else None)
        for layer in self.layer:
            x, v, h = layer(x, h, v, g)
        return x, None


class RFVel(nn.Module):
    """The RF baseline: per layer m_ij = (x_i - x_j) tanh(phi(|x_i - x_j|,
    e_ij)) with the bias-free coordinate-head Dense, x += mean_j m_ij +
    v psi(|v|). SiLU activations (RF_vel forwards its default, unlike
    FastRF)."""

    def __init__(self, hidden_nf: int, edge_attr_nf: int = 0,
                 n_layers: int = 4, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H = hidden_nf
        self.edge_attr_nf = edge_attr_nf
        kw = dict(generator=generator)
        self.phi = nn.ModuleList([
            MLP(1 + edge_attr_nf, [H, 1], use_bias_last=False,
                coord_head_last=True, **kw) for _ in range(n_layers)])
        self.coord_mlp_vel = nn.ModuleList([
            MLP(1, [H, 1], **kw) for _ in range(n_layers)])

    def forward(self, g: GraphBatch) -> Tuple[torch.Tensor, None]:
        x, v = g.loc, g.vel
        vel_norm = torch.linalg.norm(v + 1e-30, dim=-1, keepdim=True)
        N, row, col = x.shape[1], g.row, g.col
        for phi, vel_mlp in zip(self.phi, self.coord_mlp_vel):
            x_diff = take_rows(x, row) - take_rows(x, col)
            radial = torch.sqrt(torch.sum(x_diff ** 2, dim=-1, keepdim=True)
                                + 1e-30)
            e_in = (torch.cat([radial, g.edge_attr], dim=-1)
                    if self.edge_attr_nf else radial)
            m = x_diff * torch.tanh(phi(e_in))
            x = x + segment_mean(m, row, N, mask=g.edge_mask)
            x = x + v * vel_mlp(vel_norm)
            x = x * g.node_mask[..., None]
        return x, None


class GNN(nn.Module):
    """A plain message-passing GNN with a 3-wide decoder: the
    non-equivariant baseline, predicting absolute positions."""

    def __init__(self, n_layers: int, in_node_nf: int, in_edge_nf: int,
                 hidden_nf: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H = hidden_nf
        self.node_feat_nf, self.edge_attr_nf = in_node_nf, in_edge_nf
        kw = dict(generator=generator)
        self.embedding = TorchDense(in_node_nf + 6, H, **kw)
        self.edge_mlp = nn.ModuleList([
            MLP(2 * H + in_edge_nf, [H, H], **kw) for _ in range(n_layers)])
        self.node_mlp = nn.ModuleList([
            MLP(2 * H, [H, H], **kw) for _ in range(n_layers)])
        self.decoder = MLP(H, [H, 3], **kw)

    def forward(self, g: GraphBatch) -> Tuple[torch.Tensor, None]:
        N, row, col = g.loc.shape[1], g.row, g.col
        nm = g.node_mask[..., None]
        h = self.embedding(torch.cat([g.node_feat, g.loc, g.vel], dim=-1))
        for edge_mlp, node_mlp in zip(self.edge_mlp, self.node_mlp):
            msg_in = [take_rows(h, row), take_rows(h, col)]
            if self.edge_attr_nf:
                msg_in.append(g.edge_attr)
            msg = edge_mlp(torch.cat(msg_in, dim=-1)) * g.edge_mask[..., None]
            agg = segment_mean(msg, row, N, mask=g.edge_mask)
            h = (h + node_mlp(torch.cat([agg, h], dim=-1))) * nm
        return self.decoder(h) * nm, None


class LinearDynamics(nn.Module):
    """x + v t with a learnable scalar t (1 at init)."""

    def __init__(self, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.time = nn.Parameter(torch.ones(1))

    def forward(self, g: GraphBatch) -> Tuple[torch.Tensor, None]:
        return g.loc + g.vel * self.time, None


class FullMLP(nn.Module):
    """A flat MLP over the concatenated per-node state: the weakest
    baseline."""

    def __init__(self, in_node_nf: int, hidden_nf: int = 64, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.node_feat_nf = in_node_nf
        self.mlp = MLP(in_node_nf + 6, [hidden_nf, hidden_nf, 3],
                       generator=generator)

    def forward(self, g: GraphBatch) -> Tuple[torch.Tensor, None]:
        inp = torch.cat([g.node_feat, g.loc, g.vel], dim=-1)
        return g.loc + self.mlp(inp) * g.node_mask[..., None], None
