"""EGHN, the Equivariant Hierarchical Network (port of
``distegnn_tpu/models/eghn.py``; in the model library, not served by the
factory).

Per forward: the low-level EGNN force -> a learned soft cluster assignment
(PoolingNet over equivariant edge messages) -> the cluster-pooled
high-level graph (full P x P edges weighted by the pooled adjacency,
self-loops included) -> the high-level EGNN -> an equivariant kinematics
decode (EquivariantScalarNet / EGMN) back onto the nodes. The
normalized-cut auxiliary loss is kept on the module as ``cut_loss`` after
each forward (the JAX package sows it into the 'aux' collection).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from distegnn_tpu_torch.models.basic import (EGMN, BaseMLP, EGNNLayer,
                                             EquivariantEdgeScalarNet,
                                             EquivariantScalarNet)
from distegnn_tpu_torch.models.common import TorchDense
from distegnn_tpu_torch.ops.graph import GraphBatch
from distegnn_tpu_torch.ops.segment import segment_mean, segment_sum, take_rows


class PoolingLayer(nn.Module):
    """A vector + scalar message-passing step of the pooling net."""

    def __init__(self, hidden_nf: int, n_vector_input: int,
                 edge_attr_nf: int = 0, flat: bool = False, generator=None):
        super().__init__()
        H = hidden_nf
        self.edge_attr_nf = edge_attr_nf
        self.edge_message_net = EquivariantEdgeScalarNet(
            n_vector_input, H, scalar_nf=2 * H + edge_attr_nf, norm=True,
            flat=flat, generator=generator)
        self.node_net = BaseMLP(2 * H, H, H, flat=flat, generator=generator)

    def forward(self, vectors, h, g: GraphBatch):
        N, row, col = h.shape[1], g.row, g.col
        hij = [take_rows(h, row), take_rows(h, col)]
        if self.edge_attr_nf:
            hij.append(g.edge_attr)
        v_i, v_j = take_rows(vectors, row), take_rows(vectors, col)
        vec_out, msg = self.edge_message_net(v_i, v_j,
                                             scalars=torch.cat(hij, dim=-1))
        em = g.edge_mask
        vec_out = vec_out * em[..., None, None]
        msg = msg * em[..., None]
        vflat = vec_out.reshape(tuple(vec_out.shape[:2]) + (-1,))
        agg_v = segment_mean(vflat, row, N, mask=em)
        vectors = vectors + agg_v.reshape(vectors.shape)
        agg_m = segment_sum(msg, row, N, mask=em)
        h = h + self.node_net(torch.cat([h, agg_m], dim=-1))
        return vectors, h


class PoolingNet(nn.Module):
    """Stacked PoolingLayers + a tanh MLP head to the cluster logits."""

    def __init__(self, n_layers: int, n_vector_input: int, hidden_nf: int,
                 output_nf: int, edge_attr_nf: int = 0, flat: bool = False,
                 generator=None):
        super().__init__()
        self.layer = nn.ModuleList([
            PoolingLayer(hidden_nf, n_vector_input, edge_attr_nf, flat=flat,
                         generator=generator) for _ in range(n_layers)])
        self.pool_0 = TorchDense(hidden_nf, 8 * hidden_nf,
                                 generator=generator)
        self.pool_1 = TorchDense(8 * hidden_nf, output_nf,
                                 generator=generator)

    def forward(self, vectors, h, g: GraphBatch):
        if isinstance(vectors, (list, tuple)):
            vectors = torch.stack(list(vectors), dim=-1)         # [B,N,3,V]
        for layer in self.layer:
            vectors, h = layer(vectors, h, g)
        return self.pool_1(torch.tanh(self.pool_0(h)))


def _full_cluster_batch(X, V, H_feat, AA, P: int) -> GraphBatch:
    """GraphBatch over the P-cluster graph: full P x P edges (self-loops
    included), edge_attr = the pooled adjacency weights."""
    B, dev = X.shape[0], X.device
    ar = torch.arange(P, device=dev, dtype=torch.int32)
    row = ar.repeat_interleave(P)[None].expand(B, P * P)
    col = ar.repeat(P)[None].expand(B, P * P)
    return GraphBatch(
        node_feat=H_feat, node_attr=X.new_zeros((B, P, 0)), loc=X, vel=V,
        target=torch.zeros_like(X), loc_mean=torch.mean(X, dim=1),
        node_mask=X.new_ones((B, P)), edge_index=torch.stack([row, col], 1),
        edge_attr=AA.reshape(B, P * P, 1), edge_mask=X.new_ones((B, P * P)))


class EGHN(nn.Module):
    """EGHN: ``forward(batch) -> (loc_pred, None)``; the normalized-cut
    auxiliary loss of the forward is left in ``self.cut_loss``."""

    def __init__(self, in_node_nf: int, in_edge_nf: int, hidden_nf: int,
                 n_cluster: int = 4, layer_per_block: int = 3,
                 layer_pooling: int = 3, layer_decoder: int = 1,
                 with_v: bool = True, flat: bool = False, norm: bool = False,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        H = hidden_nf
        self.node_feat_nf, self.edge_attr_nf = in_node_nf, in_edge_nf
        self.n_cluster, self.with_v = n_cluster, with_v
        kw = dict(generator=generator)
        self.embedding = TorchDense(in_node_nf, H, **kw)
        # the low-level layers always see the velocities (so they carry
        # the velocity head whatever ``with_v``, as in the JAX package)
        self.low = nn.ModuleList([
            EGNNLayer(H, in_edge_nf, with_v=True, flat=flat, norm=norm,
                      **kw) for _ in range(layer_per_block)])
        n_vec = 3 if with_v else 2
        self.low_pooling = PoolingNet(layer_pooling, n_vec, H, n_cluster,
                                      in_edge_nf, flat=flat, **kw)
        self.high = nn.ModuleList([
            EGNNLayer(H, 1, with_v=with_v, flat=flat, **kw)
            for _ in range(layer_per_block)])
        n_dec = 4 if with_v else 3
        self.kinematics_net = (
            EquivariantScalarNet(n_dec, H, scalar_nf=2 * H, norm=True,
                                 flat=flat, **kw) if layer_decoder == 1
            else EGMN(layer_decoder, n_dec, H, scalar_nf=2 * H, norm=True,
                      flat=flat, **kw))
        self.cut_loss: Optional[torch.Tensor] = None

    def forward(self, g: GraphBatch) -> Tuple[torch.Tensor, None]:
        P = self.n_cluster
        x, v = g.loc, g.vel
        nmask = g.node_mask[..., None]
        h = self.embedding(g.node_feat)

        # the low-level force
        hx, hv, hh = x, v, h
        for layer in self.low:
            hx, hv, hh = layer(hx, hh, hv, g)
        nf = hx - x

        # the pooling assignment over the same graph edges
        x_mean = torch.sum(x * nmask, dim=1, keepdim=True) / torch.clamp(
            torch.sum(nmask, dim=1, keepdim=True), min=1.0)
        vecs = [x - x_mean, nf, v] if self.with_v else [x - x_mean, nf]
        s = torch.softmax(self.low_pooling(vecs, hh, g), dim=-1) * nmask

        # cluster aggregation
        count = torch.clamp(torch.sum(s, dim=1), min=1e-5)[..., None]
        X = torch.einsum("bnp,bnd->bpd", s, x) / count
        Hc = torch.einsum("bnp,bnd->bpd", s, hh) / count
        V = (torch.einsum("bnp,bnd->bpd", s, v) / count if self.with_v
             else None)

        # the pooled adjacency and the cut loss
        N = x.shape[1]
        a = segment_sum(take_rows(s, g.col) * g.edge_mask[..., None],
                        g.row, N)                                # [B, N, P]
        A = torch.einsum("bnp,bnq->bpq", s, a)                    # [B, P, P]
        A_n = A / torch.clamp(torch.linalg.norm(A, dim=2, keepdim=True),
                              min=1e-12)
        eye = torch.eye(P, dtype=A.dtype, device=A.device)
        self.cut_loss = torch.mean(torch.linalg.norm(
            (A_n - eye).reshape(A.shape[0], -1), dim=-1))

        # high-level message passing on the full cluster graph
        gc = _full_cluster_batch(X, V if V is not None
                                 else torch.zeros_like(X), Hc, A, P)
        cx, cv, ch = gc.loc, (gc.vel if self.with_v else None), Hc
        for layer in self.high:
            cx, cv, ch = layer(cx, ch, cv, gc)
        h_nf = cx - X
        X2 = X + h_nf

        # the low-level kinematics decode
        l_nf = torch.einsum("bnp,bpd->bnd", s, h_nf)
        l_X = torch.einsum("bnp,bpd->bnd", s, X)
        l_H = torch.einsum("bnp,bpd->bnd", s, ch)
        if self.with_v:
            l_V = torch.einsum("bnp,bpd->bnd", s, cv)
            vectors = [l_nf, x - l_X, v - l_V, nf]
        else:
            vectors = [l_nf, x - l_X, nf]
        l_kin, _ = self.kinematics_net(vectors,
                                       torch.cat([hh, l_H], dim=-1))
        x_out = torch.einsum("bnp,bpd->bnd", s, X2) + l_kin
        return x_out * nmask, None
