"""The TFN and SE(3)-Transformer baselines (port of
``distegnn_tpu/models/se3/dynamics.py``): the factory builds them at
nf = hidden_nf // 2, num_degrees = 2.

Features: degree 0 = the charges [B, N, 1, 1] (``node_attr``, else the last
node feature), degree 1 = the velocity [B, N, 1, 3]; the output is the
degree-1 channel added to the input positions. ``forward`` returns
``(loc_pred, None)``: no virtual nodes, so no MMD term.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from distegnn_tpu_torch.models.se3.attention import SE3Transformer
from distegnn_tpu_torch.models.se3.basis import cart_to_deg1, deg1_to_cart
from distegnn_tpu_torch.models.se3.tfn import TFN
from distegnn_tpu_torch.ops.graph import GraphBatch


def _in_features(g: GraphBatch):
    charges = (g.node_attr if g.node_attr.shape[-1]
               else g.node_feat[..., -1:])
    return {0: charges[..., None],                        # [B, N, 1, 1]
            1: cart_to_deg1(g.vel)[:, :, None, :]}        # [B, N, 1, 3]


def _out_positions(g: GraphBatch, out) -> torch.Tensor:
    return g.loc + deg1_to_cart(out[1][:, :, 0, :]) * g.node_mask[..., None]


class TFNDynamics(nn.Module):
    def __init__(self, nf: int = 32, n_layers: int = 3,
                 num_degrees: int = 2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.tfn = TFN(num_layers=n_layers, num_channels=nf,
                       num_degrees=num_degrees, in_types={0: 1, 1: 1},
                       out_types={1: 1}, generator=generator)

    def forward(self, g: GraphBatch) -> Tuple[torch.Tensor, None]:
        return _out_positions(g, self.tfn(_in_features(g), g)), None


class SE3TransformerDynamics(nn.Module):
    """The attention stack instead of plain TFN convs, the same feature
    plumbing."""

    def __init__(self, nf: int = 32, n_layers: int = 3,
                 num_degrees: int = 2, div: float = 1, n_heads: int = 1, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.se3t = SE3Transformer(
            num_layers=n_layers, num_channels=nf, num_degrees=num_degrees,
            div=div, n_heads=n_heads, in_types={0: 1, 1: 1},
            out_types={1: 1}, generator=generator)

    def forward(self, g: GraphBatch) -> Tuple[torch.Tensor, None]:
        return _out_positions(g, self.se3t(_in_features(g), g)), None
