"""Shared building blocks (port of ``distegnn_tpu/models/common.py``).

Init parity with torch ``nn.Linear`` defaults, as in the JAX package:
weights and biases U(+-1/sqrt(fan_in)); coordinate heads xavier_uniform with
gain 1e-3 and no bias. Parameters are f32; ``dtype`` is the COMPUTE dtype
(inputs and parameters are cast to it, the product and the bias add are
rounded to it separately, as flax's ``nn.Dense(dtype=...)`` rounds them).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def resolve_dtype(d) -> Optional[torch.dtype]:
    """Normalise a compute-dtype spec (None | 'bf16' | 'bfloat16' | 'f32' |
    torch dtype) to ``torch.bfloat16`` or None (= float32 compute)."""
    if d is None or d in ("none", "None", "f32", "float32", torch.float32):
        return None
    if d in ("bf16", "bfloat16") or d is torch.bfloat16:
        return torch.bfloat16
    raise ValueError(f"unsupported compute dtype {d!r}")


def uniform_(t: torch.Tensor, bound: float, generator) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class TorchDense(nn.Linear):
    """``nn.Linear`` with the JAX package's TorchDense init and an optional
    compute dtype. ``coord_head=True`` selects the coordinate-head init
    (xavier_uniform, gain 1e-3)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, coord_head: bool = False,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        if coord_head:
            bound = 1e-3 * math.sqrt(6.0 / (in_features + out_features))
        else:
            bound = 1.0 / math.sqrt(in_features)
        uniform_(self.weight, bound, generator)
        if self.bias is not None:
            uniform_(self.bias, 1.0 / math.sqrt(in_features), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w, b = self.weight, self.bias
        if dt is not None:
            x, w = x.to(dt), w.to(dt)
            b = b.to(dt) if b is not None else None
        y = x @ w.t()
        return y + b if b is not None else y


class MLP(nn.Module):
    """Dense(+silu) stack; optionally silu after the last layer too."""

    def __init__(self, fan_in: int, sizes: Sequence[int], *,
                 act_last: bool = False, use_bias_last: bool = True,
                 coord_head_last: bool = False,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        layers, f = [], fan_in
        for i, s in enumerate(sizes):
            last = i == len(sizes) - 1
            layers.append(TorchDense(
                f, s, bias=use_bias_last if last else True,
                coord_head=coord_head_last and last, dtype=dtype,
                generator=generator))
            f = s
        self.layers = nn.ModuleList(layers)
        self.act_last = act_last

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1 or self.act_last:
                x = x * torch.sigmoid(x)
        return x


class CoordMLP(MLP):
    """Dense(H) -> silu -> Dense(1, no bias, coordinate-head init)
    [-> tanh]. The scalar feeds geometry, so it is returned in f32."""

    def __init__(self, fan_in: int, hidden_nf: int, *, tanh: bool = False,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__(fan_in, [hidden_nf, 1], use_bias_last=False,
                         coord_head_last=True, dtype=dtype,
                         generator=generator)
        self.tanh = tanh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x).to(torch.float32)
        return torch.tanh(x) if self.tanh else x


class HoistedEdgeMLP(nn.Module):
    """phi_e with its first Dense evaluated on the node axis.

    The first layer is linear and gathering commutes with a linear map, so

        concat([h_row, h_col, s]) @ W
            == gather_row(h @ W[:H]) + gather_col(h @ W[H:2H]) + s @ W[2H:]

    — the same math as MLP([H, H], act_last=True) on the concat, with the
    big product over N node rows instead of E edge rows and no [E, 2H+S]
    concat. Parameters: one ``kernel`` [2H+S, H] and ``bias`` [H] in the JAX
    package's [in, out] orientation, drawn at the full fan-in, then
    ``dense`` (the second Dense, H -> H). ``ops`` is the EdgeOps dispatch.
    """

    def __init__(self, hidden_nf: int, scalar_nf: int, *,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        H, fan_in = hidden_nf, 2 * hidden_nf + scalar_nf
        self.hidden_nf = H
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty((fan_in, H)))
        self.bias = nn.Parameter(torch.empty((H,)))
        uniform_(self.kernel, 1.0 / math.sqrt(fan_in), generator)
        uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)
        self.dense = TorchDense(H, H, dtype=dtype, generator=generator)

    def forward(self, h: torch.Tensor, scalars: torch.Tensor,
                ops) -> torch.Tensor:
        H, dt = self.hidden_nf, self.dtype
        w, b = self.kernel, self.bias
        if dt is not None:
            h, scalars, w, b = (a.to(dt) for a in (h, scalars, w, b))
        y = (ops.gather_rows(h @ w[:H]) + ops.gather_cols(h @ w[H:2 * H])
             + scalars @ w[2 * H:] + b)
        y = y * torch.sigmoid(y)
        y = self.dense(y)
        return y * torch.sigmoid(y)


def gather_nodes(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched node gather: data [B, N, F], idx [B, E] -> [B, E, F]."""
    return torch.gather(
        data, 1, idx.long()[..., None].expand(-1, -1, data.shape[-1]))
