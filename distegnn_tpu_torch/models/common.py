"""Shared building blocks (port of ``distegnn_tpu/models/common.py``).

Init parity with torch ``nn.Linear`` defaults, as in the JAX package:
weights and biases U(+-1/sqrt(fan_in)); coordinate heads xavier_uniform with
gain 1e-3 and no bias. Parameters are f32; ``dtype`` is the COMPUTE dtype
(inputs and parameters are cast to it, the product and the bias add are
rounded to it separately, as flax's ``nn.Dense(dtype=...)`` rounds them).

``tensor_axis`` (the ``tensor`` axis of the mesh, parallel/mesh.py) splits
the hidden width of ``MLP``, ``CoordMLP`` and ``HoistedEdgeMLP`` over the
tensor ranks as the JAX package does: the parameters stay full and
replicated, and each rank computes with its 1/T slice of them
(parallel/collectives.py ``tp_*``), so the ``state_dict`` is the same with
and without the axis.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from distegnn_tpu_torch.parallel.collectives import (tp_copy, tp_gather,
                                                     tp_reduce, tp_slice,
                                                     tp_slice_rows)


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


def coord_head_init(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator=None) -> torch.Tensor:
    """The coordinate heads' init (the JAX package's ``coord_head_init``,
    variance scaling 1e-6 over fan_avg, uniform): xavier_uniform with gain
    1e-3, U(+-1e-3 sqrt(6 / (fan_in + fan_out)))."""
    return uniform_(t, 1e-3 * math.sqrt(6.0 / (fan_in + fan_out)),
                    generator)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def leaky(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2), the radial-field layers' activation."""
    return torch.nn.functional.leaky_relu(x, 0.2)


class TorchDense(nn.Linear):
    """``nn.Linear`` with the JAX package's TorchDense init and an optional
    compute dtype. ``coord_head=True`` selects the coordinate-head init
    (xavier_uniform, gain 1e-3)."""

    # the flax tree nests the Dense below the TorchDense (convert.py)
    FLAX_PARAM = {"weight": (("Dense_0", "kernel"), True),
                  "bias": (("Dense_0", "bias"), False)}

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, coord_head: bool = False,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        if coord_head:
            coord_head_init(self.weight, in_features, out_features,
                            generator)
        else:
            uniform_(self.weight, 1.0 / math.sqrt(in_features), generator)
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
    """Dense(+act) stack (silu by default); optionally ``act`` after the
    last layer too.

    ``tensor_axis`` (2-layer MLPs only): the first Dense is column-parallel
    (each tensor rank computes its contiguous 1/T slice of the hidden
    width), the activation runs on the slice, and the second Dense is
    row-parallel. ``tensor_out='reduce'`` closes with one sum over the axis;
    ``'partial'`` returns the rank's partial sum, for a linear consumer that
    defers the sum (phi_x's aggregation)."""

    FLAX_LIST = {"layers": "TorchDense_{}"}

    def __init__(self, fan_in: int, sizes: Sequence[int], *,
                 act_last: bool = False, use_bias_last: bool = True,
                 coord_head_last: bool = False, act: Callable = silu,
                 dtype: Optional[torch.dtype] = None, generator=None,
                 tensor_axis: Optional[str] = None,
                 tensor_out: str = "reduce"):
        super().__init__()
        if tensor_axis is not None:
            if len(sizes) != 2:
                raise ValueError(
                    f"tensor-parallel MLP supports exactly 2 dense layers, "
                    f"got sizes={list(sizes)}")
            if tensor_out not in ("reduce", "partial"):
                raise ValueError(f"unknown tensor_out {tensor_out!r}")
            if tensor_out == "partial" and use_bias_last:
                raise ValueError(
                    "tensor_out='partial' requires use_bias_last=False (a "
                    "bias on a partial sum would be counted T times)")
        self.tensor_axis, self.tensor_out = tensor_axis, tensor_out
        self.dtype = dtype
        self.act = act
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
        if self.tensor_axis is not None:
            return self._tp_forward(x)
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1 or self.act_last:
                x = self.act(x)
        return x

    def _tp_forward(self, x: torch.Tensor) -> torch.Tensor:
        ax = self.tensor_axis
        d0, d1 = self.layers
        c = (lambda a: a.to(self.dtype)) if self.dtype is not None else \
            (lambda a: a)
        # column-parallel first Dense: this rank's columns of the [in, out]
        # kernel; the activation is elementwise, so the slice stays exact
        h = self.act(tp_copy(c(x), ax) @ tp_slice(c(d0.weight).t(), ax)
                     + tp_slice(c(d0.bias), ax))
        # row-parallel second Dense: the rank's partial contraction
        y = h @ tp_slice_rows(c(d1.weight).t(), ax)
        if self.tensor_out == "partial":
            return y
        y = tp_reduce(y, ax)
        if d1.bias is not None:
            y = y + c(d1.bias)
        return self.act(y) if self.act_last else y


class CoordMLP(MLP):
    """Dense(H) -> silu -> Dense(1, no bias, coordinate-head init)
    [-> tanh]. The scalar feeds geometry, so it is returned in f32."""

    FLAX_PREFIX = ("MLP_0",)

    def __init__(self, fan_in: int, hidden_nf: int, *, tanh: bool = False,
                 dtype: Optional[torch.dtype] = None, generator=None,
                 tensor_axis: Optional[str] = None):
        # under the tensor axis the head returns the rank's PARTIAL scalar:
        # the caller multiplies it into coord_diff and sums it to the node
        # axis, all linear, and closes with one sum there; tanh is not
        # linear in the partial sum
        if tensor_axis is not None and tanh:
            raise ValueError(
                "CoordMLP: tanh=True cannot be tensor-parallel (the psum is "
                "deferred through linear ops only) — use tanh=False or T=1")
        super().__init__(fan_in, [hidden_nf, 1], use_bias_last=False,
                         coord_head_last=True, dtype=dtype,
                         generator=generator, tensor_axis=tensor_axis,
                         tensor_out="partial")
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

    ``tensor_axis``: only the two node-axis products (h @ W[:H], h @ W[H:2H],
    the dominant cost) are column-sliced, and one node-level all-gather a
    product restores the full width before the per-edge work, which stays
    replicated. Column slices and a tiled gather are exact.
    """

    FLAX_CHILD = {"dense": ("TorchDense_0",)}

    def __init__(self, hidden_nf: int, scalar_nf: int, *,
                 dtype: Optional[torch.dtype] = None, generator=None,
                 tensor_axis: Optional[str] = None):
        super().__init__()
        H, fan_in = hidden_nf, 2 * hidden_nf + scalar_nf
        self.hidden_nf = H
        self.tensor_axis = tensor_axis
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty((fan_in, H)))
        self.bias = nn.Parameter(torch.empty((H,)))
        uniform_(self.kernel, 1.0 / math.sqrt(fan_in), generator)
        uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)
        self.dense = TorchDense(H, H, dtype=dtype, generator=generator)

    def forward(self, h: torch.Tensor, scalars: torch.Tensor,
                ops) -> torch.Tensor:
        ax, H = self.tensor_axis, self.hidden_nf
        if ax is not None:
            h, scalars, w, b = ((a.to(self.dtype) for a in (
                h, scalars, self.kernel, self.bias)) if self.dtype is not None
                else (h, scalars, self.kernel, self.bias))
            hin = tp_copy(h, ax)
            hr = tp_gather(hin @ tp_slice(w[:H], ax), ax)
            hc = tp_gather(hin @ tp_slice(w[H:2 * H], ax), ax)
            y = silu(ops.gather_rows(hr) + ops.gather_cols(hc)
                     + scalars @ w[2 * H:] + b)
        else:
            y = silu(hoisted_linear(self.kernel, self.bias, h, scalars, ops,
                                    H, scalars_first=False,
                                    dtype=self.dtype))
        return silu(self.dense(y))


def hoisted_linear(w, b, h, scalars, ops, hidden: int, scalars_first: bool,
                   dtype=None) -> torch.Tensor:
    """A concat-Dense over (h_row, h_col, scalars), in either concat order,
    with its matmuls on the node axis (gathering commutes with a linear
    map). ``w`` is [2H+S, out] in the JAX package's orientation."""
    if dtype is not None:
        h, scalars, w, b = (a.to(dtype) for a in (h, scalars, w, b))
    H = hidden
    S = w.shape[0] - 2 * H
    if scalars_first:
        ws, wr, wc = w[:S], w[S:S + H], w[S + H:]
    else:
        wr, wc, ws = w[:H], w[H:2 * H], w[2 * H:]
    return (ops.gather_rows(h @ wr) + ops.gather_cols(h @ wc)
            + scalars @ ws + b)


class HoistedGate(nn.Module):
    """One Dense over concat([scalars, h_row, h_col]) evaluated on the node
    axis (the algebra of :class:`HoistedEdgeMLP`, scalars first, no
    activation): FastSchNet's coordinate gate. ``kernel`` [S+2H, out] and
    ``bias`` drawn with the torch nn.Linear bounds at the full fan-in."""

    def __init__(self, features: int, scalar_nf: int, hidden_nf: int, *,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        fan_in = scalar_nf + 2 * hidden_nf
        self.hidden_nf, self.dtype = hidden_nf, dtype
        self.kernel = nn.Parameter(torch.empty((fan_in, features)))
        self.bias = nn.Parameter(torch.empty((features,)))
        uniform_(self.kernel, 1.0 / math.sqrt(fan_in), generator)
        uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)

    def forward(self, h, scalars, ops) -> torch.Tensor:
        return hoisted_linear(self.kernel, self.bias, h, scalars, ops,
                              self.hidden_nf, scalars_first=True,
                              dtype=self.dtype)


class Dense(nn.Linear):
    """A bare flax ``nn.Dense`` (no TorchDense wrapper in the JAX tree):
    ``init`` 'xavier' (xavier_uniform) or 'kaiming' (flax's he_uniform,
    U(+-sqrt(6 / fan_in))); the bias starts at zero."""

    FLAX_PARAM = {"weight": (("kernel",), True)}

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, init: str = "xavier",
                 generator=None):
        super().__init__(in_features, out_features, bias=bias)
        bound = {"xavier": math.sqrt(6.0 / (in_features + out_features)),
                 "kaiming": math.sqrt(6.0 / in_features)}[init]
        uniform_(self.weight, bound, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6 and its
    one-pass variance, max(E[x^2] - E[x]^2, 0); ``weight`` is flax's
    ``scale``."""

    FLAX_PARAM = {"weight": (("scale",), False)}

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.clamp(torch.mean(x * x, dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


def gather_nodes(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched node gather: data [B, N, F], idx [B, E] -> [B, E, F]."""
    return torch.gather(
        data, 1, idx.long()[..., None].expand(-1, -1, data.shape[-1]))
