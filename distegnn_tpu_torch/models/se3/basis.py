"""The equivariant kernel basis at run time (port of
``distegnn_tpu/models/se3/basis.py``).

For every (d_in, d_out) degree pair the bases K_J(d) = Y_J(d) @ Q_J^T: the
spherical harmonics are so3.real_sph_harm evaluated in torch (the SAME
formulas as the host solver), the Q_J f32 constants solved once in numpy and
cached; the basis carries no gradient (as the JAX package's stop_gradient).
"""

from __future__ import annotations

import types
from typing import Dict, Tuple

import torch

from distegnn_tpu_torch.models.se3.so3 import q_matrices, real_sph_harm

# the array-module calls of real_sph_harm, in torch
_TORCH_XP = types.SimpleNamespace(
    sqrt=torch.sqrt, where=torch.where, ones_like=torch.ones_like,
    zeros_like=torch.zeros_like,
    maximum=lambda a, b: torch.clamp(a, min=b),
    stack=lambda xs, axis: torch.stack(xs, dim=axis))

# cart_to_deg1 / deg1_to_cart: our l=1 real harmonics are sqrt(3/4pi) *
# (y, z, x)/r (m = -1, 0, 1), so a cartesian vector enters the
# representation basis by the (y, z, x) permutation
_TO_DEG1, _TO_CART = [1, 2, 0], [2, 0, 1]


def cart_to_deg1(v: torch.Tensor) -> torch.Tensor:
    """Cartesian vector -> degree-1 irrep component order."""
    return v[..., _TO_DEG1]


def deg1_to_cart(f: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`cart_to_deg1`."""
    return f[..., _TO_CART]


_Q_CACHE: Dict[Tuple[int, str], dict] = {}


def _q_tensors(max_degree: int, device: torch.device) -> dict:
    key = (max_degree, str(device))
    if key not in _Q_CACHE:
        _Q_CACHE[key] = {pair: [torch.from_numpy(q).to(device) for q in qs]
                         for pair, qs in q_matrices(max_degree).items()}
    return _Q_CACHE[key]


def safe_norm(d2: torch.Tensor) -> torch.Tensor:
    """sqrt(d2) with a zero gradient where d2 == 0 (a padded edge's zero
    length): the plain square root's gradient there is 0 * inf = NaN."""
    pos = d2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2,
                                                   torch.ones_like(d2))),
                       torch.zeros_like(d2))


def compute_basis_and_r(rel_pos: torch.Tensor, max_degree: int
                        ) -> Tuple[Dict[Tuple[int, int], torch.Tensor],
                                   torch.Tensor]:
    """rel_pos [B, E, 3] (x_dst - x_src, padded edges may be zero) ->
      basis dict[(d_in, d_out)] -> [B, E, 2 d_out+1, 2 d_in+1, num_freq]
      r [B, E, 1] distances.

    Padded zero edges give the guarded north-pole harmonic value, masked
    out downstream. ``r`` takes its square root through :func:`safe_norm`:
    the same values as the JAX package's plain one, whose gradient at a
    padded edge is NaN (it reaches the parameters when the positions depend
    on them, as in FastTFN's layers after the first)."""
    with torch.no_grad():
        Y = {l: real_sph_harm(l, rel_pos, xp=_TORCH_XP)
             for l in range(2 * max_degree + 1)}
        basis = {}
        for (d_in, d_out), q_js in _q_tensors(max_degree,
                                              rel_pos.device).items():
            k_js = []
            for J, q_j in zip(range(abs(d_in - d_out), d_in + d_out + 1),
                              q_js):
                k_j = torch.einsum("bej,mj->bem", Y[J], q_j)
                k_js.append(k_j.reshape(k_j.shape[:2]
                                        + (2 * d_out + 1, 2 * d_in + 1)))
            basis[(d_in, d_out)] = torch.stack(k_js, dim=-1)
    r = safe_norm(torch.sum(rel_pos ** 2, dim=-1, keepdim=True))
    return basis, r
