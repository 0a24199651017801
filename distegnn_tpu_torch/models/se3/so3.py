"""SO(3) representation math (port of ``distegnn_tpu/models/se3/so3.py``):
host-side numpy float64, the port's own copy.

Real spherical harmonics, real Wigner-D matrices, and the Q_J
change-of-basis matrices solved from the equivariance constraint. The real
Wigner-D for degree l is DEFINED by the identity Y_l(R v) = D_l(R) Y_l(v) and
recovered from our own spherical harmonics by least squares over generic
sample directions (float64, residual ~1e-12); any consistent real irrep basis
gives a valid equivariant kernel basis, and basis.py evaluates the SAME
formulas in torch at run time.

The Q_J are a few tiny SVDs, cached in-process. Each is unique up to sign;
the generic rotations of the constraint are drawn exactly as the JAX
package draws them (scipy's ``Rotation.random``: normal quaternions from a
``RandomState``, scalar last), so the SVD picks the same sign and a JAX
checkpoint's TFN weights mean the same kernels here.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


# --------------------------------------------------------------------------
# Real (tesseral) spherical harmonics — generic l, module-agnostic (numpy/torch)
# --------------------------------------------------------------------------

def _double_factorial(n: int) -> float:
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


def real_sph_harm(l: int, xyz, xp=np, eps: float = 1e-12):
    """Real spherical harmonics Y_l of unit(xyz), shape [..., 2l+1], m=-l..l.

    Tesseral convention without Condon-Shortley phase:
      m>0: sqrt(2) K_lm cos(m phi) P_l^m(cos theta)
      m=0: K_l0 P_l(cos theta)
      m<0: sqrt(2) K_l|m| sin(|m| phi) P_l^|m|(cos theta)
    Evaluated entirely from cartesian components (no trig of angles), with
    the array module ``xp`` (numpy here; basis.py passes a torch shim).
    Zero vectors map to the
    north-pole value (guarded), which padded edges then mask away.
    """
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = xp.sqrt(x * x + y * y + z * z)
    r = xp.maximum(r, eps)
    ct = z / r                       # cos(theta)
    rxy = xp.sqrt(x * x + y * y)
    safe_rxy = xp.maximum(rxy, eps)
    cphi = xp.where(rxy > eps, x / safe_rxy, xp.ones_like(x))
    sphi = xp.where(rxy > eps, y / safe_rxy, xp.zeros_like(y))
    st = rxy / r                     # sin(theta) >= 0

    # associated Legendre P_l^m(ct) with sin(theta) factors, no CS phase
    # P[m] holds P_l^m for the target l, built by the standard recursions
    P = {}
    for m in range(l + 1):
        pmm = _double_factorial(2 * m - 1) * st**m if m > 0 else xp.ones_like(ct)
        if l == m:
            P[m] = pmm
            continue
        pmm1 = (2 * m + 1) * ct * pmm
        if l == m + 1:
            P[m] = pmm1
            continue
        p_prev, p_curr = pmm, pmm1
        for ll in range(m + 2, l + 1):
            p_next = ((2 * ll - 1) * ct * p_curr - (ll + m - 1) * p_prev) / (ll - m)
            p_prev, p_curr = p_curr, p_next
        P[m] = p_curr

    # cos(m phi), sin(m phi) by Chebyshev recurrence
    cos_m = [xp.ones_like(cphi), cphi]
    sin_m = [xp.zeros_like(sphi), sphi]
    for m in range(2, l + 1):
        cos_m.append(2 * cphi * cos_m[-1] - cos_m[-2])
        sin_m.append(2 * cphi * sin_m[-1] - sin_m[-2])

    import math

    comps = []
    for m in range(-l, l + 1):
        am = abs(m)
        K = math.sqrt((2 * l + 1) / (4 * math.pi)
                      * math.factorial(l - am) / math.factorial(l + am))
        if m > 0:
            comps.append(math.sqrt(2.0) * K * cos_m[am] * P[am])
        elif m == 0:
            comps.append(K * P[0])
        else:
            comps.append(math.sqrt(2.0) * K * sin_m[am] * P[am])
    return xp.stack(comps, axis=-1)


# --------------------------------------------------------------------------
# Real Wigner-D from the transform identity (host only)
# --------------------------------------------------------------------------

def wigner_d_real(l: int, R: np.ndarray) -> np.ndarray:
    """D_l(R) [2l+1, 2l+1] with Y_l(R v) = D_l(R) Y_l(v), solved from our Y
    by least squares over generic directions (float64, exact to ~1e-12)."""
    if l == 0:
        return np.ones((1, 1))
    rng = np.random.default_rng(12345 + l)
    v = rng.normal(size=(4 * (2 * l + 1), 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    A = real_sph_harm(l, v).T                    # [2l+1, n]
    B = real_sph_harm(l, v @ R.T).T              # [2l+1, n]
    D, *_ = np.linalg.lstsq(A.T, B.T, rcond=None)
    return D.T


def _random_rotations(n: int, seed: int = 7) -> list:
    """``scipy.spatial.transform.Rotation.random(n, random_state=seed)
    .as_matrix()`` in numpy, bit for bit (scipy's own product order): unit
    quaternions (x, y, z, w) from normal draws of ``RandomState(seed)``.
    The Q_J's signs follow from these bits."""
    q = np.random.RandomState(seed).normal(size=(n, 4))
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    x2, y2, z2, w2 = x * x, y * y, z * z, w * w
    xy, zw, xz, yw, yz, xw = x * y, z * w, x * z, y * w, y * z, x * w
    R = np.empty((n, 3, 3))
    R[:, 0, 0], R[:, 1, 0], R[:, 2, 0] = (x2 - y2 - z2 + w2, 2 * (xy + zw),
                                          2 * (xz - yw))
    R[:, 0, 1], R[:, 1, 1], R[:, 2, 1] = (2 * (xy - zw), -x2 + y2 - z2 + w2,
                                          2 * (yz + xw))
    R[:, 0, 2], R[:, 1, 2], R[:, 2, 2] = (2 * (xz + yw), 2 * (yz - xw),
                                          -x2 - y2 + z2 + w2)
    return list(R)


@lru_cache(maxsize=None)
def basis_transformation_Q_J(J: int, order_in: int, order_out: int) -> np.ndarray:
    """Q_J [(2 order_out+1)(2 order_in+1), 2J+1]: the unique (up to scale)
    intertwiner with (D_out x D_in)(R) Q_J = Q_J D_J(R) — solved as the common
    null space of Sylvester constraints at generic rotations (reference
    _basis_transformation_Q_J, utils_steerable.py:35-68)."""
    mats = []
    for R in _random_rotations(5):
        D_t = np.kron(wigner_d_real(order_out, R), wigner_d_real(order_in, R))
        D_J = wigner_d_real(J, R)
        mats.append(np.kron(D_t, np.eye(2 * J + 1))
                    - np.kron(np.eye(D_t.shape[0]), D_J.T))
    A = np.concatenate(mats, axis=0)
    _, s, vh = np.linalg.svd(A)
    null = vh[s.size - np.sum(s < 1e-8):] if np.sum(s < 1e-8) else vh[-1:]
    assert null.shape[0] == 1, f"non-unique intertwiner space: {null.shape}"
    Q = null[0].reshape((2 * order_out + 1) * (2 * order_in + 1), 2 * J + 1)

    # verify on fresh rotations
    for R in _random_rotations(3, seed=99):
        D_t = np.kron(wigner_d_real(order_out, R), wigner_d_real(order_in, R))
        assert np.allclose(D_t @ Q, Q @ wigner_d_real(J, R), atol=1e-8)
    return Q


def q_matrices(max_degree: int):
    """All Q_J needed up to max_degree: dict[(d_in, d_out)] -> float32 array
    [num_freq(=2 min+1), 2J+1 varies] stacked per-J list."""
    out = {}
    for d_in in range(max_degree + 1):
        for d_out in range(max_degree + 1):
            out[(d_in, d_out)] = [
                basis_transformation_Q_J(J, d_in, d_out).astype(np.float32)
                for J in range(abs(d_in - d_out), d_in + d_out + 1)
            ]
    return out
