"""SO(3) rotation helpers (port of ``distegnn_tpu/utils/rotate.py``): the
Euler rotation matrices ``rotx`` / ``roty`` / ``rotz`` and the uniform-angle
``random_rotate`` / ``random_rotate_y`` of the protein pipeline's
``test_rot`` split and the equivariance checks, in numpy (f64), drawing from
the caller's generator in the JAX package's order."""

from __future__ import annotations

import numpy as np


def rotx(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def roty(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def rotz(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def random_rotate(rng: np.random.Generator | None = None) -> np.ndarray:
    """``rotx(a) @ roty(b) @ rotz(c)`` for three angles drawn uniformly from
    [0, 2 pi) (not Haar-uniform; enough for equivariance checks)."""
    rng = rng or np.random.default_rng()
    a, b, c = rng.uniform(0, 2 * np.pi, size=3)
    return rotx(a) @ roty(b) @ rotz(c)


def random_rotate_y(rng: np.random.Generator | None = None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    return roty(rng.uniform(0, 2 * np.pi))
