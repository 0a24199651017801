"""Charged n-body simulator with rigid constraints, the offline generator of
the n-body datasets (port of ``distegnn_tpu/data/nbody_sim.py``).

Charged particles under a softened Coulomb force, integrated with
symplectic Euler; optional rigid sticks (2 balls) and hinges (3 balls on
rigid beams to a pivot) whose constraint-preserving updates carry a rigid
body's state. ``ChargedSystem`` / :func:`simulate_trajectory` are the JAX
package's numpy code (the same draws from the caller's generator, the same
arrays bit for bit); :func:`simulate_trajectories_batched` integrates many
isolated-ball trajectories at once in torch, on the card by default.
:func:`generate_nbody_files` writes the reference's ``.npy`` layout, which
``data/nbody.py`` ``process_nbody_cutoff`` of either package reads.

The physics (the reference's): F_i = k sum_j c_i c_j (x_i - x_j) / r^3,
clipped elementwise to +-0.1 / dt; the initial spread std (n / 5)^(1/3) +
0.1; initial speeds normalised to ``vel_norm``; several Gaussian clusters
for the large-graph configurations; stick and hinge invariants checked to
1e-6 at the end of a trajectory.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

EPS = 1e-6


def _rotation_matrix(theta: float, axis: np.ndarray) -> np.ndarray:
    """Rodrigues rotation by angle theta about unit vector axis."""
    K = np.array([
        [0.0, -axis[2], axis[1]],
        [axis[2], 0.0, -axis[0]],
        [-axis[1], axis[0], 0.0],
    ])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def _proj(v: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Component of v along d."""
    return (v @ d) / (d @ d) * d


class ChargedSystem:
    """Charged balls with optional rigid sticks/hinges.

    Public state: X [n,3], V [n,3], charges [n,1], edges [n,n] (charge
    products — the n-body 'edges' arrays the pipeline loads), sticks/hinges
    (lists of dicts with "idx"/"length*" plus integrator state).
    """

    def __init__(
        self,
        rng: np.random.Generator,
        n_isolated: int = 0,
        n_stick: int = 0,
        n_hinge: int = 0,
        delta_t: float = 0.001,
        clusters: int = 1,
        box_size: Optional[float] = None,
        loc_std: float = 1.0,
        vel_norm: float = 0.5,
        interaction_strength: float = 1.0,
        charge_types=(1.0, -1.0),
    ):
        self.rng = rng
        self.delta_t = delta_t
        self.max_F = 0.1 / delta_t
        self.box_size = box_size
        self.interaction_strength = interaction_strength
        n = self.n_balls = n_isolated + 2 * n_stick + 3 * n_hinge
        self.loc_std = loc_std * (float(n) / 5.0) ** (1.0 / 3.0) + 0.1

        self.charges = rng.choice(np.asarray(charge_types, float), size=(n, 1))
        self.edges = self.charges @ self.charges.T

        # initial placement: each ball joins a random Gaussian cluster
        if clusters == 1:
            centers = np.zeros((1, 3))
        else:
            scale = 10.0 * clusters if clusters == 3 else 3.0 * clusters
            centers = rng.uniform(-scale, scale, size=(clusters, 3))
        which = rng.integers(0, clusters, size=n)
        self.X = rng.standard_normal((n, 3)) * self.loc_std + centers[which]
        V = rng.standard_normal((n, 3))
        self.V = V / np.linalg.norm(V, axis=1, keepdims=True) * vel_norm

        # constraint membership: random disjoint index groups
        perm = rng.permutation(n)
        self.isolated = perm[:n_isolated].copy()
        self.sticks: List[dict] = []
        self.hinges: List[dict] = []
        at = n_isolated
        for _ in range(n_stick):
            self.sticks.append({"idx": (int(perm[at]), int(perm[at + 1]))})
            at += 2
        for _ in range(n_hinge):
            self.hinges.append({"idx": (int(perm[at]), int(perm[at + 1]), int(perm[at + 2]))})
            at += 3

        for s in self.sticks:
            self._init_stick(s)
        for h in self.hinges:
            self._init_hinge(h)

    # -- constraint initialization: make velocities consistent with rigidity --

    def _init_stick(self, s: dict) -> None:
        i0, i1 = s["idx"]
        x0, x1 = self.X[i0], self.X[i1]
        v0, v1 = self.V[i0], self.V[i1]
        d = x1 - x0
        # both endpoints must share the along-stick velocity component
        p0, p1 = _proj(v0, d), _proj(v1, d)
        shared = 0.5 * (p0 + p1)
        v0, v1 = v0 - p0 + shared, v1 - p1 + shared
        self.V[i0], self.V[i1] = v0, v1

        xc, vc = 0.5 * (x0 + x1), 0.5 * (v0 + v1)
        r0 = x0 - xc
        s["length"] = float(np.linalg.norm(d))
        s["xc"], s["vc"] = xc, vc
        s["wc"] = np.cross(r0, v0 - vc) / (r0 @ r0)

    def _init_hinge(self, h: dict) -> None:
        i0, i1, i2 = h["idx"]
        x0, x1, x2 = self.X[i0], self.X[i1], self.X[i2]
        v0 = self.V[i0]
        d1, d2 = x1 - x0, x2 - x0
        # each arm keeps its own transverse velocity but inherits the pivot's
        # along-beam component
        v1 = _proj(v0, d1) + (self.V[i1] - _proj(self.V[i1], d1))
        v2 = _proj(v0, d2) + (self.V[i2] - _proj(self.V[i2], d2))
        self.V[i1], self.V[i2] = v1, v2
        h["length1"], h["length2"] = float(np.linalg.norm(d1)), float(np.linalg.norm(d2))
        h["w1"] = np.cross(d1, v1 - v0) / (d1 @ d1)
        h["w2"] = np.cross(d2, v2 - v0) / (d2 @ d2)

    # -- dynamics --

    def _forces(self) -> np.ndarray:
        diff = self.X[:, None, :] - self.X[None, :, :]  # x_i - x_j
        r2 = np.sum(diff * diff, axis=-1)
        np.fill_diagonal(r2, np.inf)
        k = self.interaction_strength * self.edges / np.power(r2, 1.5)
        F = np.sum(k[:, :, None] * diff, axis=1)
        return np.clip(F, -self.max_F, self.max_F)

    def step(self) -> None:
        dt = self.delta_t
        F = self._forces()

        # free balls: symplectic Euler (unit mass)
        iso = self.isolated
        if iso.size:
            self.V[iso] += F[iso] * dt
            self.X[iso] += self.V[iso] * dt

        for s in self.sticks:
            self._step_stick(s, F, dt)
        for h in self.hinges:
            self._step_hinge(h, F, dt)

    def _step_stick(self, s: dict, F: np.ndarray, dt: float) -> None:
        i0, i1 = s["idx"]
        f0, f1 = F[i0], F[i1]
        xc, vc, wc = s["xc"], s["vc"], s["wc"]
        r0, r1 = self.X[i0] - xc, self.X[i1] - xc

        vc = vc + 0.5 * (f0 + f1) * dt
        xc = xc + vc * dt

        # torque about the COM drives the angular velocity
        J = r0 @ r0 + r1 @ r1
        wc = wc + (np.cross(r0, f0) + np.cross(r1, f1)) / J * dt

        w = float(np.linalg.norm(wc))
        if w > 1e-12:
            R = _rotation_matrix(w * dt, wc / w)
            r0, r1 = R @ r0, R @ r1
        self.X[i0], self.X[i1] = xc + r0, xc + r1
        self.V[i0], self.V[i1] = vc + np.cross(wc, r0), vc + np.cross(wc, r1)
        s["xc"], s["vc"], s["wc"] = xc, vc, wc

    def _step_hinge(self, h: dict, F: np.ndarray, dt: float) -> None:
        i0, i1, i2 = h["idx"]
        x0, x1, x2 = self.X[i0], self.X[i1], self.X[i2]
        v0, v1, v2 = self.V[i0], self.V[i1], self.V[i2]
        f0, f1, f2 = F[i0], F[i1], F[i2]
        w1, w2 = h["w1"], h["w2"]
        r01, r02 = x1 - x0, x2 - x0
        e1 = np.outer(r01, r01) / (r01 @ r01)
        e2 = np.outer(r02, r02) / (r02 @ r02)

        # pivot acceleration from the rigid-beam constraint solve
        A = np.eye(3) + e1 + e2
        rhs = (
            (f0 + f1 + f2)
            - np.cross(w1, v1 - v0)
            - np.cross(w2, v2 - v0)
            - (np.eye(3) - e1) @ f1
            - (np.eye(3) - e2) @ f2
        )
        a0 = np.linalg.solve(A, rhs)

        v0 = v0 + a0 * dt
        x0 = x0 + v0 * dt

        w1 = w1 + np.cross(r01, f1 - a0) / (r01 @ r01) * dt
        w2 = w2 + np.cross(r02, f2 - a0) / (r02 @ r02) * dt

        for (i, r, w) in ((i1, r01, w1), (i2, r02, w2)):
            wn = float(np.linalg.norm(w))
            rr = _rotation_matrix(wn * dt, w / wn) @ r if wn > 1e-12 else r
            self.X[i] = x0 + rr
            self.V[i] = v0 + np.cross(w, rr)
        self.X[i0], self.V[i0] = x0, v0
        h["w1"], h["w2"] = w1, w2

    # -- invariants (reference physical_objects.py check() methods) --

    def check(self) -> None:
        for s in self.sticks:
            i0, i1 = s["idx"]
            d = self.X[i1] - self.X[i0]
            assert abs(np.linalg.norm(d) - s["length"]) < EPS, "stick length drifted"
            p0, p1 = _proj(self.V[i0], d), _proj(self.V[i1], d)
            assert np.sum(np.abs(p0 - p1)) < EPS, "stick endpoints shear apart"
        for h in self.hinges:
            i0, i1, i2 = h["idx"]
            for i, key in ((i1, "length1"), (i2, "length2")):
                d = self.X[i] - self.X[i0]
                assert abs(np.linalg.norm(d) - h[key]) < EPS, "hinge beam length drifted"
                p0, pi = _proj(self.V[i0], d), _proj(self.V[i], d)
                assert np.sum(np.abs(p0 - pi)) < EPS, "hinge beam shears apart"

    def is_valid(self) -> bool:
        if self.box_size is None:
            return True
        return bool(np.all(np.abs(self.X) <= self.box_size))


def simulate_trajectory(
    rng: np.random.Generator,
    length: int,
    sample_freq: int,
    n_isolated: int = 0,
    n_stick: int = 0,
    n_hinge: int = 0,
    clusters: int = 1,
    delta_t: float = 0.001,
    box_size: Optional[float] = None,
):
    """One trajectory, sampled every ``sample_freq`` steps (reference
    generate_dataset.py:55-70). Returns (loc [T,N,3], vel [T,N,3],
    charges [N,1], edges [N,N]); regenerates on box escape."""
    while True:
        sys_ = ChargedSystem(
            rng, n_isolated=n_isolated, n_stick=n_stick, n_hinge=n_hinge,
            clusters=clusters, delta_t=delta_t, box_size=box_size,
        )
        loc, vel = [], []
        for t in range(length):
            sys_.step()
            if t % sample_freq == 0:
                loc.append(sys_.X.copy())
                vel.append(sys_.V.copy())
        sys_.check()
        if sys_.is_valid():
            return np.asarray(loc), np.asarray(vel), sys_.charges.copy(), sys_.edges.copy()


def simulate_trajectories_batched(
    rng: np.random.Generator,
    num: int,
    length: int,
    sample_freq: int,
    n_isolated: int,
    clusters: int = 1,
    delta_t: float = 0.001,
    loc_std: float = 1.0,
    vel_norm: float = 0.5,
    interaction_strength: float = 1.0,
    charge_types=(1.0, -1.0),
    dtype: str = "float64",
    device=None,
):
    """``num`` isolated-ball trajectories integrated at once in torch on
    ``device`` (default the card; ``'cpu'`` on the host).

    The physics of ``ChargedSystem``; samples at t % sample_freq == 0 of the
    reference's step loop: one step, a sample, then (sample_freq steps, a
    sample) x (T - 1). The initial state is drawn from ``rng`` in the JAX
    package's order (so charges and edges are its bit for bit), in another
    order than the serial path's. ``dtype`` 'float64' (the serial path's
    precision) or 'float32' (half the memory; 5000 chaotic steps then
    diverge pointwise from f64, with the same distribution). Sticks, hinges
    and ``box_size`` need the serial path.

    Returns numpy (loc [num, T, N, 3], vel [num, T, N, 3], charges
    [num, N, 1], edges [num, N, N]); loc / vel in ``dtype``.
    """
    import torch

    from distegnn_tpu_torch import resolve_device

    if dtype not in ("float64", "float32"):
        raise ValueError(f"dtype must be 'float64' or 'float32', got {dtype!r}")
    dev = resolve_device(device)
    tdt = getattr(torch, dtype)
    n = n_isolated
    T = (length + sample_freq - 1) // sample_freq
    max_F = 0.1 / delta_t
    std = loc_std * (float(n) / 5.0) ** (1.0 / 3.0) + 0.1

    charges = rng.choice(np.asarray(charge_types, float), size=(num, n, 1))
    edges = charges @ np.swapaxes(charges, 1, 2)
    if clusters == 1:
        centers = np.zeros((num, 1, 3))
    else:
        scale = 10.0 * clusters if clusters == 3 else 3.0 * clusters
        centers = rng.uniform(-scale, scale, size=(num, clusters, 3))
    which = rng.integers(0, clusters, size=(num, n))
    X0 = rng.standard_normal((num, n, 3)) * std + np.take_along_axis(
        centers, which[:, :, None], axis=1)
    V0 = rng.standard_normal((num, n, 3))
    V0 = V0 / np.linalg.norm(V0, axis=2, keepdims=True) * vel_norm

    X = torch.as_tensor(X0, dtype=tdt, device=dev)
    V = torch.as_tensor(V0, dtype=tdt, device=dev)
    E = torch.as_tensor(edges, dtype=tdt, device=dev)
    eye = torch.eye(n, dtype=torch.bool, device=dev)

    def step(X, V):
        diff = X[:, :, None, :] - X[:, None, :, :]
        r2 = torch.sum(diff * diff, dim=-1).masked_fill(eye, float("inf"))
        k = interaction_strength * E / torch.pow(r2, 1.5)
        F = torch.einsum("bij,bijd->bid", k, diff).clamp(-max_F, max_F)
        V = V + F * delta_t
        return X + V * delta_t, V

    loc = torch.empty((num, T, n, 3), dtype=tdt, device=dev)
    vel = torch.empty_like(loc)
    X, V = step(X, V)   # the reference samples first at t == 0, after a step
    loc[:, 0], vel[:, 0] = X, V
    for t in range(1, T):
        for _ in range(sample_freq):
            X, V = step(X, V)
        loc[:, t], vel[:, t] = X, V
    return loc.cpu().numpy(), vel.cpu().numpy(), charges, edges


def generate_nbody_files(
    path: str,
    n_isolated: int = 0,
    n_stick: int = 0,
    n_hinge: int = 0,
    clusters: int = 1,
    num_train: int = 0,
    num_valid: int = 0,
    num_test: int = 0,
    length: int = 5000,
    sample_freq: int = 100,
    seed: int = 42,
    suffix: str = "",
    box_size: Optional[float] = None,
    device=None,
) -> str:
    """Write the reference's .npy layout:
    ``{loc,vel,charges,edges}_{split}_charged{iso}_{stick}_{hinge}_{clusters}{suffix}.npy``
    with loc / vel [num, T, N, 3], charges [num, N, 1], edges [num, N, N].
    Isolated balls without a box go through the batched integrator on
    ``device`` (chunks of 512 trajectories), the rest through the serial
    one. Returns the tag (the file names' part after the split)."""
    tag = f"charged{n_isolated}_{n_stick}_{n_hinge}_{clusters}{suffix}"
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    fast = n_stick == 0 and n_hinge == 0 and box_size is None
    for split, num in (("train", num_train), ("valid", num_valid),
                       ("test", num_test)):
        if fast and num:
            chunks = [simulate_trajectories_batched(
                rng, min(512, num - at), length, sample_freq,
                n_isolated=n_isolated, clusters=clusters, device=device)
                for at in range(0, num, 512)]
            locs, vels, chgs, edgs = (np.concatenate(a) for a in zip(*chunks))
        else:
            runs = [simulate_trajectory(
                rng, length, sample_freq, n_isolated=n_isolated,
                n_stick=n_stick, n_hinge=n_hinge, clusters=clusters,
                box_size=box_size) for _ in range(num)]
            locs, vels, chgs, edgs = (np.asarray(a) for a in zip(*runs)) \
                if runs else (np.asarray([]),) * 4
        np.save(os.path.join(path, f"loc_{split}_{tag}.npy"), locs)
        np.save(os.path.join(path, f"vel_{split}_{tag}.npy"), vels)
        np.save(os.path.join(path, f"charges_{split}_{tag}.npy"), chgs)
        np.save(os.path.join(path, f"edges_{split}_{tag}.npy"), edgs)
    return tag
