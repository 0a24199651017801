"""The port's n-body generator against the JAX package's on the CPU.

``generate_nbody_files`` at a tiny size in both packages. The stick / hinge
path is the same numpy code on the same draws: every ``.npy`` file is
bitwise equal. The batched path draws the same initial state (charges and
edges bitwise equal); its integration is XLA's in JAX and torch's in the
port: XLA's CPU backend contracts each multiply-add into one FMA (the
squared distance is ``fma(dz, dz, fma(dy, dy, dx * dx))``) and vectorises
``pow(r2, -1.5)``, where torch rounds every product, so the trajectories
agree to the last bits (1.1e-16 of their scale after 60 steps on this
test's draw) and are held to 1e-14. The files feed ``process_nbody_cutoff``
of both packages alike.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os

import numpy as np
import pytest

from distegnn_tpu.data import nbody as jnbody
from distegnn_tpu.data import nbody_sim as jsim
from distegnn_tpu_torch.data import nbody as pnbody
from distegnn_tpu_torch.data import nbody_sim as psim

KINDS = ("loc", "vel", "charges", "edges")
SPLITS = ("train", "valid", "test")
# the batched path's trajectories, as a fraction of max |loc| / max |vel|
TOL_BATCHED = 1e-14


def files(path, tag):
    return {(k, s): os.path.join(path, f"{k}_{s}_{tag}.npy")
            for k in KINDS for s in SPLITS}


def test_stick_and_hinge_path_writes_bitwise_the_jax_files(tmp_path):
    kw = dict(n_isolated=2, n_stick=1, n_hinge=1, num_train=2, num_valid=1,
              num_test=1, length=60, sample_freq=20, seed=5)
    jtag = jsim.generate_nbody_files(str(tmp_path / "jax"), **kw)
    ptag = psim.generate_nbody_files(str(tmp_path / "port"), **kw)
    assert ptag == jtag == "charged2_1_1_1"
    jf, pf = files(str(tmp_path / "jax"), jtag), files(str(tmp_path / "port"),
                                                      ptag)
    for key in jf:
        with open(jf[key], "rb") as a, open(pf[key], "rb") as b:
            assert a.read() == b.read(), key
    loc = np.load(pf[("loc", "train")])
    assert loc.shape == (2, 3, 7, 3) and loc.dtype == np.float64


def test_charged_system_keeps_its_constraints():
    rng = np.random.default_rng(0)
    s = psim.ChargedSystem(rng, n_isolated=3, n_stick=2, n_hinge=2)
    for _ in range(50):
        s.step()
    s.check()
    assert np.isfinite(s.X).all() and s.is_valid()


def test_batched_path_matches_jax(tmp_path):
    kw = dict(n_isolated=5, num_train=3, num_valid=2, num_test=2, length=60,
              sample_freq=20, seed=7)
    jtag = jsim.generate_nbody_files(str(tmp_path / "jax"), **kw)
    ptag = psim.generate_nbody_files(str(tmp_path / "port"), device="cpu",
                                     **kw)
    assert ptag == jtag == "charged5_0_0_1"
    jf, pf = files(str(tmp_path / "jax"), jtag), files(str(tmp_path / "port"),
                                                      ptag)
    for split in SPLITS:
        for kind in ("charges", "edges"):
            a, b = np.load(jf[kind, split]), np.load(pf[kind, split])
            assert a.dtype == b.dtype and np.array_equal(a, b), (kind, split)
        for kind in ("loc", "vel"):
            a, b = np.load(jf[kind, split]), np.load(pf[kind, split])
            assert a.shape == b.shape and a.dtype == b.dtype == np.float64
            err = float(np.abs(a - b).max()) / float(np.abs(a).max())
            assert err <= TOL_BATCHED, (kind, split, err)
    # the cutoff processor of either package reads the port's files (the
    # JAX one at another cutoff rate, so that the two caches stay apart)
    base = str(tmp_path)
    os.rename(str(tmp_path / "port"), os.path.join(base, "nbody_5"))
    paths = pnbody.process_nbody_cutoff(base, "nbody_5", 10, -1.0, 0, 2, 0.0)
    jpaths = jnbody.process_nbody_cutoff(base, "nbody_5", 10, -1.0, 0, 2,
                                         0.1)
    assert len(paths) == len(jpaths) == 3 and all(map(os.path.exists, jpaths))


def test_batched_path_in_f32_and_on_the_card_by_default():
    a = psim.simulate_trajectories_batched(
        np.random.default_rng(1), 2, 40, 20, 4, dtype="float32", device="cpu")
    b = psim.simulate_trajectories_batched(
        np.random.default_rng(1), 2, 40, 20, 4, device="cpu")
    assert a[0].dtype == np.float32 and a[0].shape == (2, 2, 4, 3)
    assert np.array_equal(a[2], b[2])
    np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="dtype"):
        psim.simulate_trajectories_batched(np.random.default_rng(1), 2, 40,
                                           20, 4, dtype="bfloat16",
                                           device="cpu")
    # the entry point's device policy: the card unless the CPU is asked for
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        psim.simulate_trajectories_batched(np.random.default_rng(1), 2, 40,
                                           20, 4)
