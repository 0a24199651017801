"""The port's partitioners and distribute-mode preprocessing against the
JAX package's, exactly: ``split_graph`` for every split mode with and
without the work-balance pass (each part's arrays), the balance pass's
ratios, and the shard files of ``process_nbody_distribute`` and
``process_large_fluid_distribute`` (Fluid113K sims written by both
packages' ``write_fluid_sim``, which write the same bytes)."""

import torch_threads  # noqa: F401  (first: one torch thread)
import os
import pickle

import numpy as np
import pytest

from distegnn_tpu.data import distribute as jdist
from distegnn_tpu.data import fluid113k as jfluid
from distegnn_tpu.data import partition as jpart
from distegnn_tpu_torch.data import distribute as pdist
from distegnn_tpu_torch.data import fluid113k as pfluid
from distegnn_tpu_torch.data import partition as ppart

NPARTS, INNER, OUTER = 4, 0.3, 0.35


def _skewed_graph(seed, n=400):
    """A cloud with a dense ball: node counts balance, work does not."""
    rng = np.random.default_rng(seed)
    loc = np.concatenate([rng.uniform(0, 2, size=(n - n // 4, 3)),
                          0.5 + 0.15 * rng.normal(size=(n // 4, 3))])
    loc = loc.astype(np.float32)
    vel = rng.normal(size=loc.shape).astype(np.float32) * 0.1
    return {"node_feat": np.linalg.norm(vel, axis=1, keepdims=True),
            "node_attr": np.ones((n, 2), np.float32), "loc": loc,
            "vel": vel, "target": loc + vel,
            "loc_mean": loc.mean(axis=0),
            "edge_index": np.zeros((2, 0), np.int32),
            "edge_attr": np.zeros((0, 2), np.float32)}


def _assert_parts_equal(got, want):
    assert len(got) == len(want)
    for p, (a, b) in enumerate(zip(got, want)):
        assert a.keys() == b.keys()
        for k in a:
            if a[k] is None:
                assert b[k] is None, (p, k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{p} {k}")
                assert a[k].dtype == b[k].dtype, (p, k)


@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("method", ["random", "kmeans", "spectral", "metis"])
def test_split_graph_matches_jax(method, balance):
    g = _skewed_graph(0)
    got = ppart.split_graph(g, NPARTS, method, INNER, outer_radius=OUTER,
                            seed=3, balance=balance)
    want = jpart.split_graph(g, NPARTS, method, INNER, outer_radius=OUTER,
                             seed=3, balance=balance)
    _assert_parts_equal(got, want)
    assert sum(p["loc"].shape[0] for p in got) == g["loc"].shape[0]
    for p in got:
        np.testing.assert_array_equal(p["loc_mean"],
                                      g["loc"].mean(axis=0).astype(np.float32))


def test_balance_pass_matches_jax_and_rebalances():
    g = _skewed_graph(1)
    labels = ppart.assign_partitions(g["loc"], NPARTS, "kmeans", seed=0)
    got = ppart.balance_partitions(g["loc"], labels, NPARTS, INNER)
    want = jpart.balance_partitions(g["loc"], labels, NPARTS, INNER)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == pytest.approx(want[1:], rel=0, abs=0)
    assert got[2] < got[1] and got[1] > 1.15
    work = ppart.node_work(g["loc"], INNER)
    np.testing.assert_array_equal(work, jpart.node_work(g["loc"], INNER))
    np.testing.assert_array_equal(
        ppart.rebalance_morton(g["loc"], work, NPARTS),
        jpart.rebalance_morton(g["loc"], work, NPARTS))


def test_metis_leaves_surplus_parts_empty_like_jax():
    """Fewer nodes than parts: some parts are empty, the same ones as in
    the JAX package (a rank of such a split still joins every collective:
    tests/test_torch_distributed.py)."""
    g = _skewed_graph(2, n=12)
    got = ppart.split_graph(g, 16, "metis", INNER, outer_radius=OUTER)
    want = jpart.split_graph(g, 16, "metis", INNER, outer_radius=OUTER)
    _assert_parts_equal(got, want)
    assert min(p["loc"].shape[0] for p in got) == 0


def _load(paths):
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(pickle.load(f))
    return out


def _assert_shards_equal(got_paths, want_paths):
    assert [os.path.basename(p) for p in got_paths] == \
        [os.path.basename(p) for p in want_paths]
    for a, b in zip(_load(got_paths), _load(want_paths)):
        assert len(a) == len(b)
        for ga, gb in zip(a, b):
            _assert_parts_equal([ga], [gb])


def test_process_nbody_distribute_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    for root in ("p", "j"):
        base = tmp_path / root / "nbody_t"
        os.makedirs(base)
    for split, s in (("train", 3), ("valid", 2), ("test", 2)):
        loc = rng.normal(size=(s, 10, 30, 3)).astype(np.float32)
        vel = rng.normal(size=loc.shape).astype(np.float32) * 0.1
        q = rng.choice([-1.0, 1.0], size=(s, 30, 1)).astype(np.float32)
        for root in ("p", "j"):
            base = tmp_path / root / "nbody_t"
            np.save(base / f"loc_{split}_t.npy", loc)
            np.save(base / f"vel_{split}_t.npy", vel)
            np.save(base / f"charges_{split}_t.npy", q)
    args = ("nbody_t", NPARTS, 10, 1.2, 1.5, "metis", 2, 8)
    got = pdist.process_nbody_distribute(str(tmp_path / "p"), *args, seed=5)
    want = jdist.process_nbody_distribute(str(tmp_path / "j"), *args, seed=5)
    for g, w in zip(got, want):
        _assert_shards_equal(g, w)
    # a second call finds the files and rewrites nothing
    mtimes = [os.stat(p).st_mtime_ns for ps in got for p in ps]
    again = pdist.process_nbody_distribute(str(tmp_path / "p"), *args, seed=5)
    assert again == got
    assert [os.stat(p).st_mtime_ns for ps in got for p in ps] == mtimes


def _sim(rng, T=20, n=300):
    pos = np.cumsum(rng.normal(size=(T, n, 3)) * 0.01, axis=0) + \
        rng.uniform(0, 1, size=(1, n, 3))
    vel = rng.normal(size=(T, n, 3))
    return (pos.astype(np.float32), vel.astype(np.float32),
            np.full(n, 0.3, np.float32), np.full(n, 1.2, np.float32))


def test_process_large_fluid_distribute_matches_jax(tmp_path):
    """Sims 1 / 101 / 121 (the first of each split) written by each
    package's writer (the same bytes), read back equal, then partitioned
    into the same shard files."""
    rng = np.random.default_rng(6)
    for idx in (1, 101, 121):
        sim = _sim(rng)
        pfluid.write_fluid_sim(str(tmp_path / "p"), "Fluid113K", idx, *sim)
        jfluid.write_fluid_sim(str(tmp_path / "j"), "Fluid113K", idx, *sim)
        for s in range(pfluid.SHARDS_PER_SIM):
            name = f"sim_{idx:04d}_{s:02d}.msgpack.zst"
            with open(tmp_path / "p" / "Fluid113K" / name, "rb") as f:
                a = f.read()
            with open(tmp_path / "j" / "Fluid113K" / name, "rb") as f:
                assert a == f.read(), name
        got = pfluid.read_sim(str(tmp_path / "p"), "Fluid113K", idx)
        want = jfluid.read_sim(str(tmp_path / "j"), "Fluid113K", idx)
        for a, b, c in zip(got, want, sim):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    args = ("Fluid113K", NPARTS, 4, 0.15, 0.15, "metis", 3)
    got = pfluid.process_large_fluid_distribute(str(tmp_path / "p"), *args,
                                                seed=7)
    want = jfluid.process_large_fluid_distribute(str(tmp_path / "j"), *args,
                                                 seed=7)
    for g, w in zip(got, want):
        _assert_shards_equal(g, w)
    assert len(_load(got[0])[0]) == 4
