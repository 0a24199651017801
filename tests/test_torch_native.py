"""The port's native library (distegnn_tpu_torch/native.py: native/*.cpp
built with g++ into distegnn_tpu_torch/_build/) against the JAX package's
bindings of the same sources and against the port's numpy versions, bit for
bit: the partition labels, the edge cut, the blocked edge layout and the
reverse-edge pairing. Also: where the library lands, the build's lock
across concurrent builders, and the numpy fallback without a compiler."""

import torch_threads  # noqa: F401  (first: one torch thread)
import os
import threading
import time

import numpy as np
import pytest

from distegnn_tpu import native as jnative
from distegnn_tpu.data import partition as jpartition
from distegnn_tpu.ops import blocked as jblocked
from distegnn_tpu_torch import native as pnative
from distegnn_tpu_torch.data import partition as ppartition
from distegnn_tpu_torch.ops import blocked as pblocked
from distegnn_tpu_torch.ops.build import BUILD_DIR, locked_build
from distegnn_tpu_torch.ops.radius import radius_graph_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    lib = pnative.load_native()
    if lib is None:
        pytest.skip("no C++ compiler (g++) to build native/*.cpp")
    return lib


def _cloud_csr(seed, n=600, r=0.3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 2, size=(n, 3))
    edges = radius_graph_np(pos, r)
    indptr, col = ppartition._csr_from_edges(edges, n)
    return pos, edges, indptr, col


@pytest.mark.parametrize("nparts", [2, 4, 8])
def test_partition_labels_are_the_jax_bindings(lib, nparts):
    _, _, indptr, col = _cloud_csr(1)
    got = pnative.native_partition(indptr, col, nparts, seed=3)
    want = jnative.native_partition(indptr, col, nparts, seed=3)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    counts = np.bincount(got, minlength=nparts)
    assert (counts > 0).all() and counts.sum() == indptr.shape[0] - 1
    assert (pnative.native_edge_cut(indptr, col, got)
            == jnative.native_edge_cut(indptr, col, want))


def test_native_cut_beats_random(lib):
    _, _, indptr, col = _cloud_csr(2)
    lab = pnative.native_partition(indptr, col, 4, seed=0)
    rnd = ppartition.random_labels(600, 4, np.random.default_rng(0))
    assert (pnative.native_edge_cut(indptr, col, lab)
            < 0.5 * pnative.native_edge_cut(indptr, col, rnd))


@pytest.mark.parametrize("d", [0, 2])
def test_blockify_matches_numpy_and_jax(lib, d):
    _, edges, _, _ = _cloud_csr(3)
    rng = np.random.default_rng(4)
    attr = rng.normal(size=(edges.shape[1], d)).astype(np.float32) if d \
        else None
    n_pad, block = 1024, 256
    deg = pblocked.max_block_degree(edges[0], n_pad, block)
    epb = -(-deg // 512) * 512
    got = pnative.native_blockify(edges, attr, n_pad, epb, block)
    numpy = pblocked.blockify_edges(edges, attr, n_pad, epb, block)
    want = jnative.native_blockify(edges, attr, n_pad, epb, block)
    for a, b, c in zip(got, numpy, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        assert a.dtype == b.dtype
    # refused input: an unsorted row list, and a block over epb
    assert pnative.native_blockify(edges[:, ::-1], attr, n_pad, epb,
                                   block) is None
    assert pnative.native_blockify(edges, attr, n_pad, 8, block) is None


def test_pairing_matches_numpy_and_jax(lib):
    _, edges, _, _ = _cloud_csr(5)
    perm = np.random.default_rng(6).permutation(edges.shape[1])
    shuffled = edges[:, perm]
    for ei in (edges, shuffled):
        got = pnative.native_pairing(ei)
        np.testing.assert_array_equal(got, pblocked.pairing_perm(ei))
        np.testing.assert_array_equal(got, jnative.native_pairing(ei))
        np.testing.assert_array_equal(pblocked.pairing_perm_fast(ei), got)
    asym = edges[:, 1:]
    assert pnative.native_pairing(asym) is False
    assert pblocked.pairing_perm_fast(asym) is None


def test_prepare_blocked_graph_matches_jax(lib):
    """The port's blocked graph (native layout + native pairing) equals the
    JAX package's, key for key."""
    pos, edges, _, _ = _cloud_csr(7)
    d = np.linalg.norm(pos[edges[0]] - pos[edges[1]], axis=1)
    g = {"edge_index": edges.astype(np.int32),
         "edge_attr": np.repeat(d[:, None], 2, 1).astype(np.float32)}
    got = pblocked.prepare_blocked_graph(g, 1024, 2048, 256)
    want = jblocked.prepare_blocked_graph(g, 1024, 2048, 256)
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_library_lands_in_the_port_build_dir(lib, tmp_path, monkeypatch):
    """The port builds into distegnn_tpu_torch/_build/ and never touches
    native/build/ (the JAX package's)."""
    assert os.path.dirname(pnative.library_path()) == BUILD_DIR
    assert BUILD_DIR.endswith(os.path.join("distegnn_tpu_torch", "_build"))
    jax_build = os.path.join(REPO, "native", "build")

    def snapshot():
        if not os.path.isdir(jax_build):
            return None
        return sorted((f, os.stat(os.path.join(jax_build, f)).st_mtime_ns)
                      for f in os.listdir(jax_build))

    before = snapshot()
    monkeypatch.setattr(pnative, "BUILD_DIR", str(tmp_path))
    path = pnative.library_path()
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path).startswith("libdistegnn_native-")
    assert snapshot() == before


def test_concurrent_builds_compile_once(tmp_path):
    """Builders racing on one library: one compiles under the lock, the
    others wait and find it built; nobody sees a partial file."""
    out = str(tmp_path / "libx.so")
    calls, results = [], []

    def compile_to(tmp):
        calls.append(tmp)
        with open(tmp, "wb") as f:
            f.write(b"a" * 1000)
        time.sleep(0.2)
        return "built"

    def worker():
        path, _ = locked_build(out, compile_to)
        with open(path, "rb") as f:
            results.append(f.read())

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert results == [b"a" * 1000] * 4
    assert sorted(os.listdir(tmp_path)) == ["libx.so", "libx.so.lock"]


def test_without_a_compiler_the_numpy_versions_run(monkeypatch):
    """No library: the blocked layout and the pairing are the same, and
    metis falls back to the numpy BFS bisection, as the JAX package's does
    without its library, and says so."""
    pos, edges, _, _ = _cloud_csr(8, n=200, r=0.45)
    g = {"edge_index": edges.astype(np.int32),
         "edge_attr": np.zeros((edges.shape[1], 2), np.float32)}
    with_lib = pblocked.prepare_blocked_graph(g, 256, 2048, 256)
    ppartition.metis_labels(pos, 4, 0.45, seed=2)
    assert ppartition.metis_labels.partitioner == (
        "native" if pnative.load_native() is not None else "numpy")
    monkeypatch.setattr(pnative._NATIVE, "get", lambda: None)
    monkeypatch.setattr(jnative, "native_partition", lambda *a, **k: None)
    without = pblocked.prepare_blocked_graph(g, 256, 2048, 256)
    for k in with_lib:
        if isinstance(with_lib[k], np.ndarray):
            np.testing.assert_array_equal(without[k], with_lib[k])
    labels = ppartition.metis_labels(pos, 4, 0.45, seed=2)
    assert ppartition.metis_labels.partitioner == "numpy"
    np.testing.assert_array_equal(
        labels, jpartition.metis_labels(pos, 4, 0.45, seed=2))
    counts = np.bincount(labels, minlength=4)
    assert counts.max() - counts.min() <= 1
