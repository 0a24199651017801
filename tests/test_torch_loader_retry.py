"""The port's dataset reads retry a transient failure as the JAX package's
do (``data/loader.py`` ``_read_with_retry``): three attempts with 0.1 s and
0.2 s backoff around the whole read, through one module-level open hook
(``loader._file_open``) that the pickled datasets and the shard directories
of ``data/stream.py`` share. Two failed reads of a pickle (a raised open, a
truncated payload) still load the dataset equal to an undisturbed read and
to JAX's under the same faults; a failure on every attempt raises after the
third; the dataset's bytes land on the ``data/host_bytes`` gauge."""

import torch_threads  # noqa: F401  (first: one torch thread)
import pickle

import numpy as np
import pytest

from distegnn_tpu.data.loader import GraphDataset as JaxGraphDataset
from distegnn_tpu.testing.faults import flaky_open as jax_flaky_open
from distegnn_tpu.testing.faults import truncated_read as jax_truncated_read
from distegnn_tpu_torch import obs
from distegnn_tpu_torch.data import loader, stream
from distegnn_tpu_torch.data.loader import GraphDataset
from distegnn_tpu_torch.testing.faults import flaky_open, truncated_read


def _graphs(seed=0, n_graphs=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        n = int(rng.integers(5, 12))
        vel = rng.normal(size=(n, 3)).astype(np.float32)
        out.append({"node_feat": np.linalg.norm(vel, axis=1, keepdims=True),
                    "loc": rng.normal(size=(n, 3)).astype(np.float32),
                    "vel": vel,
                    "edge_index": rng.integers(0, n, (2, 2 * n)).astype(
                        np.int32)})
    return out


def _equal(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        assert ga.keys() == gb.keys()
        for k in ga:
            np.testing.assert_array_equal(ga[k], gb[k])


def _fault(mode):
    """The port's injector of ``mode``: the first opens raise
    (``flaky_open``) or hand back the first half of the file
    (``truncated_read``); each counts every open."""
    return flaky_open if mode == "raise" else truncated_read


@pytest.fixture
def pickled(tmp_path):
    graphs = _graphs()
    path = tmp_path / "graphs.pkl"
    with open(path, "wb") as f:
        pickle.dump(graphs, f)
    return str(path), graphs


@pytest.fixture
def sleeps(monkeypatch):
    slept = []
    monkeypatch.setattr(loader.time, "sleep", slept.append)
    return slept


@pytest.mark.parametrize("mode", ["raise", "truncate"])
def test_two_failed_reads_of_a_pickle_still_load_it(pickled, sleeps, mode):
    path, graphs = pickled
    with _fault(mode)(2) as hook:
        ds = GraphDataset(path)
    assert hook["n"] == 3 and sleeps == [0.1, 0.2]
    _equal(ds.graphs, graphs)
    # JAX under the same two faults loads the same graphs
    jfault = jax_flaky_open if mode == "raise" else jax_truncated_read
    with jfault(2) as calls:
        jds = JaxGraphDataset(path)
    assert calls["n"] == 3
    _equal(ds.graphs, jds.graphs)


@pytest.mark.parametrize("mode", ["raise", "truncate"])
def test_a_failure_on_every_attempt_still_raises(pickled, sleeps, mode):
    path, _ = pickled
    with pytest.raises(OSError if mode == "raise" else
                       (EOFError, pickle.UnpicklingError)):
        with _fault(mode)(5) as hook:
            GraphDataset(path)
    assert hook["n"] == 3 and sleeps == [0.1, 0.2]


def test_shard_reads_go_through_the_same_hook(tmp_path, sleeps):
    graphs = _graphs(1, n_graphs=4)
    out = str(tmp_path / "shards")
    stream.write_shards(graphs, out, shard_size=2)
    with truncated_read(2) as hook:
        ds = stream.StreamedGraphDataset(out)     # the manifest: 2 torn reads
        assert hook["n"] == 3
        got = [ds[i] for i in range(len(ds))]
        assert hook["n"] == 5                     # one read per shard
    for g, ref in zip(got, graphs):
        for k in ("node_feat", "loc", "vel", "edge_index"):
            np.testing.assert_array_equal(g[k], ref[k])


def test_dataset_bytes_land_on_the_host_bytes_gauge(pickled):
    path, graphs = pickled
    gauge = obs.get_registry().gauge("data/host_bytes")
    before = gauge.value
    GraphDataset(path)
    assert gauge.value - before == sum(a.nbytes for g in graphs
                                       for a in g.values())
