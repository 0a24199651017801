"""The port's shard directories (``data/stream.py``) against the JAX
package's on the CPU.

A directory written by either package opens in the other and serves the
same graphs bit for bit; a corrupted shard raises ``ShardChecksumError``
after the bounded retries; the decoded-shard cache never holds more than
``cache_shards``; a shuffled epoch streamed through the port's
``GraphLoader`` and ``PrefetchLoader`` is bitwise the in-memory one; and
the distributed launcher opens every rank's shard directory through
``open_dataset`` with ``data.stream_shard_cache``, giving the batches of the
pickle shards, and trains ``configs/simulation_distegnn.yaml`` (narrow
widths, 2 ranks) from them.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import os

import numpy as np
import pytest
import torch

from distegnn_tpu.data import stream as jstream
from distegnn_tpu_torch.config import load_config
from distegnn_tpu_torch.data import stream as pstream
from distegnn_tpu_torch.data.loader import (GraphDataset, GraphLoader,
                                            PrefetchLoader)
from distegnn_tpu_torch.ops.radius import radius_graph_np
from distegnn_tpu_torch.parallel import launch
from tests.conftest import make_water3d_h5
from torch_dist_worker import one_rank_group

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIMULATION = os.path.join(REPO, "configs", "simulation_distegnn.yaml")
FIELDS = ("node_feat", "node_attr", "loc", "vel", "target", "loc_mean",
          "edge_index", "edge_attr")


def make_graphs(n_graphs=10, seed=0, with_optional=True):
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n_graphs):
        n = int(rng.integers(20, 48))
        loc = rng.normal(size=(n, 3)).astype(np.float32)
        vel = rng.normal(size=(n, 3)).astype(np.float32)
        ei = radius_graph_np(loc, 1.5).astype(np.int32)
        dist = np.linalg.norm(loc[ei[0]] - loc[ei[1]], axis=1)
        graphs.append({
            "node_feat": np.linalg.norm(vel, axis=1, keepdims=True),
            "node_attr": (rng.normal(size=(n, 2)).astype(np.float32)
                          if with_optional else None),
            "loc": loc,
            "vel": vel,
            "target": loc + 0.1 * vel if with_optional else None,
            "loc_mean": loc.mean(axis=0),
            "edge_index": ei,
            "edge_attr": np.repeat(dist[:, None], 2, axis=1),
        })
    return graphs


def assert_graph_equal(a, b):
    for k in FIELDS:
        if b.get(k) is None:
            assert a.get(k) is None, k
        else:
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k


def assert_batches_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        else:
            assert x == y, f.name


def manifest_without_bytes(m):
    """The manifest minus each shard's CRC32 and size: npz members carry a
    write time, so two writes of the same arrays differ in a few bytes."""
    return dict(m, shards=[{k: v for k, v in s.items()
                            if k not in ("crc32", "bytes")}
                           for s in m["shards"]])


@pytest.mark.parametrize("writer, reader", [(jstream, pstream),
                                            (pstream, jstream)],
                         ids=["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("node_order", ["none", "morton"])
def test_a_directory_opens_in_the_other_package(tmp_path, writer, reader,
                                                node_order):
    graphs = make_graphs(10, with_optional=node_order == "none")
    m = writer.write_shards(graphs, str(tmp_path / "w"), shard_size=3,
                            node_order=node_order)
    # the other package writes the same manifest
    other = reader.write_shards(graphs, str(tmp_path / "r"), shard_size=3,
                                node_order=node_order)
    assert manifest_without_bytes(m) == manifest_without_bytes(other)
    ds = reader.open_dataset(str(tmp_path / "w"), node_order=node_order,
                             cache_shards=2)
    assert isinstance(ds, reader.StreamedGraphDataset)
    assert len(ds) == 10
    assert ds.size_maxima() == (max(g["loc"].shape[0] for g in graphs),
                                max(g["edge_index"].shape[1] for g in graphs))
    mem = pstream.open_dataset(graphs, node_order=node_order)
    assert isinstance(mem, GraphDataset)
    for i in range(len(graphs)):
        assert_graph_equal(ds[i], mem[i])


def test_a_corrupt_shard_is_refused_after_the_retries(tmp_path):
    graphs = make_graphs(6)
    pstream.write_shards(graphs, str(tmp_path), shard_size=2)
    shard = tmp_path / "shard_00001.npz"
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0xFF
    shard.write_bytes(bytes(data))
    ds = pstream.StreamedGraphDataset(str(tmp_path))
    assert_graph_equal(ds[0], graphs[0])
    with pytest.raises(pstream.ShardChecksumError, match="crc32"):
        ds[2]
    # JAX refuses the same bytes
    with pytest.raises(jstream.ShardChecksumError):
        jstream.StreamedGraphDataset(str(tmp_path))[2]
    with pytest.raises(ValueError, match="cache_shards"):
        pstream.StreamedGraphDataset(str(tmp_path), cache_shards=0)
    with pytest.raises(ValueError, match="node_attr"):
        pstream.write_shards([graphs[0], dict(graphs[1], node_attr=None)],
                             str(tmp_path / "mixed"))


def test_the_shard_cache_is_bounded(tmp_path):
    graphs = make_graphs(12)
    pstream.write_shards(graphs, str(tmp_path), shard_size=2)   # 6 shards
    ds = pstream.StreamedGraphDataset(str(tmp_path), cache_shards=2)
    for i in np.random.default_rng(0).integers(0, 12, size=40):
        assert_graph_equal(ds[int(i)], graphs[int(i)])
        assert ds.open_shards <= 2
    assert ds.open_shards == 2
    assert ds[-1]["loc"].shape == graphs[-1]["loc"].shape
    with pytest.raises(IndexError):
        ds[12]


@pytest.mark.parametrize("edge_block", [0, 8])
def test_a_streamed_epoch_is_bitwise_the_in_memory_epoch(tmp_path,
                                                         edge_block):
    graphs = make_graphs(10, seed=1)
    pstream.write_shards(graphs, str(tmp_path), shard_size=3)
    kw = dict(shuffle=True, seed=7, edge_block=edge_block)
    mem = GraphLoader(GraphDataset(graphs), 2, **kw)
    st = PrefetchLoader(GraphLoader(
        pstream.StreamedGraphDataset(str(tmp_path), cache_shards=2), 2,
        **kw), depth=2)
    assert len(mem) == len(st) == 5
    for epoch in range(2):
        mem.set_epoch(epoch)
        st.set_epoch(epoch)
        pairs = list(zip(mem, st))
        assert len(pairs) == 5
        for a, b in pairs:
            assert_batches_equal(a, b)


@pytest.fixture(scope="module")
def simulation(tmp_path_factory):
    """configs/simulation_distegnn.yaml at narrow widths on synthetic
    Water-3D files, 2 ranks: the config, the pickle shards and the same
    shards as write_shards directories."""
    root = tmp_path_factory.mktemp("sim")
    data = make_water3d_h5(root / "raw", 60, 30, step_scale=0.002, seed=7)
    cfg = load_config(SIMULATION, {
        "data.data_dir": data, "data.max_samples": 8, "data.batch_size": 2,
        "data.world_size": 2, "data.outer_radius": 0.15,
        "data.inner_radius": 0.12, "data.delta_t": 5,
        "data.stream_shard_cache": 2, "model.hidden_nf": 16,
        "model.n_layers": 2, "train.epochs": 1,
        "log.log_dir": str(root / "logs"), "log.test_interval": 1})
    pickles = launch._dispatch_preprocess(cfg, 2)
    dirs = [[str(root / "shards" / f"{s}_{r}") for r in range(2)]
            for s in ("train", "valid", "test")]
    for ps, ds in zip(pickles, dirs):
        for p, d in zip(ps, ds):
            pstream.write_shards(GraphDataset(p).graphs, d, shard_size=3)
    return cfg, pickles, dirs


def test_rank_loaders_stream_shard_directories(simulation, tmp_path):
    cfg, pickles, dirs = simulation
    cpu = torch.device("cpu")
    with one_rank_group(tmp_path):
        streamed = launch.rank_loaders(cfg, dirs, 1, cpu)
        whole = launch.rank_loaders(cfg, pickles, 1, cpu)
    for s, w in zip(streamed, whole):
        ds = s.loader.dataset
        assert isinstance(ds, pstream.StreamedGraphDataset)
        assert ds.cache_shards == cfg.data.stream_shard_cache == 2
        assert isinstance(w.loader.dataset, GraphDataset)
        s.set_epoch(1)
        w.set_epoch(1)
        pairs = list(zip(s, w))
        assert len(pairs) == len(w) > 0
        for a, b in pairs:
            assert_batches_equal(a, b)


def test_simulation_config_trains_from_shard_directories(simulation):
    cfg, _, dirs = simulation
    best = launch.run_distributed(cfg, split_paths=dirs, device="cpu")
    assert np.isfinite(best["loss_valid"]) and np.isfinite(best["loss_test"])
