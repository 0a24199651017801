"""The PyTorch port's host-side graph layout against the JAX package's:
radius graphs, Morton ordering and the blocked ``split_remote`` padding are
required to be BITWISE equal (they are numpy copies; any difference would
move edges between the fused kernel and the remote tail)."""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

from distegnn_tpu.ops import graph as jgraph
from distegnn_tpu.ops import order as jorder
from distegnn_tpu.ops import radius as jradius
from distegnn_tpu_torch.ops import graph as pgraph
from distegnn_tpu_torch.ops import order as porder
from distegnn_tpu_torch.ops import radius as pradius

BLOCK = 512


def blocked_test_graph(seed, n_real=4 * BLOCK, node_feat_nf=2):
    """Random graph whose edges are mostly near-diagonal (in-window) with a
    far-block minority (remote tail); the same recipe as the JAX package's
    tests/test_fused_model.py. Padded to 5 blocks it leaves a trailing node
    block with no real nodes or edges."""
    rng = np.random.default_rng(seed)
    nblk = n_real // BLOCK
    rows, cols = [], []
    for b in range(nblk):
        r = rng.integers(b * BLOCK, (b + 1) * BLOCK, size=384)
        near = rng.integers(max(0, (b - 1) * BLOCK),
                            min(n_real, (b + 2) * BLOCK), size=384)
        far_block = (b + 3) % nblk
        far = rng.integers(far_block * BLOCK, (far_block + 1) * BLOCK,
                           size=384)
        c = np.where(rng.uniform(size=384) < 0.1, far, near)
        rows.append(r)
        cols.append(c)
    row = np.concatenate(rows)
    col = np.concatenate(cols)
    order = np.argsort(row, kind="stable")
    ei = np.stack([row[order], col[order]]).astype(np.int64)
    e = ei.shape[1]
    return {
        "node_feat": rng.normal(size=(n_real, node_feat_nf)).astype(np.float32),
        "loc": rng.uniform(0, 1, size=(n_real, 3)).astype(np.float32),
        "vel": (rng.normal(size=(n_real, 3)) * 0.05).astype(np.float32),
        "target": rng.uniform(0, 1, size=(n_real, 3)).astype(np.float32),
        "edge_index": ei,
        "edge_attr": rng.normal(size=(e, 2)).astype(np.float32),
    }


def plain_test_graph(seed, n=300, radius=0.2, node_feat_nf=2,
                     node_attr_nf=0):
    """A symmetric radius graph over ``n`` uniform points (rows ascending,
    so the plain layout carries the reverse-edge pairing), with random
    features, velocities, targets and 2 edge attributes."""
    rng = np.random.default_rng(seed)
    loc = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    ei = pradius.radius_graph_np(loc, radius).astype(np.int64)
    g = {
        "node_feat": rng.normal(size=(n, node_feat_nf)).astype(np.float32),
        "loc": loc,
        "vel": (rng.normal(size=(n, 3)) * 0.05).astype(np.float32),
        "target": rng.uniform(0, 1, size=(n, 3)).astype(np.float32),
        "edge_index": ei,
        "edge_attr": rng.normal(size=(ei.shape[1], 2)).astype(np.float32),
    }
    if node_attr_nf:
        g["node_attr"] = rng.normal(size=(n, node_attr_nf)).astype(np.float32)
    return g


_FIELDS = ("node_feat", "node_attr", "loc", "vel", "target", "loc_mean",
           "node_mask", "edge_index", "edge_attr", "edge_mask",
           "remote_edge_index", "remote_edge_attr", "remote_edge_mask")


def assert_batches_equal(jb, pb, plain_pair=False):
    """Field by field, bitwise; ``plain_pair`` also holds the plain layout's
    reverse-edge pairing and ELL degree."""
    for f in _FIELDS + (("edge_pair",) if plain_pair else ()):
        a, b = getattr(jb, f), getattr(pb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert jb.edge_block == pb.edge_block
    assert jb.edge_tile == pb.edge_tile
    assert jb.edges_sorted == pb.edges_sorted
    if plain_pair:
        assert jb.max_in_degree == pb.max_in_degree


@pytest.mark.parametrize("r", [0.08, 0.2, -1.0])
def test_radius_graph_matches_jax(r):
    loc = np.random.default_rng(1).uniform(0, 1, size=(300, 3))
    a = jradius.radius_graph_np(loc, r)
    b = pradius.radius_graph_np(loc, r)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_morton_order_matches_jax():
    g = blocked_test_graph(3)
    loc = g["loc"]
    np.testing.assert_array_equal(jorder.morton_codes(loc),
                                  porder.morton_codes(loc))
    perm = porder.morton_perm(loc)
    np.testing.assert_array_equal(jorder.morton_perm(loc), perm)
    a, b = jorder.reorder_graph(g, perm), porder.reorder_graph(g, perm)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("max_nodes", [None, 5 * BLOCK])
def test_pad_graphs_blocked_split_remote_matches_jax(max_nodes):
    """A remote tail, and (max_nodes=5 blocks) a trailing empty block."""
    graphs = [blocked_test_graph(0), blocked_test_graph(1)]
    jb = jgraph.pad_graphs(graphs, max_nodes=max_nodes, edge_block=BLOCK,
                           compute_pair=False, split_remote=True)
    pb = pgraph.pad_graphs(graphs, max_nodes=max_nodes, edge_block=BLOCK,
                           split_remote=True)
    assert pb.remote_edge_mask.sum() > 0
    if max_nodes:
        assert pb.max_nodes == 5 * BLOCK
    assert_batches_equal(jb, pb)


def test_pad_graphs_plain_layout_matches_jax():
    graphs = [blocked_test_graph(2, n_real=BLOCK), blocked_test_graph(
        4, n_real=2 * BLOCK)]
    jb = jgraph.pad_graphs(graphs, compute_pair=False)
    pb = pgraph.pad_graphs(graphs)
    assert_batches_equal(jb, pb)


def test_pad_graphs_rejects_split_remote_without_blocks():
    with pytest.raises(ValueError, match="split_remote requires edge_block"):
        pgraph.pad_graphs([blocked_test_graph(0)], split_remote=True)
