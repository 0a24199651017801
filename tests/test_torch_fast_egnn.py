"""The port's FastEGNN (edge_impl='fused') against the JAX package's, with
the JAX parameters converted by ``distegnn_tpu_torch.convert``.

Tolerance (f32): |port - jax| <= 1e-5 on the predicted coordinates of real
nodes and on the virtual coordinates (both O(1): unit-cube scenes). The two
compute the same roundings (bf16 hi+lo translations and bf16 edge features in
the fused sums); only the summation order of sums and matmuls differs, and
it compounds through the layers without exceeding 1e-5 here.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import numpy as np
import pytest
import torch

from distegnn_tpu.models.fast_egnn import FastEGNN as JaxFastEGNN
from distegnn_tpu.ops.graph import pad_graphs as jax_pad_graphs
from distegnn_tpu_torch.convert import params_from_jax
from distegnn_tpu_torch.models.fast_egnn import FastEGNN
from distegnn_tpu_torch.ops.graph import pad_graphs
from test_torch_graph import BLOCK, blocked_test_graph

ATOL = 1e-5


def numpy_params(jax_model, batch, seed):
    """A parameter tree of ``jax_model`` drawn with numpy at the model's own
    init scales (torch nn.Linear bounds; coordinate heads 1e-3 xavier). Only
    the tree's shapes come from flax (``eval_shape``): running the fused
    model's init would cost a full interpret-mode forward."""
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = sds.shape
        if name == "virtual_node_feat":
            v = rng.normal(size=shape)
        elif shape[-1] == 1 and len(shape) == 2:      # coordinate heads
            b = 1e-3 * np.sqrt(6.0 / (shape[0] + shape[1]))
            v = rng.uniform(-b, b, size=shape)
        else:                                         # kernels and biases
            fan_in = shape[0] if len(shape) == 2 else shape[-1]
            v = rng.uniform(-1, 1, size=shape) / np.sqrt(fan_in)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _compare(graphs, max_nodes, H, L, C, seed=0):
    jb = jax_pad_graphs(graphs, max_nodes=max_nodes, edge_block=BLOCK,
                        compute_pair=False, split_remote=True)
    jm = JaxFastEGNN(node_feat_nf=2, edge_attr_nf=2, hidden_nf=H,
                     virtual_channels=C, n_layers=L, edge_impl="fused")
    params = numpy_params(jm, jb, seed)
    jx, jX = jax.jit(jm.apply)(params, jb)

    pm = FastEGNN(node_feat_nf=2, edge_attr_nf=2, hidden_nf=H,
                  virtual_channels=C, n_layers=L, edge_impl="fused")
    pm.load_state_dict(params_from_jax(params))
    pb = pad_graphs(graphs, max_nodes=max_nodes, edge_block=BLOCK,
                    split_remote=True)
    with torch.no_grad():
        px, pX = pm(pb)
    mask = np.asarray(jb.node_mask) > 0
    jx, jX = np.asarray(jx), np.asarray(jX)
    px, pX = px.numpy(), pX.numpy()
    assert px.shape == jx.shape and pX.shape == jX.shape
    assert np.isfinite(px).all() and np.isfinite(pX).all()
    np.testing.assert_allclose(px[mask], jx[mask], rtol=0, atol=ATOL)
    np.testing.assert_allclose(pX, jX, rtol=0, atol=ATOL)
    # the padded rows are zeroed by both models
    np.testing.assert_array_equal(px[~mask], 0.0)


def test_forward_matches_jax_small_with_remote_tail_and_empty_block():
    """H=16, L=2, C=2 over 2 graphs of 4 blocks padded to 5 blocks."""
    _compare([blocked_test_graph(0), blocked_test_graph(1)], 5 * BLOCK,
             H=16, L=2, C=2)


def test_forward_matches_jax_full_width():
    """The published width H=64, L=4, C=3 on one 3-block graph."""
    _compare([blocked_test_graph(2, n_real=3 * BLOCK)], None, H=64, L=4, C=3)


def test_converted_state_dict_covers_every_parameter():
    jm = JaxFastEGNN(node_feat_nf=2, edge_attr_nf=2, hidden_nf=16,
                     virtual_channels=2, n_layers=2, edge_impl="fused")
    jb = jax_pad_graphs([blocked_test_graph(0, n_real=3 * BLOCK)],
                        edge_block=BLOCK, compute_pair=False,
                        split_remote=True)
    sd = params_from_jax(numpy_params(jm, jb, 1))
    pm = FastEGNN(node_feat_nf=2, edge_attr_nf=2, hidden_nf=16,
                  virtual_channels=2, n_layers=2, edge_impl="fused")
    own = pm.state_dict()
    assert sd.keys() == own.keys()
    for k in own:
        assert sd[k].shape == own[k].shape, k


@pytest.mark.parametrize("kw, ported_in", [
    ({"edge_impl": "plain"}, "slice 5"),
    ({"hoist_edge_mlp": False}, "slice 5"),
    ({"blocked_impl": "pallas"}, "slice 5"),
    ({"segment_impl": "cumsum"}, "slice 5"),
    ({"segment_impl": "ell", "attention": True}, "slice 5"),
])
def test_unported_options_raise_and_name_their_slice(kw, ported_in):
    """A plain model (every lowering, either edge MLP) on a blocked batch:
    refused until port slice 5 brought the blocked one-hot lowerings; now it
    answers what the same model answers on the plain layout (1e-5, the
    model parity bound; the blocked sums run in another order)."""
    g = blocked_test_graph(0, n_real=BLOCK)
    pb = pad_graphs([g], edge_block=BLOCK)
    plain = pad_graphs([g])
    pm = FastEGNN(node_feat_nf=2, edge_attr_nf=2, hidden_nf=16,
                  virtual_channels=2, n_layers=1,
                  generator=torch.Generator().manual_seed(1), **kw)
    with torch.no_grad():
        xb, Xb = pm(pb)
        xp, Xp = pm(plain)
    n = plain.max_nodes
    mask = plain.node_mask.numpy() > 0
    np.testing.assert_allclose(xb[:, :n].numpy()[mask], xp.numpy()[mask],
                               rtol=0, atol=ATOL, err_msg=ported_in)
    np.testing.assert_allclose(Xb.numpy(), Xp.numpy(), rtol=0, atol=ATOL,
                               err_msg=ported_in)


@pytest.mark.parametrize("head", ["attention", "normalize", "tanh"])
def test_fused_model_refuses_the_plain_heads(head):
    """As in the JAX package: the fused kernel bakes the flagship EGCL."""
    with pytest.raises(ValueError, match="edge_impl='plain'"):
        FastEGNN(node_feat_nf=2, edge_attr_nf=2, hidden_nf=16,
                 edge_impl="fused", **{head: True})


def test_forward_rejects_unblocked_batch():
    pm = FastEGNN(node_feat_nf=2, edge_attr_nf=2, hidden_nf=16,
                  virtual_channels=2, n_layers=1, edge_impl="fused")
    pb = pad_graphs([blocked_test_graph(0, n_real=BLOCK)])
    with pytest.raises(ValueError, match="split_remote=True"):
        pm(pb)
