"""The port's model families of the JAX factory without SE(3) layers
(FastRF, FastSchNet, SchNet, EGNN, RF, Linear, EGHN, and the library's GNN
and FullMLP) against the JAX package's, on the CPU, plus the port's own
lowering switches of FastRF and FastSchNet.

Parameters come from the port's seeded init, carried into the flax tree at
``convert.flax_layout``'s paths (held against a flax init's paths and
shapes); the gradients come back through ``params_from_jax``.

Tolerances (f32, scale-normalized: the error over the largest |JAX value|):
  forward    1e-6 on the real nodes' predicted coordinates and on the
             virtual coordinates (the same arithmetic in another order);
  gradients  1e-5 of the largest |JAX gradient| over the model;
  lowerings  (blocked einsum, cumsum, hoisted, packed) 1e-5 forward and
             gradient against the plain scatter path of the same weights
             (other summation orders; the cumsum prefix differences round
             at ~|prefix| * eps).
FastRF, SchNet, EGNN, RF, Linear, GNN and FullMLP are held on a padded
batch; FastSchNet and EGHN on a batch with no padded node or edge (the JAX
package's FastSchNet differentiates a padded edge's zero length, and EGHN a
padded node's zero Gram, to NaN; the port's norms have a zero gradient
there: ``test_port_gradients_are_finite_on_padded_batches``), and their
padded forward on its own.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from distegnn_tpu.models import basic as jbasic
from distegnn_tpu.models.eghn import EGHN as JaxEGHN
from distegnn_tpu.models.fast_egnn import FastEGNN as JaxFastEGNN
from distegnn_tpu.models.fast_rf import FastRF as JaxFastRF
from distegnn_tpu.models.fast_schnet import FastSchNet as JaxFastSchNet
from distegnn_tpu.models.schnet import SchNet as JaxSchNet
from distegnn_tpu.ops import segment as jseg
from distegnn_tpu.ops.graph import pad_graphs as jax_pad_graphs
from distegnn_tpu_torch.convert import params_from_jax
from distegnn_tpu_torch.models import basic as pbasic
from distegnn_tpu_torch.models.eghn import EGHN
from distegnn_tpu_torch.models.fast_egnn import FastEGNN
from distegnn_tpu_torch.models.fast_rf import FastRF
from distegnn_tpu_torch.models.fast_schnet import FastSchNet
from distegnn_tpu_torch.models.schnet import SchNet
from distegnn_tpu_torch.ops import graph as pgraph
from distegnn_tpu_torch.ops import segment as pseg
from test_torch_fast_egnn import numpy_params
from test_torch_graph import BLOCK, blocked_test_graph
from torch_model_pair import (FWD_TOL, GRAD_TOL, batches, check_equivariance,
                              check_forward, check_grads, flax_tree,
                              jax_reference, port_grads, scaled_err,
                              small_graphs, tree_matches_flax_init,
                              twin_graphs, unpadded)

H, L, C = 16, 2, 2
LOWER_TOL = 1e-5


def _gen():
    return torch.Generator().manual_seed(3)


FAMILIES = {
    "FastRF": (
        lambda: JaxFastRF(edge_attr_nf=2, hidden_nf=H, virtual_channels=C,
                          n_layers=L),
        lambda **kw: FastRF(edge_attr_nf=2, hidden_nf=H, virtual_channels=C,
                            n_layers=L, generator=_gen(), **kw)),
    "FastSchNet": (
        lambda: JaxFastSchNet(node_feat_nf=2, node_attr_nf=2, edge_attr_nf=2,
                              hidden_nf=H, virtual_channels=C, n_layers=L,
                              cutoff=1.0, attention=True),
        lambda **kw: FastSchNet(node_feat_nf=2, node_attr_nf=2,
                                edge_attr_nf=2, hidden_nf=H,
                                virtual_channels=C, n_layers=L, cutoff=1.0,
                                attention=True, generator=_gen(), **kw)),
    "SchNet": (
        lambda: JaxSchNet(hidden_channels=H, num_filters=H,
                          num_interactions=L, cutoff=1.0),
        lambda: SchNet(2, hidden_channels=H, num_filters=H,
                       num_interactions=L, cutoff=1.0, generator=_gen())),
    "EGNN": (
        lambda: jbasic.EGNN(n_layers=L, in_node_nf=2, in_edge_nf=2,
                            hidden_nf=H),
        lambda: pbasic.EGNN(L, 2, 2, H, generator=_gen())),
    "RF": (
        lambda: jbasic.RFVel(hidden_nf=H, edge_attr_nf=2, n_layers=L),
        lambda: pbasic.RFVel(H, 2, L, generator=_gen())),
    "Linear": (jbasic.LinearDynamics, pbasic.LinearDynamics),
    # one layer a block: EGHN's depth is compile time in JAX, not coverage
    "EGHN": (
        lambda: JaxEGHN(in_node_nf=2, in_edge_nf=2, hidden_nf=H,
                        n_cluster=3, layer_per_block=1, layer_pooling=1),
        lambda: EGHN(2, 2, H, n_cluster=3, layer_per_block=1,
                     layer_pooling=1, generator=_gen())),
    "EGHN-EGMN-no-v": (
        lambda: JaxEGHN(in_node_nf=2, in_edge_nf=2, hidden_nf=H,
                        n_cluster=3, layer_per_block=1, layer_pooling=1,
                        layer_decoder=2, with_v=False),
        lambda: EGHN(2, 2, H, n_cluster=3, layer_per_block=1,
                     layer_pooling=1, layer_decoder=2, with_v=False,
                     generator=_gen())),
    "GNN": (
        lambda: jbasic.GNN(n_layers=L, in_node_nf=2, in_edge_nf=2,
                           hidden_nf=H),
        lambda: pbasic.GNN(L, 2, 2, H, generator=_gen())),
    "FullMLP": (lambda: jbasic.FullMLP(hidden_nf=H),
                lambda: pbasic.FullMLP(2, H, generator=_gen())),
}
NODE_ATTR = {"FastSchNet": 2}
EQUIVARIANT = [n for n in FAMILIES if n not in ("GNN", "FullMLP")]


def _graphs(name, twin=True):
    nf = NODE_ATTR.get(name, 0)
    return (twin_graphs(node_attr_nf=nf) if twin
            else small_graphs(node_attr_nf=nf))


# families whose JAX gradients stay finite on a padded batch: held there,
# padded rows included; the others on unpadded twins, and their padded
# forward on its own
PADDED_GRADS = ("FastRF", "SchNet", "EGNN", "RF", "Linear", "GNN", "FullMLP")


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_matches_jax_fwd_and_grad(name):
    jf, pf = FAMILIES[name]
    if name in PADDED_GRADS:
        jb, pb = batches(_graphs(name, twin=False), compute_pair=True)
        assert float(pb.node_mask.min()) == 0 == float(pb.edge_mask.min())
    else:
        jb, pb = unpadded(_graphs(name), compute_pair=True)
    jm, pm = jf(), pf()
    tree_matches_flax_init(jm, jb, pm)
    ref = jax_reference(jm, jb, flax_tree(pm))
    check_forward(pm, pb, ref, FWD_TOL)
    _padded_rows_match(pm, pb, ref[0])
    check_grads(pm, pb, ref, GRAD_TOL)


def _padded_rows_match(pm, pb, jx):
    """The padded rows of the output as JAX's (zero, or the input)."""
    with torch.no_grad():
        px = pm(pb)[0].numpy()
    pad = pb.node_mask.numpy() == 0
    np.testing.assert_allclose(px[pad], jx[pad], rtol=0, atol=FWD_TOL)


@pytest.mark.parametrize("name", ["FastSchNet", "EGHN"])
def test_family_forward_matches_jax_on_a_padded_batch(name):
    """Two graphs of different sizes: padded nodes and edges masked as in
    JAX, padded rows of the output as JAX's; EGHN's normalized-cut loss
    (JAX sows it into 'aux') equal to JAX's."""
    jf, pf = FAMILIES[name]
    jb, pb = batches(_graphs(name, twin=False), compute_pair=True)
    jm, pm = jf(), pf()
    (jx, jX), state = jax.jit(lambda p, g: jm.apply(p, g, mutable=["aux"]))(
        flax_tree(pm), jb)
    check_forward(pm, pb, (np.asarray(jx), None if jX is None
                           else np.asarray(jX)), FWD_TOL)
    _padded_rows_match(pm, pb, np.asarray(jx))
    if name == "EGHN":
        want = float(np.asarray(state["aux"]["cut_loss"][0]))
        assert abs(float(pm.cut_loss) - want) <= FWD_TOL * abs(want)


@pytest.mark.parametrize("name", EQUIVARIANT)
def test_family_is_equivariant(name):
    check_equivariance(FAMILIES[name][1](), _graphs(name, twin=False),
                       tol=1e-4)


@pytest.mark.parametrize("name", ["FastSchNet", "EGHN", "SchNet", "FastRF"])
def test_port_gradients_are_finite_on_padded_batches(name):
    _, pb = batches(_graphs(name, twin=False))
    assert float(pb.edge_mask.min()) == 0 and float(pb.node_mask.min()) == 0
    _, grads = port_grads(FAMILIES[name][1](), pb)
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_segment_max_and_softmax_match_jax():
    """Masked rows never win the max nor get weight; empty segments give
    the initial value (max) and no weight (softmax); one graph and a
    batch."""
    rng = np.random.default_rng(4)
    B, E, N, Hh = 2, 40, 9, 3
    ids = np.sort(rng.integers(0, N - 2, size=(B, E)), axis=1)
    scores = (rng.normal(size=(B, E, Hh)) * 30).astype(np.float32)
    mask = (rng.uniform(size=(B, E)) > 0.3).astype(np.float32)
    scores[mask == 0] = 1e4      # a masked row's score exceeds the real max
    for b in range(B):
        args = (scores[b], ids[b], N)
        jm = np.asarray(jseg.segment_max(*args, mask=mask[b]))
        js = np.asarray(jseg.segment_softmax(*args, mask=mask[b]))
        targs = (torch.from_numpy(scores[b]), torch.from_numpy(ids[b]), N)
        pm = pseg.segment_max(*targs, mask=torch.from_numpy(mask[b]))
        ps = pseg.segment_softmax(*targs, mask=torch.from_numpy(mask[b]))
        np.testing.assert_array_equal(pm.numpy(), jm)
        np.testing.assert_allclose(ps.numpy(), js, rtol=1e-6, atol=1e-7)
        assert np.all(js[mask[b] == 0] == 0)
    batched = pseg.segment_softmax(torch.from_numpy(scores),
                                   torch.from_numpy(ids), N,
                                   mask=torch.from_numpy(mask))
    one = pseg.segment_softmax(torch.from_numpy(scores[1]),
                               torch.from_numpy(ids[1]), N,
                               mask=torch.from_numpy(mask[1]))
    np.testing.assert_array_equal(batched[1].numpy(), one.numpy())


# ------------------------------------------- the port's lowering switches

def _same_weights(a, b):
    b.load_state_dict(a.state_dict())
    return b


def _lowering_err(pm_a, pb_a, pm_b, pb_b):
    """(forward, gradient) distance of two models of the same weights on
    two layouts of the same graphs, scale-normalized to ``b``."""
    n = pb_b.max_nodes
    mask = pb_b.node_mask.numpy() > 0
    with torch.no_grad():
        xa, Xa = pm_a(pb_a)
        xb, Xb = pm_b(pb_b)
    fwd = max(scaled_err(xa[:, :n].numpy()[mask], xb.numpy()[mask]),
              scaled_err(Xa.numpy(), Xb.numpy()))
    _, ga = port_grads(pm_a, pb_a)
    _, gb = port_grads(pm_b, pb_b)
    scale = max(float(g.abs().max()) for g in gb.values())
    grad = max(float((ga[k] - gb[k]).abs().max()) for k in gb) / scale
    return fwd, grad


@pytest.mark.parametrize("name", ["FastRF", "FastSchNet"])
def test_blocked_layout_matches_plain(name):
    """The blocked one-hot lowering (einsum on the CPU; the pallas wrappers
    take their plain versions here) against the plain scatter layout, as
    the JAX package's tests/test_blocked.py holds its two layouts."""
    pf = FAMILIES[name][1]
    graphs = _graphs(name, twin=False)
    plain = pgraph.pad_graphs([dict(g) for g in graphs])
    blocked = pgraph.pad_graphs([dict(g) for g in graphs], edge_block=16,
                                edge_tile=64)
    assert blocked.edge_block == 16 and blocked.edge_pair is not None
    ref = pf()
    for impl in ("einsum", "pallas"):
        fwd, grad = _lowering_err(
            _same_weights(ref, pf(blocked_impl=impl)), blocked, ref, plain)
        assert fwd <= LOWER_TOL and grad <= LOWER_TOL, (impl, fwd, grad)


@pytest.mark.parametrize("name", ["FastRF", "FastSchNet"])
def test_cumsum_lowering_matches_scatter(name):
    pf = FAMILIES[name][1]
    pb = pgraph.pad_graphs([dict(g) for g in _graphs(name, twin=False)],
                           compute_pair=True)
    assert pb.edges_sorted and pb.edge_pair is not None
    ref = pf()
    fwd, grad = _lowering_err(_same_weights(ref, pf(segment_impl="cumsum")),
                              pb, ref, pb)
    assert fwd <= LOWER_TOL and grad <= LOWER_TOL, (fwd, grad)


def _hoisted_to_concat(sd):
    """A hoisted FastSchNet's parameters (or gradients) in the concat
    model's names: phi_e's fused first kernel [2H+S, H] is the concat
    Dense's transposed weight (concat order [h_row, h_col, scalars]), the
    gate's [G+2H, 1] likewise (order [gauss, h_row, h_col])."""
    out = {}
    for k, v in sd.items():
        if k.endswith((".phi_e.kernel", ".schnet_coord_update.kernel")):
            out[k.replace(".phi_e.kernel", ".phi_e.layers.0.weight").replace(
                ".schnet_coord_update.kernel",
                ".schnet_coord_update.weight")] = v.T
        elif k.endswith(".phi_e.bias"):
            out[k.replace(".phi_e.bias", ".phi_e.layers.0.bias")] = v
        else:
            out[k.replace(".phi_e.dense.", ".phi_e.layers.1.")] = v
    return out


def test_fast_schnet_hoisted_matches_concat_and_packed_matches_unpacked():
    """hoist_edge_mlp (phi_e's and the gate's first Dense on the node axis)
    against the concat MLPs of the same weights, and fuse_agg (one packed
    aggregation a layer) against two, as the JAX package's
    tests/test_models.py and tests/test_fuse_agg.py hold them."""
    pf = FAMILIES["FastSchNet"][1]
    pb = pgraph.pad_graphs([dict(g) for g in _graphs("FastSchNet", False)])
    hoisted = pf()
    concat = pf(hoist_edge_mlp=False)
    concat.load_state_dict(_hoisted_to_concat(hoisted.state_dict()))
    with torch.no_grad():
        xh, Xh = hoisted(pb)
        xc, Xc = concat(pb)
    assert scaled_err(xh.numpy(), xc.numpy()) <= LOWER_TOL
    assert scaled_err(Xh.numpy(), Xc.numpy()) <= LOWER_TOL
    _, gh = port_grads(hoisted, pb)
    _, gc = port_grads(concat, pb)
    gh = _hoisted_to_concat(gh)
    assert gh.keys() == gc.keys()
    scale = max(float(g.abs().max()) for g in gc.values())
    assert max(float((gh[k] - gc[k]).abs().max())
               for k in gc) <= LOWER_TOL * scale
    unpacked = _same_weights(hoisted, pf(fuse_agg=False))
    fwd, grad = _lowering_err(hoisted, pb, unpacked, pb)
    assert fwd <= LOWER_TOL and grad <= LOWER_TOL, (fwd, grad)


def test_fast_models_launch_no_kernel_on_cpu():
    """On CPU tensors the blocked and scan wrappers take their plain
    versions: no launch is counted."""
    from distegnn_tpu_torch.ops import blocked as pblocked
    from distegnn_tpu_torch.ops import cumsum as pcumsum

    def counts():
        return (pblocked.blocked_segment_sum.launches,
                pblocked.blocked_gather.launches,
                pblocked.blocked_plan.launches, pcumsum.prefix_sum.launches)

    before = counts()
    graphs = _graphs("FastRF", twin=False)
    pb = pgraph.pad_graphs([dict(g) for g in graphs], edge_block=16,
                           edge_tile=64)
    port_grads(FAMILIES["FastRF"][1](blocked_impl="pallas"), pb)
    pb = pgraph.pad_graphs([dict(g) for g in graphs], compute_pair=True)
    port_grads(FAMILIES["FastSchNet"][1](segment_impl="cumsum"),
               dataclasses.replace(pb, node_attr=torch.zeros(
                   pb.node_feat.shape[:2] + (2,))))
    assert counts() == before


@pytest.mark.parametrize("kw", [{}, {"hoist_edge_mlp": False,
                                     "attention": True, "tanh": True},
                                {"edge_impl": "fused"}],
                         ids=["plain", "concat-attention", "fused"])
def test_flax_layout_reads_a_fastegnn_tree_as_the_tree_mapping(kw):
    """``params_from_jax(tree, model)`` (the module walk every family uses,
    and the JAX-checkpoint layouts) equals the FastEGNN tree mapping that
    needs no model, on the plain, concat + attention and fused trees."""
    common = dict(node_feat_nf=2, edge_attr_nf=2, hidden_nf=8,
                  virtual_channels=2, n_layers=2, **kw)
    jb = jax_pad_graphs([blocked_test_graph(0, n_real=3 * BLOCK)],
                        edge_block=BLOCK, compute_pair=False,
                        split_remote=True)
    params = numpy_params(JaxFastEGNN(**common), jb, 1)
    want = params_from_jax(params)
    got = params_from_jax(params, FastEGNN(**common))
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
