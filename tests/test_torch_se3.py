"""The port's SE(3) families (TFN, SE3Transformer, FastTFN) and their
building blocks (so3.py's harmonics and Q matrices, the run-time basis)
against the JAX package's, on the CPU.

Tolerances (f32, scale-normalized): forward 1e-5 and gradients 1e-4 (the
kernel-basis contractions and LayerNorms run in another order: one decade
above the other families' bounds); the harmonics 1e-6 relative in f32 and
1e-12 in f64; the Q matrices bitwise (each is unique up to sign, and the
port draws the constraint's rotations bit for bit as the JAX package does,
so the SVD picks the same sign).
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distegnn_tpu.models.fast_tfn import FastTFN as JaxFastTFN
from distegnn_tpu.models.se3 import basis as jbasis
from distegnn_tpu.models.se3 import so3 as jso3
from distegnn_tpu.models.se3.dynamics import (SE3TransformerDynamics as
                                              JaxSE3TransformerDynamics)
from distegnn_tpu.models.se3.dynamics import TFNDynamics as JaxTFNDynamics
from distegnn_tpu_torch.models.fast_tfn import FastTFN
from distegnn_tpu_torch.models.se3 import basis as pbasis
from distegnn_tpu_torch.models.se3 import so3 as pso3
from distegnn_tpu_torch.models.se3.dynamics import (SE3TransformerDynamics,
                                                    TFNDynamics)
from torch_model_pair import (SE3_FWD_TOL, SE3_GRAD_TOL, _loss_jax, batches,
                              check_equivariance, check_forward, check_grads,
                              flax_tree, jax_reference, port_grads,
                              small_graphs, tree_matches_flax_init,
                              twin_graphs, unpadded)


def _gen():
    return torch.Generator().manual_seed(5)


FAMILIES = {
    "TFN": (lambda: JaxTFNDynamics(nf=8, n_layers=2, num_degrees=2),
            lambda: TFNDynamics(nf=8, n_layers=2, num_degrees=2,
                                generator=_gen())),
    "SE3Transformer": (
        lambda: JaxSE3TransformerDynamics(nf=8, n_layers=2, num_degrees=2,
                                          n_heads=2),
        lambda: SE3TransformerDynamics(nf=8, n_layers=2, num_degrees=2,
                                       n_heads=2, generator=_gen())),
    "FastTFN": (
        lambda: JaxFastTFN(node_feat_nf=2, edge_attr_nf=2, hidden_nf=16,
                           virtual_channels=2, n_layers=2),
        lambda: FastTFN(node_feat_nf=2, edge_attr_nf=2, hidden_nf=16,
                        virtual_channels=2, n_layers=2, generator=_gen())),
    "FastTFN-charges-from-node_attr": (
        lambda: JaxFastTFN(node_feat_nf=2, node_attr_nf=1, edge_attr_nf=2,
                           hidden_nf=16, virtual_channels=2, n_layers=1),
        lambda: FastTFN(node_feat_nf=2, node_attr_nf=1, edge_attr_nf=2,
                        hidden_nf=16, virtual_channels=2, n_layers=1,
                        generator=_gen())),
}


def _graphs(name, twin=True):
    nf = 1 if name.endswith("node_attr") else 0
    return (twin_graphs(node_attr_nf=nf) if twin
            else small_graphs(node_attr_nf=nf))


def test_real_sph_harm_and_q_matrices_match_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 3))
    v[0] = 0.0                                   # the guarded zero vector
    v[1] = (0.0, 0.0, 2.0)                       # the pole
    for l in range(5):
        want = jso3.real_sph_harm(l, v)
        np.testing.assert_allclose(pso3.real_sph_harm(l, v), want,
                                   rtol=0, atol=1e-12)
        got = pbasis.real_sph_harm(l, torch.from_numpy(v.astype(np.float32)),
                                   xp=pbasis._TORCH_XP).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # degrees 0-1, the families' (num_degrees 2); degree 2's SVDs take
    # seconds, minutes on a loaded host
    qj, qp = jso3.q_matrices(1), pso3.q_matrices(1)
    assert qj.keys() == qp.keys()
    for k in qj:
        for a, b in zip(qj[k], qp[k]):
            np.testing.assert_array_equal(a, b)
    R = pso3._random_rotations(3, seed=99)
    for l in (1, 2):
        for r in R:
            np.testing.assert_allclose(pso3.wigner_d_real(l, r),
                                       jso3.wigner_d_real(l, r), atol=1e-12)


def test_basis_and_r_match_jax():
    rng = np.random.default_rng(1)
    rel = rng.normal(size=(2, 30, 3)).astype(np.float32)
    rel[0, :3] = 0.0                             # padded zero-length edges
    jb_, jr = jbasis.compute_basis_and_r(jnp.asarray(rel), 1)
    pb_, pr = pbasis.compute_basis_and_r(torch.from_numpy(rel), 1)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-6, atol=0)
    assert pb_.keys() == jb_.keys()
    for k in jb_:
        np.testing.assert_allclose(pb_[k].numpy(), np.asarray(jb_[k]),
                                   rtol=0, atol=1e-6)
    v = torch.from_numpy(rel[1])
    np.testing.assert_array_equal(pbasis.cart_to_deg1(v).numpy(),
                                  np.asarray(jbasis.cart_to_deg1(rel[1])))
    np.testing.assert_array_equal(
        pbasis.deg1_to_cart(pbasis.cart_to_deg1(v)).numpy(), rel[1])


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_matches_jax_fwd_and_grad(name):
    jf, pf = FAMILIES[name]
    jb, pb = unpadded(_graphs(name))
    jm, pm = jf(), pf()
    tree_matches_flax_init(jm, jb, pm)
    ref = jax_reference(jm, jb, flax_tree(pm))
    check_forward(pm, pb, ref, SE3_FWD_TOL)
    check_grads(pm, pb, ref, SE3_GRAD_TOL)


PADDED = dict(FAMILIES, SE3Transformer=(
    lambda: JaxSE3TransformerDynamics(nf=8, n_layers=1, num_degrees=2,
                                      n_heads=2),
    lambda: SE3TransformerDynamics(nf=8, n_layers=1, num_degrees=2,
                                   n_heads=2, generator=_gen())))


@pytest.mark.parametrize("name", ["TFN", "SE3Transformer", "FastTFN"])
def test_family_forward_matches_jax_on_a_padded_batch(name):
    """Padded nodes and edges masked as in JAX (the SE3Transformer at one
    layer: its masked attention softmax; the depth is held unpadded)."""
    jf, pf = PADDED[name]
    jb, pb = batches(_graphs(name, twin=False))
    jm, pm = jf(), pf()
    jx, jX = jax.jit(jm.apply)(flax_tree(pm), jb)
    check_forward(pm, pb, (np.asarray(jx), None if jX is None
                           else np.asarray(jX)), SE3_FWD_TOL)


@pytest.mark.parametrize("name", ["TFN", "SE3Transformer", "FastTFN"])
def test_family_is_equivariant(name):
    check_equivariance(FAMILIES[name][1](), _graphs(name, twin=False),
                       tol=1e-4)


def test_fast_tfn_gradients_are_finite_on_a_padded_batch():
    """A padded edge has zero length. The JAX package's FastTFN takes its
    square root's gradient there (0 * inf = NaN) once the positions depend
    on the parameters (every layer after the first); the port's
    ``basis.safe_norm`` gives the same forward and a zero gradient."""
    jf, pf = FAMILIES["FastTFN"]
    jb, pb = batches(_graphs("FastTFN", twin=False))
    assert float(pb.edge_mask.min()) == 0
    pm = pf()
    jg = jax.jit(jax.grad(lambda p, g: _loss_jax(jf())(p, g)[0]))(
        flax_tree(pm), jb)
    assert not all(np.isfinite(np.asarray(a)).all()
                   for a in jax.tree_util.tree_leaves(jg))
    _, grads = port_grads(pm, pb)
    assert all(torch.isfinite(g).all() for g in grads.values())
