"""Shared helpers of the model-family parity tests (``tests/test_torch_
models.py``, ``test_torch_se3.py``, ``test_torch_model_train.py``).

Each family is built in the port from a seeded generator; its parameters
become the flax tree at ``convert.flax_layout``'s paths (the JAX model
refuses a tree with a missing or misshapen parameter), the JAX model runs on
it, and the JAX gradients come back through ``convert.params_from_jax``.
Building the tree from the port avoids a flax ``init`` per family (seconds
each on the CPU); ``tree_matches_flax_init`` holds the paths and shapes
against a real init's (``jax.eval_shape``, no compute).

Comparisons are scale-normalized: the error over the largest |JAX value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distegnn_tpu.ops import graph as jgraph
from distegnn_tpu_torch.convert import flax_layout, params_from_jax
from distegnn_tpu_torch.ops import graph as pgraph
from test_torch_graph import plain_test_graph

# f32 bounds, scale-normalized: the same arithmetic in another summation
# order (tests/test_torch_plain_egnn.py's discipline); the SE(3) families
# contract through the kernel basis and LayerNorm, one decade looser
FWD_TOL, GRAD_TOL = 1e-6, 1e-5
SE3_FWD_TOL, SE3_GRAD_TOL = 1e-5, 1e-4


def small_graphs(seed=0, sizes=(24, 18), radius=0.5, node_feat_nf=2,
                 node_attr_nf=0):
    """Symmetric radius graphs of a few tens of nodes in the unit cube (of
    different sizes: the batch pads nodes and edges)."""
    return [plain_test_graph(seed + i, n=n, radius=radius,
                             node_feat_nf=node_feat_nf,
                             node_attr_nf=node_attr_nf)
            for i, n in enumerate(sizes)]


def twin_graphs(seed=0, n=24, radius=0.5, node_feat_nf=2, node_attr_nf=0):
    """Two graphs with the same edge list and different data: padded with
    ``node_bucket=edge_bucket=1`` the batch has no padded node or edge (the
    JAX package's FastSchNet, FastTFN and EGHN differentiate a zero-length
    padded edge or an all-zero padded node to NaN)."""
    g = plain_test_graph(seed, n=n, radius=radius, node_feat_nf=node_feat_nf,
                         node_attr_nf=node_attr_nf)
    rng = np.random.default_rng(seed + 100)
    h = {k: v.copy() for k, v in g.items()}
    for k in ("node_feat", "vel", "target", "edge_attr", "node_attr"):
        if k in h:
            h[k] = (h[k] + rng.normal(size=h[k].shape) * 0.1).astype(
                np.float32)
    h["loc"] = (g["loc"] + rng.normal(size=g["loc"].shape) * 0.02).astype(
        np.float32)
    return [g, h]


def batches(graphs, **kw):
    """The same graphs padded by both packages."""
    return (jgraph.pad_graphs([dict(g) for g in graphs], **kw),
            pgraph.pad_graphs([dict(g) for g in graphs], **kw))


def unpadded(graphs, **kw):
    return batches(graphs, node_bucket=1, edge_bucket=1, **kw)


def flax_tree(pm) -> dict:
    """The port model's parameters as the flax tree {"params": ...}."""
    root: dict = {}
    sd = dict(pm.named_parameters())
    for name, path, transposed in flax_layout(pm):
        a = sd[name].detach().numpy()
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(a.T if transposed else a)
    return {"params": root}


def tree_matches_flax_init(jm, jb, pm):
    """The flax tree of ``pm`` has exactly the paths and shapes of the JAX
    model's own init."""
    shapes = {"params": jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                       jb)["params"]}
    want = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
            jax.tree_util.tree_leaves_with_path(shapes)}
    got = {jax.tree_util.keystr(k): tuple(np.shape(v)) for k, v in
           jax.tree_util.tree_leaves_with_path(flax_tree(pm))}
    assert got == want


def _loss_jax(jm):
    def loss(p, jb):
        x, X = jm.apply(p, jb)
        out = jnp.sum((x - jb.target) ** 2 * jb.node_mask[..., None])
        if X is not None:
            out = out + 0.1 * jnp.sum(X ** 2)
        return out, (x, X)

    return loss


def port_loss(pm, pb):
    x, X = pm(pb)
    out = torch.sum((x - pb.target) ** 2 * pb.node_mask[..., None])
    return out + 0.1 * torch.sum(X ** 2) if X is not None else out


def jax_reference(jm, jb, params):
    """(x, X or None, loss, grads tree) of the JAX model: one jitted
    value_and_grad."""
    (jl, (x, X)), jg = jax.jit(jax.value_and_grad(_loss_jax(jm),
                                                  has_aux=True))(params, jb)
    return (np.asarray(x), None if X is None else np.asarray(X), float(jl),
            jax.tree_util.tree_map(np.asarray, jg))


def scaled_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


def check_forward(pm, pb, ref, tol=FWD_TOL):
    """The port's forward against the JAX reference on the real nodes."""
    with torch.no_grad():
        x, X = pm(pb)
    mask = pb.node_mask.numpy() > 0
    assert np.isfinite(x.numpy()).all()
    err = scaled_err(x.numpy()[mask], ref[0][mask])
    assert err <= tol, f"forward x: {err:.3e} > {tol:.0e}"
    if ref[1] is not None:
        assert X is not None
        errX = scaled_err(X.numpy(), ref[1])
        assert errX <= tol, f"forward X: {errX:.3e} > {tol:.0e}"
        err = max(err, errX)
    else:
        assert X is None
    return err


def port_grads(pm, pb):
    """(loss, {name: gradient}) of the port model, zeros where no loss term
    reaches a parameter."""
    pm.zero_grad(set_to_none=True)
    loss = port_loss(pm, pb)
    loss.backward()
    return float(loss.detach()), {
        k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
        for k, p in pm.named_parameters()}


def check_grads(pm, pb, ref, tol=GRAD_TOL):
    """Every parameter's gradient against JAX's, over the largest |JAX
    gradient| of the model; the loss to 1e-5 relative."""
    want = params_from_jax(ref[3], pm)
    loss, got = port_grads(pm, pb)
    np.testing.assert_allclose(loss, ref[2], rtol=1e-5)
    assert want.keys() == got.keys()
    scale = max(float(np.abs(g.numpy()).max()) for g in want.values())
    worst = 0.0
    for k, w in want.items():
        assert torch.isfinite(got[k]).all(), k
        err = float(np.abs(w.numpy() - got[k].numpy()).max()) / scale
        assert err <= tol, f"{k}: {err:.3e} > {tol:.0e}"
        worst = max(worst, err)
    return worst


def rotation(seed):
    """A random proper rotation (numpy QR) and a translation."""
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32), rng.normal(size=3).astype(np.float32)


def transformed(graphs, R, t):
    out = []
    for g in graphs:
        g = dict(g)
        g["loc"] = (g["loc"] @ R + t).astype(np.float32)
        g["vel"] = (g["vel"] @ R).astype(np.float32)
        g["target"] = (g["target"] @ R + t).astype(np.float32)
        out.append(g)
    return out


def check_equivariance(pm, graphs, tol=1e-4, **pad):
    """pm(x R + t) == pm(x) R + t on the real nodes (and on the virtual
    coordinates), f32, on a padded batch."""
    R, t = rotation(7)
    pb = pgraph.pad_graphs([dict(g) for g in graphs], **pad)
    pr = pgraph.pad_graphs(transformed(graphs, R, t), **pad)
    with torch.no_grad():
        x, X = pm(pb)
        xr, Xr = pm(pr)
    mask = pb.node_mask.numpy() > 0
    Rt, tt = torch.from_numpy(R), torch.from_numpy(t)
    err = float((x @ Rt + tt - xr).abs().numpy()[mask].max())
    assert err <= tol, f"equivariance: {err:.3e} > {tol:.0e}"
    if X is not None:
        errX = float((Rt.T @ X + tt[:, None] - Xr).abs().max())
        assert errX <= tol, f"virtual equivariance: {errX:.3e}"
    return err
