"""The port's fused-stack megakernel path (``distegnn_tpu_torch/ops/
layer_pipeline.py`` and ``FastEGNN(edge_impl='fused_stack')``) against the
JAX package's, on the CPU, where the port runs the kernel's plain version
``fused_egnn_stack_ref`` and JAX its Pallas megakernel in interpret mode.

The workload is the JAX package's own megakernel workload
(tests/test_layer_pipeline.py), regenerated here with node attributes: one
graph of 4 real node blocks of 512 padded to 5 (a trailing all-padding
block), ~10 % far-block edges (a remote tail), H=16, C=2, A=2, gravity
(0, 0, -9.8). Interpret mode is slow (~4 s a forward, ~30 s a gradient), so
each JAX reference runs once, in a module-scoped fixture.

Tolerances: f32 <= 1e-5 of each output's scale (max |JAX|), gradients <=
1e-5 of the largest gradient. Both sides round at the same points (bf16
hi + lo translations and bf16 edge features in the in-window sums); the
summation order of sums and products differs. bf16: the mean abs error <=
2^-9 of scale (measured <= 5.7e-4) and the max <= 2^-7, one bf16 ulp of
the output's largest entry (measured 3.6e-3). Both sides round every
message-MLP product and bias add to bf16, but XLA on the CPU keeps excess
precision inside fused elementwise chains (silu of a bias add) where the
port rounds each op, so single bf16 ulps of MLP outputs differ; gravity
(-9.8 times phi_g's bf16 output) carries such a flip into x.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distegnn_tpu.models.fast_egnn import FastEGNN as JaxFastEGNN
from distegnn_tpu.ops import layer_pipeline as JL
from distegnn_tpu.ops.graph import pad_graphs as jax_pad_graphs
from distegnn_tpu_torch import config as pconfig
from distegnn_tpu_torch.convert import params_from_jax
from distegnn_tpu_torch.models.fast_egnn import FastEGNN
from distegnn_tpu_torch.ops import edge_pipeline as PE
from distegnn_tpu_torch.ops import layer_pipeline as PL
from distegnn_tpu_torch.ops.graph import pad_graphs
from distegnn_tpu_torch.train.step import make_loss_fn
from test_torch_fast_egnn import numpy_params

BLOCK = 512
N_REAL = 4 * BLOCK
N_PAD = 5 * BLOCK
H, C, A = 16, 2, 2
GRAVITY = (0.0, 0.0, -9.8)
TOL = 1e-5
TOL_BF16_MEAN, TOL_BF16_MAX = 2 ** -9, 2 ** -7


def stack_graph(seed, n_real=N_REAL):
    """tests/test_layer_pipeline.py's graph (near-diagonal edges, ~10 %
    into a far block) with 2 node attributes; ``n_real`` nodes (the last
    block partly filled when it is not a multiple of the block)."""
    rng = np.random.default_rng(seed)
    nblk = -(-n_real // BLOCK)
    rows, cols = [], []
    for b in range(nblk):
        r = rng.integers(b * BLOCK, min((b + 1) * BLOCK, n_real), size=384)
        near = rng.integers(max(0, (b - 1) * BLOCK),
                            min(n_real, (b + 2) * BLOCK), size=384)
        far_block = (b + 3) % nblk
        far = rng.integers(far_block * BLOCK,
                           min((far_block + 1) * BLOCK, n_real), size=384)
        c = np.where(rng.uniform(size=384) < 0.1, far, near)
        rows.append(r)
        cols.append(c)
    row, col = np.concatenate(rows), np.concatenate(cols)
    order = np.argsort(row, kind="stable")
    ei = np.stack([row[order], col[order]]).astype(np.int64)
    e = ei.shape[1]
    return {
        "node_feat": rng.normal(size=(n_real, 2)).astype(np.float32),
        "node_attr": rng.normal(size=(n_real, A)).astype(np.float32),
        "loc": rng.uniform(0, 1, size=(n_real, 3)).astype(np.float32),
        "vel": (rng.normal(size=(n_real, 3)) * 0.05).astype(np.float32),
        "target": rng.uniform(0, 1, size=(n_real, 3)).astype(np.float32),
        "edge_index": ei,
        "edge_attr": rng.normal(size=(e, 2)).astype(np.float32),
    }


def _cfg(L, dtype_name="f32", gravity=True, **kw):
    return dict(n_layers=L, block=BLOCK, hidden=H, channels=C,
                node_attr_nf=A, has_gravity=gravity, dtype_name=dtype_name,
                **kw)


def _weights(cfg_kw, seed):
    """{key: [L, a, b]} f32 at the model's init scales (coordinate heads at
    1e-3 xavier, the rest at 1/sqrt(fan_in))."""
    rng = np.random.default_rng(seed)
    L = cfg_kw["n_layers"]
    out = {}
    for k, (a, b) in PL.stack_weight_shapes(PL.StackConfig(**cfg_kw)).items():
        if k in ("e_w4", "xv_k1", "X_k1"):
            s = 1e-3 * np.sqrt(6.0 / (H + 1))
        else:
            s = 1.0 / np.sqrt(a if a > 1 else b)
        out[k] = rng.uniform(-s, s, size=(L, a, b)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def graph_inputs():
    """Numpy operands of one graph: the node state, the edge layout of the
    port's pad_graphs + build_edge_blocks, the remote list."""
    g = stack_graph(0)
    pb = pad_graphs([g], max_nodes=N_PAD, edge_block=BLOCK,
                    edges_per_block=BLOCK, split_remote=True)
    assert pb.max_nodes == N_PAD and float(pb.remote_edge_mask.sum()) > 0
    arrs = PE.build_edge_blocks(pb.row, pb.col, pb.edge_attr, pb.edge_mask,
                                block=BLOCK, n_nodes=N_PAD)
    rng = np.random.default_rng(5)
    nm = pb.node_mask[0].numpy()
    ops = {
        "h0": (rng.normal(size=(N_PAD, H)) * nm[:, None]).astype(np.float32),
        "x0": pb.loc[0].numpy(), "v": pb.vel[0].numpy(),
        "X0": np.repeat(pb.loc_mean[0].numpy()[:, None], C, axis=1),
        "Hv0": rng.normal(size=(H, C)).astype(np.float32),
        "node_mask": nm, "node_attr": pb.node_attr[0].numpy(),
        "gravity": np.asarray(GRAVITY, np.float32),
        "edge_arrs": tuple(a[0].numpy() for a in arrs),
        "remote_arrs": (pb.remote_edge_index[0, 0].numpy(),
                        pb.remote_edge_index[0, 1].numpy(),
                        pb.remote_edge_attr[0].numpy(),
                        pb.remote_edge_mask[0].numpy()),
    }
    return ops


_ORDER = ("h0", "x0", "v", "X0", "Hv0", "node_mask", "node_attr", "gravity",
          "edge_arrs", "remote_arrs")


def _jax_stack(cfg_kw, ops, w):
    cfg = JL.StackConfig(**cfg_kw)
    args = [jax.tree_util.tree_map(jnp.asarray, ops[k]) for k in _ORDER]
    fwd = jax.jit(lambda *a: JL._stack_fwd_impl(cfg, *a),)
    out, cks = fwd(*args, {k: jnp.asarray(a) for k, a in w.items()})
    return [np.asarray(a) for a in out], [np.asarray(a) for a in cks]


def _port_args(ops, w):
    args = [torch.from_numpy(np.ascontiguousarray(ops[k]))
            if not isinstance(ops[k], tuple)
            else tuple(torch.from_numpy(np.ascontiguousarray(a))
                       for a in ops[k]) for k in _ORDER]
    return args, {k: torch.from_numpy(a) for k, a in w.items()}


FWD_CASES = {"f32-L1": (1, "f32"), "f32-L2": (2, "f32"),
             "bf16-L2": (2, "bf16")}


@pytest.fixture(scope="module")
def jax_forwards(graph_inputs):
    """JAX fused_egnn_stack (outputs + checkpoints) once per case."""
    out = {}
    for name, (L, dname) in FWD_CASES.items():
        cfg_kw = _cfg(L, dname)
        w = _weights(cfg_kw, seed=L)
        out[name] = (cfg_kw, w, _jax_stack(cfg_kw, graph_inputs, w))
    return out


def _scaled_err(a, b, reduce=np.max):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(reduce(np.abs(a - b))) / max(float(np.abs(b).max()), 1e-30)


def _assert_close(label, a, b, dtype_name):
    """f32: max abs error <= TOL of scale; bf16: mean <= 2^-9 and max <=
    2^-7 of scale (see the module docstring)."""
    assert a.shape == b.shape and np.isfinite(a).all(), label
    if dtype_name == "f32":
        err = _scaled_err(a, b)
        assert err <= TOL, f"{label}: {err:.3e} > {TOL:.1e}"
        return
    mean, mx = _scaled_err(a, b, np.mean), _scaled_err(a, b)
    assert mean <= TOL_BF16_MEAN and mx <= TOL_BF16_MAX, \
        f"{label}: mean {mean:.3e}, max {mx:.3e}"


# ----------------------------------------------------------- (a) host half

@pytest.mark.parametrize("L, dname, A_, grav", [
    (1, "f32", 0, False), (2, "bf16", 2, True), (4, "bf16", 2, False),
    (4, "f32", 5, True)])
@pytest.mark.parametrize("N, E, R, Hh, Cc", [
    (1536, 19_968, 128, 64, 3), (113_152, 1_639_424, 8192, 64, 3),
    (2560, 2560, 256, 16, 2), (4096, 61_440, 1024, 32, 4)])
def test_host_half_returns_the_jax_integers(L, dname, A_, grav, N, E, R,
                                            Hh, Cc):
    kw = dict(n_layers=L, block=BLOCK, hidden=Hh, channels=Cc,
              node_attr_nf=A_, has_gravity=grav, dtype_name=dname)
    pc, jc = PL.StackConfig(**kw), JL.StackConfig(**kw)
    assert PL.stack_weight_shapes(pc) == JL.stack_weight_shapes(jc)
    assert PL.SCALAR_NF == JL.SCALAR_NF
    dims = dict(n_nodes=N, n_edges=E, remote_pad=R)
    assert (PL.estimate_stack_vmem_bytes(pc, **dims)
            == JL.estimate_stack_vmem_bytes(jc, **dims))
    for impl in ("fused_stack", "fused", "plain"):
        kw2 = dict(n_nodes=N, n_edges=E, hidden=Hh, channels=Cc,
                   n_layers=L, remote_pad=R, node_attr_nf=A_,
                   dtype_name=dname)
        assert (PL.hbm_bytes_per_step(impl, **kw2)
                == JL.hbm_bytes_per_step(impl, **kw2))
    try:
        want = JL.check_stack_vmem(jc, **dims)
    except JL.StackVmemBudgetError as e:
        with pytest.raises(PL.StackVmemBudgetError) as ei:
            PL.check_stack_vmem(pc, **dims)
        assert str(ei.value) == str(e)
    else:
        assert PL.check_stack_vmem(pc, **dims) == want


def test_budget_bounds_match_jax():
    """The flagship shape fails with the typed error, the 1536-node cap
    shape passes (the JAX package's test_check_stack_vmem_bounds)."""
    assert PL.DEFAULT_STACK_VMEM_BUDGET == JL.DEFAULT_STACK_VMEM_BUDGET
    cfg = PL.StackConfig(n_layers=4, block=512, hidden=64, channels=3,
                         node_attr_nf=2, dtype_name="bf16")
    with pytest.raises(PL.StackVmemBudgetError) as ei:
        PL.check_stack_vmem(cfg, n_nodes=113_152, n_edges=1_639_424,
                            remote_pad=8192)
    assert f"{PL.DEFAULT_STACK_VMEM_BUDGET / 2**20:.1f} MiB" in str(ei.value)
    assert issubclass(PL.StackVmemBudgetError, ValueError)
    PL.check_stack_vmem(cfg, n_nodes=1536, n_edges=19_968, remote_pad=128)


# ------------------------------------------------------ (b) the function

@pytest.mark.parametrize("case", list(FWD_CASES))
def test_stack_forward_and_checkpoints_match_jax(graph_inputs, jax_forwards,
                                                 case):
    cfg_kw, w, (jout, jcks) = jax_forwards[case]
    args, wt = _port_args(graph_inputs, w)
    before = PL.fused_egnn_stack.launches
    with torch.no_grad():
        out = PL.fused_egnn_stack(PL.StackConfig(**cfg_kw), *args, wt)
        ref_out, cks = PL.fused_egnn_stack_ref(PL.StackConfig(**cfg_kw),
                                               *args, wt)
    assert PL.fused_egnn_stack.launches == before   # the CPU: plain version
    dname = cfg_kw["dtype_name"]
    names = ("h", "x", "X", "Hv")
    for name, a, r, b in zip(names, out, ref_out, jout):
        assert torch.equal(a, r), name
        _assert_close(f"{case} {name}", a.numpy(), b, dname)
    L = cfg_kw["n_layers"]
    for name, a, b in zip(names, cks, jcks):
        assert a.shape[0] == L
        _assert_close(f"{case} checkpoint {name}", a.numpy(), b, dname)
    # layer 0's checkpoint is the input state itself
    np.testing.assert_array_equal(cks[0][0].numpy(), graph_inputs["h0"])


def test_stack_forward_takes_the_remote_tail_and_gravity(graph_inputs,
                                                         jax_forwards):
    """Dropping the remote tail or gravity moves the result far beyond the
    tolerance: both are part of what the parity above holds."""
    cfg_kw, w, (jout, _) = jax_forwards["f32-L1"]
    args, wt = _port_args(graph_inputs, w)
    rr, rc, ra, rm = args[-1]
    no_remote = list(args[:-1]) + [(rr, rc, ra, torch.zeros_like(rm))]
    with torch.no_grad():
        a = PL.fused_egnn_stack_ref(PL.StackConfig(**cfg_kw), *no_remote,
                                    wt)[0]
        b = PL.fused_egnn_stack_ref(
            PL.StackConfig(**_cfg(1, gravity=False)), *args,
            {k: v for k, v in wt.items() if not k.startswith("g_")})[0]
    assert _scaled_err(a[0].numpy(), jout[0]) > 100 * TOL
    assert _scaled_err(b[1].numpy(), jout[1]) > 100 * TOL


# --------------------------------------------------- (c) the gradients

@pytest.fixture(scope="module")
def jax_grads(graph_inputs):
    cfg_kw = _cfg(2, "f32")
    w = _weights(cfg_kw, seed=2)
    rng = np.random.default_rng(9)
    cts = [rng.normal(size=s).astype(np.float32)
           for s in ((N_PAD, H), (N_PAD, 3), (3, C), (H, C))]
    cfg = JL.StackConfig(**cfg_kw)
    consts = [jax.tree_util.tree_map(jnp.asarray, graph_inputs[k])
              for k in _ORDER[5:]]

    def loss(h0, x0, v, X0, Hv0, ws):
        out = JL.fused_egnn_stack(cfg, h0, x0, v, X0, Hv0, *consts, ws)
        return sum(jnp.sum(o * ct) for o, ct in zip(out, cts))

    diff = [jnp.asarray(graph_inputs[k]) for k in _ORDER[:5]]
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5)))(
        *diff, {k: jnp.asarray(a) for k, a in w.items()})
    return cfg_kw, w, cts, jax.tree_util.tree_map(np.asarray, grads)


def test_stack_gradients_match_jax_grad(graph_inputs, jax_grads):
    """The port's backward walk (each layer rerun from its checkpoint
    through _layer_ref, fused_edge_layer's plain backward on the CPU)
    against jax.grad of the JAX custom VJP, L=2, f32."""
    cfg_kw, w, cts, jg = jax_grads
    jd, jw = jg[:5], jg[5]
    args, wt = _port_args(graph_inputs, w)
    diff = [a.clone().requires_grad_() for a in args[:5]]
    wt = {k: a.clone().requires_grad_() for k, a in wt.items()}
    out = PL.fused_egnn_stack(PL.StackConfig(**cfg_kw), *diff, *args[5:], wt)
    loss = sum((o * torch.from_numpy(ct)).sum() for o, ct in zip(out, cts))
    got = torch.autograd.grad(loss, diff + list(wt.values()))
    want = list(jd) + [jw[k] for k in wt]
    names = list(_ORDER[:5]) + list(wt)
    scale = max(float(np.abs(g).max()) for g in want)
    assert scale > 0
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        err = float(np.abs(a.numpy() - b).max())
        assert err <= TOL * scale, f"{name}: {err:.3e} > {TOL * scale:.3e}"


# --------------------------------------------------- (d) the model

def _model_batches():
    g = stack_graph(1)
    kw = dict(max_nodes=N_PAD, edge_block=BLOCK, split_remote=True)
    jb = jax_pad_graphs([g], compute_pair=False, **kw)
    return jb, pad_graphs([g], **kw)


def _port_model(edge_impl, L, gravity=GRAVITY, **kw):
    return FastEGNN(node_feat_nf=2, node_attr_nf=A, edge_attr_nf=2,
                    hidden_nf=H, virtual_channels=C, n_layers=L,
                    gravity=gravity, edge_impl=edge_impl, **kw)


@pytest.fixture(scope="module")
def jax_model_forward():
    jb, pb = _model_batches()
    jm = JaxFastEGNN(node_feat_nf=2, node_attr_nf=A, edge_attr_nf=2,
                     hidden_nf=H, virtual_channels=C, n_layers=2,
                     gravity=GRAVITY, edge_impl="fused_stack")
    params = numpy_params(jm, jb, 4)
    jx, jX = jax.jit(jm.apply)(params, jb)
    return jb, pb, params, np.asarray(jx), np.asarray(jX)


def test_model_converts_loads_strictly_and_matches_jax(jax_model_forward):
    jb, pb, params, jx, jX = jax_model_forward
    sd = params_from_jax(params)
    pm = _port_model("fused_stack", 2)
    pm.load_state_dict(sd, strict=True)
    assert any(".phi_g." in k for k in sd)
    with torch.no_grad():
        px, pX = pm(pb)
    m = np.asarray(jb.node_mask) > 0
    np.testing.assert_allclose(px.numpy()[m], jx[m], rtol=0, atol=TOL)
    np.testing.assert_allclose(pX.numpy(), jX, rtol=0, atol=TOL)
    np.testing.assert_array_equal(px.numpy()[~m], 0.0)

    # the same state_dict under edge_impl='fused': the same results
    pf = _port_model("fused", 2)
    pf.load_state_dict(pm.state_dict(), strict=True)
    with torch.no_grad():
        fx, fX = pf(pb)
    np.testing.assert_allclose(px.numpy(), fx.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pX.numpy(), fX.numpy(), rtol=0, atol=1e-6)


def test_fused_and_fused_stack_share_the_state_dict():
    a = _port_model("fused", 2, generator=torch.Generator().manual_seed(3))
    b = _port_model("fused_stack", 2,
                    generator=torch.Generator().manual_seed(3))
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = b.stacked_weights()
    assert {k: tuple(t.shape[1:]) for k, t in w.items()} == \
        PL.stack_weight_shapes(b.stack_config(_model_batches()[1]))


@pytest.mark.parametrize("edge_impl", ["plain", "fused"])
def test_gravity_matches_jax(edge_impl):
    """The gravity head phi_g in EGCLVel, L=1, against the JAX package's."""
    g = stack_graph(2)
    if edge_impl == "plain":
        g = dict(g, edge_index=g["edge_index"][:, :400],
                 edge_attr=g["edge_attr"][:400])
        kw = dict(compute_pair=False)
        pkw = {}
    else:
        kw = dict(max_nodes=N_PAD, edge_block=BLOCK, split_remote=True,
                  compute_pair=False)
        pkw = dict(max_nodes=N_PAD, edge_block=BLOCK, split_remote=True)
    jb = jax_pad_graphs([g], **kw)
    pb = pad_graphs([g], **pkw)
    jm = JaxFastEGNN(node_feat_nf=2, node_attr_nf=A, edge_attr_nf=2,
                     hidden_nf=H, virtual_channels=C, n_layers=1,
                     gravity=GRAVITY, edge_impl=edge_impl)
    params = numpy_params(jm, jb, 6)
    jx, jX = (np.asarray(a) for a in jax.jit(jm.apply)(params, jb))
    pm = _port_model(edge_impl, 1)
    pm.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        px, pX = pm(pb)
    m = np.asarray(jb.node_mask) > 0
    np.testing.assert_allclose(px.numpy()[m], jx[m], rtol=0, atol=TOL)
    np.testing.assert_allclose(pX.numpy(), jX, rtol=0, atol=TOL)
    # and gravity moves the answer: without it the port differs
    p0 = _port_model(edge_impl, 1, gravity=None)
    p0.load_state_dict({k: v for k, v in params_from_jax(params).items()
                        if ".phi_g." not in k}, strict=True)
    with torch.no_grad():
        assert float((p0(pb)[0] - px).abs().max()) > 100 * TOL


# --------------------------------------------------- (e) guard rails

def test_budget_error_before_any_launch_with_the_jax_message():
    jb, pb = _model_batches()
    kw = dict(node_feat_nf=2, node_attr_nf=A, edge_attr_nf=2, hidden_nf=H,
              virtual_channels=C, n_layers=2, gravity=GRAVITY,
              edge_impl="fused_stack")
    params = numpy_params(JaxFastEGNN(**kw), jb, 0)
    jm = JaxFastEGNN(stack_vmem_budget=1024, **kw)
    with pytest.raises(JL.StackVmemBudgetError) as je:
        jm.apply(params, jb)
    pm = _port_model("fused_stack", 2, stack_vmem_budget=1024)
    pm.load_state_dict(params_from_jax(params), strict=True)
    before = PE.fused_edge_layer.launches
    with pytest.raises(PL.StackVmemBudgetError) as pe:
        with torch.no_grad():
            pm(pb)
    assert str(pe.value) == str(je.value)
    assert "edge_impl='fused'" in str(pe.value)
    assert PE.fused_edge_layer.launches == before


@pytest.mark.parametrize("kw", [{"attention": True}, {"normalize": True},
                                {"tanh": True}, {"edge_attr_nf": 3},
                                {"n_layers": 0}])
def test_model_guard_rails_have_the_jax_messages(kw):
    """The fused_stack model constraints, raised with the JAX package's
    messages (the JAX model raises when applied, the port's when built)."""
    jb, _ = _model_batches()
    base = dict(node_feat_nf=2, node_attr_nf=A, edge_attr_nf=2, hidden_nf=H,
                virtual_channels=C, n_layers=1, edge_impl="fused_stack")
    jkw = dict(base, **kw)
    with pytest.raises(ValueError) as je:
        JaxFastEGNN(**jkw).init(jax.random.PRNGKey(0), jb)
    with pytest.raises(ValueError) as pe:
        FastEGNN(**jkw)
    assert str(pe.value) == str(je.value)


def test_unsplit_batch_raises_with_the_jax_message():
    g = stack_graph(3)
    kw = dict(max_nodes=N_PAD, edge_block=BLOCK)
    jb = jax_pad_graphs([g], compute_pair=False, **kw)
    pb = pad_graphs([g], **kw)
    assert pb.remote_edge_index is None
    jm = JaxFastEGNN(node_feat_nf=2, node_attr_nf=A, edge_attr_nf=2,
                     hidden_nf=H, virtual_channels=C, n_layers=1,
                     edge_impl="fused_stack")
    with pytest.raises(ValueError, match="split_remote") as je:
        jm.init(jax.random.PRNGKey(0), jb)
    with pytest.raises(ValueError, match="split_remote") as pe:
        _port_model("fused_stack", 1, gravity=None)(pb)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("section, key, value, match", [
    ("model", "n_layers", 0, "n_layers >= 1"),
    ("model", "stack_vmem_budget", -1, "stack_vmem_budget must be >= 0"),
    ("data", "edge_block", 256, "edge_block >= 512"),
    ("model", "normalize", True, "normalize")])
def test_config_checks_match_jax(tmp_path, section, key, value, match):
    """configs/fluid_fused_stack.yaml with one bad key: the port's
    load_config raises the JAX package's error."""
    import yaml

    from distegnn_tpu import config as jconfig

    with open("configs/fluid_fused_stack.yaml") as f:
        raw = yaml.safe_load(f)
    raw[section][key] = value
    path = tmp_path / "bad.yaml"
    path.write_text(yaml.safe_dump(raw))
    with pytest.raises(ValueError, match=match) as je:
        jconfig.load_config(str(path))
    with pytest.raises(ValueError, match=match) as pe:
        pconfig.load_config(str(path))
    assert str(pe.value) == str(je.value)


def test_published_config_builds_the_stack_model():
    from distegnn_tpu_torch.models.registry import get_model

    cfg = pconfig.load_config("configs/fluid_fused_stack.yaml")
    m = get_model(cfg.model)
    assert m.edge_impl == "fused_stack" and m.stack_vmem_budget == 0
    assert all(layer.edge_impl == "fused" for layer in m.gcl)


# --------------------------------------------------- (f) a train micro-step

def test_train_micro_step_matches_fused():
    """One micro-step (MSE + MMD, backward) of the port's fused_stack model
    against the same step under edge_impl='fused': loss and every
    parameter's gradient."""
    _, pb = _model_batches()
    gen = torch.Generator().manual_seed(11)
    models = {"fused_stack": _port_model("fused_stack", 2, generator=gen)}
    models["fused"] = _port_model("fused", 2)
    models["fused"].load_state_dict(models["fused_stack"].state_dict())
    res = {}
    for impl, m in models.items():
        # samples * C >= N: the deterministic MMD branch, no draw
        loss, _ = make_loss_fn(m, 0.03, 1.5, -(-N_PAD // C))(pb)
        loss.backward()
        res[impl] = (float(loss.detach()),
                     {k: p.grad.clone() if p.grad is not None
                      else torch.zeros_like(p)
                      for k, p in m.named_parameters()})
    (ls, gs), (lf, gf) = res["fused_stack"], res["fused"]
    assert abs(ls - lf) <= TOL * abs(lf)
    scale = max(float(g.abs().max()) for g in gf.values())
    for k in gf:
        err = float((gs[k] - gf[k]).abs().max())
        assert err <= TOL * scale, f"{k}: {err:.3e}"
    assert sum(float(g.abs().max()) > 0 for g in gs.values()) > len(gs) // 2


# ------------------------------------------ (g) the graph-batch axis

# two graphs of different sizes and edge sets in one padded batch: a
# cross-graph indexing fault cannot hide behind replicas
BATCH_SIZES = (N_REAL, 3 * BLOCK - 37)


def _batch_graphs():
    return [stack_graph(20 + i, n) for i, n in enumerate(BATCH_SIZES)]


def _batch_operands(dtype_name):
    """A B=2 batch's megakernel operands (torch, CPU) in
    fused_egnn_stack_batch's layout, and its weights."""
    pb = pad_graphs(_batch_graphs(), max_nodes=N_PAD, edge_block=BLOCK,
                    split_remote=True)
    assert float(pb.remote_edge_mask.sum()) > 0
    arrs = PE.build_edge_blocks(pb.row, pb.col, pb.edge_attr, pb.edge_mask,
                                block=BLOCK, n_nodes=N_PAD)
    rng = np.random.default_rng(8)
    nm = pb.node_mask
    B = nm.shape[0]
    h0 = torch.from_numpy(rng.normal(size=(B, N_PAD, H))
                          .astype(np.float32)) * nm[..., None]
    Hv0 = torch.from_numpy(rng.normal(size=(B, H, C)).astype(np.float32))
    ops = (h0, pb.loc, pb.vel, pb.loc_mean[:, :, None].repeat(1, 1, C), Hv0,
           nm, pb.node_attr, torch.tensor(GRAVITY), tuple(arrs),
           (pb.remote_edge_index[:, 0], pb.remote_edge_index[:, 1],
            pb.remote_edge_attr, pb.remote_edge_mask))
    cfg_kw = _cfg(2, dtype_name)
    w = {k: torch.from_numpy(a) for k, a in _weights(cfg_kw, seed=7).items()}
    return PL.StackConfig(**cfg_kw), ops, w


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_batched_plain_version_is_the_per_graph_plain_version(dtype_name):
    """fused_egnn_stack_batch_ref (and fused_egnn_stack_batch, which runs it
    on the CPU) over two graphs of different sizes: graph b's outputs and
    checkpoints are exactly fused_egnn_stack_ref's on graph b alone."""
    cfg, ops, w = _batch_operands(dtype_name)
    with torch.no_grad():
        out, cks = PL.fused_egnn_stack_batch_ref(cfg, *ops, w)
        via = PL.fused_egnn_stack_batch(cfg, *ops, w)
    L = cfg.n_layers
    for b, n in enumerate(BATCH_SIZES):
        g = PL._graph(b, *ops[:7], ops[8], ops[9])
        with torch.no_grad():
            ref, ref_cks = PL.fused_egnn_stack_ref(cfg, *g[:7], ops[7],
                                                   *g[7:], w)
        for a, r in zip(out, ref):
            assert torch.equal(a[b], r)
        for a, r in zip(via, ref):
            assert torch.equal(a[b], r)
        for a, r in zip(cks, ref_cks):
            assert a.shape[:2] == (2, L) and torch.equal(a[b], r)
        assert float(ops[5][b].sum()) == n
    # the two graphs' answers differ (no replica hides a mix-up)
    assert float((out[1][0] - out[1][1]).abs().max()) > 1e-2


@pytest.fixture(scope="module")
def jax_model_batch_forward():
    kw = dict(max_nodes=N_PAD, edge_block=BLOCK, split_remote=True)
    gs = _batch_graphs()
    jb = jax_pad_graphs(gs, compute_pair=False, **kw)
    jm = JaxFastEGNN(node_feat_nf=2, node_attr_nf=A, edge_attr_nf=2,
                     hidden_nf=H, virtual_channels=C, n_layers=2,
                     gravity=GRAVITY, edge_impl="fused_stack")
    params = numpy_params(jm, jb, 12)
    jx, jX = jax.jit(jm.apply)(params, jb)
    return jb, pad_graphs(gs, **kw), params, np.asarray(jx), np.asarray(jX)


def test_model_batch_of_two_graphs_matches_jax(jax_model_batch_forward):
    """FastEGNN(edge_impl='fused_stack') on a B=2 batch of different graphs
    (one megakernel call for the batch) against the JAX model (one per
    graph) on the same converted parameters."""
    jb, pb, params, jx, jX = jax_model_batch_forward
    pm = _port_model("fused_stack", 2)
    pm.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        px, pX = pm(pb)
    m = np.asarray(jb.node_mask) > 0
    assert px.shape[0] == 2 and m[0].sum() != m[1].sum()
    np.testing.assert_allclose(px.numpy()[m], jx[m], rtol=0, atol=TOL)
    np.testing.assert_allclose(pX.numpy(), jX, rtol=0, atol=TOL)
    np.testing.assert_array_equal(px.numpy()[~m], 0.0)


def test_train_micro_step_batch_of_two_graphs_matches_fused():
    """One micro-step (MSE + MMD, backward) of the fused_stack model on a
    B=2 batch of different graphs (the backward walks each graph's layers)
    against the same step under edge_impl='fused': loss and every
    parameter's gradient."""
    pb = pad_graphs(_batch_graphs(), max_nodes=N_PAD, edge_block=BLOCK,
                    split_remote=True)
    gen = torch.Generator().manual_seed(13)
    models = {"fused_stack": _port_model("fused_stack", 2, generator=gen)}
    models["fused"] = _port_model("fused", 2)
    models["fused"].load_state_dict(models["fused_stack"].state_dict())
    res = {}
    for impl, m in models.items():
        loss, _ = make_loss_fn(m, 0.03, 1.5, -(-N_PAD // C))(pb)
        loss.backward()
        res[impl] = (float(loss.detach()),
                     {k: p.grad.clone() if p.grad is not None
                      else torch.zeros_like(p)
                      for k, p in m.named_parameters()})
    (ls, gs), (lf, gf) = res["fused_stack"], res["fused"]
    assert abs(ls - lf) <= TOL * abs(lf)
    scale = max(float(g.abs().max()) for g in gf.values())
    for k in gf:
        err = float((gs[k] - gf[k]).abs().max())
        assert err <= TOL * scale, f"{k}: {err:.3e}"
    assert sum(float(g.abs().max()) > 0 for g in gs.values()) > len(gs) // 2


# --------------------------------------------- the entry points on the CPU

def _scene(n, seed, radius):
    from distegnn_tpu_torch.ops.order import morton_perm, reorder_graph
    from distegnn_tpu_torch.ops.radius import radius_graph_np

    rng = np.random.default_rng(seed)
    loc = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 0.05).astype(np.float32)
    ei = radius_graph_np(loc, radius)
    d = np.linalg.norm(loc[ei[0]] - loc[ei[1]], axis=1)[:, None]
    g = {"node_feat": np.linalg.norm(vel, axis=1, keepdims=True),
         "node_attr": np.ones((n, 2), np.float32), "loc": loc, "vel": vel,
         "target": loc + vel, "edge_index": ei.astype(np.int32),
         "edge_attr": np.repeat(d, 2, axis=1).astype(np.float32)}
    return reorder_graph(g, morton_perm(loc))


def test_serving_fused_stack_on_cpu_matches_fused_and_raises_over_budget():
    """configs/nbody_serve.yaml + fused_stack through the serving entry
    point (published width, plain version on the CPU): the same answers as
    the same weights under edge_impl='fused'; an over-budget rung raises the
    typed error out of predict."""
    from distegnn_tpu_torch.serve import engine_with_params_from_config

    path = "configs/nbody_serve.yaml"
    ov = {"model.edge_impl": "fused_stack", "data.edge_block": BLOCK}
    g = _scene(300, 0, 0.2)
    _, eng = engine_with_params_from_config(pconfig.load_config(path, ov),
                                            device="cpu")
    _, ref = engine_with_params_from_config(
        pconfig.load_config(path, dict(ov, **{"model.edge_impl": "fused"})),
        device="cpu")
    a, b = eng.predict(g), ref.predict(g)
    assert a.shape == (300, 3) and np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    _, small = engine_with_params_from_config(pconfig.load_config(
        path, dict(ov, **{"model.stack_vmem_budget": 1024})), device="cpu")
    with pytest.raises(PL.StackVmemBudgetError, match="N=1536"):
        small.predict(g)


def test_published_stack_config_trains_on_cpu(tmp_path):
    """configs/fluid_fused_stack.yaml through main.run, cut to H=16, L=2
    and 1 epoch on four small clouds: finite losses, one update, and on the
    CPU no kernel launch."""
    from distegnn_tpu_torch import main as pmain
    from distegnn_tpu_torch.data.loader import GraphDataset

    cfg = pconfig.load_config("configs/fluid_fused_stack.yaml", {
        "model.hidden_nf": H, "model.n_layers": 2, "train.epochs": 1,
        "log.test_interval": 1, "log.log_dir": str(tmp_path)})
    clouds = [dict(_scene(700, s, 0.15), node_feat=np.ones((700, 3),
                                                           np.float32))
              for s in range(6)]
    ds = [GraphDataset(clouds[:4], node_order="morton"),
          GraphDataset(clouds[4:5], node_order="morton"),
          GraphDataset(clouds[5:], node_order="morton")]
    before = (PL.fused_egnn_stack.launches, PE.fused_edge_layer.launches,
              PE.fused_edge_layer.bwd_launches)
    steps = []
    state, _, log = pmain.run(
        cfg, *ds, device="cpu",
        on_step=lambda e, s, m: steps.append(float(m["loss"])))
    assert (PL.fused_egnn_stack.launches, PE.fused_edge_layer.launches,
            PE.fused_edge_layer.bwd_launches) == before
    assert len(steps) == 4 and all(np.isfinite(v) for v in steps)
    assert state.optimizer.updates == 1
    assert np.isfinite(log["loss"]).all()
