"""The port's on-device radius graph and K-step rollouts against the JAX
package's: ``radius_graph_dev`` / ``ell_to_edge_list`` bitwise (padded
nodes, forced cell and degree overflow, a cell whose int32 hash is INT_MIN),
``make_rollout_fn`` over K=3 steps with the blocked one-hot ops (JAX Pallas
kernels in interpret mode), the batched rollout against the unbatched one,
and the engine's ``rollout`` / ``rollout_batch`` with converted parameters.

Tolerances: neighbour lists, masks, degrees and flags bitwise; trajectories
1e-5 absolute (unit-cube scenes, f32: the model parity bound, compounded
over 3 steps) with equal overflow flags; batched vs unbatched 1e-6 (the same
arithmetic per scene; only the batch shape of the products differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distegnn_tpu.config import load_config as jax_load_config
from distegnn_tpu.config import validate_config as jax_validate_config
from distegnn_tpu.models.fast_egnn import FastEGNN as JaxFastEGNN
from distegnn_tpu.models.registry import get_model as jax_get_model
from distegnn_tpu.ops import graph as jgraph
from distegnn_tpu.ops import radius_dev as jrd
from distegnn_tpu.rollout import make_rollout_fn as jax_make_rollout_fn
from distegnn_tpu.serve import engine_from_config as jax_engine_from_config
from distegnn_tpu_torch import config as pconfig
from distegnn_tpu_torch.convert import params_from_jax
from distegnn_tpu_torch.models.fast_egnn import FastEGNN
from distegnn_tpu_torch.ops import radius_dev as prd
from distegnn_tpu_torch.rollout import (make_batched_rollout_fn,
                                        make_rollout_fn)
from distegnn_tpu_torch.serve import (MixedRolloutStepsError,
                                      RolloutOverflowError,
                                      engine_with_params_from_config)
from test_torch_serve import CONFIG as SERVE_CONFIG

ATOL = 1e-5
BATCH_TOL = 1e-6
# a cell whose spatial hash is INT_MIN in int32: abs() keeps it negative,
# and the floor modulo must still give a bucket in [0, H)
INT_MIN_CELL = (791850, 13, 55)


def _graphs_equal(a, b):
    for f in ("neighbors", "nbr_mask", "degree", "cell_overflow",
              "degree_overflow"):
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        assert x.dtype == y.dtype, (f, x.dtype, y.dtype)
        np.testing.assert_array_equal(y, x, err_msg=f)


def _both(pos, r, max_degree, max_per_cell, mask=None):
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ja = jrd.radius_graph_dev(jnp.asarray(pos), r, max_degree, max_per_cell,
                              node_mask=jm)
    pa = prd.radius_graph_dev(torch.from_numpy(pos), r, max_degree,
                              max_per_cell, node_mask=tm)
    return ja, pa


@pytest.mark.parametrize("n, r, max_degree, max_per_cell, masked", [
    (500, 0.12, 32, 16, False),     # no overflow
    (300, 0.2, 64, 32, True),       # padded (masked) nodes
    (400, 0.25, 8, 32, False),      # degree overflow: farthest dropped
    (400, 0.3, 64, 4, False),       # cell overflow
])
def test_radius_graph_dev_matches_jax_bitwise(n, r, max_degree,
                                              max_per_cell, masked):
    rng = np.random.default_rng(n)
    pos = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.uniform(size=n) > 0.3).astype(np.float32)
        mask[-40:] = 0.0
    ja, pa = _both(pos, r, max_degree, max_per_cell, mask)
    _graphs_equal(ja, pa)
    if max_degree == 8:
        assert bool(pa.degree_overflow) and not bool(pa.cell_overflow)
    if max_per_cell == 4:
        assert bool(pa.cell_overflow)
    jei, jem = jrd.ell_to_edge_list(ja)
    pei, pem = prd.ell_to_edge_list(pa)
    assert pei.dtype == torch.int32
    np.testing.assert_array_equal(pei.numpy(), np.asarray(jei))
    np.testing.assert_array_equal(pem.numpy(), np.asarray(jem))


def test_radius_graph_dev_int_min_hash_matches_jax():
    """Nodes in and around a cell whose int32 hash wraps to INT_MIN."""
    c = np.array(INT_MIN_CELL, np.int32)
    with np.errstate(over="ignore"):
        h = (c[0] * np.int32(jrd._P1)) ^ (c[1] * np.int32(jrd._P2)) \
            ^ (c[2] * np.int32(jrd._P3))
    assert h == np.iinfo(np.int32).min
    rng = np.random.default_rng(3)
    base = c.astype(np.float32) + 0.5
    # positions on a 1/16 grid: exact in f32 at this magnitude
    cluster = base + np.round(rng.uniform(-1.2, 1.2, (60, 3)) * 16) / 16
    pos = np.concatenate([np.zeros((1, 3)), cluster]).astype(np.float32)
    ja, pa = _both(pos, 1.0, 64, 64)
    _graphs_equal(ja, pa)
    assert int(pa.degree.sum()) > 0
    bucket = prd._bucket_of(torch.from_numpy(c[None]), 128)
    assert int(bucket[0]) == (-2 ** 31) % 128 == 0


# -------------------------------------------------------------- rollouts

H, L, C = 16, 2, 2
RADIUS, MAX_DEGREE, MAX_PER_CELL = 0.2, 32, 32


def _scene(seed, n, n_pad=256):
    rng = np.random.default_rng(seed)
    loc = np.zeros((n_pad, 3), np.float32)
    vel = np.zeros((n_pad, 3), np.float32)
    mask = np.zeros((n_pad,), np.float32)
    loc[:n] = rng.uniform(0, 1, (n, 3))
    vel[:n] = rng.normal(size=(n, 3)) * 0.01
    mask[:n] = 1.0
    return loc, vel, mask


def _jax_params(blocked_impl):
    kw = dict(node_feat_nf=1, edge_attr_nf=2, hidden_nf=H,
              virtual_channels=C, n_layers=L, blocked_impl=blocked_impl)
    jm = JaxFastEGNN(**kw)
    loc, vel, mask = _scene(0, 100)
    ei = np.stack([np.arange(99), np.arange(1, 100)])
    init = jgraph.pad_graphs([{
        "node_feat": np.ones((100, 1), np.float32), "loc": loc[:100],
        "vel": vel[:100], "edge_index": ei,
        "edge_attr": np.ones((99, 2), np.float32)}])
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(1), init))
    pm = FastEGNN(**kw)
    pm.load_state_dict(params_from_jax(params))
    return jm, params, pm.eval()


@pytest.fixture(scope="module")
def pallas_models():
    return _jax_params("pallas")


def test_make_rollout_fn_matches_jax(pallas_models):
    jm, params, pm = pallas_models
    loc, vel, mask = _scene(5, 200)
    jro = jax_make_rollout_fn(jm, RADIUS, MAX_DEGREE, MAX_PER_CELL)
    jtraj, jover = jax.jit(lambda p, a, b, m: jro(p, a, b, m, 3))(
        params, jnp.asarray(loc), jnp.asarray(vel), jnp.asarray(mask))
    pro = make_rollout_fn(pm, RADIUS, MAX_DEGREE, MAX_PER_CELL)
    ptraj, pover = pro(torch.from_numpy(loc), torch.from_numpy(vel),
                       torch.from_numpy(mask), 3)
    assert ptraj.shape == (3, 256, 3) and pover.shape == (3,)
    np.testing.assert_array_equal(pover.numpy(), np.asarray(jover))
    assert not pover.any()
    np.testing.assert_allclose(ptraj.numpy(), np.asarray(jtraj), rtol=0,
                               atol=ATOL)
    assert (ptraj.numpy()[:, 200:] == 0).all()


def test_batched_rollout_matches_unbatched(pallas_models):
    _, _, pm = pallas_models
    scenes = [_scene(6, 180), _scene(7, 230), _scene(8, 256)]
    single = make_rollout_fn(pm, RADIUS, MAX_DEGREE, MAX_PER_CELL)
    batched = make_batched_rollout_fn(pm, RADIUS, MAX_DEGREE, MAX_PER_CELL)
    stack = [torch.from_numpy(np.stack(a)) for a in zip(*scenes)]
    btraj, bover = batched(*stack, 3)
    assert btraj.shape == (3, 3, 256, 3) and bover.shape == (3, 3)
    for i, sc in enumerate(scenes):
        traj, over = single(*(torch.from_numpy(a) for a in sc), 3)
        np.testing.assert_array_equal(bover[i].numpy(), over.numpy())
        np.testing.assert_allclose(btraj[i].numpy(), traj.numpy(), rtol=0,
                                   atol=BATCH_TOL)
    with pytest.raises(ValueError, match=r"loc0 \[B, N, 3\]"):
        batched(*(torch.from_numpy(a) for a in scenes[0]), 3)
    with pytest.raises(ValueError, match="multiple of 512"):
        make_rollout_fn(pm, RADIUS, 3, MAX_PER_CELL)
    with pytest.raises(ValueError, match="multiple of edge_block"):
        single(torch.zeros(100, 3), torch.zeros(100, 3), torch.ones(100), 1)


def _chip_smoke():
    """chip_smoke.py loaded from the repo root for its phase 3d bounds."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", ["zero_translations", "inv_deg_5pct"])
def test_rollout_bound_catches_a_wrong_aggregation(pallas_models, fault):
    """chip_smoke phase 3d holds the kernels' first rollout step against
    the plain versions as a fraction of the step's displacement. A wrong
    aggregation (the translation sums zeroed, or inv_deg 5 % off) must
    break that bound, while the right one stays inside it."""
    from unittest import mock

    from distegnn_tpu_torch.ops import blocked as BL

    tol = _chip_smoke().TOL_ROLLOUT_STEP
    _, _, pm = pallas_models
    loc, vel, mask = (torch.from_numpy(a) for a in _scene(5, 200))
    ro = make_rollout_fn(pm, RADIUS, MAX_DEGREE, MAX_PER_CELL)
    good = ro(loc, vel, mask, 1)[0][0]
    d1 = float((good - loc).abs().max())
    assert d1 > 0

    seg, plan_of = BL._seg_sum_impl, BL._plan_impl

    def faulty(data, slot, n, block, tile, plan=None):
        out = seg(data, slot, n, block, tile, plan)
        if fault == "zero_translations" and data.shape[-1] == 3:
            return out * 0.0
        return out

    def faulty_plan(slot, n, block):
        # inv_deg is the reciprocal of the plan's degree
        plan = plan_of(slot, n, block)
        if fault == "inv_deg_5pct":
            return plan._replace(deg=plan.deg * 1.05)
        return plan

    with mock.patch.object(BL, "_seg_sum_impl", faulty), \
            mock.patch.object(BL, "_plan_impl", faulty_plan):
        bad = ro(loc, vel, mask, 1)[0][0]
    assert float((bad - good).abs().max()) / d1 > tol
    pm_e = FastEGNN(node_feat_nf=1, edge_attr_nf=2, hidden_nf=H,
                    virtual_channels=C, n_layers=L, blocked_impl="einsum")
    pm_e.load_state_dict(pm.state_dict())
    ein = make_rollout_fn(pm_e.eval(), RADIUS, MAX_DEGREE, MAX_PER_CELL)(
        loc, vel, mask, 1)[0][0]
    assert float((ein - good).abs().max()) / d1 <= tol


# ---------------------------------------------------------------- engine

ROLLOUT = {"radius": RADIUS, "max_degree": MAX_DEGREE,
           "max_per_cell": MAX_PER_CELL, "edge_block": 256}


def _engines(blocked_impl="einsum"):
    jcfg = jax_load_config(SERVE_CONFIG)
    jcfg.model.hidden_nf, jcfg.model.n_layers = H, L
    jcfg.model.blocked_impl = blocked_impl
    jcfg.serve.rollout = dict(ROLLOUT)
    jmodel = jax_get_model(jcfg.model, dataset_name=jcfg.data.dataset_name)
    jeng, _ = jax_engine_from_config(jcfg, jmodel, params=None)
    loc, vel, _ = _scene(0, 100)
    ei = np.stack([np.arange(99), np.arange(1, 100)])
    init = jgraph.pad_graphs([{
        "node_feat": np.ones((100, 1), np.float32), "loc": loc[:100],
        "vel": vel[:100], "edge_index": ei,
        "edge_attr": np.ones((99, 2), np.float32)}])
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(2), init))
    jeng.params = params
    cfg = pconfig.load_config(SERVE_CONFIG, {
        "model.blocked_impl": blocked_impl, "serve.rollout": dict(ROLLOUT)})
    cfg.model.hidden_nf, cfg.model.n_layers = H, L
    model, eng = engine_with_params_from_config(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return jeng, eng


@pytest.fixture(scope="module")
def engines():
    return _engines()


def test_engine_rollout_matches_jax_engine(engines):
    jeng, eng = engines
    assert eng.rollout_enabled and jeng.rollout_enabled
    loc, vel, _ = _scene(9, 150, n_pad=150)
    assert eng.rollout_rung(150) == jeng.rollout_rung(150) == 256
    want = jeng.rollout(loc, vel, 3)
    got = eng.rollout(loc, vel, 3)
    assert got.shape == want.shape == (3, 150, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_engine_rollout_batch_matches_jax_engine(engines):
    jeng, eng = engines
    scenes = []
    for seed, n in ((10, 120), (11, 200)):
        loc, vel, _ = _scene(seed, n, n_pad=n)
        scenes.append({"loc": loc, "vel": vel, "steps": 2})
    want = jeng.rollout_batch(scenes)
    got = eng.rollout_batch(scenes)
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (2, 120, 3), (2, 200, 3)]
    for g, w, s in zip(got, want, scenes):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
        alone = eng.rollout(s["loc"], s["vel"], 2)
        np.testing.assert_allclose(g, alone, rtol=0, atol=BATCH_TOL)
    assert eng.rollout_batch([]) == []


def test_engine_rollout_errors(engines):
    _, eng = engines
    loc, vel, _ = _scene(12, 150, n_pad=150)
    with pytest.raises(MixedRolloutStepsError, match="mixes steps"):
        eng.rollout_batch([{"loc": loc, "vel": vel, "steps": 2},
                           {"loc": loc, "vel": vel, "steps": 3}])
    with pytest.raises(ValueError, match="max_batch"):
        eng.rollout_batch([{"loc": loc, "vel": vel, "steps": 1}] * 5)
    tight = engine_with_params_from_config(pconfig.load_config(
        SERVE_CONFIG, {"serve.rollout": dict(ROLLOUT, max_degree=2)}),
        device="cpu")[1]
    with pytest.raises(RolloutOverflowError, match="steps"):
        tight.rollout(loc, vel, 1)
    plain = engine_with_params_from_config(
        pconfig.load_config(SERVE_CONFIG), device="cpu")[1]
    assert not plain.rollout_enabled
    with pytest.raises(ValueError, match="rollout_opts"):
        plain.rollout(loc, vel, 1)


@pytest.mark.parametrize("bad, match", [
    ([1, 2], "must be null or a mapping"),
    ({"radius": 0.0, "max_degree": 32}, "radius must be > 0"),
    ({"radius": 0.1, "max_degree": 0}, "max_degree must be >= 1"),
    ({"radius": 0.1, "max_degree": 32, "max_per_cell": 0},
     "max_per_cell must be >= 1"),
    ({"radius": 0.1, "max_degree": 3}, "multiple of 512"),
])
def test_serve_rollout_config_checks_match_jax(bad, match):
    jcfg = jax_load_config(SERVE_CONFIG)
    jcfg.serve.rollout = bad
    with pytest.raises(ValueError, match=match) as jerr:
        jax_validate_config(jcfg)
    with pytest.raises(ValueError, match=match) as perr:
        pconfig.load_config(SERVE_CONFIG, {"serve.rollout": bad})
    assert str(perr.value) == str(jerr.value)
    cfg = pconfig.load_config(SERVE_CONFIG)
    assert cfg.serve.rollout is None
