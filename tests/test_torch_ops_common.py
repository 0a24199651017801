"""The port's segment ops, node collectives and model building blocks
against the JAX package's, on the same numpy inputs.

Tolerances:
  f32  — |port - jax| <= 1e-6 * max|jax| (+ 1e-6 relative): the same
         arithmetic, in another summation order.
  bf16 — |port - jax| <= 2^-7 * max|jax|: both round the product and the bias
         add to bf16, but XLA on the CPU keeps excess precision inside fused
         elementwise chains where PyTorch rounds each op, so single bf16 ulps
         (2^-8 relative) differ.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distegnn_tpu.models import common as jcommon
from distegnn_tpu.ops import segment as jseg
from distegnn_tpu.parallel import collectives as jcoll
from distegnn_tpu_torch.convert import _mlp
from distegnn_tpu_torch.models import common as pcommon
from distegnn_tpu_torch.ops import segment as pseg
from distegnn_tpu_torch.parallel import collectives as pcoll
from torch_dist_worker import one_rank_group


def _close(port, ref, tol=1e-6):
    ref = np.asarray(ref, np.float32)
    port = port.detach().to(torch.float32).numpy()
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30))


@pytest.mark.parametrize("with_mask", [False, True])
def test_segment_sum_matches_jax(with_mask):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(300, 5)).astype(np.float32)
    ids = np.sort(rng.integers(0, 40, size=300)).astype(np.int32)
    mask = (rng.uniform(size=300) < 0.7).astype(np.float32) if with_mask \
        else None
    want = jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), 40,
                            mask=None if mask is None else jnp.asarray(mask))
    got = pseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 40,
                           mask=None if mask is None
                           else torch.from_numpy(mask))
    _close(got, want)


@pytest.mark.parametrize("fn", ["masked_sum", "masked_mean"])
def test_masked_reductions_match_jax(fn):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(3, 50, 4)).astype(np.float32)
    mask = (rng.uniform(size=(3, 50)) < 0.6).astype(np.float32)
    mask[2] = 0.0                    # an empty graph: the count clamps to 1
    want = getattr(jseg, fn)(jnp.asarray(data), jnp.asarray(mask), axis=1)
    got = getattr(pseg, fn)(torch.from_numpy(data), torch.from_numpy(mask),
                            axis=1)
    _close(got, want)


def test_global_node_reductions_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    data = rng.normal(size=(2, 64, 3, 4)).astype(np.float32)
    mask = (rng.uniform(size=(2, 64)) < 0.8).astype(np.float32)
    js, jc = jcoll.global_node_sum(jnp.asarray(data), jnp.asarray(mask))
    ps, pc = pcoll.global_node_sum(torch.from_numpy(data),
                                   torch.from_numpy(mask))
    _close(ps, js)
    _close(pc, jc)
    _close(pcoll.global_node_mean(torch.from_numpy(data),
                                  torch.from_numpy(mask)),
           js / jnp.maximum(jc, 1.0)[:, None, None])
    # over a graph axis: a rank of one holds the whole graph, and the mean
    # summed over the axis is the same; without a group the axis is refused
    with pytest.raises(RuntimeError, match="init_graph_group"):
        pcoll.global_node_mean(torch.from_numpy(data), torch.from_numpy(mask),
                               axis_name="graph")
    with one_rank_group(tmp_path):
        _close(pcoll.global_node_mean(torch.from_numpy(data),
                                      torch.from_numpy(mask),
                                      axis_name="graph"),
               js / jnp.maximum(jc, 1.0)[:, None, None])


def test_gather_nodes_matches_jax():
    rng = np.random.default_rng(3)
    data = rng.normal(size=(2, 30, 6)).astype(np.float32)
    idx = rng.integers(0, 30, size=(2, 90)).astype(np.int32)
    want = jcommon.gather_nodes(jnp.asarray(data), jnp.asarray(idx))
    got = pcommon.gather_nodes(torch.from_numpy(data), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _flax_mlp_params(rng, fan_in, sizes, bias_last=True):
    tree, f = {}, fan_in
    for k, s in enumerate(sizes):
        d = {"kernel": (rng.uniform(-1, 1, size=(f, s)) / np.sqrt(f)
                        ).astype(np.float32)}
        if k < len(sizes) - 1 or bias_last:
            d["bias"] = (rng.uniform(-1, 1, size=(s,)) / np.sqrt(f)
                         ).astype(np.float32)
        tree[f"TorchDense_{k}"] = {"Dense_0": d}
        f = s
    return tree


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["mlp", "mlp_act_last", "coord"])
def test_mlp_blocks_match_jax(kind, dtype_name):
    rng = np.random.default_rng(4)
    fan_in, H = 11, 16
    x = rng.normal(size=(5, 7, fan_in)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype_name == "bf16" else None
    pdt = pcommon.resolve_dtype(dtype_name)
    if kind == "coord":
        tree = _flax_mlp_params(rng, fan_in, [H, 1], bias_last=False)
        jm = jcommon.CoordMLP(H, dtype=jdt)
        jparams = {"params": {"MLP_0": tree}}
        pm = pcommon.CoordMLP(fan_in, H, dtype=pdt)
    else:
        act_last = kind == "mlp_act_last"
        tree = _flax_mlp_params(rng, fan_in, [H, H])
        jm = jcommon.MLP([H, H], act_last=act_last, dtype=jdt)
        jparams = {"params": tree}
        pm = pcommon.MLP(fan_in, [H, H], act_last=act_last, dtype=pdt)
    sd = {}
    _mlp(tree, "m", sd)
    pm.load_state_dict({k[2:]: v for k, v in sd.items()})
    want = jm.apply(jparams, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.dtype == (torch.float32 if kind == "coord" or pdt is None
                         else torch.bfloat16)
    _close(got, want.astype(jnp.float32),
           tol=1e-6 if dtype_name == "f32" else 2 ** -7)


def test_resolve_dtype():
    for spec in (None, "none", "f32", "float32", torch.float32):
        assert pcommon.resolve_dtype(spec) is None
    for spec in ("bf16", "bfloat16", torch.bfloat16):
        assert pcommon.resolve_dtype(spec) is torch.bfloat16
    with pytest.raises(ValueError, match="unsupported compute dtype"):
        pcommon.resolve_dtype("f16")
