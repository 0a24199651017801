"""Shared fixtures of the serving parity tests (``tests/test_torch_serve_queue
.py``, ``test_torch_gateway.py``, ``test_torch_replica.py``): the narrow
``configs/nbody_serve.yaml``-shaped model (H=16, L=2, C=3) in both packages,
with the JAX parameters carried into the port by ``convert.params_from_jax``,
and Morton-ordered radius-graph scenes drawn from a numpy seed."""

import os

import numpy as np

from distegnn_tpu.config import load_config as jax_load_config
from distegnn_tpu_torch.config import load_config as port_load_config
from distegnn_tpu_torch.convert import params_from_jax
from distegnn_tpu_torch.ops.order import morton_perm, reorder_graph
from distegnn_tpu_torch.ops.radius import radius_graph_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "nbody_serve.yaml")
NARROW = {"model.hidden_nf": 16, "model.n_layers": 2}
ROLLOUT = {"radius": 0.3, "max_degree": 32, "max_per_cell": 32,
           "edge_block": 256}
ATOL = 1e-5


def _set(cfg, dotted: dict) -> None:
    for key, value in dotted.items():
        *path, last = key.split(".")
        node = cfg
        for p in path:
            node = node[p]
        # a mapping value becomes the config's own ConfigDict type
        node[last] = type(cfg)(value) if isinstance(value, dict) else value


def configs(serve=None, path=CONFIG):
    """(JAX config, port config) of ``path`` at the narrow width, with the
    dotted ``serve`` overrides applied to both and both validated again."""
    from distegnn_tpu.config import validate_config as jax_validate
    from distegnn_tpu_torch.config import validate_config as port_validate

    jcfg, pcfg = jax_load_config(path), port_load_config(path)
    for cfg, validate in ((jcfg, jax_validate), (pcfg, port_validate)):
        _set(cfg, NARROW)
        _set(cfg, dict(serve or {}))
        validate(cfg)
    return jcfg, pcfg


def jax_engine(jcfg, seed=0):
    """(JAX engine, queue) of ``jcfg`` with parameters drawn by numpy at the
    model's init scales (``test_torch_fast_egnn.numpy_params``: flax's
    ``eval_shape`` only, so no init program is compiled)."""
    from distegnn_tpu.models.registry import get_model
    from distegnn_tpu.serve import ServeMetrics, engine_from_config
    from distegnn_tpu.serve.buckets import synthetic_graph
    from test_torch_fast_egnn import numpy_params

    model = get_model(jcfg.model, dataset_name=jcfg.data.dataset_name)
    engine, queue = engine_from_config(jcfg, model, params=None,
                                       metrics=ServeMetrics())
    g = synthetic_graph(2, seed=0)
    batch, _ = engine.ladder.pad_batch(
        [g], engine.ladder.bucket_of_graph(g), 1, **engine._layout_opts)
    engine.params = numpy_params(model, batch, seed=seed)
    return engine, queue


def carry_params(jax_engine, port_engines) -> None:
    """Install the JAX engine's parameters in every port engine."""
    sd = params_from_jax(jax_engine.params)
    for eng in port_engines:
        eng.params = sd


def scene(n, seed, radius=0.3):
    """A Morton-ordered radius-graph scene in pad_graphs dict form (unit
    cube, n-body widths: speed as the node feature, distance twice)."""
    rng = np.random.default_rng(seed)
    loc = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 0.05).astype(np.float32)
    ei = radius_graph_np(loc, radius)
    d = np.linalg.norm(loc[ei[0]] - loc[ei[1]], axis=1)[:, None]
    g = {"node_feat": np.linalg.norm(vel, axis=1, keepdims=True),
         "loc": loc, "vel": vel, "edge_index": ei.astype(np.int32),
         "edge_attr": np.repeat(d, 2, axis=1).astype(np.float32)}
    return reorder_graph(g, morton_perm(loc))


def rollout_scene(n, seed, steps):
    rng = np.random.default_rng(seed)
    return {"loc": rng.uniform(0, 1, size=(n, 3)).astype(np.float32),
            "vel": (rng.normal(size=(n, 3)) * 0.01).astype(np.float32),
            "steps": int(steps)}
