"""Fluid113K graph dicts (port of ``build_fluid_graph`` of
``distegnn_tpu/data/fluid113k.py``). The reader of the dataset's
``.msgpack.zst`` simulation files is not ported yet (ROADMAP.md)."""

from __future__ import annotations

import numpy as np


def build_fluid_graph(loc_0, vel_0, viscosity, mass, target) -> dict:
    """Whole-graph dict without edges: node_attr = [viscosity, mass],
    node_feat = [viscosity, mass, |v|], loc_mean = the mean position.
    Edges are built by the caller (radius graph) or per partition."""
    loc_0 = np.asarray(loc_0, np.float32)
    vel_0 = np.asarray(vel_0, np.float32)
    node_attr = np.stack([np.broadcast_to(viscosity, loc_0[:, 0].shape),
                          np.broadcast_to(mass, loc_0[:, 0].shape)], axis=-1)
    speed = np.linalg.norm(vel_0, axis=1, keepdims=True)
    node_feat = np.concatenate([node_attr, speed], axis=1)
    return {
        "node_feat": node_feat.astype(np.float32),
        "node_attr": node_attr.astype(np.float32),
        "loc": loc_0,
        "vel": vel_0,
        "target": np.asarray(target, np.float32),
        "loc_mean": loc_0.mean(axis=0),
        "edge_index": np.zeros((2, 0), np.int32),
        "edge_attr": np.zeros((0, 2), np.float32),
    }
