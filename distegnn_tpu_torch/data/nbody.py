"""N-body preprocessing (port of ``distegnn_tpu/data/nbody.py``): load raw
trajectory ``.npy`` files, pick (frame_0 -> frame_T) prediction pairs, build
full or radius graphs with the edge cutoff, and cache the graph dicts as a
pickle keyed by every parameter (numpy only)."""

from __future__ import annotations

import glob
import os
import pickle
from typing import List, Optional

import numpy as np

from distegnn_tpu_torch.ops.radius import (cutoff_edges_np, full_graph_np,
                                           radius_graph_np)


def build_nbody_graph(loc: np.ndarray, vel: np.ndarray, charges: np.ndarray,
                      target: Optional[np.ndarray], radius: float = -1.0,
                      cutoff_rate: float = 0.0,
                      with_edges: bool = True) -> dict:
    """One sample -> graph dict: the full graph when radius == -1, else the
    radius graph; the longest ``cutoff_rate`` fraction of edges dropped;
    edge_attr = the distance in 2 channels; node_feat = [|v|, q / max q];
    node_attr = q; loc_mean = the mean position. ``with_edges=False`` leaves
    the edge list empty."""
    loc = np.asarray(loc, np.float32)
    vel = np.asarray(vel, np.float32)
    charges = np.asarray(charges, np.float32)
    n = loc.shape[0]
    if with_edges:
        edge_index = (full_graph_np(n) if radius == -1
                      else radius_graph_np(loc, radius))
        edge_index = cutoff_edges_np(edge_index, loc, cutoff_rate)
    else:
        edge_index = np.zeros((2, 0), np.int64)
    dist = np.linalg.norm(loc[edge_index[0]] - loc[edge_index[1]], axis=1)
    edge_attr = np.repeat(dist[:, None], 2, axis=1).astype(np.float32)
    speed = np.linalg.norm(vel, axis=1, keepdims=True)
    node_feat = np.concatenate([speed, charges / charges.max()],
                               axis=1).astype(np.float32)
    return {
        "node_feat": node_feat,
        "node_attr": charges,
        "loc": loc,
        "vel": vel,
        "target": None if target is None else np.asarray(target, np.float32),
        "loc_mean": loc.mean(axis=0),
        "edge_index": edge_index.astype(np.int32),
        "edge_attr": edge_attr,
    }


def _find_tag(base: str, split: str) -> str:
    hits = sorted(glob.glob(os.path.join(base, f"loc_{split}_*.npy")))
    if not hits:
        raise FileNotFoundError(f"no loc_{split}_*.npy under {base}")
    name = os.path.basename(hits[0])
    return name[len(f"loc_{split}_"):-len(".npy")]


def process_nbody_cutoff(data_dir: str, dataset_name: str, max_samples: int,
                         radius: float, frame_0: int, frame_T: int,
                         cutoff_rate: float,
                         tag: Optional[str] = None) -> List[str]:
    """Process the train/valid/test splits; returns the three pickle paths.
    A file that exists under the same parameter key is reused untouched (the
    same file names as the JAX package's, so either package reads the
    other's cache)."""
    base = os.path.join(data_dir, dataset_name)
    processed_dir = os.path.join(base, "processed")
    os.makedirs(processed_dir, exist_ok=True)
    paths = []
    for split in ("train", "valid", "test"):
        out = os.path.join(
            processed_dir,
            f"{dataset_name}_{split}_{radius}_{cutoff_rate:.3f}_{max_samples}"
            f"_{frame_0}_{frame_T}.pkl")
        paths.append(out)
        if os.path.exists(out):
            continue
        t = tag if tag is not None else _find_tag(base, split)
        loc = np.load(os.path.join(base, f"loc_{split}_{t}.npy"))[:max_samples]
        vel = np.load(os.path.join(base, f"vel_{split}_{t}.npy"))[:max_samples]
        charges = np.load(
            os.path.join(base, f"charges_{split}_{t}.npy"))[:max_samples]
        graphs = [build_nbody_graph(loc[k, frame_0], vel[k, frame_0],
                                    charges[k], loc[k, frame_T],
                                    radius=radius, cutoff_rate=cutoff_rate)
                  for k in range(loc.shape[0])]
        with open(out, "wb") as f:
            pickle.dump(graphs, f, protocol=pickle.HIGHEST_PROTOCOL)
    return paths
