"""Protein (AdK equilibrium) pipeline (port of ``distegnn_tpu/data/protein.py``).

Two stages, split so that the heavy dependency stays apart:

1. :func:`extract_adk_npz` fetches the MDAnalysisData AdK trajectory and
   dumps the backbone's (or every atom's) positions [T, N, 3], charges [N]
   and, where the trajectory has them, the box ``dimensions`` [3] into one
   npz. It needs MDAnalysis and MDAnalysisData; without them it raises
   ``NotImplementedError`` naming the npz to place by hand.
2. :func:`process_protein_cutoff`, numpy from the npz on: per frame t,
   vel = pos[t + 1] - pos[t], target = pos[t + delta_t]; radius-graph edges
   at ``radius`` Angstrom; the fixed split 2481 / 827 / 863
   (``TRAIN_VALID_TEST``); ``test_rot`` / ``test_trans`` rotate or
   translate the test split only (the reference's empirical equivariance
   evaluation), drawing from ``default_rng(seed)`` in the JAX package's
   order, so both packages write the same pickles under the same names.
"""

from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np

from distegnn_tpu_torch.ops.radius import cutoff_edges_np, radius_graph_np
from distegnn_tpu_torch.utils.rotate import random_rotate

TRAIN_VALID_TEST = {"train": (0, 2481), "valid": (2481, 3308),
                    "test": (3308, 4171)}
NPZ_NAME = "adk_{sel}.npz"


def extract_adk_npz(data_dir: str, backbone: bool = True) -> str:
    """Stage 1: the npz cache of the AdK trajectory. Returns its path."""
    sel = "backbone" if backbone else "all"
    out = os.path.join(data_dir, NPZ_NAME.format(sel=sel))
    if os.path.exists(out):
        return out
    try:
        import MDAnalysis
        import MDAnalysisData
    except ImportError as e:
        raise NotImplementedError(
            f"protein extraction needs MDAnalysis and MDAnalysisData, which "
            f"are not installed. Run extract_adk_npz where they are, or "
            f"place {out} (positions [T,N,3] float32, charges [N] float32, "
            f"optionally dimensions [3]) by hand.") from e

    adk = MDAnalysisData.datasets.fetch_adk_equilibrium(data_home=data_dir)
    u = MDAnalysis.Universe(adk.topology, adk.trajectory)
    ag = u.select_atoms("backbone") if backbone else u.atoms
    charges = np.asarray(u.atoms[ag.ix].charges, np.float32)
    positions = np.stack([ts.positions[ag.ix].copy() for ts in u.trajectory]
                         ).astype(np.float32)
    # the box scales the test_trans shift (the reference's dimensions[:3] / 2)
    extra = ({} if u.dimensions is None
             else {"dimensions": np.asarray(u.dimensions[:3], np.float32)})
    np.savez_compressed(out, positions=positions, charges=charges, **extra)
    return out


def build_protein_graph(loc_0, vel_0, charges, target, radius: float,
                        cutoff_rate: float) -> dict:
    """node_feat = [|v|, q / max q]; node_attr = q; the radius graph's
    distance in 2 edge channels."""
    loc_0 = np.asarray(loc_0, np.float32)
    charges = np.asarray(charges, np.float32).reshape(-1, 1)
    edge_index = radius_graph_np(loc_0, radius)
    edge_index = cutoff_edges_np(edge_index, loc_0, cutoff_rate)
    dist = np.linalg.norm(loc_0[edge_index[0]] - loc_0[edge_index[1]], axis=1)
    speed = np.linalg.norm(vel_0, axis=1, keepdims=True)
    node_feat = np.concatenate([speed, charges / charges.max()], axis=1)
    return {
        "node_feat": node_feat.astype(np.float32),
        "node_attr": charges,
        "loc": loc_0,
        "vel": np.asarray(vel_0, np.float32),
        "target": np.asarray(target, np.float32),
        "loc_mean": loc_0.mean(axis=0),
        "edge_index": edge_index.astype(np.int32),
        "edge_attr": np.repeat(dist[:, None], 2, axis=1).astype(np.float32),
    }


def process_protein_cutoff(data_dir: str, dataset_name: str, max_samples: int,
                           radius: float, delta_t: int, cutoff_rate: float,
                           backbone: bool = True, test_rot: bool = False,
                           test_trans: bool = False,
                           seed: int = 0) -> List[str]:
    """The train / valid / test pickles from ``<data_dir>/<name>/adk_<sel>.npz``
    (extracted first when missing); at most ``max_samples`` frames a split.
    The translation scale is the npz's box ``dimensions``, else the
    coordinates' largest magnitude per axis. A file that exists under the
    same parameter key is reused."""
    base = os.path.join(data_dir, dataset_name)
    processed_dir = os.path.join(base, "processed")
    os.makedirs(processed_dir, exist_ok=True)

    npz_path = os.path.join(
        base, NPZ_NAME.format(sel="backbone" if backbone else "all"))
    if not os.path.exists(npz_path):
        npz_path = extract_adk_npz(base, backbone=backbone)
    with np.load(npz_path) as data:
        positions, charges = data["positions"], data["charges"]
        trans_scale = (np.asarray(data["dimensions"], np.float32)
                       if "dimensions" in data.files
                       else np.abs(positions).max(axis=(0, 1)))
    # one stream over the splits in order: only the test split draws
    rng = np.random.default_rng(seed)

    paths = []
    for split, (lo, hi) in TRAIN_VALID_TEST.items():
        out = os.path.join(
            processed_dir,
            f"{dataset_name}_{split}_{radius}_{cutoff_rate:.3f}_{max_samples}"
            f"_{delta_t}_rot{int(test_rot)}_trans{int(test_trans)}_s{seed}.pkl")
        paths.append(out)
        if os.path.exists(out):
            continue
        hi = min(hi, positions.shape[0] - delta_t - 1, lo + max_samples)
        graphs = []
        for t in range(lo, hi):
            loc_0 = positions[t]
            vel_0 = positions[t + 1] - loc_0
            target = positions[t + delta_t]
            if split == "test" and test_rot:
                R = random_rotate(rng).astype(np.float32)
                loc_0, vel_0, target = loc_0 @ R, vel_0 @ R, target @ R
            if split == "test" and test_trans:
                tr = (rng.standard_normal(3) * trans_scale / 2
                      ).astype(np.float32)
                loc_0, target = loc_0 + tr, target + tr
            graphs.append(build_protein_graph(loc_0, vel_0, charges, target,
                                              radius, cutoff_rate))
        with open(out + ".tmp", "wb") as f:
            pickle.dump(graphs, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(out + ".tmp", out)
    return paths
