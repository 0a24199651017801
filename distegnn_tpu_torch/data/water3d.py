"""Water-3D pipeline (port of ``distegnn_tpu/data/water3d.py``).

Input: ``<data_dir>/<name>/{train,valid,test}.h5``, the DeepMind
learning-to-simulate trajectories in the reference's converted layout: per
trajectory group ``traj_<k>``, ``particle_type`` [N] and ``position``
[T, N, 3]. Per trajectory, 15 frames drawn from the first 250 form
(frame -> frame + delta_t) prediction pairs; the velocity is the one-step
difference. The draw is seeded per (seed, split) through crc32 (the
reference draws with an unseeded ``random.randint``), so reruns and both
packages write the same graphs.

Cutoff mode writes one pickle per split; distribute mode partitions every
frame into ``world_size`` parts (``data/distribute.py``) and writes a pickle
per part. The file names under ``<data_dir>/<name>/processed/`` are the JAX
package's, so the two packages share one cache. The h5 files are read by
``data/hdf5.py`` (numpy, memory-mapped; no ``h5py``), one trajectory at a
time.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np

from distegnn_tpu_torch.data.distribute import write_partitioned_split
from distegnn_tpu_torch.data.fluid113k import _split_seed
from distegnn_tpu_torch.data.hdf5 import H5File
from distegnn_tpu_torch.ops.radius import cutoff_edges_np, radius_graph_np

FRAME_RANGE = 250   # frames are drawn from the first 250 of a trajectory
FRAMES_PER_TRAJ = 15


def build_water3d_graph(loc_0, vel_0, particle_type, target, radius: float,
                        cutoff_rate: float = 0.0,
                        with_edges: bool = True) -> dict:
    """node_feat = [|v|, type / max type]; node_attr = type; the radius
    graph's distance in 2 edge channels (none with ``with_edges=False``)."""
    loc_0 = np.asarray(loc_0, np.float32)
    vel_0 = np.asarray(vel_0, np.float32)
    ptype = np.asarray(particle_type, np.float32).reshape(-1, 1)

    if with_edges:
        edge_index = radius_graph_np(loc_0, radius)
        edge_index = cutoff_edges_np(edge_index, loc_0, cutoff_rate)
    else:
        edge_index = np.zeros((2, 0), np.int64)
    dist = np.linalg.norm(loc_0[edge_index[0]] - loc_0[edge_index[1]], axis=1)

    speed = np.linalg.norm(vel_0, axis=1, keepdims=True)
    node_feat = np.concatenate([speed, ptype / max(ptype.max(), 1e-12)],
                               axis=1)
    return {
        "node_feat": node_feat.astype(np.float32),
        "node_attr": ptype,
        "loc": loc_0,
        "vel": vel_0,
        "target": np.asarray(target, np.float32),
        "loc_mean": loc_0.mean(axis=0),
        "edge_index": edge_index.astype(np.int32),
        "edge_attr": np.repeat(dist[:, None], 2, axis=1).astype(np.float32),
    }


def _iter_frames(h5file: str, max_samples: int, delta_t: int,
                 rng: np.random.Generator):
    """Yield (loc_0, vel_0, particle_type, target), at most ``max_samples``,
    trajectories in sorted key order; a trajectory too short for
    ``delta_t`` is skipped."""
    count = 0
    with H5File(h5file) as f:
        for key in sorted(f.keys()):
            if count >= max_samples:
                break
            ptype = f.read(key, "particle_type")
            pos = f.read(key, "position")
            n = min(FRAMES_PER_TRAJ, max_samples - count)
            hi = min(FRAME_RANGE, pos.shape[0] - delta_t - 1)
            if hi <= 0:
                continue
            for frame in rng.integers(0, hi, size=n):
                yield (pos[frame], pos[frame + 1] - pos[frame], ptype,
                       pos[frame + delta_t])
                count += 1


def process_water3d_cutoff(data_dir: str, dataset_name: str, max_samples: int,
                           radius: float, delta_t: int, cutoff_rate: float,
                           seed: int = 0) -> List[str]:
    """The train / valid / test pickles of radius-``radius`` graphs; a file
    that exists under the same parameter key is reused."""
    base = os.path.join(data_dir, dataset_name)
    processed_dir = os.path.join(base, "processed")
    os.makedirs(processed_dir, exist_ok=True)
    paths = []
    for split in ("train", "valid", "test"):
        out = os.path.join(
            processed_dir,
            f"{dataset_name}_{split}_{radius}_{cutoff_rate:.3f}_{max_samples}"
            f"_{delta_t}_s{seed}.pkl")
        paths.append(out)
        if os.path.exists(out):
            continue
        rng = np.random.default_rng(_split_seed(seed, split))
        graphs = [
            build_water3d_graph(l, v, p, t, radius, cutoff_rate)
            for l, v, p, t in _iter_frames(os.path.join(base, f"{split}.h5"),
                                           max_samples, delta_t, rng)]
        with open(out + ".tmp", "wb") as f:
            pickle.dump(graphs, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(out + ".tmp", out)
    return paths


def process_water3d_distribute(data_dir: str, dataset_name: str,
                               world_size: int, max_samples: int,
                               inner_radius: float,
                               outer_radius: Optional[float], split_mode: str,
                               delta_t: int, seed: int = 0
                               ) -> List[List[str]]:
    """Distribute mode: every frame, without edges, split into
    ``world_size`` parts that build their own ``inner_radius`` edges.
    Returns [train, valid, test] lists of ``world_size`` shard paths."""
    base = os.path.join(data_dir, dataset_name)
    processed_dir = os.path.join(base, "processed")
    os.makedirs(processed_dir, exist_ok=True)
    out = []
    for split in ("train", "valid", "test"):
        key = (f"{dataset_name}_{split_mode}_{split}_o{outer_radius}"
               f"_i{inner_radius}_{max_samples}_{delta_t}_s{seed}")
        paths = [os.path.join(processed_dir, f"{key}_{p}-{world_size}.pkl")
                 for p in range(world_size)]
        if not all(os.path.exists(p) for p in paths):
            rng = np.random.default_rng(_split_seed(seed, split))
            graphs = [
                build_water3d_graph(l, v, p, t, inner_radius,
                                    with_edges=False)
                for l, v, p, t in _iter_frames(
                    os.path.join(base, f"{split}.h5"), max_samples, delta_t,
                    rng)]
            paths = write_partitioned_split(
                graphs, processed_dir, key, world_size, split_mode,
                inner_radius, outer_radius, seed=seed)
        out.append(paths)
    return out
