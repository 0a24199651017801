"""Distribute-mode preprocessing (port of ``distegnn_tpu/data/distribute.py``):
partition every graph into ``world_size`` parts and write one pickle per
(split, part): ``<key>_<p>-<world_size>.pkl``, the JAX package's file names,
so either package reads the other's cache.

One process writes the shards (the parent of a spawned run, or rank 0 under
``torchrun`` while the other ranks wait at a barrier); the ranks then read
only their own."""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np

from distegnn_tpu_torch.data.nbody import _find_tag, build_nbody_graph
from distegnn_tpu_torch.data.partition import split_graph


def _shard_paths(processed_dir: str, key: str, world_size: int) -> List[str]:
    return [os.path.join(processed_dir, f"{key}_{p}-{world_size}.pkl")
            for p in range(world_size)]


def write_partitioned_split(graphs: List[dict], processed_dir: str, key: str,
                            world_size: int, split_mode: str,
                            inner_radius: float, outer_radius: Optional[float],
                            seed: int = 0) -> List[str]:
    """Split graph i with seed ``seed + i`` into ``world_size`` parts and
    write shard p's list of part-p dicts to its own file (a temporary file,
    then an atomic rename: a reader never sees a truncated pickle). Files
    that all exist already are reused. Returns the shard paths."""
    paths = _shard_paths(processed_dir, key, world_size)
    if all(os.path.exists(p) for p in paths):
        return paths
    shards: List[List[dict]] = [[] for _ in range(world_size)]
    for i, g in enumerate(graphs):
        parts = split_graph(g, world_size, split_mode, inner_radius,
                            outer_radius=outer_radius, seed=seed + i)
        for p in range(world_size):
            shards[p].append(parts[p])
    if len({len(s) for s in shards}) != 1:
        raise AssertionError("unequal shard lengths")
    os.makedirs(processed_dir, exist_ok=True)
    for p, path in enumerate(paths):
        with open(path + ".tmp", "wb") as f:
            pickle.dump(shards[p], f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(path + ".tmp", path)
    return paths


def process_nbody_distribute(data_dir: str, dataset_name: str,
                             world_size: int, max_samples: int,
                             inner_radius: float,
                             outer_radius: Optional[float], split_mode: str,
                             frame_0: int, frame_T: int, seed: int = 0,
                             tag: Optional[str] = None) -> List[List[str]]:
    """N-body in distribute mode: whole graphs without edges, each split
    into ``world_size`` parts that build their own ``inner_radius`` edges.
    Returns [train, valid, test] shard paths, ``world_size`` each."""
    base = os.path.join(data_dir, dataset_name)
    processed_dir = os.path.join(base, "processed")
    os.makedirs(processed_dir, exist_ok=True)
    out = []
    for split in ("train", "valid", "test"):
        key = (f"{dataset_name}_{split}_dist_{split_mode}_o{outer_radius}"
               f"_i{inner_radius}_{max_samples}_{frame_0}_{frame_T}_s{seed}")
        paths = _shard_paths(processed_dir, key, world_size)
        if not all(os.path.exists(p) for p in paths):
            t = tag if tag is not None else _find_tag(base, split)
            loc = np.load(os.path.join(base, f"loc_{split}_{t}.npy"))[:max_samples]
            vel = np.load(os.path.join(base, f"vel_{split}_{t}.npy"))[:max_samples]
            charges = np.load(
                os.path.join(base, f"charges_{split}_{t}.npy"))[:max_samples]
            graphs = [build_nbody_graph(loc[k, frame_0], vel[k, frame_0],
                                        charges[k], loc[k, frame_T],
                                        with_edges=False)
                      for k in range(loc.shape[0])]
            write_partitioned_split(graphs, processed_dir, key, world_size,
                                    split_mode, inner_radius, outer_radius,
                                    seed=seed)
        out.append(paths)
    return out
