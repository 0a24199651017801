"""Fluid113K (LargeFluid) pipeline (port of ``distegnn_tpu/data/fluid113k.py``).

A simulation is 16 zstd + msgpack shards (``sim_XXXX_YY.msgpack.zst``) of
frame dicts with 'pos', 'vel' and the scene constants 'viscosity' and 'm'
(msgpack-numpy array encoding, decoded here by a local hook). Simulations
1-100 train, 101-120 validate, 121-140 test; 16 random frames from the first
50 of each; node_attr = [viscosity, mass], node_feat = [viscosity, mass,
|v|]. ``msgpack`` and ``zstandard`` are imported only by the reader and the
writer.
"""

from __future__ import annotations

import os
import zlib
from typing import List, Optional

import numpy as np

from distegnn_tpu_torch.data.distribute import write_partitioned_split

SIM_SPLITS = {"train": (1, 101), "valid": (101, 121), "test": (121, 141)}
SHARDS_PER_SIM = 16
FRAMES_PER_SIM = 16
FRAME_RANGE = 50


def _split_seed(seed: int, split: str) -> list:
    """The RNG entropy of one (seed, split): crc32 of the split's name, not
    Python's per-process salted ``hash``."""
    return [seed, zlib.crc32(split.encode())]


def _mn_decode(obj):
    """msgpack-numpy decode hook (the format of ``msgpack_numpy.encode``)."""
    if isinstance(obj, dict):
        if obj.get(b"nd") is True:
            return np.frombuffer(
                obj[b"data"], dtype=np.dtype(obj[b"type"].decode())
            ).reshape(obj[b"shape"])
        if obj.get("nd") is True:
            return np.frombuffer(obj["data"], dtype=np.dtype(obj["type"])
                                 ).reshape(obj["shape"])
    return obj


def read_sim(data_dir: str, dataset_name: str, idx: int):
    """One simulation's 16 shards -> (pos [T, N, 3], vel [T, N, 3],
    viscosity [N], mass [N]), float32. Empty shards are skipped."""
    import msgpack
    import zstandard as zstd

    position, vel = [], []
    viscosity = mass = None
    dctx = zstd.ZstdDecompressor()
    for i in range(SHARDS_PER_SIM):
        path = os.path.join(data_dir, dataset_name,
                            f"sim_{idx:04d}_{i:02d}.msgpack.zst")
        with open(path, "rb") as f:
            raw = msgpack.unpackb(dctx.decompress(f.read()), raw=False,
                                  object_hook=_mn_decode,
                                  strict_map_key=False)
        for frame in raw:
            position.append(np.asarray(frame["pos"]))
            vel.append(np.asarray(frame["vel"]))
        if raw:
            viscosity = np.asarray(raw[0]["viscosity"])
            mass = np.asarray(raw[0]["m"])
    return (np.stack(position).astype(np.float32),
            np.stack(vel).astype(np.float32),
            viscosity.astype(np.float32), mass.astype(np.float32))


def write_fluid_sim(data_dir: str, dataset_name: str, idx: int,
                    pos: np.ndarray, vel: np.ndarray, viscosity: np.ndarray,
                    mass: np.ndarray) -> None:
    """Write one simulation in the format :func:`read_sim` reads: pos/vel
    [T, N, 3], the T frames split evenly over the 16 shards."""
    import msgpack
    import zstandard as zstd

    def encode_np(o):
        if isinstance(o, np.ndarray):
            return {b"nd": True, b"type": o.dtype.str.encode(),
                    b"shape": list(o.shape), b"data": o.tobytes()}
        return o

    base = os.path.join(data_dir, dataset_name)
    os.makedirs(base, exist_ok=True)
    T = pos.shape[0]
    bounds = np.linspace(0, T, SHARDS_PER_SIM + 1).astype(int)
    cctx = zstd.ZstdCompressor()
    viscosity = np.asarray(viscosity, np.float32)
    mass = np.asarray(mass, np.float32)
    for s in range(SHARDS_PER_SIM):
        frames = [{"pos": np.asarray(pos[t], np.float32),
                   "vel": np.asarray(vel[t], np.float32),
                   "viscosity": viscosity, "m": mass}
                  for t in range(bounds[s], bounds[s + 1])]
        packed = msgpack.packb(frames, default=encode_np)
        with open(os.path.join(base, f"sim_{idx:04d}_{s:02d}.msgpack.zst"),
                  "wb") as f:
            f.write(cctx.compress(packed))


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


def process_large_fluid_distribute(data_dir: str, dataset_name: str,
                                   world_size: int, max_samples: int,
                                   inner_radius: float,
                                   outer_radius: Optional[float],
                                   split_mode: str, delta_t: int,
                                   seed: int = 0) -> List[List[str]]:
    """Read each split's simulations, draw up to 16 frames of each (the
    split's RNG from :func:`_split_seed`), build (frame -> frame + delta_t)
    graphs and write them partitioned. Returns [train, valid, test] shard
    paths, ``world_size`` each."""
    base = os.path.join(data_dir, dataset_name)
    processed_dir = os.path.join(base, "processed")
    os.makedirs(processed_dir, exist_ok=True)
    out = []
    for split, (lo, hi) in SIM_SPLITS.items():
        key = (f"{dataset_name}_{split_mode}_{split}_o{outer_radius}"
               f"_i{inner_radius}_{max_samples}_{delta_t}_s{seed}")
        shard_paths = [os.path.join(processed_dir,
                                    f"{key}_{p}-{world_size}.pkl")
                       for p in range(world_size)]
        out.append(shard_paths)
        if all(os.path.exists(p) for p in shard_paths):
            continue
        rng = np.random.default_rng(_split_seed(seed, split))
        graphs = []
        for idx in range(lo, hi):
            if len(graphs) >= max_samples:
                break
            pos, vel, viscosity, mass = read_sim(data_dir, dataset_name, idx)
            n = min(FRAMES_PER_SIM, max_samples - len(graphs))
            hi_f = min(FRAME_RANGE, pos.shape[0] - delta_t - 1)
            if hi_f <= 0:
                continue  # too short for this delta_t
            for frame in rng.integers(0, hi_f, size=n):
                graphs.append(build_fluid_graph(
                    pos[frame], vel[frame], viscosity, mass,
                    pos[frame + delta_t]))
        write_partitioned_split(graphs, processed_dir, key, world_size,
                                split_mode, inner_radius, outer_radius,
                                seed=seed)
    return out
