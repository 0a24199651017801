"""Partition-quality measurement (the port's counterpart of
``scripts/partition_quality.py``, over ``distegnn_tpu_torch.data.partition``
and ``ops/radius.py``).

Compares the four partitioners (random / kmeans / spectral / native
metis-standin) on a Fluid113K-like particle cloud: edge-cut fraction
(the information the DistEGNN model LOSES — inter-partition edges are
dropped, global coupling flows only through virtual nodes), per-partition
node/edge spread (padding waste: every shard pads to the max), and wall
time. The reference reaches real libmetis via torch-sparse
(reference datasets/distribute_graphs.py:151-185); the in-tree C++
bisection+FM partitioner stands in, and this script is the evidence for
whether it is good enough (cut <= 1.5x spectral's) or needs multilevel
coarsening.

Usage: python -m distegnn_tpu_torch.scripts.partition_quality [--n 113140]
       [--parts 8] [--methods random,kmeans,metis] [--json out.json]
Spectral is O(N^2) affinity (sklearn) — include it only at --n <= ~20000.
kmeans and spectral need scikit-learn; metis the native library, which
builds with g++ at first use. Everything runs on the host: the script
touches no device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from distegnn_tpu_torch.data.partition import assign_partitions
from distegnn_tpu_torch.ops.radius import radius_graph_np

RADIUS = 0.075
TARGET_EDGES_PER_NODE = 15.0


def fluid_cloud(n: int, seed: int = 0) -> np.ndarray:
    """Uniform cloud at Fluid113K edge density (bench.py's workload)."""
    rng = np.random.default_rng(seed)
    vol = n * (4.0 / 3.0) * np.pi * RADIUS**3 / TARGET_EDGES_PER_NODE
    side = max(vol ** (1.0 / 3.0), 2.0 * RADIUS)
    return rng.uniform(0, side, size=(n, 3)).astype(np.float32)


def quality(labels: np.ndarray, edge_index: np.ndarray, n_parts: int) -> dict:
    row, col = edge_index
    cut = int((labels[row] != labels[col]).sum())
    nodes = np.bincount(labels, minlength=n_parts)
    # per-partition INNER edge count (what each shard keeps)
    same = labels[row] == labels[col]
    edges = np.bincount(labels[row[same]], minlength=n_parts)
    return {
        "cut_fraction": round(cut / max(edge_index.shape[1], 1), 4),
        "node_spread": f"{nodes.min()}..{nodes.max()}",
        "node_imbalance": round(float(nodes.max() / max(nodes.mean(), 1)), 3),
        "edge_spread": f"{edges.min()}..{edges.max()}",
        # padding waste: shards pad to the max edge count
        "edge_imbalance": round(float(edges.max() / max(edges.mean(), 1)), 3),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distegnn_tpu_torch.scripts.partition_quality",
        description="edge cut and balance of the graph partitioners")
    ap.add_argument("--n", type=int, default=113_140)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--methods", type=str, default="random,kmeans,metis")
    ap.add_argument("--json", type=str, default=None)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    loc = fluid_cloud(args.n, args.seed)
    t0 = time.perf_counter()
    edge_index = radius_graph_np(loc, RADIUS)
    print(f"N={args.n} E={edge_index.shape[1]} parts={args.parts} "
          f"(radius graph {time.perf_counter() - t0:.1f}s)", flush=True)

    results = {"n": args.n, "edges": int(edge_index.shape[1]),
               "parts": args.parts, "methods": {}}
    for method in args.methods.split(","):
        t0 = time.perf_counter()
        labels = assign_partitions(loc, args.parts, method,
                                   outer_radius=RADIUS, seed=args.seed)
        dt = time.perf_counter() - t0
        q = quality(labels, edge_index, args.parts)
        q["seconds"] = round(dt, 2)
        results["methods"][method] = q
        print(f"{method:9s} cut={q['cut_fraction']:.4f} "
              f"nodes {q['node_spread']} (x{q['node_imbalance']}) "
              f"edges {q['edge_spread']} (x{q['edge_imbalance']}) "
              f"[{dt:.1f}s]", flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
