"""Remat memory-scaling evidence (the port's counterpart of
``scripts/measure_remat_memory.py``).

FastEGNN's ``remat`` flag trades recompute for the O(E*H) per-layer
activation memory that bounds the nodes a card can train
(distegnn_tpu_torch/models/fast_egnn.py checkpoints each layer). The model
is the flagship's (``configs/largefluid_distegnn.yaml``: H=64, L=4, C=3,
bf16) on a uniform cloud at Fluid113K's edge density. Two measurements:

1. PRIMARY (runs anywhere): the bytes autograd keeps between one forward
   and its backward — the unique storages that the forward's ops save for
   the backward (read through ``torch.autograd.graph.saved_tensors_hooks``)
   plus, under remat, the tensors each layer's checkpoint keeps for its
   rerun. It is the port's counterpart of JAX's ``jax.vjp`` closure bytes;
   the two autodiffs save different arrays, so the totals are not the
   same numbers.
2. ``--xla-temp`` (the JAX flag's name, kept): the card's own peak,
   ``torch.cuda.max_memory_allocated`` around one grad step (forward,
   loss, backward), with the parameters and the batch already resident.
   It needs ``--device cuda``.

    python -m distegnn_tpu_torch.scripts.measure_remat_memory \\
        [--nodes 20000 50000] [--xla-temp] [--json out] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
from unittest import mock

import numpy as np
import torch

RADIUS = 0.075
TARGET_EDGES_PER_NODE = 15.0


def make_fluid_cloud(n_nodes: int, rng):
    """A uniform particle cloud at Fluid113K's edge density, Z-curve
    ordered, as a raw graph dict (the JAX package's ``bench.py``
    workload)."""
    from distegnn_tpu_torch.ops.order import morton_perm
    from distegnn_tpu_torch.ops.radius import radius_graph_np

    vol = n_nodes * (4.0 / 3.0) * np.pi * RADIUS**3 / TARGET_EDGES_PER_NODE
    side = max(vol ** (1.0 / 3.0), 2.0 * RADIUS)
    loc = rng.uniform(0, side, size=(n_nodes, 3)).astype(np.float32)
    vel = rng.normal(size=(n_nodes, 3)).astype(np.float32) * 0.01
    p = morton_perm(loc)
    loc, vel = loc[p], vel[p]
    edge_index = radius_graph_np(loc, RADIUS)
    dist = np.linalg.norm(loc[edge_index[0]] - loc[edge_index[1]], axis=1)
    graph = {
        "node_feat": np.concatenate(
            [np.linalg.norm(vel, axis=1, keepdims=True), vel[:, :2]],
            axis=1).astype(np.float32),
        "node_attr": np.ones((n_nodes, 2), np.float32),
        "loc": loc,
        "vel": vel,
        "target": loc + vel * 0.05,
        "loc_mean": loc.mean(axis=0),
        "edge_index": edge_index,
        "edge_attr": np.repeat(dist[:, None], 2, axis=1).astype(np.float32),
    }
    return graph, edge_index.shape[1]


@functools.lru_cache(maxsize=4)
def _fluid_batch(n_nodes: int):
    """The padded batch of the seed-0 cloud of ``n_nodes`` (built once a
    size: the radius graph dominates a measurement's host time)."""
    from distegnn_tpu_torch.ops.graph import pad_graphs

    graph, n_edges = make_fluid_cloud(n_nodes, np.random.default_rng(0))
    return pad_graphs([graph], compute_pair=False), n_edges


def _model_and_loss(n_nodes: int, remat: bool, seg: str, device):
    from distegnn_tpu_torch.models.fast_egnn import FastEGNN

    batch, n_edges = _fluid_batch(n_nodes)
    batch = batch.to(device)
    model = FastEGNN(node_feat_nf=3, node_attr_nf=2, edge_attr_nf=2,
                     hidden_nf=64, virtual_channels=3, n_layers=4,
                     compute_dtype="bf16", segment_impl=seg, remat=remat,
                     generator=torch.Generator().manual_seed(0)).to(device)

    def loss():
        loc, _ = model(batch)
        return ((loc - batch.target) ** 2
                * batch.node_mask[..., None]).sum()

    return model, loss, n_edges


def _storage_key(t: torch.Tensor):
    s = t.untyped_storage()
    return (t.device.type, s.data_ptr()), s.nbytes()


def saved_bytes(n_nodes: int, remat: bool, seg: str = "scatter",
                device="cpu") -> dict:
    """The record of measurement 1 for one (N, remat)."""
    from distegnn_tpu_torch.models import fast_egnn

    _, loss, n_edges = _model_and_loss(n_nodes, remat, seg, device)
    seen = {}

    def pack(t):
        k, nb = _storage_key(t)
        seen[k] = nb
        return t

    def keeping_checkpoint(fn, *args, **kw):
        for a in args:
            if isinstance(a, torch.Tensor):
                k, nb = _storage_key(a)
                seen[k] = nb
        return real_checkpoint(fn, *args, **kw)

    real_checkpoint = fast_egnn.checkpoint
    with mock.patch.object(fast_egnn, "checkpoint", keeping_checkpoint), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = loss()
    del out
    return {"n_nodes": n_nodes, "n_edges": int(n_edges), "remat": remat,
            "residual_bytes": int(sum(seen.values())),
            "residual_arrays": len(seen)}


def card_peak_bytes(n_nodes: int, remat: bool, seg: str = "scatter",
                    device="cuda") -> dict:
    """``--xla-temp``: the card's peak allocated bytes over one grad step
    above what is resident before it."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("--xla-temp reads the card's peak memory: run it "
                         "with --device cuda")
    model, loss, n_edges = _model_and_loss(n_nodes, remat, seg, device)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    loss().backward()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    del model
    return {"n_nodes": n_nodes, "n_edges": int(n_edges), "remat": remat,
            "temp_bytes": int(peak - base), "peak_bytes": int(peak)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distegnn_tpu_torch.scripts.measure_remat_memory",
        description="bytes autograd keeps for one FastEGNN forward, with "
                    "and without remat")
    ap.add_argument("--nodes", type=int, nargs="+", default=[20000, 50000])
    ap.add_argument("--seg", default="scatter")
    ap.add_argument("--xla-temp", action="store_true",
                    help="also report the card's peak allocated bytes over "
                         "one grad step (torch.cuda.max_memory_allocated; "
                         "needs --device cuda). The name is the JAX "
                         "script's, whose flag reads XLA's temp buffer")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from distegnn_tpu_torch import resolve_device

    device = resolve_device(args.device)
    rows = []
    for n in args.nodes:
        for remat in (False, True):
            r = saved_bytes(n, remat, args.seg, device)
            if args.xla_temp:
                r.update(card_peak_bytes(n, remat, args.seg, device))
            rows.append(r)
            print(f"N={n:>7} remat={str(remat):5} "
                  f"residuals={r['residual_bytes'] / 2**30:.3f} GiB "
                  f"({r['residual_arrays']} arrays)"
                  + (f" card_peak={r['temp_bytes'] / 2**30:.3f} GiB"
                     if args.xla_temp else ""))
        off, on = rows[-2]["residual_bytes"], rows[-1]["residual_bytes"]
        print(f"          -> remat residual reduction {off / max(on, 1):.1f}x")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"backend": device.type,
                       "method": "unique storages autograd saves for the "
                                 "backward (saved_tensors_hooks) plus the "
                                 "remat checkpoints' kept inputs; temp = "
                                 "the card's peak over one grad step",
                       "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
