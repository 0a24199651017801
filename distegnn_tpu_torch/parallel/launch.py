"""Distributed (DistEGNN) training over ``torch.distributed`` (port of
``distegnn_tpu/parallel/launch.py``).

One process per graph part: rank r reads shard r of every graph
(data/distribute.py), trains the same model on it, and the ranks couple
through the per-layer virtual-node sums, the loss's node counts and one
gradient sum per update (parallel/collectives.py, train/step.py), so every
rank applies the same update and the parameters stay replicated (checked
bitwise by broadcast at the start and the end, as the reference checks at
start-up).

:func:`run_distributed` preprocesses once and builds every CUDA kernel and
the native library in the calling process, then starts ``world_size`` ranks
with ``torch.multiprocessing`` (start method ``spawn``: CUDA cannot fork)
over a ``FileStore`` in a temporary directory; one rank runs in the calling
process. Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``
set) each process instead joins as its rank: rank 0 preprocesses while the
others wait at a barrier. A failed rank fails the run.

Each rank's main thread installs its own preemption guard (the trainer's);
they agree on a stop after the same micro-step, rank 0 writes the
checkpoint, and a resume (``train.resume``) has every rank resolve its
own candidate and agree on it (train/checkpoint.py) before the first step.
The parent of spawned ranks holds its first SIGTERM / SIGINT so that it
cannot end the group while the ranks checkpoint.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from distegnn_tpu_torch import resolve_device
from distegnn_tpu_torch.parallel.checks import assert_replicated
from distegnn_tpu_torch.parallel.mesh import (GRAPH_AXIS, destroy_graph_group,
                                              init_graph_group)


def _log(msg: str) -> None:
    print(f"[train] {msg}", flush=True)


def _dispatch_preprocess(config, ws: int) -> List[List[str]]:
    """The dataset's distribute-mode shard files, [train, valid, test] x
    ``ws``, written if missing (cached by every parameter in their names)."""
    d = config.data
    name = d.dataset_name
    if name.startswith("nbody"):
        from distegnn_tpu_torch.data.distribute import process_nbody_distribute

        return process_nbody_distribute(
            d.data_dir, name, ws, d.max_samples, d.inner_radius,
            d.outer_radius, d.split_mode, d.frame_0, d.frame_T,
            seed=config.seed)
    if name in ("Fluid113K", "LargeFluid"):
        from distegnn_tpu_torch.data.fluid113k import (
            process_large_fluid_distribute)

        return process_large_fluid_distribute(
            d.data_dir, name, ws, d.max_samples, d.inner_radius,
            d.outer_radius, d.split_mode, d.delta_t, seed=config.seed)
    if name == "Water-3D":
        from distegnn_tpu_torch.data.water3d import process_water3d_distribute

        return process_water3d_distribute(
            d.data_dir, name, ws, d.max_samples, d.inner_radius,
            d.outer_radius, d.split_mode, d.delta_t, seed=config.seed)
    raise NotImplementedError(f"{name} has no distribute-mode processor")


def build_native_and_kernels(device_type: str) -> None:
    """Build the native library and (on a card) every CUDA kernel of the
    port before the ranks start, so that they find them built."""
    from distegnn_tpu_torch.native import load_native
    from distegnn_tpu_torch.ops.build import CSRC, build_all

    if load_native() is None:
        _log("no native library (g++ missing or failed): the numpy layout "
             "and partitioner run instead")
    if device_type == "cuda":
        build_all(sorted(f[:-3] for f in os.listdir(CSRC)
                         if f.endswith(".cu")))


def rank_loaders(config, split_paths, rank: int, device: torch.device):
    """This rank's (train, valid, test) loaders over shard ``rank`` of each
    split, prefetched to ``device``. A shard that is a ``write_shards``
    directory streams (``data.stream_shard_cache`` decoded shards
    resident); a pickle is read whole."""
    from distegnn_tpu_torch.data.loader import (PrefetchLoader, device_put,
                                                shard_loader)
    from distegnn_tpu_torch.data.stream import open_dataset

    d = config.data
    edge_block = int(d.edge_block)
    pairing = (True if (not edge_block and config.model.get("segment_impl")
                        in ("cumsum", "ell")) else None)
    put = device_put(device)
    loaders = []
    for i, paths in enumerate(split_paths):
        ds = open_dataset(paths[rank], node_order=d.node_order,
                          cache_shards=int(d.get("stream_shard_cache", 4)))
        loaders.append(PrefetchLoader(shard_loader(
            ds, d.batch_size, GRAPH_AXIS, device, shuffle=(i == 0),
            seed=config.seed, node_bucket=int(d.node_bucket),
            edge_bucket=int(d.edge_bucket), edge_block=edge_block,
            pairing=pairing,
            split_remote=config.model.get("edge_impl")
            in ("fused", "fused_stack")),
            put, depth=int(d.get("prefetch_depth", 2))))
    return loaders


def train_rank(config, split_paths, rank: int, world_size: int,
               device: torch.device, on_step: Optional[Callable] = None):
    """One rank's run inside an initialised group: its loaders, the model
    from the config's seed (replicated), and the shared trainer. Returns
    the trainer's best."""
    from distegnn_tpu_torch.main import train_model
    from distegnn_tpu_torch.models.registry import get_model
    from distegnn_tpu_torch.utils.seed import fix_seed

    fix_seed(config.seed)
    loaders = rank_loaders(config, split_paths, rank, device)
    gen = torch.Generator().manual_seed(int(config.seed))
    model = get_model(config.model, world_size=world_size,
                      dataset_name=config.data.dataset_name,
                      axis_name=GRAPH_AXIS, generator=gen).to(device)
    assert_replicated(model, GRAPH_AXIS, "start")
    if rank == 0:
        n_params = sum(p.numel() for p in model.parameters())
        _log(f"Data ready: {len(loaders[0].loader.dataset)} graphs x "
             f"{world_size} partitions; Model: {config.model.model_name}, "
             f"{n_params} parameters, on {device}")
    _, _, best, _ = train_model(config, model, loaders, device,
                                on_step=on_step, axis_name=GRAPH_AXIS,
                                rank=rank)
    assert_replicated(model, GRAPH_AXIS, "end")
    return best


def _rank_main(rank: int, world_size: int, config, split_paths,
               device_type: str, init_method: str,
               on_step: Optional[Callable], result_dir: Optional[str]):
    """A rank's process: join the group, preprocess (rank 0, when no paths
    were given; the others wait at a barrier and then read the cache),
    train, and write rank 0's best to ``result_dir``."""
    if device_type == "cpu" and world_size > 1:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    gg = init_graph_group(world_size, rank, device_type, init_method)
    try:
        if split_paths is None:
            if rank == 0:
                split_paths = _dispatch_preprocess(config, world_size)
            dist.barrier()
            if rank != 0:
                split_paths = _dispatch_preprocess(config, world_size)
        best = train_rank(config, split_paths, rank, world_size, gg.device,
                          on_step)
        if result_dir is not None and rank == 0:
            with open(os.path.join(result_dir, "rank0.pkl"), "wb") as f:
                pickle.dump(best, f)
        return best
    finally:
        destroy_graph_group()


def run_distributed(config, split_paths: Optional[List[List[str]]] = None,
                    device=None, on_step: Optional[Callable] = None) -> dict:
    """Distribute-mode training of ``config`` over ``data.world_size``
    ranks (derived when unset: ``parallel.mesh.graph``, else the card
    count). ``split_paths``: [train, valid, test] lists of ``world_size``
    shard pickles or ``write_shards`` directories (default: the dataset's
    pickles, preprocessed here). ``device``
    'cuda' (the default; refuses to fall back) or 'cpu' (gloo ranks on the
    CPU). ``on_step(epoch, step, metrics)`` (picklable) runs in every rank
    after every micro-step. Returns rank 0's best."""
    from distegnn_tpu_torch.config import derive_runtime_fields
    from distegnn_tpu_torch.train.checkpoint import adopt_resume_seed

    device_type = resolve_device(device).type
    env = os.environ
    if all(k in env for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")):
        world_size = int(env["WORLD_SIZE"])
        derive_runtime_fields(config, world_size=world_size)
        adopt_resume_seed(config)
        return _rank_main(int(env["RANK"]), world_size, config, split_paths,
                          device_type, "env://", on_step, None)
    derive_runtime_fields(config)
    adopt_resume_seed(config)
    world_size = int(config.data.world_size)
    if split_paths is None:
        split_paths = _dispatch_preprocess(config, world_size)
    if any(len(p) != world_size for p in split_paths):
        raise ValueError(f"split_paths must hold {world_size} shard files "
                         "per split")
    build_native_and_kernels(device_type)
    with tempfile.TemporaryDirectory(prefix="distegnn_ranks_") as tmp:
        args = (world_size, config, split_paths, device_type,
                "file://" + os.path.join(tmp, "store"), on_step, tmp)
        if world_size == 1:
            _rank_main(0, *args)
        else:
            # the parent only waits: a SIGTERM / SIGINT meant for the run is
            # each rank's to handle (they agree on a stop and exit
            # resumable), so the parent's first one must not end the group;
            # a second ends it
            from distegnn_tpu_torch.train.trainer import PreemptionGuard

            guard = PreemptionGuard().install()
            try:
                torch.multiprocessing.start_processes(
                    _rank_main, args=args, nprocs=world_size, join=True,
                    start_method="spawn")
            finally:
                guard.uninstall()
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            return pickle.load(f)
