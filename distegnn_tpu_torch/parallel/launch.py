"""Distributed (DistEGNN) training over ``torch.distributed`` (port of
``distegnn_tpu/parallel/launch.py``).

One process per rank of the (data, graph, tensor) mesh (parallel/mesh.py,
as JAX's ``parallel.mesh`` / ``data.data_parallel`` / ``data.world_size``
shape it): rank (d, g, t) reads shard g of every graph
(data/distribute.py), keeps data shard d of each draw of D x batch_size
graphs, and computes slice t of the hidden width. The ranks couple through
the per-layer virtual-node sums (graph axis), the hidden-width collectives
(tensor axis), the loss's node counts and one gradient sum per update
((data, graph); parallel/collectives.py, train/step.py), so every rank
applies the same update and the parameters stay replicated (checked
bitwise by broadcast over the whole world at the start and the end, as the
reference checks at start-up).

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

from distegnn_tpu_torch import obs, resolve_device
from distegnn_tpu_torch.parallel.checks import assert_replicated
from distegnn_tpu_torch.parallel.mesh import (DATA_AXIS, GRAPH_AXIS,
                                              TENSOR_AXIS, WORLD_AXES,
                                              destroy_graph_group,
                                              init_graph_group, mesh_coords,
                                              mesh_shape)


def _log(msg: str) -> None:
    obs.log(f"[train] {msg}")


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


def rank_loaders(config, split_paths, rank: int, device: torch.device,
                 data_parallel: int = 1, data_index: int = 0):
    """The (train, valid, test) loaders over shard ``rank`` (the graph
    part) of each split, prefetched to ``device``; with ``data_parallel``
    D > 1 each keeps data shard ``data_index`` of every draw of D x
    batch_size graphs. A shard that is a ``write_shards`` directory streams
    (``data.stream_shard_cache`` decoded shards resident); a pickle is read
    whole."""
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
            in ("fused", "fused_stack"),
            data_parallel=data_parallel, data_index=data_index),
            put, depth=int(d.get("prefetch_depth", 2))))
    return loaders


def mesh_of_config(config, cards: int):
    """(D, P, T) of a distribute run, as JAX's ``run_distributed`` derives
    them: T = ``parallel.mesh.tensor``, D = ``parallel.mesh.data`` or
    ``data.data_parallel``, P = ``parallel.mesh.graph`` or
    ``data.world_size``, else ``cards // (D T)`` (at least 1)."""
    pmesh = (config.get("parallel") or {}).get("mesh") or {}
    tp = int(pmesh.get("tensor") or 1)
    dp = int(pmesh.get("data") or config.data.get("data_parallel") or 1)
    ws = pmesh.get("graph") or config.data.get("world_size")
    ws = int(ws) if ws else max(1, cards // (dp * tp))
    return dp, ws, tp


def train_rank(config, split_paths, rank: int, world_size: int,
               device: torch.device, on_step: Optional[Callable] = None):
    """One rank's run inside an initialised group: its loaders (graph part
    g, data shard d), the model from the config's seed (replicated; slice
    t of its hidden width under the tensor axis), and the shared trainer.
    ``world_size`` is the whole mesh's, laid out as ``parallel.mesh``.
    Under ``train.scan_epochs`` (on the card when the staged data of the
    card's ranks fit) the eager loop runs on staged device data without
    capture (``train.scan_epoch.DistributedScanRunner`` in place of the
    loaders, from ``main.make_scan_runner``). Returns the trainer's
    best."""
    from distegnn_tpu_torch.main import train_model
    from distegnn_tpu_torch.models.registry import get_model
    from distegnn_tpu_torch.utils.seed import fix_seed

    shape = mesh_shape()
    d, g, _ = mesh_coords(rank, shape)
    fix_seed(config.seed)
    loaders = rank_loaders(config, split_paths, g, device,
                           data_parallel=shape[0], data_index=d)
    gen = torch.Generator().manual_seed(int(config.seed))
    model = get_model(config.model, world_size=shape[1],
                      dataset_name=config.data.dataset_name,
                      axis_name=GRAPH_AXIS, generator=gen,
                      tensor_axis=TENSOR_AXIS if shape[2] > 1 else None
                      ).to(device)
    assert_replicated(model, WORLD_AXES, "start")
    if rank == 0:
        n_params = sum(p.numel() for p in model.parameters())
        _log(f"Data ready: {len(loaders[0].loader.dataset)} graphs x "
             f"{shape[1]} partitions x {shape[0]} data shards; Model: "
             f"{config.model.model_name}, {n_params} parameters, mesh "
             f"data={shape[0]} graph={shape[1]} tensor={shape[2]}, on "
             f"{device}")
    _, _, best, _ = train_model(
        config, model, loaders, device, on_step=on_step, axis_name=GRAPH_AXIS,
        rank=rank, data_axis_name=DATA_AXIS if shape[0] > 1 else None)
    assert_replicated(model, WORLD_AXES, "end")
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
    m = config.parallel.mesh
    shape = (int(m.data), int(m.graph), int(m.tensor))
    gg = init_graph_group(world_size, rank, device_type, init_method, shape)
    try:
        if split_paths is None:
            if rank == 0:
                split_paths = _dispatch_preprocess(config, shape[1])
            dist.barrier()
            if rank != 0:
                split_paths = _dispatch_preprocess(config, shape[1])
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
    """Distribute-mode training of ``config`` over the D x P x T ranks of
    its mesh (:func:`mesh_of_config`: P graph parts, ``data.world_size``,
    derived when unset from ``parallel.mesh.graph``, else the card count
    over D T; D data shards; T hidden-width slices), recorded in
    ``config.parallel.mesh``. ``split_paths``: [train, valid, test] lists of
    P shard pickles or ``write_shards`` directories (default: the dataset's
    pickles, preprocessed here). ``device`` 'cuda' (the default; refuses to
    fall back) or 'cpu' (gloo ranks on the CPU). ``on_step(epoch, step,
    metrics)`` (picklable) runs in every rank after every micro-step.
    Returns rank 0's best."""
    from distegnn_tpu_torch.config import derive_runtime_fields
    from distegnn_tpu_torch.train.checkpoint import adopt_resume_seed

    device_type = resolve_device(device).type
    cards = torch.cuda.device_count() if device_type == "cuda" else 1
    env = os.environ
    torchrun = all(k in env for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    if torchrun:
        # the processes are given: the graph parts are what D and T leave
        dp, _, tp = mesh_of_config(config, cards)
        cards = int(env["WORLD_SIZE"])
        if cards % (dp * tp):
            raise ValueError(f"WORLD_SIZE={cards} is not a multiple of "
                             f"data x tensor = {dp} x {tp}")
        config.data.world_size = config.parallel.mesh.graph = None
    dp, ws, tp = mesh_of_config(config, cards)
    derive_runtime_fields(config, world_size=ws)
    config.parallel.mesh = {"data": dp, "graph": ws, "tensor": tp}
    world_size = dp * ws * tp
    adopt_resume_seed(config)
    if torchrun:
        return _rank_main(int(env["RANK"]), world_size, config, split_paths,
                          device_type, "env://", on_step, None)
    if split_paths is None:
        split_paths = _dispatch_preprocess(config, ws)
    if any(len(p) != ws for p in split_paths):
        raise ValueError(f"split_paths must hold {ws} shard files "
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
