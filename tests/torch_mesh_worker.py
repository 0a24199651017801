"""The rank side of tests/test_torch_mesh.py: one process per rank of a
(data, graph, tensor) mesh, started with ``torch.multiprocessing`` over a
FileStore. The ranks fork from a forkserver that has imported this module
(torch and the port) once, so the 8 ranks do not each import torch. It
imports torch and the port only (no JAX), runs the jobs of an input pickle
as rank (d, g, t) and writes its results to ``rank<r>.pkl``."""

import multiprocessing
import os
import pickle
from unittest import mock

import numpy as np
import torch

from distegnn_tpu_torch.data.loader import GraphDataset, shard_loader
from distegnn_tpu_torch.models.fast_egnn import FastEGNN
from distegnn_tpu_torch.parallel import collectives as coll
from distegnn_tpu_torch.parallel.checks import assert_replicated
from distegnn_tpu_torch.parallel.mesh import (DATA_AXIS, GRAPH_AXIS,
                                              TENSOR_AXIS, WORLD_AXES,
                                              destroy_graph_group,
                                              init_graph_group, mesh_coords)
from distegnn_tpu_torch.train.step import (TrainState, make_eval_step,
                                           make_optimizer, make_train_step)

CPU = torch.device("cpu")


def _np(t):
    return t.detach().cpu().numpy()


def _batch(job, d, g):
    loader = shard_loader(GraphDataset(job["shards"][g]), job["batch_size"],
                          GRAPH_AXIS, CPU, shuffle=True, seed=job["seed"],
                          data_parallel=job["mesh"][0], data_index=d,
                          **job["loader"])
    loader.set_epoch(1)
    return next(iter(loader))


def _model(job, **over):
    m = FastEGNN(axis_name=GRAPH_AXIS, tensor_axis=TENSOR_AXIS,
                 **dict(job["model"], **over))
    m.load_state_dict({k: torch.from_numpy(v)
                       for k, v in job["state_dict"].items()})
    return m


def _step_job(job, rank):
    """Layout, forward, eval loss, one train step (MMD from injected
    indices) and the parameters and Adam's first moment after it; with
    ``stack``, also the fused_stack forward (the megakernel never called)."""
    d, g, _ = mesh_coords(rank, job["mesh"])
    batch = _batch(job, d, g)
    model = _model(job)
    out = {"batch": {k: _np(v) for k, v in vars(batch).items()
                     if isinstance(v, torch.Tensor)}}
    with torch.no_grad():
        x, X = model(batch)
    out["x"], out["X"] = _np(x), _np(X)
    if job.get("stack"):
        stack = _model(job, edge_impl="fused_stack")

        def no_stack(*a, **k):
            raise AssertionError("the megakernel ran under the mesh")

        with torch.no_grad(), mock.patch(
                "distegnn_tpu_torch.models.fast_egnn.fused_egnn_stack_batch",
                no_stack):
            xs, Xs = stack(batch)
        out["stack_same"] = bool(torch.equal(x, xs) and torch.equal(X, Xs))
    out["eval"] = float(make_eval_step(model, GRAPH_AXIS, DATA_AXIS)(batch))
    h = job["hyper"]
    opt = make_optimizer(model.parameters(), h["lr"],
                         weight_decay=h["weight_decay"], clip_norm=h["clip"])
    step = make_train_step(model, opt, h["mmd_weight"], h["mmd_sigma"],
                           h["mmd_samples"], axis_name=GRAPH_AXIS,
                           data_axis_name=DATA_AXIS)
    idx = torch.from_numpy(job["mmd_idx"][d][g])
    _, m = step(TrainState(model, opt), batch, mmd_idx=idx)
    out.update({k: float(v) for k, v in m.items()})
    out["params"] = {k: _np(v) for k, v in model.state_dict().items()}
    out["mu"] = {n: _np(opt.adam.state[p]["exp_avg"])
                 for n, p in model.named_parameters()}
    assert_replicated(model, WORLD_AXES, "end")
    return out


TP_FUNCS = {"tp_copy": coll.tp_copy, "tp_reduce": coll.tp_reduce,
            "tp_gather": coll.tp_gather, "tp_slice": coll.tp_slice,
            "tp_slice_rows": coll.tp_slice_rows, "tp_once": coll.tp_once}


def _tp_job(job, rank):
    """Each tp_* function's forward and backward on this rank's inputs."""
    d, g, t = mesh_coords(rank, job["mesh"])
    out = {}
    for name, fn in TP_FUNCS.items():
        x = torch.from_numpy(job["x"][name][d, g, t]).requires_grad_()
        y = fn(x, TENSOR_AXIS)
        (gx,) = torch.autograd.grad(
            y, x, torch.from_numpy(job["ct"][name][d, g, t]))
        out[name] = (_np(y), _np(gx))
    return out


JOBS = {"step": _step_job, "tp": _tp_job}


def run_rank(rank, mesh, init_method, in_path, out_dir):
    torch.set_num_threads(1)
    world = int(np.prod(mesh))
    init_graph_group(world, rank, "cpu", init_method, mesh)
    try:
        with open(in_path, "rb") as f:
            jobs = pickle.load(f)
        results = {name: JOBS[job["kind"]](job, rank)
                   for name, job in jobs.items()}
        results["counts"] = {"all_reduce": dict(coll.all_reduce.counts),
                             "all_gather": dict(coll.all_gather.counts)}
    finally:
        destroy_graph_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def start(jobs, mesh, tmp):
    """Start the mesh's ranks on ``jobs``; returns their context (the
    caller works meanwhile, then calls :func:`collect`)."""
    in_path = os.path.join(tmp, "jobs.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(jobs, f)
    # a no-op where this process's forkserver already runs
    multiprocessing.set_forkserver_preload([__name__])
    return torch.multiprocessing.start_processes(
        run_rank, args=(tuple(mesh), "file://" + os.path.join(tmp, "store"),
                        in_path, tmp),
        nprocs=int(np.prod(mesh)), join=False, start_method="forkserver")


def collect(ctx, world_size, tmp):
    """Wait for the ranks (raising if one failed); their results."""
    while not ctx.join(timeout=300):
        pass
    out = []
    for r in range(world_size):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
