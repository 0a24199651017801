"""The rank side of tests/test_torch_distributed.py: one process per graph
part, started with ``torch.multiprocessing`` (spawn) over a FileStore. It
imports torch and the port only (no JAX), runs the jobs of an input pickle
on its shard and writes its results to ``rank<r>.pkl``."""

import contextlib
import os
import pickle
import signal
from unittest import mock

import torch

from distegnn_tpu_torch.data.loader import GraphDataset, shard_loader
from distegnn_tpu_torch.models.fast_egnn import FastEGNN
from distegnn_tpu_torch.models.fast_schnet import FastSchNet
from distegnn_tpu_torch.parallel.collectives import all_reduce
from distegnn_tpu_torch.parallel.checks import assert_replicated
from distegnn_tpu_torch.parallel.mesh import (GRAPH_AXIS, destroy_graph_group,
                                              init_graph_group)
from distegnn_tpu_torch.train.step import (TrainState, make_eval_step,
                                           make_loss_fn, make_optimizer,
                                           make_train_step, sum_gradients)

CPU = torch.device("cpu")


@contextlib.contextmanager
def one_rank_group(tmp_dir):
    """This process as the only rank of a gloo group bound to the graph
    axis (a FileStore in ``tmp_dir``), left on exit."""
    init_graph_group(1, 0, "cpu", "file://" + os.path.join(str(tmp_dir),
                                                           "store1"))
    try:
        yield
    finally:
        destroy_graph_group()


def _np(t):
    return t.detach().cpu().numpy()


def _batch(job, rank):
    loader = shard_loader(GraphDataset(job["shards"][rank]),
                          job["batch_size"], GRAPH_AXIS, CPU, shuffle=True,
                          seed=job["seed"], **job["loader"])
    loader.set_epoch(1)
    return next(iter(loader))


FAMILIES = {"FastEGNN": FastEGNN, "FastSchNet": FastSchNet}


def _model(job, sd, **over):
    kw = dict(job["model"], **over)
    m = FAMILIES[job.get("family", "FastEGNN")](axis_name=GRAPH_AXIS, **kw)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return m


def _step_job(job, rank):
    """Layout, forward, eval loss, one train step (MMD from injected
    indices), the parameters after it and Adam's first moment."""
    batch = _batch(job, rank)
    model = _model(job, job["state_dict"])
    out = {"batch": {k: _np(v) for k, v in vars(batch).items()
                     if isinstance(v, torch.Tensor)}}
    with torch.no_grad():
        x, X = model(batch)
    out["x"], out["X"] = _np(x), _np(X)
    out["eval"] = float(make_eval_step(model, GRAPH_AXIS)(batch))
    h = job["hyper"]
    opt = make_optimizer(model.parameters(), h["lr"],
                         weight_decay=h["weight_decay"], clip_norm=h["clip"])
    step = make_train_step(model, opt, h["mmd_weight"], h["mmd_sigma"],
                           h["mmd_samples"], axis_name=GRAPH_AXIS)
    idx = job.get("mmd_idx")
    _, m = step(TrainState(model, opt), batch,
                mmd_idx=None if idx is None else torch.from_numpy(idx[rank]))
    out.update({k: float(v) for k, v in m.items()})
    out["params"] = {k: _np(v) for k, v in model.state_dict().items()}
    out["mu"] = {n: _np(opt.adam.state[p]["exp_avg"])
                 for n, p in model.named_parameters()}
    return out


def _grad_job(job, rank):
    """Forward, the MSE-only loss and the gradient summed over the ranks
    (the union invariant)."""
    batch = _batch(job, rank)
    model = _model(job, job["state_dict"])
    with torch.no_grad():
        x, X = model(batch)
    loss, logged = make_loss_fn(model, 0.0, 1.5, 3, GRAPH_AXIS)(batch)
    loss.backward()
    params = list(model.parameters())
    sum_gradients(params, GRAPH_AXIS)
    total = all_reduce(logged.detach().reshape(1), GRAPH_AXIS, "loss")
    names = [n for n, _ in model.named_parameters()]
    return {"x": _np(x), "X": _np(X), "n_real": int(batch.node_mask.sum()),
            "loss": float(total[0]),
            "grads": {n: _np(p.grad) for n, p in zip(names, params)}}


def _stack_job(job, rank):
    """fused_stack under the axis runs the per-layer fused layers: the same
    forward as edge_impl='fused', and the megakernel is never called."""
    batch = _batch(job, rank)
    fused = _model(job, job["state_dict"], edge_impl="fused")
    stack = _model(job, job["state_dict"], edge_impl="fused_stack")

    def no_stack(*a, **k):
        raise AssertionError("the megakernel ran under a graph axis")

    with torch.no_grad(), mock.patch(
            "distegnn_tpu_torch.models.fast_egnn.fused_egnn_stack_batch",
            no_stack):
        a, A = fused(batch)
        b, B = stack(batch)
    return {"same": bool(torch.equal(a, b) and torch.equal(A, B))}


def _replicated_job(job, rank):
    """assert_replicated passes on replicated parameters and raises on
    every rank once one rank's parameters differ."""
    model = _model(job, job["state_dict"])
    assert_replicated(model, GRAPH_AXIS, "start")
    if rank == 1:
        with torch.no_grad():
            next(model.parameters()).add_(1e-7)
    try:
        assert_replicated(model, GRAPH_AXIS, "end")
    except AssertionError as exc:
        return {"raised": str(exc)}
    return {"raised": None}


class Killer:
    """A loader that sends this process SIGTERM before batch ``at`` (over
    the whole run)."""

    def __init__(self, loader, at):
        self.loader, self.at, self.n = loader, at, 0

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            if self.n == self.at:
                os.kill(os.getpid(), signal.SIGTERM)
            self.n += 1
            yield batch


def _train_job(job, rank):
    """``main.train_model`` on this rank's shards with the job's config; a
    SIGTERM to the ranks in ``job['kill']`` before batch ``job['at']``.
    Returns the micro-steps run, the preemption record, the files this
    rank wrote and the final parameters."""
    from distegnn_tpu_torch.config import ConfigDict
    from distegnn_tpu_torch.main import train_model
    from distegnn_tpu_torch.train import checkpoint as ckpt

    cfg = ConfigDict(job["config"])
    loaders = [shard_loader(GraphDataset(split[rank]), 1, GRAPH_AXIS, CPU,
                            shuffle=(i == 0), seed=cfg.seed)
               for i, split in enumerate(job["splits"])]
    if rank in job.get("kill", ()):
        loaders[0] = Killer(loaders[0], job["at"])
    model = _model(job, job["state_dict"])
    steps, writes = [], []
    real = ckpt._write_atomic

    def counted(path, data):
        writes.append(os.path.basename(path))
        return real(path, data)

    with mock.patch.object(ckpt, "_write_atomic", counted):
        _, _, best, _ = train_model(
            cfg, model, loaders, CPU, axis_name=GRAPH_AXIS, rank=rank,
            on_step=lambda e, s, m: steps.append((e, s)))
    return {"steps": steps, "preempted": best.get("preempted"),
            "writes": writes,
            "params": {k: _np(v) for k, v in model.state_dict().items()}}


def _consensus_job(job, rank):
    """Resume coordinates that differ across the ranks raise on every
    rank."""
    from distegnn_tpu_torch.train.checkpoint import (ResumeConsensusError,
                                                     verify_resume_consensus)

    verify_resume_consensus(1, 2, GRAPH_AXIS)       # agreed: passes
    try:
        verify_resume_consensus(1, 2 + rank, GRAPH_AXIS, path="mine.ckpt")
    except ResumeConsensusError as exc:
        return {"lagging": exc.lagging, "coords": exc.coords}
    return {"lagging": None}


JOBS = {"step": _step_job, "grad": _grad_job, "stack": _stack_job,
        "replicated": _replicated_job, "train": _train_job,
        "consensus": _consensus_job}


def run_rank(rank, world_size, init_method, in_path, out_dir):
    torch.set_num_threads(1)
    init_graph_group(world_size, rank, "cpu", init_method)
    try:
        with open(in_path, "rb") as f:
            jobs = pickle.load(f)
        results = {name: JOBS[job["kind"]](job, rank)
                   for name, job in jobs.items()}
        results["counts"] = dict(all_reduce.counts)
    finally:
        destroy_graph_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def start(jobs, world_size, tmp):
    """Start ``world_size`` ranks on ``jobs``; returns their context (the
    caller works meanwhile, then calls :func:`collect`)."""
    in_path = os.path.join(tmp, "jobs.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(jobs, f)
    return torch.multiprocessing.start_processes(
        run_rank, args=(world_size, "file://" + os.path.join(tmp, "store"),
                        in_path, tmp),
        nprocs=world_size, join=False, start_method="spawn")


def collect(ctx, world_size, tmp):
    """Wait for the ranks (raising if one failed); their results."""
    while not ctx.join(timeout=300):
        pass
    out = []
    for r in range(world_size):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
