"""The scanned epoch (port of ``distegnn_tpu/train/scan_epoch.py``): the
epoch on staged device data.

JAX folds an epoch into one ``lax.scan`` over a device-resident stacked
dataset, so that the host dispatches once an epoch. The port stages the
data the same way: every graph of a loader's dataset padded to the loader's
dataset-wide layout (``loader._graph`` and ``loader.pad_kwargs()``, what its
``__iter__`` pads to) and stacked on a leading axis on the device, once. An
epoch then picks each step's batch on the device, into fixed input
buffers, from the loader's permutation (``set_epoch`` + ``_order``, the
eager loop's), and the loss sums stay on the device: the host reads once an
epoch. The steps' generators are the eager loop's
(:func:`~distegnn_tpu_torch.train.step.step_generator`), so a scanned
epoch is the same training run as the eager one.

:class:`ScanEpochRunner` (one process): on the card the micro-step is
captured into CUDA graphs once a runner, after a warm-up on a side stream
whose effects on the state are undone: a graph that only accumulates, one
that ends in the optimizer update, and a forward-only eval graph per split.
An epoch replays them, the host picking the graph from
``Optimizer.micro``; before each replay the host writes the batch's indices
(a device copy) and the MMD draw (the eager loop's ``torch.rand`` call on
the step's generator, into a fixed buffer). The update graph ends in the
gradient clip; the Adam step follows it eagerly (``Optimizer.adam_step``,
torch's own Adam as in the eager loop), so its rate (the cosine schedule,
the rollback's ``lr_scale``) and its step count stay numbers on the host
and its arithmetic is the eager loop's. The graphs hold the parameters and
their gradients by address, so the optimizer keeps its gradients in place
(``Optimizer.stage``): a rollback (``trainer.restore_state``) or a
checkpoint load copies into them, and ``load_state_dict`` copies into the
parameters. On the CPU the runner runs the same
per-step body without capture. A failed capture or replay raises
:class:`ScanCaptureError` naming the operation; nothing falls back to the
eager loop.

The kernels' Python launch counters count at capture, not at replay:
:meth:`ScanEpochRunner.launches` gives each counter's launches as captured
x replays. Each capture adds one to ``scan/captures`` in the metrics
registry and writes a ``scan/capture`` event (its ms and the graph pool's
bytes): one per runner, and any later one is a recapture to look into (the
counterpart of JAX's compile watcher).

:class:`DistributedScanRunner` (distribute mode) is a rank's staged
loader: it stages only the rank's own partition's ``[G, ...]`` stack and
picks with the ``[S, B]`` permutation, or its data slice of the
``[S, D, B]`` one under the data axis. It captures nothing: the gloo
collectives of the distributed step run on the host and cannot be
captured. The trainer's eager loop runs on it in place of the rank's
loader, so the epoch loop, its hooks and its ``batch_consistency`` check
are the eager ones.
"""

from __future__ import annotations

import collections
import dataclasses
import socket
import time
from typing import Dict, Optional

import numpy as np
import torch

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.ops.graph import GraphBatch, pad_graphs
from distegnn_tpu_torch.train.step import TrainState, step_generator

# the auto policy's share of the card's memory for the staged data (the
# parameters, the optimizer and the activations need the rest), as in JAX
SCAN_MEMORY_SHARE = 0.4


class ScanCaptureError(RuntimeError):
    """A capture or a replay of the scanned epoch's CUDA graphs failed."""


def scan_enabled(flag, total_nbytes: int, device) -> bool:
    """The ``train.scan_epochs`` policy, shared by main.py (one process)
    and parallel.launch (distribute mode): False turns the scan off and
    True on; 'auto' turns it off on the CPU and, on the card, on when the
    staged data (``total_nbytes``: all splits of every process on the
    card, :func:`card_nbytes`) fit :data:`SCAN_MEMORY_SHARE` of the
    card's memory."""
    if flag is not True and flag != "auto":
        return False
    if flag is True:
        return True
    dev = torch.device(device)
    if dev.type != "cuda":
        return False
    total = torch.cuda.get_device_properties(dev).total_memory
    return total_nbytes <= int(total * SCAN_MEMORY_SHARE)


def card_nbytes(nbytes: int, device) -> int:
    """The staged bytes of every process on this process's card: in a
    distributed run the ranks gather (host, device, bytes) and sum those
    sharing this rank's host and device (ranks of one machine may share a
    card); else ``nbytes``. A collective over the default group when one
    is initialised: every rank calls it."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return int(nbytes)
    dev = torch.device(device)
    index = dev.index
    if index is None and dev.type == "cuda":
        index = torch.cuda.current_device()
    key = (socket.gethostname(), dev.type, index)
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (key, int(nbytes)))
    return sum(n for k, n in got if k == key)


def _base(loader):
    """The GraphLoader under a PrefetchLoader."""
    return getattr(loader, "loader", loader)


def stack_dataset(loader, device=None) -> GraphBatch:
    """Every graph of ``loader``'s dataset padded to the loader's layout
    and stacked into one GraphBatch with leading axis [num_graphs], on
    ``device``. ``loader._graph`` (not ``loader.dataset[i]``), so that
    edge_block loaders stack the blockified graphs their ``__iter__``
    pads."""
    ld = _base(loader)
    batch = pad_graphs([ld._graph(i) for i in range(len(ld.dataset))],
                       **ld.pad_kwargs())
    return batch if device is None else batch.to(device)


def _tensors(batch: GraphBatch):
    return [(f.name, getattr(batch, f.name))
            for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), torch.Tensor)]


def dataset_nbytes(loader) -> int:
    """The device footprint of :func:`stack_dataset`: one padded graph's
    bytes times the dataset's graphs."""
    ld = _base(loader)
    g0 = pad_graphs([ld._graph(0)], **ld.pad_kwargs())
    return sum(t.nbytes for _, t in _tensors(g0)) * len(ld.dataset)


# JAX's names for distribute mode, where the port's ranks each stage their
# own partition: the stack and its footprint are a one-process loader's
stack_sharded_dataset = stack_dataset
sharded_dataset_nbytes = dataset_nbytes


def pick(data: GraphBatch, idx: torch.Tensor,
         out: Optional[GraphBatch] = None) -> GraphBatch:
    """The graphs ``idx`` of a staged stack as a batch (into ``out``'s
    tensors when given: the fixed inputs of a captured graph)."""
    if out is None:
        return data._map(lambda v: v.index_select(0, idx))
    for name, t in _tensors(data):
        torch.index_select(t, 0, idx, out=getattr(out, name))
    return out


def _launch_counts() -> Dict[str, int]:
    """The kernels' Python launch counters, by name."""
    from distegnn_tpu_torch.ops import blocked, cumsum, edge_pipeline
    from distegnn_tpu_torch.ops import layer_pipeline

    fe = edge_pipeline.fused_edge_layer
    return {"fused_edge_fwd": fe.launches, "fused_edge_bwd": fe.bwd_launches,
            "fused_edge_fwd_tc": fe.tc_launches,
            "fused_edge_fwd_f32": fe.f32_launches,
            "prefix_scan": cumsum.prefix_sum.launches,
            "suffix_scan": cumsum.prefix_sum.suffix_launches,
            "fused_stack_fwd": layer_pipeline.fused_egnn_stack.launches,
            "blocked_plan": blocked.blocked_plan.launches,
            "blocked_seg_sum": blocked.blocked_segment_sum.launches,
            "blocked_gather": blocked.blocked_gather.launches}


class _Split:
    """A staged split and the fixed inputs of its step."""

    def __init__(self, loader, device):
        ld = _base(loader)
        self.steps, self.batch_size = len(ld), ld.batch_size
        self.data = stack_dataset(ld, device)
        # the eval order (unshuffled); a train epoch copies its own in
        self.perm = torch.arange(self.steps * self.batch_size,
                                 device=device).reshape(self.steps,
                                                        self.batch_size)
        self.idx = self.perm[0].clone()
        self.batch = pick(self.data, self.idx)
        self.total = torch.zeros((), dtype=torch.float32, device=device)


class ScanEpochRunner:
    """Scanned replacements for ``run_epoch_train`` / ``run_epoch_eval`` on
    one process (the module docstring). ``train_step`` is the eager loop's
    :class:`~distegnn_tpu_torch.train.step.TrainStep` and ``eval_step`` its
    eval step over the same model. It captures where the model lies on
    the card."""

    def __init__(self, train_step, eval_step, loader_train, seed: int,
                 loader_valid=None, loader_test=None):
        self.train_step, self.eval_step = train_step, eval_step
        self.model, self.optimizer = train_step.model, train_step.optimizer
        self.device = next(self.model.parameters()).device
        self.capture = self.device.type == "cuda"
        self.seed = int(seed)
        self.loader = _base(loader_train)
        self.train = _Split(loader_train, self.device)
        self.num_steps, self.batch_size = self.train.steps, \
            self.train.batch_size
        shape = train_step.mmd_draw_shape(self.train.batch)
        self.u = (None if shape is None else
                  torch.zeros(shape, dtype=torch.float32, device=self.device))
        self.eval_sets = {}
        if eval_step is not None:
            for name, ld in (("valid", loader_valid), ("test", loader_test)):
                if ld is not None:
                    self.eval_sets[name] = _Split(ld, self.device)
        self.optimizer.stage()
        self.graphs: Optional[dict] = None
        self.captured: Dict[str, Dict[str, int]] = {}
        self.replays: collections.Counter = collections.Counter()
        self.capture_ms: Optional[float] = None
        self.pool_bytes: Optional[int] = None

    # ------------------------------------------------------ the step bodies

    def _train_body(self, update: bool) -> None:
        sp = self.train
        pick(sp.data, sp.idx, sp.batch)
        _, logged = self.train_step.loss_backward(sp.batch, mmd_u=self.u)
        sp.total.add_(logged.detach() * sp.batch_size)
        if update:
            self.optimizer.clip()

    def _eval_body(self, name: str) -> None:
        sp = self.eval_sets[name]
        pick(sp.data, sp.idx, sp.batch)
        sp.total.add_(self.eval_step(sp.batch) * sp.batch_size)

    def _bodies(self) -> dict:
        out = {"update": lambda: self._train_body(True)}
        if self.optimizer.accumulation_steps > 1:
            out["accumulate"] = lambda: self._train_body(False)
        for name in self.eval_sets:
            out[f"eval_{name}"] = (lambda n=name: self._eval_body(n))
        return out

    # ------------------------------------------------------------- capture

    def _capture(self) -> None:
        """Warm every body up on a side stream (the kernels' build and
        load, the libraries' workspaces), undo the warm-up's effect on the
        state (the gradients), then capture each body into a CUDA graph of
        one shared memory pool."""
        from distegnn_tpu_torch.train.trainer import (restore_state,
                                                      snapshot_state)

        dev, bodies = self.device, self._bodies()
        held = TrainState(self.model, self.optimizer)
        snap = snapshot_state(held)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(side):
                for body in bodies.values():
                    body()
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
        except Exception as exc:
            raise ScanCaptureError(
                f"the scanned epoch's warm-up before capture failed: "
                f"{exc!r}") from exc
        restore_state(held, snap)
        torch.cuda.synchronize(dev)
        # the pool's bytes: what the captures reserve past an emptied cache
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        pool = torch.cuda.graph_pool_handle()
        graphs = {}
        for name, body in bodies.items():
            before = _launch_counts()
            g = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(g, pool=pool):
                    body()
            except Exception as exc:
                raise ScanCaptureError(
                    f"capture of the scanned epoch's {name!r} graph "
                    f"failed: {exc!r}") from exc
            after = _launch_counts()
            self.captured[name] = {k: after[k] - before[k] for k in after
                                   if after[k] != before[k]}
            graphs[name] = g
        torch.cuda.synchronize(dev)
        self.graphs = graphs
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        obs.get_registry().counter("scan/captures").add(1)
        obs.event("scan/capture", graphs=sorted(graphs),
                  ms=round(self.capture_ms, 3), pool_bytes=self.pool_bytes)

    def _ready(self) -> None:
        """Capture on the card at the runner's first epoch, before its
        sums are zeroed (the warm-up adds into them)."""
        if self.capture and self.graphs is None:
            self._capture()

    def _run(self, name: str) -> None:
        self.replays[name] += 1
        if not self.capture:
            self._bodies()[name]()
            return
        try:
            self.graphs[name].replay()
        except Exception as exc:
            raise ScanCaptureError(
                f"replay of the scanned epoch's {name!r} graph failed: "
                f"{exc!r}") from exc

    def launches(self) -> Dict[str, int]:
        """Each kernel counter's launches in the replays so far: the
        launches captured into each graph times its replays (on the CPU,
        where nothing is captured, empty)."""
        out: collections.Counter = collections.Counter()
        for name, counts in self.captured.items():
            for k, n in counts.items():
                out[k] += n * self.replays[name]
        return dict(out)

    # -------------------------------------------------------------- epochs

    def _perm(self, epoch: int) -> torch.Tensor:
        """The eager loader's order of ``epoch`` as [S, B] on the device
        (one copy an epoch)."""
        self.loader.set_epoch(epoch)
        order = self.loader._order()[: self.num_steps * self.batch_size]
        return torch.from_numpy(np.ascontiguousarray(
            order.reshape(self.num_steps, self.batch_size))).to(self.device)

    def train_epoch(self, state: TrainState, epoch: int):
        """One scanned training epoch of ``state`` (the runner's model and
        optimizer). Returns (state, the epoch's mean logged loss)."""
        if state.model is not self.model or \
                state.optimizer is not self.optimizer:
            raise ValueError("ScanEpochRunner.train_epoch: the state holds "
                             "another model or optimizer than the runner's "
                             "train step")
        self._ready()
        perm, opt, sp = self._perm(epoch), self.optimizer, self.train
        sp.total.zero_()
        for s in range(self.num_steps):
            sp.idx.copy_(perm[s])
            if self.u is not None:
                # the eager loss's draw (train/loss.py), into the buffer
                torch.rand(self.u.shape, generator=step_generator(
                    self.seed, epoch, s, self.device), out=self.u)
            updated = opt.next_is_update()
            self._run("update" if updated else "accumulate")
            if updated:
                opt.adam_step()
            opt.count(updated)
            state.step += 1
        return state, float(sp.total) / (self.num_steps * self.batch_size)

    def eval_epoch(self, model, split: str) -> float:
        """The node-weighted eval loss of ``split`` ('valid' or 'test')
        over its staged set, for the runner's model."""
        if model is not self.model:
            raise ValueError("ScanEpochRunner.eval_epoch: another model than "
                             "the runner's")
        self._ready()
        sp = self.eval_sets[split]
        sp.total.zero_()
        for s in range(sp.steps):
            sp.idx.copy_(sp.perm[s])
            self._run(f"eval_{split}")
        return float(sp.total) / (sp.steps * sp.batch_size)


class DistributedScanRunner:
    """A rank's staged loader for distribute mode (the module docstring):
    ``loader``'s dataset stacked on ``device`` once, and batches picked
    from it on the device in the loader's order. It stands in for the
    rank's loader in the trainer's eager loop (``run_epoch_train`` /
    ``run_epoch_eval``: the per-step hooks, cadence saves and stop checks
    stay). The loader is the rank's own (``data.loader.shard_loader``):
    under the data axis it draws D x B graphs and keeps rows
    [d B, (d + 1) B), so the rank picks its data slice of the [S, D, B]
    permutation."""

    staged = True

    def __init__(self, loader, device):
        self.loader = _base(loader)
        self.device = torch.device(device)
        self.data = stack_sharded_dataset(self.loader, self.device)

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def _perm(self) -> torch.Tensor:
        """This rank's [S, B] indices of the loader's order: under the
        data axis (``rows``) its slice d of the [S, D, B] layout."""
        ld, steps = self.loader, len(self.loader)
        o = np.asarray(ld._order()[: steps * ld.batch_size], dtype=np.int64)
        o = o.reshape(steps, ld.batch_size)
        if ld.rows is not None:
            a, b = ld.rows
            o = o[:, a:b]
        return torch.from_numpy(np.ascontiguousarray(o)).to(self.device)

    def __iter__(self):
        perm = self._perm()
        for s in range(len(self)):
            yield pick(self.data, perm[s])
