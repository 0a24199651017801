"""The train and eval steps (port of ``distegnn_tpu/train/step.py``):
forward, loss (masked MSE + MMD), backward, and the optimizer.

The optimizer does what the JAX package's optax chain does:
  clip by global norm (``clip_norm``) -> + weight_decay * p -> Adam (b1 0.9,
  b2 0.999, eps 1e-8 outside the square root) -> - lr (constant or cosine),
  applied once every ``accumulation_steps`` micro-steps to the mean of their
  gradients (``optax.MultiSteps``).
Here each micro-step back-propagates loss / k into the parameters' ``.grad``
(which sums to the mean over the k micro-steps), and every k-th micro-step
clips that sum once and takes one ``torch.optim.Adam`` step, whose
``weight_decay`` adds wd * p to the gradient before the moments, as
``optax.add_decayed_weights`` does.

Randomness inside a step (the MMD draw) comes from a ``torch.Generator``
seeded from (seed, epoch, step) by :func:`step_generator`, as the JAX
trainer folds its key.

Distributed (``axis_name``, one rank per graph part): each rank
differentiates only its own node-weighted loss share (the parts couple
through the model's virtual-node sums, whose backward sums the cotangent
over the axis), and at each update the parameter gradients are summed over
the axis in one flattened buffer before the clip: the DDP-sum pattern of
the JAX step, so every rank applies the same update and the parameters stay
replicated. Summing the accumulated gradient once per update instead of
each micro-step's is equal in exact arithmetic. The logged losses are
summed over the axis, and ``batch_consistency`` is max |loc_mean - its min
over the ranks|, reduced with MAX: 0 iff every rank fed the same graphs.
The MMD draw is independent per rank (the rank joins the generator's seed).

With the data axis (``data_axis_name``, a data-parallel shard of the batch
per rank) the loss's node weighting, the logged sums and the gradient sum
span both axes, (data, graph): every rank holds a part of some graph of
the global batch, and the global loss is the node-weighted sum over all of
them. The model's virtual-node sums stay on the graph axis (the data axis
holds other graphs), and so does the min of ``batch_consistency``, whose
max spans (data, graph). The tensor axis is in neither: the ``tp_*``
collectives (parallel/collectives.py) already hand every tensor rank the
whole parameter gradient with each loss term counted once, so the loss is
replicated over the tensor ranks and the sum over (data, graph) stays exact
(JAX's ``_reduce_axes``).

The scanned epoch (train/scan_epoch.py) replays the micro-step from CUDA
graphs, which hold every tensor they touch by address. For it the
optimizer can keep its gradients in place (:meth:`Optimizer.stage`: the
accumulation adds into fixed ``.grad`` tensors, the update zeroes them and
a load copies into them); the train step splits into the device work a
graph can hold (:meth:`TrainStep.loss_backward`, :meth:`Optimizer.clip`)
and the host's part (:meth:`Optimizer.adam_step`, whose rate and Adam step
count are numbers on the host, and :meth:`Optimizer.count`), and the MMD
draw can come in as ``mmd_u``, drawn outside the graph with the step's
generator and the same ``torch.rand`` call
(:meth:`TrainStep.mmd_draw_shape`), so that the draws are the eager loop's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

import numpy as np
import torch

import torch.distributed as dist

from distegnn_tpu_torch.ops.graph import GraphBatch
from distegnn_tpu_torch.parallel.collectives import all_reduce
from distegnn_tpu_torch.train.loss import (masked_mse, mmd_loss,
                                           weighted_global_loss,
                                           weighted_local_loss)


def needs_grad_clip(config) -> bool:
    """The reference rule: clip by norm 0.3 only when distributed or on the
    largest dataset, and only for FastEGNN."""
    dist = int(config.data.get("world_size", 1) or 1) > 1
    big = config.data.dataset_name in ("LargeFluid", "Fluid113K")
    return (dist or big) and config.model.model_name == "FastEGNN"


class Optimizer:
    """Gradient accumulation + global-norm clip + Adam with L2 weight decay
    + an optional cosine learning-rate schedule (see the module docstring).

    Call :meth:`micro_step` after each micro-step's backward; it returns
    True on the micro-steps that update the parameters. ``updates`` counts
    the parameter updates, ``last_grad_norm`` is the global norm of the
    accumulated gradient at the last update (before clipping). ``lr_scale``
    multiplies the learning rate, schedule included: the trainer's
    divergence rollback lowers it, as the JAX package's ``build_tx(lr_scale)``
    rebuilds its optimizer at ``learning_rate * lr_scale``; it is not part of
    :meth:`state_dict`, so the Adam state carries over unchanged."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: float, weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None,
                 accumulation_steps: int = 1,
                 total_steps: Optional[int] = None, scheduler: str = "None"):
        self.params = [p for p in params if p.requires_grad]
        if scheduler == "cosine" and total_steps is None:
            raise ValueError("the cosine scheduler needs total_steps")
        self.learning_rate = float(learning_rate)
        self.clip_norm = clip_norm
        self.accumulation_steps = int(accumulation_steps)
        self.total_steps = total_steps
        self.scheduler = scheduler
        self.adam = torch.optim.Adam(self.params, lr=self.learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=float(weight_decay))
        self.micro = 0          # micro-steps since the last update
        self.updates = 0
        self.lr_scale = 1.0
        self.last_grad_norm: Optional[torch.Tensor] = None
        self.in_place = False   # set by stage()

    def lr_at(self, count: int) -> float:
        """optax.cosine_decay_schedule(lr, total_steps) at update ``count``
        (0-based), or the constant rate; lr = learning_rate * lr_scale."""
        lr = self.learning_rate * self.lr_scale
        if self.scheduler != "cosine":
            return lr
        t = min(count, self.total_steps) / self.total_steps
        return lr * 0.5 * (1.0 + math.cos(math.pi * t))

    def stage(self) -> None:
        """Keep the gradients in place from now on (the scanned epoch's
        CUDA graphs hold them by address): every parameter gets a fixed
        ``.grad`` (zero where none has accumulated), which the backward
        adds into, the update zeroes and a load copies into. Idempotent."""
        if not self.in_place:
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.in_place = True

    def next_is_update(self) -> bool:
        """Whether the next micro-step ends in the optimizer update."""
        return self.micro + 1 >= self.accumulation_steps

    def clip(self, reduce_grads: Optional[Callable] = None) -> None:
        """The update's gradient work, with no host read (a CUDA graph
        can hold it): call ``reduce_grads(params)`` (the distributed
        step's gradient sum), then clip the accumulated gradient by its
        global norm."""
        if reduce_grads is not None:
            reduce_grads(self.params)
        # a parameter no loss term reaches (the last layer's feature heads)
        # has no gradient here and a zero one in optax, whose weight decay
        # and Adam still move it: give it the zero gradient
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        self.last_grad_norm = norm.detach()
        if self.clip_norm is not None:
            # optax.clip_by_global_norm: g / norm * clip once norm >= clip
            scale = torch.where(norm < self.clip_norm,
                                torch.ones_like(norm), self.clip_norm / norm)
            for g in grads:
                g.mul_(scale)

    def adam_step(self) -> None:
        """The rate of update ``updates`` (a number the host computes),
        the Adam step (its step count on the host) and the gradients
        cleared (zeroed in place after :meth:`stage`)."""
        lr = self.lr_at(self.updates)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        self.adam.zero_grad(set_to_none=not self.in_place)

    def count(self, updated: bool) -> None:
        """The host's counting of one micro-step that did (or did not) end
        in the update."""
        if updated:
            self.micro = 0
            self.updates += 1
        else:
            self.micro += 1

    def micro_step(self, reduce_grads: Optional[Callable] = None) -> bool:
        """Count one micro-step; on every ``accumulation_steps``-th, call
        ``reduce_grads(params)`` (the distributed step's gradient sum), then
        clip and update."""
        updated = self.next_is_update()
        if updated:
            self.clip(reduce_grads)
            self.adam_step()
        self.count(updated)
        return updated

    def state_dict(self) -> dict:
        """The whole accumulation state, as optax's MultiSteps state holds
        it: Adam's, ``micro``, ``updates`` and ``grads``, the micro-gradients
        summed since the last update (``p.grad`` of each parameter, None
        where it has none). The tensors are references; a checkpoint copies
        them as it serialises."""
        return {"adam": self.adam.state_dict(), "micro": self.micro,
                "updates": self.updates,
                "grads": [None if p.grad is None else p.grad.detach()
                          for p in self.params]}

    def check_state_dict(self, sd: dict) -> None:
        """Raise ValueError, touching nothing, unless :meth:`load_state_dict`
        can load ``sd`` exactly."""
        micro, grads = int(sd["micro"]), sd.get("grads")
        if grads is None and micro != 0:
            raise ValueError(
                f"the optimizer state has micro={micro} of "
                f"accumulation_steps={self.accumulation_steps} but no "
                "accumulation state (the summed micro-gradients, 'grads'): "
                "it was saved mid-accumulation by an older version and "
                "cannot resume exactly")
        if grads is not None and len(grads) != len(self.params):
            raise ValueError(f"the optimizer state holds {len(grads)} "
                             f"gradients for {len(self.params)} parameters")

    def load_state_dict(self, sd: dict) -> None:
        """Load a :meth:`state_dict` (copies of its gradients become the
        parameters' ``.grad``). A payload without ``grads`` (written before
        the accumulation state was saved) loads only at ``micro == 0``,
        where nothing has accumulated; at any other ``micro`` it raises
        ValueError rather than resume with a wrong gradient. After
        :meth:`stage` the gradients are copied into the fixed ones (a
        missing one zeroes its tensor)."""
        self.check_state_dict(sd)
        micro, grads = int(sd["micro"]), sd.get("grads")
        if grads is None:
            grads = [None] * len(self.params)
        self.adam.load_state_dict(sd["adam"])
        with torch.no_grad():
            for p, g in zip(self.params, grads):
                if self.in_place:
                    if g is None:
                        p.grad.zero_()
                    else:
                        p.grad.copy_(g)
                else:
                    p.grad = None if g is None else g.detach().to(
                        device=p.device, dtype=p.dtype).clone()
        self.micro, self.updates = micro, int(sd["updates"])


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   learning_rate: float, weight_decay: float = 0.0,
                   clip_norm: Optional[float] = None,
                   accumulation_steps: int = 1,
                   total_steps: Optional[int] = None,
                   scheduler: str = "None") -> Optimizer:
    return Optimizer(params, learning_rate, weight_decay, clip_norm,
                     accumulation_steps, total_steps, str(scheduler))


@dataclasses.dataclass
class TrainState:
    """The model and its optimizer; ``step`` counts micro-steps."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0


def step_generator(seed: int, epoch: int, step: int, device: torch.device,
                   rank: Optional[int] = None) -> torch.Generator:
    """The generator of one train step, seeded from (seed, epoch, step) and,
    for a rank of a distributed run, its rank."""
    entropy = [int(seed), int(epoch), int(step)]
    if rank is not None:
        entropy.append(int(rank))
    s = np.random.SeedSequence(entropy)
    return torch.Generator(device=device).manual_seed(
        int(s.generate_state(1, np.uint64)[0]))


def reduce_axes(axis_name: Optional[str],
                data_axis_name: Optional[str] = None):
    """The axes the loss and the gradient sum over: the graph axis, with
    the data axis before it when there is one (a tuple), or None on one
    device."""
    if data_axis_name is None:
        return axis_name
    return tuple(a for a in (data_axis_name, axis_name) if a is not None)


def make_loss_fn(model, mmd_weight: float, mmd_sigma: float,
                 mmd_samples: int, axis_name: Optional[str] = None,
                 data_axis_name: Optional[str] = None) -> Callable:
    """loss(batch, generator=None, mmd_idx=None, mmd_u=None) -> (loss to
    differentiate, logged node-weighted MSE). Under ``axis_name`` both are
    this rank's node-weighted shares (the train step sums them for
    logging), weighted over (data, graph) with ``data_axis_name``.
    ``mmd_u``: the MMD draw's uniforms, drawn by the caller
    (:meth:`TrainStep.mmd_draw_shape`)."""
    axis_name = reduce_axes(axis_name, data_axis_name)

    def loss_fn(batch: GraphBatch, generator=None, mmd_idx=None,
                mmd_u=None):
        loc_pred, virtual_loc = model(batch)
        mse = masked_mse(loc_pred, batch.target, batch.node_mask)
        loss = weighted_local_loss(mse, batch.node_mask, axis_name)
        logged = loss
        if mmd_weight:
            lm = mmd_loss(virtual_loc, batch.target, batch.node_mask,
                          mmd_sigma, mmd_samples, generator=generator,
                          idx=mmd_idx, u=mmd_u)
            loss = loss + mmd_weight * weighted_local_loss(
                lm, batch.node_mask, axis_name)
        return loss, logged

    return loss_fn


def sum_gradients(params, axis_name) -> None:
    """Sum the parameters' ``.grad`` over the axis in one flattened buffer
    (one collective, not one a tensor). A missing gradient counts as zero
    and every parameter gets the sum, so all ranks hold the same gradients
    whichever parameters their own loss share reached."""
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1) for p in params])
    all_reduce(flat, axis_name, "grad")
    off = 0
    for p in params:
        n = p.numel()
        p.grad = flat[off:off + n].view_as(p).clone()
        off += n


def batch_consistency(loc_mean: torch.Tensor, axis_name: str,
                      max_axes=None) -> torch.Tensor:
    """max |loc_mean - its min over the graph axis|, the max over
    ``max_axes`` (default the graph axis; (data, graph) under the data
    axis, whose shards hold other graphs): 0 iff every graph part of a data
    shard carries the same graphs' means."""
    low = all_reduce(loc_mean.detach().clone(), axis_name, "consistency",
                     op=dist.ReduceOp.MIN)
    resid = torch.max(torch.abs(loc_mean - low)).reshape(1)
    return all_reduce(resid, axis_name if max_axes is None else max_axes,
                      "consistency", op=dist.ReduceOp.MAX)[0]


class TrainStep:
    """One micro-step for the state holding ``model`` and ``optimizer``:
    ``step(state, batch, generator=None, mmd_idx=None) -> (state,
    metrics)`` runs the forward, the loss / k backward and, every k-th
    micro-step, the optimizer update. The metrics are detached device
    scalars; under ``axis_name`` the losses are summed over the axis
    ((data, graph) with ``data_axis_name``) and ``batch_consistency`` is
    added (the module docstring). The scanned epoch drives the parts:
    :meth:`loss_backward`, the optimizer's update and its counting."""

    def __init__(self, model, optimizer: Optimizer, mmd_weight: float,
                 mmd_sigma: float, mmd_samples: int,
                 axis_name: Optional[str] = None,
                 data_axis_name: Optional[str] = None):
        self.model, self.optimizer = model, optimizer
        self.mmd_weight, self.mmd_samples = mmd_weight, int(mmd_samples)
        self.axis_name = axis_name
        self.axes = reduce_axes(axis_name, data_axis_name)
        self.loss_fn = make_loss_fn(model, mmd_weight, mmd_sigma,
                                    mmd_samples, axis_name, data_axis_name)
        self.reduce_grads = (None if axis_name is None else
                             lambda params: sum_gradients(params, self.axes))

    def mmd_draw_shape(self, batch: GraphBatch) -> Optional[tuple]:
        """The shape of the MMD draw's uniforms on ``batch``, or None where
        the loss draws nothing (no MMD, or every real node used once)."""
        C = getattr(self.model, "virtual_channels", None)
        ns = self.mmd_samples * (C or 0)
        if not self.mmd_weight or C is None or batch.max_nodes <= ns:
            return None
        return (batch.batch_size, ns)

    def loss_backward(self, batch: GraphBatch, generator=None,
                      mmd_idx=None, mmd_u=None):
        """The forward and the loss / k backward (the gradients add into
        ``.grad``); returns (loss, logged)."""
        self.model.train()
        loss, logged = self.loss_fn(batch, generator, mmd_idx, mmd_u)
        (loss / self.optimizer.accumulation_steps).backward()
        return loss, logged

    def __call__(self, state: TrainState, batch: GraphBatch, generator=None,
                 mmd_idx=None):
        loss, logged = self.loss_backward(batch, generator, mmd_idx)
        self.optimizer.micro_step(self.reduce_grads)
        state.step += 1
        metrics = {"loss": logged.detach(), "loss_with_mmd": loss.detach()}
        if self.axis_name is not None:
            sums = all_reduce(torch.stack([metrics["loss"],
                                           metrics["loss_with_mmd"]]),
                              self.axes, "loss")
            metrics = {"loss": sums[0], "loss_with_mmd": sums[1],
                       "batch_consistency": batch_consistency(
                           batch.loc_mean, self.axis_name, self.axes)}
        return state, metrics


def make_train_step(model, optimizer: Optimizer, mmd_weight: float,
                    mmd_sigma: float, mmd_samples: int,
                    axis_name: Optional[str] = None,
                    data_axis_name: Optional[str] = None) -> TrainStep:
    """The :class:`TrainStep` of ``model`` and ``optimizer``."""
    return TrainStep(model, optimizer, mmd_weight, mmd_sigma, mmd_samples,
                     axis_name, data_axis_name)


def make_eval_step(model, axis_name: Optional[str] = None,
                   data_axis_name: Optional[str] = None) -> Callable:
    """Returns eval(batch) -> the node-weighted global MSE (no MMD), no
    autograd; summed over (data, graph) with ``data_axis_name``."""
    axis_name = reduce_axes(axis_name, data_axis_name)

    def eval_step(batch: GraphBatch):
        model.eval()
        with torch.no_grad():
            loc_pred, _ = model(batch)
            mse = masked_mse(loc_pred, batch.target, batch.node_mask)
            return weighted_global_loss(mse, batch.node_mask, axis_name)

    return eval_step
