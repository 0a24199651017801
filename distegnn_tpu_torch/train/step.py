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

    def lr_at(self, count: int) -> float:
        """optax.cosine_decay_schedule(lr, total_steps) at update ``count``
        (0-based), or the constant rate; lr = learning_rate * lr_scale."""
        lr = self.learning_rate * self.lr_scale
        if self.scheduler != "cosine":
            return lr
        t = min(count, self.total_steps) / self.total_steps
        return lr * 0.5 * (1.0 + math.cos(math.pi * t))

    def micro_step(self, reduce_grads: Optional[Callable] = None) -> bool:
        """Count one micro-step; on every ``accumulation_steps``-th, call
        ``reduce_grads(params)`` (the distributed step's gradient sum), then
        clip and update."""
        self.micro += 1
        if self.micro < self.accumulation_steps:
            return False
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
        for group in self.adam.param_groups:
            group["lr"] = self.lr_at(self.updates)
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        self.micro = 0
        self.updates += 1
        return True

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
        ValueError rather than resume with a wrong gradient."""
        self.check_state_dict(sd)
        micro, grads = int(sd["micro"]), sd.get("grads")
        if grads is None:
            grads = [None] * len(self.params)
        self.adam.load_state_dict(sd["adam"])
        for p, g in zip(self.params, grads):
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
    """loss(batch, generator=None, mmd_idx=None) -> (loss to differentiate,
    logged node-weighted MSE). Under ``axis_name`` both are this rank's
    node-weighted shares (the train step sums them for logging), weighted
    over (data, graph) with ``data_axis_name``."""
    axis_name = reduce_axes(axis_name, data_axis_name)

    def loss_fn(batch: GraphBatch, generator=None, mmd_idx=None):
        loc_pred, virtual_loc = model(batch)
        mse = masked_mse(loc_pred, batch.target, batch.node_mask)
        loss = weighted_local_loss(mse, batch.node_mask, axis_name)
        logged = loss
        if mmd_weight:
            lm = mmd_loss(virtual_loc, batch.target, batch.node_mask,
                          mmd_sigma, mmd_samples, generator=generator,
                          idx=mmd_idx)
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


def make_train_step(model, optimizer: Optimizer, mmd_weight: float,
                    mmd_sigma: float, mmd_samples: int,
                    axis_name: Optional[str] = None,
                    data_axis_name: Optional[str] = None) -> Callable:
    """Returns step(state, batch, generator=None, mmd_idx=None) -> (state,
    metrics) for the state holding ``model`` and ``optimizer``: one
    micro-step (forward, loss / k backward, and every k-th micro-step the
    optimizer update). The metrics are detached device scalars; under
    ``axis_name`` the losses are summed over the axis ((data, graph) with
    ``data_axis_name``) and ``batch_consistency`` is added (the module
    docstring)."""
    loss_fn = make_loss_fn(model, mmd_weight, mmd_sigma, mmd_samples,
                           axis_name, data_axis_name)
    axes = reduce_axes(axis_name, data_axis_name)
    k = optimizer.accumulation_steps
    reduce_grads = (None if axis_name is None
                    else lambda params: sum_gradients(params, axes))

    def step(state: TrainState, batch: GraphBatch, generator=None,
             mmd_idx=None):
        model.train()
        loss, logged = loss_fn(batch, generator, mmd_idx)
        (loss / k).backward()
        optimizer.micro_step(reduce_grads)
        state.step += 1
        metrics = {"loss": logged.detach(), "loss_with_mmd": loss.detach()}
        if axis_name is not None:
            sums = all_reduce(torch.stack([metrics["loss"],
                                           metrics["loss_with_mmd"]]),
                              axes, "loss")
            metrics = {"loss": sums[0], "loss_with_mmd": sums[1],
                       "batch_consistency": batch_consistency(
                           batch.loc_mean, axis_name, axes)}
        return state, metrics

    return step


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
