"""The train and eval steps (port of ``distegnn_tpu/train/step.py``, single
device): forward, loss (masked MSE + MMD), backward, and the optimizer.

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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from distegnn_tpu_torch.ops.graph import GraphBatch
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

    def micro_step(self) -> bool:
        self.micro += 1
        if self.micro < self.accumulation_steps:
            return False
        grads = [p.grad for p in self.params if p.grad is not None]
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
        return {"adam": self.adam.state_dict(), "micro": self.micro,
                "updates": self.updates}

    def load_state_dict(self, sd: dict) -> None:
        self.adam.load_state_dict(sd["adam"])
        self.micro, self.updates = int(sd["micro"]), int(sd["updates"])


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


def step_generator(seed: int, epoch: int, step: int,
                   device: torch.device) -> torch.Generator:
    """The generator of one train step, seeded from (seed, epoch, step)."""
    s = np.random.SeedSequence([int(seed), int(epoch), int(step)])
    return torch.Generator(device=device).manual_seed(
        int(s.generate_state(1, np.uint64)[0]))


def make_loss_fn(model, mmd_weight: float, mmd_sigma: float,
                 mmd_samples: int) -> Callable:
    """loss(batch, generator=None, mmd_idx=None) -> (loss to differentiate,
    logged node-weighted MSE)."""

    def loss_fn(batch: GraphBatch, generator=None, mmd_idx=None):
        loc_pred, virtual_loc = model(batch)
        mse = masked_mse(loc_pred, batch.target, batch.node_mask)
        loss = weighted_local_loss(mse, batch.node_mask)
        logged = loss
        if mmd_weight:
            lm = mmd_loss(virtual_loc, batch.target, batch.node_mask,
                          mmd_sigma, mmd_samples, generator=generator,
                          idx=mmd_idx)
            loss = loss + mmd_weight * weighted_local_loss(lm,
                                                           batch.node_mask)
        return loss, logged

    return loss_fn


def make_train_step(model, optimizer: Optimizer, mmd_weight: float,
                    mmd_sigma: float, mmd_samples: int) -> Callable:
    """Returns step(state, batch, generator) -> (state, metrics) for the
    state holding ``model`` and ``optimizer``: one micro-step (forward,
    loss / k backward, and every k-th micro-step the optimizer update). The
    metrics are detached device scalars."""
    loss_fn = make_loss_fn(model, mmd_weight, mmd_sigma, mmd_samples)
    k = optimizer.accumulation_steps

    def step(state: TrainState, batch: GraphBatch, generator=None):
        model.train()
        loss, logged = loss_fn(batch, generator)
        (loss / k).backward()
        optimizer.micro_step()
        state.step += 1
        return state, {"loss": logged.detach(),
                       "loss_with_mmd": loss.detach()}

    return step


def make_eval_step(model) -> Callable:
    """Returns eval(batch) -> the node-weighted MSE (no MMD), no autograd."""

    def eval_step(batch: GraphBatch):
        model.eval()
        with torch.no_grad():
            loc_pred, _ = model(batch)
            mse = masked_mse(loc_pred, batch.target, batch.node_mask)
            return weighted_global_loss(mse, batch.node_mask)

    return eval_step
