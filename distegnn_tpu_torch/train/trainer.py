"""The epoch loop (port of ``distegnn_tpu/train/trainer.py``): epochs of
micro-steps, evaluation every ``log.test_interval`` epochs, best/last
checkpoints, early stopping, the divergence rollback (a non-finite epoch
loss restores the last finite state and retries at a decayed learning rate,
``train.divergence_retries`` times, then stops), and ``log.json`` with the
JAX package's three-element layout ``[best, log_dict, config]``.

In a distributed run (``rank`` given) every rank runs this loop on its own
graph part. The losses it decides on are summed over the ranks by the
steps, so every rank takes the same branch (rollback, best, early stop);
only rank 0 prints and writes files; the epoch's ``batch_consistency`` must
be exactly 0 (:func:`assert_batch_consistency`).

Not ported yet (ROADMAP.md): preemption handling, cadence checkpoints and
the resume scan, the obs event stream, the promotion publisher, wandb and
the on-device epoch scan.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from distegnn_tpu_torch.train.checkpoint import save_checkpoint
from distegnn_tpu_torch.train.step import step_generator


def _fmt(loss: float) -> str:
    return f"{loss:.5f}" if loss >= 1e-4 else f"{loss:.3e}"


def _log(msg: str) -> None:
    print(f"[train] {msg}", flush=True)


def snapshot_state(state) -> dict:
    """Copies of everything a divergence rollback restores, as the JAX
    package rolls back its whole ``TrainState``: the model's parameters and
    buffers, the optimizer's Adam moments, ``updates`` and ``micro``, the
    gradient accumulated since the last update (``p.grad``; the JAX package
    keeps it in the optax MultiSteps state) and the micro-step count."""
    opt = state.optimizer
    return {"model": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "optimizer": copy.deepcopy(opt.state_dict()),
            "grads": [None if p.grad is None else p.grad.detach().clone()
                      for p in opt.params],
            "step": state.step}


def restore_state(state, snap: dict) -> None:
    """Load a :func:`snapshot_state` into ``state`` in place (the snapshot
    stays intact: a second rollback to it restores the same values)."""
    state.model.load_state_dict(snap["model"])
    opt = state.optimizer
    opt.load_state_dict(copy.deepcopy(snap["optimizer"]))
    for p, g in zip(opt.params, snap["grads"]):
        p.grad = None if g is None else g.clone()
    state.step = snap["step"]


def run_epoch_train(train_step: Callable, state, loader, seed: int,
                    epoch: int, device: torch.device,
                    on_step: Optional[Callable] = None,
                    rank: Optional[int] = None):
    """One training epoch. Returns (state, average of the per-step logged
    MSE weighted by batch size). The sum stays on the device; the one host
    read is at the end of the epoch. ``on_step(epoch, step_idx, metrics)``
    is called after each micro-step. ``rank`` (distributed) joins each
    step's generator seed, and the epoch's ``batch_consistency`` is
    checked at its end."""
    loader.set_epoch(epoch)
    total, counter, cons = None, 0.0, None
    for step_idx, batch in enumerate(loader):
        batch = batch.to(device)
        gen = step_generator(seed, epoch, step_idx, device, rank)
        state, metrics = train_step(state, batch, gen)
        if on_step is not None:
            on_step(epoch, step_idx, metrics)
        bsz = batch.batch_size
        contrib = metrics["loss"] * bsz
        total = contrib if total is None else total + contrib
        counter += bsz
        if "batch_consistency" in metrics:
            c = metrics["batch_consistency"]
            cons = c if cons is None else torch.maximum(cons, c)
    avg = float(total) / max(counter, 1.0) if total is not None else 0.0
    assert_batch_consistency(cons, epoch)
    return state, avg


def assert_batch_consistency(cons, epoch: int) -> None:
    """Raise unless the epoch's loc_mean residual across the ranks is
    exactly 0 (a NaN fails too): every rank must have fed the same graphs
    in the same order."""
    if cons is not None and not float(cons) == 0.0:
        raise AssertionError(
            f"cross-rank batch mismatch at epoch {epoch}: loc_mean residual "
            f"{float(cons):g} != 0 — the ranks fed different graphs (loader "
            "order drift or corrupted shard data)")


def run_epoch_eval(eval_step: Callable, loader, device: torch.device) -> float:
    total, counter = None, 0.0
    for batch in loader:
        batch = batch.to(device)
        contrib = eval_step(batch) * batch.batch_size
        total = contrib if total is None else total + contrib
        counter += batch.batch_size
    return float(total) / max(counter, 1.0) if total is not None else 0.0


def train(state, train_step: Callable, eval_step: Callable, loader_train,
          loader_valid, loader_test, config, device: torch.device,
          start_epoch: int = 0, on_step: Optional[Callable] = None,
          rank: Optional[int] = None):
    """Full training run. Returns (state, best_state, best, log_dict):
    ``best_state`` is a CPU copy of the model's state_dict at the best
    validation loss. ``rank``: this process's rank in a distributed run
    (None on one device); only rank 0 prints and writes."""
    train_cfg, log_cfg = config.train, config.log
    seed = config.seed
    is_main = rank is None or rank == 0
    # the layout of the JAX package's log.json
    log_dict = {"epochs": [], "loss": [], "loss_train": [], "epoch_time": [],
                "start_epoch": start_epoch, "divergence_events": []}
    best = {"epoch_index": start_epoch, "loss_valid": 1e8, "loss_test": 1e8,
            "loss_train": 1e8}

    def snapshot():
        return {k: v.detach().cpu().clone()
                for k, v in state.model.state_dict().items()}

    best_state = snapshot()
    exp_dir = os.path.join(log_cfg.log_dir, log_cfg.get("exp_name", "run"))
    log_dir = os.path.join(exp_dir, "log")
    ckpt_dir = os.path.join(exp_dir, "state_dict")
    if is_main:
        os.makedirs(log_dir, exist_ok=True)
        os.makedirs(ckpt_dir, exist_ok=True)
    cfg = config.to_dict() if hasattr(config, "to_dict") else dict(config)
    start = time.perf_counter()
    log = _log if is_main else (lambda msg: None)

    def save(name, epoch, losses):
        if is_main:
            save_checkpoint(os.path.join(ckpt_dir, name), state, epoch,
                            losses=losses, config=cfg, seed=seed)

    def write_log():
        best["time_cost"] = time.perf_counter() - start
        if not is_main:
            return
        with open(os.path.join(log_dir, "log.json"), "w") as f:
            json.dump([best, _sanitize_nonfinite(log_dict), cfg], f,
                      indent=4)

    retries_left = int(train_cfg.get("divergence_retries", 0) or 0)
    lr_decay = float(train_cfg.get("divergence_lr_decay", 0.5) or 0.5)
    lr_scale = 1.0
    # the last finite-loss state and the log lengths at that point, so that
    # a rollback also rewinds the curves (loss_train[i] is the absolute epoch
    # start_epoch + 1 + i: a retried epoch must not append twice)
    finite_snap = (snapshot_state(state), start_epoch, 0, 0)

    epoch = start_epoch    # the last completed epoch
    while epoch < train_cfg.epochs:
        epoch += 1
        t_epoch = time.perf_counter()
        state, loss_train = run_epoch_train(train_step, state, loader_train,
                                            seed, epoch, device, on_step,
                                            rank)
        dt_epoch = time.perf_counter() - t_epoch
        log_dict["loss_train"].append(loss_train)
        log_dict["epoch_time"].append(round(dt_epoch, 4))
        if not np.isfinite(loss_train):
            if retries_left > 0:
                # roll back to the last finite state and retry from there at
                # a decayed learning rate (the Adam state carries over)
                retries_left -= 1
                snap, snap_epoch, n_tr, n_ev = finite_snap
                restore_state(state, snap)
                lr_scale *= lr_decay
                state.optimizer.lr_scale = lr_scale
                del log_dict["loss_train"][n_tr:]
                del log_dict["epoch_time"][n_tr:]
                del log_dict["epochs"][n_ev:], log_dict["loss"][n_ev:]
                log_dict["divergence_events"].append(
                    {"epoch": epoch, "loss_train": repr(loss_train),
                     "rolled_back_to": snap_epoch, "lr_scale": lr_scale,
                     "retries_left": retries_left})
                log(f"DIVERGED at epoch {epoch}: train loss {loss_train}; "
                     f"rolling back to epoch {snap_epoch} state, "
                     f"lr_scale={lr_scale:g} ({retries_left} retries left)")
                epoch = snap_epoch
                continue
            best["diverged"] = {"epoch": epoch, "loss_train": repr(loss_train),
                                "retries_exhausted": int(train_cfg.get(
                                    "divergence_retries", 0) or 0)}
            log(f"DIVERGED at epoch {epoch}: train loss {loss_train}; "
                 "stopping (divergence retries exhausted — resume from the "
                 "last checkpoint with a lower lr)")
            write_log()
            break
        finite_snap = (snapshot_state(state), epoch,
                       len(log_dict["loss_train"]), len(log_dict["epochs"]))

        if epoch % log_cfg.test_interval == 0:
            loss_valid = run_epoch_eval(eval_step, loader_valid, device)
            loss_test = run_epoch_eval(eval_step, loader_test, device)
            log_dict["epochs"].append(epoch)
            log_dict["loss"].append(loss_test)
            if loss_valid < best["loss_valid"]:
                best = {"epoch_index": epoch, "loss_valid": loss_valid,
                        "loss_test": loss_test, "loss_train": loss_train}
                best_state = snapshot()
                save("best_model.ckpt", epoch, best)
            save("last_model.ckpt", epoch,
                 {"loss_train": loss_train, "loss_valid": loss_valid,
                  "loss_test": loss_test})
            log(f"Epoch {epoch} | train {_fmt(loss_train)} | valid "
                 f"{_fmt(loss_valid)} | test {_fmt(loss_test)} | "
                 f"{dt_epoch:.2f}s/epoch")
            log(f"*** Best Valid Loss: {_fmt(best['loss_valid'])} | "
                 f"Best Test Loss: {_fmt(best['loss_test'])} | "
                 f"Best Epoch Index: {best['epoch_index']}")

        # early stop is checked every epoch, not only on eval epochs
        if epoch - best["epoch_index"] >= train_cfg.early_stop:
            best["early_stop"] = epoch
            log(f"Early stopped! Epoch: {epoch}")
            write_log()
            break
        write_log()
    return state, best_state, best, log_dict


def _sanitize_nonfinite(log_dict):
    """Non-finite floats -> None (json null): a bare NaN token is not JSON."""
    def fix(v):
        if isinstance(v, float) and not np.isfinite(v):
            return None
        return v

    return {k: [fix(v) for v in vals] if isinstance(vals, list) else vals
            for k, vals in log_dict.items()}
