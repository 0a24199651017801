"""Tiny deterministic training run — the subprocess under test (port of
``distegnn_tpu/testing/tiny_run.py``).

``python -m distegnn_tpu_torch.testing.tiny_run --log-dir D ...`` trains a
small FastEGNN on a synthetic n-body set whose graphs depend only on a FIXED
data seed, so every invocation (control, victim, resumed) sees the identical
problem. The resilience tests (``tests/test_torch_faults.py``) and
``chip_smoke.py`` SIGKILL/SIGTERM it mid-training and assert the resumed run
reaches the same final train loss as an uninterrupted control — which holds
because the per-step generators and loader permutations derive from (seed,
epoch, step) only (train/trainer.py).

Fault flags map to testing/faults.py injectors:
  --kill-at-step N     SIGKILL self after N train-step calls (abrupt death)
  --sigterm-at-step N  SIGTERM self after N calls (graceful preemption path)
  --poison-at-step N   NaN batch at global step N (divergence recovery path)

The run is on the card unless ``--device cpu`` asks for the CPU; the model
runs its plain path (scatter aggregation), so it launches no hand-written
kernel. Exits 75 (EX_TEMPFAIL, the training entry point's contract) when
preempted-but-resumable.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

import numpy as np

DATA_SEED = 1234  # fixed: the dataset must be identical across invocations


def build_graphs(n_graphs: int = 8, n: int = 10):
    from distegnn_tpu_torch.data.nbody import build_nbody_graph

    rng = np.random.default_rng(DATA_SEED)
    graphs = []
    for _ in range(n_graphs):
        loc = rng.normal(size=(n, 3))
        vel = rng.normal(size=(n, 3))
        charges = rng.choice([1.0, -1.0], size=(n, 1))
        target = loc + 0.1 * vel
        graphs.append(build_nbody_graph(loc, vel, charges, target,
                                        radius=-1.0, cutoff_rate=0.0))
    return graphs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="tiny resilience-test trainer")
    ap.add_argument("--log-dir", required=True)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--interval-s", type=float, default=0.0,
                    help="train.checkpoint_interval_s (mid-epoch cadence)")
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--resume", default=None, help="'auto' or a checkpoint path")
    ap.add_argument("--retries", type=int, default=0,
                    help="train.divergence_retries")
    ap.add_argument("--kill-at-step", type=int, default=0)
    ap.add_argument("--sigterm-at-step", type=int, default=0)
    ap.add_argument("--poison-at-step", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    import torch

    from distegnn_tpu_torch import obs, resolve_device
    from distegnn_tpu_torch.config import ConfigDict
    from distegnn_tpu_torch.data.loader import GraphDataset, GraphLoader
    from distegnn_tpu_torch.models.fast_egnn import FastEGNN
    from distegnn_tpu_torch.testing.faults import (inject_at_call,
                                                   poison_nan_batches)
    from distegnn_tpu_torch.train.checkpoint import (adopt_resume_seed,
                                                     resolve_resume)
    from distegnn_tpu_torch.train.step import (TrainState, make_eval_step,
                                               make_optimizer,
                                               make_train_step)
    from distegnn_tpu_torch.train.trainer import train

    device = resolve_device(args.device)
    config = ConfigDict({
        "seed": args.seed,
        "train": {"epochs": args.epochs, "early_stop": 10_000,
                  "checkpoint_interval_s": args.interval_s,
                  "keep_checkpoints": args.keep,
                  "divergence_retries": args.retries,
                  "divergence_lr_decay": 0.5,
                  "resume": args.resume,
                  # scan_epochs stays off: the host loop is the code path
                  # under test (cadence saves + preemption checks live there)
                  "scan_epochs": False},
        "log": {"test_interval": 2, "log_dir": args.log_dir,
                "exp_name": "run",  # fixed (no timestamp): resume scans here
                "check_consistency": False,
                "wandb": {"enable": False}},
    })

    # a resumed run must adopt the original run's seed BEFORE the loaders /
    # model derive anything from it (same contract as main.py)
    adopt_resume_seed(config)
    seed = int(config.seed)

    graphs = build_graphs()
    mk = lambda shuffle: GraphLoader(GraphDataset(graphs), args.batch_size,
                                     shuffle=shuffle, seed=seed)
    loader_train, loader_valid, loader_test = mk(True), mk(False), mk(False)

    model = FastEGNN(node_feat_nf=2, hidden_nf=16, virtual_channels=3,
                     n_layers=2,
                     generator=torch.Generator().manual_seed(seed)).to(device)
    # the divergence rollback retries at the optimizer's lr_scale
    # (train/trainer.py), so one optimizer and one step serve every retry
    opt = make_optimizer(model.parameters(), args.lr)
    state = TrainState(model, opt)
    start_epoch, start_step_in_epoch = 0, 0
    resumed = resolve_resume(config, state)
    if resumed is not None:
        state, start_epoch = resumed.state, resumed.epoch
        start_step_in_epoch = resumed.step_in_epoch
        obs.log(f"resume: restored {resumed.path} (epoch {start_epoch} + "
                f"{start_step_in_epoch} step(s) applied)")

    train_step = make_train_step(model, opt, mmd_weight=0.0, mmd_sigma=1.5,
                                 mmd_samples=3)
    if args.kill_at_step > 0:
        train_step = inject_at_call(
            train_step, args.kill_at_step,
            lambda: os.kill(os.getpid(), signal.SIGKILL))
    elif args.sigterm_at_step > 0:
        train_step = inject_at_call(
            train_step, args.sigterm_at_step,
            lambda: signal.raise_signal(signal.SIGTERM))
    if args.poison_at_step >= 0:
        loader_train = poison_nan_batches(loader_train, args.poison_at_step)

    state, _, best, log_dict = train(
        state, train_step, make_eval_step(model), loader_train, loader_valid,
        loader_test, config, device, start_epoch=start_epoch,
        start_step_in_epoch=start_step_in_epoch)

    result = {
        "final_train_loss": log_dict["loss_train"][-1] if log_dict["loss_train"] else None,
        "start_epoch": start_epoch,
        "start_step_in_epoch": start_step_in_epoch,
        "epochs_logged": len(log_dict["loss_train"]),
        "divergence_events": len(log_dict["divergence_events"]),
        "preempted": bool(best.get("preempted")),
        "diverged": bool(best.get("diverged")),
    }
    # harness contract line (tests parse exactly this prefix on stdout)
    print("RESULT " + json.dumps(result), flush=True)  # noqa: obs-print (the parent parses it)
    return result


if __name__ == "__main__":
    _r = main()
    if _r.get("preempted"):
        sys.exit(75)
