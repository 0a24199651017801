"""The epoch loop (port of ``distegnn_tpu/train/trainer.py``): epochs of
micro-steps, evaluation every ``log.test_interval`` epochs, best/last
checkpoints, early stopping, the divergence rollback (a non-finite epoch
loss restores the last finite state and retries at a decayed learning rate,
``train.divergence_retries`` times, then stops), and ``log.json`` with the
JAX package's three-element layout ``[best, log_dict, config]``.

The long run's durability, as in JAX:
  - cadence saves (``train.checkpoint_interval_s``): every interval a
    mid-epoch ``step_<n>.ckpt`` with its (epoch, step_in_epoch), rotated
    to the newest ``train.keep_checkpoints`` (:class:`CadenceSaver`);
  - SIGTERM / SIGINT (:class:`PreemptionGuard`): the in-flight micro-step
    finishes, then ``preempt_model.ckpt``, the ``PREEMPTED`` marker,
    ``best['preempted']`` and ``log.json`` are written and ``train``
    returns (``main`` exits 75, resumable);
  - a resumed run (``start_epoch``, ``start_step_in_epoch``) skips the
    micro-steps already applied: the loader order and the step generators
    derive from (seed, epoch, step) only, so the schedule replays exactly;
  - the promotion conveyor's trainer end (``promote.publish``): rank 0
    republishes every rotated cadence checkpoint as a candidate into
    ``promote.watch_dir`` (``promote/publish.py``), with the latest
    finite validation loss in its manifest; a failed publish never stops
    training.

The event stream (obs/): ``train/run_start``, ``train/resume``,
``train/step`` (each micro-step under ``obs.step_events``: its host time,
no device sync added, and the data-stall delta), ``train/epoch``,
``train/eval``, ``train/divergence``, ``train/rollback``,
``train/preempt``, the memory events at the start and after the first
evaluation, and the checkpoint module's ``ckpt/*`` events.
``log.trace_epoch: n`` writes a torch.profiler trace (CPU and CUDA
activities) of epoch n under ``<exp_dir>/trace/``.

In a distributed run (``rank`` and ``axis_name`` given) every rank runs
this loop on its own graph part. The losses it decides on are summed over
the ranks by the steps, so every rank takes the same branch (rollback,
best, early stop); the ranks agree on a stop after the same micro-step
(:meth:`PreemptionGuard.stop_agreed`); only rank 0 prints and writes files;
the epoch's ``batch_consistency`` must be exactly 0
(:func:`assert_batch_consistency`), and under ``log.check_consistency``
the parameters are checked bitwise replicated at every eval epoch.

Not ported yet (ROADMAP.md): wandb and the epoch as one device program.
"""

from __future__ import annotations

import copy
import json
import os
import signal
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.obs import cudaprobe
from distegnn_tpu_torch.train.checkpoint import (rotate_checkpoints,
                                                 save_checkpoint,
                                                 step_checkpoint_name,
                                                 write_preempt_marker)
from distegnn_tpu_torch.train.step import step_generator


def _fmt(loss: float) -> str:
    return f"{loss:.5f}" if loss >= 1e-4 else f"{loss:.3e}"


def _log(msg: str) -> None:
    obs.log(f"[train] {msg}")


class PreemptionGuard:
    """Cooperative SIGTERM / SIGINT handling. The first signal sets a flag
    that the epoch loop reads after each completed micro-step (the
    in-flight step always finishes); a second restores the previous
    handler and raises KeyboardInterrupt, so a stuck run can still be
    killed. The handlers install only from the main thread (elsewhere
    ``signal.signal`` raises), and :meth:`uninstall` restores the previous
    ones.

    In a distributed run each rank reacts to its own signal, but the stop
    is agreed: :meth:`stop_agreed` takes the MAX of the ranks' flags over
    the axes (the trainer passes the whole mesh's) after every micro-step,
    so a signal that reaches one rank stops
    every rank after the same micro-step, and the preempt checkpoint's
    (epoch, step_in_epoch) is one value. On one device it is the local
    flag: no collective and no device sync."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, axis_name=None, device=None):
        self.requested = False
        self.agreed = False        # the last stop_agreed's answer
        self.signum: Optional[int] = None
        self.interrupted = False   # run_epoch_train broke off mid-epoch
        self.steps_done = 0        # steps of that epoch applied at the break
        self.axis_name = axis_name
        self.device = torch.device("cpu") if device is None else device
        self._prev: dict = {}

    def stop_agreed(self) -> bool:
        """True iff any rank has a stop request (one MAX all-reduce of the
        flags, kind 'stop', under a graph axis; the local flag without)."""
        if self.axis_name is None:
            self.agreed = self.requested
            return self.agreed
        from distegnn_tpu_torch.parallel.collectives import all_reduce

        flag = torch.tensor([int(self.requested)], device=self.device)
        all_reduce(flag, self.axis_name, "stop", op=dist.ReduceOp.MAX)
        self.agreed = bool(flag.item())
        if self.agreed and not self.requested:
            # adopt the other rank's request: this rank checkpoints the same
            # coordinates and exits resumable too
            self.requested = True
            self.signum = self.signum or signal.SIGTERM
            obs.log("preemption: adopting another rank's stop request at "
                    "the step barrier")
        return self.agreed

    def stop_at_boundary(self) -> bool:
        """The stop check at an epoch boundary: the local flag on one
        device; under a graph axis the last agreement (a later signal is
        agreed on after the next micro-step), so no collective is added."""
        return self.agreed if self.axis_name is not None \
            else self.stop_agreed()

    def _handle(self, signum, frame):
        if self.requested:  # second signal: give up the graceful path
            signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
            raise KeyboardInterrupt(f"second signal {signum} during "
                                    "preemption")
        self.requested = True
        self.signum = signum
        obs.log(f"preemption: caught signal {signum}; finishing the "
                "in-flight step and checkpointing", signal=signum)

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in self.SIGNALS:
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except (ValueError, OSError):
                pass
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()


class CadenceSaver:
    """Wall-clock mid-epoch checkpoints (``train.checkpoint_interval_s``):
    every ``interval_s`` seconds of training, ``step_<n>.ckpt`` with its
    (epoch, step_in_epoch), then rotation to the newest ``keep``.
    ``interval_s`` <= 0 or ``enabled=False`` (a rank other than 0) makes it
    a no-op, so the loop never branches on the configuration. With a
    ``publisher`` (``promote.publish``) each rotated checkpoint is also
    published as a serving candidate."""

    def __init__(self, ckpt_dir: str, interval_s: float, keep: int,
                 config: Optional[dict], seed: Optional[int],
                 enabled: bool = True, publisher=None):
        self.ckpt_dir = ckpt_dir
        self.interval_s = float(interval_s or 0)
        self.keep = max(int(keep), 1)
        self.config = config
        self.seed = seed
        self.enabled = enabled and self.interval_s > 0
        self._last = time.monotonic()
        self.saves = 0
        # promotion conveyor: None = training island only. The latest eval
        # loss rides the candidate manifest so the promoter can attribute a
        # candidate to its validation quality.
        self.publisher = publisher
        self.last_val_loss: Optional[float] = None

    def maybe_save(self, state, completed_epoch: int,
                   step_in_epoch: int) -> None:
        if not self.enabled or time.monotonic() - self._last < \
                self.interval_s:
            return
        path = os.path.join(self.ckpt_dir, step_checkpoint_name(state.step))
        save_checkpoint(path, state, completed_epoch, config=self.config,
                        seed=self.seed, step_in_epoch=step_in_epoch)
        rotate_checkpoints(self.ckpt_dir, self.keep)
        self._last = time.monotonic()
        self.saves += 1
        if self.publisher is not None:
            try:
                self.publisher.publish(path, step=int(state.step),
                                       val_loss=self.last_val_loss,
                                       config=self.config)
            except Exception as exc:
                # the conveyor never stops training: a full/unwritable
                # watch_dir just delays promotion to the next rotation
                obs.log(f"promote: candidate publish failed for step "
                        f"{int(state.step)}: {exc!r}")


def snapshot_state(state) -> dict:
    """Copies of everything a divergence rollback restores, as the JAX
    package rolls back its whole ``TrainState``: the model's parameters and
    buffers, the optimizer's whole state (Adam's, ``updates``, ``micro`` and
    the gradient accumulated since the last update) and the micro-step
    count."""
    return {"model": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "optimizer": copy.deepcopy(state.optimizer.state_dict()),
            "step": state.step}


def restore_state(state, snap: dict) -> None:
    """Load a :func:`snapshot_state` into ``state`` in place (the snapshot
    stays intact: a second rollback to it restores the same values)."""
    state.model.load_state_dict(snap["model"])
    state.optimizer.load_state_dict(copy.deepcopy(snap["optimizer"]))
    state.step = snap["step"]


def run_epoch_train(train_step: Callable, state, loader, seed: int,
                    epoch: int, device: torch.device,
                    on_step: Optional[Callable] = None,
                    rank: Optional[int] = None, start_step: int = 0,
                    guard: Optional[PreemptionGuard] = None,
                    cadence: Optional[CadenceSaver] = None,
                    tracer=None, step_events: bool = False):
    """One training epoch. Returns (state, average of the per-step logged
    MSE weighted by batch size). The sum stays on the device; the one host
    read is at the end of the epoch. ``on_step(epoch, step_idx, metrics)``
    is called after each micro-step. ``rank`` (distributed) joins each
    step's generator seed, and the epoch's ``batch_consistency`` is
    checked at its end.

    ``start_step``: skip the first steps, already applied to the state of
    the mid-epoch checkpoint being resumed (the loader order and the step
    generators derive from (seed, epoch, step) only, so the schedule
    replays exactly); the average then covers the resumed span.
    ``guard`` / ``cadence``: the stop check and the cadence save after each
    step. ``tracer`` / ``step_events``: one ``train/step`` event a step
    with its host time (no device sync) and the ``data/stall_s`` delta
    since the previous step."""
    loader.set_epoch(epoch)
    try:
        steps_total = len(loader)
    except TypeError:
        steps_total = None
    reg = obs.get_registry()
    stall_c = reg.counter("data/stall_s")
    step_res = reg.reservoir("train/step_ms")
    emit = step_events and tracer is not None and tracer.enabled
    stall_prev = stall_c.value
    total, counter, cons = None, 0.0, None
    for step_idx, batch in enumerate(loader):
        if step_idx < start_step:
            stall_prev = stall_c.value
            continue    # applied before the checkpoint this run resumed
        batch = batch.to(device)
        gen = step_generator(seed, epoch, step_idx, device, rank)
        t_step = time.perf_counter()
        state, metrics = train_step(state, batch, gen)
        dt_step = time.perf_counter() - t_step
        step_res.record(1e3 * dt_step)
        if emit:
            stall_now = stall_c.value
            tracer.event("train/step", epoch=epoch, step=step_idx,
                         dur_s=round(dt_step, 6),
                         stall_s=round(stall_now - stall_prev, 6))
            stall_prev = stall_now
        if on_step is not None:
            on_step(epoch, step_idx, metrics)
        bsz = batch.batch_size
        contrib = metrics["loss"] * bsz
        total = contrib if total is None else total + contrib
        counter += bsz
        if "batch_consistency" in metrics:
            c = metrics["batch_consistency"]
            cons = c if cons is None else torch.maximum(cons, c)
        if cadence is not None:
            if steps_total is not None and step_idx + 1 == steps_total:
                # a save on the epoch's last step is (epoch, 0): a resume
                # starts the next epoch instead of replaying an empty rest
                cadence.maybe_save(state, epoch, 0)
            else:
                cadence.maybe_save(state, epoch - 1, step_idx + 1)
        if guard is not None and guard.stop_agreed():
            guard.interrupted = True
            guard.steps_done = step_idx + 1
            break
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


def run_dir(config) -> str:
    """``<log.log_dir>/<log.exp_name>``: the run's logs, checkpoints,
    events and traces."""
    return os.path.join(config.log.log_dir,
                        config.log.get("exp_name", "run"))


def configure_obs(config):
    """Bind the event stream under the run's directory (rank 0 writes
    ``obs/events.jsonl``, every rank ``events_p<rank>.jsonl`` under
    ``obs.per_host``, none under ``obs.enable: false``); returns the
    tracer."""
    return obs.configure_from_config(
        config, run_dir(config),
        tags={"run": config.log.get("exp_name", "run")})


class _EpochTrace:
    """A torch.profiler trace (CPU and, on a card, CUDA activities) of one
    epoch, exported as a Chrome trace ``<trace_dir>/epoch<n>.json``."""

    def __init__(self, trace_dir: str, epoch: int, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        self.path = os.path.join(trace_dir, f"epoch{epoch}.json")
        self.device = device
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> str:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._prof = self._prof, None
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(self.path)
        return self.path


def train(state, train_step: Callable, eval_step: Callable, loader_train,
          loader_valid, loader_test, config, device: torch.device,
          start_epoch: int = 0, on_step: Optional[Callable] = None,
          rank: Optional[int] = None, start_step_in_epoch: int = 0,
          axis_name: Optional[str] = None, tracer=None):
    """Full training run. Returns (state, best_state, best, log_dict):
    ``best_state`` is a CPU copy of the model's state_dict at the best
    validation loss; ``best['preempted']`` is set when a signal stopped
    the run. ``start_step_in_epoch``: steps of epoch ``start_epoch + 1``
    already applied to ``state`` (a mid-epoch checkpoint). ``rank`` /
    ``axis_name``: this process's rank and the graph axis of a distributed
    run (None on one device); only rank 0 prints and writes. The stop
    agreement and the replication check span the whole mesh, and the
    ranks of one tensor group draw the same MMD samples (their loss is one
    replicated value). ``tracer``:
    the run's event stream when the caller bound it already
    (:func:`configure_obs`), else it is bound here."""
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
    exp_dir = run_dir(config)
    log_dir = os.path.join(exp_dir, "log")
    ckpt_dir = os.path.join(exp_dir, "state_dict")
    if is_main:
        os.makedirs(log_dir, exist_ok=True)
        os.makedirs(ckpt_dir, exist_ok=True)
    cfg = config.to_dict() if hasattr(config, "to_dict") else dict(config)
    log = _log if is_main else (lambda msg: None)

    obs_cfg = config.get("obs") or {}
    tracer = tracer or configure_obs(config)
    cudaprobe.configure(bool(obs_cfg.get("jax_probe", True)), device)
    step_events = bool(obs_cfg.get("step_events", True))
    stall_c = obs.get_registry().counter("data/stall_s")
    shape, world_axes, draw_rank = (1, 1, 1), None, rank
    if axis_name is not None:
        from distegnn_tpu_torch.parallel.mesh import WORLD_AXES, mesh_shape

        shape, world_axes = mesh_shape(), WORLD_AXES
        # the MMD draw: one a (data, graph) coordinate
        draw_rank = rank // shape[2]
    world = shape[0] * shape[1] * shape[2]
    mesh_tag = "x".join(str(int(v)) for v in shape)
    tracer.event("train/run_start", start_epoch=start_epoch,
                 epochs=int(train_cfg.epochs), scan_epochs=False,
                 devices=(torch.cuda.device_count() if device.type == "cuda"
                          else 1),
                 processes=world, mesh=mesh_tag)
    cudaprobe.emit_memory_event(tracer, phase="run_start", mesh=mesh_tag)
    cudaprobe.record_memory_gauges("run_start")
    if start_epoch or start_step_in_epoch:
        tracer.event("train/resume", epoch=start_epoch,
                     step_in_epoch=int(start_step_in_epoch or 0))
    start = time.perf_counter()

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

    guard = PreemptionGuard(world_axes, device).install()
    # trainer end of the promotion conveyor: every rotated cadence
    # checkpoint is republished as a candidate the gateway's promoter can
    # canary. Rank 0 only, as the checkpoints themselves.
    publisher = None
    pm_cfg = config.get("promote") or {}
    if (is_main and pm_cfg.get("publish")
            and str(pm_cfg.get("watch_dir", "")).strip()):
        from distegnn_tpu_torch.promote.publish import CandidatePublisher

        publisher = CandidatePublisher(str(pm_cfg["watch_dir"]),
                                       history=int(pm_cfg.get("history", 4)))
    cadence = CadenceSaver(
        ckpt_dir, train_cfg.get("checkpoint_interval_s", 0),
        train_cfg.get("keep_checkpoints", 3), cfg, seed, enabled=is_main,
        publisher=publisher)
    retries_left = int(train_cfg.get("divergence_retries", 0) or 0)
    lr_decay = float(train_cfg.get("divergence_lr_decay", 0.5) or 0.5)
    lr_scale = 1.0
    try:
        steps_per_epoch = len(loader_train)
    except TypeError:
        steps_per_epoch = None
    # the last finite-loss state (at the start: the restored one, its
    # accumulated gradient included) and the log lengths at that point, so
    # that a rollback also rewinds the curves (loss_train[i] is the absolute
    # epoch start_epoch + 1 + i: a retried epoch must not append twice)
    finite_snap = (snapshot_state(state), start_epoch, 0, 0)

    def preempt_exit(completed_epoch: int, step_in_epoch: int) -> None:
        name = "preempt_model.ckpt"
        path = os.path.join(ckpt_dir, name)
        if is_main:
            save_checkpoint(path, state, completed_epoch, config=cfg,
                            seed=seed, step_in_epoch=step_in_epoch)
            write_preempt_marker(ckpt_dir, name, completed_epoch,
                                 step_in_epoch)
            log(f"PREEMPTED (signal {guard.signum}): checkpointed epoch "
                f"{completed_epoch} + {step_in_epoch} step(s) to {path}; "
                "resume with train.resume: auto")
        tracer.event("train/preempt", epoch=completed_epoch,
                     step_in_epoch=step_in_epoch, signal=guard.signum)
        tracer.flush()
        best["preempted"] = {"epoch": completed_epoch,
                             "step_in_epoch": step_in_epoch,
                             "signal": guard.signum, "checkpoint": path}
        write_log()

    trace = None
    try:
        epoch = start_epoch    # the last completed epoch
        resume_step = int(start_step_in_epoch or 0)
        warmup_marked = False
        while epoch < train_cfg.epochs:
            epoch += 1
            t_epoch = time.perf_counter()
            stall_e0 = stall_c.value
            if is_main and int(log_cfg.get("trace_epoch", 0) or 0) == epoch:
                trace = _EpochTrace(os.path.join(exp_dir, "trace"), epoch,
                                    device)
            guard.interrupted, guard.steps_done = False, 0
            state, loss_train = run_epoch_train(
                train_step, state, loader_train, seed, epoch, device,
                on_step, draw_rank, start_step=resume_step, guard=guard,
                cadence=cadence, tracer=tracer, step_events=step_events)
            resume_step = 0    # only the first resumed epoch skips steps
            if trace is not None:
                log(f"profiler trace of epoch {epoch} written to "
                    f"{trace.stop()}")
                trace = None
            dt_epoch = time.perf_counter() - t_epoch

            # preempted mid-epoch: the state holds a part of the epoch;
            # checkpoint it with its step count (a resume replays the rest)
            # and do not log the part's loss as the epoch's
            if guard.interrupted and (steps_per_epoch is None
                                      or guard.steps_done < steps_per_epoch):
                preempt_exit(epoch - 1, guard.steps_done)
                break

            log_dict["loss_train"].append(loss_train)
            log_dict["epoch_time"].append(round(dt_epoch, 4))
            tracer.event(
                "train/epoch", epoch=epoch, dur_s=round(dt_epoch, 4),
                stall_s=round(stall_c.value - stall_e0, 4),
                loss_train=(loss_train if np.isfinite(loss_train)
                            else repr(loss_train)))
            if not np.isfinite(loss_train):
                if retries_left > 0:
                    # roll back to the last finite state and retry from
                    # there at a decayed learning rate (the Adam state
                    # carries over)
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
                    tracer.event("train/divergence", epoch=epoch,
                                 loss_train=repr(loss_train),
                                 retries_left=retries_left)
                    tracer.event("train/rollback", epoch=epoch,
                                 rolled_back_to=snap_epoch,
                                 lr_scale=round(lr_scale, 6))
                    log(f"DIVERGED at epoch {epoch}: train loss {loss_train}"
                        f"; rolling back to epoch {snap_epoch} state, "
                        f"lr_scale={lr_scale:g} ({retries_left} retries "
                        "left)")
                    epoch = snap_epoch
                    continue
                best["diverged"] = {"epoch": epoch,
                                    "loss_train": repr(loss_train),
                                    "retries_exhausted": int(train_cfg.get(
                                        "divergence_retries", 0) or 0)}
                tracer.event("train/divergence", epoch=epoch,
                             loss_train=repr(loss_train), fatal=True)
                log(f"DIVERGED at epoch {epoch}: train loss {loss_train}; "
                    "stopping (divergence retries exhausted — resume from "
                    "the last checkpoint with a lower lr)")
                write_log()
                break
            finite_snap = (snapshot_state(state), epoch,
                           len(log_dict["loss_train"]),
                           len(log_dict["epochs"]))

            # a signal at the epoch boundary (it landed on the last step):
            # checkpoint the completed epoch and exit before the evaluation
            if guard.stop_at_boundary():
                preempt_exit(epoch, 0)
                break

            if epoch % log_cfg.test_interval == 0:
                t_eval = time.perf_counter()
                loss_valid = run_epoch_eval(eval_step, loader_valid, device)
                loss_test = run_epoch_eval(eval_step, loader_test, device)
                tracer.event("train/eval", epoch=epoch,
                             dur_s=round(time.perf_counter() - t_eval, 4),
                             loss_valid=float(loss_valid),
                             loss_test=float(loss_test))
                if np.isfinite(loss_valid):
                    # candidates published after this eval carry this loss
                    cadence.last_val_loss = float(loss_valid)
                if not warmup_marked:
                    # both the train and the eval step have run: the
                    # steady-state footprint
                    warmup_marked = True
                    cudaprobe.emit_memory_event(tracer, phase="post_warmup",
                                                mesh=mesh_tag)
                    cudaprobe.record_memory_gauges("post_warmup")
                if axis_name is not None and \
                        log_cfg.get("check_consistency", True):
                    from distegnn_tpu_torch.parallel.checks import \
                        assert_replicated

                    assert_replicated(state.model, world_axes,
                                      f"eval of epoch {epoch}")
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
    finally:
        if trace is not None:
            trace.stop()
        guard.uninstall()
        tracer.flush()
    return state, best_state, best, log_dict


def _sanitize_nonfinite(log_dict):
    """Non-finite floats -> None (json null): a bare NaN token is not JSON."""
    def fix(v):
        if isinstance(v, float) and not np.isfinite(v):
            return None
        return v

    return {k: [fix(v) for v in vals] if isinstance(vals, list) else vals
            for k, vals in log_dict.items()}
