"""Training entry point of the port (the JAX package's ``main.py``).

    python -m distegnn_tpu_torch.main --config_path configs/<x>.yaml \\
        [--epochs N --lr ... --seed ... --world_size P] [--device cpu]

``main`` parses the flags and loads the config. ``accelerate_mode:
cutoff_edges`` loads the datasets and calls :func:`run`, which builds the
loaders, the model, the optimizer and the steps and runs the epoch loop on
one device; ``run`` takes in-memory datasets too (``GraphDataset`` of graph
dicts). ``accelerate_mode: distribute`` goes to
``parallel.launch.run_distributed``: graph parts over ``torch.distributed``,
one rank each. The device defaults to the CUDA card and refuses to fall
back; ``--device cpu`` runs the plain versions of the kernels (and the
ranks over gloo on the CPU).

``train.resume: auto`` (or ``--resume auto``) continues the newest valid
checkpoint under ``log.log_dir``, a mid-epoch one included, with its seed;
``train.checkpoint_interval_s`` writes mid-epoch checkpoints. A SIGTERM or
SIGINT checkpoints the run after the in-flight micro-step and exits with
code 75 (resumable). ``train.scan_epochs`` (default ``auto``: on the card
when the staged data fit) runs the epochs on staged device data, the
micro-step replayed from CUDA graphs (train/scan_epoch.py). The run's
events land in ``<exp_dir>/obs/events.jsonl``; ``python -m
distegnn_tpu_torch.obs.report`` renders them.
"""

from __future__ import annotations

import sys

import torch

from distegnn_tpu_torch import obs, resolve_device
from distegnn_tpu_torch.config import (build_arg_parser, cli_overrides,
                                       derive_runtime_fields, load_config)
from distegnn_tpu_torch.data.loader import GraphDataset, GraphLoader
from distegnn_tpu_torch.data.nbody import process_nbody_cutoff
from distegnn_tpu_torch.data.protein import process_protein_cutoff
from distegnn_tpu_torch.data.water3d import process_water3d_cutoff
from distegnn_tpu_torch.models.registry import get_model
from distegnn_tpu_torch.train.checkpoint import (adopt_resume_seed,
                                                 resolve_resume,
                                                 restore_checkpoint,
                                                 verify_resume_consensus)
from distegnn_tpu_torch.train.step import (TrainState, make_eval_step,
                                           make_optimizer, make_train_step,
                                           needs_grad_clip)
from distegnn_tpu_torch.train.trainer import configure_obs, train
from distegnn_tpu_torch.utils.seed import fix_seed

# the exit code of a preempted, resumable run (EX_TEMPFAIL), as in JAX
EXIT_PREEMPTED = 75


def process_dataset_edge_cutoff(data_cfg, seed: int = 0):
    """The processed train/valid/test files of a cutoff-mode dataset
    (n-body, protein or Water-3D; ``seed`` draws Water-3D's frames and the
    protein test split's rotations and shifts)."""
    name = data_cfg.dataset_name
    if name.startswith("nbody"):
        return process_nbody_cutoff(
            data_cfg.data_dir, name, data_cfg.max_samples, data_cfg.radius,
            data_cfg.frame_0, data_cfg.frame_T, data_cfg.cutoff_rate)
    if name == "protein":
        return process_protein_cutoff(
            data_cfg.data_dir, name, data_cfg.max_samples, data_cfg.radius,
            data_cfg.delta_t, data_cfg.cutoff_rate,
            backbone=data_cfg.backbone, test_rot=data_cfg.test_rot,
            test_trans=data_cfg.test_trans, seed=seed)
    if name == "Water-3D":
        return process_water3d_cutoff(
            data_cfg.data_dir, name, data_cfg.max_samples, data_cfg.radius,
            data_cfg.delta_t, data_cfg.cutoff_rate, seed=seed)
    raise NotImplementedError(f"{name} has no cutoff-mode processor")


def make_loaders(config, ds_train, ds_valid, ds_test):
    """The train / valid / test loaders, as the JAX package's ``main.py``
    builds them: the compact remote list only for the fused lowerings; the
    reverse-edge pairing forced on for the scatter-free lowerings of a plain
    batch, and decided by the dataset's symmetry scan (``None``) on a
    blocked one."""
    d = config.data
    edge_block = int(d.edge_block)
    pairing = (True if (not edge_block and config.model.get("segment_impl")
                        in ("cumsum", "ell")) else None)

    def mk(ds, shuffle):
        return GraphLoader(ds, d.batch_size, shuffle=shuffle, seed=config.seed,
                           edge_block=edge_block, pairing=pairing,
                           node_bucket=int(d.node_bucket),
                           edge_bucket=int(d.edge_bucket),
                           split_remote=(config.model.get("edge_impl")
                                         in ("fused", "fused_stack")))

    return mk(ds_train, True), mk(ds_valid, False), mk(ds_test, False)


def run(config, ds_train: GraphDataset, ds_valid: GraphDataset,
        ds_test: GraphDataset, device=None, on_step=None):
    """Train ``config``'s model on the datasets on one device. Returns
    (state, best, log_dict); ``state.model`` holds the last parameters.
    ``on_step(epoch, step, metrics)`` is called after every micro-step.
    Graph parts over several ranks (``accelerate_mode: distribute``) go
    through ``parallel.launch.run_distributed``."""
    dev = resolve_device(device)
    if config.data.accelerate_mode != "cutoff_edges":
        raise ValueError(
            "run trains one device on whole graphs; accelerate_mode="
            f"{config.data.accelerate_mode!r} goes through "
            "distegnn_tpu_torch.parallel.launch.run_distributed (main "
            "dispatches it)")
    if not config.log.get("exp_name"):
        derive_runtime_fields(config)
    # a resumed run takes its checkpoint's seed before the loaders and the
    # model derive anything from it
    adopt_resume_seed(config)
    loaders = make_loaders(config, ds_train, ds_valid, ds_test)
    gen = torch.Generator().manual_seed(int(config.seed))
    model = get_model(config.model, dataset_name=config.data.dataset_name,
                      generator=gen).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    obs.log(f"[train] Model: {config.model.model_name}, {n_params} "
            f"parameters, {len(ds_train)}/{len(ds_valid)}/{len(ds_test)} "
            f"graphs, on {dev}")
    state, _, best, log_dict = train_model(config, model, loaders, dev,
                                           on_step=on_step)
    return state, best, log_dict


def train_model(config, model, loaders, dev, on_step=None, axis_name=None,
                rank=None, data_axis_name=None):
    """The optimizer, the steps and the epoch loop over (train, valid, test)
    ``loaders`` for ``model`` (on ``dev``). ``train.resume`` restores its
    checkpoint first (the model, the optimizer's whole state and the
    (epoch, step) to continue from); otherwise ``model.checkpoint`` is
    restored when set. ``axis_name`` / ``rank``: one rank of a distributed
    run, whose ranks must agree on the resume coordinates;
    ``data_axis_name`` its data axis, over which the loss and the gradient
    sum too. Returns the trainer's (state, best_state, best, log_dict)."""
    loader_train, loader_valid, loader_test = loaders
    t = config.train
    total_steps = t.epochs * len(loader_train) // t.accumulation_steps
    optimizer = make_optimizer(
        model.parameters(), t.learning_rate, weight_decay=t.weight_decay,
        clip_norm=0.3 if needs_grad_clip(config) else None,
        accumulation_steps=t.accumulation_steps,
        total_steps=max(total_steps, 1), scheduler=str(t.scheduler))
    state = TrainState(model, optimizer)
    # the event stream first: the restore's events belong to this run
    tracer = configure_obs(config)
    start_epoch, start_step = 0, 0
    resumed = resolve_resume(config, state)
    if resumed is not None:
        start_epoch, start_step = resumed.epoch, resumed.step_in_epoch
        obs.log(f"[train] resume: restored {resumed.path} (epoch "
                f"{start_epoch} + {start_step} step(s) applied)")
    elif config.model.get("checkpoint"):
        state, start_epoch, _ = restore_checkpoint(config.model.checkpoint,
                                                   state)
    # every rank resolved its own candidate: the same one, or none steps
    if axis_name is not None:
        from distegnn_tpu_torch.parallel.mesh import WORLD_AXES

        verify_resume_consensus(start_epoch, start_step, WORLD_AXES,
                                path=None if resumed is None
                                else resumed.path)
    # MMD applies to the virtual-node (Fast*) models only
    mmd_w = t.mmd.weight if config.model.model_name.startswith("Fast") else 0.0
    train_step = make_train_step(model, optimizer, mmd_w, t.mmd.sigma,
                                 t.mmd.samples, axis_name=axis_name,
                                 data_axis_name=data_axis_name)
    eval_step = make_eval_step(model, axis_name=axis_name,
                               data_axis_name=data_axis_name)
    scan_runner, loaders = make_scan_runner(config, train_step, eval_step,
                                            loaders, dev, rank)
    return train(state, train_step, eval_step, *loaders, config, dev, start_epoch=start_epoch,
                 on_step=on_step, rank=rank, start_step_in_epoch=start_step,
                 axis_name=axis_name, tracer=tracer, scan_runner=scan_runner)


def make_scan_runner(config, train_step, eval_step, loaders, dev,
                     rank=None):
    """The scanned epoch (train/scan_epoch.py) when ``train.scan_epochs``
    turns it on for the staged data on this process's card, as JAX's
    ``main.py`` and ``parallel.launch`` build theirs. Returns (runner,
    loaders): on one process a ``ScanEpochRunner`` (else None) and the
    loaders unchanged; on a rank of a distributed run (``rank``) no runner
    and the loaders replaced by ``DistributedScanRunner``s, the staged
    loaders the eager loop runs on. Under 'auto' the budget holds the
    bytes of every rank on the card (``card_nbytes``)."""
    from distegnn_tpu_torch.train.scan_epoch import (DistributedScanRunner,
                                                     ScanEpochRunner,
                                                     card_nbytes,
                                                     dataset_nbytes,
                                                     scan_enabled)

    flag = config.train.get("scan_epochs", "auto")
    if flag is False or (flag == "auto" and dev.type != "cuda"):
        return None, loaders
    total = sum(dataset_nbytes(ld) for ld in loaders)
    card = card_nbytes(total, dev) if flag == "auto" else total
    if not scan_enabled(flag, card, dev):
        return None, loaders
    loader_train, loader_valid, loader_test = loaders
    gib = f"{total / 2**30:.2f} GiB device-resident"
    if rank is None:
        obs.log(f"[train] scan_epochs: on ({gib})")
        return ScanEpochRunner(train_step, eval_step, loader_train,
                               config.seed, loader_valid=loader_valid,
                               loader_test=loader_test), loaders
    if rank == 0:
        obs.log(f"[train] scan_epochs: on ({gib} a rank, "
                f"{card / 2**30:.2f} GiB on its card)")
    return None, tuple(DistributedScanRunner(ld, dev) for ld in loaders)


def point_at_events() -> None:
    """Flush the event stream and print where it landed and how to render
    it."""
    tracer = obs.get_tracer()
    tracer.flush()
    w = tracer.writer
    if w is not None:
        obs.log(f"[train] obs: events at {w.path}; render with python -m "
                f"distegnn_tpu_torch.obs.report {w.path}")


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    config = load_config(args.config_path, cli_overrides(args))
    if config.data.accelerate_mode == "distribute":
        from distegnn_tpu_torch.parallel.launch import run_distributed

        best = run_distributed(config, device=args.device)
    else:
        derive_runtime_fields(config)
        adopt_resume_seed(config)
        fix_seed(config.seed)
        files = process_dataset_edge_cutoff(config.data, seed=config.seed)
        ds_train, ds_valid, ds_test = (
            GraphDataset(f, node_order=config.data.node_order) for f in files)
        _, best, _ = run(config, ds_train, ds_valid, ds_test,
                         device=args.device)
    if best.get("preempted"):
        obs.log(f"[train] Preempted (resumable). Best so far: {best}")
    else:
        obs.log(f"[train] Done. Best: {best}")
    point_at_events()
    return best


if __name__ == "__main__":
    _best = main(sys.argv[1:])
    if isinstance(_best, dict) and _best.get("preempted"):
        sys.exit(EXIT_PREEMPTED)
