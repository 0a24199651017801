"""Training entry point of the port (the single-device ``cutoff_edges`` flow
of the JAX package's ``main.py``).

    python -m distegnn_tpu_torch.main --config_path configs/<x>.yaml \\
        [--epochs N --lr ... --seed ...] [--device cpu]

``main`` parses the flags, loads the config and the datasets, and calls
:func:`run`, which builds the loaders, the model, the optimizer and the
steps and runs the epoch loop. ``run`` takes in-memory datasets too
(``GraphDataset`` of graph dicts). The device defaults to the CUDA card and
refuses to fall back; ``--device cpu`` runs the plain versions of the
kernels.
"""

from __future__ import annotations

import sys

import torch

from distegnn_tpu_torch import resolve_device
from distegnn_tpu_torch.config import (build_arg_parser, cli_overrides,
                                       derive_runtime_fields, load_config)
from distegnn_tpu_torch.data.loader import GraphDataset, GraphLoader
from distegnn_tpu_torch.data.nbody import process_nbody_cutoff
from distegnn_tpu_torch.models.registry import get_model
from distegnn_tpu_torch.train.checkpoint import restore_checkpoint
from distegnn_tpu_torch.train.step import (TrainState, make_eval_step,
                                           make_optimizer, make_train_step,
                                           needs_grad_clip)
from distegnn_tpu_torch.train.trainer import train
from distegnn_tpu_torch.utils.seed import fix_seed


def process_dataset_edge_cutoff(data_cfg):
    """The processed train/valid/test files of a cutoff-mode dataset."""
    name = data_cfg.dataset_name
    if name.startswith("nbody"):
        return process_nbody_cutoff(
            data_cfg.data_dir, name, data_cfg.max_samples, data_cfg.radius,
            data_cfg.frame_0, data_cfg.frame_T, data_cfg.cutoff_rate)
    raise NotImplementedError(
        f"dataset {name!r}: only the n-body processor is ported; pass "
        "in-memory datasets to distegnn_tpu_torch.main.run")


def _require_single_device(config) -> None:
    if config.data.accelerate_mode != "cutoff_edges":
        raise NotImplementedError(
            "accelerate_mode='distribute' (graph partitions over "
            "torch.distributed, launch.py) comes with the distributed slice "
            "of the port")


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
    """Train ``config``'s model on the datasets. Returns (state, best,
    log_dict); ``state.model`` holds the last parameters. ``on_step(epoch,
    step, metrics)`` is called after every micro-step."""
    dev = resolve_device(device)
    _require_single_device(config)
    if not config.log.get("exp_name"):
        derive_runtime_fields(config)
    loader_train, loader_valid, loader_test = make_loaders(
        config, ds_train, ds_valid, ds_test)

    gen = torch.Generator().manual_seed(int(config.seed))
    model = get_model(config.model, generator=gen).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] Model: {config.model.model_name}, {n_params} parameters, "
          f"{len(ds_train)}/{len(ds_valid)}/{len(ds_test)} graphs, on {dev}",
          flush=True)
    t = config.train
    total_steps = t.epochs * len(loader_train) // t.accumulation_steps
    optimizer = make_optimizer(
        model.parameters(), t.learning_rate, weight_decay=t.weight_decay,
        clip_norm=0.3 if needs_grad_clip(config) else None,
        accumulation_steps=t.accumulation_steps,
        total_steps=max(total_steps, 1), scheduler=str(t.scheduler))
    state = TrainState(model, optimizer)
    start_epoch = 0
    if config.model.get("checkpoint"):
        state, start_epoch, _ = restore_checkpoint(config.model.checkpoint,
                                                   state)
    # MMD applies to the virtual-node (Fast*) models only
    mmd_w = t.mmd.weight if config.model.model_name.startswith("Fast") else 0.0
    train_step = make_train_step(model, optimizer, mmd_w, t.mmd.sigma,
                                 t.mmd.samples)
    eval_step = make_eval_step(model)
    state, _, best, log_dict = train(
        state, train_step, eval_step, loader_train, loader_valid,
        loader_test, config, dev, start_epoch=start_epoch, on_step=on_step)
    return state, best, log_dict


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    config = load_config(args.config_path, cli_overrides(args))
    _require_single_device(config)
    derive_runtime_fields(config)
    fix_seed(config.seed)
    files = process_dataset_edge_cutoff(config.data)
    ds_train, ds_valid, ds_test = (
        GraphDataset(f, node_order=config.data.node_order) for f in files)
    _, best, _ = run(config, ds_train, ds_valid, ds_test, device=args.device)
    print(f"[train] Done. Best: {best}", flush=True)
    return best


if __name__ == "__main__":
    main(sys.argv[1:])
