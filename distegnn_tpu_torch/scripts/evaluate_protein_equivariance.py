"""Protein test_rot / test_trans equivariance evaluation (the port's
counterpart of ``scripts/evaluate_protein_equivariance.py``).

The reference evaluates empirical E(3)-equivariance by REBUILDING the test
split with a random rotation (test_rot) or a box-scaled translation
(test_trans) injected into every frame, and reporting test MSE on each
variant. An equivariant model scores the same MSE on all three (up to
float noise); a non-equivariant one degrades under the injection.

This script loads a trained checkpoint (of either package:
``train.checkpoint.load_params``) and reports the test MSE triple:

    python -m distegnn_tpu_torch.scripts.evaluate_protein_equivariance \\
        --config_path configs/protein_fastegnn.yaml \\
        --checkpoint logs/<exp>/state_dict/best_model.ckpt \\
        [--json out.json] [--device cpu]

The model runs on the card unless ``--device cpu`` asks for the plain
PyTorch path; without a card the default raises.
"""

from __future__ import annotations

import argparse
import json

import torch


def _test_loader(config, variant: str):
    from distegnn_tpu_torch.data.loader import GraphDataset, GraphLoader
    from distegnn_tpu_torch.data.protein import process_protein_cutoff

    d = config.data
    paths = process_protein_cutoff(
        d.data_dir, d.dataset_name, d.max_samples, d.radius, d.delta_t,
        d.cutoff_rate, backbone=d.backbone,
        test_rot=(variant == "rot"), test_trans=(variant == "trans"),
        seed=config.seed)
    ds_test = GraphDataset(paths[2], node_order=d.node_order)
    return GraphLoader(ds_test, d.batch_size, shuffle=False,
                       seed=config.seed, node_bucket=d.node_bucket,
                       edge_bucket=d.edge_bucket)


def test_mse(config, eval_step, variant: str, device) -> float:
    num, den = 0.0, 0.0
    for batch in _test_loader(config, variant):
        # node-weighted global MSE, accumulated the way the trainer does
        batch = batch.to(device)
        n_nodes = float(batch.node_mask.sum())
        num += float(eval_step(batch)) * n_nodes
        den += n_nodes
    return num / max(den, 1.0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distegnn_tpu_torch.scripts."
             "evaluate_protein_equivariance",
        description="protein test MSE on the plain, rotated and shifted "
                    "test splits")
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from distegnn_tpu_torch import resolve_device
    from distegnn_tpu_torch.config import derive_runtime_fields, load_config
    from distegnn_tpu_torch.models.registry import get_model
    from distegnn_tpu_torch.train.checkpoint import load_params
    from distegnn_tpu_torch.train.step import make_eval_step
    from distegnn_tpu_torch.utils.seed import fix_seed

    device = resolve_device(args.device)
    config = load_config(args.config_path)
    derive_runtime_fields(config, world_size=1)
    fix_seed(config.seed)

    model = get_model(config.model, dataset_name=config.data.dataset_name,
                      generator=torch.Generator().manual_seed(
                          int(config.seed)))
    load_params(args.checkpoint, model)
    eval_step = make_eval_step(model.to(device))

    out = {"checkpoint": args.checkpoint}
    for variant in ("plain", "rot", "trans"):
        out[f"test_mse_{variant}"] = test_mse(config, eval_step, variant,
                                              device)
        print(f"test MSE ({variant}):  {out[f'test_mse_{variant}']:.6f}")
    rel = max(abs(out["test_mse_rot"] - out["test_mse_plain"]),
              abs(out["test_mse_trans"] - out["test_mse_plain"]))
    out["max_abs_deviation"] = rel
    verdict = ("equivariant" if rel < 0.05 * out["test_mse_plain"] + 1e-6
               else "DEGRADED")
    print(f"max |deviation| vs plain: {rel:.2e} ({verdict})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
