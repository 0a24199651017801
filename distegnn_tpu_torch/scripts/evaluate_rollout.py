"""Autoregressive rollout MSE evaluation (the port's counterpart of
``scripts/evaluate_rollout.py``).

Drives the port's rollout (distegnn_tpu_torch/rollout.py: predict ->
rebuild the radius graph on the device (ops/radius_dev.py) -> next step)
against ground-truth trajectory frames and reports MSE per horizon.

Wired datasets (dispatch on config data.dataset_name):
  nbody*    — raw loc/vel/charges .npy trajectories; full graph emulated with
              a radius larger than the system; horizons keyed by FRAME index.
  Water-3D  — h5 trajectories (read by data/hdf5.py), multi-step
              (--max-steps) radius-graph rollout; horizons keyed by rollout
              STEP (each spanning delta_t frames); rollout displacement
              rescaled to the pipeline's one-frame velocity convention.
  Fluid113K — zstd/msgpack simulations; horizons keyed by rollout STEP;
              velocity convention converted with a data-estimated frame
              duration. Needs the ``zstandard`` module: without it the leg
              is refused by name.

Parameters come from ``--checkpoint`` (a checkpoint of either package,
``train.checkpoint.load_params``), else they are drawn from the config's
seed.

    python -m distegnn_tpu_torch.scripts.evaluate_rollout \\
        --config_path configs/nbody_fastegnn.yaml \\
        [--checkpoint logs/.../best_model.ckpt] [--samples 50] \\
        [--split test] [--device cpu]

The model runs on the card unless ``--device cpu`` (or JAX's ``--platform
cpu``) asks for the plain PyTorch path; without a card the default raises.
Prints one JSON line: {"metric": "rollout_mse", "horizons": {frame: mse},
...}
"""

from __future__ import annotations

import argparse
import functools
import json
import os

import numpy as np
import torch

_OVERFLOW_MSG = ("radius-graph capacity overflow — re-run with a larger "
                 "--degree-margin; MSE from a truncated graph is invalid")


def _speed_plus_static_feature(v, static):
    """The n-body / Water-3D feature_fn: [|v|, static channel] — the
    conventions of the training pipelines (nbody.py build_nbody_graph:
    [|v|, q/q.max]; water3d.py build_water3d_graph: [|v|, type/type.max]);
    the static channel is computed per sample with those normalizations."""
    return torch.cat([torch.linalg.norm(v, dim=-1, keepdim=True), static],
                     dim=-1)


def _static_plus_speed_feature(v, static):
    """Fluid113K's feature_fn: [viscosity, mass, |v|] — static channels
    FIRST, matching build_fluid_graph (data/fluid113k.py)."""
    return torch.cat([static, torch.linalg.norm(v, dim=-1, keepdim=True)],
                     dim=-1)


def _model(config, checkpoint, seed, device):
    """The config's model with parameters from ``checkpoint`` when given,
    else drawn from ``seed`` (smoke mode)."""
    from distegnn_tpu_torch.models.registry import get_model
    from distegnn_tpu_torch.train.checkpoint import load_params

    model = get_model(config.model, dataset_name=config.data.dataset_name,
                      generator=torch.Generator().manual_seed(int(seed)))
    if checkpoint:
        # params-only: evaluation loads checkpoints written with ANY
        # optimizer wrapping, and JAX's checkpoints too
        load_params(checkpoint, model)
    return model.to(device).eval()


def _rollout(model, radius, max_degree, max_per_cell, feature_fn, static,
             edge_block, velocity_scale, loc0, vel0, mask, steps, device,
             node_attr=None):
    """One padded scene through the port's rollout: (traj [steps, N, 3]
    numpy, any overflow)."""
    from distegnn_tpu_torch.rollout import make_rollout_fn

    t = functools.partial(torch.as_tensor, device=device)
    rollout = make_rollout_fn(
        model, radius=radius, max_degree=max_degree,
        max_per_cell=max_per_cell,
        feature_fn=lambda v: feature_fn(v, t(static)),
        edge_block=edge_block, velocity_scale=velocity_scale,
        node_attr=None if node_attr is None else t(node_attr))
    traj, overflow = rollout(t(loc0), t(vel0), t(mask), steps)
    return traj.cpu().numpy(), bool(overflow.any())


def evaluate_nbody_rollout(config, checkpoint=None, samples=50, split="test",
                           edge_block=256, seed=0, device="cpu"):
    """Rollout the n-body test trajectories; returns ({horizon_frame: mse},
    steps, num)."""
    from distegnn_tpu_torch.data.nbody import _find_tag
    from distegnn_tpu_torch.ops.graph import _round_up

    base = os.path.join(config.data.data_dir, config.data.dataset_name)
    tag = _find_tag(base, split)
    loc = np.load(os.path.join(base, f"loc_{split}_{tag}.npy"))[:samples]
    vel = np.load(os.path.join(base, f"vel_{split}_{tag}.npy"))[:samples]
    charges = np.load(os.path.join(base,
                                   f"charges_{split}_{tag}.npy"))[:samples]
    num, T, n, _ = loc.shape
    f0, fT = config.data.frame_0, config.data.frame_T
    delta = fT - f0
    steps = max((T - 1 - f0) // delta, 1)
    horizons = [f0 + (k + 1) * delta for k in range(steps)
                if f0 + (k + 1) * delta < T]
    if not horizons:
        raise ValueError(
            f"trajectory too short to evaluate: T={T} frames, first horizon "
            f"would be frame {f0 + delta} (frame_0={f0}, delta={delta})")

    N = _round_up(n, edge_block)
    node_mask = np.zeros((N,), np.float32)
    node_mask[:n] = 1.0

    # full graph (radius -1) emulated with a radius larger than any system
    # extent; real radius configs pass through unchanged
    radius = float(config.data.radius)
    if radius <= 0:
        radius = float(np.abs(loc).max()) * 2.0 + 1.0
    max_degree = max(_round_up(n - 1, 2), 2)
    while (max_degree * edge_block) % 512:
        max_degree += 2

    model = _model(config, checkpoint, seed, device)
    mse_acc = {h: 0.0 for h in horizons}
    for k in range(num):
        # normalization matches the training pipeline (build_nbody_graph:
        # charges / charges.max(), no abs)
        qn_pad = np.zeros((N, 1), np.float32)
        qn_pad[:n] = (charges[k] / charges[k].max()).astype(
            np.float32).reshape(n, 1)
        loc0 = np.zeros((N, 3), np.float32)
        vel0 = np.zeros((N, 3), np.float32)
        loc0[:n], vel0[:n] = loc[k, f0], vel[k, f0]
        traj, overflow = _rollout(
            model, radius, max_degree, N, _speed_plus_static_feature,
            qn_pad, edge_block, 1.0, loc0, vel0, node_mask, steps, device)
        if overflow:
            raise RuntimeError(
                f"radius-graph capacity overflow on sample {k} — raise "
                "max_degree/max_per_cell; MSE from a truncated graph is "
                "invalid")
        for i, h in enumerate(horizons):
            mse_acc[h] += float(np.mean((traj[i][:n] - loc[k, h]) ** 2))
    return {h: mse_acc[h] / num for h in horizons}, steps, num


def _calibrate_degree(first_frames, radius, edge_block, margin):
    """(max_degree, max_per_cell) for the on-device radius graph, from the
    max observed first-frame degree x safety margin, 512-aligned for the
    blocked layout."""
    from distegnn_tpu_torch.ops.graph import _round_up
    from distegnn_tpu_torch.ops.radius import radius_graph_np

    deg0 = 1
    for pos0 in first_frames:
        ei = radius_graph_np(pos0, radius)
        deg = (np.bincount(ei[0], minlength=pos0.shape[0]).max()
               if ei.size else 1)
        deg0 = max(deg0, int(deg))
    max_degree = _round_up(int(deg0 * margin) + 1, 2)
    while (max_degree * edge_block) % 512:
        max_degree += 2
    return max_degree, max(int(deg0 * margin), 32)


def evaluate_water3d_rollout(config, checkpoint=None, samples=4,
                             split="test", edge_block=256, seed=0,
                             max_steps=5, degree_margin=2.0, device="cpu"):
    """Multi-step rollout over Water-3D h5 trajectories; returns
    ({step_index: mse}, steps, num_trajectories). Each rollout step spans
    ``delta_t`` frames starting at frame 0; velocities follow the training
    convention (one-frame position delta), so the rollout's displacement is
    rescaled by 1/delta_t."""
    from distegnn_tpu_torch.data.hdf5 import H5File
    from distegnn_tpu_torch.ops.graph import _round_up

    radius = float(config.data.radius)
    delta = int(config.data.delta_t)
    trajs, t_min = [], None
    with H5File(os.path.join(config.data.data_dir, config.data.dataset_name,
                             f"{split}.h5")) as f:
        for key in sorted(f.keys())[:samples]:
            pos = f.read(key, "position")
            T = pos.shape[0]
            t_min = T if t_min is None else min(t_min, T)
            # a rollout of max_steps touches the first max_steps*delta + 1
            # frames (vel0 needs frame 1)
            trajs.append((np.array(pos[:max_steps * delta + 1], np.float32),
                          np.asarray(f.read(key, "particle_type"),
                                     np.float32)))
    if not trajs:
        raise ValueError("no trajectories in the h5 file")

    # a step k needs target frame k*delta and vel0 needs frame 1 (T >= 2)
    steps = min(max_steps, (t_min - 1) // delta)
    if steps < 1 or t_min < 2:
        raise ValueError(
            f"trajectories too short for one rollout step of delta_t={delta} "
            f"(shortest has {t_min} frames)")
    n_max = max(p.shape[1] for p, _ in trajs)
    N = _round_up(n_max, edge_block)

    max_degree, max_per_cell = _calibrate_degree(
        (pos[0] for pos, _ in trajs), radius, edge_block, degree_margin)

    model = _model(config, checkpoint, seed, device)
    mse_acc = {k: 0.0 for k in range(1, steps + 1)}
    for pos, ptype in trajs:
        n = pos.shape[1]
        mask = np.zeros((N,), np.float32)
        mask[:n] = 1.0
        tn = np.zeros((N, 1), np.float32)
        tn[:n, 0] = ptype / max(float(ptype.max()), 1e-12)
        loc0 = np.zeros((N, 3), np.float32)
        vel0 = np.zeros((N, 3), np.float32)
        loc0[:n] = pos[0]
        vel0[:n] = pos[1] - pos[0]
        traj, overflow = _rollout(
            model, radius, max_degree, max_per_cell,
            _speed_plus_static_feature, tn, edge_block, 1.0 / delta, loc0,
            vel0, mask, steps, device)
        if overflow:
            raise RuntimeError(_OVERFLOW_MSG)
        for k in range(1, steps + 1):
            mse_acc[k] += float(np.mean((traj[k - 1][:n]
                                         - pos[k * delta]) ** 2))
    num = len(trajs)
    return {k: v / num for k, v in mse_acc.items()}, steps, num


def evaluate_fluid113k_rollout(config, checkpoint=None, samples=2,
                               split="test", edge_block=256, seed=0,
                               max_steps=5, degree_margin=2.0, device="cpu"):
    """Multi-step rollout over Fluid113K (LargeFluid) simulations. Horizons
    keyed by rollout step (delta_t frames each, starting at frame 0). The
    sim's own velocity field is the model input; the rollout's delta_t-frame
    displacement is converted back to that convention with a data-estimated
    frame duration."""
    import importlib.util

    if importlib.util.find_spec("zstandard") is None:
        raise RuntimeError(
            "the Fluid113K leg reads zstd-compressed simulations and needs "
            "the 'zstandard' module, which is not installed here")
    from distegnn_tpu_torch.data.fluid113k import SIM_SPLITS, read_sim
    from distegnn_tpu_torch.ops.graph import _round_up

    delta = int(config.data.delta_t)
    radius = float(config.data.inner_radius or config.data.radius)
    lo, hi = SIM_SPLITS[split]
    sims = []
    for idx in range(lo, min(lo + samples, hi)):
        try:
            pos, vel, visc, mass = read_sim(config.data.data_dir,
                                            config.data.dataset_name, idx)
        except FileNotFoundError:
            break
        # keep only the frames a rollout touches: 0..max_steps*delta
        keep = max_steps * delta + 1
        sims.append((pos[:keep] if pos.shape[0] > keep else pos,
                     vel[:1], visc, mass))
    if not sims:
        raise ValueError(f"no {split} simulations found under "
                         f"{config.data.data_dir}/{config.data.dataset_name}")

    t_min = min(pos.shape[0] for pos, _, _, _ in sims)
    steps = min(max_steps, (t_min - 1) // delta)
    if steps < 1:
        raise ValueError(
            f"simulations too short for one rollout step of delta_t={delta} "
            f"(shortest has {t_min} frames)")
    n_max = max(pos.shape[1] for pos, _, _, _ in sims)
    N = _round_up(n_max, edge_block)

    # frame duration estimated from the data: |pos[1]-pos[0]| ~ |vel[0]|*dt.
    # A degenerate estimate means the velocity convention cannot be
    # recovered and any MSE would be silently wrong — refuse.
    dts = []
    for pos, vel, _, _ in sims:
        dx = np.linalg.norm(pos[1] - pos[0], axis=1)
        v0 = np.linalg.norm(vel[0], axis=1)
        ok = v0 > 1e-8
        if ok.any():
            dts.append(float(np.median(dx[ok] / v0[ok])))
    frame_dt = float(np.median(dts)) if dts else 0.0
    if not np.isfinite(frame_dt) or frame_dt <= 0:
        raise ValueError(
            "cannot estimate the frame duration from the data (static first "
            "frames or zero velocities) — the rollout velocity convention "
            "would be wrong; check the simulation dump")

    max_degree, max_per_cell = _calibrate_degree(
        (pos[0] for pos, _, _, _ in sims), radius, edge_block, degree_margin)

    model = _model(config, checkpoint, seed, device)
    mse_acc = {k: 0.0 for k in range(1, steps + 1)}
    for pos, vel, viscosity, mass in sims:
        n = pos.shape[1]
        mask = np.zeros((N,), np.float32)
        mask[:n] = 1.0
        attr = np.zeros((N, 2), np.float32)
        attr[:n, 0] = viscosity
        attr[:n, 1] = mass
        loc0 = np.zeros((N, 3), np.float32)
        vel0 = np.zeros((N, 3), np.float32)
        loc0[:n], vel0[:n] = pos[0], vel[0]
        # attr enters BOTH as node_feat channels (feature_fn) and as the
        # model's node_attr input (node_attr_nf=2 in the largefluid config)
        traj, overflow = _rollout(
            model, radius, max_degree, max_per_cell,
            _static_plus_speed_feature, attr, edge_block,
            1.0 / (delta * frame_dt), loc0, vel0, mask, steps, device,
            node_attr=attr)
        if overflow:
            raise RuntimeError(_OVERFLOW_MSG)
        for k in range(1, steps + 1):
            mse_acc[k] += float(np.mean((traj[k - 1][:n]
                                         - pos[k * delta]) ** 2))
    num = len(sims)
    return {k: v / num for k, v in mse_acc.items()}, steps, num


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distegnn_tpu_torch.scripts.evaluate_rollout",
        description="multi-step rollout MSE per horizon")
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--samples", type=int, default=50)
    ap.add_argument("--split", default="test")
    ap.add_argument("--max-steps", type=int, default=5,
                    help="rollout horizon cap (trajectory datasets)")
    ap.add_argument("--degree-margin", type=float, default=2.0,
                    help="radius-graph capacity = observed degree x margin")
    ap.add_argument("--platform", default=None,
                    help="JAX's flag: a platform name, read as --device "
                         "(cpu or cuda)")
    ap.add_argument("--device", type=str, default=None,
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from distegnn_tpu_torch import resolve_device
    from distegnn_tpu_torch.config import load_config

    if args.device and args.platform and args.device != args.platform:
        raise SystemExit(f"--device {args.device} and --platform "
                         f"{args.platform} disagree")
    device = resolve_device(args.device or args.platform or "cuda")
    config = load_config(args.config_path)
    name = config.data.dataset_name
    kw = dict(checkpoint=args.checkpoint, samples=args.samples,
              split=args.split, seed=int(config.get("seed", 0)),
              device=device)
    if name.startswith("nbody"):
        horizons, steps, num = evaluate_nbody_rollout(config, **kw)
    elif name == "Water-3D":
        horizons, steps, num = evaluate_water3d_rollout(
            config, max_steps=args.max_steps,
            degree_margin=args.degree_margin, **kw)
    elif name == "Fluid113K":
        horizons, steps, num = evaluate_fluid113k_rollout(
            config, max_steps=args.max_steps,
            degree_margin=args.degree_margin, **kw)
    else:
        raise SystemExit(f"no rollout evaluator wired for dataset {name!r} "
                         "(supported: nbody*, Water-3D, Fluid113K)")
    rec = {
        "metric": "rollout_mse",
        "dataset": name,
        "split": args.split,
        "samples": num,
        "steps": steps,
        "checkpoint": args.checkpoint,
        # significant figures, not fixed decimals: fluid displacement
        # targets give MSEs of 1e-9 scale, which round(_, 6) flattens to 0
        "horizons": {str(k): float(f"{v:.4g}") for k, v in horizons.items()},
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
