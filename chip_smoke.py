#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that the PyTorch port runs on a GPU.

Run from the root of a checkout, with one CUDA card and no arguments:

    python3 chip_smoke.py

It drives the port (``distegnn_tpu_torch``) only and imports nothing of JAX
or of the JAX package. Phases (any failure exits nonzero):

  1. print the card (nvidia-smi name, power limit); build every kernel of
     the serving and training paths from ``distegnn_tpu_torch/csrc`` with
     nvcc (sm_90a), one nvcc per source, all started together.
  2. hold the forward kernel against its plain PyTorch version on the card
     (N=8192 = 16 blocks of 512, H=64, a Morton-ordered radius graph of mean
     degree ~20), in f32 and bf16.
  2b. the same for the backward kernel, with random cotangents: all ten
     outputs (d_x, d_hr, d_hc and the seven weight gradients).
  3. serve: ``engine_with_params_from_config`` on configs/nbody_serve.yaml
     with model.edge_impl=fused and data.edge_block=512 (H=64, L=4, C=3,
     max_batch 4, random weights from the config's seed); answer four
     Morton-ordered scenes of ~1500/3000/6000/10000 nodes with every launch
     count set to 0 just before and read just after; check finiteness, the
     exact launch count, equivariance under a random rotation + translation,
     and agreement with the same model run through the plain version.
  4. time each kernel and its plain version with CUDA events, its bound from
     this run's shapes, and per-request predict time on the host clock.
  5. train: ``distegnn_tpu_torch.main.run`` on configs/largefluid_distegnn.yaml
     + model.edge_impl=fused, data.edge_block=512,
     data.accelerate_mode=cutoff_edges (H=64, L=4, C=3, bf16, remat, MSE +
     MMD, Adam with 4-step accumulation, random weights from the config's
     seed) over 4 train + 1 valid + 1 test synthetic fluid clouds of 113140
     nodes, 2 epochs; both launch counts set to 0 just before and checked
     exactly just after; finite losses, parameters moved; both kernels held
     against their plain versions at the train batch's shape and dtype (all
     3 forward and 10 backward outputs) and timed there; then the first
     optimizer update again with the kernels and with their plain versions
     (losses, gradient norm, and each parameter's gradient must agree),
     micro-step ms, nodes/s and peak device memory.

With ``--profile`` it then breaks one request of the largest scene into host
stages and profiles it with torch.profiler (device time by kernel, the
device's idle share), and profiles one train micro-step the same way.

Output: timing lines, then one JSON line ``{"kernels": [...]}``, the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"f32": 67e12, "bf16": 989e12}

BLOCK = 512
KERNEL_N, KERNEL_DEG, HIDDEN = 8192, 20.0, 64
SCENES = (1500, 3000, 6000, 10000)
# tolerances, as a fraction of each output's max |plain|: f32 differs by
# summation order and by single bf16-ulp flips (2^-8) of per-edge features
# whose f32 value sat at a rounding boundary; bf16 also by such flips of
# the intermediates
TOL_MAX = {"f32": 2 ** -7, "bf16": 2 ** -5}
TOL_MEAN = {"f32": 1e-5, "bf16": 2 ** -9}
TOL_TRANS = {"f32": 1e-4, "bf16": 2 ** -5}
# served coordinates are O(1) (unit-cube scenes): rotation/translation and
# the plain path move them only through bf16 rounding flips of invariant
# edge features
TOL_EQUIV = 1e-4
TOL_PLAIN = 1e-4
# phase 5: the flagship train phase on Fluid113K-scale clouds (bench.py's
# synthetic recipe), 4 train + 1 valid + 1 test cloud, batch 1, 4-step
# accumulation, TRAIN_EPOCHS epochs with one evaluation at the end
FLUID_N, FLUID_RADIUS, FLUID_DEGREE = 113140, 0.075, 15
TRAIN_EPOCHS = 2
TRAIN_TIMED = 6
# kernels vs plain versions over one optimizer update of the bf16 model:
# relative error of each micro-step loss (with and without MMD), of the
# accumulated gradient's global norm, and its max abs error over its max abs
# entry (single bf16-ulp flips of per-edge terms between the two)
TOL_TRAIN = 1e-3
# the same, for each parameter tensor's gradient against its own max |plain|:
# the bf16 modules' weight gradients come out of bf16 products, rounded to
# bf16, and an ulp of a tensor's max is 2^-8..2^-7 of it; allow two
TOL_PARAM = 2 ** -6


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def scene(n, seed, deg=KERNEL_DEG):
    """Morton-ordered uniform scene whose radius graph has mean degree
    ~``deg`` (one radius correction for the cube's boundary)."""
    import numpy as np

    from distegnn_tpu_torch.ops.order import morton_perm, reorder_graph
    from distegnn_tpu_torch.ops.radius import radius_graph_np

    rng = np.random.default_rng(seed)
    loc = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 0.05).astype(np.float32)
    r = (3.0 * deg / (4.0 * math.pi * n)) ** (1.0 / 3.0)
    ei = radius_graph_np(loc, r)
    r *= (deg / max(ei.shape[1] / n, 1e-9)) ** (1.0 / 3.0)
    ei = radius_graph_np(loc, r)
    d = np.linalg.norm(loc[ei[0]] - loc[ei[1]], axis=1)[:, None]
    g = {"node_feat": np.linalg.norm(vel, axis=1, keepdims=True),
         "loc": loc, "vel": vel, "edge_index": ei.astype(np.int32),
         "edge_attr": np.repeat(d, 2, axis=1).astype(np.float32)}
    return reorder_graph(g, morton_perm(loc))


def cuda_ms(fn, reps=20, warm=3):
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, flops, dname):
    """Least time for the work on this card, ms: the bytes over the memory
    rate or the operations over the peak rate of their type, the larger."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dname] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def fwd_work(N, E, active, H, elt):
    """(bytes, flop) of one forward launch: inputs read once (edge stream,
    x, hr/hc of ``elt`` bytes, weights), the [N, H+8] sums written once;
    the operations of the active edges only (two H x H products)."""
    nbytes = (E * (3 * 4 + 8 * 4) + N * (3 * 4 + 2 * H * elt)
              + (2 * H * H + 7 * H) * 4 + N * (H + 8) * 4)
    return nbytes, active * (4 * H * H + 12 * H + 8)


def bwd_work(N, E, active, H, elt):
    """(bytes, flop) of one backward launch: the forward's inputs and the
    [N, H+8] cotangent read once, the two [N, H+8] sums and the weight
    gradients written once; per active edge six H x H products (12 H^2)
    plus ~30 H of elementwise work."""
    nw = 2 * H * H + 7 * H
    nbytes = (E * (3 * 4 + 8 * 4) + N * (3 * 4 + 2 * H * elt) + nw * 4
              + N * (H + 8) * 4 + 2 * N * (H + 8) * 4 + nw * 4)
    return nbytes, active * (12 * H * H + 30 * H)


def compare(label, dname, names, out, ref):
    """Hold each kernel output against its plain version: finite, the same
    shape, and max / mean abs error within TOL_MAX (TOL_TRANS for
    ``trans_sum``) / TOL_MEAN of the output's max |plain|. Returns the
    largest max abs error."""
    import torch

    errs = []
    for name, a, b in zip(names, out, ref):
        check(a.shape == b.shape, f"{label} {dname} {name} shape {a.shape} "
              f"!= {b.shape}")
        check(torch.isfinite(a).all(), f"{label} {dname} {name} not finite")
        d = (a.float() - b.float()).abs()
        scale = float(b.abs().max())
        mx, mean = float(d.max()), float(d.mean())
        tmax = TOL_TRANS[dname] if name == "trans_sum" else TOL_MAX[dname]
        print(f"{label} vs plain {dname} {name}: max_abs_err={mx:.3e} "
              f"mean_abs_err={mean:.3e} scale={scale:.4e} "
              f"tol_max={tmax * scale:.3e} "
              f"tol_mean={TOL_MEAN[dname] * scale:.3e}")
        check(scale > 0 and mx <= tmax * scale
              and mean <= TOL_MEAN[dname] * scale,
              f"{label} disagrees with its plain version ({dname} {name})")
        errs.append(mx)
    return max(errs)


FWD_NAMES = ("trans_sum", "count", "ef_sum")
BWD_NAMES = ("d_x", "d_hr", "d_hc", "dws", "db1", "dw2", "db2", "dw3", "db3",
             "dw4")


def bwd_outputs(out):
    """The backward's (d_x, d_hr, d_hc, EdgeWeights) as ten tensors."""
    return list(out[:3]) + list(out[3])


def edge_weights(p):
    """EdgeWeights of a layer's FusedEdgeParams, detached."""
    from distegnn_tpu_torch.ops import edge_pipeline as ep

    H = p.w2.shape[0]
    return ep.EdgeWeights(ws=p.w1[2 * H:].detach(), b1=p.b1[None].detach(),
                          w2=p.w2.detach(), b2=p.b2[None].detach(),
                          w3=p.w3.detach(), b3=p.b3[None].detach(),
                          w4=p.w4.T.detach())


def kernel_inputs(batch):
    """The kernels' edge layout of graph 0 of a blocked batch on the card,
    and its (N, E slots, active edges)."""
    from distegnn_tpu_torch.ops import edge_pipeline as ep

    arrs = [a[0].contiguous() for a in ep.build_edge_blocks(
        batch.row, batch.col, batch.edge_attr, batch.edge_mask,
        block=batch.edge_block, n_nodes=batch.max_nodes)]
    return arrs, batch.max_nodes, arrs[3].shape[0], int((arrs[3][:, 2] > 0)
                                                         .sum())


def edge_kernel_phase(model, dev):
    """Phase 2 + the kernel's timings of phase 4."""
    import torch

    from distegnn_tpu_torch.ops import edge_pipeline as ep
    from distegnn_tpu_torch.ops.graph import pad_graphs

    g = scene(KERNEL_N, seed=11)
    batch = pad_graphs([g], edge_block=BLOCK, split_remote=True).to(dev)
    arrs, N, E, active = kernel_inputs(batch)
    n_real_edges = g["edge_index"].shape[1]
    print(f"kernel shape: N={N} E_slots={E} real_edges={n_real_edges} "
          f"in_window={active} ({active / n_real_edges:.4f}) "
          f"mean_degree={n_real_edges / KERNEL_N:.2f}")

    p = model.gcl[0].phi_e_fused
    H = HIDDEN
    gen = torch.Generator(device=dev).manual_seed(5)
    h = torch.randn((N, H), generator=gen, device=dev)
    x = batch.loc[0].contiguous()
    w = edge_weights(p)
    res = {}
    with torch.no_grad():
        for dname in ("f32", "bf16"):
            dt = torch.float32 if dname == "f32" else torch.bfloat16
            hr = (h.to(dt) @ p.w1[:H].to(dt)).contiguous()
            hc = (h.to(dt) @ p.w1[H:2 * H].to(dt)).contiguous()
            args = (x, hr, hc, *arrs, w, BLOCK, dname)
            out = ep.fused_edge_layer(*args)
            torch.cuda.synchronize()
            err = compare("kernel", dname, FWD_NAMES, out,
                          ep.fused_edge_layer_ref(*args))
            ms = cuda_ms(lambda: ep.fused_edge_layer(*args))
            plain_ms = cuda_ms(lambda: ep.fused_edge_layer_ref(*args), reps=5)
            nbytes, flops = fwd_work(N, E, active, H, hr.element_size())
            b_ms, b_by = bound(nbytes, flops, dname)
            res[dname] = dict(ms=ms, plain_ms=plain_ms, err=err,
                              bound_ms=b_ms, bound_by=b_by)
            print(f"kernel time {dname}: {ms:.4f} ms/launch, plain "
                  f"{plain_ms:.4f} ms, bound {res[dname]['bound_ms']:.4f} ms "
                  f"({res[dname]['bound_by']}: {nbytes} B, {flops} flop), "
                  f"{res[dname]['bound_ms'] / ms:.3f} of bound")
    return res


def edge_bwd_kernel_phase(model, dev):
    """Phase 2b: the backward kernel against fused_edge_layer_bwd_ref at
    phase 2's shape, with random cotangents, in f32 and bf16, and its
    timings."""
    import torch

    from distegnn_tpu_torch.ops import edge_pipeline as ep
    from distegnn_tpu_torch.ops.graph import pad_graphs

    g = scene(KERNEL_N, seed=11)
    batch = pad_graphs([g], edge_block=BLOCK, split_remote=True).to(dev)
    arrs, N, E, active = kernel_inputs(batch)
    p = model.gcl[0].phi_e_fused
    H = HIDDEN
    gen = torch.Generator(device=dev).manual_seed(6)
    h = torch.randn((N, H), generator=gen, device=dev)
    g_trans = torch.randn((N, 3), generator=gen, device=dev)
    g_ef = torch.randn((N, H), generator=gen, device=dev)
    x = batch.loc[0].contiguous()
    w = edge_weights(p)
    res = {}
    with torch.no_grad():
        for dname in ("f32", "bf16"):
            dt = torch.float32 if dname == "f32" else torch.bfloat16
            hr = (h.to(dt) @ p.w1[:H].to(dt)).contiguous()
            hc = (h.to(dt) @ p.w1[H:2 * H].to(dt)).contiguous()
            args = (x, hr, hc, *arrs, w, g_trans, g_ef, BLOCK, dname)
            out = ep._fused_edge_bwd_cuda(*args)
            torch.cuda.synchronize()
            err = compare("bwd kernel", dname, BWD_NAMES, bwd_outputs(out),
                          bwd_outputs(ep.fused_edge_layer_bwd_ref(*args)))
            ms = cuda_ms(lambda: ep._fused_edge_bwd_cuda(*args))
            plain_ms = cuda_ms(lambda: ep.fused_edge_layer_bwd_ref(*args),
                               reps=5)
            nbytes, flops = bwd_work(N, E, active, H, hr.element_size())
            b_ms, b_by = bound(nbytes, flops, dname)
            res[dname] = dict(ms=ms, plain_ms=plain_ms, err=err,
                              bound_ms=b_ms, bound_by=b_by)
            print(f"bwd kernel time {dname}: {ms:.4f} ms/launch, plain "
                  f"{plain_ms:.4f} ms, bound {res[dname]['bound_ms']:.4f} ms "
                  f"({res[dname]['bound_by']}: {nbytes} B, {flops} flop), "
                  f"{res[dname]['bound_ms'] / ms:.3f} of bound")
    return res


def serve_phase(cfg, model, eng, dev):
    """Phase 3 + per-request timings of phase 4."""
    import numpy as np
    import torch

    from distegnn_tpu_torch.models import fast_egnn
    from distegnn_tpu_torch.ops import edge_pipeline as ep

    scenes = [scene(n, seed=100 + i) for i, n in enumerate(SCENES)]
    for n, g in zip(SCENES, scenes):
        e = g["edge_index"].shape[1]
        sel = ep.remote_selection(g["edge_index"], block=BLOCK,
                                  n_nodes=-(-n // BLOCK) * BLOCK)
        print(f"scene n={n} edges={e} mean_degree={e / n:.2f} "
              f"in_window_share={1 - sel.shape[0] / e:.4f}")
    eng.warmup([(g["loc"].shape[0], g["edge_index"].shape[1])
                for g in scenes])
    torch.cuda.synchronize()

    # the main path: counts 0 just before, read just after
    ep.fused_edge_layer.launches = 0
    t0 = time.perf_counter()
    outs = [eng.predict(g) for g in scenes]
    first_ms = (time.perf_counter() - t0) * 1e3 / len(scenes)
    launches = ep.fused_edge_layer.launches
    want = cfg.model.n_layers * eng.max_batch * len(scenes)
    print(f"served {len(scenes)} requests: fused_edge_fwd launches="
          f"{launches} (expected {cfg.model.n_layers} layers x "
          f"{eng.max_batch} graphs x {len(scenes)} requests = {want})")
    check(launches == want, f"launch count {launches} != {want}")
    for g, o in zip(scenes, outs):
        check(o.shape == (g["loc"].shape[0], 3), f"bad output {o.shape}")
        check(np.isfinite(o).all(), "non-finite served output")

    # equivariance on the 3000-node request
    rng = np.random.default_rng(7)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    R = (q * np.sign(np.diag(r))).astype(np.float32)
    t = rng.normal(size=(3,)).astype(np.float32)
    g = scenes[1]
    gr = dict(g, loc=(g["loc"] @ R.T + t).astype(np.float32),
              vel=(g["vel"] @ R.T).astype(np.float32))
    err = float(np.abs(eng.predict(gr) - (outs[1] @ R.T + t)).max())
    print(f"equivariance (rotation + translation): max_abs_err={err:.3e} "
          f"tol={TOL_EQUIV:.1e}")
    check(err <= TOL_EQUIV, "equivariance violated")

    # the same model through the plain version, on the card
    with mock.patch.object(fast_egnn, "fused_edge_layer",
                           ep.fused_edge_layer_ref):
        plain = [eng.predict(g) for g in scenes]
    perr = max(float(np.abs(a - b).max()) for a, b in zip(outs, plain))
    print(f"served vs plain-version model: max_abs_err={perr:.3e} "
          f"tol={TOL_PLAIN:.1e}")
    check(perr <= TOL_PLAIN, "served output disagrees with the plain path")

    for n, g in zip(SCENES, scenes):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng.predict(g)
            ts.append((time.perf_counter() - t0) * 1e3)
        print(f"predict ms n={n}: median={sorted(ts)[2]:.3f} "
              f"min={min(ts):.3f} max={max(ts):.3f}")
    print(f"predict ms, first pass mean over the {len(scenes)} requests: "
          f"{first_ms:.3f}")
    return launches, scenes


def fluid_cloud(seed):
    """A synthetic fluid cloud at Fluid113K scale (the recipe of bench.py's
    make_fluid_cloud): N=113140 nodes uniform in a cube sized for ~15
    radius-0.075 neighbours each, Morton-ordered, 3 node features
    [|v|, v_x, v_y], 2 node attributes, edge_attr = [d, d]."""
    import numpy as np

    from distegnn_tpu_torch.ops.order import morton_perm
    from distegnn_tpu_torch.ops.radius import radius_graph_np

    rng = np.random.default_rng(seed)
    vol = FLUID_N * (4.0 / 3.0) * np.pi * FLUID_RADIUS ** 3 / FLUID_DEGREE
    side = max(vol ** (1.0 / 3.0), 2.0 * FLUID_RADIUS)
    loc = rng.uniform(0, side, size=(FLUID_N, 3)).astype(np.float32)
    vel = rng.normal(size=(FLUID_N, 3)).astype(np.float32) * 0.01
    p = morton_perm(loc)
    loc, vel = loc[p], vel[p]
    ei = radius_graph_np(loc, FLUID_RADIUS)
    d = np.linalg.norm(loc[ei[0]] - loc[ei[1]], axis=1)
    return {
        "node_feat": np.concatenate([np.linalg.norm(vel, axis=1,
                                                    keepdims=True),
                                     vel[:, :2]], axis=1).astype(np.float32),
        "node_attr": np.ones((FLUID_N, 2), np.float32),
        "loc": loc, "vel": vel, "target": loc + vel * 0.05,
        "loc_mean": loc.mean(axis=0),
        "edge_index": ei.astype(np.int32),
        "edge_attr": np.repeat(d[:, None], 2, axis=1).astype(np.float32)}


def first_update(cfg, init_sd, batches, dev, plain=False, time_extra=0,
                 profile=False):
    """One optimizer update (accumulation_steps micro-steps) of the train
    step from ``init_sd`` over ``batches`` (on the card), with the per-step
    generators of epoch 1. Returns a dict: the micro-steps' losses with and
    without MMD, the accumulated gradient as one vector (as the optimizer
    sees it, by parameter name), the kernel launches the update made, and the micro-step ms of
    ``time_extra`` more timed micro-steps. ``plain=True`` runs the plain
    versions of the kernels."""
    import torch

    from distegnn_tpu_torch.models.registry import get_model
    from distegnn_tpu_torch.ops import edge_pipeline as ep
    from distegnn_tpu_torch.train.step import (TrainState, make_optimizer,
                                               make_train_step,
                                               needs_grad_clip,
                                               step_generator)

    model = get_model(cfg.model)
    model.load_state_dict(init_sd)
    model.to(dev)
    pname = {id(p): n for n, p in model.named_parameters()}
    t = cfg.train
    opt = make_optimizer(model.parameters(), t.learning_rate,
                         weight_decay=t.weight_decay,
                         clip_norm=0.3 if needs_grad_clip(cfg) else None,
                         accumulation_steps=t.accumulation_steps)
    grads = []
    adam_step = opt.adam.step

    def capture_then_step(*a, **kw):
        if not grads:
            grads.append({pname[id(p)]: p.grad.detach().clone()
                          for p in opt.params if p.grad is not None})
        return adam_step(*a, **kw)

    opt.adam.step = capture_then_step
    state = TrainState(model, opt)
    step = make_train_step(model, opt, t.mmd.weight, t.mmd.sigma,
                           t.mmd.samples)
    patches = ((mock.patch.object(ep, "_fused_edge_layer_cuda",
                                  ep.fused_edge_layer_ref),
                mock.patch.object(ep, "_fused_edge_bwd_cuda",
                                  ep.fused_edge_layer_bwd_ref))
               if plain else ())
    counts = (ep.fused_edge_layer.launches, ep.fused_edge_layer.bwd_launches)
    with contextlib.ExitStack() as stack:
        for pt in patches:
            stack.enter_context(pt)
        out = {"loss_with_mmd": [], "loss": []}
        for i in range(t.accumulation_steps):
            b = batches[i % len(batches)]
            state, m = step(state, b, step_generator(cfg.seed, 1, i, dev))
            for k in out:
                out[k].append(float(m[k]))
        out["grad"] = grads[0]
        out["launches"] = (ep.fused_edge_layer.launches - counts[0],
                           ep.fused_edge_layer.bwd_launches - counts[1])
        ms = []
        for i in range(time_extra):
            b = batches[i % len(batches)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b, step_generator(cfg.seed, 2, i, dev))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["ms"] = ms
        if profile:
            profile_step(lambda: step(state, batches[0],
                                      step_generator(cfg.seed, 3, 0, dev)))
    return out


def flagship_kernel_phase(model, batch, dev):
    """Both kernels at the train batch's shape, in the model's compute
    dtype, with layer 0's weights, random node features and cotangents:
    each held against its plain version (all 3 forward and 10 backward
    outputs), then timed (CUDA events) beside its plain version and the
    bound of that shape. Returns {kernel name: result}."""
    import torch

    from distegnn_tpu_torch.ops import edge_pipeline as ep

    arrs, N, E, active = kernel_inputs(batch)
    layer = model.gcl[0]
    H = layer.hidden_nf
    dt = layer.dt or torch.float32
    dname = "bf16" if dt is torch.bfloat16 else "f32"
    p = layer.phi_e_fused
    gen = torch.Generator(device=dev).manual_seed(7)
    h = torch.randn((N, H), generator=gen, device=dev)
    g_trans = torch.randn((N, 3), generator=gen, device=dev)
    g_ef = torch.randn((N, H), generator=gen, device=dev)
    x = batch.loc[0].contiguous()
    w = edge_weights(p)
    res = {}
    print(f"flagship kernel shape: N={N} E_slots={E} in_window={active} "
          f"H={H} {dname}")
    with torch.no_grad():
        hr = (h.to(dt) @ p.w1[:H].to(dt)).contiguous()
        hc = (h.to(dt) @ p.w1[H:2 * H].to(dt)).contiguous()
        fargs = (x, hr, hc, *arrs, w, batch.edge_block, dname)
        bargs = (x, hr, hc, *arrs, w, g_trans, g_ef, batch.edge_block, dname)
        for name, kern, plain, args, flat, names, work in (
                ("fused_edge_fwd", ep._fused_edge_layer_cuda,
                 ep.fused_edge_layer_ref, fargs, list, FWD_NAMES, fwd_work),
                ("fused_edge_bwd", ep._fused_edge_bwd_cuda,
                 ep.fused_edge_layer_bwd_ref, bargs, bwd_outputs, BWD_NAMES,
                 bwd_work)):
            out = flat(kern(*args))
            torch.cuda.synchronize()
            err = compare(f"flagship {name}", dname, names, out,
                          flat(plain(*args)))
            del out
            ms = cuda_ms(lambda: kern(*args), reps=10)
            plain_ms = cuda_ms(lambda: plain(*args), reps=3, warm=1)
            nbytes, flops = work(N, E, active, H, hr.element_size())
            b_ms, b_by = bound(nbytes, flops, dname)
            f32_ms, _ = bound(nbytes, flops, "f32")
            res[name] = dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=b_ms,
                             bound_by=b_by, dtype=dname,
                             shape=f"N={N} E_slots={E} in_window={active} "
                                   f"H={H}")
            print(f"flagship {name} {dname}: {ms:.4f} ms/launch, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} "
                  f"B, {flops} flop), {b_ms / ms:.4f} of bound; f32 FMA bound "
                  f"{f32_ms:.4f} ms, {f32_ms / ms:.3f} of it")
    return res


def profile_step(fn):
    """``--profile``: torch.profiler over one train micro-step: device time
    by kernel and the device's idle share of the step's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"profile train micro-step: wall {wall_ms:.3f} ms, device kernel "
          f"time {busy:.3f} ms, busy share {busy / wall_ms:.4f}, idle share "
          f"{1 - busy / wall_ms:.4f}, {sum(r[2] for r in rows)} device ops")
    for key, ms, n in rows[:15]:
        print(f"profile train kernel: {ms:.3f} ms  x{n}  {key[:90]}")


def train_phase(root, dev, profile=False):
    """Phase 5: a few training steps of the flagship model on Fluid113K-scale
    clouds through distegnn_tpu_torch.main.run, with exact launch counts,
    then the first optimizer update again with the kernels and with their
    plain versions. The run's logs and checkpoints go to a temporary
    directory that is removed afterwards."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as log_dir:
        return _train_phase(root, dev, log_dir, profile)


def _train_phase(root, dev, log_dir, profile):
    import numpy as np
    import torch

    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.data.loader import GraphDataset
    from distegnn_tpu_torch.main import make_loaders, run
    from distegnn_tpu_torch.models.registry import get_model
    from distegnn_tpu_torch.ops import edge_pipeline as ep

    cfg = load_config(
        os.path.join(root, "configs", "largefluid_distegnn.yaml"),
        {"model.edge_impl": "fused", "data.edge_block": BLOCK,
         "data.accelerate_mode": "cutoff_edges",
         "train.epochs": TRAIN_EPOCHS, "log.test_interval": TRAIN_EPOCHS,
         "log.log_dir": log_dir})
    m = cfg.model
    print(f"train config: H={m.hidden_nf} L={m.n_layers} "
          f"C={m.virtual_channels} node_feat_nf={m.node_feat_nf} "
          f"node_attr_nf={m.node_attr_nf} compute_dtype={m.compute_dtype} "
          f"remat={m.remat} batch={cfg.data.batch_size} "
          f"accumulation_steps={cfg.train.accumulation_steps} "
          f"epochs={cfg.train.epochs} test_interval={cfg.log.test_interval}")
    t0 = time.perf_counter()
    clouds = [fluid_cloud(300 + i) for i in range(6)]
    order = cfg.data.node_order
    ds = [GraphDataset(clouds[:4], node_order=order),
          GraphDataset(clouds[4:5], node_order=order),
          GraphDataset(clouds[5:], node_order=order)]
    e = [c["edge_index"].shape[1] for c in clouds]
    print(f"clouds: 6 x N={FLUID_N}, edges {min(e)}..{max(e)} (mean degree "
          f"{np.mean(e) / FLUID_N:.2f}), built in "
          f"{time.perf_counter() - t0:.1f} s")

    init_sd = get_model(cfg.model, generator=torch.Generator().manual_seed(
        int(cfg.seed))).state_dict()
    marks = []

    def on_step(epoch, step, metrics):
        torch.cuda.synchronize()
        marks.append((epoch, step, time.perf_counter(),
                      float(metrics["loss_with_mmd"])))

    # the main path: counts 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    ep.fused_edge_layer.launches = 0
    ep.fused_edge_layer.bwd_launches = 0
    t0 = time.perf_counter()
    state, best, log = run(cfg, *ds, device=dev, on_step=on_step)
    wall = time.perf_counter() - t0
    fwd, bwd = ep.fused_edge_layer.launches, ep.fused_edge_layer.bwd_launches
    peak = torch.cuda.max_memory_allocated()
    L = m.n_layers
    micro = TRAIN_EPOCHS * len(ds[0]) // cfg.data.batch_size
    evals = (TRAIN_EPOCHS // cfg.log.test_interval) * (len(ds[1]) + len(ds[2]))
    want_fwd, want_bwd = L * micro * 2 + L * evals, L * micro
    print(f"trained {micro} micro-steps ({state.optimizer.updates} optimizer "
          f"updates) + {evals} eval forwards in {wall:.1f} s: fused_edge_fwd "
          f"launches={fwd} (expected {L} layers x {micro} micro-steps x 2 "
          f"(remat) + {L} x {evals} = {want_fwd}), fused_edge_bwd launches="
          f"{bwd} (expected {L} x {micro} = {want_bwd})")
    check(fwd == want_fwd, f"fwd launch count {fwd} != {want_fwd}")
    check(bwd == want_bwd, f"bwd launch count {bwd} != {want_bwd}")
    losses = [mk[3] for mk in marks]
    print("train losses (with MMD): " + " ".join(f"{v:.6g}" for v in losses))
    check(len(losses) == micro and all(math.isfinite(v) for v in losses),
          "non-finite or missing train loss")
    check(all(math.isfinite(v) for v in log["loss_train"] + log["loss"]),
          "non-finite epoch loss")
    moved = max(float((p.detach().cpu() - init_sd[k]).abs().max())
                for k, p in state.model.state_dict().items())
    print(f"log.json losses: train {log['loss_train']} test {log['loss']}; "
          f"max |param change| {moved:.3e}; peak device memory "
          f"{peak / 2**30:.3f} GiB")
    check(moved > 0, "the parameters did not change")
    gaps = [(b[2] - a[2]) * 1e3 for a, b in zip(marks, marks[1:])
            if a[0] == b[0]]
    print("micro-step ms in the trainer (host clock, loader included): "
          + " ".join(f"{v:.1f}" for v in gaps))

    # where the trainer's host time goes: the loader (blockify on its
    # first pass, cached afterwards) and the copy to the card
    loader = make_loaders(cfg, *ds)[0]
    loader.set_epoch(1)
    t0 = time.perf_counter()
    host = list(loader)
    t1 = time.perf_counter()
    host = list(loader)
    t2 = time.perf_counter()
    batches = [b.to(dev) for b in host]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    nb = len(host)
    print(f"loader ms per batch (host): first pass {(t1 - t0) * 1e3 / nb:.1f} "
          f"(blockify + collate), cached {(t2 - t1) * 1e3 / nb:.1f}; copy to "
          f"the card {(t3 - t2) * 1e3 / nb:.1f} ms per batch")

    flagship = flagship_kernel_phase(state.model, batches[0], dev)

    # the first optimizer update again: the kernels, then the plain versions
    n_real = float(batches[0].node_mask.sum())
    k = first_update(cfg, init_sd, batches, dev, time_extra=TRAIN_TIMED,
                     profile=profile)
    p = first_update(cfg, init_sd, batches, dev, plain=True)
    n_micro = cfg.train.accumulation_steps
    check(k["launches"] == (2 * L * n_micro, L * n_micro)
          and p["launches"] == (0, 0),
          f"first update launches: kernels {k['launches']}, plain "
          f"{p['launches']}")
    errs = {}
    for name in ("loss_with_mmd", "loss"):
        errs[name] = max(abs(a - b) / abs(b) for a, b in zip(k[name], p[name]))
        print(f"first update, kernels vs plain, {name}: {k[name]} vs "
              f"{p[name]} (max rel err {errs[name]:.3e}, tol {TOL_TRAIN:.0e})")
    check(k["grad"].keys() == p["grad"].keys(),
          "kernels and plain versions gave gradients of different parameters")
    gk = torch.cat([g.reshape(-1) for g in k["grad"].values()])
    gp = torch.cat([p["grad"][n].reshape(-1) for n in k["grad"]])
    norm_k, norm_p = float(gk.norm()), float(gp.norm())
    errs["grad norm"] = abs(norm_k - norm_p) / norm_p
    errs["grad"] = float((gk - gp).abs().max()) / float(gp.abs().max())
    print(f"first update, kernels vs plain, accumulated gradient ({gk.numel()} "
          f"entries): norm {norm_k:.6g} vs {norm_p:.6g} (rel err "
          f"{errs['grad norm']:.3e}), max abs err / max abs "
          f"{errs['grad']:.3e} (tol {TOL_TRAIN:.0e} each); launches: kernels "
          f"{k['launches']}, plain {p['launches']}")
    check(all(v <= TOL_TRAIN for v in errs.values()),
          "the train step with the kernels disagrees with the plain versions")
    perr = {}
    for n, a in k["grad"].items():
        b = p["grad"][n]
        scale, d = float(b.abs().max()), float((a - b).abs().max())
        perr[n] = d / scale if scale > 0 else (0.0 if d == 0 else math.inf)
    worst = sorted(perr.items(), key=lambda kv: -kv[1])
    fused = [kv for kv in worst if ".phi_e_fused." in kv[0]]
    print(f"first update, kernels vs plain, per-parameter gradient max abs "
          f"err / its max abs plain ({len(perr)} tensors, tol "
          f"{TOL_PARAM:.3e}), worst 6: " + ", ".join(
              f"{n} {v:.3e}" for n, v in worst[:6]) + "; worst 4 of the "
          "kernels' own weights: " + ", ".join(
              f"{n} {v:.3e}" for n, v in fused[:4]))
    check(worst[0][1] <= TOL_PARAM,
          f"the gradient of {worst[0][0]} with the kernels disagrees with the "
          f"plain versions ({worst[0][1]:.3e} of its max)")
    ms = k["ms"]
    med = sorted(ms)[len(ms) // 2]
    print(f"train micro-step ms (synchronised, step only, {len(ms)} after "
          f"the first update): median {med:.3f} min {min(ms):.3f} max "
          f"{max(ms):.3f}; {n_real / (med / 1e3):.0f} nodes/s")
    return fwd, bwd, flagship


def profile_phase(eng, g, reps=5):
    """``--profile``: where one request's time goes, for the largest scene.
    Host clock around each stage (each ended by a synchronise), then
    torch.profiler over ``reps`` requests: device time by kernel and the
    device's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bucket = eng.ladder.bucket_of_graph(g)
    stages = {"pad_batch": [], "to_device": [], "forward": [], "readback": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        batch, _ = eng.ladder.pad_batch([g], bucket, eng.max_batch,
                                        **eng._layout_opts)
        t1 = time.perf_counter()
        b = batch.to(eng.device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.no_grad():
            x = eng.model(b)[0]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        x.cpu()
        t4 = time.perf_counter()
        for k, a, z in (("pad_batch", t0, t1), ("to_device", t1, t2),
                        ("forward", t2, t3), ("readback", t3, t4)):
            stages[k].append((z - a) * 1e3)
    print("profile n={} stage ms (median of {}): {}".format(
        g["loc"].shape[0], reps, json.dumps(
            {k: sorted(v)[reps // 2] for k, v in stages.items()})))

    # the host padding, by function (cumulative ms of one pad_batch)
    import cProfile
    import pstats

    pr = cProfile.Profile()
    pr.runcall(eng.ladder.pad_batch, [g], bucket, eng.max_batch,
               **eng._layout_opts)
    st = pstats.Stats(pr)
    funcs = sorted(st.stats.items(), key=lambda kv: -kv[1][3])
    for (fname, line, func), (_, ncalls, _, cum, _) in funcs[:10]:
        print(f"profile host: {cum * 1e3:.3f} ms cumulative x{ncalls} "
              f"{os.path.basename(fname)}:{line} {func}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.predict(g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, memcpy, memset): the CPU-side aten
    # ops also carry their kernels' time and would count it twice
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"profile: wall {wall_ms:.3f} ms over {reps} requests, device "
          f"kernel time {busy:.3f} ms, busy share {busy / wall_ms:.4f}, "
          f"idle share {1 - busy / wall_ms:.4f}, "
          f"{sum(r[2] for r in rows)} device ops")
    for key, ms, n in rows[:12]:
        print(f"profile kernel: {ms:.3f} ms  x{n}  {key[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    try:
        import distegnn_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout: {exc}",
              file=sys.stderr)
        return 3
    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.ops.build import build_all
    from distegnn_tpu_torch.serve import engine_with_params_from_config

    smi = nvidia_smi()
    print(f"card: {smi}")
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    reports = build_all(["fused_edge_fwd", "fused_edge_bwd"])
    print(f"built {len(reports)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}")

    dev = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "configs", "nbody_serve.yaml"),
                      {"model.edge_impl": "fused", "data.edge_block": BLOCK})
    model, eng = engine_with_params_from_config(cfg)
    profile = "--profile" in sys.argv[1:]
    kres = edge_kernel_phase(model, dev)
    edge_bwd_kernel_phase(model, dev)
    launches, scenes = serve_phase(cfg, model, eng, dev)
    if profile:
        profile_phase(eng, scenes[-1])
    del model, eng
    train_fwd, train_bwd, flagship = train_phase(root, dev, profile=profile)
    print(f"main-path launches: fused_edge_fwd {launches} (serve) + "
          f"{train_fwd} (train), fused_edge_bwd {train_bwd} (train)")

    # one row per kernel and path, with the numbers of the dtype and shape
    # that path launches the kernel at: serving f32 at phase 2's shape,
    # training bf16 at the train batch's
    def row(name, path, k, replaces, n):
        return {"name": name, "route": "cuda",
                "source": f"distegnn_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": n, "max_abs_err": k["err"],
                "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": None, "path": path}

    fwd_tpu = "distegnn_tpu/ops/edge_pipeline.py:288"
    kernels = [
        row("fused_edge_fwd", "serve f32 N=8192", kres["f32"], fwd_tpu,
            launches),
        row("fused_edge_fwd", f"train {flagship['fused_edge_fwd']['dtype']} "
            f"{flagship['fused_edge_fwd']['shape']}",
            flagship["fused_edge_fwd"], fwd_tpu, train_fwd),
        row("fused_edge_bwd", f"train {flagship['fused_edge_bwd']['dtype']} "
            f"{flagship['fused_edge_bwd']['shape']}",
            flagship["fused_edge_bwd"],
            "distegnn_tpu/ops/edge_pipeline.py:314", train_bwd)]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
