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
     degree ~20), in f32 and bf16: bf16 at H=64 runs the tensor-core
     kernel (fused_edge_layer.tc_launches counts it), f32 the f32 FMA
     kernel (fused_edge_layer.f32_launches counts it).
  2b. the same for the backward kernel, with random cotangents: all ten
     outputs (d_x, d_hr, d_hc and the seven weight gradients).
  2d. the fused-stack megakernel (csrc/fused_stack_fwd.cu) against its
     plain version at H=64, C=3, L=4, A=2 on the JAX package's megakernel
     workload (4 node blocks of 512 + a trailing empty block, ~10 %
     far-block edges), as a batch of one graph and as one launch for a
     batch of four distinct graphs of different real sizes: every graph's
     four outputs and four checkpoints, f32 and bf16, gravity on and off,
     timed beside its bound (summed over the batch's graphs) and its plain
     version; the launch's grid, blocks per SM and shared memory printed.
  2c. the prefix-scan kernel (csrc/prefix_scan.cu) in both directions, f32
     and bf16 input, against f64 and against its plain version, at the
     plain train path's shapes ([E, 68], [E, 64], [E, 3] with E the padded
     edge count of a 113140-node cloud), the plain serve path's [4, E, 68]
     and edge cases (E under one tile, ragged E, F = 1, a batch of 4);
     prefix_sum's autograd backward against the suffix kernel; each path
     shape timed beside its plain version, its bound and torch.cumsum.
  3. serve: ``engine_with_params_from_config`` on configs/nbody_serve.yaml
     with model.edge_impl=fused and data.edge_block=512 (H=64, L=4, C=3,
     max_batch 4, random weights from the config's seed); answer four
     Morton-ordered scenes of ~1500/3000/6000/10000 nodes with every launch
     count set to 0 just before and read just after; check finiteness, the
     exact launch count (every one on the f32 FMA kernel, none on the
     tensor-core forward), equivariance under a random rotation + translation,
     and agreement with the same model run through the plain version.
  3b. serve configs/nbody_serve.yaml as published (edge_impl plain,
     segment_impl scatter: no kernel), then with model.segment_impl=cumsum
     (one scan launch per layer and request, the batch axis in the launch):
     exact launch counts, equivariance, and the cumsum model held against
     the scatter model, with the kernel and with its plain version.
  3c. serve configs/nbody_serve.yaml + model.edge_impl=fused_stack,
     data.edge_block=512: scenes of ~500 and ~1000 nodes (rung 1536), the
     counts set to 0 just before and read just after: exactly one stack
     launch per request (its 4 padded graphs in the launch) and no
     fused_edge_fwd launch; equivariance; agreement with the same weights
     under edge_impl=fused and through the plain stack; a 1500-node scene
     (rung 2048) raises StackVmemBudgetError before any launch; the kernel
     held against its plain version on a batch of four distinct scenes at
     the served rung, then held and timed on the largest request's padded
     batch (B=4).
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
     3 forward and 10 backward outputs) and timed there (the forward on
     the tensor-core kernel, as every bf16 forward of the run); then the
     first optimizer update again with the kernels and with their plain
     versions (losses, gradient norm, and each parameter's gradient must agree),
     micro-step ms, nodes/s and peak device memory.
  6. train the plain path: the same run with only
     data.accelerate_mode=cutoff_edges and model.segment_impl=cumsum on the
     published config (edge_block 0: the plain row-sorted layout with the
     reverse-edge pairing), the scan's launch counts by width set to 0 just
     before and checked exactly just after; finite losses, parameters moved;
     the first optimizer update again with the kernel, with its plain
     version and with segment_impl=scatter, the kernel's and the plain
     version's distance from the exact scatter lowering compared;
     micro-step ms, nodes/s and peak device memory.

  2e. the blocked one-hot kernels (csrc/blocked_onehot.cu: the slots' CSR
     plan, the segment sum through it and the row gather of the blocked
     layout): the plan equal to its plain version, the segment sum equal
     to the edge-order sum through the plan bit for bit and within 1e-6
     of f64 and of its plain version, bitwise repeatable, the gather
     bitwise, at edge cases (an all-sentinel block, epb == tile, F = 1, a
     batch of 4, bf16, F = 128), at the rollout batch's shape ([4, 4096]
     nodes, 48 x 256 slots per block; F = 1, 3, 64) and, with phase 8, at
     the train batch's (113152 nodes in 442 blocks of 256; F = 1, 3, 64,
     f32 and bf16); each path shape timed beside its plain version,
     index_add_ / index_select (the plan: a stable argsort), the einsum
     lowering and its bound. Rows of at most 16 bytes take the gather's
     and the segment sum's one-thread-per-row forms.
  3d. rollout serving: configs/nbody_serve.yaml + serve.rollout (radius of
     mean degree ~20, max_degree 48, max_per_cell 32, edge_block 256) +
     model.blocked_impl=pallas; engine.rollout of a 4000-node scene and
     engine.rollout_batch of 4 scenes of 1000-4000 nodes (rung 4096), K=8
     steps, with the counts set to 0 just before and checked exactly just
     after each (per step 1 plan, 2L seg_sum and 2L gather launches);
     finite, no overflow, first-step equivariance, the trajectory against
     the plain versions and against blocked_impl=einsum; ms per request and
     step.
  7. train configs/fluid_fused_stack.yaml as published (H=64, L=4, C=3, bf16,
     edge_block 512, MSE + MMD, Adam with 4-step accumulation) through
     main.run over 4 train + 1 valid + 1 test synthetic fluid clouds of
     1536 nodes at phase 5's density, 2 epochs; exact launches (per
     micro-step 1 stack + L fused_edge_fwd + L fused_edge_bwd, 1 stack per
     eval forward; every fused_edge_fwd on the tensor-core kernel); finite
     losses, parameters moved; the three kernels at
     the train batch's shape; the first optimizer update again through the
     plain stack and with edge_impl=fused, at phase 5's bounds; micro-step
     ms, nodes/s and peak device memory.
  8. train configs/largefluid_distegnn.yaml + data.edge_block=256,
     data.accelerate_mode=cutoff_edges, model.blocked_impl=pallas (the
     blocked layout with the pairing, no remote tail) over phase 5's clouds,
     2 epochs, with exact launch counts by width (one plan per forward, the
     remat reruns and the backward roles of both kernels derived from the
     code); finite losses,
     parameters moved; the first optimizer update again with the plain
     versions, with blocked_impl=einsum and with edge_block=0 (scatter), at
     phase 5's aggregate bounds and phase 6's per-tensor bound; micro-step ms,
     nodes/s and peak device memory.

With ``--profile`` it then breaks one request of the largest scene into host
stages and profiles it with torch.profiler (device time by kernel, the
device's idle share), and profiles one train micro-step of each train path
and one batched rollout the same way (with the segment sum's and the plan's
device time where they run).

Every kernel's ``ms`` is its time launched eagerly, as a user's path
launches it (CUDA events around back-to-back launches; the small kernels,
the one-hot kernels and their library calls, as the median of 5 batches of
200 launches). Where an eager call of a few microseconds measures the host
rather than the card, ``graph_ms`` (and ``library_graph_ms``) is the same
work replayed from a CUDA graph: the card's time.

Output: timing lines, then one JSON line ``{"kernels": [...]}``, the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
"""

import collections
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

# every phase runs here (a CPU rehearsal of the phases points it elsewhere)
DEVICE = "cuda"
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
# phase 2c: the scan against f64, as a fraction of each column's max
# |prefix| (the scan of |x|), which the f32 rounding of a running total is
# relative to; the plain version is held to the same bound
TOL_SCAN = 1e-5
SCAN_CASES = ((1, 100, 5), (1, 4097, 1), (2, 9001, 3), (4, 12345, 68))
# phases 3b and 6: a cumsum segment sum is the difference of two f32
# prefixes, rounded at ~|prefix| * eps, so the kernel and its plain version
# are two roundings of one cancellation; each is held against the exact
# scatter lowering instead, and the kernel's distance from it may be at most
# SCATTER_FACTOR times the plain version's, plus SCATTER_FLOOR (of the
# metric's own scale: coordinates O(1), relative errors). In training the
# rule holds the aggregate distances (losses, gradient norm, the gradient's
# relative L2 distance): once the bf16 model rounds, a one-ulp flip moves
# single gradient entries, and the max-entry distances of the kernel and of
# the plain version from scatter were 2x apart on an H100 (1.7e-4, 8.4e-5
# of the max; the scatter lowering's backward itself sums in bf16). Those
# are held to bounds of their own: TOL_TRAIN for the gradient's max abs
# error over its max, and SCATTER_PARAM for each tensor's against its own
# max (the virtual-coordinate heads phi_X, whose gradients cancel over all
# nodes, measured 0.10-0.13 for both).
SCATTER_FACTOR = 2.0
SCATTER_FLOOR = 1e-6
SCATTER_PARAM = 2 ** -2


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


def cuda_ms_batches(fn, launches=200, batches=5, warm=3, graph=True):
    """Per-launch ms of a small kernel: the median over ``batches`` batches
    of ``launches`` back-to-back launches, each batch timed with CUDA
    events (at 10-25 us a launch, a few dozen launches cannot resolve a 2x
    difference between two such kernels). With ``graph`` the launches are
    captured once in a CUDA graph and each batch replays it, so the time is
    the device's: launched eagerly, a call of a few microseconds on the card
    measures the host's Python and dispatch time instead (``graph=False``
    gives that time)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(launches):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(launches):
                fn()
    per = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / launches)
    return sorted(per)[len(per) // 2]


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


def compare(label, dname, names, out, ref, verbose=True):
    """Hold each kernel output against its plain version: finite, the same
    shape, and max / mean abs error within TOL_MAX (TOL_TRANS for
    ``trans_sum``) / TOL_MEAN of the output's max |plain|. Returns the
    largest max abs error; ``verbose`` prints each output's line, else one
    line with each output's max abs error over its max |plain|."""
    import torch

    errs, rel = [], []
    for name, a, b in zip(names, out, ref):
        check(a.shape == b.shape, f"{label} {dname} {name} shape {a.shape} "
              f"!= {b.shape}")
        check(torch.isfinite(a).all(), f"{label} {dname} {name} not finite")
        d = (a.float() - b.float()).abs()
        scale = float(b.abs().max())
        mx, mean = float(d.max()), float(d.mean())
        tmax = TOL_TRANS[dname] if name == "trans_sum" else TOL_MAX[dname]
        if verbose:
            print(f"{label} vs plain {dname} {name}: max_abs_err={mx:.3e} "
                  f"mean_abs_err={mean:.3e} scale={scale:.4e} "
                  f"tol_max={tmax * scale:.3e} "
                  f"tol_mean={TOL_MEAN[dname] * scale:.3e}")
        rel.append(f"{name} {mx / max(scale, 1e-30):.2e}")
        check(scale > 0 and mx <= tmax * scale
              and mean <= TOL_MEAN[dname] * scale,
              f"{label} disagrees with its plain version ({dname} {name})")
        errs.append(mx)
    if not verbose:
        print(f"{label} vs plain {dname}, max abs error / max |plain| (tol "
              f"{TOL_MAX[dname]:.2e}): " + ", ".join(rel))
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
            before = fwd_counts()
            f32_before = ep.fused_edge_layer.f32_launches
            out = ep.fused_edge_layer(*args)
            torch.cuda.synchronize()
            # bf16 at H=64 runs the tensor-core kernel, f32 the f32 FMA
            # kernel
            want = (before[0] + 1, before[1] + (dname == "bf16"))
            f32 = ep.fused_edge_layer.f32_launches - f32_before
            check(fwd_counts() == want and f32 == (dname == "f32"),
                  f"kernel {dname}: (launches, tc_launches) "
                  f"{fwd_counts()} != {want} or f32_launches +{f32}")
            err = compare("kernel", dname, FWD_NAMES, out,
                          ep.fused_edge_layer_ref(*args))
            ms = cuda_ms(lambda: ep.fused_edge_layer(*args))
            # the card's time: 20 launches replayed from a CUDA graph (at
            # ~0.1 ms an eager call measures part host time)
            graph_ms = cuda_ms_batches(lambda: ep.fused_edge_layer(*args),
                                       launches=20, batches=3)
            plain_ms = cuda_ms(lambda: ep.fused_edge_layer_ref(*args), reps=5)
            nbytes, flops = fwd_work(N, E, active, H, hr.element_size())
            b_ms, b_by = bound(nbytes, flops, dname)
            res[dname] = dict(ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                              err=err, bound_ms=b_ms, bound_by=b_by)
            print(f"kernel time {dname}: {ms:.4f} ms/launch eagerly, "
                  f"{graph_ms:.4f} as CUDA-graph replays, plain "
                  f"{plain_ms:.4f} ms, bound {res[dname]['bound_ms']:.4f} ms "
                  f"({res[dname]['bound_by']}: {nbytes} B, {flops} flop), "
                  f"{res[dname]['bound_ms'] / graph_ms:.3f} of bound "
                  f"(replays)")
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
            before = fwd_counts()
            out = ep._fused_edge_bwd_cuda(*args)
            torch.cuda.synchronize()
            # the backward recomputes the forward inside its own kernel
            check(fwd_counts() == before,
                  f"bwd kernel {dname}: a forward launch was counted")
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


def serve_scenes():
    return [scene(n, seed=100 + i) for i, n in enumerate(SCENES)]


def serve_phase(cfg, model, eng, dev, scenes):
    """Phase 3 + per-request timings of phase 4."""
    import numpy as np
    import torch

    from distegnn_tpu_torch.models import fast_egnn
    from distegnn_tpu_torch.ops import edge_pipeline as ep

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
    ep.fused_edge_layer.tc_launches = 0
    ep.fused_edge_layer.f32_launches = 0
    t0 = time.perf_counter()
    outs = [eng.predict(g) for g in scenes]
    first_ms = (time.perf_counter() - t0) * 1e3 / len(scenes)
    launches, tc = fwd_counts()
    f32 = ep.fused_edge_layer.f32_launches
    want = cfg.model.n_layers * eng.max_batch * len(scenes)
    print(f"served {len(scenes)} requests: fused_edge_fwd launches="
          f"{launches} (expected {cfg.model.n_layers} layers x "
          f"{eng.max_batch} graphs x {len(scenes)} requests = {want}), "
          f"{f32} of them on the f32 kernel (expected all), {tc} on the "
          f"tensor-core kernel (expected 0)")
    check(launches == want, f"launch count {launches} != {want}")
    check(tc == 0, f"f32 serving launched the tensor-core forward {tc} times")
    check(f32 == launches, f"{launches - f32} f32 forward launches did not "
          f"run fused_edge_fwd_f32_kernel")
    for g, o in zip(scenes, outs):
        check(o.shape == (g["loc"].shape[0], 3), f"bad output {o.shape}")
        check(np.isfinite(o).all(), "non-finite served output")

    check_equivariance("", eng, scenes[1], outs[1])

    # the same model through the plain version, on the card
    with mock.patch.object(fast_egnn, "fused_edge_layer",
                           ep.fused_edge_layer_ref):
        plain = [eng.predict(g) for g in scenes]
    perr = max(float(np.abs(a - b).max()) for a, b in zip(outs, plain))
    print(f"served vs plain-version model: max_abs_err={perr:.3e} "
          f"tol={TOL_PLAIN:.1e}")
    check(perr <= TOL_PLAIN, "served output disagrees with the plain path")

    predict_times("", eng, scenes)
    print(f"predict ms, first pass mean over the {len(scenes)} requests: "
          f"{first_ms:.3f}")
    return launches


def check_equivariance(label, eng, g, out):
    """The served answer for ``g`` rotated and translated (a random proper
    rotation and offset) against ``out`` moved the same way."""
    import numpy as np

    rng = np.random.default_rng(7)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    R = (q * np.sign(np.diag(r))).astype(np.float32)
    t = rng.normal(size=(3,)).astype(np.float32)
    gr = dict(g, loc=(g["loc"] @ R.T + t).astype(np.float32),
              vel=(g["vel"] @ R.T).astype(np.float32))
    err = float(np.abs(eng.predict(gr) - (out @ R.T + t)).max())
    print(f"{label}equivariance (rotation + translation, n="
          f"{g['loc'].shape[0]}): max_abs_err={err:.3e} tol={TOL_EQUIV:.1e}")
    check(err <= TOL_EQUIV, f"{label}equivariance violated")


def predict_times(label, eng, scenes, reps=5):
    """Host-clock predict ms per scene, median of ``reps``."""
    meds = []
    for g in scenes:
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            eng.predict(g)
            ts.append((time.perf_counter() - t0) * 1e3)
        ts.sort()
        meds.append(ts[reps // 2])
        print(f"{label}predict ms n={g['loc'].shape[0]}: median="
              f"{ts[reps // 2]:.3f} min={ts[0]:.3f} max={ts[-1]:.3f}")
    return meds


def fluid_cloud(seed, n=FLUID_N):
    """A synthetic fluid cloud at Fluid113K density (the recipe of bench.py's
    make_fluid_cloud): ``n`` nodes uniform in a cube sized for ~15
    radius-0.075 neighbours each, Morton-ordered, 3 node features
    [|v|, v_x, v_y], 2 node attributes, edge_attr = [d, d]."""
    import numpy as np

    from distegnn_tpu_torch.ops.order import morton_perm
    from distegnn_tpu_torch.ops.radius import radius_graph_np

    rng = np.random.default_rng(seed)
    vol = n * (4.0 / 3.0) * np.pi * FLUID_RADIUS ** 3 / FLUID_DEGREE
    side = max(vol ** (1.0 / 3.0), 2.0 * FLUID_RADIUS)
    loc = rng.uniform(0, side, size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 0.01
    p = morton_perm(loc)
    loc, vel = loc[p], vel[p]
    ei = radius_graph_np(loc, FLUID_RADIUS)
    d = np.linalg.norm(loc[ei[0]] - loc[ei[1]], axis=1)
    return {
        "node_feat": np.concatenate([np.linalg.norm(vel, axis=1,
                                                    keepdims=True),
                                     vel[:, :2]], axis=1).astype(np.float32),
        "node_attr": np.ones((n, 2), np.float32),
        "loc": loc, "vel": vel, "target": loc + vel * 0.05,
        "loc_mean": loc.mean(axis=0),
        "edge_index": ei.astype(np.int32),
        "edge_attr": np.repeat(d[:, None], 2, axis=1).astype(np.float32)}


def fused_counts():
    from distegnn_tpu_torch.ops import edge_pipeline as ep

    return ep.fused_edge_layer.launches, ep.fused_edge_layer.bwd_launches


def fwd_counts():
    """The forward's launches and those of them on the tensor-core kernel."""
    from distegnn_tpu_torch.ops import edge_pipeline as ep

    return ep.fused_edge_layer.launches, ep.fused_edge_layer.tc_launches


def fused_plain_patches():
    """The fused kernels' wrappers pointed at their plain versions."""
    from distegnn_tpu_torch.ops import edge_pipeline as ep

    return (mock.patch.object(ep, "_fused_edge_layer_cuda",
                              ep.fused_edge_layer_ref),
            mock.patch.object(ep, "_fused_edge_bwd_cuda",
                              ep.fused_edge_layer_bwd_ref))


def scan_counts():
    from distegnn_tpu_torch.ops import cumsum as CS

    return CS.prefix_sum.launches, CS.prefix_sum.suffix_launches


def reset_scan_counts():
    from distegnn_tpu_torch.ops import cumsum as CS

    CS.prefix_sum.launches = 0
    CS.prefix_sum.suffix_launches = 0
    CS.prefix_sum.launch_widths.clear()


def scan_plain_patches():
    """The scan wrapper's kernel call pointed at its plain version."""
    from distegnn_tpu_torch.ops import cumsum as CS

    return (mock.patch.object(CS, "_scan_cuda", CS.prefix_sum_ref),)


def first_update(cfg, init_sd, batches, dev, patches=(), counts=fused_counts,
                 time_extra=0, profile=False):
    """One optimizer update (accumulation_steps micro-steps) of the train
    step from ``init_sd`` over ``batches`` (on the card), with the per-step
    generators of epoch 1. Returns a dict: the micro-steps' losses with and
    without MMD, the accumulated gradient as one vector (as the optimizer
    sees it, by parameter name), the change of ``counts()`` (kernel
    launches) over the update, and the micro-step ms of ``time_extra`` more
    timed micro-steps. ``patches`` (e.g. :func:`fused_plain_patches`) are
    entered around it all."""
    import torch

    from distegnn_tpu_torch.models.registry import get_model
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
            # a parameter no loss term reaches has no gradient in one
            # lowering and a zero one in another: both count as zero
            grads.append({pname[id(p)]: p.grad.detach().clone()
                          if p.grad is not None else torch.zeros_like(p)
                          for p in opt.params})
        return adam_step(*a, **kw)

    opt.adam.step = capture_then_step
    state = TrainState(model, opt)
    step = make_train_step(model, opt, t.mmd.weight, t.mmd.sigma,
                           t.mmd.samples)
    before = counts()
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
        out["launches"] = tuple(a - b for a, b in zip(counts(), before))
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


def update_distance(a, b):
    """How far the first update ``a`` lies from ``b`` (two results of
    :func:`first_update`): the micro-step losses' (with and without MMD)
    max relative error; the accumulated gradient's norm relative error, max
    abs error over its max abs entry, and the norm of the difference over
    the norm ("grad l2"); and each parameter tensor's max abs error over
    its own max |b|. Returns (the five global numbers, the per-tensor
    numbers)."""
    import torch

    errs = {}
    for name in ("loss_with_mmd", "loss"):
        errs[name] = max(abs(x - y) / abs(y) for x, y in zip(a[name], b[name]))
    check(a["grad"].keys() == b["grad"].keys(),
          "two updates gave gradients of different parameters")
    ga = torch.cat([g.reshape(-1) for g in a["grad"].values()])
    gb = torch.cat([b["grad"][n].reshape(-1) for n in a["grad"]])
    errs["grad norm"] = abs(float(ga.norm()) - float(gb.norm())) / float(
        gb.norm())
    errs["grad"] = float((ga - gb).abs().max()) / float(gb.abs().max())
    errs["grad l2"] = float((ga - gb).norm()) / float(gb.norm())
    per = {}
    for n, x in a["grad"].items():
        y = b["grad"][n]
        scale, d = float(y.abs().max()), float((x - y).abs().max())
        per[n] = d / scale if scale > 0 else (0.0 if d == 0 else math.inf)
    return errs, per


def flagship_kernel_phase(model, batch, dev):
    """Both kernels at the train batch's shape, in the model's compute
    dtype, with layer 0's weights, random node features and cotangents:
    each held against its plain version (all 3 forward and 10 backward
    outputs), then timed (CUDA events) beside its plain version and the
    bound of that shape. Returns {kernel name: result}; the forward's
    ``kernel`` names the kernel that runs it (``fused_edge_fwd_tc`` on the
    tensor cores, or ``fused_edge_fwd``)."""
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
            # the card's time: 20 launches replayed from a CUDA graph (at
            # the stack's small batch an eager call is mostly host time)
            graph_ms = cuda_ms_batches(lambda: kern(*args), launches=20,
                                       batches=3)
            plain_ms = cuda_ms(lambda: plain(*args), reps=3, warm=1)
            nbytes, flops = work(N, E, active, H, hr.element_size())
            b_ms, b_by = bound(nbytes, flops, dname)
            f32_ms, _ = bound(nbytes, flops, "f32")
            res[name] = dict(ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                             err=err, bound_ms=b_ms, bound_by=b_by,
                             dtype=dname,
                             shape=f"N={N} E_slots={E} in_window={active} "
                                   f"H={H}")
            print(f"flagship {name} {dname}: {ms:.4f} ms/launch eagerly "
                  f"({graph_ms:.4f} as CUDA-graph replays), plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} "
                  f"B, {flops} flop), {b_ms / ms:.4f} of bound; f32 FMA bound "
                  f"{f32_ms:.4f} ms, {f32_ms / ms:.3f} of it")
    res["fused_edge_fwd"]["kernel"] = (
        "fused_edge_fwd_tc" if ep.fwd_uses_tensor_cores(H, dname)
        else "fused_edge_fwd")
    return res


def print_blocked_device_time(label, rows):
    """``--profile``: the one-hot segment sum's device time in a profiled
    run, ``blocked_seg_sum`` and ``blocked_plan`` (the plan kernel), each
    with its launches and together."""
    seg = [(ms, n) for key, ms, n in rows if "seg_sum" in key]
    plan = [(ms, n) for key, ms, n in rows if "plan_kernel" in key]
    if not seg and not plan:
        return
    s_ms, s_n = sum(r[0] for r in seg), sum(r[1] for r in seg)
    p_ms, p_n = sum(r[0] for r in plan), sum(r[1] for r in plan)
    print(f"profile {label}: blocked_seg_sum {s_ms:.3f} ms x{s_n}, "
          f"blocked_plan {p_ms:.3f} ms x{p_n}, together {s_ms + p_ms:.3f} ms")


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
    print_blocked_device_time("train micro-step", rows)


def train_phase(root, dev, clouds, profile=False):
    """Phase 5: a few training steps of the flagship model on Fluid113K-scale
    clouds through distegnn_tpu_torch.main.run, with exact launch counts,
    then the first optimizer update again with the kernels and with their
    plain versions. The run's logs and checkpoints go to a temporary
    directory that is removed afterwards."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as log_dir:
        return _train_phase(root, dev, clouds, log_dir, profile)


def fluid_datasets(clouds, order):
    """4 train, 1 valid, 1 test cloud."""
    from distegnn_tpu_torch.data.loader import GraphDataset

    return [GraphDataset(clouds[:4], node_order=order),
            GraphDataset(clouds[4:5], node_order=order),
            GraphDataset(clouds[5:], node_order=order)]


def drive_train(cfg, ds, dev, reset_counts, read_counts, label):
    """The main path of a train phase: ``distegnn_tpu_torch.main.run`` from
    the config's seeded initial weights, with ``reset_counts()`` just before
    and ``read_counts()`` just after. Checks finite losses and that the
    parameters moved; prints the losses, the peak device memory and the
    micro-step times in the trainer's loop. Returns (initial state_dict,
    counts, micro-steps, eval forwards)."""
    import torch

    from distegnn_tpu_torch.main import run
    from distegnn_tpu_torch.models.registry import get_model

    init_sd = get_model(cfg.model, generator=torch.Generator().manual_seed(
        int(cfg.seed))).state_dict()
    marks = []

    def on_step(epoch, step, metrics):
        torch.cuda.synchronize()
        marks.append((epoch, step, time.perf_counter(),
                      float(metrics["loss_with_mmd"])))

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, _, log = run(cfg, *ds, device=dev, on_step=on_step)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    micro = TRAIN_EPOCHS * len(ds[0]) // cfg.data.batch_size
    evals = (TRAIN_EPOCHS // cfg.log.test_interval) * (len(ds[1]) + len(ds[2]))
    print(f"{label}trained {micro} micro-steps ({state.optimizer.updates} "
          f"optimizer updates) + {evals} eval forwards in {wall:.1f} s")
    losses = [mk[3] for mk in marks]
    print(f"{label}train losses (with MMD): "
          + " ".join(f"{v:.6g}" for v in losses))
    check(len(losses) == micro and all(math.isfinite(v) for v in losses),
          f"{label}non-finite or missing train loss")
    check(all(math.isfinite(v) for v in log["loss_train"] + log["loss"]),
          f"{label}non-finite epoch loss")
    moved = max(float((p.detach().cpu() - init_sd[k]).abs().max())
                for k, p in state.model.state_dict().items())
    print(f"{label}log.json losses: train {log['loss_train']} test "
          f"{log['loss']}; max |param change| {moved:.3e}; peak device "
          f"memory {peak / 2**30:.3f} GiB")
    check(moved > 0, f"{label}the parameters did not change")
    gaps = [(b[2] - a[2]) * 1e3 for a, b in zip(marks, marks[1:])
            if a[0] == b[0]]
    print(f"{label}micro-step ms in the trainer (host clock, loader "
          "included): " + " ".join(f"{v:.1f}" for v in gaps))
    return init_sd, state, counts, micro, evals


def host_batches(cfg, ds, dev, label):
    """The train loader's epoch-1 batches on the card, with where the
    trainer's host time goes: the loader's first and second pass (layout
    work cached on the first) and the copy to the card."""
    import torch

    from distegnn_tpu_torch.main import make_loaders

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
    print(f"{label}loader ms per batch (host): first pass "
          f"{(t1 - t0) * 1e3 / nb:.1f}, second {(t2 - t1) * 1e3 / nb:.1f}; "
          f"copy to the card {(t3 - t2) * 1e3 / nb:.1f} ms per batch")
    return loader, batches


def step_times(label, k, n_real):
    """Median micro-step ms of a first_update's timed steps, and nodes/s."""
    ms = sorted(k["ms"])
    med = ms[len(ms) // 2]
    print(f"{label}train micro-step ms (synchronised, step only, {len(ms)} "
          f"after the first update): median {med:.3f} min {ms[0]:.3f} max "
          f"{ms[-1]:.3f}; {n_real / (med / 1e3):.0f} nodes/s")
    return med


def _train_phase(root, dev, clouds, log_dir, profile):
    from distegnn_tpu_torch.config import load_config
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
    ds = fluid_datasets(clouds, cfg.data.node_order)

    def reset():
        ep.fused_edge_layer.launches = 0
        ep.fused_edge_layer.tc_launches = 0
        ep.fused_edge_layer.bwd_launches = 0

    # the main path: counts 0 just before, read just after
    init_sd, state, (fwd, bwd, tc), micro, evals = drive_train(
        cfg, ds, dev, reset,
        lambda: fused_counts() + (ep.fused_edge_layer.tc_launches,), "")
    L = m.n_layers
    want_fwd, want_bwd = L * micro * 2 + L * evals, L * micro
    print(f"fused_edge_fwd launches={fwd} (expected {L} layers x {micro} "
          f"micro-steps x 2 (remat) + {L} x {evals} = {want_fwd}), {tc} of "
          f"them on the tensor-core kernel (expected all: bf16 at H="
          f"{m.hidden_nf}), fused_edge_bwd launches={bwd} (expected {L} x "
          f"{micro} = {want_bwd})")
    check(fwd == want_fwd, f"fwd launch count {fwd} != {want_fwd}")
    check(tc == fwd, f"tensor-core fwd launches {tc} != {fwd}")
    check(bwd == want_bwd, f"bwd launch count {bwd} != {want_bwd}")

    _, batches = host_batches(cfg, ds, dev, "")
    flagship = flagship_kernel_phase(state.model, batches[0], dev)

    # the first optimizer update again: the kernels, then the plain versions
    n_real = float(batches[0].node_mask.sum())
    k = first_update(cfg, init_sd, batches, dev, time_extra=TRAIN_TIMED,
                     profile=profile)
    p = first_update(cfg, init_sd, batches, dev,
                     patches=fused_plain_patches())
    n_micro = cfg.train.accumulation_steps
    check(k["launches"] == (2 * L * n_micro, L * n_micro)
          and p["launches"] == (0, 0),
          f"first update launches: kernels {k['launches']}, plain "
          f"{p['launches']}")
    errs, perr = update_distance(k, p)
    for name in ("loss_with_mmd", "loss"):
        print(f"first update, kernels vs plain, {name}: {k[name]} vs "
              f"{p[name]} (max rel err {errs[name]:.3e}, tol {TOL_TRAIN:.0e})")
    print(f"first update, kernels vs plain, accumulated gradient: norm rel "
          f"err {errs['grad norm']:.3e}, max abs err / max abs "
          f"{errs['grad']:.3e} (tol {TOL_TRAIN:.0e} each); launches: kernels "
          f"{k['launches']}, plain {p['launches']}")
    check(all(errs[key] <= TOL_TRAIN
              for key in ("loss_with_mmd", "loss", "grad norm", "grad")),
          "the train step with the kernels disagrees with the plain versions")
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
    step_times("", k, n_real)
    return fwd, bwd, flagship


def scan_ref64(x, reverse):
    """The exact scan of ``x`` [B, E, F] along E, in f64, and its scale:
    each column's max of the scan of |x| (shaped [B, 1, F]). Both are taken
    along the innermost axis of a transposed copy: torch's scan along an
    outer axis of a tall array runs one thread per column."""
    xd = x.double().transpose(1, 2).contiguous()
    if reverse:
        xd = xd.flip(-1)
    ref, scale = xd.cumsum(-1), xd.abs().cumsum(-1).amax(-1, keepdim=True)
    if reverse:
        ref = ref.flip(-1)
    return ref.transpose(1, 2), scale.transpose(1, 2).clamp(min=1e-30)


def scan_phase(dev, e_train, e_serve):
    """Phase 2c: the prefix-scan kernel in both directions, f32 and bf16
    input, against f64 and its plain version at the paths' shapes and the
    edge cases; prefix_sum's backward against the suffix kernel; then each
    path shape timed (kernel, plain version, torch.cumsum) beside its bound.
    Returns {row: result} for the ``kernels`` line."""
    import torch

    from distegnn_tpu_torch.ops import cumsum as CS

    f32, bf16 = torch.float32, torch.bfloat16
    # row -> (B, E, F, input type, reverse): the shapes the paths launch
    rows = {"serve f32": (4, e_serve, 68, f32, False),
            "train fwd f32": (1, e_train, 68, f32, False),
            "train bwd bf16": (1, e_train, 64, bf16, False),
            "train bwd f32": (1, e_train, 3, f32, False),
            "suffix f32": (1, e_train, 68, f32, True)}
    shapes = list(dict.fromkeys([r[:3] for r in rows.values()]
                                + list(SCAN_CASES)))
    gen = torch.Generator(device=dev).manual_seed(9)
    worst = 0.0
    for B, E, F in shapes:
        for dt in (f32, bf16):
            x = torch.randn((B, E, F), generator=gen, device=dev).to(dt)
            for rev in (False, True):
                out = CS._scan_cuda(x, rev)
                torch.cuda.synchronize()
                check(out.dtype == f32 and out.shape == x.shape
                      and bool(torch.isfinite(out).all()),
                      f"scan [{B}, {E}, {F}] {dt} reverse={rev}: bad output")
                ref, scale = scan_ref64(x, rev)
                plain = CS.prefix_sum_ref(x, rev)
                err = float(((out.double() - ref).abs() / scale).max())
                perr = float(((plain.double() - ref).abs() / scale).max())
                kperr = float(((out.double() - plain.double()).abs()
                               / scale).max())
                print(f"scan [{B}, {E}, {F}] {str(dt)[6:]} "
                      f"{'suffix' if rev else 'prefix'}: error over max "
                      f"|prefix| vs f64: kernel {err:.3e}, plain {perr:.3e}; "
                      f"kernel vs plain {kperr:.3e} (tol {TOL_SCAN:.0e})")
                check(max(err, perr, kperr) <= TOL_SCAN,
                      f"scan [{B}, {E}, {F}] {dt} reverse={rev} disagrees")
                worst = max(worst, err)
                del out, ref, scale, plain
    # a positive stream (the edge features' columns): |prefix| grows with
    # every row, so the f32 rounding of the running totals shows; the
    # kernel may stray from f64 at most SCATTER_FACTOR x the TPU algorithm
    B, E, F, _, _ = rows["train fwd f32"]
    x = torch.randn((B, E, F), generator=gen, device=dev).abs()
    ref, scale = scan_ref64(x, False)
    err = float(((CS._scan_cuda(x, False).double() - ref).abs()
                 / scale).max())
    perr = float(((CS.prefix_sum_ref(x).double() - ref).abs() / scale).max())
    print(f"scan [{B}, {E}, {F}] positive f32 prefix: error over max "
          f"|prefix| vs f64: kernel {err:.3e}, plain {perr:.3e} (kernel <= "
          f"{SCATTER_FACTOR} x plain + 1e-9)")
    check(err <= SCATTER_FACTOR * perr + 1e-9,
          "the scan kernel rounds further from f64 than the TPU algorithm")
    del x, ref, scale
    # prefix_sum's autograd backward is the suffix kernel, bit for bit
    x = torch.randn((E, F), generator=gen, device=dev).requires_grad_()
    w = torch.randn((E, F), generator=gen, device=dev)
    before = scan_counts()
    (g,) = torch.autograd.grad((CS.prefix_sum(x) * w).sum(), x)
    torch.cuda.synchronize()
    after = scan_counts()
    check(after == (before[0] + 1, before[1] + 1) and torch.equal(
        g, CS._scan_cuda(w, True)),
        "prefix_sum's backward is not the suffix kernel")
    print(f"scan: prefix_sum backward == suffix kernel at [{E}, {F}] "
          f"(bitwise); worst kernel error over max |prefix| {worst:.3e}")
    del x, w, g

    res = {}
    for name, (B, E, F, dt, rev) in rows.items():
        x = torch.randn((B, E, F), generator=gen, device=dev).to(dt)
        out = CS._scan_cuda(x, rev)
        plain = CS.prefix_sum_ref(x, rev)
        err = float((out - plain).abs().max())
        del out, plain
        ms = cuda_ms(lambda: CS._scan_cuda(x, rev))
        plain_ms = cuda_ms(lambda: CS.prefix_sum_ref(x, rev), reps=3, warm=1)
        # one PyTorch call computes the prefix direction; none the suffix
        lib_ms = (None if rev else cuda_ms(
            lambda: torch.cumsum(x, 1, dtype=f32), reps=2, warm=1))
        # [B, E, F] read once, written once as f32; one add per element
        nbytes = B * E * F * (x.element_size() + 4)
        b_ms, b_by = bound(nbytes, B * E * F, "f32")
        res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         err=err, bound_ms=b_ms, bound_by=b_by,
                         shape=f"[{B}, {E}, {F}]")
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"scan time {name} [{B}, {E}, {F}]: {ms:.4f} ms/launch, plain "
              f"{plain_ms:.4f} ms, torch.cumsum {lib} ms, bound {b_ms:.4f} "
              f"ms ({b_by}: {nbytes} B), {b_ms / ms:.3f} of bound; max abs "
              f"err vs plain {err:.3e}")
        del x
    return res


def plain_serve_phase(root, dev, scenes):
    """Phase 3b: configs/nbody_serve.yaml as published (scatter, no kernel)
    and with segment_impl=cumsum, each main path with the scan's counts set
    to 0 just before and read just after; equivariance; the cumsum model
    with the kernel and with its plain version, each against the scatter
    model. Returns (scan launches, {impl: predict ms medians})."""
    import numpy as np
    import torch

    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.ops import cumsum as CS
    from distegnn_tpu_torch.serve import engine_with_params_from_config

    path = os.path.join(root, "configs", "nbody_serve.yaml")
    outs, times, engines, weights = {}, {}, {}, {}
    launches = 0
    for impl in ("scatter", "cumsum"):
        cfg = load_config(path, {"model.segment_impl": "cumsum"}
                          if impl == "cumsum" else None)
        m = cfg.model
        model, eng = engine_with_params_from_config(cfg)
        weights[impl] = model.state_dict()
        print(f"serve plain {impl}: edge_impl={m.edge_impl} segment_impl="
              f"{m.segment_impl} H={m.hidden_nf} L={m.n_layers} "
              f"C={m.virtual_channels} max_batch={eng.max_batch}")
        eng.warmup([(g["loc"].shape[0], g["edge_index"].shape[1])
                    for g in scenes])
        torch.cuda.synchronize()
        # the main path: counts 0 just before, read just after
        reset_scan_counts()
        o = [eng.predict(g) for g in scenes]
        n, n_suffix = scan_counts()
        widths = dict(CS.prefix_sum.launch_widths)
        want = m.n_layers * len(scenes) if impl == "cumsum" else 0
        print(f"serve plain {impl}: {len(scenes)} requests, prefix_scan "
              f"launches={n} by width {widths}, suffix {n_suffix} (expected "
              f"{want}: {m.n_layers} layers x 1 packed [{eng.max_batch}, E, "
              f"{m.hidden_nf + 4}] aggregation x {len(scenes)} requests)"
              if impl == "cumsum" else
              f"serve plain {impl}: {len(scenes)} requests, prefix_scan "
              f"launches={n}, suffix {n_suffix} (expected 0: index_add_)")
        check(n == want and n_suffix == 0 and widths == (
            {("prefix", "f32", m.hidden_nf + 4): want} if want else {}),
            f"serve plain {impl}: scan launch count {n}/{n_suffix} "
            f"{widths} != {want}")
        for g, a in zip(scenes, o):
            check(a.shape == (g["loc"].shape[0], 3)
                  and bool(np.isfinite(a).all()),
                  f"serve plain {impl}: bad output")
        check_equivariance(f"serve plain {impl} ", eng, scenes[1], o[1])
        times[impl] = predict_times(f"serve plain {impl} ", eng, scenes)
        outs[impl], engines[impl] = o, eng
        if impl == "cumsum":
            launches = n
    check(all(torch.equal(a, weights["cumsum"][k])
              for k, a in weights["scatter"].items()),
          "the scatter and cumsum models drew different weights")
    with contextlib.ExitStack() as stack:
        for pt in scan_plain_patches():
            stack.enter_context(pt)
        plain = [engines["cumsum"].predict(g) for g in scenes]
    err_k = max(float(np.abs(a - b).max())
                for a, b in zip(outs["cumsum"], outs["scatter"]))
    err_p = max(float(np.abs(a - b).max())
                for a, b in zip(plain, outs["scatter"]))
    err_kp = max(float(np.abs(a - b).max())
                 for a, b in zip(outs["cumsum"], plain))
    print(f"serve plain: cumsum vs scatter model, max abs err: kernel "
          f"{err_k:.3e}, plain version {err_p:.3e} (kernel <= "
          f"{SCATTER_FACTOR} x plain + {SCATTER_FLOOR:.0e}, and <= "
          f"{TOL_PLAIN:.0e}); kernel vs plain version {err_kp:.3e}")
    check(err_k <= SCATTER_FACTOR * err_p + SCATTER_FLOOR
          and err_k <= TOL_PLAIN,
          "served cumsum model: the kernel strays from the scatter model")
    return launches, times


def plain_train_phase(root, dev, clouds, e_train, profile=False):
    """Phase 6 in a temporary log directory (see :func:`train_phase`)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_plain_") as log_dir:
        return _plain_train_phase(root, dev, clouds, e_train, log_dir,
                                  profile)


def _plain_train_phase(root, dev, clouds, e_train, log_dir, profile):
    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.ops import cumsum as CS

    path = os.path.join(root, "configs", "largefluid_distegnn.yaml")
    run_len = {"train.epochs": TRAIN_EPOCHS,
               "log.test_interval": TRAIN_EPOCHS, "log.log_dir": log_dir}
    ov = {"data.accelerate_mode": "cutoff_edges",
          "model.segment_impl": "cumsum"}
    cfg = load_config(path, {**ov, **run_len})
    m, d = cfg.model, cfg.data
    print(f"plain train config: edge_impl={m.edge_impl} segment_impl="
          f"{m.segment_impl} edge_block={d.edge_block} "
          f"node_order={d.node_order} H={m.hidden_nf} L={m.n_layers} "
          f"C={m.virtual_channels} compute_dtype={m.compute_dtype} "
          f"remat={m.remat} hoist_edge_mlp={m.hoist_edge_mlp} "
          f"fuse_agg={m.fuse_agg} agg_dtype={m.agg_dtype} "
          f"accumulation_steps={cfg.train.accumulation_steps} "
          f"epochs={cfg.train.epochs}")
    check(m.edge_impl == "plain" and d.edge_block == 0,
          "the published config is no longer the plain layout")
    ds = fluid_datasets(clouds, d.node_order)

    def read():
        return scan_counts() + (dict(CS.prefix_sum.launch_widths),)

    # the main path: counts 0 just before, read just after
    init_sd, state, (n, n_suffix, widths), micro, evals = drive_train(
        cfg, ds, dev, reset_scan_counts, read, "plain ")
    L, H = m.n_layers, m.hidden_nf
    # per micro-step: the packed [E, 3 + H + 1] aggregation of each layer,
    # forward and remat recompute; the backward of the bf16 [E, H] hoisted
    # row and column gathers of each layer; the backward of the f32 [E, 3]
    # coordinate gathers of layers 1..L-1 (layer 0's x is the batch's); and
    # one packed aggregation per layer of every eval forward
    want = {("prefix", "f32", H + 4): 2 * L * micro + L * evals,
            ("prefix", "bf16", H): 2 * L * micro,
            ("prefix", "f32", 3): 2 * (L - 1) * micro}
    print(f"plain prefix_scan launches={n} by width {widths}, suffix "
          f"{n_suffix} (expected {want}, suffix 0: {micro} micro-steps, "
          f"{evals} eval forwards)")
    check(widths == want and n == sum(want.values()) and n_suffix == 0,
          f"plain train: scan launch count {n}/{n_suffix} {widths} != {want}")

    loader, batches = host_batches(cfg, ds, dev, "plain ")
    check(loader.max_edges == e_train and loader.pairing
          and batches[0].edge_pair is not None,
          f"plain train batches: E={loader.max_edges} (phase 2c timed "
          f"{e_train}), pairing {loader.pairing}")
    print(f"plain train batch: N={loader.max_nodes} E={loader.max_edges} "
          f"max_in_degree={loader.max_in_degree}, "
          f"{int(batches[0].edge_mask.sum())} real edges")

    # the first optimizer update again: the kernel, its plain version, and
    # the exact scatter lowering
    n_real = float(batches[0].node_mask.sum())
    n_micro = cfg.train.accumulation_steps
    k = first_update(cfg, init_sd, batches, dev, counts=scan_counts,
                     time_extra=TRAIN_TIMED, profile=profile)
    p = first_update(cfg, init_sd, batches, dev, counts=scan_counts,
                     patches=scan_plain_patches())
    cfg_s = load_config(path, {**ov, **run_len,
                               "model.segment_impl": "scatter"})
    sc = first_update(cfg_s, init_sd, batches, dev, counts=scan_counts,
                      time_extra=TRAIN_TIMED)
    check(k["launches"] == ((4 * L + 2 * (L - 1)) * n_micro, 0)
          and p["launches"] == (0, 0) and sc["launches"] == (0, 0),
          f"first update launches: kernel {k['launches']}, plain "
          f"{p['launches']}, scatter {sc['launches']}")
    ek, pk = update_distance(k, sc)
    ep_, pp = update_distance(p, sc)
    ekp, pkp = update_distance(k, p)
    ek["param"], ep_["param"], ekp["param"] = (
        max(pk.values()), max(pp.values()), max(pkp.values()))
    ratio = ("loss_with_mmd", "loss", "grad norm", "grad l2")
    bounds = {"grad": TOL_TRAIN, "param": SCATTER_PARAM}
    for key in ratio + tuple(bounds):
        rule = (f"kernel <= {SCATTER_FACTOR} x plain + {SCATTER_FLOOR:.0e}"
                if key in ratio else f"both <= {bounds[key]:.3e}")
        kp_tol = SCATTER_PARAM if key == "param" else TOL_TRAIN
        print(f"plain first update vs scatter, {key}: kernel {ek[key]:.3e}, "
              f"plain version {ep_[key]:.3e} ({rule}); kernel vs plain "
              f"version {ekp[key]:.3e} (<= {kp_tol:.3e})")
    worst = sorted(pk.items(), key=lambda kv: -kv[1])
    print("plain first update vs scatter, worst 6 parameters (kernel): "
          + ", ".join(f"{nm} {v:.3e} (plain {pp[nm]:.3e})"
                      for nm, v in worst[:6]))
    bad = [key for key in ratio
           if ek[key] > SCATTER_FACTOR * ep_[key] + SCATTER_FLOOR]
    bad += [key for key, b in bounds.items() if max(ek[key], ep_[key]) > b]
    # the kernel against its plain version directly, at the same bounds
    bad += [f"kernel vs plain {key}" for key in ratio + ("grad",)
            if ekp[key] > TOL_TRAIN]
    bad += ["kernel vs plain param"] if ekp["param"] > SCATTER_PARAM else []
    check(not bad, f"plain train: the cumsum lowering strays from the "
          f"scatter lowering ({bad})")
    med = step_times("plain ", k, n_real)
    med_s = step_times("plain scatter ", sc, n_real)
    return dict(widths=widths, suffix=n_suffix, ms=med, scatter_ms=med_s)


# ------------------------------------------------ the fused-stack megakernel

STACK_TPU = "distegnn_tpu/ops/layer_pipeline.py:425"
STACK_NAMES = ("h", "x", "X", "Hv", "ck_h", "ck_x", "ck_X", "ck_Hv")
# phase 2d's workload at the published width; its residency estimate
# exceeds the 16 MiB default, so it passes an explicit budget. Its batch of
# four adds three distinct graphs of these real sizes to the first
STACK_BUDGET_2D = 64 * 2 ** 20
STACK_SIZES_2D = (3 * BLOCK + 200, 2 * BLOCK + 37, 4 * BLOCK - 100)
# phase 3c: two scenes whose rung pads to 3 blocks (1536 nodes) and one
# whose rung (2048) exceeds the default budget; the kernel is also held on
# a batch of four distinct scenes at the served rung
STACK_SCENES = (500, 1000)
STACK_OVER_BUDGET = 1500
STACK_DISTINCT = (1000, 900, 700, 500)
# phase 7: synthetic fluid clouds at phase 5's density, bench.py's
# 1536-node cap for this lowering
STACK_FLUID_N = 1536
# phase 7 holds the first update's losses, gradient norm and max gradient
# entry at phase 5's TOL_TRAIN; each tensor against its own max at
# SCATTER_PARAM: the phi_X heads' gradients cancel over the cloud's 1536
# nodes, and single bf16-ulp flips of the checkpoints (~1e-3 of h's scale)
# moved them by 2.7e-2 of their own max on an H100 (all else <= 2^-6)
STACK_PARAM = SCATTER_PARAM


def stack_counts():
    from distegnn_tpu_torch.ops import edge_pipeline as ep
    from distegnn_tpu_torch.ops import layer_pipeline as lp

    return (lp.fused_egnn_stack.launches, ep.fused_edge_layer.launches,
            ep.fused_edge_layer.bwd_launches)


def reset_stack_counts():
    from distegnn_tpu_torch.ops import edge_pipeline as ep
    from distegnn_tpu_torch.ops import layer_pipeline as lp

    lp.fused_egnn_stack.launches = 0
    ep.fused_edge_layer.launches = 0
    ep.fused_edge_layer.tc_launches = 0
    ep.fused_edge_layer.bwd_launches = 0


def stack_plain_patches():
    """The stack wrapper's kernel call pointed at its plain version."""
    from distegnn_tpu_torch.ops import layer_pipeline as lp

    return (mock.patch.object(lp, "_fused_egnn_stack_batch_cuda",
                              lp.fused_egnn_stack_batch_ref),)


def stack_work(cfg, ops, n_real):
    """(bytes, flop) of one batched launch, summed over the batch's graphs:
    per graph the bytes of the JAX package's
    hbm_bytes_per_step('fused_stack') model at these shapes; the operations
    of this run's data over L layers (active in-window and remote edges
    through phi_e + phi_x, the hoisted products and the node / virtual MLPs
    of the real nodes, ``n_real`` over the batch)."""
    from distegnn_tpu_torch.ops import layer_pipeline as lp

    H, C, A, L = cfg.hidden, cfg.channels, cfg.node_attr_nf, cfg.n_layers
    B, N = ops[0].shape[:2]
    E, R = ops[8][1].shape[1], ops[9][0].shape[1]
    active = int((ops[8][3][..., 2] > 0).sum()) + int((ops[9][3] > 0).sum())
    nbytes = B * lp.hbm_bytes_per_step(
        "fused_stack", n_nodes=N, n_edges=E, hidden=H, channels=C,
        n_layers=L, remote_pad=R, node_attr_nf=A,
        dtype_name=cfg.dtype_name)["total"]
    heads = 2 if cfg.has_gravity else 1
    macs_node = (2 * H * H                              # hoisted hr, hc
                 + C * ((2 * H + 1 + C) * H + H * H)    # phi_ev
                 + 2 * C * (H * H + H)                  # phi_xv, phi_X
                 + heads * (H * H + H)                  # phi_v (+ phi_g)
                 + (3 * H + A) * H + H * H)             # phi_h
    macs_virtual = C * (2 * H * H + H * H)              # phi_hv
    flops = L * (active * (4 * H * H + 12 * H + 8)
                 + 2 * n_real * macs_node + 2 * B * macs_virtual)
    return nbytes, flops, active


def stack_resident_bytes(cfg, ops):
    """The bytes a batched launch keeps live on the card, from its shapes:
    per graph the checkpoint slots (the state), hr / hc, the aggregates,
    the edge and remote streams, the inputs and the tile partials; the
    stacked weights once. Held against the card's 50 MB L2."""
    from distegnn_tpu_torch.ops import layer_pipeline as lp

    H, C, A, L = cfg.hidden, cfg.channels, cfg.node_attr_nf, cfg.n_layers
    B, N = ops[0].shape[:2]
    E, R = ops[8][1].shape[1], ops[9][0].shape[1]
    elt = 2 if cfg.dtype_name == "bf16" else 4
    ntile = N // 16
    graph = ((L + 1) * (N * (H + 3) + 3 * C + H * C) * 4
             + 2 * N * H * elt + N * (H + 12) * 4
             + E * (3 * 4 + 8 * 4) + R * 20
             + N * (H + 7 + A) * 4 + ntile * (8 + 3 * C + C * H) * 4)
    weights = 4 * L * sum(a * b for a, b in
                          lp.stack_weight_shapes(cfg).values())
    return B * graph + weights


def stack_time(label, cfg, ops, w, n_real, reps=20, timed=True):
    """One batched launch against the plain version on the same card
    tensors (every graph's four outputs and checkpoints), then both timed
    (CUDA events) beside the bound of the batch. Returns the row's
    numbers."""
    import torch

    from distegnn_tpu_torch.ops import layer_pipeline as lp

    dname = cfg.dtype_name
    B = ops[0].shape[0]
    with torch.no_grad():
        out, cks = lp._fused_egnn_stack_batch_cuda(cfg, *ops, w)
        torch.cuda.synchronize()
        info = dict(lp.fused_egnn_stack.last_launch)
        ref, ref_cks = lp.fused_egnn_stack_batch_ref(cfg, *ops, w)
        err = max(compare(f"{label} graph {b}", dname, STACK_NAMES,
                          [t[b] for t in list(out) + list(cks)],
                          [t[b] for t in list(ref) + list(ref_cks)],
                          verbose=B == 1)
                  for b in range(B))
        del out, cks, ref, ref_cks
        if not timed:
            return dict(err=err)
        # the median of 5 batches of `reps` eager launches (one batch
        # varied by up to 20 % between calls on one card)
        ms = cuda_ms_batches(
            lambda: lp._fused_egnn_stack_batch_cuda(cfg, *ops, w),
            launches=reps, batches=5, graph=False)
        plain_ms = cuda_ms(
            lambda: lp.fused_egnn_stack_batch_ref(cfg, *ops, w), reps=3,
            warm=1)
    nbytes, flops, active = stack_work(cfg, ops, n_real)
    b_ms, b_by = bound(nbytes, flops, dname)
    f32_ms, _ = bound(nbytes, flops, "f32")
    N = ops[0].shape[1]
    E, R = ops[8][1].shape[1], ops[9][0].shape[1]
    shape = (f"B={B} N={N} E_slots={E} R={R} active_edges={active} "
             f"H={cfg.hidden} C={cfg.channels} L={cfg.n_layers}")
    print(f"{label} {dname}: {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}: {nbytes} B, {flops} flop), "
          f"{b_ms / ms:.4f} of bound; f32 FMA bound {f32_ms:.4f} ms; grid "
          f"{info['grid']} blocks ({info['blocks_per_sm']} per SM), "
          f"{info['smem_bytes']} B dynamic shared memory; working set "
          f"{stack_resident_bytes(cfg, ops) / 1e6:.2f} MB (L2 50 MB); "
          f"{shape}")
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=b_ms,
                bound_by=b_by, dtype=dname, shape=shape)


def stack_graph(rng, n_real=4 * BLOCK):
    """The JAX package's megakernel workload (tests/test_layer_pipeline.py):
    4 real node blocks, edges near the diagonal with ~10 % into a far block,
    2 node attributes; ``n_real`` nodes (a last block partly filled when it
    is not a multiple of the block)."""
    import numpy as np

    nblk = -(-n_real // BLOCK)
    rows, cols = [], []
    for b in range(nblk):
        r = rng.integers(b * BLOCK, min((b + 1) * BLOCK, n_real), size=384)
        near = rng.integers(max(0, (b - 1) * BLOCK),
                            min(n_real, (b + 2) * BLOCK), size=384)
        far_block = (b + 3) % nblk
        far = rng.integers(far_block * BLOCK,
                           min((far_block + 1) * BLOCK, n_real), size=384)
        rows.append(r)
        cols.append(np.where(rng.uniform(size=384) < 0.1, far, near))
    row, col = np.concatenate(rows), np.concatenate(cols)
    order = np.argsort(row, kind="stable")
    ei = np.stack([row[order], col[order]]).astype(np.int64)
    return {"node_feat": rng.normal(size=(n_real, 2)).astype(np.float32),
            "node_attr": rng.normal(size=(n_real, 2)).astype(np.float32),
            "loc": rng.uniform(0, 1, size=(n_real, 3)).astype(np.float32),
            "vel": (rng.normal(size=(n_real, 3)) * 0.05).astype(np.float32),
            "edge_index": ei,
            "edge_attr": rng.normal(size=(ei.shape[1], 2)).astype(np.float32)}


def stack_model_operands(model, batch):
    """The batched megakernel's operands for a blocked batch on the card,
    exactly as FastEGNN._fused_stack_forward builds them."""
    import torch

    from distegnn_tpu_torch.ops import edge_pipeline as ep

    with torch.no_grad():
        cfg = model.stack_config(batch)
        w = {k: a.detach() for k, a in model.stacked_weights().items()}
        arrs = tuple(a.contiguous() for a in ep.build_edge_blocks(
            batch.row, batch.col, batch.edge_attr, batch.edge_mask,
            block=batch.edge_block, n_nodes=batch.max_nodes))
        B = batch.batch_size
        H, C = model.hidden_nf, model.virtual_channels
        ops = (model.embedding_in(batch.node_feat), batch.loc, batch.vel,
               batch.loc_mean[:, :, None].repeat(1, 1, C),
               model.virtual_node_feat.detach().expand(B, H, C).contiguous(),
               batch.node_mask,
               batch.node_attr if model.node_attr_nf else None,
               model.gravity if model.has_gravity else None, arrs,
               (batch.remote_edge_index[:, 0], batch.remote_edge_index[:, 1],
                batch.remote_edge_attr, batch.remote_edge_mask))
    return cfg, ops, w, float(batch.node_mask.sum())


def stack_kernel_phase(dev):
    """Phase 2d: the megakernel against its plain version at H=64, C=3,
    L=4, A=2 on the JAX package's workload, f32 and bf16, gravity on and
    off, as a batch of one graph and as a batch of four distinct graphs of
    different real sizes (one launch each); timed in each dtype and batch
    (gravity off, the published configs', at the most repetitions)."""
    import numpy as np
    import torch

    from distegnn_tpu_torch.ops import edge_pipeline as ep
    from distegnn_tpu_torch.ops import layer_pipeline as lp
    from distegnn_tpu_torch.ops.graph import pad_graphs

    rng = np.random.default_rng(31)
    g0 = stack_graph(rng)
    rng4 = np.random.default_rng(32)
    graphs = [g0] + [stack_graph(rng4, n) for n in STACK_SIZES_2D]
    H, C, A, L = HIDDEN, 3, 2, 4
    res = {}
    for gravity in (False, True):
        for dname in ("f32", "bf16"):
            cfg = lp.StackConfig(n_layers=L, block=BLOCK, hidden=H,
                                 channels=C, node_attr_nf=A,
                                 has_gravity=gravity, dtype_name=dname,
                                 vmem_budget=STACK_BUDGET_2D)
            w = {}
            for k, (a, b) in lp.stack_weight_shapes(cfg).items():
                s = (1e-3 if k in ("e_w4", "xv_k1", "X_k1") else 1.0) \
                    / math.sqrt(a if a > 1 else b)
                w[k] = torch.from_numpy(rng.uniform(-s, s, size=(L, a, b))
                                        .astype(np.float32)).to(dev)
            h0 = rng.normal(size=(5 * BLOCK, H)).astype(np.float32)
            Hv0 = rng.normal(size=(H, C)).astype(np.float32)
            for B in (1, 4):
                pb = pad_graphs(graphs[:B], max_nodes=5 * BLOCK,
                                edge_block=BLOCK, split_remote=True).to(dev)
                nm = pb.node_mask
                arrs = tuple(a.contiguous() for a in ep.build_edge_blocks(
                    pb.row, pb.col, pb.edge_attr, pb.edge_mask, block=BLOCK,
                    n_nodes=5 * BLOCK))
                hb = np.stack([h0] + [rng4.normal(size=h0.shape).astype(
                    np.float32) for _ in range(B - 1)])
                hvb = np.stack([Hv0] + [rng4.normal(size=Hv0.shape).astype(
                    np.float32) for _ in range(B - 1)])
                ops = (torch.from_numpy(hb).to(dev) * nm[..., None],
                       pb.loc, pb.vel, pb.loc_mean[:, :, None].repeat(1, 1, C),
                       torch.from_numpy(hvb).to(dev), nm, pb.node_attr,
                       torch.tensor([0.0, 0.0, -9.8], device=dev)
                       if gravity else None, arrs,
                       (pb.remote_edge_index[:, 0],
                        pb.remote_edge_index[:, 1], pb.remote_edge_attr,
                        pb.remote_edge_mask))
                est = lp.estimate_stack_vmem_bytes(
                    cfg, n_nodes=5 * BLOCK, n_edges=arrs[1].shape[1],
                    remote_pad=ops[9][0].shape[1])
                label = f"stack kernel (2d) B={B} gravity={gravity}"
                print(f"{label}: residency estimate {est / 2**20:.2f} MiB "
                      f"a graph (budget passed "
                      f"{STACK_BUDGET_2D / 2**20:.0f} MiB)")
                r = stack_time(label, cfg, ops, w, float(nm.sum()),
                               reps=20 if not gravity else 3)
                res[(dname, gravity, B)] = r
    return res


def stack_serve_phase(root, dev, profile=False):
    """Phase 3c. Returns (stack launches, kernel row at the served shape,
    predict ms medians, and those of the same weights under
    edge_impl=fused)."""
    import numpy as np
    import torch

    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.ops import layer_pipeline as lp
    from distegnn_tpu_torch.serve import engine_with_params_from_config

    path = os.path.join(root, "configs", "nbody_serve.yaml")
    ov = {"model.edge_impl": "fused_stack", "data.edge_block": BLOCK}
    cfg = load_config(path, ov)
    model, eng = engine_with_params_from_config(cfg)
    m = cfg.model
    print(f"serve stack: edge_impl={m.edge_impl} H={m.hidden_nf} "
          f"L={m.n_layers} C={m.virtual_channels} max_batch={eng.max_batch} "
          f"budget={m.stack_vmem_budget or lp.DEFAULT_STACK_VMEM_BUDGET}")
    scenes = [scene(n, seed=200 + i) for i, n in enumerate(STACK_SCENES)]
    for g in scenes:
        batch, _ = eng.ladder.pad_batch([g], eng.ladder.bucket_of_graph(g),
                                        eng.max_batch, **eng._layout_opts)
        N, E = batch.max_nodes, batch.max_edges
        R = batch.remote_edge_mask.shape[-1]
        est = lp.estimate_stack_vmem_bytes(
            model.stack_config(batch), n_nodes=N, n_edges=E, remote_pad=R)
        print(f"serve stack scene n={g['loc'].shape[0]} edges="
              f"{g['edge_index'].shape[1]}: padded N={N} E={E} R={R}, "
              f"residency estimate {est / 2**20:.2f} MiB")
    eng.warmup([(g["loc"].shape[0], g["edge_index"].shape[1])
                for g in scenes])
    torch.cuda.synchronize()

    # the main path: counts 0 just before, read just after
    reset_stack_counts()
    outs = [eng.predict(g) for g in scenes]
    stack, fwd, bwd = stack_counts()
    want = len(scenes)
    print(f"serve stack: {len(scenes)} requests, fused_stack_fwd launches="
          f"{stack} (expected one per request, its {eng.max_batch} padded "
          f"graphs in the launch: {want}), fused_edge_fwd {fwd}, "
          f"fused_edge_bwd {bwd} (expected 0)")
    check(stack == want and fwd == 0 and bwd == 0,
          f"serve stack: launches {stack}/{fwd}/{bwd} != {want}/0/0")
    for g, o in zip(scenes, outs):
        check(o.shape == (g["loc"].shape[0], 3)
              and bool(np.isfinite(o).all()), "serve stack: bad output")
    check_equivariance("serve stack ", eng, scenes[1], outs[1])

    # the same weights under edge_impl=fused, and through the plain stack
    fmodel, feng = engine_with_params_from_config(
        load_config(path, dict(ov, **{"model.edge_impl": "fused"})))
    check(all(torch.equal(a, fmodel.state_dict()[k].to(a.device))
              for k, a in model.state_dict().items()),
          "serve stack: the fused model drew different weights")
    fused = [feng.predict(g) for g in scenes]
    fused_times = predict_times("serve stack (as edge_impl=fused) ", feng,
                                scenes)
    with contextlib.ExitStack() as st:
        for pt in stack_plain_patches():
            st.enter_context(pt)
        plain = [eng.predict(g) for g in scenes]
    err_f = max(float(np.abs(a - b).max()) for a, b in zip(outs, fused))
    err_p = max(float(np.abs(a - b).max()) for a, b in zip(outs, plain))
    print(f"serve stack vs edge_impl=fused: max_abs_err={err_f:.3e}; vs the "
          f"plain stack: {err_p:.3e} (tol {TOL_PLAIN:.1e})")
    check(err_f <= TOL_PLAIN and err_p <= TOL_PLAIN,
          "serve stack disagrees with the fused model or the plain stack")
    del fmodel, feng

    # a scene whose rung does not fit: the typed error, before any launch
    big = scene(STACK_OVER_BUDGET, seed=210)
    before = stack_counts()
    try:
        eng.predict(big)
    except lp.StackVmemBudgetError as exc:
        print(f"serve stack n={STACK_OVER_BUDGET}: StackVmemBudgetError: "
              f"{str(exc)[:120]}...")
    else:
        fail("serve stack: an over-budget scene did not raise")
    check(stack_counts() == before, "serve stack: launched over budget")

    times = predict_times("serve stack ", eng, scenes)
    if profile:
        profile_phase(eng, scenes[-1])
    # the kernel at the served rung: a batch of four distinct scenes held
    # against the plain version, then the largest request's padded batch
    # (its scene and three replicas, as predict pads it) held and timed
    distinct = [scene(n, seed=220 + i) for i, n in enumerate(STACK_DISTINCT)]
    batch, _ = eng.ladder.pad_batch(
        distinct, eng.ladder.bucket_of_graph(distinct[0]), eng.max_batch,
        **eng._layout_opts)
    cfg_k, ops, w, n_real = stack_model_operands(model, batch.to(dev))
    stack_time("serve stack kernel, 4 distinct scenes", cfg_k, ops, w,
               n_real, timed=False)
    batch, _ = eng.ladder.pad_batch(
        [scenes[-1]], eng.ladder.bucket_of_graph(scenes[-1]), eng.max_batch,
        **eng._layout_opts)
    cfg_k, ops, w, n_real = stack_model_operands(model, batch.to(dev))
    row = stack_time("serve stack kernel", cfg_k, ops, w, n_real)
    return stack, row, times, fused_times


def stack_train_phase(root, dev, clouds, profile=False):
    """Phase 7 in a temporary log directory (see :func:`train_phase`)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_stack_") as log_dir:
        return _stack_train_phase(root, dev, clouds, log_dir, profile)


def _stack_train_phase(root, dev, clouds, log_dir, profile):
    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.ops import layer_pipeline as lp

    path = os.path.join(root, "configs", "fluid_fused_stack.yaml")
    run_len = {"train.epochs": TRAIN_EPOCHS,
               "log.test_interval": TRAIN_EPOCHS, "log.log_dir": log_dir}
    cfg = load_config(path, run_len)
    m, d = cfg.model, cfg.data
    print(f"stack train config: edge_impl={m.edge_impl} H={m.hidden_nf} "
          f"L={m.n_layers} C={m.virtual_channels} node_feat_nf="
          f"{m.node_feat_nf} node_attr_nf={m.node_attr_nf} compute_dtype="
          f"{m.compute_dtype} edge_block={d.edge_block} node_order="
          f"{d.node_order} accelerate_mode={d.accelerate_mode} batch="
          f"{d.batch_size} accumulation_steps={cfg.train.accumulation_steps} "
          f"epochs={cfg.train.epochs}")
    check(m.edge_impl == "fused_stack", "the published config changed")
    ds = fluid_datasets(clouds, d.node_order)

    # the main path: counts 0 just before, read just after
    init_sd, state, (stack, fwd, bwd, tc), micro, evals = drive_train(
        cfg, ds, dev, reset_stack_counts,
        lambda: stack_counts() + (fwd_counts()[1],), "stack ")
    L = m.n_layers
    want = (micro + evals, L * micro, L * micro)
    print(f"stack train launches: fused_stack_fwd={stack}, fused_edge_fwd="
          f"{fwd}, fused_edge_bwd={bwd} (expected {want}: {micro} micro-steps "
          f"x (1 stack + {L} fwd + {L} bwd) + {evals} eval forwards x 1 "
          f"stack); {tc} of the fused_edge_fwd on the tensor-core kernel "
          f"(expected all: bf16 at H={m.hidden_nf})")
    check((stack, fwd, bwd) == want,
          f"stack train: launches {(stack, fwd, bwd)} != {want}")
    check(tc == fwd, f"stack train: tensor-core fwd launches {tc} != {fwd}")

    loader, batches = host_batches(cfg, ds, dev, "stack ")
    b0 = batches[0]
    est = lp.estimate_stack_vmem_bytes(
        state.model.stack_config(b0), n_nodes=b0.max_nodes,
        n_edges=b0.max_edges, remote_pad=b0.remote_edge_mask.shape[-1])
    print(f"stack train batch: N={b0.max_nodes} E={b0.max_edges} R="
          f"{b0.remote_edge_mask.shape[-1]}, {int(b0.edge_mask.sum())} real "
          f"edges, residency estimate {est / 2**20:.2f} MiB")
    cfg_k, ops, w, n_real = stack_model_operands(state.model, b0)
    row = stack_time("train stack kernel", cfg_k, ops, w, n_real)
    edge_rows = flagship_kernel_phase(state.model, b0, dev)

    # the first optimizer update again: the kernel, the plain stack, and
    # the per-layer fused lowering of the same weights
    n_micro = cfg.train.accumulation_steps
    k = first_update(cfg, init_sd, batches, dev, counts=stack_counts,
                     time_extra=TRAIN_TIMED, profile=profile)
    p = first_update(cfg, init_sd, batches, dev, counts=stack_counts,
                     patches=stack_plain_patches())
    cfg_f = load_config(path, dict(run_len, **{"model.edge_impl": "fused"}))
    f = first_update(cfg_f, init_sd, batches, dev, counts=stack_counts,
                     time_extra=TRAIN_TIMED)
    per = (L * n_micro, L * n_micro)
    check(k["launches"] == (n_micro,) + per and p["launches"] == (0,) + per
          and f["launches"] == (0,) + per,
          f"stack first update launches: kernel {k['launches']}, plain "
          f"{p['launches']}, fused {f['launches']}")
    for other, name in ((p, "plain stack"), (f, "edge_impl=fused")):
        errs, perr = update_distance(k, other)
        worst = sorted(perr.items(), key=lambda kv: -kv[1])
        print(f"stack first update, kernel vs {name}: losses "
              f"{errs['loss_with_mmd']:.3e} / {errs['loss']:.3e}, gradient "
              f"norm {errs['grad norm']:.3e}, max abs / max "
              f"{errs['grad']:.3e}, l2 {errs['grad l2']:.3e} (tol "
              f"{TOL_TRAIN:.0e}); worst parameters: " + ", ".join(
                  f"{n} {v:.3e}" for n, v in worst[:4])
              + f" (tol {STACK_PARAM:.3e})")
        check(all(errs[key] <= TOL_TRAIN for key in
                  ("loss_with_mmd", "loss", "grad norm", "grad"))
              and worst[0][1] <= STACK_PARAM,
              f"the stack's first update disagrees with the {name}")
    n_real_b = float(b0.node_mask.sum())
    med = step_times("stack ", k, n_real_b)
    med_f = step_times("stack (as edge_impl=fused) ", f, n_real_b)
    return dict(launches=(stack, fwd, bwd), row=row, edge_rows=edge_rows,
                ms=med, fused_ms=med_f)


# ------------------------------------------------ the blocked one-hot kernels

BLOCKED_TPU = {"blocked_seg_sum": "distegnn_tpu/ops/blocked.py:290",
               "blocked_gather": "distegnn_tpu/ops/blocked.py:306"}
RB_BLOCK, RB_TILE = 256, 512
# phase 3d: rollout scenes at one density (the radius of a 4000-node unit
# cube scene at mean degree ~20; smaller scenes fill a smaller cube)
ROLLOUT_N, ROLLOUT_DEG = 4000, 20.0
ROLLOUT_SIZES = (1000, 2000, 3000, 4000)
ROLLOUT_STEPS = 8
ROLLOUT_OPTS = {"max_degree": 48, "max_per_cell": 32, "edge_block": RB_BLOCK}
# phase 2e: the segment sum against f64 and against its plain version, as a
# fraction of each column's max |sum| (f32 accumulation in another order);
# the gather is a bit copy and is held bitwise
TOL_BLOCKED = 1e-6
# phase 3d: the kernels' rollout against the same engine through the plain
# versions and through blocked_impl=einsum, as a fraction of what the model
# moves the scene: the first step against max |x_1 - x_0| (~2e-3), the
# whole trajectory against max |x_k - x_0|. They differ by f32 summation
# order and by the rounding of x + dx at |x| ~ 1, where one ulp (1.2e-7,
# 2.4e-7 above 1.0) is 6e-5 to 1.2e-4 of the first step; the trajectory
# bound leaves room for a few such flips over K steps. PERF.md records the
# readings the bounds were set from. A wrong aggregation (zeroed
# translations, a wrong inv_deg) moves the scene by a different amount:
# an error of order 1 of the displacement.
TOL_ROLLOUT_STEP = 2e-4
TOL_ROLLOUT_TRAJ = 5e-4


def blocked_counts():
    """(blocked_seg_sum, blocked_gather, blocked_plan) launches."""
    from distegnn_tpu_torch.ops import blocked as BL

    return (BL.blocked_segment_sum.launches, BL.blocked_gather.launches,
            BL.blocked_plan.launches)


def blocked_widths():
    from distegnn_tpu_torch.ops import blocked as BL

    return (dict(BL.blocked_segment_sum.launch_widths),
            dict(BL.blocked_gather.launch_widths))


def reset_blocked_counts():
    from distegnn_tpu_torch.ops import blocked as BL

    for f in (BL.blocked_segment_sum, BL.blocked_gather):
        f.launches = 0
        f.launch_widths.clear()
    BL.blocked_plan.launches = 0


def blocked_plain_patches():
    """The three kernels' wrappers pointed at their plain versions."""
    from distegnn_tpu_torch.ops import blocked as BL

    return (mock.patch.object(BL, "_seg_sum_cuda",
                              BL.blocked_segment_sum_ref),
            mock.patch.object(BL, "_gather_cuda", BL.blocked_gather_ref),
            mock.patch.object(BL, "_plan_cuda", BL.blocked_plan_ref))


def blocked_want(L, steps=0, micro=0, evals=0):
    """Launches by (F, type) from the code, and the plan's: per forward
    (hoist_edge_mlp, fuse_agg, no pairing on the f32 rollout path) 1
    blocked_plan of the slots (inv_deg is its degree; every segment sum of
    the forward and its backward reads it) and per layer a gather of x
    [E, 3] and of the hoisted h @ W [E, H], and a seg_sum of the
    translations [E, 3] and of the edge features [E, H]. Training (bf16
    message MLPs, remat, the pairing attached) adds per micro-step the
    remat rerun of each layer (not of the plan, built before the layers)
    and the backward: a gather of each seg_sum's cotangent (but the last
    layer's edge-feature mean, which reaches only that layer's h, unused by
    the loss), a seg_sum for the row gather and the paired column gather of
    h @ W in every layer and of x in layers 1..L-1 (layer 0's x is the
    batch's). Returns (seg_sum widths, gather widths, plan launches)."""
    H = HIDDEN
    seg = collections.Counter()
    gat = collections.Counter()
    if steps:
        seg[(3, "f32")] += steps * L
        seg[(H, "f32")] += steps * L
        gat[(3, "f32")] += steps * L
        gat[(H, "f32")] += steps * L
    n_fwd = micro + evals
    if n_fwd:
        seg[(3, "f32")] += L * (2 * micro + evals) + 2 * (L - 1) * micro
        seg[(H, "bf16")] += L * (2 * micro + evals) + 2 * L * micro
        gat[(3, "f32")] += L * (2 * micro + evals) + L * micro
        gat[(H, "bf16")] += L * (2 * micro + evals) + (L - 1) * micro
    return dict(seg), dict(gat), steps + n_fwd


def seg_ref64(data, slot, n_nodes, block):
    """The exact segment sum in f64 [B, N, F] and each column's scale (the
    max over nodes of the sum of |data|), shaped [B, 1, F]."""
    import torch

    B, E, F = data.shape
    epb = E // (n_nodes // block)
    blk = (torch.arange(E, device=slot.device) // epb) * block
    valid = (slot >= 0) & (slot < block)
    idx = torch.where(valid, slot.long() + blk, torch.zeros_like(blk))
    idx = idx[..., None].expand(B, E, F)
    d = data.double() * valid[..., None]
    out = torch.zeros((B, n_nodes, F), dtype=torch.float64,
                      device=data.device).scatter_add_(1, idx, d)
    mag = torch.zeros_like(out).scatter_add_(1, idx, d.abs())
    return out, mag.amax(dim=1, keepdim=True).clamp(min=1e-30)


def blocked_case(label, slot, n_nodes, F, dtype, gen, dev, timed=False):
    """The three kernels at one shape: the plan against its plain version
    (torch.equal); the segment sum through it against the edge-order
    reference (torch.equal), f64 and its plain version (TOL_BLOCKED of each
    column's max), bitwise repeatable; the gather bitwise. With ``timed``
    each is timed beside its plain version, the library call
    (``index_add_`` into a zeroed output / ``index_select`` from h with a
    zero row for the sentinels; the plan has none: a stable
    ``torch.argsort`` of the slots, its largest part, is timed as
    ``sort_ms``), the einsum lowering and the bound: the kernels and the
    library calls as the median of batches of 200 launches
    (:func:`cuda_ms_batches`), eagerly and as CUDA-graph replays, the plain
    versions and the einsum lowering over 3 calls. Returns {kernel name:
    result}."""
    import torch

    from distegnn_tpu_torch.ops import blocked as BL

    B, E = slot.shape
    block, tile = RB_BLOCK, RB_TILE
    nb = n_nodes // block
    dname = "bf16" if dtype == torch.bfloat16 else "f32"
    elt = 2 if dname == "bf16" else 4
    data = torch.randn((B, E, F), generator=gen, device=dev).to(dtype)
    h = torch.randn((B, n_nodes, F), generator=gen, device=dev).to(dtype)
    real = int((slot < block).sum())
    plan = BL._plan_cuda(slot, n_nodes, block)
    torch.cuda.synchronize()
    plan_ok = all(torch.equal(a, b) for a, b in zip(
        plan, BL.blocked_plan_ref(slot, n_nodes, block)))
    out = BL._seg_sum_cuda(data, slot, n_nodes, block, tile, plan)
    torch.cuda.synchronize()
    inorder = torch.equal(out, BL.blocked_segment_sum_inorder(data, plan,
                                                              block))
    ref, scale = seg_ref64(data, slot, n_nodes, block)
    err64 = float(((out.double() - ref).abs() / scale).max())
    plain = BL.blocked_segment_sum_ref(data, slot, n_nodes, block, tile)
    errp = float(((out - plain).double().abs() / scale).max())
    again = torch.equal(BL._seg_sum_cuda(data, slot, n_nodes, block, tile,
                                         plan), out)
    g = BL._gather_cuda(h, slot, block, tile)
    torch.cuda.synchronize()
    gp = BL.blocked_gather_ref(h, slot, block, tile)
    sentinel = slot >= block
    g_ok = (torch.equal(g, gp) and g.dtype == dtype
            and bool((g[sentinel] == 0).all()))
    print(f"2e {label} B={B} N={n_nodes} E={E} F={F} {dname}: plan vs plain "
          f"equal {plan_ok}; seg_sum vs the edge-order sum bitwise "
          f"{inorder}, vs f64 {err64:.3e}, vs plain {errp:.3e} (tol "
          f"{TOL_BLOCKED:.0e} of each column's max), repeat bitwise {again}; "
          f"gather vs plain bitwise {g_ok}; {real} real slots")
    check(plan_ok, f"2e {label}: the plan kernel disagrees")
    check(inorder and err64 <= TOL_BLOCKED and errp <= TOL_BLOCKED and again,
          f"2e {label}: the seg_sum kernel disagrees")
    check(g_ok, f"2e {label}: the gather kernel disagrees")
    res = {"blocked_seg_sum": dict(err=float((out - plain).abs().max())),
           "blocked_gather": dict(err=float((g.float() - gp.float()).abs()
                                            .max())),
           "blocked_plan": dict(err=0.0)}
    if not timed:
        return res
    shape = f"B={B} N={n_nodes} E={E} F={F} {dname}"
    plan_shape = f"B={B} N={n_nodes} E={E}"
    # the library calls and the einsum lowering on the same inputs
    epb = E // nb
    blk = (torch.arange(E, device=dev) // epb) * block
    bofs = (torch.arange(B, device=dev) * (n_nodes + 1))[:, None]
    idx = torch.where(sentinel, torch.full_like(blk, n_nodes),
                      slot.long() + blk) + bofs
    idx = idx.reshape(-1)
    src = data.float().reshape(B * E, F)
    h_ext = torch.cat([h, torch.zeros((B, 1, F), dtype=dtype, device=dev)],
                      dim=1).reshape(B * (n_nodes + 1), F)
    oh = BL.onehot_blocks(slot, epb, block)
    key = torch.where(sentinel, torch.full_like(slot, block),
                      slot).reshape(B, nb, epb)

    def both(fn):
        # eagerly (host and card, as a path calls it) and as CUDA-graph
        # replays (the card's time)
        return (cuda_ms_batches(fn, graph=False), cuda_ms_batches(fn))

    ms_s = both(lambda: BL._seg_sum_cuda(data, slot, n_nodes, block, tile,
                                         plan))
    pl_s = cuda_ms(lambda: BL.blocked_segment_sum_ref(data, slot, n_nodes,
                                                      block, tile),
                   reps=3, warm=1)
    lib_s = both(lambda: torch.zeros((B * (n_nodes + 1), F),
                                     device=dev).index_add_(0, idx, src))
    ein_s = cuda_ms(lambda: BL._ein_seg_sum_raw(data, oh), reps=3, warm=1)
    ms_p = both(lambda: BL._plan_cuda(slot, n_nodes, block))
    pl_p = cuda_ms(lambda: BL.blocked_plan_ref(slot, n_nodes, block),
                   reps=3, warm=1)
    sort_p = both(lambda: torch.argsort(key, dim=-1, stable=True))
    ms_g = both(lambda: BL._gather_cuda(h, slot, block, tile))
    pl_g = cuda_ms(lambda: BL.blocked_gather_ref(h, slot, block, tile),
                   reps=3, warm=1)
    lib_g = both(lambda: torch.index_select(h_ext, 0, idx))
    ein_g = cuda_ms(lambda: BL._ein_gather_raw(h, oh).to(dtype), reps=3,
                    warm=1)
    del oh
    nodes = B * n_nodes
    offs = B * nb * (block + 1) * 4
    # seg_sum: the real slots' rows and their perm entries, the offsets, the
    # f32 output; the plan: the slots, then perm, off and the degree
    for name, (ms, g_ms), pl, (lib, g_lib), ein, nbytes, flops in (
            ("blocked_seg_sum", ms_s, pl_s, lib_s, ein_s,
             real * (F * elt + 4) + offs + nodes * F * 4, real * F),
            ("blocked_plan", ms_p, pl_p, (None, None), None,
             2 * B * E * 4 + offs + nodes * 4, 0),
            ("blocked_gather", ms_g, pl_g, lib_g, ein_g,
             nodes * F * elt + B * E * (4 + F * elt), 0)):
        b_ms, b_by = bound(nbytes, flops, "f32")
        res[name].update(ms=ms, graph_ms=g_ms, plain_ms=pl, library_ms=lib,
                         library_graph_ms=g_lib, einsum_ms=ein,
                         bound_ms=b_ms, bound_by=b_by,
                         shape=plan_shape if name == "blocked_plan"
                         else shape)
        lib_name = {"blocked_seg_sum": "index_add_",
                    "blocked_gather": "index_select"}.get(name)
        libs = (f"library ({lib_name}) {lib:.4f} eagerly, {g_lib:.4f} as "
                f"replays" if lib_name else
                f"no library call (stable argsort {sort_p[0]:.4f} eagerly, "
                f"{sort_p[1]:.4f} as replays)")
        eins = f"einsum lowering {ein:.4f} ms, " if ein is not None else ""
        print(f"2e {label} {name} {res[name]['shape']}: {ms:.4f} "
              f"ms/launch eagerly, "
              f"{g_ms:.4f} as CUDA-graph replays; plain {pl:.4f} ms, {libs}; "
              f"{eins}bound {b_ms:.4f} ms ({b_by}: {nbytes} B), "
              f"{b_ms / g_ms:.4f} of bound (replays)")
    res["blocked_plan"].update(sort_ms=sort_p[0], sort_graph_ms=sort_p[1])
    return res


def blocked_kernel_phase(dev, rollout_slot):
    """Phase 2e, the edge cases and the rollout batch's shapes (the train
    batch's come with phase 8)."""
    import numpy as np
    import torch

    gen = torch.Generator(device=dev).manual_seed(5)
    rng = np.random.default_rng(5)

    def synthetic(B, nb, epb, empty_last=True, fill=0.7):
        s = np.full((B, nb, epb), RB_BLOCK, np.int32)
        for b in range(B):
            for k in range(nb):
                if empty_last and b == 0 and k == nb - 1:
                    continue            # an all-sentinel block
                n = int(fill * epb)
                s[b, k, :n] = np.sort(rng.integers(0, RB_BLOCK, n))
                s[b, k] = rng.permutation(s[b, k])
        return torch.from_numpy(s.reshape(B, nb * epb)).to(dev)

    for label, slot, nb, F, dtype in (
            ("epb == tile, all-sentinel block", synthetic(1, 5, RB_TILE), 5,
             64, torch.float32),
            ("F=1", synthetic(1, 5, 1024), 5, 1, torch.float32),
            ("batch of 4, bf16", synthetic(4, 6, 1536), 6, 64,
             torch.bfloat16),
            ("batch of 4, F=3", synthetic(4, 6, 1536), 6, 3, torch.float32),
            ("bf16 F=128", synthetic(2, 3, 512), 3, 128, torch.bfloat16)):
        blocked_case(label, slot, nb * RB_BLOCK, F, dtype, gen, dev)
    n = rollout_slot.shape[1] // (ROLLOUT_OPTS["max_degree"])
    return {(F, "f32"): blocked_case("rollout", rollout_slot, n, F,
                                     torch.float32, gen, dev, timed=True)
            for F in (1, 3, HIDDEN)}


def rollout_scene(n, seed, r0):
    """A Morton-ordered uniform scene of ``n`` nodes at the density of
    :data:`ROLLOUT_N` nodes per unit cube (so radius ``r0`` gives every
    scene a mean degree of ~:data:`ROLLOUT_DEG`): loc, vel."""
    import numpy as np

    from distegnn_tpu_torch.ops.order import morton_perm

    rng = np.random.default_rng(seed)
    side = (n / ROLLOUT_N) ** (1.0 / 3.0)
    loc = (rng.uniform(0, side, size=(n, 3))).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 0.01 * r0).astype(np.float32)
    p = morton_perm(loc)
    return {"loc": loc[p], "vel": vel[p]}


def rollout_slots(eng, scenes, dev):
    """The slot ids of the first step of a rollout_batch of ``scenes`` (the
    batch the 3d main path runs), for phase 2e."""
    import numpy as np
    import torch

    from distegnn_tpu_torch.ops.blocked import slot_ids
    from distegnn_tpu_torch.ops.radius_dev import (ell_to_edge_list,
                                                   radius_graph_dev)

    o = eng._rollout_opts
    n_pad = max(eng.rollout_rung(s["loc"].shape[0]) for s in scenes)
    slots = []
    for s in scenes:
        n = s["loc"].shape[0]
        loc = np.zeros((n_pad, 3), np.float32)
        mask = np.zeros((n_pad,), np.float32)
        loc[:n], mask[:n] = s["loc"], 1.0
        g = radius_graph_dev(torch.from_numpy(loc).to(dev), o["radius"],
                             o["max_degree"], o["max_per_cell"],
                             node_mask=torch.from_numpy(mask).to(dev))
        ei, em = ell_to_edge_list(g)
        slots.append(slot_ids(ei[0], em, o["edge_block"],
                              o["max_degree"] * o["edge_block"]))
    return torch.stack(slots)


def rollout_serve_phase(root, dev, profile=False):
    """Phase 3d: K-step rollouts of configs/nbody_serve.yaml (H=64, L=4,
    C=3, f32, max_batch 4) with serve.rollout set and
    model.blocked_impl=pallas, through engine.rollout and
    engine.rollout_batch; exact launch counts, finiteness, no overflow,
    first-step equivariance, and the trajectory against the plain versions
    and against blocked_impl=einsum. Returns the launches, the phase 2e
    rows at the rollout batch's shape and the timings."""
    import numpy as np
    import torch

    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.serve import engine_with_params_from_config

    from distegnn_tpu_torch.ops.radius import radius_graph_np

    # the radius of a 4000-node unit-cube scene at mean degree ~20 (one
    # correction for the cube's boundary, as in :func:`scene`)
    r0 = (3.0 * ROLLOUT_DEG / (4.0 * math.pi * ROLLOUT_N)) ** (1.0 / 3.0)
    probe = rollout_scene(ROLLOUT_N, 500, r0)["loc"]
    e = radius_graph_np(probe, r0).shape[1]
    r0 *= (ROLLOUT_DEG / (e / ROLLOUT_N)) ** (1.0 / 3.0)
    e = radius_graph_np(probe, r0).shape[1]
    print(f"rollout scenes: radius {r0:.5f}, mean degree {e / ROLLOUT_N:.2f} "
          f"at {ROLLOUT_N} nodes per unit cube")
    opts = dict(ROLLOUT_OPTS, radius=float(r0))
    path = os.path.join(root, "configs", "nbody_serve.yaml")
    cfg = load_config(path, {"model.blocked_impl": "pallas",
                             "serve.rollout": opts})
    m = cfg.model
    model, eng = engine_with_params_from_config(cfg)
    L, K = m.n_layers, ROLLOUT_STEPS
    print(f"rollout config: H={m.hidden_nf} L={L} C={m.virtual_channels} "
          f"edge_impl={m.edge_impl} blocked_impl={m.blocked_impl} "
          f"max_batch={eng.max_batch} rollout={opts}")
    one = rollout_scene(ROLLOUT_N, 501, r0)
    many = [rollout_scene(n, 510 + i, r0)
            for i, n in enumerate(ROLLOUT_SIZES)]
    rung = eng.rollout_rung(ROLLOUT_N)
    print(f"rollout rungs: {ROLLOUT_N} nodes -> {rung}; the batch of "
          f"{ROLLOUT_SIZES} -> {max(map(eng.rollout_rung, ROLLOUT_SIZES))}")
    check(max(map(eng.rollout_rung, ROLLOUT_SIZES)) == rung,
          "rollout: the batch does not pad to the single scene's rung")
    reqs = [dict(s, steps=K) for s in many]
    eng.rollout(one["loc"], one["vel"], 1)          # warm-up: loads the kernels
    torch.cuda.synchronize()

    # the main path: counts 0 just before, read just after each request
    reset_blocked_counts()
    traj = eng.rollout(one["loc"], one["vel"], K)
    single = blocked_counts(), blocked_widths()
    reset_blocked_counts()
    trajs = eng.rollout_batch(reqs)
    batched = blocked_counts(), blocked_widths()
    want = blocked_want(L, steps=K)
    for name, (n, w) in (("rollout", single), ("rollout_batch", batched)):
        print(f"{name} (K={K}): blocked_seg_sum launches {n[0]} {w[0]}, "
              f"blocked_gather {n[1]} {w[1]}, blocked_plan {n[2]} (expected "
              f"per step 2L = {2 * L}, 2L = {2 * L} and 1: {want})")
        check(w == want[:2] and n == (K * 2 * L, K * 2 * L, K),
              f"{name}: launch counts {n} {w} != {want}")
    check(traj.shape == (K, ROLLOUT_N, 3) and np.isfinite(traj).all(),
          "rollout: bad or non-finite trajectory")
    for t, s in zip(trajs, many):
        check(t.shape == (K, s["loc"].shape[0], 3) and np.isfinite(t).all(),
              "rollout_batch: bad or non-finite trajectory")
    # what the model moves the scene: the error scales of the comparisons
    d1 = float(np.abs(traj[0] - one["loc"]).max())
    dk = float(np.abs(traj - one["loc"]).max())
    print(f"rollout: trajectory finite, no overflow; max |x_1 - x_0| "
          f"{d1:.3e}, max |x_k - x_0| over {K} steps {dk:.3e}, max |x| "
          f"{np.abs(traj).max():.3e}")
    check(d1 > 0.0, "rollout: the first step moved nothing")

    # first-step equivariance under a random rotation + translation
    rng = np.random.default_rng(7)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    R = (q * np.sign(np.diag(r))).astype(np.float32)
    t = rng.normal(size=(3,)).astype(np.float32)
    rot = eng.rollout((one["loc"] @ R.T + t).astype(np.float32),
                      (one["vel"] @ R.T).astype(np.float32), 1)
    err = float(np.abs(rot[0] - (traj[0] @ R.T + t)).max())
    print(f"rollout first-step equivariance: max_abs_err={err:.3e} tol "
          f"{TOL_EQUIV:.1e}")
    check(err <= TOL_EQUIV, "rollout: equivariance violated")

    # the same engine through the plain versions; the einsum lowering
    with contextlib.ExitStack() as stack:
        for pt in blocked_plain_patches():
            stack.enter_context(pt)
        reset_blocked_counts()
        traj_p = eng.rollout(one["loc"], one["vel"], K)
        check(blocked_counts() == (0, 0, 0),
              "plain versions launched kernels")
    cfg_e = load_config(path, {"model.blocked_impl": "einsum",
                               "serve.rollout": opts})
    model_e, eng_e = engine_with_params_from_config(cfg_e)
    check(all(torch.equal(a, model_e.state_dict()[k])
              for k, a in model.state_dict().items()),
          "the einsum engine drew other weights")
    reset_blocked_counts()
    traj_e = eng_e.rollout(one["loc"], one["vel"], K)
    check(blocked_counts() == (0, 0, 0),
          "the einsum lowering launched kernels")
    errs = {}
    for name, other in (("plain versions", traj_p), ("einsum", traj_e)):
        a1 = float(np.abs(traj[0] - other[0]).max())
        ak = float(np.abs(traj - other).max())
        e1, ek = a1 / d1, ak / dk
        errs[name] = (e1, ek)
        print(f"rollout kernels vs {name}: first step {a1:.3e} = {e1:.3e} "
              f"of max |x_1 - x_0| (tol {TOL_ROLLOUT_STEP:.0e}), all {K} "
              f"steps {ak:.3e} = {ek:.3e} of max |x_k - x_0| (tol "
              f"{TOL_ROLLOUT_TRAJ:.0e})")
        check(e1 <= TOL_ROLLOUT_STEP and ek <= TOL_ROLLOUT_TRAJ,
              f"rollout: the kernels disagree with the {name}")
    del model_e, eng_e

    # request times: median of 5 after the warm-up
    def times(fn):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        ts.sort()
        return ts
    t1 = times(lambda: eng.rollout(one["loc"], one["vel"], K))
    tb = times(lambda: eng.rollout_batch(reqs))
    for name, ts, n in (("rollout (1 scene)", t1, 1),
                        ("rollout_batch (4 scenes)", tb, len(reqs))):
        print(f"{name} K={K}: ms per request median {ts[2]:.3f} (min "
              f"{ts[0]:.3f} max {ts[-1]:.3f}), per step {ts[2] / K:.3f}, "
              f"{n * K * 1e3 / ts[2]:.1f} scene-steps/s")
    if profile:
        rollout_profile(eng, reqs)
    rows = blocked_kernel_phase(dev, rollout_slots(eng, many, dev))
    return dict(launches=(single[0], batched[0]),
                widths=(single[1], batched[1]), rows=rows,
                ms=(t1[2], tb[2]), errs=errs)


def rollout_profile(eng, reqs, reps=5):
    """``--profile``: host stages of one batched rollout step (each ended
    by a synchronise: the per-scene radius graphs, the batch's assembly,
    the forward), then torch.profiler over one request (device time by
    kernel, idle share)."""
    import functools

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distegnn_tpu_torch import rollout as R

    o = eng._rollout_fn_opts()
    n_pad = max(eng.rollout_rung(s["loc"].shape[0]) for s in reqs)
    loc = np.zeros((len(reqs), n_pad, 3), np.float32)
    vel = np.zeros_like(loc)
    mask = np.zeros((len(reqs), n_pad), np.float32)
    for i, s in enumerate(reqs):
        n = s["loc"].shape[0]
        loc[i, :n], vel[i, :n], mask[i, :n] = s["loc"], s["vel"], 1.0
    x, v, m = (torch.from_numpy(a).to(eng.device) for a in (loc, vel, mask))
    graph_fn = functools.partial(
        R._scene_graph, radius=o["radius"], max_degree=o["max_degree"],
        max_per_cell=o["max_per_cell"],
        feature_fn=o.get("feature_fn", R.default_feature_fn),
        edge_attr_fn=o.get("edge_attr_fn", R.default_edge_attr_fn))
    stages = {"radius_graphs": [], "batch": [], "forward": []}
    with torch.no_grad():
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            per = [graph_fn(x[b], v[b], m[b]) for b in range(x.shape[0])]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            batch = R._batch([p[0] for p in per], o["edge_block"])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            eng.model(batch)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for k, a, z in (("radius_graphs", t0, t1), ("batch", t1, t2),
                            ("forward", t2, t3)):
                stages[k].append((z - a) * 1e3)
    print("profile rollout_batch step stage ms (median of {}): {}".format(
        reps, json.dumps({k: sorted(v)[reps // 2]
                          for k, v in stages.items()})))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.rollout_batch(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"profile rollout_batch: wall {wall_ms:.3f} ms, device kernel time "
          f"{busy:.3f} ms, busy share {busy / wall_ms:.4f}, idle share "
          f"{1 - busy / wall_ms:.4f}, {sum(r[2] for r in rows)} device ops")
    for key, ms, n in rows[:12]:
        print(f"profile rollout kernel: {ms:.3f} ms  x{n}  {key[:90]}")
    print_blocked_device_time("rollout_batch", rows)


def blocked_train_phase(root, dev, clouds, profile=False):
    """Phase 8 in a temporary log directory (see :func:`train_phase`)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_blocked_") as log_dir:
        return _blocked_train_phase(root, dev, clouds, log_dir, profile)


def _blocked_train_phase(root, dev, clouds, log_dir, profile):
    import torch

    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.ops.blocked import slot_ids

    path = os.path.join(root, "configs", "largefluid_distegnn.yaml")
    run_len = {"train.epochs": TRAIN_EPOCHS,
               "log.test_interval": TRAIN_EPOCHS, "log.log_dir": log_dir}
    ov = {"data.edge_block": RB_BLOCK, "data.accelerate_mode": "cutoff_edges",
          "model.blocked_impl": "pallas"}
    cfg = load_config(path, {**ov, **run_len})
    m, d = cfg.model, cfg.data
    print(f"blocked train config: edge_impl={m.edge_impl} blocked_impl="
          f"{m.blocked_impl} edge_block={d.edge_block} node_order="
          f"{d.node_order} H={m.hidden_nf} L={m.n_layers} "
          f"C={m.virtual_channels} compute_dtype={m.compute_dtype} "
          f"remat={m.remat} hoist_edge_mlp={m.hoist_edge_mlp} "
          f"fuse_agg={m.fuse_agg} agg_dtype={m.agg_dtype} "
          f"accumulation_steps={cfg.train.accumulation_steps} "
          f"epochs={cfg.train.epochs}")
    check(m.edge_impl == "plain" and m.hoist_edge_mlp and m.fuse_agg
          and m.remat and m.agg_dtype is None,
          "the published config's plain-path knobs changed")
    ds = fluid_datasets(clouds, d.node_order)

    def read():
        return blocked_counts(), blocked_widths()

    # the main path: counts 0 just before, read just after
    init_sd, state, (n, widths), micro, evals = drive_train(
        cfg, ds, dev, reset_blocked_counts, read, "blocked ")
    L = m.n_layers
    want = blocked_want(L, micro=micro, evals=evals)
    print(f"blocked train launches: blocked_seg_sum {n[0]} {widths[0]}, "
          f"blocked_gather {n[1]} {widths[1]}, blocked_plan {n[2]} "
          f"(expected {want}: {micro} micro-steps, {evals} eval forwards)")
    check(widths == want[:2] and n == (sum(want[0].values()),
                                       sum(want[1].values()), want[2]),
          f"blocked train: launch counts {n} {widths} != {want}")

    loader, batches = host_batches(cfg, ds, dev, "blocked ")
    b0 = batches[0]
    check(loader.pairing and not loader.split_remote
          and b0.edge_pair is not None and b0.remote_edge_index is None
          and b0.max_nodes == -(-FLUID_N // RB_BLOCK) * RB_BLOCK,
          f"blocked train batch: N={b0.max_nodes} pairing {loader.pairing} "
          f"split_remote {loader.split_remote}")
    print(f"blocked train batch: N={b0.max_nodes} "
          f"({b0.max_nodes // RB_BLOCK} blocks) epb={b0.edges_per_block} "
          f"E={b0.max_edges}, {int(b0.edge_mask.sum())} real edges, pairing "
          f"attached")

    # phase 2e at the train batch's shapes
    slot = slot_ids(b0.row, b0.edge_mask, b0.edge_block, b0.edges_per_block)
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = {}
    for F, dtype, timed in ((1, torch.float32, True),
                            (3, torch.float32, True),
                            (HIDDEN, torch.bfloat16, True),
                            (HIDDEN, torch.float32, False)):
        r = blocked_case("train", slot, b0.max_nodes, F, dtype, gen, dev,
                         timed=timed)
        if timed:
            rows[(F, "bf16" if dtype == torch.bfloat16 else "f32")] = r
    del slot

    # the first optimizer update again: the kernels, their plain versions,
    # the einsum lowering and the scatter lowering of the plain layout
    n_micro = cfg.train.accumulation_steps
    n_real = float(b0.node_mask.sum())
    k = first_update(cfg, init_sd, batches, dev, counts=blocked_counts,
                     time_extra=TRAIN_TIMED, profile=profile)
    p = first_update(cfg, init_sd, batches, dev, counts=blocked_counts,
                     patches=blocked_plain_patches())
    cfg_e = load_config(path, {**ov, **run_len,
                               "model.blocked_impl": "einsum"})
    e = first_update(cfg_e, init_sd, batches, dev, counts=blocked_counts,
                     time_extra=TRAIN_TIMED)
    del batches
    cfg_s = load_config(path, {"data.accelerate_mode": "cutoff_edges",
                               **run_len})
    _, plain_batches = host_batches(cfg_s, ds, dev, "scatter ")
    s = first_update(cfg_s, init_sd, plain_batches, dev,
                     counts=blocked_counts, time_extra=TRAIN_TIMED)
    del plain_batches
    per = blocked_want(L, micro=n_micro)
    check(k["launches"] == (sum(per[0].values()), sum(per[1].values()),
                            per[2])
          and p["launches"] == e["launches"] == s["launches"] == (0, 0, 0),
          f"blocked first update launches: kernels {k['launches']}, plain "
          f"{p['launches']}, einsum {e['launches']}, scatter "
          f"{s['launches']}")
    for other, name in ((p, "plain versions"), (e, "blocked_impl=einsum"),
                        (s, "edge_block=0 (scatter)")):
        errs, perr = update_distance(k, other)
        worst = sorted(perr.items(), key=lambda kv: -kv[1])
        print(f"blocked first update, kernels vs {name}: losses "
              f"{errs['loss_with_mmd']:.3e} / {errs['loss']:.3e}, gradient "
              f"norm {errs['grad norm']:.3e}, max abs / max "
              f"{errs['grad']:.3e}, l2 {errs['grad l2']:.3e} (tol "
              f"{TOL_TRAIN:.0e}); worst parameters: " + ", ".join(
                  f"{nm} {v:.3e}" for nm, v in worst[:4])
              + f" (tol {SCATTER_PARAM:.3e})")
        check(all(errs[key] <= TOL_TRAIN for key in
                  ("loss_with_mmd", "loss", "grad norm", "grad"))
              and worst[0][1] <= SCATTER_PARAM,
              f"blocked first update: the kernels disagree with the {name}")
    med = step_times("blocked ", k, n_real)
    med_e = step_times("blocked einsum ", e, n_real)
    med_s = step_times("plain scatter (edge_block 0) ", s, n_real)
    return dict(launches=n, widths=widths, rows=rows, ms=med,
                einsum_ms=med_e, scatter_ms=med_s)


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
    import numpy as np

    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.ops.build import build_all
    from distegnn_tpu_torch.ops.graph import _round_up
    from distegnn_tpu_torch.serve import engine_with_params_from_config

    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(f"card: {smi}")
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    reports = build_all(["fused_edge_fwd", "fused_edge_bwd", "prefix_scan",
                         "fused_stack_fwd", "blocked_onehot"])
    print(f"built {len(reports)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line or "error" in line):
                print(f"  {name}: {line.strip()}")

    dev = torch.device(DEVICE)
    root = os.path.dirname(os.path.abspath(__file__))
    profile = "--profile" in sys.argv[1:]
    t0 = time.perf_counter()
    clouds = [fluid_cloud(300 + i) for i in range(6)]
    stack_clouds = [fluid_cloud(400 + i, n=STACK_FLUID_N) for i in range(6)]
    scenes = serve_scenes()
    e = [c["edge_index"].shape[1] for c in clouds]
    print(f"clouds: 6 x N={FLUID_N}, edges {min(e)}..{max(e)} (mean degree "
          f"{np.mean(e) / FLUID_N:.2f}); serve scenes; built in "
          f"{time.perf_counter() - t0:.1f} s")

    cfg = load_config(os.path.join(root, "configs", "nbody_serve.yaml"),
                      {"model.edge_impl": "fused", "data.edge_block": BLOCK})
    model, eng = engine_with_params_from_config(cfg)
    kres = edge_kernel_phase(model, dev)
    edge_bwd_kernel_phase(model, dev)
    stack_kernel_phase(dev)
    # the plain paths' scan shapes: the train loader's padded E (the 4
    # train clouds' max, rounded to the edge bucket), the serve bucket of
    # the largest scene
    e_train = _round_up(max(e[:4]), 128)
    e_serve = eng.ladder.bucket_of_graph(scenes[-1]).e
    sres = scan_phase(dev, e_train, e_serve)
    launches = serve_phase(cfg, model, eng, dev, scenes)
    if profile:
        profile_phase(eng, scenes[-1])
    del model, eng
    serve_scans, _ = plain_serve_phase(root, dev, scenes)
    serve_stacks, serve_stack_row, _, _ = stack_serve_phase(root, dev,
                                                            profile)
    rollout = rollout_serve_phase(root, dev, profile)
    train_fwd, train_bwd, flagship = train_phase(root, dev, clouds,
                                                 profile=profile)
    plain = plain_train_phase(root, dev, clouds, e_train, profile=profile)
    stack = stack_train_phase(root, dev, stack_clouds, profile=profile)
    blocked = blocked_train_phase(root, dev, clouds, profile=profile)
    print(f"main-path launches: fused_edge_fwd {launches} (serve) + "
          f"{train_fwd} (train) + {stack['launches'][1]} (stack train "
          f"backward), fused_edge_bwd {train_bwd} (train) + "
          f"{stack['launches'][2]} (stack train backward), prefix_scan "
          f"{serve_scans} (serve cumsum) + "
          f"{sum(plain['widths'].values())} (plain train), suffix "
          f"{plain['suffix']}, fused_stack_fwd {serve_stacks} (serve) + "
          f"{stack['launches'][0]} (stack train), blocked_seg_sum "
          f"{rollout['launches'][0][0]} + {rollout['launches'][1][0]} "
          f"(rollout, rollout_batch) + {blocked['launches'][0]} (blocked "
          f"train), blocked_gather {rollout['launches'][0][1]} + "
          f"{rollout['launches'][1][1]} + {blocked['launches'][1]}, "
          f"blocked_plan {rollout['launches'][0][2]} + "
          f"{rollout['launches'][1][2]} + {blocked['launches'][2]}")

    # one row per kernel and path, with the numbers of the dtype and shape
    # that path launches the kernel at: serving f32 at phase 2's shape,
    # training bf16 at the train batch's; the scan at each path's shapes
    def row(name, path, k, replaces, n, source=None):
        return {"name": name, "route": "cuda",
                "source": f"distegnn_tpu_torch/csrc/{source or name}.cu",
                "replaces": replaces, "launches": n, "max_abs_err": k["err"],
                "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": k.get("library_ms"),
                "graph_ms": k.get("graph_ms"),
                "library_graph_ms": k.get("library_graph_ms"), "path": path}

    fwd_tpu = "distegnn_tpu/ops/edge_pipeline.py:288"
    H = HIDDEN
    w = plain["widths"]
    scan_rows = (
        ("prefix_scan", "serve f32", serve_scans,
         "distegnn_tpu/ops/cumsum.py:38"),
        ("prefix_scan", "train fwd f32", w.get(("prefix", "f32", H + 4), 0),
         "distegnn_tpu/ops/cumsum.py:38"),
        ("prefix_scan", "train bwd bf16", w.get(("prefix", "bf16", H), 0),
         "distegnn_tpu/ops/cumsum.py:38"),
        ("prefix_scan", "train bwd f32", w.get(("prefix", "f32", 3), 0),
         "distegnn_tpu/ops/cumsum.py:38"),
        ("suffix_scan", "suffix f32", plain["suffix"],
         "distegnn_tpu/ops/cumsum.py:62"))
    kernels = [
        row("fused_edge_fwd_f32", "serve f32 N=8192", kres["f32"], fwd_tpu,
            launches, source="fused_edge_fwd"),
        row(flagship["fused_edge_fwd"]["kernel"],
            f"train {flagship['fused_edge_fwd']['dtype']} "
            f"{flagship['fused_edge_fwd']['shape']}",
            flagship["fused_edge_fwd"], fwd_tpu, train_fwd,
            source="fused_edge_fwd"),
        row("fused_edge_bwd", f"train {flagship['fused_edge_bwd']['dtype']} "
            f"{flagship['fused_edge_bwd']['shape']}",
            flagship["fused_edge_bwd"],
            "distegnn_tpu/ops/edge_pipeline.py:314", train_bwd)]
    kernels += [row(name, f"{key} {sres[key]['shape']}", sres[key], tpu, n,
                    source="prefix_scan")
                for name, key, n, tpu in scan_rows]
    ef, eb = stack["edge_rows"]["fused_edge_fwd"], \
        stack["edge_rows"]["fused_edge_bwd"]
    kernels += [
        row(ef["kernel"], f"stack train backward {ef['dtype']} "
            f"{ef['shape']}", ef, fwd_tpu, stack["launches"][1],
            source="fused_edge_fwd"),
        row("fused_edge_bwd", f"stack train backward {eb['dtype']} "
            f"{eb['shape']}", eb, "distegnn_tpu/ops/edge_pipeline.py:314",
            stack["launches"][2]),
        row("fused_stack_fwd", f"serve f32 {serve_stack_row['shape']}",
            serve_stack_row, STACK_TPU, serve_stacks),
        row("fused_stack_fwd", f"train {stack['row']['dtype']} "
            f"{stack['row']['shape']}", stack["row"], STACK_TPU,
            stack["launches"][0])]
    # the one-hot kernels: a row per path and launched width (F, type);
    # the gather's rows of at most 16 bytes are its narrow form; the plan
    # (part of the segment sum's port) a row per path
    for i, name in enumerate(("blocked_seg_sum", "blocked_gather")):
        for path, rows, widths in (
                ("rollout serve", rollout["rows"],
                 [w[i] for w in rollout["widths"]]),
                ("blocked train", blocked["rows"], [blocked["widths"][i]])):
            for key, r in sorted(rows.items()):
                n = sum(w.get(key, 0) for w in widths)
                if n:
                    kernels.append(row(
                        name, f"{path} {r[name]['shape']}", r[name],
                        BLOCKED_TPU[name], n, source="blocked_onehot"))
    for path, rows, n in (
            ("rollout serve", rollout["rows"],
             sum(c[2] for c in rollout["launches"])),
            ("blocked train", blocked["rows"], blocked["launches"][2])):
        r = rows[min(rows)]["blocked_plan"]
        kernels.append(row("blocked_plan", f"{path} {r['shape']}", r,
                           BLOCKED_TPU["blocked_seg_sum"], n,
                           source="blocked_onehot"))
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s, the kernels' build "
          f"included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
