#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that the PyTorch port runs on a GPU.

Run from the root of a checkout, with one CUDA card and no arguments:

    python3 chip_smoke.py

It drives the port (``distegnn_tpu_torch``) only and imports nothing of JAX
or of the JAX package. Phases (any failure exits nonzero):

  1. print the card (nvidia-smi name, power limit); build every kernel of
     the serving path from ``distegnn_tpu_torch/csrc`` with nvcc (sm_90a).
  2. hold each kernel against its plain PyTorch version on the card, at the
     shape the serving path gives it (N=8192 = 16 blocks of 512, H=64, a
     Morton-ordered radius graph of mean degree ~20), in f32 and bf16.
  3. serve: ``engine_with_params_from_config`` on configs/nbody_serve.yaml
     with model.edge_impl=fused and data.edge_block=512 (H=64, L=4, C=3,
     max_batch 4, random weights from the config's seed); answer four
     Morton-ordered scenes of ~1500/3000/6000/10000 nodes with every launch
     count set to 0 just before and read just after; check finiteness, the
     exact launch count, equivariance under a random rotation + translation,
     and agreement with the same model run through the plain version.
  4. time each kernel and its plain version with CUDA events, its bound from
     this run's shapes, and per-request predict time on the host clock.

With ``--profile`` it then breaks one request of the largest scene into host
stages and profiles it with torch.profiler (device time by kernel, the
device's idle share).

Output: timing lines, then one JSON line ``{"kernels": [...]}``, the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
"""

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


def edge_kernel_phase(model, dev):
    """Phase 2 + the kernel's timings of phase 4."""
    import torch

    from distegnn_tpu_torch.ops import edge_pipeline as ep
    from distegnn_tpu_torch.ops.graph import pad_graphs

    g = scene(KERNEL_N, seed=11)
    batch = pad_graphs([g], edge_block=BLOCK, split_remote=True).to(dev)
    arrs = [a[0].contiguous() for a in ep.build_edge_blocks(
        batch.row, batch.col, batch.edge_attr, batch.edge_mask, block=BLOCK,
        n_nodes=batch.max_nodes)]
    n_real_edges = g["edge_index"].shape[1]
    active = int((arrs[3][:, 2] > 0).sum())
    N, E = batch.max_nodes, arrs[3].shape[0]
    print(f"kernel shape: N={N} E_slots={E} real_edges={n_real_edges} "
          f"in_window={active} ({active / n_real_edges:.4f}) "
          f"mean_degree={n_real_edges / KERNEL_N:.2f}")

    p = model.gcl[0].phi_e_fused
    H = HIDDEN
    gen = torch.Generator(device=dev).manual_seed(5)
    h = torch.randn((N, H), generator=gen, device=dev)
    x = batch.loc[0].contiguous()
    w = ep.EdgeWeights(ws=p.w1[2 * H:].detach(), b1=p.b1[None].detach(),
                       w2=p.w2.detach(), b2=p.b2[None].detach(),
                       w3=p.w3.detach(), b3=p.b3[None].detach(),
                       w4=p.w4.T.detach())
    res = {}
    with torch.no_grad():
        for dname in ("f32", "bf16"):
            dt = torch.float32 if dname == "f32" else torch.bfloat16
            hr = (h.to(dt) @ p.w1[:H].to(dt)).contiguous()
            hc = (h.to(dt) @ p.w1[H:2 * H].to(dt)).contiguous()
            args = (x, hr, hc, *arrs, w, BLOCK, dname)
            out = ep.fused_edge_layer(*args)
            torch.cuda.synchronize()
            ref = ep.fused_edge_layer_ref(*args)
            errs = []
            for name, a, b in zip(("trans_sum", "count", "ef_sum"), out, ref):
                check(torch.isfinite(a).all(), f"{dname} {name} not finite")
                d = (a - b).abs()
                scale = float(b.abs().max())
                mx, mean = float(d.max()), float(d.mean())
                tmax = (TOL_TRANS[dname] if name == "trans_sum"
                        else TOL_MAX[dname])
                print(f"kernel vs plain {dname} {name}: max_abs_err={mx:.3e} "
                      f"mean_abs_err={mean:.3e} scale={scale:.4e} "
                      f"tol_max={tmax * scale:.3e} "
                      f"tol_mean={TOL_MEAN[dname] * scale:.3e}")
                check(mx <= tmax * scale and mean <= TOL_MEAN[dname] * scale,
                      f"kernel disagrees with plain version ({dname} {name})")
                errs.append(mx)
            ms = cuda_ms(lambda: ep.fused_edge_layer(*args))
            plain_ms = cuda_ms(lambda: ep.fused_edge_layer_ref(*args), reps=5)
            # least time for the same work on this card: inputs read once,
            # output written once; operations of the active edges only
            nbytes = (E * (3 * 4 + 8 * 4) + N * (3 * 4 + 2 * H * hr.element_size())
                      + (2 * H * H + 7 * H) * 4 + N * (H + 8) * 4)
            flops = active * (4 * H * H + 12 * H + 8)
            t_bytes = nbytes / PEAK_BYTES_S * 1e3
            t_ops = flops / PEAK_FLOPS_S[dname] * 1e3
            res[dname] = dict(ms=ms, plain_ms=plain_ms, err=max(errs),
                              bound_ms=max(t_bytes, t_ops),
                              bound_by="bytes" if t_bytes > t_ops
                              else "operations",
                              bytes=nbytes, flops=flops)
            print(f"kernel time {dname}: {ms:.4f} ms/launch, plain "
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
    reports = build_all(["fused_edge_fwd"])
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
    kres = edge_kernel_phase(model, dev)
    launches, scenes = serve_phase(cfg, model, eng, dev)
    if "--profile" in sys.argv[1:]:
        profile_phase(eng, scenes[-1])

    k = kres["f32"]
    kernels = [{
        "name": "fused_edge_fwd", "route": "cuda",
        "source": "distegnn_tpu_torch/csrc/fused_edge_fwd.cu",
        "replaces": "distegnn_tpu/ops/edge_pipeline.py:288",
        "launches": launches, "max_abs_err": k["err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
