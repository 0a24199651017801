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

  9. distributed training (parallel/launch.py ``run_distributed``): 2
     train clouds (the cut: phase 5 trains 4), the valid and the test
     cloud, partitioned into 4 parts each by the native metis partitioner
     (data/distribute.py; asserted native, within its 3 % balance cap, a
     cut below a random split's; partition ms and local edges per part
     printed). (j1) configs/largefluid_distegnn.yaml as published +
     data.world_size=4 (distribute, metis, plain scatter, bf16, remat, MSE
     + MMD, accumulation 4), 2 epochs, 4 ranks sharing the card over gloo:
     per rank the exact all-reduces of every micro-step (derived in
     ``micro_step_collectives``), batch_consistency 0, micro-step ms, the
     collectives' host ms and peak memory, the global nodes/s; parameters
     bitwise equal across ranks (run_distributed's broadcast check). Then,
     spawned over the same shards: (j1)'s first update with MMD off against
     the union of the parts in one process (phase 6's bounds) and an f32
     forward against it (1e-5 of scale); (j2) + model.edge_impl=fused,
     data.edge_block=512, 1 epoch: exact fused launches per rank, the first
     update with the plain versions (phase 5's bounds), edge_impl
     fused_stack under the axis launching no stack; (j0) as published with
     the world size from the card count: 1 rank over nccl, 1 epoch.

  10. the preemption drill: configs/largefluid_distegnn.yaml +
     data.accelerate_mode=cutoff_edges, model.edge_impl=fused,
     data.edge_block=512 (phase 5's cell) over phase 5's clouds, 2 epochs,
     an evaluation after each, a cadence save after every micro-step
     (keep_checkpoints 2) and log.trace_epoch 2, through main.run: A and A2
     uninterrupted; B with SIGTERM from the on_step hook after micro-step 2
     of epoch 2 (micro 3 of the 4-step accumulation); C resuming B's log
     dir with train.resume: auto in a fresh model; D as A with
     obs.enable: false. Checked: B's preempt checkpoint, PREEMPTED marker
     (1, 3) and rotation; C's restored state bitwise B's at the signal
     (parameters, Adam moments, accumulated gradients, micro, updates,
     step); C's replayed coordinates; C's final parameters within 2 x
     max |A2 - A| + 1e-6 x max |A| of A's; exact fused launches in A and
     C's equal to A's for the steps C ran; each run's events (memory
     events with CUDA peak bytes), the obs report of A's and A's trace
     naming both fused tensor-core kernels. Printed: a checkpoint's bytes,
     save and restore ms, the micro-step median with and without events.

  11. the other datasets, on synthetic raw files in their published
     layout and per-frame size (written here: Water-3D h5 by the port's
     HDF5 writer, 2 trajectories x [45, 7806, 3] a split at ~94.9 k edges
     a frame within 0.035; an AdK-shaped npz [4200, 855, 3]); only depth is
     cut (data.max_samples, train.epochs; printed). (a)
     configs/water3d_fastegnn.yaml as published (plain scatter, f32, batch
     15 ~ 117 k nodes) through main.run, 2 epochs: finite losses, the
     parameters moved, preprocessing ms a frame, micro-step ms, nodes/s,
     peak memory. (b) + model.edge_impl=fused, data.edge_block=512, 1
     epoch: exact fused launches (L x 15 graphs a micro-step, forward and
     backward, every forward on the f32 kernel), both kernels held and
     timed at the batch's graph 0, the first update with the plain versions
     (phase 5's bounds). (c) configs/simulation_distegnn.yaml as published
     + data.world_size=4 (metis, asserted native), 4 ranks sharing the card
     over gloo, 2 epochs: exact all-reduces a micro-step,
     batch_consistency 0, parameters bitwise replicated; the first update
     with MMD off against the parts' union (phase 9's bounds); each rank's
     shards written with write_shards and streamed through open_dataset in
     the ranks' loaders, every batch of every split on the card bitwise
     the pickle shards'. (d) configs/protein_fastegnn.yaml as published, 2
     epochs; the same weights on the test split built with test_rot and
     with test_trans: test MSE within TOL_DATA_EQUIV of the plain split's,
     and the frames whose radius graphs differ after the move counted.

  12. the serving gateway (serve/transport.py, serve/registry.py,
     serve/gateway.py): configs/nbody_serve.yaml as published with the
     serve.models routing its comments document, ``fused`` (phase 3's
     model) and ``rollout`` (phase 3d's), written to a temporary YAML. (a)
     In process, a Gateway on an ephemeral port, 8 closed-loop
     ``http.client`` threads: seven share 64 predicts of Morton-ordered
     scenes of 1500/3000/6000 nodes (mean degree ~20), a scene over
     max_nodes (413), an unknown model (404) and a malformed body (400);
     the eighth sends 4 rollouts of K=8 on 1000-4000-node scenes, then 2
     streamed rollouts (``?stream=1``, chunk_steps 4; it leaves the second
     after its first chunk), one after another; the counts set
     to 0 just before and read just after: fused_edge_fwd exactly L x
     max_batch per executed predict batch (every one on the f32 kernel),
     the one-hot kernels exactly per rollout step (1 plan, 2L seg_sum, 2L
     gather; the steps read from the run's serve/execute spans); every
     predict within 1e-5 of a direct engine.predict of the same entry and
     seed, the rollouts within phase 3d's bounds of engine.rollout, the
     streamed chunks of the buffered trajectory, the disconnected stream
     cancelled before its last chunk, the mean batch fill of /metrics
     above 1; a swap to a checkpoint in the trainer's format (canary
     launches L x max_batch per warmed rung, then predicts within 1e-5 of
     that checkpoint's engine) and one holding a NaN parameter (422, rolled
     back). (b) ``python -m distegnn_tpu_torch.serve.gateway`` on the same
     YAML: /readyz 200, then SIGTERM while a K=64 rollout and 8 predicts
     are in flight: every accepted request answers 200, /readyz answers
     503 during the drain, exit code 0. Printed: client-side p50/p99 per
     model and route, requests/s, the mean batch fill, rollout ms, the
     stream's first-chunk ms, the drain seconds and the phase's time.

  13. the promotion conveyor and process-isolated replicas (promote/,
     serve/worker.py, testing/serve_faults.py): configs/nbody_promote.yaml
     as published (3 replicas, the promoter on) + phase 12's ``fused``
     override, serve.workers: process, a fresh promote.watch_dir and
     serve.supervisor.worker_heartbeat_timeout_s 3 (default 10). (a)
     ``python -m distegnn_tpu_torch.serve.gateway`` on it: /readyz 200
     with 3 worker children, each a process other than the gateway's, on
     the card, with the parent's params digest; each child's pid, device,
     digest, spawn seconds and memory printed. (b) 48 predicts from 4
     closed-loop clients through the children, each within 1e-5 of an
     in-process engine.predict; SIGTERM, exit 0; from each child's own
     event stream (written at its exit): fused_edge_fwd_f32_kernel
     launches exactly L x max_batch per executed batch, none on the
     tensor-core kernel, its peak memory. (c) the same fleet in this
     process behind a Gateway, two clients sending predicts throughout,
     JAX's four-phase drill (testing/promote_drill.py): a candidate
     promoted; a publisher child SIGKILLed mid-publish (orphan tmp, no
     manifest, the conveyor unmoved, swept at the next publish); the
     canary killed with kill9_replica (rolled_back / canary_died, the
     supervisor respawns it); the live params x 2.25 (rolled_back /
     drift); 0 lost, 0 errors, /readyz fleet_coherent, no replica
     degraded. (d) sigstop_replica (heartbeat staleness, SIGKILL
     escalation, a new pid) and spawn_failure(n=1) (degraded, the event
     seen, a real child back at the next restart). (e) (b)'s p50 / p99 and
     requests/s beside phase 12's thread-backend predicts.
  14. tiled serving of scenes above serve.max_nodes (ops/tiling.py,
     serve/tiled.py): configs/nbody_serve.yaml + model.edge_impl=fused,
     data.edge_block=512, serve.tiled.enable (H=64, L=4, C=3). (a) a
     40000-node radius-graph scene at tile_nodes 8192 (at least 4 tiles)
     through engine.predict_tiled, within 1e-5 scale-normalized of the
     monolithic fused forward of the same module called directly, with
     exactly L x T launches of fused_edge_fwd_f32_kernel (counts set to 0
     just before, read just after). (b) JAX's million-node lattice (side
     100: 10^6 nodes, ~1.98 M edges) POSTed to the HTTP gateway at the
     default tile_nodes 65536: 200 (not 413), the engine holding one
     tile_layer shape key; the streamed variant's L x T progress lines and
     its answer within 1e-5 of the buffered one; a model routed with
     serve.tiled.max_nodes 524288 answers 413 naming the knob; exactly
     2 x L x T forward launches; the tiles, halo and stall fractions,
     prep_ms, total_ms, the device's peak memory and the host's RSS
     printed. (c) the forward kernel at the heaviest tile of (b)'s cached
     plan, held against its plain version and timed beside its bound.

  16. the data and tensor axes of the mesh (parallel/mesh.py: the world
     laid out as JAX's (data, graph, tensor) mesh, sub-groups by axis). (a)
     both fused edge kernels at phi_x width HX = H / T (w3 [H, HX], b3 and
     w4 [HX]: a tensor rank's slice) for HX = 32 and 16 at H = 64: the
     forward on the tensor cores (bf16) and the f32 kernel, the backward on
     the tensor cores (bf16) and the f32 FMA kernel, at phase 2's shape, at
     phase 9's rank shape (its rank 0's part of 4 of a cloud) and at (b)'s
     rank shape (a part of 2 of the same cloud: the shape (b) launches
     them at), each held against its plain version at phases 2 / 2b's
     bounds and timed beside its bound and plain version. (b)
     configs/largefluid_distegnn.yaml as published (H=64, L=4, C=3, bf16,
     remat, MSE + MMD, accumulation 4) + model.edge_impl=fused,
     data.edge_block=512 and parallel.mesh {data 1, graph 2, tensor 2}: 4
     ranks sharing the card over gloo, 1 epoch (the cut) of phase 9's
     first cloud split in 2 (the cut: its parts make every batch of the
     train, valid and test splits, so one partition serves the 4
     micro-steps): exact fused launches a micro-step a rank, every one at
     HX = 32 on the tensor-core kernels; exact all-reduces and all-gathers
     a micro-step by kind (``mesh_micro_step_collectives``); the
     parameters bitwise equal over the 4 ranks at the start and the end;
     after the last micro-step, in the same world, the first update with
     MMD off against the same run at tensor 1 (2 ranks) at phase 9's
     bounds. (c) configs/simulation_distegnn.yaml as published +
     parallel.mesh {data 2, graph 2} on phase 11's synthetic Water-3D files
     (4 ranks, 1 epoch, data.max_samples cut): exact collectives; after the
     last micro-step, in the same world, each rank's batch bitwise rows
     [d B, (d + 1) B) of the data-1 draw at batch 2B, and the first update
     with MMD off against data 1 at batch 2B at phase 9's bounds. Printed:
     micro-step ms, the all-reduce and all-gather counts with their host
     seconds, the phase's time.
  17. the scanned epoch (train/scan_epoch.py: the epoch on staged device
     data, the micro-step replayed from CUDA graphs). (a) cell (d)
     (phase 5's config and clouds, 2 epochs) twice eagerly and once
     scanned through main.run: the scanned losses and parameters within
     2x the eager runs' own distance (floor 1e-6 of scale), each captured
     micro-step 8 forward + 4 backward launches and the replayed launches
     (captured x replays) equal to the eager counts; the micro-step ms
     eagerly and replayed, the capture ms, the graph pool's bytes and the
     device idle share of one scanned epoch. (d) restore_state under the
     live runner: an eager epoch from a snapshot, the snapshot restored, a
     scanned epoch from it, within (a)'s bound. (b) configs/
     nbody_fastegnn.yaml as published under train.scan_epochs 'auto' (it
     must scan), then + model.segment_impl cumsum and FastSchNet +
     phase 15 (p)'s one-hot kernels, each scanned once and run twice
     eagerly (launches equal, within (a)'s kind of bound). (c) cell (g)
     the same way. Each of these bounds must sit below what the eager
     run moved the parameters. (e) configs/simulation_distegnn.yaml at
     parallel.mesh {data 1, graph 2} over gloo, 2 epochs (one update),
     the eager loop on the staged loaders (no capture) against it on the
     loaders: parameters within 1e-6 of scale, below the update's move,
     and the best losses within 1e-6. Phases 5-11, 15, 16 and 18 set
     train.scan_epochs: false and print it.
  18. Fluid113K from synthesized scenes, and the training fault kit. (a)
     sims 1, 101 and 121 (the first of each split), each made by
     ``python -m distegnn_tpu_torch.data.fluid_scenes generate --seed S
     --num-objects 2 --const-fluid-particles 113140 --radius 0.025
     --simulator-bin <stand-in>`` (the three started together, with
     (b)'s runs, beside the kernel build of phase 1, and waited for before
     phase 2: no measured phase runs beside them); the stand-in simulator,
     written here, exports 22 partio frames per fluid
     (the fewest delta_t 20 allows), the particles advanced along their
     start velocities, shuffled, with ids. The H100 machine has no
     zstandard, so the shards are neither packed nor read here: a
     ``read_sim`` of the exports through the port's bgeo codec
     (``scene_sim``: the arrays ``pack_scene_records`` stores) feeds
     ``run_distributed`` (the distribute branch of the port's ``main``) on
     configs/largefluid_distegnn.yaml as published + model.edge_impl
     fused, data.edge_block 512, data.max_samples 2, train.epochs 1,
     log.test_interval 1, at the world size from the card count (1 rank
     over nccl): the positions equal the stand-in's frames within 1e-6,
     viscosity and mass per fluid the scene's; exactly 2L fused forwards
     and L backwards a micro-step and L forwards an eval forward (all on
     the tensor cores); finite losses; the first update with the kernels
     against the plain versions at phase 5's bounds; both kernels held and
     timed at the batch's shape. (b) ``python -m
     distegnn_tpu_torch.testing.tiny_run`` on the card: two controls, a
     SIGKILL after step 6 with a cadence save every step (the newest step
     checkpoint truncated, then --resume auto: "resume: skipping" and
     "resume: restored"), a SIGTERM after step 2 (exit 75, the preempt
     checkpoint and marker, then --resume auto), both resumes within
     max(2 x the controls' distance, 1e-6 x |loss|) of the control's final
     loss; a NaN batch at step 5 with 2 retries (one divergence event,
     finite, not diverged). tiny_run launches no kernel (plain scatter).
     Printed: each scene's seconds and particles, the read and
     preprocessing seconds, the mean degree, the micro-step ms, nodes/s,
     peak memory and each drill run's seconds.
  19. the tools (``distegnn_tpu_torch/scripts``), each run in this process
     through its ``main(argv)`` on the card, the counts set to 0 just
     before and read just after. (a) ``serve_bench --transport http
     --requests 64 --sizes 256,512,1024`` on configs/nbody_serve.yaml +
     model.edge_impl fused, data.edge_block 512 at --rate 10, 20 and 40:
     each BENCH line, the sustained rate, completed, shed, p50 / p99;
     fused_edge_fwd_f32_kernel exactly L x max_batch = 16 a batch executed
     after the warmup boundary (and a multiple of 16 before it). (b)
     ``serve_bench --workload rollout --sizes 1000,2000,4000`` on phase
     3d's config: rows 5, 6 and the plan exactly blocked_want's for the
     run's steps (the warmup's two, the solo and B=1 windows and the
     coalesced batches, K each). (c) ``traffic_gen --profile spike10x
     --requests 96 --rate 10 --mix predict=0.6,session=0.3,rollout=0.1``
     against phase 12's two-model YAML in process (row 1 exactly 16 a
     fused batch, rows 5 / 6 and the plan exactly blocked_want's for the
     rollout steps) and with --url against ``python -m
     distegnn_tpu_torch.serve.gateway`` (a process of its own; SIGTERM,
     exit 0): both records' per-phase p50 / p99 and SLO verdicts, the same
     phase counts, no request lost. (d) ``measure_remat_memory --xla-temp``
     at 20000, 50000 and 113140 nodes (the flagship model, bf16, H=64,
     L=4, C=3): saved bytes and the card's grad-step peak, each lower with
     remat. (e) ``evaluate_rollout`` on 4 n-body test trajectories (71
     frames) from the port's generator, configs/nbody_fastegnn.yaml +
     model.blocked_impl pallas, random weights: finite horizons, rows 5 / 6
     and the plan exactly blocked_want's. Its clouds are built beside the
     kernel build.

Phases 3, 5, 6, 7 and 8 also time the host layout (``pad_batch``, the
loader's first pass) with the native library and with the numpy layout.

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

import atexit
import collections
import concurrent.futures
import contextlib
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import threading
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
# the phases that time or probe single micro-steps (5-11, 15, 16) run the
# eager loop; phase 17 scans (train/scan_epoch.py)
EAGER = {"train.scan_epochs": False}
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


@contextlib.contextmanager
def phase_tmp(prefix):
    """A temporary directory for one phase's files. A run in it binds the
    process's event stream to a file there, so the stream is unbound before
    the directory goes (a later phase's first event would find no file)."""
    import tempfile

    from distegnn_tpu_torch import obs

    with tempfile.TemporaryDirectory(prefix=prefix) as tmp:
        try:
            yield tmp
        finally:
            obs.configure(enable=False)


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


def fwd_work(N, E, active, H, elt, hx=None):
    """(bytes, flop) of one forward launch: inputs read once (edge stream,
    x, hr/hc of ``elt`` bytes, weights), the [N, H+8] sums written once;
    the operations of the active edges only (the H x H product and the
    H x HX one; phi_x's width HX is H, or H / T on a tensor rank)."""
    hx = H if hx is None else hx
    nbytes = (E * (3 * 4 + 8 * 4) + N * (3 * 4 + 2 * H * elt)
              + (H * H + H * hx + 4 * H + 3 * hx) * 4 + N * (H + 8) * 4)
    return nbytes, active * (2 * H * H + 2 * H * hx + 12 * H + 8)


def bwd_work(N, E, active, H, elt, hx=None):
    """(bytes, flop) of one backward launch: the forward's inputs and the
    [N, H+8] cotangent read once, the two [N, H+8] sums and the weight
    gradients written once; per active edge six products (three H x H,
    three H x HX: 12 H^2 at HX = H) plus ~30 H of elementwise work."""
    hx = H if hx is None else hx
    nw = H * H + H * hx + 4 * H + 3 * hx
    nbytes = (E * (3 * 4 + 8 * 4) + N * (3 * 4 + 2 * H * elt) + nw * 4
              + N * (H + 8) * 4 + 2 * N * (H + 8) * 4 + nw * 4)
    return nbytes, active * (6 * H * H + 6 * H * hx + 30 * H)


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
    reset_fused_counts()
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
    pad_batch_ms(eng, scenes[-1])
    return launches


def no_native():
    """The native library unavailable: the port's numpy layout runs."""
    from distegnn_tpu_torch import native

    return mock.patch.object(native._NATIVE, "get", lambda: None)


def pad_batch_ms(eng, g, reps=5):
    """The host padding of one request (``pad_batch``: blockify, pairing,
    the remote list) with the native library and with the numpy layout,
    median of ``reps`` each; the two batches must be equal."""
    import torch

    bucket = eng.ladder.bucket_of_graph(g)
    out = {}
    for label, ctx in (("native", contextlib.nullcontext), ("numpy",
                                                            no_native)):
        ts = []
        with ctx():
            for _ in range(reps):
                t0 = time.perf_counter()
                batch, _ = eng.ladder.pad_batch([g], bucket, eng.max_batch,
                                                **eng._layout_opts)
                ts.append((time.perf_counter() - t0) * 1e3)
        out[label] = (sorted(ts)[reps // 2], batch)
    a, b = out["native"][1], out["numpy"][1]
    same = all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(vars(a).values(), vars(b).values()))
    check(same, "pad_batch: the native and numpy layouts differ")
    print(f"pad_batch ms (host), n={g['loc'].shape[0]}, median of {reps}: "
          f"native layout {out['native'][0]:.3f}, numpy "
          f"{out['numpy'][0]:.3f} (equal batches)")


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


def print_mode(label, cfg):
    """The train loop a phase runs: ``train.scan_epochs`` (EAGER's false,
    the eager loop)."""
    print(f"{label}train.scan_epochs: {cfg.train.scan_epochs}")


def fused_counts():
    from distegnn_tpu_torch.ops import edge_pipeline as ep

    return ep.fused_edge_layer.launches, ep.fused_edge_layer.bwd_launches


def reset_fused_counts():
    """Every launch count of the fused edge kernels to 0."""
    from distegnn_tpu_torch.ops import edge_pipeline as ep

    ep.fused_edge_layer.launches = 0
    ep.fused_edge_layer.tc_launches = 0
    ep.fused_edge_layer.f32_launches = 0
    ep.fused_edge_layer.bwd_launches = 0
    ep.fused_edge_layer.launch_widths.clear()
    ep.fused_edge_layer.bwd_launch_widths.clear()


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
                 time_extra=0, profile=False, axis_name=None, rank=None,
                 profiler=None, tensor_axis=None, data_axis_name=None):
    """One optimizer update (accumulation_steps micro-steps) of the train
    step from ``init_sd`` over ``batches`` (on the card), with the per-step
    generators of epoch 1. Returns a dict: the micro-steps' losses with and
    without MMD, the accumulated gradient as one vector (as the optimizer
    sees it, by parameter name), the change of ``counts()`` (kernel
    launches) over the update, and the micro-step ms of ``time_extra`` more
    timed micro-steps. ``patches`` (e.g. :func:`fused_plain_patches`) are
    entered around it all. ``axis_name`` / ``rank``: one rank of a
    distributed run (the gradient is then the one summed over the ranks);
    ``tensor_axis`` / ``data_axis_name`` its mesh's other axes.
    ``profile`` runs one more micro-step under ``profiler`` (default
    :func:`profile_step`), whose result is ``out["profile"]``."""
    import torch

    from distegnn_tpu_torch.models.registry import get_model
    from distegnn_tpu_torch.train.step import (TrainState, make_optimizer,
                                               make_train_step,
                                               needs_grad_clip,
                                               step_generator)

    model = get_model(cfg.model, dataset_name=cfg.data.dataset_name,
                      axis_name=axis_name, tensor_axis=tensor_axis)
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
    # MMD applies to the virtual-node (Fast*) models only, as in main.py
    mmd_w = t.mmd.weight if cfg.model.model_name.startswith("Fast") else 0.0
    step = make_train_step(model, opt, mmd_w, t.mmd.sigma, t.mmd.samples,
                           axis_name=axis_name, data_axis_name=data_axis_name)
    before = counts()
    with contextlib.ExitStack() as stack:
        for pt in patches:
            stack.enter_context(pt)
        out = {"loss_with_mmd": [], "loss": []}
        for i in range(t.accumulation_steps):
            b = batches[i % len(batches)]
            state, m = step(state, b, step_generator(cfg.seed, 1, i, dev,
                                                     rank))
            for k in out:
                out[k].append(float(m[k]))
        out["grad"] = grads[0]
        out["launches"] = tuple(a - b for a, b in zip(counts(), before))
        ms = []
        for i in range(time_extra):
            b = batches[i % len(batches)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b, step_generator(cfg.seed, 2, i, dev,
                                                     rank))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["ms"] = ms
        if profile:
            out["profile"] = (profiler or profile_step)(
                lambda: step(state, batches[0], step_generator(
                    cfg.seed, 3, 0, dev, rank)))
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
        else "fused_edge_fwd_f32" if ep.fwd_uses_f32_kernel(H, dname)
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
    with phase_tmp("chip_smoke_train_") as log_dir:
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

    init_sd = get_model(
        cfg.model, dataset_name=cfg.data.dataset_name,
        generator=torch.Generator().manual_seed(int(cfg.seed))).state_dict()
    marks = []

    def on_step(epoch, step, metrics):
        torch.cuda.synchronize()
        marks.append((epoch, step, time.perf_counter(),
                      float(metrics["loss_with_mmd"])))

    print_mode(label, cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, _, log = run(cfg, *ds, device=dev, on_step=on_step)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    B, epochs = cfg.data.batch_size, cfg.train.epochs
    micro = epochs * (len(ds[0]) // B)
    evals = (epochs // cfg.log.test_interval) * (len(ds[1]) // B
                                                 + len(ds[2]) // B)
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
    work cached on the first), the first pass again with the numpy layout
    (on copies of the graph dicts: the plain pairing caches itself on
    them), and the copy to the card."""
    import torch

    from distegnn_tpu_torch.data.loader import GraphDataset
    from distegnn_tpu_torch.main import make_loaders

    with no_native():
        copies = [GraphDataset([dict(g) for g in d.graphs]) for d in ds]
        loader = make_loaders(cfg, *copies)[0]
        loader.set_epoch(1)
        t0 = time.perf_counter()
        numpy_host = list(loader)
        numpy_ms = (time.perf_counter() - t0) * 1e3 / len(numpy_host)
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
    same = all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for a, b in zip(host, numpy_host)
               for x, y in zip(vars(a).values(), vars(b).values()))
    check(same, f"{label}the native and numpy loader layouts differ")
    print(f"{label}loader ms per batch (host): first pass "
          f"{(t1 - t0) * 1e3 / nb:.1f} (numpy layout {numpy_ms:.1f}, equal "
          f"batches), second {(t2 - t1) * 1e3 / nb:.1f}; "
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
         "data.accelerate_mode": "cutoff_edges", **EAGER,
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

    # the main path: counts 0 just before, read just after
    init_sd, state, (fwd, bwd, tc), micro, evals = drive_train(
        cfg, ds, dev, reset_fused_counts,
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

    return {name: scan_row(dev, gen, B, E, F, dt, rev, label=f"{name} ")
            for name, (B, E, F, dt, rev) in rows.items()}


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
    with phase_tmp("chip_smoke_plain_") as log_dir:
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
    cfg = load_config(path, {**ov, **run_len, **EAGER})
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
    cumsum_update_agrees("plain ", k, p, sc)
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
    from distegnn_tpu_torch.ops import layer_pipeline as lp

    lp.fused_egnn_stack.launches = 0
    reset_fused_counts()


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
    with phase_tmp("chip_smoke_stack_") as log_dir:
        return _stack_train_phase(root, dev, clouds, log_dir, profile)


def _stack_train_phase(root, dev, clouds, log_dir, profile):
    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.ops import layer_pipeline as lp

    path = os.path.join(root, "configs", "fluid_fused_stack.yaml")
    run_len = {"train.epochs": TRAIN_EPOCHS,
               "log.test_interval": TRAIN_EPOCHS, "log.log_dir": log_dir}
    cfg = load_config(path, {**run_len, **EAGER})
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


def rollout_radius():
    """Phase 3d's radius: mean degree ~ROLLOUT_DEG at ROLLOUT_N nodes per
    unit cube (one correction for the cube's boundary). Returns (radius,
    measured mean degree)."""
    from distegnn_tpu_torch.ops.radius import radius_graph_np

    r0 = (3.0 * ROLLOUT_DEG / (4.0 * math.pi * ROLLOUT_N)) ** (1.0 / 3.0)
    probe = rollout_scene(ROLLOUT_N, 500, r0)["loc"]
    e = radius_graph_np(probe, r0).shape[1]
    r0 *= (ROLLOUT_DEG / (e / ROLLOUT_N)) ** (1.0 / 3.0)
    return r0, radius_graph_np(probe, r0).shape[1] / ROLLOUT_N


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

    # the radius of a 4000-node unit-cube scene at mean degree ~20
    r0, deg = rollout_radius()
    print(f"rollout scenes: radius {r0:.5f}, mean degree {deg:.2f} "
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
    with phase_tmp("chip_smoke_blocked_") as log_dir:
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
    cfg = load_config(path, {**ov, **run_len, **EAGER})
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


# ------------------------------------------------ phase 9: distributed training

DIST_WS = 4
# j1 trains 2 epochs over DIST_TRAIN / 1 / 1 of the clouds, j2 one; j0 one
# over the 4 / 1 / 1 unpartitioned. The cut (to keep the script inside its
# time): 2 train clouds, not phase 5's 4, so 4 clouds are partitioned
DIST_EPOCHS = 2
DIST_TRAIN = 2
# the native partitioner's balance cap (native/partition.cpp k-way refine)
PART_CAP = 1.03
# a rank's f32 forward against the union graph's, of the max |coordinate|
TOL_UNION_F32 = 1e-5


class StepProbe:
    """``on_step`` of ``run_distributed`` (pickled into every rank): after
    each micro-step, synchronised, the host time, the losses, the
    collectives so far by kind and their host seconds, the fused kernels'
    launches so far and the peak device memory, written to
    ``<out_dir>/rank<r>.json``."""

    def __init__(self, out_dir):
        self.out_dir = out_dir
        self.rows = []

    def __call__(self, epoch, step, metrics):
        import torch
        import torch.distributed as dist

        from distegnn_tpu_torch.ops import edge_pipeline as ep
        from distegnn_tpu_torch.ops import layer_pipeline as lp
        from distegnn_tpu_torch.parallel.collectives import (all_gather,
                                                             all_reduce)

        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        self.rows.append({
            "epoch": epoch, "step": step, "t": time.perf_counter(),
            "loss": float(metrics["loss_with_mmd"]),
            "consistency": float(metrics["batch_consistency"]),
            "counts": dict(all_reduce.counts),
            "seconds": sum(all_reduce.seconds.values()),
            "gathers": dict(all_gather.counts),
            "gather_seconds": sum(all_gather.seconds.values()),
            "widths": {f"{h}x{x}": n for (h, x), n in
                       ep.fused_edge_layer.launch_widths.items()},
            "bwd_widths": {f"{h}x{x}": n for (h, x), n in
                           ep.fused_edge_layer.bwd_launch_widths.items()},
            "fwd": ep.fused_edge_layer.launches,
            "tc": ep.fused_edge_layer.tc_launches,
            "bwd": ep.fused_edge_layer.bwd_launches,
            "stack": lp.fused_egnn_stack.launches,
            "peak": torch.cuda.max_memory_allocated() if cuda else 0})
        with open(os.path.join(self.out_dir,
                               f"rank{dist.get_rank()}.json"), "w") as f:
            json.dump(self.rows, f)


def micro_step_collectives(L, remat, mmd, update, first=False):
    """The all-reduces of one micro-step of the distributed train step, by
    kind, derived from the code: each layer's three node means sum a
    value and a count (models/fast_egnn.py, parallel/collectives.py), rerun
    by remat's recompute; the backward sums the cotangent of every value
    sum that reaches the loss: all but layer 0's coordinate mean (the input
    positions) and the last layer's feature mean (its Hv output is unused);
    the loss's node count once per weighted share (two with MMD); the two
    logged losses in one buffer; the consistency pair (MIN, MAX); the
    gradient buffer once per update (train/step.py); the preemption
    guard's stop agreement, one MAX after every micro-step
    (train/trainer.py PreemptionGuard.stop_agreed). The probe reads the
    counts between a micro-step and that agreement, so each micro-step's
    delta carries the previous one's: all but the run's ``first``."""
    return {"psum": 6 * L * (2 if remat else 1) + (2 if mmd else 1),
            "psum_bwd": 3 * L - 2, "loss": 1, "consistency": 2,
            "grad": 1 if update else 0, "stop": 0 if first else 1}


def write_dist_shards(cfg, clouds, out_dir, ws):
    """The clouds as train / valid / test (all but the last two, then one
    each) partitioned by the config's split mode into
    ``ws`` parts and written as shard files (data/distribute.py, the
    preprocessing path of a distribute run). Returns (split paths, (each
    cloud's partition ms: the outer-radius graph and the labels; the
    labels alone, native_partition), the split's wall ms)."""
    from distegnn_tpu_torch.data import partition
    from distegnn_tpu_torch.data.distribute import write_partitioned_split

    from distegnn_tpu_torch import native

    d = cfg.data
    part_ms, label_ms = [], []

    def timed(fn, into):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    paths = []
    t0 = time.perf_counter()
    with mock.patch.object(partition, "assign_partitions", timed(
            partition.assign_partitions, part_ms)), mock.patch.object(
            native, "native_partition", timed(native.native_partition,
                                              label_ms)):
        for split, graphs in (("train", clouds[:-2]),
                              ("valid", clouds[-2:-1]),
                              ("test", clouds[-1:])):
            paths.append(write_partitioned_split(
                graphs, out_dir, f"fluid_{split}", ws, d.split_mode,
                d.inner_radius, d.outer_radius, seed=cfg.seed))
    return paths, (part_ms, label_ms), (time.perf_counter() - t0) * 1e3


def check_partitions(clouds, paths, part_ms, ws):
    """Phase 9's partition checks: the native partitioner ran; each cloud's
    parts within its balance cap; the edge cut (the cloud's radius edges
    that no part keeps: inner = outer radius) below a random split's."""
    import pickle

    import numpy as np

    from distegnn_tpu_torch.data import partition
    from distegnn_tpu_torch.native import native_edge_cut

    check(partition.metis_labels.partitioner == "native",
          "metis did not run the native partitioner")
    shards = []
    for split in paths:
        per = []
        for p in split:
            with open(p, "rb") as f:
                per.append(pickle.load(f))
        shards.append(per)
    parts = [[shard[i] for shard in split] for split in shards
             for i in range(len(split[0]))]
    for i, (cloud, pr) in enumerate(zip(clouds, parts)):
        n = [q["loc"].shape[0] for q in pr]
        local = [q["edge_index"].shape[1] for q in pr]
        total = cloud["edge_index"].shape[1]
        cut = total - sum(local)
        indptr, col = partition._csr_from_edges(cloud["edge_index"],
                                                cloud["loc"].shape[0])
        rnd = native_edge_cut(indptr, col, partition.random_labels(
            cloud["loc"].shape[0], ws, np.random.default_rng(i)))
        imb = max(n) / (sum(n) / ws)
        print(f"partition cloud {i}: metis {part_ms[0][i]:.1f} ms (the "
              f"outer-radius graph + the native labels "
              f"{part_ms[1][i]:.1f} ms); "
              f"nodes per part {n} (max/mean {imb:.4f}, cap {PART_CAP}); "
              f"local edges per part {local}; cut {cut} of {total} edges "
              f"({cut / total:.4f}), random split {rnd} ({rnd / total:.4f})")
        check(sum(n) == cloud["loc"].shape[0], "partition lost nodes")
        check(imb <= PART_CAP, f"cloud {i}: partition imbalance {imb:.4f}")
        check(cut < rnd, f"cloud {i}: metis cut {cut} >= random {rnd}")
    return shards


def read_probe(out_dir, ws):
    rows = []
    for r in range(ws):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            rows.append(json.load(f))
    return rows


def report_dist_run(label, cfg, rows, n_real, startup):
    """Per rank: exact collectives of every micro-step (the first one also
    carries ``startup``: the loaders' layout agreement and the replication
    check), batch_consistency 0, micro-step ms (median of the steps after
    the first update, host clock between synchronised micro-step ends),
    collective seconds and peak memory; the global nodes/s. Returns the
    medians."""
    L, k = cfg.model.n_layers, cfg.train.accumulation_steps
    mmd = bool(cfg.train.mmd.weight)
    meds = []
    for r, rr in enumerate(rows):
        prev, prev_s = {}, 0.0
        for j, row in enumerate(rr):
            want = micro_step_collectives(L, cfg.model.remat, mmd,
                                          (j + 1) % k == 0, first=(j == 0))
            if j == 0:
                for kind, n in startup.items():
                    want[kind] = want.get(kind, 0) + n
            got = {kind: n - prev.get(kind, 0)
                   for kind, n in row["counts"].items()
                   if n - prev.get(kind, 0)}
            check(got == {kind: n for kind, n in want.items() if n},
                  f"{label}rank {r} micro-step {j}: collectives {got}, "
                  f"expected {want}")
            row["coll_ms"] = (row["seconds"] - prev_s) * 1e3
            prev, prev_s = row["counts"], row["seconds"]
            check(row["consistency"] == 0.0,
                  f"{label}rank {r}: batch_consistency {row['consistency']}")
            check(math.isfinite(row["loss"]), f"{label}non-finite loss")
        # the steps after the first update (a run of one update: all but
        # the first step)
        after = k if len(rr) > k else 1
        post = [(b["t"] - a["t"]) * 1e3 for j, (a, b) in
                enumerate(zip(rr, rr[1:])) if j + 1 >= after
                and a["epoch"] == b["epoch"]]
        coll = sorted(row["coll_ms"] for row in rr[after:]) or [0.0]
        med = sorted(post)[len(post) // 2] if post else float("nan")
        meds.append(med)
        per = micro_step_collectives(L, cfg.model.remat, mmd, False)
        print(f"{label}rank {r}: micro-step ms from step {after + 1} on "
              f"(host clock, loader included) "
              + " ".join(f"{v:.1f}" for v in post)
              + f", median {med:.1f}; all-reduces a micro-step "
              f"{sum(per.values())} (+1 gradient at each update: "
              f"{json.dumps(per)}), their host ms a micro-step median "
              f"{coll[len(coll) // 2]:.1f}; peak device memory "
              f"{rr[-1]['peak'] / 2**30:.3f} GiB; batch_consistency 0 in "
              f"all {len(rr)} micro-steps")
    slow = max(meds)
    print(f"{label}global: {n_real} real nodes over {len(rows)} rank(s) / "
          f"the slowest rank's median {slow:.1f} ms = "
          f"{n_real / (slow / 1e3):.0f} nodes/s" + (
              " (ranks sharing one card: the collectives' and the host's "
              "overhead, not scaling)" if len(rows) > 1 else ""))
    return meds


def profile_dist_step(fn):
    """One distributed micro-step under torch.profiler: its wall ms, the
    device's kernel time, the collective ops' host time and calls, and the
    top device kernels."""
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
    avgs = prof.key_averages()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in avgs if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    comm = [(e.key, e.cpu_time_total / 1e3, e.count) for e in avgs
            if e.device_type == DeviceType.CPU
            and ("all_reduce" in e.key or "allreduce" in e.key)]
    return {"wall_ms": wall_ms, "device_ms": sum(r[1] for r in rows),
            "comm": comm, "top": rows[:8]}


def dist_check_rank(rank, ws, init_method, cfgs, paths, out_dir,
                    device="cuda"):
    """A rank of phase 9's checks (spawned, over the card): (a) (j1)'s
    first update (its seeded weights, its first batches) with MMD off, for
    the union comparison; (j1) as published: 3 timed micro-steps after its
    first update and one under torch.profiler; (b) an f32 forward of the
    first batch; (c) (j2)'s
    first update with the fused kernels and with their plain versions;
    (d) one forward with edge_impl fused_stack: no stack launch; (e) rank 0
    times both fused kernels at its batch's shape."""
    import itertools

    import torch

    from distegnn_tpu_torch.models.registry import get_model
    from distegnn_tpu_torch.ops import edge_pipeline as ep
    from distegnn_tpu_torch.ops import layer_pipeline as lp
    from distegnn_tpu_torch.parallel.launch import rank_loaders
    from distegnn_tpu_torch.parallel.mesh import (GRAPH_AXIS,
                                                  destroy_graph_group,
                                                  init_graph_group)

    gg = init_graph_group(ws, rank, device, init_method)
    dev = gg.device
    out = {}
    try:
        def first_batches(cfg):
            loader = rank_loaders(cfg, paths, rank, dev)[0]
            loader.set_epoch(1)
            return list(itertools.islice(loader,
                                         cfg.train.accumulation_steps))

        def seeded(cfg):
            return get_model(cfg.model, generator=torch.Generator()
                             .manual_seed(int(cfg.seed))).state_dict()

        cfg = cfgs["union"]
        batches = first_batches(cfg)
        init = seeded(cfg)
        u = first_update(cfg, init, batches, dev, axis_name=GRAPH_AXIS,
                         rank=rank)
        out["union"] = {"loss": u["loss"], "grad": {
            n: g.cpu() for n, g in u["grad"].items()}}
        # (j1) as published: 3 timed micro-steps, one more profiled
        j1 = first_update(cfgs["j1"], init, batches, dev, time_extra=3,
                          profile=True, profiler=profile_dist_step,
                          axis_name=GRAPH_AXIS, rank=rank)
        out["j1"] = {"ms": j1["ms"], "profile": j1["profile"]}
        m32 = get_model(cfgs["f32"].model, axis_name=GRAPH_AXIS)
        m32.load_state_dict(init)
        m32.to(dev)
        with torch.no_grad():
            x, X = m32(batches[0])
        n = int(batches[0].node_mask.sum())
        out["f32"] = {"x": x[0, :n].cpu(), "X": X.cpu()}

        cfg = cfgs["fused"]
        fb = first_batches(cfg)
        init = seeded(cfg)
        k = first_update(cfg, init, fb, dev, axis_name=GRAPH_AXIS, rank=rank)
        p = first_update(cfg, init, fb, dev, patches=fused_plain_patches(),
                         axis_name=GRAPH_AXIS, rank=rank)
        out["fused"] = {key: v for key, v in (("k", k), ("p", p))}
        for v in out["fused"].values():
            v["grad"] = {n: g.cpu() for n, g in v["grad"].items()}
        stack = get_model(cfgs["stack"].model, axis_name=GRAPH_AXIS)
        stack.load_state_dict(init)
        stack.to(dev)
        before = (lp.fused_egnn_stack.launches, ep.fused_edge_layer.launches)
        with torch.no_grad():
            stack(fb[0])
        torch.cuda.synchronize()
        out["stack"] = (lp.fused_egnn_stack.launches - before[0],
                        ep.fused_edge_layer.launches - before[1])
        if rank == 0:
            fused = get_model(cfg.model)
            fused.load_state_dict(init)
            out["kernels"] = flagship_kernel_phase(fused.to(dev), fb[0], dev)
            out["kernels"]["n_real"] = int(fb[0].node_mask.sum())
    finally:
        destroy_graph_group()
    torch.save(out, os.path.join(out_dir, f"check{rank}.pt"))


def union_batches(cfg, paths, dev):
    """The union run's first batches, as many as the ranks' first update
    reads (accumulation_steps, or the epoch's batches if fewer): for each
    train graph of a batch (in the ranks' epoch-1 order) one graph of its
    parts' nodes in rank order (each part Morton-ordered as its rank reads
    it) and their local edges; with the node offsets of each batch's first
    graph's parts."""
    import numpy as np

    from distegnn_tpu_torch.data.loader import GraphDataset
    from distegnn_tpu_torch.ops.graph import pad_graphs

    shards = [GraphDataset(p, node_order=cfg.data.node_order)
              for p in paths[0]]
    B = cfg.data.batch_size
    order = np.random.default_rng([int(cfg.seed), 1]).permutation(
        len(shards[0]))
    batches, offsets = [], []
    for b in range(min(cfg.train.accumulation_steps, len(order) // B)):
        graphs = []
        for i in order[b * B:(b + 1) * B]:
            parts = [s[int(i)] for s in shards]
            off = np.cumsum([0] + [q["loc"].shape[0] for q in parts])
            g = {k: np.concatenate([q[k] for q in parts])
                 for k in ("node_feat", "node_attr", "loc", "vel", "target",
                           "edge_attr")}
            g["edge_index"] = np.concatenate(
                [q["edge_index"] + o for q, o in zip(parts, off)], axis=1)
            g["loc_mean"] = parts[0]["loc_mean"]
            graphs.append(g)
            if len(graphs) == 1:
                offsets.append(off)
        batches.append(pad_graphs(graphs).to(dev))
    return batches, offsets


def dist_phase(root, dev, clouds):
    """Phase 9: distributed training, the flagship config as published over
    graph parts (see the module docstring). Logs, checkpoints and shards go
    to a temporary directory that is removed afterwards."""
    import pickle

    import torch

    from distegnn_tpu_torch.config import load_config

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    flagship = os.path.join(root, "configs", "largefluid_distegnn.yaml")
    with phase_tmp("chip_smoke_dist_") as tmp:
        cfg = load_config(flagship, {
            "data.world_size": DIST_WS, "train.epochs": DIST_EPOCHS, **EAGER,
            "log.log_dir": os.path.join(tmp, "logs")})
        d, m = cfg.data, cfg.model
        print(f"dist config: {d.accelerate_mode} split_mode={d.split_mode} "
              f"outer/inner radius {d.outer_radius}/{d.inner_radius} "
              f"world_size={d.world_size} edge_impl={m.edge_impl} "
              f"segment_impl={m.segment_impl} edge_block={d.edge_block} "
              f"compute_dtype={m.compute_dtype} remat={m.remat} "
              f"mmd={cfg.train.mmd.weight} accumulation="
              f"{cfg.train.accumulation_steps} node_order={d.node_order}")
        dclouds = clouds[:DIST_TRAIN] + clouds[4:]
        paths, part_ms, split_ms = write_dist_shards(
            cfg, dclouds, os.path.join(tmp, "ws4"), DIST_WS)
        print(f"partitioned and wrote {len(dclouds)} clouds ({DIST_TRAIN} / "
              f"1 / 1) x {DIST_WS} parts in {split_ms:.0f} ms (each: the "
              f"outer-radius graph, the labels, {DIST_WS} local inner-radius "
              "graphs)")
        check_partitions(dclouds, paths, part_ms, DIST_WS)
        n_real = clouds[0]["loc"].shape[0]   # a batch: one cloud, all ranks
        per = micro_step_collectives(cfg.model.n_layers, cfg.model.remat,
                                     bool(cfg.train.mmd.weight), False)
        check(sum(per.values()) == 64, f"the flagship micro-step's "
              f"all-reduces {per} are not 64 (63 of the step + the stop "
              "agreement)")
        j1_meds = dist_j1(cfg, paths, dev, tmp, n_real)
        res = dist_checks(flagship, paths, dev, tmp)
        launches = dist_j2(flagship, paths, dev, tmp, n_real, res,
                           cfg.model.n_layers)
        j0_meds = dist_j0(flagship, clouds, dev, tmp, n_real)
        with open(paths[0][0], "rb") as f:
            part = pickle.load(f)[0]   # rank 0's part of the first cloud
    print(f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "kernels": res[0]["kernels"], "part": part,
            "j1_ms": j1_meds, "j0_ms": j0_meds}


def dist_j1(cfg, paths, dev, tmp, n_real):
    """(j1): the config as published at 4 ranks sharing the card."""
    import copy

    from distegnn_tpu_torch.parallel.launch import run_distributed

    probe_dir = os.path.join(tmp, "probe_j1")
    os.makedirs(probe_dir)
    t0 = time.perf_counter()
    print_mode("phase 9 (j1) ", cfg)
    best = run_distributed(copy.deepcopy(cfg), split_paths=paths, device=dev,
                           on_step=StepProbe(probe_dir))
    print(f"(j1) run_distributed: {DIST_WS} ranks x {DIST_EPOCHS} epochs in "
          f"{time.perf_counter() - t0:.1f} s (spawn and loading included); "
          f"best {json.dumps(best)}; parameters bitwise equal across the "
          f"ranks at the start and the end (run_distributed's broadcast and "
          f"compare)")
    check(math.isfinite(best["loss_valid"]), "(j1) non-finite eval loss")
    rows = read_probe(probe_dir, DIST_WS)
    check(all(len(r) == DIST_EPOCHS * DIST_TRAIN for r in rows),
          "(j1) missing micro-steps")
    check(all(r[-1]["fwd"] == 0 and r[-1]["stack"] == 0 for r in rows),
          "(j1) the plain path launched a fused kernel")
    return report_dist_run("(j1) ", cfg, rows, n_real,
                           {"layout": 3, "replicated": 1})


def dist_checks(flagship, paths, dev, tmp):
    """The spawned checks (:func:`dist_check_rank`), then in this process
    the union run: (j1)'s first update with MMD off against the parts'
    union (the aggregate bounds of phases 5 and 6), and the f32 forward
    (1e-5 of scale). Returns the ranks' results."""
    import copy

    import torch

    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.models.registry import get_model

    def cfg_of(over):
        return load_config(flagship, dict({"data.world_size": DIST_WS,
                                           **EAGER}, **over))

    cfgs = {"j1": cfg_of({}), "union": cfg_of({"train.mmd.weight": 0.0}),
            "fused": cfg_of({"model.edge_impl": "fused",
                             "data.edge_block": BLOCK}),
            "stack": cfg_of({"model.edge_impl": "fused_stack",
                             "data.edge_block": BLOCK})}
    cfgs["f32"] = copy.deepcopy(cfgs["union"])
    cfgs["f32"].model.compute_dtype = None
    check_dir = os.path.join(tmp, "checks")
    os.makedirs(check_dir)
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        dist_check_rank, args=(DIST_WS, "file://" + os.path.join(
            check_dir, "store"), cfgs, paths, check_dir, dev.type),
        nprocs=DIST_WS, join=True, start_method="spawn")
    res = [torch.load(os.path.join(check_dir, f"check{r}.pt"),
                      weights_only=False) for r in range(DIST_WS)]
    print(f"checks: {DIST_WS} ranks in {time.perf_counter() - t0:.1f} s")
    for r, rr in enumerate(res):
        ms, pr = sorted(rr["j1"]["ms"]), rr["j1"]["profile"]
        print(f"(j1) rank {r}: micro-step ms (synchronised, step only, "
              f"after the first update) " + " ".join(f"{v:.1f}" for v in ms)
              + f"; one micro-step under torch.profiler: wall "
              f"{pr['wall_ms']:.1f} ms, device kernel time "
              f"{pr['device_ms']:.1f} ms (busy {pr['device_ms'] / pr['wall_ms']:.4f}), "
              f"collective ops (host time, calls): " + ", ".join(
                  f"{k} {v:.1f} ms x{n}" for k, v, n in pr["comm"]))
    for key, ms, n in res[0]["j1"]["profile"]["top"]:
        print(f"(j1) rank 0 profiled kernel: {ms:.3f} ms x{n} {key[:80]}")
    for r, rr in enumerate(res):
        for n, g in rr["union"]["grad"].items():
            check(torch.equal(g, res[0]["union"]["grad"][n]),
                  f"rank {r}: the summed gradient of {n} differs")

    ucfg = cfgs["union"]
    init = get_model(ucfg.model, generator=torch.Generator().manual_seed(
        int(ucfg.seed))).state_dict()
    ub, offs = union_batches(ucfg, paths, dev)
    uu = first_update(ucfg, init, ub, dev)
    uu["grad"] = {n: g.cpu() for n, g in uu["grad"].items()}
    ru = res[0]["union"]
    errs, per = update_distance(dict(ru, loss_with_mmd=ru["loss"]),
                                dict(uu, loss_with_mmd=uu["loss"]))
    gmax = max(float(g.abs().max()) for g in uu["grad"].values())
    worst = sorted(per.items(), key=lambda kv: -kv[1])
    print(f"(j1) first update (MMD off) of {DIST_WS} ranks vs the union "
          f"graph in one process: losses {ru['loss']} vs {uu['loss']} (max "
          f"rel err {errs['loss']:.3e}); gradient norm rel err "
          f"{errs['grad norm']:.3e}, max abs err / max abs {errs['grad']:.3e}"
          f", l2 {errs['grad l2']:.3e} (tol {TOL_TRAIN:.0e} each); per "
          f"tensor, error over its own max, worst 4: " + ", ".join(
              f"{n} {v:.3e} (its max {float(uu['grad'][n].abs().max()) / gmax:.2e}"
              f" of the gradient's)" for n, v in worst[:4]))
    check(all(errs[key] <= TOL_TRAIN for key in ("loss", "grad norm",
                                                 "grad", "grad l2")),
          "(j1) the distributed update disagrees with the union graph's")

    m32 = get_model(cfgs["f32"].model)
    m32.load_state_dict(init)
    m32.to(dev)
    with torch.no_grad():
        x, X = m32(ub[0])
    x, o = x[0].cpu(), offs[0]
    scale = float(x.abs().max())
    e_x = max(float((rr["f32"]["x"] - x[o[r]:o[r + 1]]).abs().max())
              for r, rr in enumerate(res))
    e_X = max(float((rr["f32"]["X"] - X.cpu()).abs().max()) for rr in res)
    print(f"(j1) f32 forward of {DIST_WS} ranks vs the union graph: max abs "
          f"err {e_x:.3e} of max |x| {scale:.3f}, virtual {e_X:.3e} (tol "
          f"{TOL_UNION_F32:.0e} of scale)")
    check(e_x <= TOL_UNION_F32 * scale and e_X <= TOL_UNION_F32 * float(
        X.abs().max()), "(j1) the f32 forward disagrees with the union's")
    return res


def dist_j2(flagship, paths, dev, tmp, n_real, res, L):
    """(j2): model.edge_impl fused, data.edge_block 512, one epoch; exact
    launches per rank, then the checks' first updates (kernels vs plain
    versions) and fused_stack under the axis. Returns the run's (forward,
    backward) launches over all ranks."""
    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.parallel.launch import run_distributed

    cfg2 = load_config(flagship, {
        "data.world_size": DIST_WS, "model.edge_impl": "fused", **EAGER,
        "data.edge_block": BLOCK, "train.epochs": 1,
        "log.log_dir": os.path.join(tmp, "logs")})
    probe_dir = os.path.join(tmp, "probe_j2")
    os.makedirs(probe_dir)
    t0 = time.perf_counter()
    print_mode("phase 9 (j2) ", cfg2)
    run_distributed(cfg2, split_paths=paths, device=dev,
                    on_step=StepProbe(probe_dir))
    rows2 = read_probe(probe_dir, DIST_WS)
    print(f"(j2) run_distributed fused: {DIST_WS} ranks x 1 epoch in "
          f"{time.perf_counter() - t0:.1f} s (no evaluation: test_interval "
          f"{cfg2.log.test_interval})")
    micro = DIST_TRAIN
    want_fwd, want_bwd = 2 * L * micro, L * micro
    for r, rr in enumerate(rows2):
        last = rr[-1]
        print(f"(j2) rank {r}: fused_edge_fwd {last['fwd']} (expected {L} "
              f"layers x {micro} micro-steps x 2 (remat) = {want_fwd}; "
              f"{last['tc']} on the tensor cores), fused_edge_bwd "
              f"{last['bwd']} (expected {want_bwd}), fused_stack_fwd "
              f"{last['stack']}")
        check(len(rr) == micro and last["fwd"] == want_fwd
              and last["tc"] == want_fwd and last["bwd"] == want_bwd
              and last["stack"] == 0, f"(j2) rank {r}: launch counts")
    report_dist_run("(j2) ", cfg2, rows2, n_real,
                    {"layout": 6, "replicated": 1})
    acc = cfg2.train.accumulation_steps    # the first update's micro-steps
    for r, rr in enumerate(res):
        k, p = rr["fused"]["k"], rr["fused"]["p"]
        check(k["launches"] == (2 * L * acc, L * acc)
              and p["launches"] == (0, 0),
              f"rank {r}: first update launches {k['launches']} / "
              f"{p['launches']}")
        errs, per = update_distance(k, p)
        worst = sorted(per.items(), key=lambda kv: -kv[1])
        print(f"(j2) rank {r} first update, kernels vs plain versions: "
              f"losses max rel err "
              f"{max(errs['loss'], errs['loss_with_mmd']):.3e}, gradient "
              f"norm {errs['grad norm']:.3e}, max {errs['grad']:.3e} (tol "
              f"{TOL_TRAIN:.0e}); worst tensor {worst[0][0]} "
              f"{worst[0][1]:.3e} (tol {TOL_PARAM:.3e})")
        check(all(errs[key] <= TOL_TRAIN for key in ("loss_with_mmd", "loss",
                                                     "grad norm", "grad")),
              f"(j2) rank {r}: the kernels disagree with the plain versions")
        check(worst[0][1] <= TOL_PARAM,
              f"(j2) rank {r}: the gradient of {worst[0][0]} disagrees")
        check(rr["stack"] == (0, L), f"rank {r}: edge_impl fused_stack under "
              f"the graph axis launched {rr['stack']} (stack, "
              f"fused_edge_fwd), expected (0, {L})")
    print(f"(j2) edge_impl fused_stack under the graph axis, one forward a "
          f"rank: 0 fused_stack_fwd launches, {L} fused_edge_fwd (the "
          f"per-layer fused path)")
    return (sum(r[-1]["fwd"] for r in rows2),
            sum(r[-1]["bwd"] for r in rows2))


def dist_j0(flagship, clouds, dev, tmp, n_real):
    """(j0): the config as published with the world size derived from the
    card count (one rank on a one-card machine, over nccl), one epoch."""
    import pickle

    import torch

    from distegnn_tpu_torch.config import derive_runtime_fields, load_config
    from distegnn_tpu_torch.parallel.collectives import all_reduce
    from distegnn_tpu_torch.parallel.launch import run_distributed
    from distegnn_tpu_torch.parallel.mesh import backend_for

    cfg0 = derive_runtime_fields(load_config(
        flagship, {"train.epochs": 1, **EAGER,
                   "log.log_dir": os.path.join(tmp, "logs")}))
    ws0 = cfg0.data.world_size
    check(ws0 == max(1, torch.cuda.device_count()),
          "(j0) world size not derived from the card count")
    backend = backend_for(ws0, dev.type)
    if dev.type == "cuda":
        check(backend == "nccl", f"(j0) {ws0} rank(s) on "
              f"{torch.cuda.device_count()} card(s) would not take nccl")
    # one part a graph: the cloud itself (its edges are the inner-radius
    # graph, FLUID_RADIUS), as split_graph would rebuild it
    check(ws0 == 1 and cfg0.data.inner_radius == FLUID_RADIUS,
          "(j0) expects one rank and the clouds' radius")
    paths1 = []
    for split, graphs in (("train", clouds[:4]), ("valid", clouds[4:5]),
                          ("test", clouds[5:])):
        path = os.path.join(tmp, f"fluid_{split}_0-1.pkl")
        with open(path, "wb") as f:
            pickle.dump([dict(g, loc_mean=g["loc"].mean(axis=0).astype(
                "float32")) for g in graphs], f)
        paths1.append([path])
    probe_dir = os.path.join(tmp, "probe_j0")
    os.makedirs(probe_dir)
    # the rank runs in this process: its collective counts start from 0
    all_reduce.counts.clear()
    all_reduce.seconds.clear()
    t0 = time.perf_counter()
    print_mode("phase 9 (j0) ", cfg0)
    run_distributed(cfg0, split_paths=paths1, device=dev,
                    on_step=StepProbe(probe_dir))
    print(f"(j0) run_distributed at world size {ws0} (derived: "
          f"{torch.cuda.device_count()} card), backend {backend}: 1 epoch "
          f"in {time.perf_counter() - t0:.1f} s")
    return report_dist_run("(j0) ", cfg0, read_probe(probe_dir, ws0),
                           n_real, {"layout": 3, "replicated": 1})


# ------------------------------------------------ phase 10: the preemption drill

# the flagship (cell d) over phase 5's clouds: 2 epochs of 4 micro-steps, an
# evaluation after each; B's SIGTERM comes after micro-step 2 of epoch 2
# (the run's 7th: micro 3 of the 4-step accumulation)
PREEMPT_EPOCHS = 2
PREEMPT_AT = (2, 2)


class PreemptProbe:
    """``on_step`` of a phase-10 run: after each micro-step, synchronised,
    its (epoch, step), the host time and the fused kernels' launches so
    far; SIGTERM to this process after micro-step ``kill_at``."""

    def __init__(self, kill_at=None):
        self.kill_at, self.rows = kill_at, []

    def __call__(self, epoch, step, metrics):
        import signal

        import torch

        from distegnn_tpu_torch.ops import edge_pipeline as ep

        torch.cuda.synchronize()
        self.rows.append({"at": (epoch, step), "t": time.perf_counter(),
                          "counts": (ep.fused_edge_layer.launches,
                                     ep.fused_edge_layer.bwd_launches,
                                     ep.fused_edge_layer.tc_launches)})
        if (epoch, step) == self.kill_at:
            os.kill(os.getpid(), signal.SIGTERM)

    def gaps(self, epoch=None):
        """Host ms between consecutive micro-steps of one epoch (of
        ``epoch`` only, when given)."""
        return [(b["t"] - a["t"]) * 1e3 for a, b in
                zip(self.rows, self.rows[1:]) if a["at"][0] == b["at"][0]
                and epoch in (None, a["at"][0])]


def train_snapshot(state):
    """CPU copies of a TrainState's parameters, Adam state, accumulated
    gradients and counters."""
    opt = state.optimizer
    return {"params": {k: v.detach().cpu().clone() for k, v in
                       state.model.state_dict().items()},
            "adam": [{k: v.detach().cpu().clone() for k, v in
                      opt.adam.state[p].items()} for p in opt.params],
            "grads": [None if p.grad is None else p.grad.detach().cpu()
                      .clone() for p in opt.params],
            "counts": (opt.micro, opt.updates, state.step)}


def snapshots_equal(a, b):
    """The names of what differs between two train_snapshots (bitwise)."""
    bad = [k for k, v in a["params"].items()
           if not torch_equal(v, b["params"][k])]
    for i, (x, y) in enumerate(zip(a["adam"], b["adam"])):
        if x.keys() != y.keys() or any(not torch_equal(x[k], y[k])
                                       for k in x):
            bad.append(f"adam[{i}]")
    for i, (x, y) in enumerate(zip(a["grads"], b["grads"])):
        if (x is None) != (y is None) or (x is not None
                                          and not torch_equal(x, y)):
            bad.append(f"grad[{i}]")
    if a["counts"] != b["counts"]:
        bad.append(f"(micro, updates, step) {a['counts']} != {b['counts']}")
    return bad


def torch_equal(a, b):
    import torch

    return torch.equal(a, b)


def run_events(cfg):
    """(names, records) of a run's events.jsonl."""
    path = os.path.join(cfg.log.log_dir, cfg.log.exp_name, "obs",
                        "events.jsonl")
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r["name"] for r in recs], recs


def preempt_phase(root, dev, clouds):
    """Phase 10: the preemption drill on the card (see the module
    docstring). Logs, checkpoints, events and traces go to a temporary
    directory that is removed afterwards."""
    with phase_tmp("chip_smoke_preempt_") as tmp:
        return _preempt_phase(root, dev, clouds, tmp)


def _preempt_phase(root, dev, clouds, tmp):
    import torch

    from distegnn_tpu_torch import main as pmain
    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.ops import edge_pipeline as ep

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    flagship = os.path.join(root, "configs", "largefluid_distegnn.yaml")

    def config(name, log_dir, **over):
        ov = {"model.edge_impl": "fused", "data.edge_block": BLOCK,
              "data.accelerate_mode": "cutoff_edges",
              "train.epochs": PREEMPT_EPOCHS, "log.test_interval": 1,
              "train.checkpoint_interval_s": 1e-9,
              "train.keep_checkpoints": 2,
              "log.trace_epoch": PREEMPT_EPOCHS,
              "log.log_dir": os.path.join(tmp, log_dir),
              "log.exp_name": name}
        ov.update(over)
        return load_config(flagship, {**ov, **EAGER})

    ds = fluid_datasets(clouds, "none")

    def drive(cfg, kill_at=None):
        probe = PreemptProbe(kill_at)
        reset_fused_counts()
        t0 = time.perf_counter()
        print_mode("phase 10 ", cfg)
        state, best, _ = pmain.run(cfg, *ds, device=dev, on_step=probe)
        wall = time.perf_counter() - t0
        counts = (ep.fused_edge_layer.launches,
                  ep.fused_edge_layer.bwd_launches,
                  ep.fused_edge_layer.tc_launches)
        return state, best, probe, counts, wall

    cfg_a = config("A", "a")
    m = cfg_a.model
    print(f"preempt drill config: H={m.hidden_nf} L={m.n_layers} "
          f"C={m.virtual_channels} compute_dtype={m.compute_dtype} "
          f"remat={m.remat} edge_impl={m.edge_impl} accumulation_steps="
          f"{cfg_a.train.accumulation_steps} epochs={cfg_a.train.epochs} "
          f"test_interval 1, a cadence save after every micro-step "
          f"(checkpoint_interval_s {cfg_a.train.checkpoint_interval_s}), "
          f"keep_checkpoints {cfg_a.train.keep_checkpoints}, trace_epoch "
          f"{cfg_a.log.trace_epoch}")
    a, best_a, probe_a, counts_a, wall_a = drive(cfg_a)
    a2, _, probe_a2, _, _ = drive(config("A2", "a2"))
    cfg_b = config("B", "b")
    b, best_b, probe_b, _, wall_b = drive(cfg_b, PREEMPT_AT)
    snap_b = train_snapshot(b)
    del b
    restored = {}
    real_resolve = pmain.resolve_resume

    def resolve(config, state):
        rr = real_resolve(config, state)
        if rr is not None:
            restored["snap"] = train_snapshot(rr.state)
            restored["rr"] = rr
        return rr

    cfg_c = config("C", "b", **{"train.resume": "auto"})
    with mock.patch.object(pmain, "resolve_resume", resolve):
        c, best_c, probe_c, counts_c, wall_c = drive(cfg_c)
    d, _, probe_d, _, _ = drive(config("D", "d", **{"obs.enable": False}))
    print(f"phase 10 runs: A {wall_a:.1f} s, B {wall_b:.1f} s (preempted), "
          f"C {wall_c:.1f} s (resumed), A2 and D (obs off) alike")

    # B: the preempt checkpoint, the marker and the rotation
    L, k = m.n_layers, cfg_a.train.accumulation_steps
    steps_a = [r["at"] for r in probe_a.rows]
    n_micro = PREEMPT_EPOCHS * len(ds[0])
    check(steps_a == [(e, s) for e in range(1, PREEMPT_EPOCHS + 1)
                      for s in range(len(ds[0]))], f"A's steps {steps_a}")
    at_b = [r["at"] for r in probe_b.rows]
    check(at_b == steps_a[:steps_a.index(PREEMPT_AT) + 1],
          f"B ran {at_b}, not up to {PREEMPT_AT}")
    pre = best_b.get("preempted") or {}
    ckpt_b = os.path.join(tmp, "b", "B", "state_dict")
    with open(os.path.join(ckpt_b, "PREEMPTED")) as f:
        marker = json.load(f)
    files = sorted(os.listdir(ckpt_b))
    step_files = [x for x in files if x.startswith("step_")]
    print(f"B preempted after micro-step {len(at_b)} ({PREEMPT_AT}, micro "
          f"{snap_b['counts'][0]} of {k}): marker {json.dumps(marker)}; "
          f"files {files}")
    check((pre.get("epoch"), pre.get("step_in_epoch")) == (1, 3)
          and (marker["checkpoint"], marker["epoch"],
               marker["step_in_epoch"]) == ("preempt_model.ckpt", 1, 3),
          f"B's preemption record {pre} / marker {marker}")
    check(snap_b["counts"][0] == 3, "B's signal did not land at micro 3")
    check("preempt_model.ckpt" in files and 0 < len(step_files)
          <= cfg_b.train.keep_checkpoints,
          f"B's checkpoint directory {files}")

    # C: the restored state is B's at the signal, the replayed coordinates
    bad = snapshots_equal(snap_b, restored.get("snap") or {"params": {},
                                                           "adam": [],
                                                           "grads": [],
                                                           "counts": None})
    rr = restored.get("rr")
    check(rr is not None and rr.path.endswith("preempt_model.ckpt"),
          "C did not restore B's preempt checkpoint")
    print(f"C restored {rr.path} (epoch {rr.epoch} + {rr.step_in_epoch} "
          f"steps, seed {rr.seed}); against B's state at the signal: "
          f"parameters, Adam moments, accumulated gradients, micro, updates "
          f"and step {'bitwise equal' if not bad else 'DIFFER: ' + str(bad)}")
    check(not bad, f"C's restored state differs from B's: {bad}")
    at_c = [r["at"] for r in probe_c.rows]
    want_c = steps_a[len(at_b):]
    print(f"C replayed {at_c} (A's remaining coordinates {want_c})")
    check(at_c == want_c, "C did not replay A's remaining coordinates")

    # C's final parameters against A's, with A2 for the card's spread
    def params(state):
        return {kk: v.detach().float().cpu() for kk, v in
                state.model.state_dict().items()}

    pa, pa2, pc = params(a), params(a2), params(c)
    spread = max(float((pa2[kk] - v).abs().max()) for kk, v in pa.items())
    scale = max(float(v.abs().max()) for v in pa.values())
    dist_c = max(float((pc[kk] - v).abs().max()) for kk, v in pa.items())
    bound = 2 * spread + 1e-6 * scale
    print(f"final parameters: max |A2 - A| {spread:.3e} (the card's "
          f"run-to-run spread), max |C - A| {dist_c:.3e}, bound 2 x spread "
          f"+ 1e-6 x max |A| ({scale:.4g}) = {bound:.3e}")
    check(dist_c <= bound, "the resumed run's parameters are off A's")

    # launches: A's exact counts, and C's equal to A's for the steps C ran
    evals = PREEMPT_EPOCHS * (len(ds[1]) + len(ds[2]))
    want_a = (L * n_micro * 2 + L * evals, L * n_micro)
    check(counts_a[:2] == want_a and counts_a[2] == counts_a[0],
          f"A's launches {counts_a}, expected fwd/bwd {want_a}, all "
          "forwards on the tensor-core kernel")
    rows_a = probe_a.rows
    i0 = len(at_b) - 1
    after_c = tuple(fin - r for fin, r in zip(counts_a,
                                              rows_a[i0]["counts"]))
    print(f"fused launches: A {counts_a} (fwd, bwd, tensor-core fwd; "
          f"expected fwd {want_a[0]} = {L} x {n_micro} x 2 + {L} x "
          f"{evals}, bwd {want_a[1]}), C {counts_c}, A's for C's steps and "
          f"its evaluation {after_c}")
    check(counts_c == after_c and counts_c[0] > 0 and counts_c[1] > 0,
          "C's fused launches differ from A's for the same steps")

    # the events
    for label, cfg, extra, n_steps in (
            ("A", cfg_a, (), n_micro), ("B", cfg_b, ("train/preempt",),
                                        len(at_b)),
            ("C", cfg_c, ("train/resume", "ckpt/restore"), len(at_c))):
        names, recs = run_events(cfg)
        need = ("train/run_start", "train/epoch", "train/eval",
                "ckpt/save", "ckpt/rotate", "jax/memory") + extra
        missing = [x for x in need if x not in names]
        mem = [r.get("peak_bytes_in_use", 0) for r in recs
               if r["name"] == "jax/memory"]
        print(f"{label} events: {len(recs)} records, {names.count('train/step')}"
              f" train/step, memory events' CUDA peak bytes {mem}")
        check(not missing and names.count("train/step") == n_steps
              and mem and all(v > 0 for v in mem),
              f"{label}'s events: missing {missing}, steps "
              f"{names.count('train/step')} of {n_steps}, memory {mem}")
    check(not os.path.exists(os.path.join(tmp, "d", "D", "obs")),
          "obs.enable: false wrote events")
    _, recs_a = run_events(cfg_a)
    saves = [r for r in recs_a if r["name"] == "ckpt/save"
             and r["path"].startswith("step_")]
    save_ms = sorted(1e3 * r["dur_s"] for r in saves)
    _, recs_c = run_events(cfg_c)
    (rest,) = [r for r in recs_c if r["name"] == "ckpt/restore"]
    events_a = os.path.join(tmp, "a", "A", "obs", "events.jsonl")
    out = subprocess.run([sys.executable, "-m",
                          "distegnn_tpu_torch.obs.report", events_a,
                          "--check"], capture_output=True, text=True,
                         cwd=root, timeout=120)
    print("obs report of A's events:\n" + out.stdout.rstrip())
    check(out.returncode == 0 and f"steps: {n_micro}" in out.stdout,
          f"the obs report failed: {out.stderr.strip()}")

    # A's trace of epoch 2 names both fused kernels
    trace = os.path.join(tmp, "a", "A", "trace",
                         f"epoch{PREEMPT_EPOCHS}.json")
    with open(trace) as f:
        text = f.read()
    found = {name: name in text for name in ("fused_edge_fwd_tc_kernel",
                                             "fused_edge_bwd_tc_kernel")}
    print(f"A's trace {os.path.basename(trace)}: {len(text)} bytes; "
          f"kernels named: {found}")
    check(all(found.values()), f"the trace lacks a fused kernel: {found}")

    smi = nvidia_smi()
    med = {}

    def median(v):
        v = sorted(v)
        return v[len(v) // 2]

    for label, probe in (("A", probe_a), ("A2", probe_a2),
                         ("D (obs off)", probe_d)):
        med[label] = median(probe.gaps())
        print(f"phase 10 {label}: micro-step ms in the trainer (host clock; "
              f"the cadence save included, epoch 1 the loader's first pass, "
              f"epoch {PREEMPT_EPOCHS} the profiler): " + " ".join(
                  f"{v:.1f}" for v in probe.gaps())
              + f", median {med[label]:.3f}, epoch 1 "
              f"{median(probe.gaps(1)):.3f}, epoch {PREEMPT_EPOCHS} "
              f"{median(probe.gaps(PREEMPT_EPOCHS)):.3f} [{smi}]")
    print(f"phase 10 checkpoint: {rest['bytes']} bytes a flagship "
          f"checkpoint with its whole optimizer state (B's preempt "
          f"checkpoint: parameters, Adam moments, accumulated gradient), "
          f"restore ms {1e3 * rest['dur_s']:.3f} (verify + torch.load + "
          f"load into the card's model); A's cadence saves "
          f"{min(r['bytes'] for r in saves)}-"
          f"{max(r['bytes'] for r in saves)} bytes, save ms (state to the "
          f"host + torch.save + fsync + manifest) median "
          f"{save_ms[len(save_ms) // 2]:.3f} of {len(save_ms)} (min "
          f"{save_ms[0]:.3f} max {save_ms[-1]:.3f}) [{smi}]")
    print(f"phase 10 obs: micro-step median A {med['A']:.3f} / A2 "
          f"{med['A2']:.3f} ms with events, D {med['D (obs off)']:.3f} ms "
          f"without [{smi}]")
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": counts_a, "resumed_launches": counts_c,
            "spread": spread, "dist": dist_c}


# ------------------------------------------------ phase 11: Water-3D, protein

# Water-3D: the published mean of ~7806 particles a trajectory
# (docs/DATASETS.md) at ~94931 edges a frame within the 0.035 radius
# (SURVEY.md); the synthetic cloud's expected neighbours (13.2, boundary
# losses included) gives that density
W3D_N = 7806
W3D_DEGREE = 13.2
W3D_FRAMES = 45
W3D_TRAJS = 2
# the cuts of depth: 15 frames a split (one batch of the published 15) in
# cutoff mode, 8 (two batches of 4) in distribute mode
W3D_SAMPLES = 15
W3D_DIST_SAMPLES = 8
# AdK: 214 residues x 4 backbone atoms, less the last O: the published 855
ADK_FRAMES, ADK_RES = 4200, 214
ADK_SAMPLES = 50
# timed micro-steps after a first update
DATA_TIMED = 3
# (d): the test MSE of the same weights on the rotated / translated test
# split over the plain one's, |a - b| / b. Derived: rounding the moved
# inputs to f32 shifts each coordinate by <= 2^-24 of max |x| (~50 A, ~80 A
# after a shift of half the box): ~5e-6 A; four f32 layers carry at most
# ~2x that into a prediction, |de| <= 1e-5 A. The MSE moves by 2 mean(e de)
# <= 2 |de| rms(e), i.e. by 2 |de| / rms(e) of itself; with rms(e) >= 0.2 A
# (the synthetic backbone's motion over delta_t = 15 frames) that is 1e-4,
# the bound (rounding errors of random sign give ~1e-7). An edge that flips
# at the 10 A cutoff moves two atoms by ~1e-3 x 10 A / ~60 neighbours:
# ~1e-8 of the split's MSE.
TOL_DATA_EQUIV = 1e-4


def water3d_traj(rng, n, frames, radius, degree):
    """One synthetic trajectory in the scheme of
    scripts/generate_water3d_synthetic.py: a damped falling particle cloud
    in a box sized for ``degree`` neighbours within ``radius`` [T, n, 3]."""
    import numpy as np

    vol = n * (4.0 / 3.0) * np.pi * radius ** 3 / degree
    side = vol ** (1.0 / 3.0)
    pos = rng.uniform(0, side, size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 0.02
    g = np.array([0.0, 0.0, -0.05], np.float32)
    out = []
    for _ in range(frames):
        vel = (0.99 * vel + g * 0.01
               + rng.normal(size=(n, 3)).astype(np.float32) * 2e-3)
        pos = pos + vel * 0.02
        vel = np.where((pos < 0) | (pos > side), -0.5 * vel, vel)
        pos = np.clip(pos, 0, side)
        out.append(pos.copy())
    return np.stack(out)


def write_water3d(data_dir, seed):
    """``<data_dir>/Water-3D/{train,valid,test}.h5``, W3D_TRAJS trajectories
    each (the port's HDF5 writer: the machine may lack h5py)."""
    import numpy as np

    from distegnn_tpu_torch.data.hdf5 import write_groups

    rng = np.random.default_rng(seed)
    base = os.path.join(data_dir, "Water-3D")
    os.makedirs(base)
    for split in ("train", "valid", "test"):
        write_groups(os.path.join(base, f"{split}.h5"), {
            f"traj_{k}": {"particle_type": np.full((W3D_N,), 5.0),
                          "position": water3d_traj(rng, W3D_N, W3D_FRAMES,
                                                   0.035, W3D_DEGREE)}
            for k in range(W3D_TRAJS)})
    return data_dir


def write_adk(data_dir, seed):
    """``<data_dir>/protein/adk_backbone.npz`` in the scheme of
    scripts/generate_adk_synthetic.py: a compact random-walk backbone (N,
    CA, C, O a residue) moved by 12 smooth collective modes and jitter,
    CHARMM-like charges, an 80 A box."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = np.zeros((ADK_RES, 3))
    d = rng.standard_normal(3)
    d /= np.linalg.norm(d)
    for i in range(1, ADK_RES):
        d = 0.7 * d + 0.6 * rng.standard_normal(3)
        d -= 0.004 * centers[i - 1]
        d /= np.linalg.norm(d)
        centers[i] = centers[i - 1] + 3.8 * d
    centers -= centers.mean(axis=0)
    centers *= 34.0 / np.abs(centers).max()
    offsets = np.array([[-1.2, 0.4, 0.0], [0.0, 0.0, 0.0], [1.3, 0.2, 0.3],
                        [1.8, -0.9, 0.7]])
    x0 = (centers[:, None] + offsets[None]).reshape(-1, 3)[:-1]
    n = x0.shape[0]
    res = np.arange(n) // 4
    t = np.arange(ADK_FRAMES, dtype=np.float64)
    pos = np.broadcast_to(x0, (ADK_FRAMES, n, 3)).copy()
    for k in range(12):
        period, amp = rng.uniform(60.0, 1200.0), rng.uniform(0.4, 1.8)
        phase = rng.uniform(0, 2 * np.pi)
        spatial = np.sin((k + 1) * np.pi * res / ADK_RES
                         + rng.uniform(0, 2 * np.pi))
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        wave = amp * np.sin(2 * np.pi * t / period + phase)
        pos += wave[:, None, None] * spatial[None, :, None] * axis
    pos += 0.05 * rng.standard_normal(pos.shape)
    charges = (np.tile([-0.47, 0.07, 0.51, -0.51], ADK_RES)[:n]
               + rng.normal(0, 0.02, n))
    base = os.path.join(data_dir, "protein")
    os.makedirs(base)
    np.savez_compressed(os.path.join(base, "adk_backbone.npz"),
                        positions=pos.astype(np.float32),
                        charges=charges.astype(np.float32),
                        dimensions=np.full(3, 80.0, np.float32))
    return data_dir


def print_cuts(label, cfg, over):
    d, m, t = cfg.data, cfg.model, cfg.train
    print(f"{label}config: {d.dataset_name} {d.accelerate_mode} H="
          f"{m.hidden_nf} L={m.n_layers} C={m.virtual_channels} batch "
          f"{d.batch_size} radius {d.radius} delta_t {d.delta_t} "
          f"edge_impl {m.edge_impl} edge_block {d.edge_block} "
          f"compute_dtype {m.compute_dtype} remat {m.remat} mmd "
          f"{dict(t.mmd)} accumulation {t.accumulation_steps}; cut: "
          + ", ".join(f"{k} {v}" for k, v in over.items()
                      if k in ("data.max_samples", "train.epochs")))


def timed_preprocess(label, fn, n_frames):
    t0 = time.perf_counter()
    out = fn()
    ms = (time.perf_counter() - t0) * 1e3
    print(f"{label}preprocessing: {n_frames} frames in {ms:.0f} ms, "
          f"{ms / n_frames:.1f} ms a frame (host)")
    return out, ms / n_frames


def data_phase(root, dev):
    """Phase 11: the Water-3D and protein configs as published, on synthetic
    raw files in their published layout and per-frame size. Files, logs and
    shards go to a temporary directory that is removed afterwards."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with phase_tmp("chip_smoke_data_") as tmp:
        t0 = time.perf_counter()
        w3d = write_water3d(os.path.join(tmp, "simulate"), 11)
        adk = write_adk(os.path.join(tmp, "mdanalysis"), 12)
        print(f"phase 11 raw files: Water-3D {W3D_TRAJS} trajectories x "
              f"[{W3D_FRAMES}, {W3D_N}, 3] a split (the port's HDF5 writer), "
              f"AdK [{ADK_FRAMES}, {4 * ADK_RES - 1}, 3] npz, in "
              f"{time.perf_counter() - t0:.1f} s")
        out = water3d_cutoff_phase(root, dev, w3d, tmp)
        out["dist"] = water3d_dist_phase(root, dev, w3d, tmp)
        out["protein"] = protein_phase(root, dev, adk, tmp)
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return out


def water3d_cutoff_phase(root, dev, data_dir, tmp):
    """(a) configs/water3d_fastegnn.yaml as published, 2 epochs; (b) +
    edge_impl fused, edge_block 512, 1 epoch, exact launches, the first
    update with the plain versions."""
    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.data.loader import GraphDataset
    from distegnn_tpu_torch.main import process_dataset_edge_cutoff
    from distegnn_tpu_torch.ops import edge_pipeline as ep

    path = os.path.join(root, "configs", "water3d_fastegnn.yaml")
    over = {"data.data_dir": data_dir, "data.max_samples": W3D_SAMPLES,
            "train.epochs": 2, "log.log_dir": os.path.join(tmp, "logs")}
    cfg = load_config(path, {**over, **EAGER})
    print_cuts("(a) ", cfg, over)
    files, prep_ms = timed_preprocess(
        "(a) ", lambda: process_dataset_edge_cutoff(cfg.data, seed=cfg.seed),
        3 * W3D_SAMPLES)

    def datasets():
        return [GraphDataset(f, node_order=cfg.data.node_order)
                for f in files]

    ds = datasets()
    e = [g["edge_index"].shape[1] for d in ds for g in d.graphs]
    n = [g["loc"].shape[0] for d in ds for g in d.graphs]
    print(f"(a) frames {len(ds[0])}/{len(ds[1])}/{len(ds[2])}, {n[0]} "
          f"particles, edges a frame {min(e)}..{max(e)} (mean "
          f"{sum(e) / len(e):.0f}; published ~94931)")

    init_sd, _, counts, _, _ = drive_train(cfg, ds, dev, reset_fused_counts,
                                           fused_counts, "(a) ")
    check(counts == (0, 0), f"(a) the plain path launched {counts}")
    _, batches = host_batches(cfg, ds, dev, "(a) ")
    n_real = float(batches[0].node_mask.sum())
    k = first_update(cfg, init_sd, batches, dev, time_extra=DATA_TIMED)
    med_a = step_times("(a) ", k, n_real)

    over_b = dict(over, **{"model.edge_impl": "fused",
                           "data.edge_block": BLOCK, "train.epochs": 1})
    cfg_b = load_config(path, {**over_b, **EAGER})
    print_cuts("(b) ", cfg_b, over_b)
    ds = datasets()
    init_sd, state, (fwd, bwd, f32), micro, evals = drive_train(
        cfg_b, ds, dev, reset_fused_counts,
        lambda: fused_counts() + (ep.fused_edge_layer.f32_launches,), "(b) ")
    # FastEGNN launches the layer kernel once per graph of the batch
    # (models/fast_egnn.py _fused_edges); without remat the backward reruns
    # nothing: one backward launch per forward launch of a micro-step
    L, B = cfg_b.model.n_layers, cfg_b.data.batch_size
    want_fwd, want_bwd = L * B * (micro + evals), L * B * micro
    print(f"(b) fused_edge_fwd launches={fwd} (expected {L} layers x {B} "
          f"graphs x ({micro} micro-steps + {evals} eval forwards) = "
          f"{want_fwd}), {f32} on the f32 kernel (expected all), "
          f"fused_edge_bwd launches={bwd} (expected {L} x {B} x {micro} = "
          f"{want_bwd})")
    check(fwd == want_fwd and f32 == fwd and bwd == want_bwd,
          "(b) fused launch counts")
    _, batches = host_batches(cfg_b, ds, dev, "(b) ")
    print("(b) both kernels at the train batch's graph 0 (f32):")
    rows = flagship_kernel_phase(state.model, batches[0], dev)
    n_real = float(batches[0].node_mask.sum())
    k = first_update(cfg_b, init_sd, batches, dev, time_extra=DATA_TIMED)
    p = first_update(cfg_b, init_sd, batches, dev,
                     patches=fused_plain_patches())
    acc = cfg_b.train.accumulation_steps
    check(k["launches"] == (L * B * acc, L * B * acc)
          and p["launches"] == (0, 0),
          f"(b) first update launches: kernels {k['launches']}, plain "
          f"{p['launches']}")
    errs, per = update_distance(k, p)
    worst = sorted(per.items(), key=lambda kv: -kv[1])
    print(f"(b) first update, kernels vs plain: losses max rel err "
          f"{max(errs['loss'], errs['loss_with_mmd']):.3e}, gradient norm "
          f"{errs['grad norm']:.3e}, max {errs['grad']:.3e} (tol "
          f"{TOL_TRAIN:.0e}); worst tensor {worst[0][0]} {worst[0][1]:.3e} "
          f"(tol {TOL_PARAM:.3e})")
    check(all(errs[key] <= TOL_TRAIN for key in ("loss_with_mmd", "loss",
                                                 "grad norm", "grad")),
          "(b) the kernels disagree with the plain versions")
    check(worst[0][1] <= TOL_PARAM,
          f"(b) the gradient of {worst[0][0]} disagrees")
    med_b = step_times("(b) ", k, n_real)
    return {"launches": (fwd, bwd), "kernels": rows, "prep_ms": prep_ms,
            "ms": (med_a, med_b)}


def data_check_rank(rank, ws, init_method, cfg, paths, dirs, out_dir,
                    device="cuda"):
    """A rank of (c)'s checks (spawned, over the card): the first update
    with MMD off, for the union comparison; then every split's batches of
    its loaders over the pickle shards and over the same shards as
    ``write_shards`` directories (opened through ``open_dataset`` with
    ``data.stream_shard_cache``), compared on the card bitwise."""
    import dataclasses
    import itertools

    import torch

    from distegnn_tpu_torch.data.stream import StreamedGraphDataset
    from distegnn_tpu_torch.models.registry import get_model
    from distegnn_tpu_torch.parallel.launch import rank_loaders
    from distegnn_tpu_torch.parallel.mesh import (GRAPH_AXIS,
                                                  destroy_graph_group,
                                                  init_graph_group)

    gg = init_graph_group(ws, rank, device, init_method)
    dev = gg.device
    out = {}
    try:
        loader = rank_loaders(cfg, paths, rank, dev)[0]
        loader.set_epoch(1)
        batches = list(itertools.islice(loader,
                                        cfg.train.accumulation_steps))
        init = get_model(cfg.model, generator=torch.Generator().manual_seed(
            int(cfg.seed))).state_dict()
        u = first_update(cfg, init, batches, dev, axis_name=GRAPH_AXIS,
                         rank=rank)
        out["union"] = {"loss": u["loss"], "grad": {
            n: g.cpu() for n, g in u["grad"].items()}}
        whole = rank_loaders(cfg, paths, rank, dev)
        streamed = rank_loaders(cfg, dirs, rank, dev)
        compared, streams = 0, []
        for w, s in zip(whole, streamed):
            ds = s.loader.dataset
            streams.append((type(ds) is StreamedGraphDataset,
                            getattr(ds, "cache_shards", None)))
            for epoch in (1, 2):
                w.set_epoch(epoch)
                s.set_epoch(epoch)
                for a, b in itertools.zip_longest(w, s):
                    if a is None or b is None:
                        raise AssertionError("the loaders' lengths differ")
                    for f in dataclasses.fields(a):
                        x, y = getattr(a, f.name), getattr(b, f.name)
                        same = (torch.equal(x, y) and x.device == y.device
                                if isinstance(x, torch.Tensor) else x == y)
                        if not same:
                            raise AssertionError(
                                f"rank {rank}: {f.name} of a streamed batch "
                                "differs from the pickle run's")
                    compared += 1
        out["stream"] = {"batches": compared, "datasets": streams}
    finally:
        destroy_graph_group()
    torch.save(out, os.path.join(out_dir, f"check{rank}.pt"))


def water3d_dist_phase(root, dev, data_dir, tmp):
    """(c) configs/simulation_distegnn.yaml as published + data.world_size
    4: 4 ranks sharing the card over gloo, 2 epochs; exact collectives; the
    first update (MMD off) against the parts' union; the shards streamed
    from write_shards directories, batch for batch."""
    import copy

    import torch

    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.data import partition
    from distegnn_tpu_torch.data.loader import GraphDataset
    from distegnn_tpu_torch.data.stream import write_shards
    from distegnn_tpu_torch.models.registry import get_model
    from distegnn_tpu_torch.parallel.launch import (_dispatch_preprocess,
                                                    run_distributed)

    path = os.path.join(root, "configs", "simulation_distegnn.yaml")
    over = {"data.data_dir": data_dir, "data.world_size": DIST_WS,
            "data.max_samples": W3D_DIST_SAMPLES, "train.epochs": 2,
            "log.log_dir": os.path.join(tmp, "logs")}
    cfg = load_config(path, {**over, **EAGER})
    print_cuts("(c) ", cfg, over)
    d = cfg.data
    print(f"(c) split_mode {d.split_mode} outer/inner radius "
          f"{d.outer_radius}/{d.inner_radius} world_size {d.world_size}")
    paths, prep_ms = timed_preprocess(
        "(c) ", lambda: _dispatch_preprocess(cfg, DIST_WS),
        3 * W3D_DIST_SAMPLES)
    check(partition.metis_labels.partitioner == "native",
          "(c) metis did not run the native partitioner")
    parts = [GraphDataset(p) for p in paths[0]]
    print(f"(c) metis (native) parts of a frame: nodes "
          f"{[q[0]['loc'].shape[0] for q in parts]}, local edges "
          f"{[q[0]['edge_index'].shape[1] for q in parts]}")
    n_real = sum(q[i]["loc"].shape[0] for q in parts
                 for i in range(d.batch_size))
    L, mmd = cfg.model.n_layers, bool(cfg.train.mmd.weight)
    per = micro_step_collectives(L, cfg.model.remat, mmd, False)
    print(f"(c) all-reduces a micro-step, derived: {sum(per.values())} "
          f"{json.dumps(per)} (+1 gradient at each update)")
    probe_dir = os.path.join(tmp, "probe_c")
    os.makedirs(probe_dir)
    t0 = time.perf_counter()
    print_mode("phase 11 (c) ", cfg)
    best = run_distributed(copy.deepcopy(cfg), split_paths=paths, device=dev,
                           on_step=StepProbe(probe_dir))
    print(f"(c) run_distributed: {DIST_WS} ranks x {cfg.train.epochs} "
          f"epochs in {time.perf_counter() - t0:.1f} s; best "
          f"{json.dumps(best)}; parameters bitwise equal across the ranks "
          f"(run_distributed's checks at the start, each evaluation and the "
          f"end)")
    check(math.isfinite(best["loss_valid"]), "(c) non-finite eval loss")
    rows = read_probe(probe_dir, DIST_WS)
    micro = cfg.train.epochs * (len(parts[0]) // d.batch_size)
    check(all(len(r) == micro and r[-1]["fwd"] == 0 for r in rows),
          "(c) missing micro-steps or a fused launch")
    meds = report_dist_run("(c) ", cfg, rows, n_real,
                           {"layout": 3, "replicated": 1})

    dirs = [[os.path.join(tmp, "shards", f"{split}_{r}")
             for r in range(DIST_WS)] for split in ("train", "valid", "test")]
    for ps, ds in zip(paths, dirs):
        for p, q in zip(ps, ds):
            write_shards(GraphDataset(p).graphs, q, shard_size=3)
    ucfg = load_config(path, dict(over, **{"train.mmd.weight": 0.0}))
    check_dir = os.path.join(tmp, "checks_c")
    os.makedirs(check_dir)
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        data_check_rank, args=(DIST_WS, "file://" + os.path.join(
            check_dir, "store"), ucfg, paths, dirs, check_dir, dev.type),
        nprocs=DIST_WS, join=True, start_method="spawn")
    res = [torch.load(os.path.join(check_dir, f"check{r}.pt"),
                      weights_only=False) for r in range(DIST_WS)]
    print(f"(c) checks: {DIST_WS} ranks in {time.perf_counter() - t0:.1f} s")
    for r, rr in enumerate(res):
        st = rr["stream"]
        check(all(s == (True, d.stream_shard_cache) for s in st["datasets"]),
              f"(c) rank {r}: the loaders did not stream {st['datasets']}")
        print(f"(c) rank {r}: {st['batches']} batches (2 epochs of each "
              f"split) from write_shards directories (StreamedGraphDataset, "
              f"cache_shards {d.stream_shard_cache}) bitwise the pickle "
              f"shards' on the card")
        for n, g in rr["union"]["grad"].items():
            check(torch.equal(g, res[0]["union"]["grad"][n]),
                  f"(c) rank {r}: the summed gradient of {n} differs")
    init = get_model(ucfg.model, generator=torch.Generator().manual_seed(
        int(ucfg.seed))).state_dict()
    ub, _ = union_batches(ucfg, paths, dev)
    uu = first_update(ucfg, init, ub, dev)
    uu["grad"] = {n: g.cpu() for n, g in uu["grad"].items()}
    ru = res[0]["union"]
    errs, _ = update_distance(dict(ru, loss_with_mmd=ru["loss"]),
                              dict(uu, loss_with_mmd=uu["loss"]))
    print(f"(c) first update (MMD off) of {DIST_WS} ranks vs the union in "
          f"one process: losses max rel err {errs['loss']:.3e}, gradient "
          f"norm {errs['grad norm']:.3e}, max {errs['grad']:.3e}, l2 "
          f"{errs['grad l2']:.3e} (tol {TOL_TRAIN:.0e} each)")
    check(all(errs[key] <= TOL_TRAIN for key in ("loss", "grad norm", "grad",
                                                 "grad l2")),
          "(c) the distributed update disagrees with the union's")
    return {"prep_ms": prep_ms, "ms": meds, "collectives": per}


def test_mse(model, files, batch_size, dev):
    """The test split's node-weighted MSE under the eval step, with the
    test graphs."""
    from distegnn_tpu_torch.data.loader import GraphDataset, GraphLoader
    from distegnn_tpu_torch.train.step import make_eval_step

    ds = GraphDataset(files[2])
    step = make_eval_step(model)
    num = den = 0.0
    for b in GraphLoader(ds, batch_size):
        n = float(b.node_mask.sum())
        num += float(step(b.to(dev))) * n
        den += n
    return num / den, ds.graphs


def protein_phase(root, dev, data_dir, tmp):
    """(d) configs/protein_fastegnn.yaml as published, 2 epochs; then the
    same weights on the test split built with test_rot and with
    test_trans."""
    import numpy as np

    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.data.loader import GraphDataset
    from distegnn_tpu_torch.main import process_dataset_edge_cutoff

    path = os.path.join(root, "configs", "protein_fastegnn.yaml")
    over = {"data.data_dir": data_dir, "data.max_samples": ADK_SAMPLES,
            "train.epochs": 2, "log.log_dir": os.path.join(tmp, "logs")}
    cfg = load_config(path, {**over, **EAGER})
    print_cuts("(d) ", cfg, over)
    files, prep_ms = timed_preprocess(
        "(d) ", lambda: process_dataset_edge_cutoff(cfg.data, seed=cfg.seed),
        3 * ADK_SAMPLES)
    ds = [GraphDataset(f, node_order=cfg.data.node_order) for f in files]
    e = [g["edge_index"].shape[1] for g in ds[0].graphs]
    print(f"(d) frames {len(ds[0])}/{len(ds[1])}/{len(ds[2])}, "
          f"{ds[0][0]['loc'].shape[0]} atoms, edges a frame within "
          f"{cfg.data.radius} A {min(e)}..{max(e)}")
    init_sd, state, counts, _, _ = drive_train(cfg, ds, dev,
                                               reset_fused_counts,
                                               fused_counts, "(d) ")
    check(counts == (0, 0), f"(d) the plain path launched {counts}")
    _, batches = host_batches(cfg, ds, dev, "(d) ")
    k = first_update(cfg, init_sd, batches, dev, time_extra=DATA_TIMED)
    med = step_times("(d) ", k, float(batches[0].node_mask.sum()))
    B = cfg.data.batch_size
    plain, graphs = test_mse(state.model, files, B, dev)
    for key in ("test_rot", "test_trans"):
        cfg.data[key] = True
        moved, mgraphs = test_mse(state.model, process_dataset_edge_cutoff(
            cfg.data, seed=cfg.seed), B, dev)
        cfg.data[key] = False
        flips = sum(not np.array_equal(a["edge_index"], b["edge_index"])
                    for a, b in zip(graphs, mgraphs))
        rel = abs(moved - plain) / plain
        print(f"(d) test MSE with {key}: {moved:.9g} vs plain {plain:.9g}, "
              f"|a - b| / b {rel:.3e} (tol {TOL_DATA_EQUIV:.0e}); frames "
              f"whose radius-graph edge sets differ: {flips} of "
              f"{len(graphs)}")
        check(rel <= TOL_DATA_EQUIV,
              f"(d) the {key} test split's MSE disagrees with the plain one")
    return {"prep_ms": prep_ms, "ms": med}


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


# ---- phase 12: the serving gateway ------------------------------------------

GW_SCENES = (1500, 3000, 6000)
GW_PREDICTS, GW_CLIENTS = 64, 8
GW_STREAM_CHUNK = 4
GW_CUT_STEPS = 32          # the stream the client leaves after one chunk
GW_TOL = 1e-5              # tests/test_torch_serve.py's bound
GW_DRAIN_PREDICTS = 8
GW_DRAIN_STEPS = 64        # a rollout that holds the drain open


def gateway_yaml(root, tmp, r0):
    """configs/nbody_serve.yaml as published plus the ``serve.models``
    routing its comments document: ``fused`` (phase 3's model) and
    ``rollout`` (phase 3d's)."""
    import yaml

    with open(os.path.join(root, "configs", "nbody_serve.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["serve"]["models"] = [
        {"name": "fused", "overrides": {"model": {"edge_impl": "fused"},
                                        "data": {"edge_block": BLOCK}}},
        {"name": "rollout", "overrides": {
            "model": {"blocked_impl": "pallas"},
            "serve": {"rollout": dict(ROLLOUT_OPTS, radius=float(r0))}}}]
    path = os.path.join(tmp, "gateway.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def b64(a, dtype="<f4"):
    import base64

    import numpy as np

    a = np.ascontiguousarray(a, dtype=dtype)
    return {"b64": base64.b64encode(a.tobytes()).decode("ascii"),
            "shape": list(a.shape)}


def unb64(spec):
    import base64

    import numpy as np

    return np.frombuffer(base64.b64decode(spec["b64"]),
                         "<f4").reshape(spec["shape"])


def predict_body(g):
    return json.dumps({
        "positions": b64(g["loc"]), "velocities": b64(g["vel"]),
        "node_feat": b64(g["node_feat"]), "edge_attr": b64(g["edge_attr"]),
        "edge_index": b64(g["edge_index"], "<i4"),
        "encoding": "b64"}).encode()


def rollout_body(s, steps, chunk=None):
    body = {"positions": b64(s["loc"]), "velocities": b64(s["vel"]),
            "steps": int(steps), "encoding": "b64"}
    if chunk is not None:
        body["chunk_steps"] = int(chunk)
    return json.dumps(body).encode()


def http_call(port, method, path, data=None, timeout=300):
    """One request on its own connection -> (status, body bytes, ms)."""
    import http.client

    t0 = time.perf_counter()
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    c.request(method, path, body=data,
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    body = r.read()
    c.close()
    return r.status, body, (time.perf_counter() - t0) * 1e3


def http_stream(port, path, data, leave_after=None):
    """A streamed rollout: the NDJSON lines, the ms to the first line and
    to the end; ``leave_after`` lines closes the connection early."""
    import http.client

    t0 = time.perf_counter()
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    c.request("POST", path, body=data,
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    lines, first_ms = [], None
    while True:
        line = r.readline()
        if not line:
            break
        if first_ms is None:
            first_ms = (time.perf_counter() - t0) * 1e3
        lines.append(json.loads(line))
        if leave_after is not None and len(lines) >= leave_after:
            break
    c.close()
    return r.status, lines, first_ms, (time.perf_counter() - t0) * 1e3


def pct(vals, q):
    s = sorted(vals)
    return s[min(len(s) - 1, max(0, int(round(q / 100 * (len(s) - 1)))))]


def gateway_phase(root, dev):
    """Phase 12 (see the module docstring). Its files go to a temporary
    directory that is removed afterwards."""
    with phase_tmp("chip_smoke_gateway_") as tmp:
        return _gateway_phase(root, dev, tmp)


def _gateway_phase(root, dev, tmp):
    import queue as pyqueue
    import threading

    import numpy as np
    import torch

    from distegnn_tpu_torch import obs
    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.models.registry import get_model
    from distegnn_tpu_torch.obs.metrics import MetricsRegistry
    from distegnn_tpu_torch.obs.report import load_events
    from distegnn_tpu_torch.obs.slo import parse_prometheus
    from distegnn_tpu_torch.ops import edge_pipeline as ep
    from distegnn_tpu_torch.serve import engine_with_params_from_config
    from distegnn_tpu_torch.serve.registry import ModelRegistry
    from distegnn_tpu_torch.serve.transport import Gateway
    from distegnn_tpu_torch.train.checkpoint import save_checkpoint
    from distegnn_tpu_torch.train.step import TrainState, make_optimizer

    t_phase = time.perf_counter()
    r0, deg = rollout_radius()
    path = gateway_yaml(root, tmp, r0)
    cfg = load_config(path)
    print(f"gateway config: configs/nbody_serve.yaml as published + "
          f"serve.models [fused: edge_impl fused, edge_block {BLOCK}; "
          f"rollout: blocked_impl pallas, serve.rollout radius {r0:.4f} "
          f"(mean degree {deg:.2f}), {ROLLOUT_OPTS}]; max_batch "
          f"{cfg.serve.max_batch}, batch_deadline_ms "
          f"{cfg.serve.batch_deadline_ms}, queue_capacity "
          f"{cfg.serve.queue_capacity}, request_timeout_ms "
          f"{cfg.serve.request_timeout_ms}, warmup_nodes "
          f"{list(cfg.serve.gateway.warmup_nodes)} (as published)")
    obs.configure(log_dir=os.path.join(tmp, "obs"))
    reg = ModelRegistry.from_config(cfg, device=dev)
    fused, roll = reg.get("fused"), reg.get("rollout")
    m = fused.config.model
    L, B = int(m.n_layers), int(fused.engine.max_batch)
    print(f"gateway models: fused H={m.hidden_nf} L={L} "
          f"C={m.virtual_channels} edge_impl={m.edge_impl}; rollout "
          f"blocked_impl={roll.config.model.blocked_impl}")
    reg.start()
    reg.warmup([int(n) for n in cfg.serve.gateway.warmup_nodes])
    check(reg.ready(), f"gateway: models not ready after warmup: "
          f"{reg.health()}")
    gw_metrics = MetricsRegistry()
    gw = Gateway(reg, host="127.0.0.1", port=0,
                 max_inflight=int(cfg.serve.gateway.max_inflight),
                 drain_grace_s=float(cfg.serve.gateway.drain_grace_s),
                 metrics_registry=gw_metrics,
                 stream_chunk_steps=int(cfg.serve.stream.chunk_steps))
    server = threading.Thread(target=gw.serve_forever, daemon=True)
    server.start()
    port = gw.port

    # the traffic of (a): predicts, rollouts, two streams, three errors
    preds = [scene(n, seed=700 + 10 * i + k) for i, n in
             enumerate(GW_SCENES) for k in range(2)]
    bodies = [predict_body(g) for g in preds]
    many = [rollout_scene(n, 710 + i, r0)
            for i, n in enumerate(ROLLOUT_SIZES)]
    K = ROLLOUT_STEPS
    # one client sends the rollouts and then the two streams, each after the
    # last came back; the other seven share the predicts and the errors.
    # The queue batches rollouts per (rung, steps), and 1000-4000 nodes are
    # three rungs: sent at once, the later rungs would wait behind the first
    # past the published 500 ms queued-time deadline
    mixed = [("predict", i % len(preds)) for i in range(GW_PREDICTS)]
    mixed += [("413", None), ("404", None), ("400", None)]
    work = [pyqueue.Queue() for _ in range(2)]
    for job in [("rollout", i) for i in range(len(many))] + [
            ("stream", len(many) - 1), ("cut", 0)]:
        work[0].put(job)
    for i in np.random.default_rng(12).permutation(len(mixed)):
        work[1].put(mixed[i])
    jobs = list(work[0].queue) + list(work[1].queue)
    over = json.dumps({"positions": b64(np.random.default_rng(1).uniform(
        0, 1, (int(cfg.serve.max_nodes) + 1, 3))),
        "edge_index": [[0, 1], [1, 0]]}).encode()
    tiny = json.dumps({"positions": [[0.0, 0.0, 0.0]],
                       "radius": 0.1}).encode()
    results = []
    lock = threading.Lock()

    def client(jobs_q):
        while True:
            try:
                kind, i = jobs_q.get_nowait()
            except pyqueue.Empty:
                return
            if kind == "predict":
                out = http_call(port, "POST", "/v1/models/fused/predict",
                           bodies[i])
            elif kind == "rollout":
                out = http_call(port, "POST", "/v1/models/rollout/rollout",
                           rollout_body(many[i], K))
            elif kind in ("stream", "cut"):
                out = http_stream(
                    port, "/v1/models/rollout/rollout?stream=1",
                    rollout_body(many[i], K if kind == "stream"
                                 else GW_CUT_STEPS, GW_STREAM_CHUNK),
                    leave_after=1 if kind == "cut" else None)
            elif kind == "413":
                out = http_call(port, "POST", "/v1/models/fused/predict", over)
            elif kind == "404":
                out = http_call(port, "POST", "/v1/models/nope/predict",
                                tiny)
            else:
                out = http_call(port, "POST", "/v1/models/fused/predict",
                           b"{not json")
            with lock:
                results.append((kind, i, out))

    # the engine warms predict rungs only: one rollout and one stream of a
    # step each take the rollout path's first-use costs before the counts
    st, _, ms = http_call(port, "POST", "/v1/models/rollout/rollout",
                          rollout_body(many[-1], 1))
    st2, lines, _, ms2 = http_stream(
        port, "/v1/models/rollout/rollout?stream=1",
        rollout_body(many[0], 1, 1))
    print(f"gateway rollout warm-up: buffered K=1 {st} in {ms:.1f} ms, "
          f"streamed K=1 {st2} in {ms2:.1f} ms")
    check(st == 200 and st2 == 200 and lines[-1].get("done"),
          "gateway: the rollout warm-up failed")
    torch.cuda.synchronize()
    b0 = fused.engine.metrics.snapshot()
    t_reset = time.time()           # the events' clock: the warm-up's end
    reset_fused_counts()
    reset_blocked_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(work[min(c, 1)],))
               for c in range(GW_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    # the client that left got its answer before the server stopped: wait
    # for the cancelled stream's end (its event) before reading the counts
    events_path = os.path.join(tmp, "obs", "events.jsonl")
    cut = []
    while not cut:
        check(time.perf_counter() - t0 < 600, "gateway: the disconnected "
              "stream never ended")
        time.sleep(0.05)
        obs.flush()
        if os.path.exists(events_path):
            cut = [e for e in load_events(events_path)[0]
                   if e.get("name") == "serve/stream_cancelled"]
    fwd, tc = fwd_counts()
    f32 = ep.fused_edge_layer.f32_launches
    bl_n, bl_w = blocked_counts(), blocked_widths()
    b1 = fused.engine.metrics.snapshot()
    check(len(results) == len(jobs), f"gateway: {len(results)} of "
          f"{len(jobs)} requests answered")
    by = collections.defaultdict(list)
    for kind, i, out in results:
        by[kind].append((i, out))
    for kind, want in (("413", 413), ("404", 404), ("400", 400)):
        st, body, _ = by[kind][0][1]
        print(f"gateway {kind}: status {st} {json.loads(body)['type']}")
        check(st == want, f"gateway: {kind} answered {st}")
    for i, (st, body, ms) in sorted(by["rollout"]):
        b = json.loads(body)
        print(f"gateway rollout {i} ({many[i]['loc'].shape[0]} nodes): "
              f"status {st} in {ms:.1f} ms"
              + (f", queue {b['queue_ms']} ms, compute {b['compute_ms']} ms,"
                 f" batch of {b['batch_filled']}" if st == 200 else
                 f": {b['type']}"))
    bad = [o[0] for _, o in by["rollout"] if o[0] != 200]
    check(not bad, f"gateway: rollout statuses {bad}")
    # seven closed-loop clients with no pause between requests offer more
    # than the fused dispatcher serves in the published 500 ms queued-time
    # deadline at times: such a predict is shed as the JAX gateway sheds it,
    # a 504 RequestTimeout, counted here and on the gateway's counter
    shed = [json.loads(o[1])["type"] for _, o in by["predict"]
            if o[0] != 200]
    timeouts = int(gw_metrics.snapshot()["gateway/timeouts"])
    print(f"gateway predicts: {GW_PREDICTS - len(shed)} answered 200, "
          f"{len(shed)} shed at the deadline {sorted(set(shed))}; the "
          f"gateway's timeouts counter {timeouts}")
    check(set(shed) <= {"RequestTimeout"} and len(shed) == timeouts,
          f"gateway: predicts answered {shed}")
    check({i for i, o in by["predict"] if o[0] == 200} == set(
        range(len(preds))), "gateway: a scene was never answered")

    # launches: fused forward L x max_batch per executed predict batch
    batches = b1["batches_executed"] - b0["batches_executed"]
    check(b1["requests_retried"] == b0["requests_retried"],
          "gateway: a predict batch was retried")
    want_fwd = L * B * batches
    print(f"gateway fused predicts: {GW_PREDICTS} requests in {batches} "
          f"batches; fused_edge_fwd launches {fwd} (expected L x max_batch "
          f"x batches = {L} x {B} x {batches} = {want_fwd}), {f32} on the "
          f"f32 kernel, {tc} on the tensor-core kernel")
    check(fwd == want_fwd and f32 == fwd and tc == 0,
          f"gateway: fused launches {fwd}/{f32}/{tc} != {want_fwd}")
    obs.flush()
    events, _ = load_events(events_path)
    execs = [e for e in events if e.get("name") == "serve/execute"
             and e.get("workload") in ("rollout", "rollout_stream")
             and e["ts"] >= t_reset]
    steps = sum(int(e["steps"]) for e in execs)
    want_bl = blocked_want(L, steps=steps)
    print(f"gateway rollouts: {len(execs)} executions, {steps} steps; "
          f"blocked_seg_sum {bl_n[0]} {bl_w[0]}, blocked_gather {bl_n[1]} "
          f"{bl_w[1]}, blocked_plan {bl_n[2]} (expected per step 2L, 2L "
          f"and 1: {want_bl})")
    check(bl_w == want_bl[:2] and bl_n == (2 * L * steps, 2 * L * steps,
                                           steps),
          f"gateway: blocked launches {bl_n} {bl_w} != {want_bl}")
    check(len(cut) == 1, f"gateway: {len(cut)} stream_cancelled events")
    chunks_run = cut[0]["steps_done"] // GW_STREAM_CHUNK
    total_chunks = GW_CUT_STEPS // GW_STREAM_CHUNK
    print(f"gateway disconnected stream: {chunks_run} of {total_chunks} "
          f"chunks ran ({cut[0]['steps_done']} of {GW_CUT_STEPS} steps)")
    check(chunks_run < total_chunks, "gateway: the disconnect cancelled "
          "nothing")

    # the batcher coalesced: mean requests per executed batch, from /metrics
    st, text, _ = http_call(port, "GET", "/metrics")
    prom = parse_prometheus(text.decode())
    pre = "distegnn_model_fused_serve_"
    fill = prom[pre + "batch_slots_filled"] / prom[pre + "batches_executed"]
    print(f"gateway /metrics: {int(prom[pre + 'batches_executed'])} fused "
          f"batches, mean batch fill {fill:.3f} requests (of {B})")
    check(st == 200 and fill > 1.0, f"gateway: mean batch fill {fill}")

    # every predict against a direct engine of the same entry and seed
    _, direct = engine_with_params_from_config(fused.config, device=dev)
    want = [direct.predict(g) for g in preds]
    err = 0.0
    for i, (stt, body, _) in by["predict"]:
        if stt != 200:
            continue
        out = unb64(json.loads(body)["prediction"])
        err = max(err, float(np.abs(out - want[i]).max()))
    print(f"gateway predicts vs engine.predict: max_abs_err {err:.3e} tol "
          f"{GW_TOL:.0e}")
    legs = collections.defaultdict(list)
    for _, (stt, body, ms) in by["predict"]:
        if stt != 200:
            continue
        b = json.loads(body)
        for k in ("queue_ms", "compute_ms", "total_ms"):
            legs[k].append(b[k])
        legs["client_ms"].append(ms)
    print("gateway predict legs, p50 / p99 ms: " + ", ".join(
        f"{k} {pct(v, 50):.2f} / {pct(v, 99):.2f}"
        for k, v in legs.items()) + " (queue and compute: the batch's; "
        "total: the handler's, from the body's decode to the answer)")
    check(err <= GW_TOL, "gateway: a predict disagrees with the engine")
    # rollouts against engine.rollout, at phase 3d's bounds
    _, rdirect = engine_with_params_from_config(roll.config, device=dev)
    trajs = {i: unb64(json.loads(o[1])["trajectory"])
             for i, o in by["rollout"]}
    worst = (0.0, 0.0)
    for i, s in enumerate(many):
        ref = rdirect.rollout(s["loc"], s["vel"], K)
        d1 = float(np.abs(ref[0] - s["loc"]).max())
        dk = float(np.abs(ref - s["loc"]).max())
        e1 = float(np.abs(trajs[i][0] - ref[0]).max()) / d1
        ek = float(np.abs(trajs[i] - ref).max()) / dk
        worst = (max(worst[0], e1), max(worst[1], ek))
    print(f"gateway rollouts vs engine.rollout: first step {worst[0]:.3e} "
          f"of max |x_1 - x_0| (tol {TOL_ROLLOUT_STEP:.0e}), all steps "
          f"{worst[1]:.3e} of max |x_k - x_0| (tol {TOL_ROLLOUT_TRAJ:.0e})")
    check(worst[0] <= TOL_ROLLOUT_STEP and worst[1] <= TOL_ROLLOUT_TRAJ,
          "gateway: a rollout disagrees with engine.rollout")
    (si, (sst, lines, first_ms, stream_ms)), = by["stream"]
    check(sst == 200 and lines[-1].get("done") and
          not lines[-1]["cancelled"], f"gateway: stream {sst} {lines[-1]}")
    cat = np.concatenate([unb64(x["chunk"]) for x in lines[:-1]])
    ref = trajs[si]
    d1 = float(np.abs(ref[0] - many[si]["loc"]).max())
    dk = float(np.abs(ref - many[si]["loc"]).max())
    e1 = float(np.abs(cat[0] - ref[0]).max()) / d1
    ek = float(np.abs(cat - ref).max()) / dk
    print(f"gateway stream ({len(lines) - 1} chunks of {GW_STREAM_CHUNK}) "
          f"vs the buffered trajectory: first step {e1:.3e}, all steps "
          f"{ek:.3e} (phase 3d's bounds)")
    check(cat.shape == ref.shape and e1 <= TOL_ROLLOUT_STEP
          and ek <= TOL_ROLLOUT_TRAJ, "gateway: the streamed trajectory "
          "disagrees with the buffered one")

    # blue/green: the trainer's checkpoint format, then a NaN parameter
    gen = torch.Generator().manual_seed(int(cfg.seed) + 1)
    new = get_model(fused.config.model, generator=gen)
    good = os.path.join(tmp, "swap", "good.ckpt")
    save_checkpoint(good, TrainState(new, make_optimizer(
        new.parameters(), 1e-3)), epoch=0)
    nan = get_model(fused.config.model, generator=gen)
    with torch.no_grad():
        next(iter(nan.parameters())).view(-1)[0] = float("nan")
    bad = os.path.join(tmp, "swap_nan", "nan.ckpt")
    save_checkpoint(bad, TrainState(nan, make_optimizer(
        nan.parameters(), 1e-3)), epoch=0)
    reset_fused_counts()
    st, body, ms = http_call(port, "POST", "/v1/models/fused/swap",
                        json.dumps({"checkpoint": good}).encode())
    info = json.loads(body)
    swap_fwd = fwd_counts()[0]
    print(f"gateway swap to the trainer checkpoint: status {st} {info} in "
          f"{ms:.1f} ms; canary launches {swap_fwd} (expected L x max_batch"
          f" x rungs = {L * B * info.get('rungs_canaried', -1)})")
    check(st == 200 and info["version"] == 1 and
          swap_fwd == L * B * info["rungs_canaried"], "gateway: swap failed")
    reset_fused_counts()
    st, body, _ = http_call(port, "POST", "/v1/models/fused/swap",
                       json.dumps({"checkpoint": bad}).encode())
    info = json.loads(body)
    print(f"gateway swap to a NaN parameter: status {st} {info['type']} "
          f"stage {info['stage']} rolled_back {info['rolled_back']}; "
          f"canary launches {fwd_counts()[0]} (expected {L * B}: the "
          f"first rung fails)")
    check(st == 422 and info["stage"] == "canary" and info["rolled_back"]
          and fwd_counts()[0] == L * B, "gateway: the NaN swap did not "
          "roll back")
    _, sdirect = engine_with_params_from_config(fused.config, device=dev,
                                                checkpoint=good)
    err = 0.0
    for g, b in zip(preds[::2], bodies[::2]):
        st, body, _ = http_call(port, "POST", "/v1/models/fused/predict", b)
        check(st == 200, f"gateway: predict after the swaps {st}")
        out = unb64(json.loads(body)["prediction"])
        err = max(err, float(np.abs(out - sdirect.predict(g)).max()))
    print(f"gateway predicts after the swaps vs the new checkpoint's "
          f"engine: max_abs_err {err:.3e} tol {GW_TOL:.0e}")
    check(err <= GW_TOL, "gateway: the swapped model disagrees")
    del direct, rdirect, sdirect

    # client-side latency per model and route
    lat = collections.defaultdict(list)
    for kind, i, out in results:
        if kind in ("predict", "rollout"):
            lat[kind].append(out[2])
        elif kind in ("stream", "cut"):
            lat[kind].append(out[3])
    for kind, model in (("predict", "fused"), ("rollout", "rollout"),
                        ("stream", "rollout"), ("cut", "rollout")):
        v = lat[kind]
        print(f"gateway client ms {model} {kind}: n={len(v)} p50 "
              f"{pct(v, 50):.2f} p99 {pct(v, 99):.2f}")
    print(f"gateway (a): {len(results)} requests from {GW_CLIENTS} "
          f"closed-loop clients in "
          f"{wall:.3f} s: {len(results) / wall:.1f} requests/s; rollout "
          f"K={K} p50 {pct(lat['rollout'], 50):.2f} ms; stream first chunk "
          f"{first_ms:.2f} ms of {stream_ms:.2f} ms")
    gw.drain()
    gw.close()
    server.join(30)

    drain_s = gateway_subprocess(root, path, bodies, many[-1], dev)
    ph_s = time.perf_counter() - t_phase
    print(f"gateway phase: {ph_s:.1f} s")
    return dict(fwd=fwd, blocked=bl_n, widths=bl_w, fill=fill,
                rps=len(results) / wall, drain_s=drain_s,
                predict_p50=pct(lat["predict"], 50),
                predict_p99=pct(lat["predict"], 99),
                predict_rps=len(lat["predict"]) / wall)


def gateway_subprocess(root, path, bodies, long_scene, dev):
    """Phase 12 (b): ``python -m distegnn_tpu_torch.serve.gateway`` on the
    card; SIGTERM while requests are in flight. Returns the drain seconds."""
    import signal
    import threading

    from distegnn_tpu_torch.obs.slo import parse_prometheus

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=root)
    err_path = os.path.join(os.path.dirname(path), "gateway.stderr")
    err = open(err_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distegnn_tpu_torch.serve.gateway",
         "--config_path", path, "--port", "0", "--obs-dir", "",
         "--device", dev.type],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=err, text=True)

    def stderr_tail():
        err.flush()
        with open(err_path) as f:
            return f.read()[-2000:]

    try:
        port = None
        for line in proc.stdout:
            if "listening on http://" in line:
                port = int(line.split("http://")[1].split()[0]
                           .rsplit(":", 1)[1])
                break
        if port is None:
            proc.kill()
            fail(f"gateway entry point printed no listening line: "
                 f"{stderr_tail()}")
        while True:
            st, body, _ = http_call(port, "GET", "/readyz")
            if st == 200:
                break
            check(time.perf_counter() - t0 < 120, "gateway: /readyz never "
                  "answered 200")
            time.sleep(0.05)
        print(f"gateway entry point: ready on port {port} in "
              f"{time.perf_counter() - t0:.1f} s")
        # as in (a): the rollout path's and the drained predicts' rung's
        # first use (lazily loaded device code among it) before the drain
        st1, _, ms1 = http_call(port, "POST", "/v1/models/rollout/rollout",
                                rollout_body(long_scene, 1))
        st2, _, ms2 = http_call(port, "POST", "/v1/models/fused/predict",
                                bodies[0])
        print(f"gateway entry point warm-up: K=1 rollout {st1} in "
              f"{ms1:.1f} ms, predict {st2} in {ms2:.1f} ms")
        check(st1 == 200 and st2 == 200, "gateway: the entry point's "
              "warm-up failed")
        res = {}

        def go(key, path_, body):
            try:
                res[key] = http_call(port, "POST", path_, body)
            except OSError as exc:
                res[key] = (None, repr(exc).encode(), 0.0)

        long = threading.Thread(target=go, args=(
            "long", "/v1/models/rollout/rollout",
            rollout_body(long_scene, GW_DRAIN_STEPS)))
        long.start()
        time.sleep(0.3)
        # one rung (the two 1500-node scenes): two batches of four
        ts = [threading.Thread(target=go, args=(
            i, "/v1/models/fused/predict", bodies[i % 2]))
            for i in range(GW_DRAIN_PREDICTS)]
        for t in ts:
            t.start()
        # SIGTERM once the server holds them all (its inflight gauge), or
        # after a second
        t_wait = time.perf_counter()
        while time.perf_counter() - t_wait < 1.0:
            st, text, _ = http_call(port, "GET", "/metrics")
            held = parse_prometheus(text.decode()).get(
                "distegnn_gateway_inflight", 0.0)
            if held >= 1 + GW_DRAIN_PREDICTS:
                break
            time.sleep(0.002)
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        saw = None
        while saw is None and proc.poll() is None:
            try:
                st, body, _ = http_call(port, "GET", "/readyz", timeout=5)
                if st == 503:
                    saw = json.loads(body)
            except OSError:
                break
            time.sleep(0.005)
        code = proc.wait(timeout=120)
        drain_s = time.perf_counter() - t_sig
        for t in ts + [long]:
            t.join(60)
        # a request the server never read (still in the listen backlog when
        # the drain closed it) fails to connect: it was not accepted
        statuses = [res[i][0] for i in range(GW_DRAIN_PREDICTS)]
        types = sorted({json.loads(res[i][1]).get("type", "")
                        if res[i][0] is not None else res[i][1].decode()
                        for i in range(GW_DRAIN_PREDICTS)
                        if res[i][0] != 200})
        print(f"gateway SIGTERM with {int(held)} requests in flight: exit "
              f"code {code} after {drain_s:.3f} s; "
              f"in-flight rollout K={GW_DRAIN_STEPS} status "
              f"{res['long'][0]}; predicts {statuses} (non-200 types "
              f"{types}); /readyz during the drain: {saw}")
        if code != 0:
            fail(f"gateway entry point exited {code}: {stderr_tail()}")
        check(res["long"][0] == 200, "gateway: the accepted rollout did not "
              "get its 200")
        check(all(s in (200, 503, None) for s in statuses)
              and all(res[i][0] != 503 or json.loads(res[i][1])["type"]
                      == "Draining" for i in range(GW_DRAIN_PREDICTS)),
              f"gateway: drain answered {statuses} {types}")
        check(saw is not None and saw.get("reason") == "draining",
              "gateway: /readyz never answered 503 during the drain")
        return drain_s
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()


# ---- phase 13: the promotion conveyor and process-isolated replicas ---------

PR_SCENES = (1500, 3000, 6000)    # (b)'s predicts: phase 12's scene sizes
PR_PREDICTS, PR_CLIENTS = 48, 4
PR_DRILL_SCENES = (500, 1000)     # the drill's live traffic
PR_HB_TIMEOUT_S = 3.0             # serve.supervisor.worker_heartbeat_timeout_s


def promote_yaml(root, tmp, name, watch):
    """configs/nbody_promote.yaml as published plus phase 12's ``fused``
    model override, ``serve.workers: process``, a fresh
    ``promote.watch_dir`` and the worker heartbeat timeout cut from its
    default 10 s to PR_HB_TIMEOUT_S (the SIGSTOP drill's detection)."""
    import yaml

    with open(os.path.join(root, "configs", "nbody_promote.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"]["edge_impl"] = "fused"
    raw.setdefault("data", {})["edge_block"] = BLOCK
    raw["serve"]["workers"] = "process"
    raw["serve"]["supervisor"] = {
        "worker_heartbeat_timeout_s": PR_HB_TIMEOUT_S}
    raw["promote"]["watch_dir"] = watch
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def compute_apps():
    """pid -> MiB on the card of every process nvidia-smi lists ({} where
    it lists none: a container may not see the host's process table)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return {}
    apps = {}
    for line in out.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            try:
                apps[int(parts[0])] = float(parts[1])
            except ValueError:
                pass
    return apps


def mib(n):
    return "n/a" if n is None else f"{n / 2 ** 20:.1f} MiB"


def promote_phase(root, dev, gate):
    """Phase 13 (see the module docstring). Its files go to a temporary
    directory that is removed afterwards."""
    with phase_tmp("chip_smoke_promote_") as tmp:
        return _promote_phase(root, dev, tmp, gate)


def _promote_phase(root, dev, tmp, gate):
    import threading

    import torch

    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.serve import engine_with_params_from_config

    t_phase = time.perf_counter()
    path = promote_yaml(root, tmp, "fleet_a.yaml",
                        os.path.join(tmp, "conveyor_a"))
    cfg = load_config(path)
    m, s, pm = cfg.model, cfg.serve, cfg.promote
    L, B = int(m.n_layers), int(s.max_batch)
    print(f"promote config: configs/nbody_promote.yaml as published (H="
          f"{m.hidden_nf} L={L} C={m.virtual_channels}, replicas "
          f"{s.replicas}, max_batch {B}, request_timeout_ms "
          f"{s.request_timeout_ms}, warmup_nodes "
          f"{list(s.gateway.warmup_nodes)}; promote interval_s "
          f"{pm.interval_s}, shadow_sample {pm.shadow_sample}, min_shadow "
          f"{pm.min_shadow}, gate_timeout_s {pm.gate_timeout_s}, "
          f"drift_ceiling {pm.drift_ceiling}) + model.edge_impl fused, "
          f"data.edge_block {BLOCK}, serve.workers process, "
          f"serve.supervisor.worker_heartbeat_timeout_s {PR_HB_TIMEOUT_S} "
          f"(default 10), a fresh promote.watch_dir")
    _, direct = engine_with_params_from_config(cfg, device=dev)
    digest = direct.params_digest()
    kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    preds = [scene(n, seed=1300 + 10 * i + k)
             for i, n in enumerate(PR_SCENES) for k in range(2)]
    want = [direct.predict(g) for g in preds]
    # (c)'s fleet comes up while (b)'s gateway drains and its children's
    # records are read
    fleet = {}

    def bring_up():
        try:
            fleet["up"] = drill_fleet(root, dev, tmp)
        except BaseException as exc:
            fleet["error"] = exc

    up = threading.Thread(target=bring_up, name="promote-fleet-c")
    try:
        sub = promote_subprocess(root, path, dev, tmp, preds, want, digest,
                                 kind, L * B, before_sigterm=up.start)
    finally:
        if up.ident is not None:
            up.join()
    if "error" in fleet:
        raise fleet["error"]
    drill = promote_drill_phase(dev, tmp, digest, kind, *fleet["up"])
    del direct
    torch.cuda.empty_cache()
    print(f"promote (e): predicts through 3 worker children (phase 13 (b), "
          f"{PR_CLIENTS} closed-loop clients, scenes {PR_SCENES}) p50 "
          f"{sub['p50']:.2f} ms, p99 {sub['p99']:.2f} ms, "
          f"{sub['rps']:.1f} requests/s; phase 12's thread replica "
          f"(7 closed-loop predict clients beside the rollouts, the same "
          f"scene sizes) p50 {gate['predict_p50']:.2f} ms, p99 "
          f"{gate['predict_p99']:.2f} ms, {gate['predict_rps']:.1f} "
          f"predicts/s; a finding, not a claim (different loads)")
    print(f"promote phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(fwd=sub["fwd"] + drill["fwd"], sub_fwd=sub["fwd"],
                drill_fwd=drill["fwd"], p50=sub["p50"], p99=sub["p99"],
                rps=sub["rps"])


def promote_subprocess(root, path, dev, tmp, preds, want, digest, kind,
                       per_batch, before_sigterm):
    """Phase 13 (a) and (b): ``python -m distegnn_tpu_torch.serve.gateway``
    with 3 worker children on the card; predicts through them; SIGTERM
    (``before_sigterm`` is called once the predicts are checked)."""
    import queue as pyqueue
    import signal
    import threading

    import numpy as np

    from distegnn_tpu_torch.obs.report import load_events

    obs_dir = os.path.join(tmp, "gw_a")
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=root)
    err_path = os.path.join(tmp, "gateway_a.stderr")
    err = open(err_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distegnn_tpu_torch.serve.gateway",
         "--config_path", path, "--port", "0", "--obs-dir", obs_dir,
         "--device", dev.type],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=err, text=True)

    def stderr_tail():
        err.flush()
        with open(err_path) as f:
            return f.read()[-3000:]

    try:
        port = None
        for line in proc.stdout:
            if "listening on http://" in line:
                port = int(line.split("http://")[1].split()[0]
                           .rsplit(":", 1)[1])
                break
        if port is None:
            proc.kill()
            fail(f"promote gateway printed no listening line: "
                 f"{stderr_tail()}")
        while True:
            st, body, _ = http_call(port, "GET", "/readyz")
            if st == 200:
                break
            check(time.perf_counter() - t0 < 300, "promote: /readyz never "
                  "answered 200")
            time.sleep(0.05)
        t_ready = time.perf_counter() - t0
        rz = json.loads(body)
        _, body, _ = http_call(port, "GET", "/v1/models")
        rows = json.loads(body)["models"][0]["replicas"]
        apps = compute_apps()
        print(f"promote (a): gateway pid {proc.pid} ready in {t_ready:.1f} "
              f"s (3 children spawned side by side, then warmed); parent "
              f"params digest {digest}")
        for r in rows:
            print(f"promote (a) child {r['replica']}: pid {r['pid']}, "
                  f"backend {r['backend']}, degraded {r['degraded']}, "
                  f"device {r.get('device')}, params digest "
                  f"{r.get('params_digest')}, spawn {r.get('spawn_s')} s "
                  f"(exec to ready; {r.get('init_s')} s of it after the "
                  f"init message), on the card (nvidia-smi) "
                  + (f"{apps[r['pid']]} MiB" if r["pid"] in apps else
                     "not listed by nvidia-smi here"))
        pids = {r["pid"] for r in rows}
        check(len(rows) == 3 and len(pids) == 3
              and all(r["backend"] == "process" and not r["degraded"]
                      and r["pid"] not in (None, proc.pid) for r in rows),
              f"promote: the children are not 3 live processes: {rows}")
        check(all(r.get("params_digest") == digest for r in rows),
              "promote: a child's params digest differs from the parent's")
        check(all(r.get("device") == kind for r in rows),
              f"promote: a child is not on the card: {rows}")
        promo = rz.get("promote") or {}
        check(promo.get("enable") and promo.get("state") == "idle"
              and promo.get("fleet_coherent") is True,
              f"promote: /readyz promote status {promo}")

        # (b): closed-loop predicts through the children
        bodies = [predict_body(g) for g in preds]
        jobs = pyqueue.Queue()
        for i in range(PR_PREDICTS):
            jobs.put(i % len(preds))
        results = []
        lock = threading.Lock()

        def client():
            while True:
                try:
                    i = jobs.get_nowait()
                except pyqueue.Empty:
                    return
                out = http_call(port, "POST", "/v1/models/default/predict",
                                bodies[i])
                with lock:
                    results.append((i, out))

        tb = time.perf_counter()
        threads = [threading.Thread(target=client)
                   for _ in range(PR_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - tb
        check(len(results) == PR_PREDICTS, f"promote: {len(results)} of "
              f"{PR_PREDICTS} predicts answered")
        shed = [json.loads(o[1])["type"] for _, o in results if o[0] != 200]
        ok = [(i, o) for i, o in results if o[0] == 200]
        err_max = 0.0
        for i, (_, body, _) in ok:
            out = unb64(json.loads(body)["prediction"])
            err_max = max(err_max, float(np.abs(out - want[i]).max()))
        lat = [o[2] for _, o in ok]
        print(f"promote (b): {len(ok)} of {PR_PREDICTS} predicts answered "
              f"200 ({len(shed)} shed at the deadline {sorted(set(shed))}) "
              f"in {wall:.3f} s; vs an in-process engine.predict: "
              f"max_abs_err {err_max:.3e} tol {GW_TOL:.0e}")
        check(set(shed) <= {"RequestTimeout"}, f"promote: predicts {shed}")
        check({i for i, _ in ok} == set(range(len(preds))),
              "promote: a scene was never answered")
        check(err_max <= GW_TOL, "promote: a child disagrees with the "
              "in-process engine")

        before_sigterm()
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        if code != 0:
            fail(f"promote gateway exited {code}: {stderr_tail()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()

    # each child's totals, from its own stream (written at its exit)
    obs_path = os.path.join(obs_dir, "obs")
    spawns = {e["pid"]: e for e in load_events(
        os.path.join(obs_path, "events.jsonl"))[0]
        if e.get("name") == "gateway/worker_spawn"}
    fwd = 0
    for r in rows:
        wk, _ = load_events(os.path.join(
            obs_path, f"events_worker_default_{r['replica']}.jsonl"))
        ex = [e for e in wk if e.get("name") == "worker/exit"]
        check(len(ex) == 1, f"promote: child {r['replica']} wrote "
              f"{len(ex)} exit records")
        ex = ex[0]
        batches = sum(1 for e in wk if e.get("name") == "serve/execute"
                      and "workload" not in e)
        ln = ex.get("launches") or {}
        sp = spawns.get(r["pid"], {})
        print(f"promote (b) child {r['replica']} (pid {ex['pid']}, "
              f"{ex.get('device_name', ex['device'])}): {batches} executed "
              f"batches "
              f"(the 2 warmup rungs included), fused_edge_fwd "
              f"{ln.get('fused_edge_fwd')} launches, "
              f"{ln.get('fused_edge_fwd_f32')} on fused_edge_fwd_f32_kernel "
              f"(expected L x max_batch = {per_batch} per batch: "
              f"{per_batch * batches}), {ln.get('fused_edge_fwd_tc')} on "
              f"the tensor-core kernel; peak allocated "
              f"{mib(ex.get('max_memory_allocated'))}, reserved "
              f"{mib(ex.get('memory_reserved'))}; spawn event: digest "
              f"{sp.get('params_digest')}, {sp.get('spawn_s')} s")
        check(ln.get("fused_edge_fwd_f32") == per_batch * batches
              and ln.get("fused_edge_fwd") == ln.get("fused_edge_fwd_f32")
              and ln.get("fused_edge_fwd_tc") == 0 and batches > 2,
              f"promote: child {r['replica']} launches {ln} for {batches} "
              f"batches")
        check(ex["pid"] == r["pid"] and sp.get("params_digest") == digest,
              f"promote: child {r['replica']}'s records disagree")
        fwd += int(ln["fused_edge_fwd"])
    return dict(fwd=fwd, p50=pct(lat, 50), p99=pct(lat, 99),
                rps=len(ok) / wall)


def drill_fleet(root, dev, tmp):
    """Phase 13 (c)'s fleet: the same config in this process, so the chaos
    injectors reach its registry. Returns (config, registry, seconds to
    warmed)."""
    from distegnn_tpu_torch import obs
    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.serve.registry import ModelRegistry

    path = promote_yaml(root, tmp, "fleet_c.yaml",
                        os.path.join(tmp, "conveyor_c"))
    cfg = load_config(path)
    obs.configure(log_dir=os.path.join(tmp, "obs_c"))
    t0 = time.perf_counter()
    reg = ModelRegistry.from_config(cfg, device=dev).start()
    reg.warmup([int(n) for n in cfg.serve.gateway.warmup_nodes])
    return cfg, reg, time.perf_counter() - t0


def promote_drill_phase(dev, tmp, digest, kind, cfg, reg, up_s):
    """Phase 13 (c) and (d) on :func:`drill_fleet`'s fleet: JAX's
    four-phase drill under live traffic, then SIGSTOP and an armed spawn
    failure."""
    import threading

    from distegnn_tpu_torch.obs.metrics import MetricsRegistry
    from distegnn_tpu_torch.serve.transport import Gateway
    from distegnn_tpu_torch.testing.promote_drill import (
        DRIFT_SCALE, LiveTraffic, run_promote_drill, run_worker_faults)

    check(reg.ready(), f"promote: fleet not ready: {reg.health()}")
    entry = reg.get("default")
    rows = entry.replicas.health()
    print(f"promote (c) fleet in process: 3 children up and warmed in "
          f"{up_s:.1f} s, started while (b)'s gateway drained: pids "
          f"{[r['pid'] for r in rows]} (this process {os.getpid()})")
    check(all(r["backend"] == "process" and not r["degraded"]
              and r["pid"] not in (None, os.getpid())
              and r.get("params_digest") == digest
              and r.get("device") == kind
              for r in rows), f"promote: in-process fleet rows {rows}")
    gw = Gateway(reg, host="127.0.0.1", port=0,
                 max_inflight=int(cfg.serve.gateway.max_inflight),
                 drain_grace_s=float(cfg.serve.gateway.drain_grace_s),
                 metrics_registry=MetricsRegistry(),
                 promote=dict(cfg.promote))
    server = threading.Thread(target=gw.serve_forever, daemon=True)
    server.start()
    try:
        bodies = [predict_body(scene(n, seed=1400 + i))
                  for i, n in enumerate(PR_DRILL_SCENES)]
        traffic = LiveTraffic(gw.port, "default", bodies, clients=2,
                              pause_s=0.005).start()
        rec = run_promote_drill(
            gw, reg, "default", bodies[0], os.path.join(tmp, "stage"),
            traffic=traffic, log=lambda msg: print(f"promote (c) {msg}"))
        check(rec.get("error") is None, f"promote: the drill raised "
              f"{rec.get('error')}")
        ph, t = rec["phases"], rec["traffic"]
        print(f"promote (c) drill: {rec['drill_s']} s, {rec['published']} "
              f"candidates published; live traffic {t['requests']} "
              f"predicts, {t['completed']} answered 200, lost {t['lost']}, "
              f"errors {t['errors']} {t['statuses']}; orphan swept "
              f"{rec['tmp_swept']}; /readyz fleet_coherent "
              f"{(rec['readyz'] or {}).get('fleet_coherent')}; the x"
              f"{DRIFT_SCALE} candidate caught by the "
              f"{ph['drift'].get('caught_by')}")
        check(ph["promote"].get("outcome") == "promoted",
              f"promote: phase 1 {ph['promote']}")
        check(ph["publisher_kill"]["ok"], f"promote: phase 2 "
              f"{ph['publisher_kill']}")
        ck = ph["canary_kill"]
        check((ck.get("outcome"), ck.get("reason"), ck.get("killed_via"))
              == ("rolled_back", "canary_died", "kill9") and ck["respawned"]
              and ck.get("new_pid") not in (None, ck.get("killed_pid"))
              and not ck.get("degraded"), f"promote: phase 3 {ck}")
        check((ph["drift"].get("outcome"), ph["drift"].get("reason"))
              == ("rolled_back", "drift"), f"promote: phase 4 "
              f"{ph['drift']}")
        check(rec["ok"] and t["lost"] == 0 and t["errors"] == 0,
              f"promote: the drill failed: {rec}")
        rows = entry.replicas.health()
        check(not any(r["degraded"] for r in rows), f"promote: a replica "
              f"degraded with no spawn failure armed: {rows}")
        # the children alive now: their launches since spawn (canaries and
        # shadow predicts included; a killed child's count died with it)
        fwd = 0
        for r in entry.replicas.replicas:
            st = r.queue.worker.call("stats")
            fwd += int(st["launches"]["fused_edge_fwd"])
            check(st["launches"]["fused_edge_fwd_tc"] == 0,
                  f"promote: a child launched the tensor-core kernel {st}")
        print(f"promote (c): fused_edge_fwd launches in the 3 children "
              f"alive after the drill: {fwd} (canaries, fleet swaps, "
              f"shadow and live predicts; the killed child's count died "
              f"with it)")
        faults = run_worker_faults(
            reg, "default", 1, 0,
            log=lambda msg: print(f"promote (d) {msg}"))
        check(faults["ok"], f"promote: worker faults {faults}")
        sg, sf = faults["sigstop"], faults["spawn_failure"]
        print(f"promote (d): SIGSTOP caught by heartbeat staleness in "
              f"{sg['detect_s']} s (timeout {PR_HB_TIMEOUT_S} s), "
              f"SIGKILL-escalated {sg['escalated']}, respawned as pid "
              f"{sg['new_pid']} {sg['respawn_s']} s after the stop; spawn "
              f"failure degraded in {sf['degrade_s']} s (event seen "
              f"{sf['degraded_event']}), a real child (pid "
              f"{sf['new_pid']}) back {sf['recover_s']} s after the arm")
    finally:
        gw.drain()
        gw.close()
        server.join(30)
    return dict(fwd=fwd)


# ---- phase 14: tiled serving -------------------------------------------------

TL_SCENE_N = 40000     # (a): a radius-graph scene above serve.max_nodes 16384
TL_TILE_N = 8192       # (a)'s serve.tiled.tile_nodes: at least 4 tiles
TL_SIDE = 100          # (b): JAX's lattice, side^3 = 10^6 nodes
TL_BOUND = 524288      # (b): the `bounded` model's serve.tiled.max_nodes
TL_TOL = 1e-5          # tests/test_torch_tiled.py's bound, scale-normalized


def lattice_scene(side):
    """JAX ``tests/test_tiled.py`` ``_lattice_scene``: side^3 nodes on a
    jittered lattice with +/-x neighbour edges (~2 side^3 edges), the
    distance twice as edge features."""
    import numpy as np

    n = side ** 3
    idx = np.arange(n, dtype=np.int64)
    x, y, z = idx // (side * side), (idx // side) % side, idx % side
    loc = np.stack([x, y, z], axis=1).astype(np.float32)
    loc += np.random.default_rng(0).uniform(-0.1, 0.1, loc.shape
                                            ).astype(np.float32)
    src = idx[x < side - 1]
    dst = src + side * side
    ei = np.concatenate([np.stack([src, dst]), np.stack([dst, src])],
                        axis=1).astype(np.int32)
    d = np.linalg.norm(loc[ei[0]] - loc[ei[1]], axis=1)[:, None]
    vel = np.zeros_like(loc)
    vel[:, 0] = 0.01
    return {"node_feat": np.ones((n, 1), np.float32), "loc": loc,
            "vel": vel, "edge_index": ei,
            "edge_attr": np.repeat(d, 2, axis=1).astype(np.float32)}


def tiled_yaml(root, tmp):
    """configs/nbody_serve.yaml + the fused edge path + ``serve.tiled`` on
    (its defaults: tile_nodes 65536), routed as ``tiled`` and as
    ``bounded`` (serve.tiled.max_nodes TL_BOUND)."""
    import yaml

    with open(os.path.join(root, "configs", "nbody_serve.yaml")) as f:
        raw = yaml.safe_load(f)
    over = {"model": {"edge_impl": "fused"}, "data": {"edge_block": BLOCK}}
    raw["serve"]["models"] = [
        {"name": "tiled", "overrides": dict(
            over, serve={"tiled": {"enable": True}})},
        {"name": "bounded", "overrides": dict(
            over, serve={"tiled": {"enable": True, "max_nodes": TL_BOUND}})}]
    path = os.path.join(tmp, "tiled.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def rss_mib():
    """(this process's resident MiB now, its peak so far)."""
    import resource

    now = None
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                now = int(line.split()[1]) / 1024
    return now, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def norm_err(a, b):
    import numpy as np

    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def tiled_phase(root, dev):
    """Phase 14 (see the module docstring). Its files go to a temporary
    directory that is removed afterwards."""
    with phase_tmp("chip_smoke_tiled_") as tmp:
        return _tiled_phase(root, dev, tmp)


def _tiled_phase(root, dev, tmp):
    import threading

    import numpy as np
    import torch

    from distegnn_tpu_torch import obs
    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.obs.metrics import MetricsRegistry
    from distegnn_tpu_torch.ops import edge_pipeline as ep
    from distegnn_tpu_torch.ops.graph import pad_graphs
    from distegnn_tpu_torch.serve import engine_with_params_from_config
    from distegnn_tpu_torch.serve.registry import ModelRegistry
    from distegnn_tpu_torch.serve.transport import Gateway

    t_phase = time.perf_counter()
    # (a) a 40000-node scene: the tiled predict against the monolithic
    # fused forward of the same module, called on the model directly
    cfg = load_config(os.path.join(root, "configs", "nbody_serve.yaml"),
                      {"model.edge_impl": "fused", "data.edge_block": BLOCK,
                       "serve.tiled.enable": True,
                       "serve.tiled.tile_nodes": TL_TILE_N})
    model, eng = engine_with_params_from_config(cfg, device=dev)
    m = cfg.model
    L = int(m.n_layers)
    g = scene(TL_SCENE_N, seed=1400)
    n = g["loc"].shape[0]
    check(n > int(cfg.serve.max_nodes) and eng.tiled_enabled,
          f"tiled (a): {n} nodes not above serve.max_nodes or tiled off")
    with torch.no_grad():
        batch = pad_graphs([g], edge_block=BLOCK, split_remote=True).to(dev)
        mono = model(batch)[0][0, :n].cpu().numpy()
    del batch
    reset_fused_counts()
    out = eng.predict_tiled(dict(g))
    torch.cuda.synchronize()
    T = out["tiles"]
    fwd, tc = fwd_counts()
    f32 = ep.fused_edge_layer.f32_launches
    err = norm_err(out["prediction"], mono)
    print(f"tiled (a): configs/nbody_serve.yaml + fused (H={m.hidden_nf} "
          f"L={L} C={m.virtual_channels}), {n} nodes "
          f"(serve.max_nodes {cfg.serve.max_nodes}), tile_nodes "
          f"{TL_TILE_N}: {T} tiles, padded_nodes {out['padded_nodes']}, "
          f"halo_fraction {out['halo_fraction']:.4f}; vs the monolithic "
          f"forward max abs err / max |mono| = {err:.3e} (tol {TL_TOL}); "
          f"fused_edge_fwd {fwd} (f32 kernel {f32}, tensor-core {tc}, want "
          f"L x T = {L * T}); prep_ms {out['prep_ms']:.1f}, total_ms "
          f"{out['total_ms']:.1f}")
    check(T >= 4, f"tiled (a): {T} tiles < 4")
    check(np.isfinite(out["prediction"]).all()
          and out["prediction"].shape == (n, 3), "tiled (a): bad prediction")
    check(err <= TL_TOL, f"tiled (a): {err:.3e} from the monolithic forward")
    check((fwd, f32, tc) == (L * T, L * T, 0),
          f"tiled (a): launches {(fwd, f32, tc)} != {(L * T, L * T, 0)}")
    launches_a = fwd
    del model, eng

    # (b) the million-node lattice through the HTTP gateway
    path = tiled_yaml(root, tmp)
    cfg = load_config(path)
    obs.configure(log_dir=os.path.join(tmp, "obs"))
    reg = ModelRegistry.from_config(cfg, device=dev)
    entry = reg.get("tiled")
    eng = entry.engine
    model = eng.model
    reg.start()
    reg.warmup([int(k) for k in cfg.serve.gateway.warmup_nodes])
    gw = Gateway(reg, host="127.0.0.1", port=0,
                 metrics_registry=MetricsRegistry())
    threading.Thread(target=gw.serve_forever, daemon=True).start()
    port = gw.port
    try:
        t0 = time.perf_counter()
        g = lattice_scene(TL_SIDE)
        n, e = g["loc"].shape[0], g["edge_index"].shape[1]
        body = json.dumps({
            "positions": b64(g["loc"]), "velocities": b64(g["vel"]),
            "node_feat": b64(g["node_feat"]),
            "edge_attr": b64(g["edge_attr"]),
            "edge_index": b64(g["edge_index"], "<i4"), "encoding": "b64",
            "session_id": "giant"}).encode()
        rss0 = rss_mib()
        print(f"tiled (b): lattice {n} nodes, {e} edges, request "
              f"{len(body) / 2 ** 20:.1f} MiB, built in "
              f"{time.perf_counter() - t0:.1f} s; host RSS "
              f"{rss0[0]:.0f} MiB (peak so far {rss0[1]:.0f} MiB)")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_fused_counts()
        status, raw, ms = http_call(port, "POST", "/v1/models/tiled/predict",
                                    body, timeout=900)
        check(status == 200, f"tiled (b): {status} {raw[:300]!r}")
        resp = json.loads(raw)
        st = resp["tiled"]
        pred = unb64(resp["prediction"])
        Tb = st["tiles"]
        dev_peak = torch.cuda.max_memory_allocated()
        rss1 = rss_mib()
        print(f"tiled (b): 200 in {ms:.1f} ms; tiles {Tb}, layers "
              f"{st['layers']}, padded_nodes {st['padded_nodes']}, "
              f"halo_fraction {st['halo_fraction']:.6f}, work_imbalance "
              f"{st['work_imbalance']}, stall_fraction "
              f"{st['stall_fraction']:.6f}, prep_ms {st['prep_ms']:.1f}, "
              f"total_ms {st['compute_ms']:.1f}; device peak "
              f"{mib(dev_peak)}; host RSS {rss1[0]:.0f} MiB (peak "
              f"{rss1[1]:.0f} MiB)")
        check(pred.shape == (n, 3) and np.isfinite(pred).all(),
              "tiled (b): bad prediction")
        check(Tb >= 2 and resp["session"]["hit"] is False,
              f"tiled (b): tiles {Tb}, session {resp['session']}")
        status, lines, first_ms, s_ms = http_stream(
            port, "/v1/models/tiled/predict?stream=1", body)
        done = lines[-1] if lines else {}
        progress = [ln for ln in lines[:-1] if "tile" in ln]
        check(status == 200 and done.get("done") is True
              and not done.get("cancelled"),
              f"tiled (b) stream: {status} {str(done)[:300]}")
        s_err = norm_err(unb64(done["prediction"]), pred)
        print(f"tiled (b) stream: {len(progress)} progress lines (want "
              f"L x T = {L * Tb}), first line {first_ms:.1f} ms, done "
              f"{s_ms:.1f} ms, session hit {done['session']['hit']}, vs the "
              f"buffered answer {s_err:.3e}")
        check(len(progress) == L * Tb and done["session"]["hit"] is True,
              "tiled (b) stream: progress lines or session")
        check(s_err <= TL_TOL, f"tiled (b) stream: {s_err:.3e} from buffered")
        status, raw, _ = http_call(port, "POST",
                                   "/v1/models/bounded/predict", body,
                                   timeout=900)
        over = json.loads(raw)
        print(f"tiled (b) bounded: {status} {over.get('type')}: "
              f"{over.get('error')}")
        check(status == 413 and "serve.tiled.max_nodes" in over["error"],
              f"tiled (b) bounded: {status} {raw[:300]!r}")
        torch.cuda.synchronize()
        fwd, tc = fwd_counts()
        f32 = ep.fused_edge_layer.f32_launches
        keys = [k for k in eng.shapes_seen if k[0] == "tile_layer"]
        print(f"tiled (b): fused_edge_fwd {fwd} (f32 kernel {f32}, "
              f"tensor-core {tc}, want 2 x L x T = {2 * L * Tb}); "
              f"tile_layer keys {keys}")
        check((fwd, f32, tc) == (2 * L * Tb, 2 * L * Tb, 0),
              f"tiled (b): launches {(fwd, f32, tc)}")
        check(len(keys) == 1, f"tiled (b): tile_layer keys {keys}")
        launches_b = fwd

        # (c) the forward kernel at the tile shape: the session's cached
        # plan, its heaviest tile as the executor builds it
        plan, hit = eng.prep_cache.prepare_tile(
            "giant", g, lambda: fail("tiled (c): the plan was not cached"))
        spec = max(plan.tiles, key=lambda s: s.edge_index.shape[1])
        p = plan.perm
        tb = eng.tiled._tile_batch(
            plan, spec, g["loc"][p], g["vel"][p], g["node_feat"][p], None,
            g["loc"].mean(axis=0)[None]).to(dev)
        arrs, N, E, active = kernel_inputs(tb)
        H = int(m.hidden_nf)
        pe = model.gcl[0].phi_e_fused
        gen = torch.Generator(device=dev).manual_seed(14)
        with torch.no_grad():
            h = torch.randn((N, H), generator=gen, device=dev)
            hr = (h @ pe.w1[:H]).contiguous()
            hc = (h @ pe.w1[H:2 * H]).contiguous()
            args = (tb.loc[0].contiguous(), hr, hc, *arrs, edge_weights(pe),
                    BLOCK, "f32")
            kerr = compare("tiled kernel", "f32", FWD_NAMES,
                           ep.fused_edge_layer(*args),
                           ep.fused_edge_layer_ref(*args))
            k_ms = cuda_ms(lambda: ep.fused_edge_layer(*args))
            graph_ms = cuda_ms_batches(lambda: ep.fused_edge_layer(*args),
                                       launches=20, batches=3)
            plain_ms = cuda_ms(lambda: ep.fused_edge_layer_ref(*args),
                               reps=5)
        nbytes, flops = fwd_work(N, E, active, H, 4)
        b_ms, b_by = bound(nbytes, flops, "f32")
        remote = int(tb.remote_edge_mask.sum())
        print(f"tiled (c): tile {plan.tiles.index(spec)} N={N} "
              f"E_slots={E} in_window={active} remote={remote} "
              f"(own {spec.n_own}, halo {spec.n_halo}): kernel "
              f"{k_ms:.4f} ms eagerly, {graph_ms:.4f} as CUDA-graph "
              f"replays, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}: {nbytes} B, {flops} flop)")
        row = dict(err=kerr, ms=k_ms, graph_ms=graph_ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by)
    finally:
        gw.drain()
        gw.close()
    secs = time.perf_counter() - t_phase
    print(f"tiled phase: {secs:.1f} s")
    return {"launches": launches_a + launches_b, "row": row,
            "shape": f"N={N}"}


# ------------------------------------------------ phase 15: every model family

FAMILIES = ("FastRF", "FastSchNet", "SchNet", "EGNN", "RF", "TFN",
            "SE3Transformer", "FastTFN", "Linear")
# systems a micro-step, 100 bodies each (9900 edges): the published 250
# where the autograd state fits the card, cut where the per-edge tensors
# saved for the backward would not. The SE(3) families' RadialFunc keeps
# [E, m_out, m_in, 2 min(l_in, l_out) + 1] per degree pair and layer: at
# nf 32 and degrees 0-1 that is 6144 f32, ~24.6 KB an edge and layer
# (~60 GB at 250 systems). Peaks measured on an H100 (the first phase-15
# run): TFN 19.1 GiB at 25 systems, SE3Transformer (its value and key
# convs) 20.0 GiB at 10, so 50 and 20 stay under ~40 GiB; FastTFN 21.7 GiB
# and SchNet (~2.8 KB an edge in each of 6 interactions) ran at 125 and
# run the published 250.
FAM_BATCH = {"TFN": 50, "SE3Transformer": 20}
FAM_SYSTEMS = (500, 250, 250)      # train / valid / test trajectories
FAM_TIMED = 3
FAM_SERVE = ("FastRF", "FastSchNet", "FastTFN")
FAM_SERVE_N = 1500


def family_blocked_want(name, L, micro=0, evals=0):
    """FastRF / FastSchNet launches on a blocked batch with the pairing
    (hoist_edge_mlp, fuse_agg, f32), by (F, type), from the code: per
    forward 1 blocked_plan; per layer a gather of x [E, 3] (its paired
    column gather is a plain take) and a seg_sum of the translations [E, 3]
    (FastRF: its only aggregation); FastSchNet adds the hoisted products'
    row gathers, h @ W_e [E, H] and the gate's h @ W_g [E, 1], and the edge
    features' mean [E, H] (agg_rows_pair is two seg_sums on a blocked
    batch). The backward of a micro-step: a gather of each seg_sum's
    cotangent (but FastSchNet's last edge-feature mean, which reaches only
    the unused last h), and a seg_sum for each row gather and paired column
    gather whose input needs a gradient: x in layers 1..L-1 (layer 0's is
    the batch's), the gate's product in every layer, h @ W_e in layers
    0..L-2 (the last layer's edge features reach only its h). Returns (seg
    widths, gather widths, plans)."""
    H = HIDDEN
    seg, gat = collections.Counter(), collections.Counter()
    n_fwd = micro + evals
    seg[(3, "f32")] += L * n_fwd + 2 * (L - 1) * micro
    gat[(3, "f32")] += L * n_fwd + L * micro
    if name == "FastSchNet":
        seg[(H, "f32")] += L * n_fwd + 2 * (L - 1) * micro
        seg[(1, "f32")] += 2 * L * micro
        gat[(H, "f32")] += L * n_fwd + (L - 1) * micro
        gat[(1, "f32")] += L * n_fwd
    return ({k: v for k, v in seg.items() if v},
            {k: v for k, v in gat.items() if v}, n_fwd)


def family_scan_want(name, L, micro=0, evals=0):
    """FastRF / FastSchNet prefix scans on a plain paired batch, by
    ("prefix", type, F), from the code: per forward and layer one packed
    aggregation (FastRF: the [E, 3] translations and the count, F 4;
    FastSchNet: agg_rows_pair's [E, 3 + H + 1]); the backward of a packed
    sum is a gather, and each row gather / paired column gather whose input
    needs a gradient is one scan: x [E, 3] in layers 1..L-1, FastSchNet's
    h @ W_e [E, H] and gate h @ W_g [E, 1] in every layer (the packed
    stream carries the last layer's edge features too, so their zero
    cotangent runs the gathers' backward). No suffix scan."""
    H = HIDDEN
    n_fwd = micro + evals
    if name == "FastRF":
        want = {("prefix", "f32", 4): L * n_fwd,
                ("prefix", "f32", 3): 2 * (L - 1) * micro}
    else:
        want = {("prefix", "f32", H + 4): L * n_fwd,
                ("prefix", "f32", H): 2 * L * micro,
                ("prefix", "f32", 1): 2 * L * micro,
                ("prefix", "f32", 3): 2 * (L - 1) * micro}
    return {k: v for k, v in want.items() if v}


def loader_batches(cfg, ds, dev):
    """The train loader's epoch-1 batches on the card."""
    from distegnn_tpu_torch.main import make_loaders

    loader = make_loaders(cfg, *ds)[0]
    loader.set_epoch(1)
    return [b.to(dev) for b in loader]


def batch_equivariance(label, model, batch):
    """One forward of ``model`` on ``batch`` and on the batch rotated and
    translated (a random proper rotation and offset) on the card: the
    predicted coordinates of the real nodes (and the virtual coordinates)
    moved the same way, within TOL_EQUIV."""
    import dataclasses

    import torch

    rng = torch.Generator().manual_seed(7)
    q, r = torch.linalg.qr(torch.randn((3, 3), generator=rng,
                                       dtype=torch.float64))
    R = q * torch.sign(torch.diagonal(r))
    # a proper rotation: TFN's degree-1 x degree-1 paths are SE(3)-, not
    # reflection-, equivariant
    R[:, 0] *= torch.sign(torch.linalg.det(R))
    R = R.float().to(batch.loc.device)
    t = torch.randn(3, generator=rng).to(batch.loc.device)
    rot = dataclasses.replace(batch, loc=batch.loc @ R.T + t,
                              vel=batch.vel @ R.T,
                              target=batch.target @ R.T + t,
                              loc_mean=batch.loc_mean @ R.T + t)
    model.eval()
    with torch.no_grad():
        x, X = model(batch)
        xr, Xr = model(rot)
    m = batch.node_mask > 0
    err = float((x @ R.T + t - xr)[m].abs().max())
    if X is not None:
        err = max(err, float((R @ X + t[:, None] - Xr).abs().max()))
    print(f"{label}equivariance on the card (rotation + translation, "
          f"{int(m.sum())} real nodes): max_abs_err={err:.3e} "
          f"tol={TOL_EQUIV:.1e}")
    check(math.isfinite(err) and err <= TOL_EQUIV,
          f"{label}equivariance violated")


# phase 15: a parameter gradient held against its own max |plain|, but
# with a floor of this fraction of the model's largest gradient entry: the
# f32 families' virtual-coordinate heads (FastRF's edge_mlp_vr) have
# gradients that cancel over the nodes to ~0, where two summation orders
# leave noise of the order of the summed terms (0.61 of their own max on
# the CPU against the plain versions, 1e-7 of the model's max)
FAM_GRAD_FLOOR = 1e-5


def floored_param_errors(a, b, floor):
    """Each parameter's max abs gradient error of update ``a`` against
    ``b`` over max(its own max |b|, ``floor`` x b's largest entry), and that
    largest entry."""
    top = max(float(g.abs().max()) for g in b["grad"].values())
    return {n: float((g - b["grad"][n]).abs().max())
            / max(float(b["grad"][n].abs().max()), floor * top)
            for n, g in a["grad"].items()}, top


def update_agrees(label, k, other, name):
    """A first update through the kernels against one through ``name``:
    losses, gradient norm and max gradient entry within TOL_TRAIN, and each
    parameter's gradient within TOL_TRAIN of max(its own max |plain|,
    FAM_GRAD_FLOOR x the largest)."""
    import torch

    errs, _ = update_distance(k, other)
    per, top = floored_param_errors(k, other, FAM_GRAD_FLOOR)
    worst = sorted(per.items(), key=lambda kv: -kv[1])
    print(f"{label}first update, kernels vs {name}: losses "
          f"{errs['loss_with_mmd']:.3e} / {errs['loss']:.3e}, gradient norm "
          f"{errs['grad norm']:.3e}, max abs / max {errs['grad']:.3e}, l2 "
          f"{errs['grad l2']:.3e}; worst parameters (over max(own max, "
          f"{FAM_GRAD_FLOOR:.0e} x {top:.3e})): "
          + ", ".join(f"{nm} {v:.3e}" for nm, v in worst[:4])
          + f" (tol {TOL_TRAIN:.0e})")
    check(all(errs[key] <= TOL_TRAIN for key in
              ("loss_with_mmd", "loss", "grad norm", "grad"))
          and worst[0][1] <= TOL_TRAIN and torch.isfinite(
              torch.tensor(worst[0][1])),
          f"{label}first update: the kernels disagree with the {name}")


def cumsum_update_agrees(label, k, p, sc, floor=0.0):
    """Phase 6's rule for a first update through the scan kernel (``k``),
    its plain version (``p``) and the exact scatter lowering (``sc``): the
    kernel's aggregate distances from scatter at most SCATTER_FACTOR x the
    plain version's + SCATTER_FLOOR, the gradient's max entry within
    TOL_TRAIN and each parameter within SCATTER_PARAM, and the kernel within
    those bounds of its plain version. ``floor`` > 0 holds each parameter
    against max(its own max, floor x the largest gradient entry) instead of
    its own max (phase 15: FAM_GRAD_FLOOR)."""
    ek, pk = update_distance(k, sc)
    ep_, pp = update_distance(p, sc)
    ekp, pkp = update_distance(k, p)
    if floor:
        pk, pp, pkp = (floored_param_errors(a, b, floor)[0] for a, b in
                       ((k, sc), (p, sc), (k, p)))
    ek["param"], ep_["param"], ekp["param"] = (
        max(pk.values()), max(pp.values()), max(pkp.values()))
    ratio = ("loss_with_mmd", "loss", "grad norm", "grad l2")
    bounds = {"grad": TOL_TRAIN, "param": SCATTER_PARAM}
    for key in ratio + tuple(bounds):
        rule = (f"kernel <= {SCATTER_FACTOR} x plain + {SCATTER_FLOOR:.0e}"
                if key in ratio else f"both <= {bounds[key]:.3e}")
        kp_tol = SCATTER_PARAM if key == "param" else TOL_TRAIN
        print(f"{label}first update vs scatter, {key}: kernel "
              f"{ek[key]:.3e}, plain version {ep_[key]:.3e} ({rule}); "
              f"kernel vs plain version {ekp[key]:.3e} (<= {kp_tol:.3e})")
    worst = sorted(pk.items(), key=lambda kv: -kv[1])
    print(f"{label}first update vs scatter, worst 6 parameters (kernel): "
          + ", ".join(f"{nm} {v:.3e} (plain {pp[nm]:.3e})"
                      for nm, v in worst[:6]))
    bad = [key for key in ratio
           if ek[key] > SCATTER_FACTOR * ep_[key] + SCATTER_FLOOR]
    bad += [key for key, b in bounds.items() if max(ek[key], ep_[key]) > b]
    bad += [f"kernel vs plain {key}" for key in ratio + ("grad",)
            if ekp[key] > TOL_TRAIN]
    bad += ["kernel vs plain param"] if ekp["param"] > SCATTER_PARAM else []
    check(not bad, f"{label}the cumsum lowering strays from the scatter "
          f"lowering ({bad})")


def scan_row(dev, gen, B, E, F, dt=None, rev=False, label=""):
    """The scan kernel at [B, E, F] timed beside its plain version,
    torch.cumsum (the prefix direction) and its bound; its max abs error
    against the plain version."""
    import torch

    from distegnn_tpu_torch.ops import cumsum as CS

    f32 = torch.float32
    x = torch.randn((B, E, F), generator=gen, device=dev).to(dt or f32)
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
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
    print(f"scan time {label}[{B}, {E}, {F}] {str(x.dtype)[6:]}: {ms:.4f} "
          f"ms/launch, plain {plain_ms:.4f} ms, torch.cumsum {lib} ms, "
          f"bound {b_ms:.4f} ms ({b_by}: {nbytes} B), {b_ms / ms:.3f} of "
          f"bound; max abs err vs plain {err:.3e}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, err=err,
                bound_ms=b_ms, bound_by=b_by, shape=f"[{B}, {E}, {F}]")


def family_phase(root, dev):
    """Phase 15: every family the factory serves, through the port's entry
    points, on configs/nbody_fastegnn.yaml's model width (H=64, L=4, C=3)
    and 100-body full graphs made by the port's n-body generator: (a) one
    epoch of each family through main.run with finite losses, moved
    parameters, an equivariant forward on the card and timed micro-steps;
    (b) FastRF and FastSchNet on the blocked layout with the one-hot
    kernels, exact launches by width, the first update against the plain
    versions and the kernels timed at these shapes; (c) the same two with
    segment_impl cumsum: the scan's launches by width, the first update
    through the kernel, its plain version and scatter, the scan timed;
    (d) three Fast* families served. Files and logs in a temporary
    directory, removed afterwards."""
    with phase_tmp("chip_smoke_families_") as tmp:
        return _family_phase(root, dev, tmp)


def _family_phase(root, dev, tmp):
    import numpy as np
    import torch

    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.data.loader import GraphDataset
    from distegnn_tpu_torch.data.nbody_sim import generate_nbody_files
    from distegnn_tpu_torch.main import process_dataset_edge_cutoff
    from distegnn_tpu_torch.ops import cumsum as CS
    from distegnn_tpu_torch.ops.blocked import slot_ids
    from distegnn_tpu_torch.serve import engine_with_params_from_config

    t_phase = time.perf_counter()
    path = os.path.join(root, "configs", "nbody_fastegnn.yaml")
    data_dir = os.path.join(tmp, "data")
    n_tr, n_va, n_te = FAM_SYSTEMS
    base = load_config(path)
    d0 = base.data
    t0 = time.perf_counter()
    # frames up to frame_T at the reference's sample_freq 100
    generate_nbody_files(os.path.join(data_dir, d0.dataset_name),
                         n_isolated=100, num_train=n_tr, num_valid=n_va,
                         num_test=n_te, length=(d0.frame_T + 1) * 100,
                         sample_freq=100, seed=43, device=dev)
    t1 = time.perf_counter()
    run_len = {"data.data_dir": data_dir, "train.epochs": 1,
               "log.test_interval": 1,
               "log.log_dir": os.path.join(tmp, "logs")}
    cfg0 = load_config(path, run_len)
    files = process_dataset_edge_cutoff(cfg0.data, seed=cfg0.seed)
    graphs = [GraphDataset(f).graphs for f in files]
    m = cfg0.model
    print(f"15 families: {n_tr}/{n_va}/{n_te} 100-body systems by the "
          f"port's generator in {t1 - t0:.1f} s, full graphs (E="
          f"{graphs[0][0]['edge_index'].shape[1]}) in "
          f"{time.perf_counter() - t1:.1f} s; H={m.hidden_nf} "
          f"L={m.n_layers} C={m.virtual_channels} node_feat_nf="
          f"{m.node_feat_nf} edge_attr_nf={m.edge_attr_nf} frames "
          f"{cfg0.data.frame_0}->{cfg0.data.frame_T}")
    check((m.hidden_nf, m.n_layers, m.virtual_channels) == (HIDDEN, 4, 3),
          "configs/nbody_fastegnn.yaml's width changed")
    L = m.n_layers

    def datasets(B):
        # 2 micro-steps, 1 valid and 1 test batch at B systems a batch
        return [GraphDataset(g[:k]) for g, k in
                zip(graphs, (2 * B, B, B))]

    res = {"train": {}, "blocked": {}, "cumsum": {}, "serve": {}}
    # (a) every family, as published but for the depth of the run
    for name in FAMILIES:
        B = FAM_BATCH.get(name, d0.batch_size)
        label = f"15a {name} B={B}: "
        cfg = load_config(path, {**run_len, **EAGER,
                                 "model.model_name": name,
                                 "data.batch_size": B})
        ds = datasets(B)
        init_sd, state, _, micro, evals = drive_train(
            cfg, ds, dev, lambda: None, lambda: None, label)
        evb = loader_batches(cfg, [ds[1], ds[1], ds[1]], dev)[0]
        batch_equivariance(label, state.model, evb)
        del state, evb
        batches = loader_batches(cfg, ds, dev)
        n_real = float(batches[0].node_mask.sum())
        k = first_update(cfg, init_sd, batches, dev, counts=lambda: (),
                         time_extra=FAM_TIMED)
        n_params = sum(v.numel() for v in init_sd.values())
        res["train"][name] = dict(B=B, ms=step_times(label, k, n_real),
                                  params=n_params, nodes=n_real,
                                  edges=int(batches[0].edge_mask.sum()))
        del batches, k
        torch.cuda.empty_cache()

    # (b) the blocked one-hot kernels
    gen = torch.Generator(device=dev).manual_seed(15)
    for name in ("FastRF", "FastSchNet"):
        label = f"15b {name} blocked: "
        ov = {**run_len, "model.model_name": name,
              "data.edge_block": RB_BLOCK, "model.blocked_impl": "pallas"}
        cfg = load_config(path, {**ov, **EAGER})
        ds = datasets(cfg.data.batch_size)

        def read():
            return blocked_counts(), blocked_widths()

        # the main path: counts 0 just before, read just after
        init_sd, _, (n, widths), micro, evals = drive_train(
            cfg, ds, dev, reset_blocked_counts, read, label)
        want = family_blocked_want(name, L, micro=micro, evals=evals)
        print(f"{label}launches: blocked_seg_sum {n[0]} {widths[0]}, "
              f"blocked_gather {n[1]} {widths[1]}, blocked_plan {n[2]} "
              f"(expected {want}: {micro} micro-steps, {evals} eval "
              f"forwards)")
        check(widths == want[:2] and n == (sum(want[0].values()),
                                           sum(want[1].values()), want[2]),
              f"{label}launch counts {n} {widths} != {want}")
        batches = loader_batches(cfg, ds, dev)
        b0 = batches[0]
        check(b0.edge_block == RB_BLOCK and b0.edge_pair is not None,
              f"{label}the batch is not blocked with the pairing")
        k = first_update(cfg, init_sd, batches, dev, counts=blocked_counts,
                         time_extra=FAM_TIMED)
        p = first_update(cfg, init_sd, batches, dev, counts=blocked_counts,
                         patches=blocked_plain_patches())
        per = family_blocked_want(name, L, micro=cfg.train.accumulation_steps)
        check(k["launches"] == (sum(per[0].values()), sum(per[1].values()),
                                per[2]) and p["launches"] == (0, 0, 0),
              f"{label}first update launches: kernels {k['launches']}, "
              f"plain {p['launches']}")
        update_agrees(label, k, p, "plain versions")
        n_real = float(b0.node_mask.sum())
        rec = dict(launches=n, widths=widths,
                   ms=step_times(label, k, n_real), shape=(
                       b0.batch_size, b0.max_nodes, b0.max_edges))
        if name == "FastSchNet":
            # the kernels at these models' shapes (FastRF's widths are a
            # subset; the two runs' batches are the same)
            slot = slot_ids(b0.row, b0.edge_mask, b0.edge_block,
                            b0.edges_per_block)
            rec["rows"] = {(F, "f32"): blocked_case(
                "15b", slot, b0.max_nodes, F,
                torch.float32, gen, dev, timed=True)
                for F in (1, 3, HIDDEN)}
            del slot
        res["blocked"][name] = rec
        del batches, k, p
        torch.cuda.empty_cache()

    # (c) the scan
    for name in ("FastRF", "FastSchNet"):
        label = f"15c {name} cumsum: "
        ov = {**run_len, "model.model_name": name,
              "model.segment_impl": "cumsum"}
        cfg = load_config(path, {**ov, **EAGER})
        ds = datasets(cfg.data.batch_size)

        def read():
            return scan_counts() + (dict(CS.prefix_sum.launch_widths),)

        init_sd, _, (n, n_suffix, widths), micro, evals = drive_train(
            cfg, ds, dev, reset_scan_counts, read, label)
        want = family_scan_want(name, L, micro=micro, evals=evals)
        print(f"{label}prefix_scan launches={n} by width {widths}, suffix "
              f"{n_suffix} (expected {want}, suffix 0: {micro} micro-steps, "
              f"{evals} eval forwards)")
        check(widths == want and n == sum(want.values()) and n_suffix == 0,
              f"{label}scan launch count {n}/{n_suffix} {widths} != {want}")
        batches = loader_batches(cfg, ds, dev)
        b0 = batches[0]
        check(b0.edge_pair is not None and b0.edges_sorted,
              f"{label}the plain batch carries no pairing")
        k = first_update(cfg, init_sd, batches, dev, counts=scan_counts,
                         time_extra=FAM_TIMED)
        p = first_update(cfg, init_sd, batches, dev, counts=scan_counts,
                         patches=scan_plain_patches())
        cfg_s = load_config(path, {**ov, "model.segment_impl": "scatter"})
        sc = first_update(cfg_s, init_sd, batches, dev, counts=scan_counts,
                          time_extra=FAM_TIMED)
        per = sum(family_scan_want(
            name, L, micro=cfg.train.accumulation_steps).values())
        check(k["launches"] == (per, 0) and p["launches"] == (0, 0)
              and sc["launches"] == (0, 0),
              f"{label}first update launches: kernel {k['launches']}, plain "
              f"{p['launches']}, scatter {sc['launches']}")
        cumsum_update_agrees(label, k, p, sc, floor=FAM_GRAD_FLOOR)
        n_real = float(b0.node_mask.sum())
        B, E = b0.batch_size, b0.max_edges
        res["cumsum"][name] = dict(
            launches=n, widths=widths, ms=step_times(label, k, n_real),
            scatter_ms=step_times(f"{label}scatter ", sc, n_real),
            rows={key: scan_row(dev, gen, B, E, key[2], label=label)
                  for key in want})
        del batches, k, p, sc
        torch.cuda.empty_cache()

    # (d) serving
    g = scene(FAM_SERVE_N, 15)
    for name in FAM_SERVE:
        label = f"15d {name} serve: "
        cfg = load_config(os.path.join(root, "configs", "nbody_serve.yaml"),
                          {"model.model_name": name})
        _, eng = engine_with_params_from_config(cfg)
        out = eng.predict(g)
        check(out.shape == (FAM_SERVE_N, 3) and bool(np.isfinite(out).all()),
              f"{label}non-finite or misshapen prediction")
        check_equivariance(label, eng, g, out)
        res["serve"][name] = predict_times(label, eng, [g])[0]
        del eng
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"15 families: phase done in {res['seconds']:.1f} s")
    return res


def family_rows(fam, row):
    """Phase 15's rows of the ``kernels`` line: for the FastRF and
    FastSchNet paths, one row per launched (F, type) of each one-hot kernel
    and of the scan, and the plan's, each with its launches on the main
    path; ``row`` is main's row builder."""
    fb, fc = fam["blocked"], fam["cumsum"]
    frows = fb["FastSchNet"]["rows"]
    out = []
    for name in ("FastRF", "FastSchNet"):
        n, widths = fb[name]["launches"], fb[name]["widths"]
        for i, kname in enumerate(("blocked_seg_sum", "blocked_gather")):
            for key, cnt in sorted(widths[i].items()):
                r = frows[key][kname]
                out.append(row(kname, f"{name} blocked train {r['shape']}",
                               r, BLOCKED_TPU[kname], cnt,
                               source="blocked_onehot"))
        r = frows[min(frows)]["blocked_plan"]
        out.append(row("blocked_plan", f"{name} blocked train {r['shape']}",
                       r, BLOCKED_TPU["blocked_seg_sum"], n[2],
                       source="blocked_onehot"))
        for key, cnt in sorted(fc[name]["widths"].items()):
            r = fc[name]["rows"][key]
            out.append(row("prefix_scan", f"{name} cumsum train "
                           f"{r['shape']} f32", r,
                           "distegnn_tpu/ops/cumsum.py:38", cnt))
    return out


def family_summary(fam):
    """Phase 15's launches and times on one line."""
    fb, fc = fam["blocked"], fam["cumsum"]
    return (
        "families (phase 15): launches " + "; ".join(
            f"{name} blocked_seg_sum {fb[name]['launches'][0]}, "
            f"blocked_gather {fb[name]['launches'][1]}, blocked_plan "
            f"{fb[name]['launches'][2]}, prefix_scan "
            f"{sum(fc[name]['widths'].values())}" for name in fb)
        + "; micro-step ms (nodes/s): " + "; ".join(
            f"{name} B={r['B']} {r['ms']:.3f} "
            f"({r['nodes'] / r['ms'] * 1e3:.0f})"
            for name, r in fam["train"].items())
        + "; blocked: " + "; ".join(f"{name} {fb[name]['ms']:.3f}"
                                    for name in fb)
        + "; cumsum: " + "; ".join(
            f"{name} {fc[name]['ms']:.3f} (scatter "
            f"{fc[name]['scatter_ms']:.3f})" for name in fc)
        + f"; serve predict ms (n={FAM_SERVE_N}): " + "; ".join(
            f"{name} {ms:.3f}" for name, ms in fam["serve"].items())
        + f"; phase {fam['seconds']:.1f} s")


# ------------------------------------------------ phase 16: the data and tensor axes

# (b): the flagship split over 2 graph parts and 2 tensor ranks (4 ranks
# sharing the card); (c): Water-3D over 2 data shards x 2 graph parts
MESH_TP = (1, 2, 2)
MESH_DP = (2, 2, 1)
# the phi_x widths of the tensor axis at H = 64 held in (a): T = 2 and 4
MESH_HX = (32, 16)
FWD_TPU = "distegnn_tpu/ops/edge_pipeline.py:288"
BWD_TPU = "distegnn_tpu/ops/edge_pipeline.py:314"


def mesh_micro_step_collectives(L, remat, mmd, update, first=False,
                                tensor=False):
    """The collectives of one micro-step of the fused distributed train
    step under a (data, graph, tensor) mesh, by kind: (all-reduces,
    all-gathers), derived from the code. The graph axis's, the loss's, the
    consistency pair, the gradient and the stop agreement are
    :func:`micro_step_collectives`'s (the data axis changes their groups,
    not their number). The tensor axis adds, per layer
    (models/fast_egnn.py ``_fused_edges``, models/common.py ``MLP``): in
    every forward, rerun by remat's recompute, two all-gathers of the
    hoisted products (``tp_gather``) and two sums (``tp_reduce``: phi_x's
    trans_sum, phi_h's output); in the backward, the cotangent sums of the
    ``tp_copy`` inputs (11 a layer: the node features, the two gathered
    products, the kernel's four and the remote tail's four replicated
    weights; + x, but not layer 0's, the input positions; + phi_h's input,
    but not the last layer's, whose h is unused) and the all-gathers of the
    sliced weights' cotangents (``tp_slice``: w1's two column blocks, the
    kernel's and the tail's w3, b3, w4; + phi_h's first Dense, kernel and
    bias, and ``tp_slice_rows``, its second, but not the last layer's)."""
    red = micro_step_collectives(L, remat, mmd, update, first)
    gat = {}
    if tensor:
        fw = 2 if remat else 1
        red.update(tp_reduce=2 * L * fw, tp_copy_bwd=11 * L + 2 * (L - 1))
        gat = {"tp_gather": 2 * L * fw, "tp_slice_bwd": 8 * L + 2 * (L - 1),
               "tp_slice_rows_bwd": L - 1}
    return red, gat


def mesh_kernel_case(label, arrs, N, E, active, x, w, H, hx, dev, gen):
    """Phase 16 (a) at one shape and phi_x width ``hx``: the forward (bf16
    on the tensor cores, f32 on the f32 kernel) and the backward (bf16
    tensor cores, f32 FMA) with w3 [H, hx], b3 / w4 [hx] (a tensor rank's
    slice), each held against its plain version at phases 2 / 2b's bounds
    and timed (eagerly, as CUDA-graph replays, the plain version, the
    bound). Returns {(kernel, dtype): row}."""
    import torch

    from distegnn_tpu_torch.ops import edge_pipeline as ep

    ws = ep.EdgeWeights(w.ws, w.b1, w.w2, w.b2, w.w3[:, :hx].contiguous(),
                        w.b3[:, :hx].contiguous(), w.w4[:, :hx].contiguous())
    hr0 = torch.randn((N, H), generator=gen, device=dev) * 0.5
    hc0 = torch.randn((N, H), generator=gen, device=dev) * 0.5
    g_trans = torch.randn((N, 3), generator=gen, device=dev)
    g_ef = torch.randn((N, H), generator=gen, device=dev)
    res = {}
    shape = f"N={N} E_slots={E} in_window={active} H={H} HX={hx}"
    with torch.no_grad():
        for dname in ("bf16", "f32"):
            dt = torch.float32 if dname == "f32" else torch.bfloat16
            hr, hc = hr0.to(dt).contiguous(), hc0.to(dt).contiguous()
            fargs = (x, hr, hc, *arrs, ws, BLOCK, dname)
            bargs = (x, hr, hc, *arrs, ws, g_trans, g_ef, BLOCK, dname)
            for name, kern, plain, args, flat, names, work in (
                    ("fused_edge_fwd", ep._fused_edge_layer_cuda,
                     ep.fused_edge_layer_ref, fargs, list, FWD_NAMES,
                     fwd_work),
                    ("fused_edge_bwd", ep._fused_edge_bwd_cuda,
                     ep.fused_edge_layer_bwd_ref, bargs, bwd_outputs,
                     BWD_NAMES, bwd_work)):
                wid = (ep.fused_edge_layer.launch_widths
                       if name == "fused_edge_fwd"
                       else ep.fused_edge_layer.bwd_launch_widths)
                before = (wid[(H, hx)], ep.fused_edge_layer.tc_launches,
                          ep.fused_edge_layer.f32_launches)
                out = flat(kern(*args))
                torch.cuda.synchronize()
                tc = name == "fused_edge_fwd" and dname == "bf16"
                f32 = name == "fused_edge_fwd" and dname == "f32"
                check((wid[(H, hx)], ep.fused_edge_layer.tc_launches,
                       ep.fused_edge_layer.f32_launches)
                      == (before[0] + 1, before[1] + tc, before[2] + f32),
                      f"{label} {name} {dname} HX={hx}: launch counts")
                err = compare(f"{label} {name} HX={hx}", dname, names, out,
                              flat(plain(*args)), verbose=False)
                del out
                ms = cuda_ms(lambda: kern(*args), reps=10)
                graph_ms = cuda_ms_batches(lambda: kern(*args), launches=20,
                                           batches=3)
                plain_ms = cuda_ms(lambda: plain(*args), reps=3, warm=1)
                nbytes, flops = work(N, E, active, H, hr.element_size(), hx)
                b_ms, b_by = bound(nbytes, flops, dname)
                kernel = ("fused_edge_fwd_tc" if tc else "fused_edge_fwd_f32"
                          if f32 else "fused_edge_bwd")
                res[(kernel, dname)] = dict(
                    ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, err=err,
                    bound_ms=b_ms, bound_by=b_by, shape=shape, hx=hx,
                    dtype=dname)
                print(f"{label} {kernel} {dname} HX={hx}: {ms:.4f} ms/launch "
                      f"eagerly, {graph_ms:.4f} as CUDA-graph replays, plain "
                      f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
                      f"{nbytes} B, {flops} flop), {b_ms / graph_ms:.4f} of "
                      f"bound (replays)")
    return res


def mesh_kernel_phase(dev, parts):
    """Phase 16 (a): both fused edge kernels at phi_x widths HX = 32 and 16
    (H = 64), at phase 2's shape and at each (label, part graph) of
    ``parts``. Returns the rows by (shape label, kernel, dtype, HX)."""
    import torch

    from distegnn_tpu_torch.ops import edge_pipeline as ep
    from distegnn_tpu_torch.ops.graph import _round_up, pad_graphs

    H = HIDDEN
    gen = torch.Generator(device=dev).manual_seed(16)
    s = 0.3 / math.sqrt(H)
    w = ep.EdgeWeights(*[torch.randn(shape, generator=gen, device=dev) * s
                         for shape in ((3, H), (1, H), (H, H), (1, H),
                                       (H, H), (1, H), (1, H))])
    rows = {}
    for label, g in (("(a) phase-2 shape", scene(KERNEL_N, seed=11)),
                     *parts):
        # at least the window's 3 blocks, as the loader pads
        n = max(_round_up(g["loc"].shape[0], BLOCK), 3 * BLOCK)
        batch = pad_graphs([g], edge_block=BLOCK, split_remote=True,
                           max_nodes=n).to(dev)
        arrs, N, E, active = kernel_inputs(batch)
        x = batch.loc[0].contiguous()
        for hx in MESH_HX:
            for key, r in mesh_kernel_case(label, arrs, N, E, active, x, w,
                                           H, hx, dev, gen).items():
                rows[(label,) + key + (hx,)] = r
    return rows


def write_mesh_shards(cfg, cloud, out_dir, ws, n_train):
    """(b)'s shards: ``cloud`` split once by the config's split mode into
    ``ws`` parts, written as the train split (``n_train`` copies: one
    update's micro-steps) and as the valid and test splits (one copy
    each), in data/distribute.py's shard format. Returns (split paths, the
    split's ms)."""
    import pickle

    from distegnn_tpu_torch.data.partition import split_graph

    d = cfg.data
    t0 = time.perf_counter()
    parts = split_graph(cloud, ws, d.split_mode, d.inner_radius,
                        outer_radius=d.outer_radius, seed=cfg.seed)
    split_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir)
    paths = []
    for split, n in (("train", n_train), ("valid", 1), ("test", 1)):
        paths.append([os.path.join(out_dir, f"fluid_{split}_{p}-{ws}.pkl")
                      for p in range(ws)])
        for p, path in enumerate(paths[-1]):
            with open(path, "wb") as f:
                pickle.dump([parts[p]] * n, f,
                            protocol=pickle.HIGHEST_PROTOCOL)
    return paths, split_ms


def mesh_check_rank(rank, shape, cfgs, paths, out_dir, dev):
    """A rank of phase 16's checks, run by :class:`MeshProbe` in the timed
    run's world after its last micro-step. (b), ``shape`` (1, 2, 2): the
    first update with MMD off of the tensor-parallel model and of the
    model without the tensor axis (each tensor coordinate's graph group is
    a 2-rank run at T = 1), its fused launches by phi_x width. (c),
    ``shape`` (2, 2, 1): the rank's batches at data index d, the graph
    group's batches of the D = 1 draw at batch 2B, and the first update
    (MMD off) with the data axis and, per data coordinate, at D = 1 and
    batch 2B. Writes ``check<rank>.pt``."""
    import itertools

    import torch

    from distegnn_tpu_torch.models.registry import get_model
    from distegnn_tpu_torch.ops import edge_pipeline as ep
    from distegnn_tpu_torch.parallel.launch import rank_loaders
    from distegnn_tpu_torch.parallel.mesh import (DATA_AXIS, GRAPH_AXIS,
                                                  TENSOR_AXIS, mesh_coords)

    d, g, _ = mesh_coords(rank, shape)
    out = {}
    t0 = time.perf_counter()

    def batches_of(cfg, **kw):
        loader = rank_loaders(cfg, paths, g, dev, **kw)[0]
        loader.set_epoch(1)
        return list(itertools.islice(loader, cfg.train.accumulation_steps))

    H = cfgs["tp"].model.hidden_nf if "tp" in cfgs else 0
    hx = H // shape[2]

    def widths():
        # fused launches (forward, backward) at phi_x width HX, then at H
        fw = ep.fused_edge_layer.launch_widths
        bw = ep.fused_edge_layer.bwd_launch_widths
        return fw[(H, hx)], bw[(H, hx)], fw[(H, H)], bw[(H, H)]

    def cpu(u):
        u["grad"] = {n: t.cpu() for n, t in u["grad"].items()}
        return u

    if shape[2] > 1:
        cfg = cfgs["tp"]
        init = get_model(cfg.model, generator=torch.Generator()
                         .manual_seed(int(cfg.seed))).state_dict()
        b = batches_of(cfg)
        out["tp"] = cpu(first_update(cfg, init, b, dev, counts=widths,
                                     axis_name=GRAPH_AXIS, rank=g,
                                     tensor_axis=TENSOR_AXIS))
        out["t1"] = cpu(first_update(cfg, init, b, dev, counts=widths,
                                     axis_name=GRAPH_AXIS, rank=g))
    else:
        cfg, cfg1 = cfgs["dp"], cfgs["dp1"]
        init = get_model(cfg.model, generator=torch.Generator()
                         .manual_seed(int(cfg.seed))).state_dict()
        b = batches_of(cfg, data_parallel=shape[0], data_index=d)
        b1 = batches_of(cfg1)
        B = cfg.data.batch_size
        same = all(
            torch.equal(getattr(x, f), getattr(y, f)[d * B:(d + 1) * B])
            for x, y in zip(b, b1) for f in vars(x)
            if isinstance(getattr(x, f), torch.Tensor))
        out["rows"] = (same, len(b), len(b1), b[0].batch_size,
                       b1[0].batch_size)
        out["dp"] = cpu(first_update(cfg, init, b, dev, time_extra=3,
                                     axis_name=GRAPH_AXIS, rank=rank,
                                     data_axis_name=DATA_AXIS))
        out["d1"] = cpu(first_update(cfg1, init, b1, dev,
                                     axis_name=GRAPH_AXIS, rank=g))
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(out_dir, f"check{rank}.pt"))


class MeshProbe(StepProbe):
    """Phase 16's ``on_step``: :class:`StepProbe`'s rows, and after the
    run's micro-step ``after`` (its last) :func:`mesh_check_rank` in the
    same world (the rows are written before it, so it moves no count or
    time the phase reads from them)."""

    def __init__(self, out_dir, after, shape, cfgs, paths):
        super().__init__(out_dir)
        self.after, self.shape, self.cfgs, self.paths = (after, shape, cfgs,
                                                         paths)

    def __call__(self, epoch, step, metrics):
        import torch
        import torch.distributed as dist

        super().__call__(epoch, step, metrics)
        if len(self.rows) == self.after:
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if torch.cuda.is_available() else torch.device("cpu"))
            mesh_check_rank(dist.get_rank(), self.shape, self.cfgs,
                            self.paths, self.out_dir, dev)


def read_mesh_checks(label, out_dir, world):
    import torch

    res = [torch.load(os.path.join(out_dir, f"check{r}.pt"),
                      weights_only=False) for r in range(world)]
    print(f"({label}) checks in the run's world after its last micro-step: "
          f"{max(r['seconds'] for r in res):.1f} s")
    return res


def report_mesh_run(label, cfg, rows, n_real, startup, gstartup,
                    tensor=False):
    """Per rank: exact all-reduces and all-gathers of every micro-step by
    kind (:func:`mesh_micro_step_collectives`; the first also carries the
    start-up's), batch_consistency 0, micro-step ms, the collectives' host
    ms; the global nodes/s. Returns the medians."""
    L, k = cfg.model.n_layers, cfg.train.accumulation_steps
    mmd = bool(cfg.train.mmd.weight)
    meds = []
    for r, rr in enumerate(rows):
        prev, prevg, prev_s = {}, {}, 0.0
        for j, row in enumerate(rr):
            want, wantg = mesh_micro_step_collectives(
                L, cfg.model.remat, mmd, (j + 1) % k == 0, first=(j == 0),
                tensor=tensor)
            if j == 0:
                for kind, n in startup.items():
                    want[kind] = want.get(kind, 0) + n
                for kind, n in gstartup.items():
                    wantg[kind] = wantg.get(kind, 0) + n
            for got_all, before, expect, what in (
                    (row["counts"], prev, want, "all-reduces"),
                    (row["gathers"], prevg, wantg, "all-gathers")):
                got = {kind: n - before.get(kind, 0)
                       for kind, n in got_all.items()
                       if n - before.get(kind, 0)}
                check(got == {kind: n for kind, n in expect.items() if n},
                      f"{label}rank {r} micro-step {j}: {what} {got}, "
                      f"expected {expect}")
            secs = row["seconds"] + row["gather_seconds"]
            row["coll_ms"] = (secs - prev_s) * 1e3
            prev, prevg, prev_s = row["counts"], row["gathers"], secs
            check(row["consistency"] == 0.0,
                  f"{label}rank {r}: batch_consistency {row['consistency']}")
            check(math.isfinite(row["loss"]), f"{label}non-finite loss")
        steps = [(b["t"] - a["t"]) * 1e3 for a, b in zip(rr, rr[1:])
                 if a["epoch"] == b["epoch"]]
        med = sorted(steps)[len(steps) // 2] if steps else None
        meds.append(med)
        coll = [row["coll_ms"] for row in rr[1:]] or [rr[0]["coll_ms"]]
        per, perg = mesh_micro_step_collectives(L, cfg.model.remat, mmd,
                                                False, tensor=tensor)
        print(f"{label}rank {r}: micro-step ms (host clock, loader "
              f"included) " + (" ".join(f"{v:.1f}" for v in steps)
                               + f", median {med:.1f}" if steps else
                               "n/a (one micro-step)")
              + "; a micro-step's all-reduces "
              f"{sum(per.values())} {json.dumps(per)} (+1 gradient at each "
              f"update) and all-gathers {sum(perg.values())} "
              f"{json.dumps(perg)}, their host ms a micro-step "
              + " ".join(f"{v:.1f}" for v in coll)
              + f"; all-reduce host s {rr[-1]['seconds']:.3f}, all-gather "
              f"host s {rr[-1]['gather_seconds']:.3f}; peak device memory "
              f"{rr[-1]['peak'] / 2**30:.3f} GiB; batch_consistency 0 in "
              f"all {len(rr)} micro-steps")
    if all(v is not None for v in meds):
        slow = max(meds)
        print(f"{label}global: {n_real} real nodes / the slowest rank's "
              f"median {slow:.1f} ms = {n_real / (slow / 1e3):.0f} nodes/s "
              "(ranks sharing one card: the collectives' and the host's "
              "overhead, not scaling)")
    return meds


def mesh_phase(root, dev, cloud, part4):
    """Phase 16: the data and tensor axes of the mesh (see the module
    docstring). ``cloud`` is phase 9's first cloud and ``part4`` phase 9's
    rank 0's part of it. Shards, logs and data go to a temporary directory
    that is removed afterwards."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with phase_tmp("chip_smoke_mesh_") as tmp:
        out = _mesh_phase(root, dev, cloud, part4, tmp)
    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return out


def _mesh_phase(root, dev, cloud, part4, tmp):
    import copy
    import pickle

    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.data.loader import GraphDataset
    from distegnn_tpu_torch.parallel.launch import (_dispatch_preprocess,
                                                    run_distributed)

    flagship = os.path.join(root, "configs", "largefluid_distegnn.yaml")
    mesh_over = {"parallel.mesh.data": MESH_TP[0],
                 "parallel.mesh.graph": MESH_TP[1],
                 "parallel.mesh.tensor": MESH_TP[2]}
    over = dict(mesh_over, **{"model.edge_impl": "fused",
                              "data.edge_block": BLOCK, "train.epochs": 1,
                              "log.log_dir": os.path.join(tmp, "logs")})
    cfg = load_config(flagship, {**over, **EAGER})
    m, t = cfg.model, cfg.train
    micro = t.accumulation_steps
    paths, split_ms = write_mesh_shards(cfg, cloud, os.path.join(tmp, "ws2"),
                                        MESH_TP[1], micro)
    print(f"(b) partitioned phase 9's first cloud into {MESH_TP[1]} parts in "
          f"{split_ms:.0f} ms; its parts make the {micro} train batches (one "
          "update) and the valid and test batches")
    # (a) the kernels: phase 9's rank shape (a part of 4) and (b)'s (the
    # part of 2 that rank g = 0 trains on)
    with open(paths[0][0], "rb") as f:
        part2 = pickle.load(f)[0]
    krows = mesh_kernel_phase(dev, (("(a) phase-9 rank shape", part4),
                                    ("(a) (b)'s rank shape", part2)))

    # (b) the tensor axis at full width
    print(f"(b) config: configs/largefluid_distegnn.yaml as published + "
          f"{json.dumps(over)}: H={m.hidden_nf} L={m.n_layers} "
          f"C={m.virtual_channels} {m.compute_dtype} remat={m.remat} mmd "
          f"{t.mmd.weight} accumulation {t.accumulation_steps}; cut: "
          f"train.epochs 1 (the published 2500), one cloud's parts for "
          f"every batch")
    n_real = cloud["loc"].shape[0]
    L = m.n_layers
    per, perg = mesh_micro_step_collectives(L, m.remat, bool(t.mmd.weight),
                                            False, tensor=True)
    print(f"(b) collectives a micro-step, derived: all-reduces "
          f"{sum(per.values())} {json.dumps(per)} (+1 gradient at each "
          f"update), all-gathers {sum(perg.values())} {json.dumps(perg)}")
    probe_dir = os.path.join(tmp, "probe_b")
    os.makedirs(probe_dir)
    ucfg = load_config(flagship, dict(over, **{"train.mmd.weight": 0.0}))
    t0 = time.perf_counter()
    print_mode("phase 16 (a) ", cfg)
    run_distributed(copy.deepcopy(cfg), split_paths=paths, device=dev,
                    on_step=MeshProbe(probe_dir, micro, MESH_TP,
                                      {"tp": ucfg}, paths))
    world = MESH_TP[0] * MESH_TP[1] * MESH_TP[2]
    print(f"(b) run_distributed, mesh data x graph x tensor = "
          f"{' x '.join(map(str, MESH_TP))}: {world} ranks sharing the card "
          f"over gloo, 1 epoch in {time.perf_counter() - t0:.1f} s (spawn, "
          f"loading and the checks included); parameters bitwise equal "
          f"across the {world} ranks at the start and the end "
          f"(run_distributed's broadcast and compare over the whole mesh)")
    rows = read_probe(probe_dir, world)
    want_fwd, want_bwd = 2 * L * micro, L * micro
    hx = f"{m.hidden_nf}x{m.hidden_nf // MESH_TP[2]}"
    for r, rr in enumerate(rows):
        last = rr[-1]
        print(f"(b) rank {r}: fused_edge_fwd {last['fwd']} (expected {L} "
              f"layers x {micro} micro-steps x 2 (remat) = {want_fwd}; "
              f"{last['tc']} on the tensor cores; by H x HX "
              f"{last['widths']}), fused_edge_bwd {last['bwd']} (expected "
              f"{want_bwd}; {last['bwd_widths']}), fused_stack_fwd "
              f"{last['stack']}")
        check(len(rr) == micro and last["fwd"] == want_fwd
              and last["tc"] == want_fwd and last["bwd"] == want_bwd
              and last["widths"] == {hx: want_fwd}
              and last["bwd_widths"] == {hx: want_bwd}
              and last["stack"] == 0, f"(b) rank {r}: launch counts")
    meds_b = report_mesh_run("(b) ", cfg, rows, n_real * MESH_TP[0],
                             {"layout": 6, "replicated": 1},
                             {"consensus": 1}, tensor=True)
    launches = (sum(r[-1]["fwd"] for r in rows),
                sum(r[-1]["bwd"] for r in rows))

    res = read_mesh_checks("b", probe_dir, world)
    for r, rr in enumerate(res):
        tp, t1 = rr["tp"], rr["t1"]
        # one update: accumulation_steps micro-steps of 2L forward (remat)
        # and L backward launches, at HX = H / 2, then at HX = H
        k = ucfg.train.accumulation_steps
        check(tp["launches"] == (2 * L * k, L * k, 0, 0)
              and t1["launches"] == (0, 0, 2 * L * k, L * k),
              f"(b) rank {r}: first update launches (HX = H/2 fwd, bwd, "
              f"HX = H fwd, bwd) {tp['launches']} / {t1['launches']}")
        errs, per_t = update_distance(
            dict(tp, loss_with_mmd=tp["loss"]),
            dict(t1, loss_with_mmd=t1["loss"]))
        worst = sorted(per_t.items(), key=lambda kv: -kv[1])
        print(f"(b) rank {r} first update (MMD off), tensor 2 vs tensor 1 "
              f"(2 ranks): losses max rel err {errs['loss']:.3e}, gradient "
              f"norm {errs['grad norm']:.3e}, max {errs['grad']:.3e}, l2 "
              f"{errs['grad l2']:.3e} (tol {TOL_TRAIN:.0e} each); worst "
              f"tensor {worst[0][0]} {worst[0][1]:.3e}")
        check(all(errs[key] <= TOL_TRAIN for key in ("loss", "grad norm",
                                                     "grad", "grad l2")),
              f"(b) rank {r}: the tensor-parallel update disagrees with "
              "tensor 1's")

    # (c) the data axis on Water-3D
    data_dir = write_water3d(os.path.join(tmp, "simulate"), 16)
    path = os.path.join(root, "configs", "simulation_distegnn.yaml")
    cover = {"data.data_dir": data_dir, "parallel.mesh.data": MESH_DP[0],
             "parallel.mesh.graph": MESH_DP[1],
             "data.max_samples": W3D_DIST_SAMPLES, "train.epochs": 1,
             "log.log_dir": os.path.join(tmp, "logs_c")}
    dcfg = load_config(path, {**cover, **EAGER})
    print_cuts("(c) ", dcfg, cover)
    dpaths, _ = timed_preprocess(
        "(c) ", lambda: _dispatch_preprocess(dcfg, MESH_DP[1]),
        3 * W3D_DIST_SAMPLES)
    parts = [GraphDataset(p) for p in dpaths[0]]
    B = dcfg.data.batch_size
    n_real_c = sum(q[i]["loc"].shape[0] for q in parts
                   for i in range(MESH_DP[0] * B))
    micro_c = len(parts[0]) // (MESH_DP[0] * B)
    c_over = dict(cover, **{"train.mmd.weight": 0.0})
    ccfg = load_config(path, c_over)
    c1 = load_config(path, dict(c_over, **{
        "parallel.mesh.data": 1, "data.batch_size": MESH_DP[0] * B}))
    probe_dir = os.path.join(tmp, "probe_c")
    os.makedirs(probe_dir)
    t0 = time.perf_counter()
    print_mode("phase 16 (c) ", dcfg)
    run_distributed(copy.deepcopy(dcfg), split_paths=dpaths, device=dev,
                    on_step=MeshProbe(probe_dir, micro_c, MESH_DP,
                                      {"dp": ccfg, "dp1": c1}, dpaths))
    world = MESH_DP[0] * MESH_DP[1] * MESH_DP[2]
    print(f"(c) run_distributed, mesh data x graph x tensor = "
          f"{' x '.join(map(str, MESH_DP))}: {world} ranks, 1 epoch in "
          f"{time.perf_counter() - t0:.1f} s (the checks included); "
          f"parameters bitwise equal across the ranks at the start and the "
          f"end")
    rows_c = read_probe(probe_dir, world)
    check(all(len(r) == micro_c and r[-1]["fwd"] == 0 for r in rows_c),
          "(c) missing micro-steps or a fused launch")
    meds_c = report_mesh_run("(c) ", dcfg, rows_c, n_real_c,
                             {"layout": 3, "replicated": 1},
                             {"consensus": 1})
    res = read_mesh_checks("c", probe_dir, world)
    for r, rr in enumerate(res):
        same, nb, nb1, bs, bs1 = rr["rows"]
        print(f"(c) rank {r}: {nb} batch(es) of {bs} graphs, bitwise rows "
              f"[d B, (d + 1) B) of the data-1 draw of {bs1}: {same}")
        check(same and nb == nb1 and bs == B and bs1 == MESH_DP[0] * B,
              f"(c) rank {r}: the data shard's batches are not the D = 1 "
              "draw's rows")
        errs, _ = update_distance(dict(rr["dp"], loss_with_mmd=rr["dp"]["loss"]),
                                  dict(rr["d1"], loss_with_mmd=rr["d1"]["loss"]))
        ms = sorted(rr["dp"]["ms"])
        meds_c[r] = ms[len(ms) // 2]
        print(f"(c) rank {r}: micro-step ms (synchronised, step only, after "
              f"the first update) " + " ".join(f"{v:.1f}" for v in ms)
              + f", median {meds_c[r]:.1f}; global {n_real_c} real nodes / "
              f"{meds_c[r]:.1f} ms = {n_real_c / (meds_c[r] / 1e3):.0f} "
              "nodes/s")
        print(f"(c) rank {r} first update (MMD off), data 2 x batch {B} vs "
              f"data 1 x batch {MESH_DP[0] * B}: losses max rel err "
              f"{errs['loss']:.3e}, gradient norm {errs['grad norm']:.3e}, "
              f"max {errs['grad']:.3e}, l2 {errs['grad l2']:.3e} (tol "
              f"{TOL_TRAIN:.0e} each)")
        check(all(errs[key] <= TOL_TRAIN for key in ("loss", "grad norm",
                                                     "grad", "grad l2")),
              f"(c) rank {r}: the data-parallel update disagrees with "
              "data 1's")
    return {"kernels": krows, "launches": launches, "tp_ms": meds_b,
            "dp_ms": meds_c}


def mesh_rows(mesh, row):
    """The kernels line's rows of phase 16 (a): each kernel at each phi_x
    width and shape; the launches of (b)'s run on the row of its width and
    kernels (HX = 32, bf16 on the tensor cores) at its own rank shape, 0
    on the others."""
    out = []
    fwd, bwd = mesh["launches"]
    for (label, kernel, dname, hx), r in sorted(mesh["kernels"].items()):
        n = 0
        if (dname == "bf16" and hx == HIDDEN // MESH_TP[2]
                and label.startswith("(a) (b)'s")):
            n = fwd if kernel == "fused_edge_fwd_tc" else bwd
        out.append(row(kernel, f"tensor axis {dname} HX={hx} "
                       f"{label[4:]} {r['shape']}", r,
                       FWD_TPU if "fwd" in kernel else BWD_TPU, n,
                       source="fused_edge_bwd" if kernel == "fused_edge_bwd"
                       else "fused_edge_fwd"))
    return out


# ------------------------------------------------ phase 17: the scanned epoch
SCAN_EPOCHS = 2
SCAN_FLOOR = 1e-6       # of the parameters' (or the loss's) scale
SCAN_NBODY = (500, 250, 250)   # phase 15's trajectories: 2 micro-steps


def reset_all_counts():
    """Every kernel's launch counters to 0."""
    from distegnn_tpu_torch.ops import layer_pipeline as lp

    reset_fused_counts()
    reset_scan_counts()
    reset_blocked_counts()
    lp.fused_egnn_stack.launches = 0


def scan_runs(cfg, ds, dev, modes, label, keep=False):
    """``main.run`` of ``cfg`` once per ``train.scan_epochs`` value in
    ``modes``, every count set to 0 just before each and read just after.
    Returns one dict a run: the parameters (CPU) at the start and the end,
    the log, the counts, the replayed launches and, with ``keep``, the
    trainer's state and the runner main built (None: eager); else both
    go, with the runner's graph pool, before the next run."""
    import gc

    import torch

    from distegnn_tpu_torch import main as pmain
    from distegnn_tpu_torch.train.scan_epoch import _launch_counts

    real, real_train = pmain.make_scan_runner, pmain.train_model
    out = []
    for mode in modes:
        built, init = [], []

        def grab(*a, **kw):
            r, loaders = real(*a, **kw)
            built.append(r)
            return r, loaders

        def grab_init(config, model, *a, **kw):
            init.append(cpu_params(model))
            return real_train(config, model, *a, **kw)

        c = copy.deepcopy(cfg)
        c.train.scan_epochs = mode
        reset_all_counts()
        t0 = time.perf_counter()
        with mock.patch.object(pmain, "make_scan_runner", grab), \
                mock.patch.object(pmain, "train_model", grab_init):
            state, _, log = pmain.run(c, *ds, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in _launch_counts().items() if v}
        runner = built[0] if built else None
        params = cpu_params(state.model)
        check(all(math.isfinite(v) for v in log["loss_train"] + log["loss"]),
              f"{label}scan_epochs={mode}: non-finite epoch loss")
        replayed = runner.launches() if runner is not None else {}
        print(f"{label}scan_epochs={mode}: runner "
              f"{type(runner).__name__ if runner else None}, {wall:.1f} s; "
              f"loss_train {log['loss_train']} test {log['loss']}; counts "
              f"{counts}; replayed {replayed}")
        out.append(dict(params=params, init=init[0], log=log, counts=counts,
                        replayed=replayed, mode=mode,
                        captured=getattr(runner, "captured", None),
                        state=state if keep else None,
                        runner=runner if keep else None,
                        runner_kind=type(runner).__name__ if runner else None))
        del state, runner, built
        gc.collect()
        torch.cuda.empty_cache()
    return out


def cpu_params(model):
    """A CPU copy of ``model``'s state_dict."""
    return {k: v.detach().cpu().clone()
            for k, v in model.state_dict().items()}


def param_distance(a, b):
    """max |a - b| over two state_dicts' tensors."""
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def scan_distance(a, b):
    """(max |parameter difference|, max over the epoch losses of the
    absolute difference) between two scan_runs results."""
    dp = param_distance(a["params"], b["params"])
    la = a["log"]["loss_train"] + a["log"]["loss"]
    lb = b["log"]["loss_train"] + b["log"]["loss"]
    return dp, max(abs(x - y) for x, y in zip(la, lb))


def scan_agrees(label, scanned, eager, eager2):
    """The scanned run against the eager one within 2x the two eager
    runs' own distance (floor SCAN_FLOOR of the scale), the parameter
    bound below what the eager run moved the parameters (so a run whose
    updates never landed cannot pass). Returns the (parameter, loss)
    bounds."""
    scale = max(float(v.abs().max()) for v in eager["params"].values())
    lscale = max(abs(v) for v in eager["log"]["loss_train"]
                 + eager["log"]["loss"])
    dp, dl = scan_distance(scanned, eager)
    ep, el = scan_distance(eager, eager2)
    bp, bl = max(2 * ep, SCAN_FLOOR * scale), max(2 * el,
                                                  SCAN_FLOOR * lscale)
    moved = param_distance(eager["params"], eager["init"])
    print(f"{label}scanned vs eager: parameters max abs diff {dp:.3e}, "
          f"losses {dl:.3e}; eager vs eager {ep:.3e} / {el:.3e}, bounds 2x "
          f"(floor {SCAN_FLOOR:.0e} of scale {scale:.3e} / {lscale:.3e}) = "
          f"{bp:.3e} / {bl:.3e}; the eager run moved the parameters "
          f"{moved:.3e}")
    check(dp <= bp and dl <= bl,
          f"{label}the scanned run disagrees with the eager loop")
    check(bp < moved, f"{label}the parameter bound {bp:.3e} is not below "
          f"the run's move {moved:.3e}")
    return bp, bl


def replay_agrees(label, scanned, eager):
    """The replayed launches equal the eager run's counted ones (per
    kernel counter, eval forwards included)."""
    want = eager["counts"]
    got = scanned["replayed"]
    print(f"{label}launches replayed {got} vs eager {want}")
    check(got == want, f"{label}replayed launches {got} != eager {want}")


def scan_times(label, runner, state, epoch):
    """The micro-step ms eagerly (the runner's own train step on a staged
    batch) and replayed (one scanned epoch over its steps), both
    synchronised, on the runner's state; the capture ms and the pool's
    bytes; the device's busy / idle share of one more scanned epoch under
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from distegnn_tpu_torch.train.scan_epoch import pick
    from distegnn_tpu_torch.train.step import step_generator

    sp = runner.train
    S = runner.num_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.train_epoch(state, epoch)
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3 / S
    batch = pick(sp.data, sp.perm[0])
    ms = []
    for i in range(S):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.train_step(state, batch, step_generator(
            runner.seed, epoch, i, runner.device))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    eager_ms = sorted(ms)[len(ms) // 2]
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.train_epoch(state, epoch + 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    out = dict(eager_ms=eager_ms, replay_ms=replay_ms,
               capture_ms=runner.capture_ms, pool_bytes=runner.pool_bytes,
               idle=1 - busy / wall if busy > 0 else None, busy_ms=busy,
               wall_ms=wall)
    idle = ("not measured (the profiler saw no device time in the "
            "replays)" if out["idle"] is None else
            f"{out['idle']:.4f} (device {busy:.3f} ms of {wall:.3f} ms)")
    print(f"{label}micro-step ms: eager {eager_ms:.3f} (median of {S}), "
          f"replayed {replay_ms:.3f} (one scanned epoch of {S}); capture "
          f"{runner.capture_ms:.1f} ms, graph pool {runner.pool_bytes} "
          f"bytes; device idle share of one scanned epoch {idle}")
    return out


def scan_epoch_phase(root, dev, clouds, stack_clouds):
    """Phase 17: the scanned epoch on the card (train/scan_epoch.py), each
    run against the eager loop from the same seed: (a) cell (d) twice
    eagerly and once scanned, within 2x the eager runs' distance, the
    replayed launches equal to the eager counts, micro-step ms both ways;
    (b) configs/nbody_fastegnn.yaml under 'auto' (scans), with
    segment_impl cumsum, and FastSchNet on the one-hot kernels (15 (p));
    (c) cell (g)'s stack training; (d) restore_state under a live runner,
    then a scanned epoch against an eager one from the same snapshot; (e)
    (u)'s config at {data 1, graph 2} over gloo, the eager loop on the
    staged loaders (no capture) against it on the loaders, parameters
    and best losses. Every scanned run's parameter bound sits below what
    the run moved the parameters. Files and logs in a temporary
    directory."""
    with phase_tmp("chip_smoke_scan_") as tmp:
        return _scan_epoch_phase(root, dev, clouds, stack_clouds, tmp)


def _scan_epoch_phase(root, dev, clouds, stack_clouds, tmp):
    import gc

    import torch

    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.data.loader import GraphDataset
    from distegnn_tpu_torch.data.nbody_sim import generate_nbody_files
    from distegnn_tpu_torch.main import (make_loaders,
                                         process_dataset_edge_cutoff)
    from distegnn_tpu_torch.parallel.launch import (_dispatch_preprocess,
                                                    run_distributed)
    from distegnn_tpu_torch.models.registry import get_model
    from distegnn_tpu_torch.parallel.mesh import GRAPH_AXIS
    from distegnn_tpu_torch.train.checkpoint import verify_checkpoint
    from distegnn_tpu_torch.train.trainer import (restore_state, run_dir,
                                                  run_epoch_train,
                                                  snapshot_state)

    t_phase = t_part = time.perf_counter()
    res, parts = {}, {}
    logs = os.path.join(tmp, "logs")
    run_len = {"train.epochs": SCAN_EPOCHS,
               "log.test_interval": SCAN_EPOCHS, "log.log_dir": logs}

    # (a) cell (d): the flagship + the fused kernels, full width
    cfg = load_config(os.path.join(root, "configs",
                                   "largefluid_distegnn.yaml"),
                      {"model.edge_impl": "fused", "data.edge_block": BLOCK,
                       "data.accelerate_mode": "cutoff_edges", **run_len})
    m = cfg.model
    print(f"17a cell (d): H={m.hidden_nf} L={m.n_layers} "
          f"C={m.virtual_channels} {m.compute_dtype} remat={m.remat} MMD "
          f"{cfg.train.mmd.weight} accumulation "
          f"{cfg.train.accumulation_steps}, {SCAN_EPOCHS} epochs on "
          f"{len(clouds)} clouds of {FLUID_N} nodes")
    ds = fluid_datasets(clouds, cfg.data.node_order)
    e1, e2, sc = scan_runs(cfg, ds, dev, (False, False, True), "17a ",
                           keep=True)
    runner = sc["runner"]
    check(type(runner).__name__ == "ScanEpochRunner"
          and runner.graphs is not None, "17a: no captured runner")
    L = m.n_layers
    per = {"fused_edge_fwd": 2 * L, "fused_edge_bwd": L,
           "fused_edge_fwd_tc": 2 * L}
    print(f"17a captured launches by graph: {runner.captured} (a micro-step "
          f"{per}); replays {dict(runner.replays)}")
    check(runner.captured["update"] == per
          and runner.captured["accumulate"] == per,
          f"17a: a captured micro-step holds {runner.captured}, not {per}")
    replay_agrees("17a ", sc, e1)
    bp, _ = scan_agrees("17a ", sc, e1, e2)
    res["a"] = dict(replayed=sc["replayed"], captured=runner.captured)
    res["a"].update(scan_times("17a ", runner, sc["state"], SCAN_EPOCHS + 1))

    parts["a"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (d) restore_state under the live runner: an eager epoch from a
    # snapshot, the snapshot restored, then a scanned epoch from it (a
    # capture still pointing at replaced tensors would train on others)
    state = sc["state"]
    snap = snapshot_state(state)
    state, _ = run_epoch_train(runner.train_step, state,
                               runner.loader, cfg.seed, SCAN_EPOCHS + 3, dev)
    eager = {k: v.detach().cpu().clone()
             for k, v in state.model.state_dict().items()}
    restore_state(state, snap)
    state, _ = runner.train_epoch(state, SCAN_EPOCHS + 3)
    scanned = {k: v.detach().cpu().clone()
               for k, v in state.model.state_dict().items()}
    moved = max(float((scanned[k] - snap["model"][k].cpu()).abs().max())
                for k in scanned)
    dd = max(float((scanned[k] - eager[k]).abs().max()) for k in scanned)
    print(f"17d restore_state under a live runner, then epoch "
          f"{SCAN_EPOCHS + 3}: scanned vs eager parameters max abs diff "
          f"{dd:.3e} (bound {bp:.3e}, 17a's); the epoch moved them "
          f"{moved:.3e}")
    check(dd <= bp and moved > bp,
          "17d: the scanned epoch after a restore disagrees with the eager "
          "one (a stale capture trains on the old values)")
    del e1, e2, sc, state, runner, snap
    gc.collect()
    torch.cuda.empty_cache()

    parts["d"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (b) n-body as published under 'auto'; cumsum; FastSchNet blocked
    path = os.path.join(root, "configs", "nbody_fastegnn.yaml")
    base = load_config(path)
    data_dir = os.path.join(tmp, "data")
    n_tr, n_va, n_te = SCAN_NBODY
    t0 = time.perf_counter()
    generate_nbody_files(os.path.join(data_dir, base.data.dataset_name),
                         n_isolated=100, num_train=n_tr, num_valid=n_va,
                         num_test=n_te, length=(base.data.frame_T + 1) * 100,
                         sample_freq=100, seed=43, device=dev)
    nb_len = {"data.data_dir": data_dir, "train.epochs": 1,
              "log.test_interval": 1, "log.log_dir": logs}
    files = process_dataset_edge_cutoff(load_config(path, nb_len).data,
                                        seed=base.seed)
    nds = [GraphDataset(f) for f in files]
    print(f"17b n-body: {n_tr}/{n_va}/{n_te} systems in "
          f"{time.perf_counter() - t0:.1f} s, batch {base.data.batch_size}")
    auto, ea, ea2 = scan_runs(load_config(path, nb_len), nds, dev,
                              ("auto", False, False), "17b as published ")
    check(auto["runner_kind"] == "ScanEpochRunner",
          "17b: 'auto' did not scan the published n-body config on the card")
    scan_agrees("17b as published ", auto, ea, ea2)
    del ea, ea2
    res["b"] = {}
    for key, ov in (("cumsum", {"model.segment_impl": "cumsum"}),
                    ("FastSchNet blocked", {
                        "model.model_name": "FastSchNet",
                        "data.edge_block": RB_BLOCK,
                        "model.blocked_impl": "pallas"})):
        label = f"17b {key} "
        sc, ea, ea2 = scan_runs(load_config(path, {**nb_len, **ov}), nds,
                                dev, (True, False, False), label)
        replay_agrees(label, sc, ea)
        scan_agrees(label, sc, ea, ea2)
        res["b"][key] = sc["replayed"]
        del sc, ea, ea2
    # the scan at the cumsum batch's widest width, [B, E, H + 4] f32
    ld = make_loaders(load_config(path, {**nb_len,
                                         "model.segment_impl": "cumsum"}),
                      *nds)[0]
    res["scan_row"] = scan_row(dev, torch.Generator(device=dev).manual_seed(
        17), ld.batch_size, ld.max_edges, HIDDEN + 4, label="17b ")
    del auto, nds, ld
    torch.cuda.empty_cache()

    parts["b"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (c) cell (g): the stack, its backward's per-layer kernels
    cfg = load_config(os.path.join(root, "configs", "fluid_fused_stack.yaml"),
                      run_len)
    sds = fluid_datasets(stack_clouds, cfg.data.node_order)
    sc, ea, ea2 = scan_runs(cfg, sds, dev, (True, False, False), "17c ",
                            keep=True)
    replay_agrees("17c ", sc, ea)
    scan_agrees("17c ", sc, ea, ea2)
    res["c"] = dict(replayed=sc["replayed"])
    res["c"].update(scan_times("17c ", sc["runner"], sc["state"],
                               SCAN_EPOCHS + 1))
    del sc, ea, ea2
    gc.collect()
    torch.cuda.empty_cache()

    parts["c"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (e) (u)'s config at {data 1, graph 2} over gloo: the eager loop on
    # the staged loaders (no capture) against it on the rank's loaders; 2
    # epochs of 2 micro-steps, so that accumulation 4 updates once
    data_dir = write_water3d(os.path.join(tmp, "simulate"), 17)
    wpath = os.path.join(root, "configs", "simulation_distegnn.yaml")
    over = {"data.data_dir": data_dir, "parallel.mesh.data": 1,
            "parallel.mesh.graph": 2, "data.max_samples": W3D_DIST_SAMPLES,
            "train.epochs": 2, "log.test_interval": 2}
    wcfg = load_config(wpath, over)
    paths = _dispatch_preprocess(wcfg, 2)
    best, params, res["e"] = {}, {}, {}
    for mode in (False, True):
        c = load_config(wpath, {**over, "train.scan_epochs": mode,
                                "log.log_dir": os.path.join(tmp, f"w{mode}")})
        t0 = time.perf_counter()
        best[mode] = run_distributed(c, split_paths=paths, device=dev)
        wall = time.perf_counter() - t0
        names, recs = run_events(c)
        start = [r for r in recs if r["name"] == "train/run_start"]
        check(start and start[0].get("scan_epochs") is mode,
              f"17e: scan_epochs={mode} did not reach the trainer")
        epoch_s = [r["dur_s"] for r in recs if r["name"] == "train/epoch"]
        params[mode] = verify_checkpoint(os.path.join(
            run_dir(c), "state_dict", "last_model.ckpt"))["model"]
        res["e"][mode] = dict(seconds=wall, epoch_s=epoch_s)
        print(f"17e {wpath.split(os.sep)[-1]} mesh data 1 graph 2, "
              f"scan_epochs={mode} ({'staged loaders' if mode else 'loaders'}"
              f"): {wall:.1f} s the run, epoch {epoch_s} s; best "
              f"{json.dumps(best[mode])}")
    # the ranks' initial parameters: the config's seed, as train_rank
    init = get_model(c.model, world_size=2,
                     dataset_name=c.data.dataset_name, axis_name=GRAPH_AXIS,
                     generator=torch.Generator().manual_seed(int(c.seed))
                     ).state_dict()
    scale = max(float(v.abs().max()) for v in params[False].values())
    dp = param_distance(params[True], params[False])
    moved = param_distance(params[False], init)
    dl = max(abs(best[True][k] - best[False][k]) / abs(best[False][k])
             for k in ("loss_train", "loss_valid", "loss_test"))
    print(f"17e staged vs loaders: parameters max abs diff {dp:.3e} (bound "
          f"{SCAN_FLOOR:.0e} of scale {scale:.3e} = {SCAN_FLOOR * scale:.3e}"
          f"; the run's update moved them {moved:.3e}), best losses max "
          f"rel diff {dl:.3e} (bound {SCAN_FLOOR:.0e})")
    check(dp <= SCAN_FLOOR * scale and dl <= SCAN_FLOOR
          and SCAN_FLOOR * scale < moved,
          "17e: the staged-loader run disagrees with the loaders' run")
    parts["e"] = time.perf_counter() - t_part
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 17 took {res['seconds']:.1f} s (by cell: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    return res


def scanned_epoch_rows(scan, flagship, stack, fam, row):
    """Phase 17's rows of the ``kernels`` line: each kernel replayed from
    the scanned epoch's CUDA graphs, its launches as captured x replays,
    with the numbers of the same kernel at the same shape measured by the
    phase that drives that cell eagerly (5, 7, 15)."""
    fwd_tpu = "distegnn_tpu/ops/edge_pipeline.py:288"
    bwd_tpu = "distegnn_tpu/ops/edge_pipeline.py:314"
    a, c = scan["a"]["replayed"], scan["c"]["replayed"]
    out = []
    for name, k, rep, tpu, src in (
            (flagship["fused_edge_fwd"]["kernel"], flagship["fused_edge_fwd"],
             a["fused_edge_fwd"], fwd_tpu, "fused_edge_fwd"),
            ("fused_edge_bwd", flagship["fused_edge_bwd"],
             a["fused_edge_bwd"], bwd_tpu, "fused_edge_bwd")):
        out.append(row(name, f"scanned epoch (graph replays) train "
                       f"{k['dtype']} {k['shape']}", k, tpu, rep,
                       source=src))
    ef, eb = stack["edge_rows"]["fused_edge_fwd"], \
        stack["edge_rows"]["fused_edge_bwd"]
    out += [row("fused_stack_fwd", f"scanned epoch (graph replays) stack "
                f"train {stack['row']['dtype']} {stack['row']['shape']}",
                stack["row"], STACK_TPU, c["fused_stack_fwd"]),
            row(ef["kernel"], f"scanned epoch (graph replays) stack train "
                f"backward {ef['dtype']} {ef['shape']}", ef, fwd_tpu,
                c["fused_edge_fwd"], source="fused_edge_fwd"),
            row("fused_edge_bwd", f"scanned epoch (graph replays) stack "
                f"train backward {eb['dtype']} {eb['shape']}", eb, bwd_tpu,
                c["fused_edge_bwd"])]
    r = scan["scan_row"]
    out.append(row("prefix_scan", f"scanned epoch (graph replays) n-body "
                   f"cumsum train {r['shape']} f32 (launches at every "
                   f"width)", r, "distegnn_tpu/ops/cumsum.py:38",
                   scan["b"]["cumsum"]["prefix_scan"]))
    frows = fam["blocked"]["FastSchNet"]["rows"]
    rep = scan["b"]["FastSchNet blocked"]
    for kname, key in (("blocked_seg_sum", "blocked_seg_sum"),
                       ("blocked_gather", "blocked_gather"),
                       ("blocked_plan", "blocked_plan")):
        r = frows[(HIDDEN, "f32")][kname]
        out.append(row(kname, f"scanned epoch (graph replays) FastSchNet "
                       f"blocked train {r['shape']} (launches at every "
                       f"width)", r,
                       BLOCKED_TPU.get(kname,
                                       BLOCKED_TPU["blocked_seg_sum"]),
                       rep[key], source="blocked_onehot"))
    return out


# ------------------------------------- phase 18: Fluid113K scenes, the fault kit

# (a) the first sim of each split (data/fluid113k.py SIM_SPLITS), each made
# by the port's command line at the flagship's node count
SCENE_SIMS = (1, 101, 121)
SCENE_PARTICLES = FLUID_N
SCENE_MIN_PARTICLES = 100_000    # the command line's default budget floor
SCENE_RADIUS = 0.025
# the fewest frames delta_t 20 allows (data/fluid113k.py: hi_f =
# min(FRAME_RANGE, T - delta_t - 1) > 0)
SCENE_FRAMES = 22
# The reader (a) takes, fixed: the H100 machine this script is run on has
# no zstandard (python3 -c "import msgpack, zstandard, scipy" fails there),
# without which the shards can be neither packed (pack_scene_records) nor
# read (read_sim). So (a) reads the stand-in's partio exports with the
# port's bgeo codec: the arrays pack stores and read_sim returns
# (scene_sim). The shard round trip is held on the CPU
# (tests/test_torch_fluid_scenes.py).
SCENE_READER = "bgeo exports (numpy_from_bgeo), no shards"
SCENE_TIMED = 4
# (b) tiny_run's final train loss: the resumed run's distance from a
# control within max(DRILL_FACTOR x the two controls' distance,
# DRILL_FLOOR x |loss|) (the plain scatter's atomics sum in no fixed order)
DRILL_FACTOR = 2.0
DRILL_FLOOR = 1e-6

# A stand-in for SPlisHSPlasH's DynamicBoundarySimulator, written into the
# phase's directory: run_simulator's argv in, SCENE_FRAMES partio frames per
# fluid out, the particles advanced along their start velocities at the
# scene's particleFPS, shuffled and carrying ids, as the simulator's
# exports arrive. It loads the port's bgeo codec by its path (no torch).
STANDIN_SIM = '''#!{python}
import importlib.util, json, os, sys, time
import numpy as np
t0 = time.perf_counter()
spec = importlib.util.spec_from_file_location("bgeo", {bgeo!r})
bgeo = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bgeo)
args = sys.argv[1:]
if args[:3] != ["--no-cache", "--no-gui", "--no-initial-pause"]:
    sys.exit("stand-in simulator: unexpected argv %r" % (args,))
out = args[args.index("--output-dir") + 1]
with open(args[-1]) as f:
    scene = json.load(f)
dt = 1.0 / scene["Configuration"]["particleFPS"]
partio = os.path.join(out, "partio")
os.makedirs(partio, exist_ok=True)
n = 0
for k, fm in enumerate(scene["FluidModels"]):
    pos0, vel0 = bgeo.numpy_from_bgeo(os.path.join(out, fm["particleFile"]))
    n += pos0.shape[0]
    for t in range({frames}):
        perm = np.random.default_rng([k, t]).permutation(pos0.shape[0])
        bgeo.write_bgeo(
            os.path.join(partio, "ParticleData_%s_%d.bgeo" % (fm["id"], t)),
            (pos0 + np.float32(t * dt) * vel0)[perm],
            dict(velocity=vel0[perm], id=perm.astype(np.int64)))
print("stand-in simulator: %d particles x %d frames in %.2f s"
      % (n, {frames}, time.perf_counter() - t0), flush=True)
'''


def write_standin(tmp, root):
    import stat

    path = os.path.join(tmp, "standin_simulator")
    with open(path, "w") as f:
        f.write(STANDIN_SIM.format(
            python=sys.executable, frames=SCENE_FRAMES,
            bgeo=os.path.join(root, "distegnn_tpu_torch", "data",
                              "bgeo.py")))
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)
    return path


def scene_sim(scene_dir, radius=SCENE_RADIUS):
    """``read_sim``'s (pos [T, N, 3], vel [T, N, 3], viscosity [N], mass
    [N]) of a scene directory's partio exports, read with the port's bgeo
    codec: per frame the arrays ``pack_scene_records`` stores (the fluids
    in ``list_partio_frames`` order, each sorted by id; per-particle mass
    density0 (2r)^3), float32."""
    import numpy as np

    from distegnn_tpu_torch.data.bgeo import (list_partio_frames,
                                              numpy_from_bgeo)

    with open(os.path.join(scene_dir, "scene.json")) as f:
        scene = json.load(f)
    frames = list_partio_frames(os.path.join(scene_dir, "partio"))
    counts = {len(v) for v in frames.values()}
    check(len(frames) > 0 and len(counts) == 1,
          f"{scene_dir}: no partio exports, or fluids with different frame "
          f"counts {counts}")
    pos, vel = [], []
    for t in range(counts.pop()):
        read = [numpy_from_bgeo(paths[t]) for paths in frames.values()]
        check(all(v is not None for _, v in read),
              f"{scene_dir}: frame {t} has no velocity attribute")
        pos.append(np.concatenate([p for p, _ in read]).astype(np.float32))
        vel.append(np.concatenate([v for _, v in read]).astype(np.float32))
    n = [p.shape[0] for p, _ in read]
    visc = np.concatenate([np.full(k, scene[f]["viscosity"], np.float32)
                           for f, k in zip(frames, n)])
    mass = (np.concatenate([np.full(k, scene[f]["density0"], np.float32)
                            for f, k in zip(frames, n)])
            * (2 * radius) ** 3).astype(np.float32)
    return (np.stack(pos).astype(np.float32),
            np.stack(vel).astype(np.float32), visc, mass)


class Background:
    """Commands started together (cwd the checkout, the port importable,
    at nice 10), each one's output into a file, left running while the
    script goes on; :meth:`results` waits for them. Whatever still runs
    when the script exits is killed (``_kill_background``)."""

    live = []

    def __init__(self, cmds, root, tmp, tag):
        env = dict(os.environ, PYTHONPATH=root)
        self.logs = [os.path.join(tmp, f"{tag}_{i}.log")
                     for i in range(len(cmds))]
        # below the build's priority: nvcc's critical path keeps its cores
        nice = shutil.which("nice")
        prefix = [nice, "-n", "10"] if nice else []
        self.t0 = time.perf_counter()
        self.procs = []
        for cmd, path in zip([prefix + c for c in cmds], self.logs):
            with open(path, "w") as log:
                self.procs.append(subprocess.Popen(
                    cmd, cwd=root, env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        self.ends = [None] * len(cmds)
        Background.live.append(self)
        # each command's exit time, seen while the script goes on
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        while any(e is None for e in self.ends):
            for i, p in enumerate(self.procs):
                if self.ends[i] is None and p.poll() is not None:
                    self.ends[i] = time.perf_counter() - self.t0
            time.sleep(0.05)

    def results(self, timeout=900):
        """Per command (exit code, output, wall seconds from the common
        start to its exit); raises TimeoutError past ``timeout`` s, with
        every command killed."""
        while any(e is None for e in self.ends):
            if time.perf_counter() - self.t0 > timeout:
                self.kill()
                raise TimeoutError(f"commands still running after "
                                   f"{timeout} s: {self.logs}")
            time.sleep(0.05)
        out = []
        for p, path, end in zip(self.procs, self.logs, self.ends):
            with open(path) as f:
                out.append((p.returncode, f.read(), end))
        return out

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _kill_background():
    for b in Background.live:
        b.kill()


class DrillRuns(threading.Thread):
    """Phase 18 (b)'s tiny_run subprocesses, run on a thread beside the
    script (they need no kernel): two controls, SIGKILL after step 6 with a
    cadence save every step, SIGTERM after step 2 and a NaN batch at step 5
    with 2 retries, started together; then the newest step checkpoint of
    the killed run truncated, and the two resumes together. The checks are
    :func:`drill_phase`'s, in the main thread."""

    def __init__(self, root, tmp):
        super().__init__(daemon=True)
        self.root, self.tmp = root, tmp
        self.dirs = {k: os.path.join(tmp, "drill", k)
                     for k in ("c1", "c2", "kill", "term", "poison")}
        self.first = self.second = self.steps = self.error = None
        self.seconds = None
        self.t0 = time.perf_counter()
        self.start()

    def run(self):
        import glob

        from distegnn_tpu_torch.testing.faults import corrupt_checkpoint

        try:
            d = self.dirs
            self.first = Background(
                [tiny_cmd(d["c1"]), tiny_cmd(d["c2"]),
                 tiny_cmd(d["kill"], "--interval-s", 0.001, "--kill-at-step",
                          6),
                 tiny_cmd(d["term"], "--sigterm-at-step", 2),
                 tiny_cmd(d["poison"], "--poison-at-step", 5, "--retries",
                          2)], self.root, self.tmp, "drill1").results(600)
            self.steps = sorted(glob.glob(os.path.join(
                d["kill"], "run", "state_dict", "step_*.ckpt")))
            if len(self.steps) >= 2:
                corrupt_checkpoint(self.steps[-1], mode="truncate")
            self.second = Background(
                [tiny_cmd(d["kill"], "--resume", "auto"),
                 tiny_cmd(d["term"], "--resume", "auto")],
                self.root, self.tmp, "drill2").results(600)
        except Exception as e:   # reported by drill_phase in the main thread
            self.error = e
        self.seconds = time.perf_counter() - self.t0


def start_scene_work(root):
    """Phase 18's host work, started beside the kernel build (nvcc keeps
    five cores busy; nothing is measured there): the three scenes'
    ``generate`` with the stand-in simulator, and the drills. Returns what
    :func:`scene_phase` joins."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_scenes_")
    # at exit (last registered, first run): the processes, then their files
    atexit.register(shutil.rmtree, tmp, True)
    atexit.register(_kill_background)
    standin = write_standin(tmp, root)
    scenes = os.path.join(tmp, "scenes")
    gen = Background(
        [[sys.executable, "-m", "distegnn_tpu_torch.data.fluid_scenes",
          "generate", "--output", scenes, "--seed", str(s), "--num-objects",
          "2", "--const-fluid-particles", str(SCENE_PARTICLES),
          "--min-fluid-particles", str(SCENE_MIN_PARTICLES), "--radius",
          str(SCENE_RADIUS), "--simulator-bin", standin]
         for s in SCENE_SIMS], root, tmp, "generate")
    print(f"phase 18: started {len(SCENE_SIMS)} scene generations and the "
          "tiny_run drills beside the kernel build")
    return {"tmp": tmp, "scenes": scenes, "gen": gen,
            "drills": DrillRuns(root, tmp)}


def join_scene_work(work, t_build):
    """Wait, after the build, for phase 18's host work, so that none of it
    runs beside a measured phase."""
    try:
        work["gen_out"] = work["gen"].results()
    except TimeoutError as e:
        fail(f"phase 18 generate: {e}")
    work["drills"].join(1200)
    check(not work["drills"].is_alive(),
          "phase 18: the drills still run after 1200 s")
    waited = time.perf_counter() - t_build
    print(f"phase 18's host work done {waited:.1f} s after the build "
          f"(generate {max(w for _, _, w in work['gen_out']):.1f} s, the "
          f"drills {work['drills'].seconds:.1f} s, from their start)")


def scene_phase(root, dev, work):
    """Phase 18: (a) Fluid113K from the synthesized scenes through the
    distribute path, (b) the kill-and-resume drills' checks. The scenes,
    exports, shards, logs and checkpoints are removed afterwards."""
    from distegnn_tpu_torch import obs

    t0 = time.perf_counter()
    try:
        res = scene_train_phase(root, dev, work)
        res["drill_s"] = drill_phase(work["drills"])
    finally:
        obs.configure(enable=False)
        shutil.rmtree(work["tmp"], ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"phase 18: {res['seconds']:.1f} s here ((a) {res['a_s']:.1f}), "
          f"its host work beside the build: generate "
          f"{res['gen_s']:.1f} s, the drills {res['drill_s']:.1f} s")
    return res


def scene_train_phase(root, dev, work):
    import itertools
    import pickle

    import numpy as np
    import torch

    from distegnn_tpu_torch.config import derive_runtime_fields, load_config
    from distegnn_tpu_torch.data import fluid113k
    from distegnn_tpu_torch.data.bgeo import numpy_from_bgeo
    from distegnn_tpu_torch.models.registry import get_model
    from distegnn_tpu_torch.ops import edge_pipeline as ep
    from distegnn_tpu_torch.parallel import launch
    from distegnn_tpu_torch.parallel.collectives import (all_gather,
                                                         all_reduce)
    from distegnn_tpu_torch.parallel.mesh import (GRAPH_AXIS, backend_for,
                                                  destroy_graph_group,
                                                  init_graph_group)

    t_a = time.perf_counter()
    tmp = work["tmp"]
    print(f"phase 18 (a): Fluid113K scenes {SCENE_SIMS}, reader: "
          f"{SCENE_READER}")
    gen = work["gen_out"]
    gen_s = max(wall for _, _, wall in gen)
    sims = {}
    for s, (rc, out, wall) in zip(SCENE_SIMS, gen):
        check(rc == 0, f"(a) generate --seed {s} exited {rc}:\n{out[-3000:]}")
        sim_dir = os.path.join(work["scenes"], f"sim_{s:04d}")
        with open(os.path.join(sim_dir, "scene.json")) as f:
            scene = json.load(f)
        fluids = {fm["id"]: numpy_from_bgeo(
            os.path.join(sim_dir, fm["particleFile"]))
            for fm in scene["FluidModels"]}
        n = sum(p.shape[0] for p, _ in fluids.values())
        sim_line = [ln for ln in out.splitlines()
                    if ln.startswith("stand-in simulator:")]
        check(len(sim_line) == 1, f"(a) sim {s}: the stand-in simulator "
              f"printed no result:\n{out[-3000:]}")
        sim_s = float(sim_line[0].rsplit(" in ", 1)[1].split()[0])
        print(f"(a) sim {s}: generate (beside the build) {wall:.2f} s: the "
              f"stand-in {sim_s:.2f} s, the rest (interpreter, imports, "
              f"synthesis) {wall - sim_s:.2f} s; "
              f"{n} particles in {len(fluids)} fluid(s) "
              + ", ".join(f"{fid} {p.shape[0]} (viscosity "
                          f"{scene[fid]['viscosity']:.5f}, density0 "
                          f"{scene[fid]['density0']:.1f})"
                          for fid, (p, _) in fluids.items())
              + f"; {sim_line[0]}")
        check(n == SCENE_PARTICLES,
              f"(a) sim {s}: {n} particles, not {SCENE_PARTICLES}")
        # the reader against the stand-in's frames and the scene's constants
        t0 = time.perf_counter()
        pos, vel, visc, mass = scene_sim(sim_dir)
        read_s = time.perf_counter() - t0
        dt = np.float32(1.0 / scene["Configuration"]["particleFPS"])
        truth = np.stack([np.concatenate(
            [p + np.float32(t * float(dt)) * v for p, v in fluids.values()])
            for t in range(SCENE_FRAMES)])
        check(pos.shape == (SCENE_FRAMES, SCENE_PARTICLES, 3)
              and vel.shape == pos.shape,
              f"(a) sim {s}: frames {pos.shape}, {vel.shape}")
        err = float(np.abs(pos - truth).max())
        want_v = np.concatenate([np.full(p.shape[0], scene[f]["viscosity"],
                                         np.float32)
                                 for f, (p, _) in fluids.items()])
        want_m = (np.concatenate([np.full(p.shape[0], scene[f]["density0"],
                                          np.float32)
                                  for f, (p, _) in fluids.items()])
                  * (2 * SCENE_RADIUS) ** 3).astype(np.float32)
        print(f"(a) sim {s}: read {SCENE_FRAMES} frames in {read_s:.2f} s; "
              f"positions vs the stand-in's frames max abs err {err:.3e} "
              f"(tol 1e-6); viscosity and mass per fluid "
              f"{np.array_equal(visc, want_v) and np.array_equal(mass, want_m)}")
        check(err <= 1e-6, f"(a) sim {s}: positions off the stand-in's")
        check(np.array_equal(visc, want_v) and np.array_equal(mass, want_m),
              f"(a) sim {s}: viscosity or mass not the scene's")
        sims[s] = sim_dir
    print("(a) pack: not run (no zstandard installed); the pack -> "
          "read_sim round trip is held on the CPU")

    data_dir = os.path.join(tmp, "data")
    cfg = derive_runtime_fields(load_config(
        os.path.join(root, "configs", "largefluid_distegnn.yaml"),
        {"model.edge_impl": "fused", "data.edge_block": BLOCK,
         "data.max_samples": 2, "train.epochs": 1, **EAGER,
         "log.test_interval": 1, "data.data_dir": data_dir,
         "log.log_dir": os.path.join(tmp, "logs")}))
    ws = cfg.data.world_size
    backend = backend_for(ws, dev.type)
    check(ws == max(1, torch.cuda.device_count()) and ws == 1,
          f"(a) world size {ws} not derived from one card")
    if dev.type == "cuda":
        check(backend == "nccl", "(a) one rank would not take nccl")
    reads, prep = [], []

    def read_scene(data_dir_, name, idx):
        check(data_dir_ == data_dir and name == cfg.data.dataset_name
              and idx in sims, f"(a) read_sim({data_dir_!r}, {name!r}, "
              f"{idx}) outside the synthesized scenes")
        t0 = time.perf_counter()
        out = scene_sim(sims[idx])
        reads.append(time.perf_counter() - t0)
        return out

    real_prep = launch._dispatch_preprocess

    def timed_prep(*a, **k):
        t0 = time.perf_counter()
        out = real_prep(*a, **k)
        prep.append(time.perf_counter() - t0)
        return out

    probe_dir = os.path.join(tmp, "probe")
    os.makedirs(probe_dir)
    print_mode("phase 18 (a) ", cfg)
    # the rank runs in this process: its collective counts start from 0
    for c in (all_reduce, all_gather):
        c.counts.clear()
        c.seconds.clear()
    reset_fused_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the main path: counts 0 just before, read just after
    with mock.patch.object(fluid113k, "read_sim", read_scene), \
            mock.patch.object(launch, "_dispatch_preprocess", timed_prep):
        best = launch.run_distributed(cfg, device=dev,
                                      on_step=StepProbe(probe_dir))
    fwd, bwd = fused_counts()
    tc = ep.fused_edge_layer.tc_launches
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(len(prep) == 1 and len(reads) == 3,
          f"(a) {len(prep)} preprocessing call(s), {len(reads)} sim reads")
    print(f"(a) run_distributed at world size {ws} (backend {backend}): "
          f"{wall:.1f} s; read {sum(reads):.2f} s for {len(reads)} sims, "
          f"preprocessing (frames -> graphs -> the partition shards) "
          f"{prep[0] - sum(reads):.2f} s; best {best}")
    rows = read_probe(probe_dir, ws)[0]
    L, micro = cfg.model.n_layers, len(rows)
    with mock.patch.object(fluid113k, "read_sim", read_scene):
        paths = launch._dispatch_preprocess(cfg, ws)
    check(len(reads) == 3, "(a) the cached shards were read again")
    with open(paths[0][0], "rb") as f:
        train = pickle.load(f)
    deg = [g["edge_index"].shape[1] / g["loc"].shape[0] for g in train]
    print(f"(a) train graphs: {len(train)} of "
          f"{[g['loc'].shape[0] for g in train]} nodes, mean degree "
          + " ".join(f"{d:.2f}" for d in deg))
    evals = 2 * 2     # valid + test, max_samples 2 each, batch 1
    want_fwd, want_bwd = 2 * L * micro + L * evals, L * micro
    steps = [(r["fwd"] - q["fwd"], r["bwd"] - q["bwd"]) for q, r in
             zip([{"fwd": 0, "bwd": 0}] + rows, rows)]
    print(f"(a) {micro} micro-steps ({cfg.train.epochs} epoch of "
          f"{len(train)} graphs, batch {cfg.data.batch_size}) + {evals} eval "
          f"forwards: fused_edge_fwd {fwd} ({tc} on the tensor cores; "
          f"expected {2 * L} a micro-step x {micro} + {L} x {evals} = "
          f"{want_fwd}), fused_edge_bwd {bwd} (expected {want_bwd}); per "
          f"micro-step {steps}; peak device memory {peak / 2**30:.3f} GiB")
    check(micro == 2 and len(train) == 2, f"(a) {micro} micro-steps")
    check(all(st == (2 * L, L) for st in steps),
          f"(a) launches a micro-step {steps}, expected {(2 * L, L)}")
    check(fwd == want_fwd and bwd == want_bwd and tc == fwd,
          f"(a) launches fwd {fwd} bwd {bwd} tc {tc}")
    check(all(math.isfinite(r["loss"]) for r in rows),
          "(a) non-finite train loss")
    report_dist_run("(a) ", cfg, [rows], SCENE_PARTICLES,
                    {"layout": 6, "replicated": 1})

    # the first update again, in this process at world size 1: the kernels,
    # then the plain versions; both kernels at the batch's shape
    gg = init_graph_group(1, 0, dev.type,
                          "file://" + os.path.join(tmp, "check_store"))
    try:
        loader = launch.rank_loaders(cfg, paths, 0, gg.device)[0]
        loader.set_epoch(1)
        batches = list(itertools.islice(loader,
                                        cfg.train.accumulation_steps))
        init = get_model(cfg.model, generator=torch.Generator().manual_seed(
            int(cfg.seed))).state_dict()
        k = first_update(cfg, init, batches, dev, time_extra=SCENE_TIMED,
                         axis_name=GRAPH_AXIS, rank=0)
        p = first_update(cfg, init, batches, dev,
                         patches=fused_plain_patches(), axis_name=GRAPH_AXIS,
                         rank=0)
        fused = get_model(cfg.model)
        fused.load_state_dict(init)
        kernels = flagship_kernel_phase(fused.to(dev), batches[0], dev)
        n_real = float(batches[0].node_mask.sum())
    finally:
        destroy_graph_group()
    n_micro = cfg.train.accumulation_steps
    check(k["launches"] == (2 * L * n_micro, L * n_micro)
          and p["launches"] == (0, 0),
          f"(a) first update launches: kernels {k['launches']}, plain "
          f"{p['launches']}")
    errs, per = update_distance(k, p)
    worst = sorted(per.items(), key=lambda kv: -kv[1])
    print(f"(a) first update, kernels vs plain: losses max rel err "
          f"{max(errs['loss'], errs['loss_with_mmd']):.3e}, gradient norm "
          f"{errs['grad norm']:.3e}, max {errs['grad']:.3e} (tol "
          f"{TOL_TRAIN:.0e}); worst tensor {worst[0][0]} {worst[0][1]:.3e} "
          f"(tol {TOL_PARAM:.3e})")
    check(all(errs[key] <= TOL_TRAIN for key in ("loss_with_mmd", "loss",
                                                 "grad norm", "grad")),
          "(a) the kernels disagree with the plain versions")
    check(worst[0][1] <= TOL_PARAM,
          f"(a) the gradient of {worst[0][0]} disagrees")
    med = step_times("(a) ", k, n_real)
    a_s = time.perf_counter() - t_a
    print(f"phase 18 (a): {a_s:.1f} s")
    return {"kernels": kernels, "launches": (fwd, bwd), "ms": med,
            "a_s": a_s, "gen_s": gen_s}


def tiny_cmd(log_dir, *extra):
    return [sys.executable, "-m", "distegnn_tpu_torch.testing.tiny_run",
            "--log-dir", log_dir] + [str(a) for a in extra]


def tiny_result(label, run, want_rc=0):
    """(exit code, output, RESULT dict or None) of a tiny_run; checks the
    exit code."""
    rc, out, wall = run
    result = [json.loads(ln[len("RESULT "):]) for ln in out.splitlines()
              if ln.startswith("RESULT ")]
    print(f"(b) {label}: exit {rc} in {wall:.1f} s; "
          f"{result[0] if result else 'no RESULT line'}")
    check(rc == want_rc, f"(b) {label} exited {rc}, expected {want_rc}:\n"
          f"{out[-3000:]}")
    return out, result[0] if result else None


def drill_phase(drills):
    """Phase 18 (b)'s checks of :class:`DrillRuns`:
    ``python -m distegnn_tpu_torch.testing.tiny_run`` at its default device
    (the card), as the JAX package's resilience tests drive its own: the
    controls finish; the SIGKILL leaves step checkpoints and its resume
    logs "resume: skipping" (past the truncated newest) and "resume:
    restored"; the SIGTERM exits 75 with the preempt checkpoint and marker;
    both resumes reach the control's final loss within max(DRILL_FACTOR x
    the controls' distance, DRILL_FLOOR x |loss|); the NaN batch gives one
    divergence event, not diverged, a finite loss. tiny_run's FastEGNN
    runs the plain scatter: it launches no kernel, so this checks the
    training runtime on the card, not a kernel. Returns the drills' wall
    seconds."""
    print("phase 18 (b): the kill-and-resume drills of tiny_run on the card "
          "(plain scatter: no kernel launches; the runtime is checked, not "
          "a kernel)")
    check(drills.error is None, f"(b) the drills failed: {drills.error!r}")
    first, second, d = drills.first, drills.second, drills.dirs
    _, r1 = tiny_result("control 1", first[0])
    _, r2 = tiny_result("control 2", first[1])
    tiny_result("SIGKILL after step 6", first[2], want_rc=-9)
    out, rt = tiny_result("SIGTERM after step 2", first[3], want_rc=75)
    state = os.path.join(d["term"], "run", "state_dict")
    check("PREEMPTED" in out and rt is not None and rt["preempted"]
          and os.path.exists(os.path.join(state, "preempt_model.ckpt"))
          and os.path.exists(os.path.join(state, "PREEMPTED")),
          "(b) SIGTERM left no preempt checkpoint and marker")
    out, rp = tiny_result("NaN batch at step 5, 2 retries", first[4])
    check("DIVERGED" in out and "rolling back" in out
          and rp["divergence_events"] == 1 and not rp["diverged"]
          and math.isfinite(rp["final_train_loss"]),
          f"(b) the poisoned run did not roll back and recover: {rp}")
    check(len(drills.steps) >= 2, f"(b) the killed run left "
          f"{len(drills.steps)} step checkpoints")
    print(f"(b) truncated the newest of {len(drills.steps)} step "
          f"checkpoints: {os.path.basename(drills.steps[-1])}")
    loss = r1["final_train_loss"]
    bound = max(DRILL_FACTOR * abs(r2["final_train_loss"] - loss),
                DRILL_FLOOR * abs(loss))
    for label, run, skip in (("resume after SIGKILL", second[0], True),
                             ("resume after SIGTERM", second[1], False)):
        out, r = tiny_result(label, run)
        dist = abs(r["final_train_loss"] - loss)
        print(f"(b) {label}: final train loss {r['final_train_loss']!r} vs "
              f"control {loss!r}: {dist:.3e} (bound {bound:.3e}: "
              f"{DRILL_FACTOR:g} x the controls' "
              f"{abs(r2['final_train_loss'] - loss):.3e}, floor "
              f"{DRILL_FLOOR:g} x |loss|); from epoch {r['start_epoch']} + "
              f"{r['start_step_in_epoch']} step(s)")
        check("resume: restored" in out and (not skip
                                            or "resume: skipping" in out),
              f"(b) {label}: the log lacks the resume lines")
        check(r["start_epoch"] > 0 or r["start_step_in_epoch"] > 0,
              f"(b) {label} started from scratch")
        check(dist <= bound, f"(b) {label}: {dist:.3e} from the control's "
              f"loss, bound {bound:.3e}")
    print(f"phase 18 (b): the drills took {drills.seconds:.1f} s (wall, "
          "beside the build: each run's seconds are from its wave's start)")
    return drills.seconds


# ---------------------------------------------------------------- phase 19

TOOLS_SIZES = (256, 512, 1024)          # (a)'s --sizes
TOOLS_RATES = (10.0, 20.0, 40.0)        # (a)'s --rate, req/s
TOOLS_REQUESTS = 64
TOOLS_ROLLOUT_SIZES = (1000, 2000, 4000)   # (b)'s --sizes
TOOLS_ROLLOUT_SCENES, TOOLS_ROLLOUT_STEPS = 8, 8
TOOLS_TRAFFIC = ["--profile", "spike10x", "--requests", "96", "--rate", "10",
                 "--mix", "predict=0.6,session=0.3,rollout=0.1"]
TOOLS_REMAT_NODES = (20000, 50000, FLUID_N)   # the script's defaults + 113140
TOOLS_EVAL_SAMPLES = 4
TOOLS_EVAL_FRAMES = 71          # frame_0 30, frame_T 40: 4 horizons


def run_tool(main, argv):
    """A tool's ``main(argv)`` in this process: (return value, its stdout
    lines); the lines are printed here too."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    for ln in lines:
        print(f"  | {ln}")
    return rc, lines


def tools_phase(root, dev):
    """Phase 19 (see the module docstring). Its files go to a temporary
    directory that is removed afterwards."""
    with phase_tmp("chip_smoke_tools_") as tmp:
        return _tools_phase(root, dev, tmp)


def tools_yaml(root, tmp, name, over):
    """configs/nbody_serve.yaml with the nested overrides ``over``."""
    import yaml

    with open(os.path.join(root, "configs", "nbody_serve.yaml")) as f:
        raw = yaml.safe_load(f)
    for section, kv in over.items():
        raw.setdefault(section, {}).update(kv)
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def tools_bench_http(root, dev, tmp):
    """(a): serve_bench --transport http at three offered rates on the
    gateway's fused model; row 1 launches exactly L x max_batch a batch."""
    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.ops import edge_pipeline as ep
    from distegnn_tpu_torch.scripts import serve_bench as psb
    from distegnn_tpu_torch.serve.buckets import synthetic_graph

    path = tools_yaml(root, tmp, "bench.yaml", {
        "model": {"edge_impl": "fused"}, "data": {"edge_block": BLOCK}})
    cfg = load_config(path)
    L, B = cfg.model.n_layers, cfg.serve.max_batch
    edges = [synthetic_graph(n, seed=43 + i).get("edge_index").shape[1]
             for i, n in enumerate(TOOLS_SIZES)]
    print(f"phase 19 (a): serve_bench's graphs {dict(zip(TOOLS_SIZES, edges))} "
          f"edges (max_edges {cfg.serve.max_edges})")
    check(max(edges) <= cfg.serve.max_edges, "tools: a bench graph exceeds "
          "serve.max_edges")
    out, fwd = [], 0
    for rate in TOOLS_RATES:
        warm = {}

        def boundary(_real=psb._mark_warmup_done):
            warm["launches"] = ep.fused_edge_layer.launches
            _real()

        reset_all_counts()
        with mock.patch.object(psb, "_mark_warmup_done", boundary):
            rc, lines = run_tool(psb.main, [
                "--config_path", path, "--transport", "http", "--requests",
                str(TOOLS_REQUESTS), "--sizes",
                ",".join(map(str, TOOLS_SIZES)), "--rate", str(rate),
                "--obs-dir", "", "--device", dev.type])
        n, n32 = ep.fused_edge_layer.launches, ep.fused_edge_layer.f32_launches
        rec = json.loads(lines[-1])
        snap = rec["snapshot"]
        batches = snap["batches_executed"]
        timed = n - warm["launches"]
        print(f"phase 19 (a) rate {rate:g} req/s: sustained "
              f"{rec['value']} req/s, completed {snap['requests_completed']}"
              f"/{TOOLS_REQUESTS}, shed {rec['rejected_at_submit']} (429) + "
              f"{snap['requests_timeout']} (timeout), latency p50 "
              f"{snap['latency_p50_ms']} ms p99 {snap['latency_p99_ms']} ms, "
              f"queue wait p50 {snap['queue_wait_p50_ms']} ms p99 "
              f"{snap['queue_wait_p99_ms']} ms, batches {batches} (fill "
              f"{snap['batch_fill_ratio']}), wall {rec['wall_s']} s; "
              f"fused_edge_fwd_f32 launches {timed} in the timed window + "
              f"{warm['launches']} in the warmup")
        check(rc == 0 and snap["requests_completed"] > 0,
              f"tools (a) rate {rate}: nothing completed")
        check(timed == L * B * batches,
              f"tools (a): {timed} fused launches for {batches} batches, "
              f"want {L * B} a batch")
        check(warm["launches"] % (L * B) == 0 and n32 == n,
              f"tools (a): warmup launches {warm['launches']}, f32 {n32} of "
              f"{n}")
        fwd += n
        out.append({"rate": rate, "sustained": rec["value"],
                    "completed": snap["requests_completed"],
                    "shed": rec["rejected_at_submit"],
                    "timeouts": snap["requests_timeout"],
                    "p50": snap["latency_p50_ms"],
                    "p99": snap["latency_p99_ms"]})
    return out, fwd


def tools_bench_rollout(root, dev, tmp, r0):
    """(b): serve_bench --workload rollout on phase 3d's config; the one-hot
    kernels launch exactly as blocked_want derives them for the run's
    steps."""
    from distegnn_tpu_torch.config import load_config
    from distegnn_tpu_torch.scripts import serve_bench as psb

    opts = dict(ROLLOUT_OPTS, radius=float(r0))
    path = tools_yaml(root, tmp, "rollout.yaml", {
        "model": {"blocked_impl": "pallas"}, "serve": {"rollout": opts}})
    L = load_config(path).model.n_layers
    K, S = TOOLS_ROLLOUT_STEPS, TOOLS_ROLLOUT_SCENES
    reset_all_counts()
    rc, lines = run_tool(psb.main, [
        "--config_path", path, "--workload", "rollout", "--sizes",
        ",".join(map(str, TOOLS_ROLLOUT_SIZES)), "--rollout-scenes", str(S),
        "--rollout-steps", str(K), "--rate", "40", "--obs-dir", "",
        "--device", dev.type])
    got = blocked_counts(), blocked_widths()
    rec = json.loads(lines[-1])
    batches = rec["snapshot"]["batches_executed"]
    # warmup (one solo + one batch-of-1 rollout), the solo and the B=1
    # windows (S each) and the coalesced batches: K steps each
    steps = K * (2 + 2 * S + batches)
    want = blocked_want(L, steps=steps)
    print(f"phase 19 (b): serve_bench rollout {rec['value']} scenes*steps/s "
          f"batched vs {rec['baseline_b1']} B=1 ({rec['vs_baseline']}x), "
          f"solo {rec['baseline_solo']}; {rec['scenes_completed']}/{S} "
          f"scenes in {batches} batches; blocked_seg_sum {got[0][0]} "
          f"{got[1][0]}, blocked_gather {got[0][1]} {got[1][1]}, "
          f"blocked_plan {got[0][2]} (want {want} for {steps} steps)")
    check(rc == 0 and rec["scenes_completed"] == S,
          f"tools (b): {rec['scenes_completed']}/{S} scenes completed")
    check(got[1] == want[:2] and got[0] == (steps * 2 * L, steps * 2 * L,
                                            steps),
          f"tools (b): launches {got} != {want}")
    return rec, got


def tools_traffic(root, dev, tmp, r0):
    """(c): traffic_gen's spike10x replay against phase 12's two-model
    gateway, in process and over --url against a gateway process."""
    import signal

    from distegnn_tpu_torch.ops import edge_pipeline as ep
    from distegnn_tpu_torch.scripts import traffic_gen as ptg

    path = gateway_yaml(root, tmp, r0)
    argv = ["--config_path", path, *TOOLS_TRAFFIC, "--obs-dir", ""]
    held = {}

    def boot(args, cfg, device, _real=ptg.boot_gateway):
        gw, server, reg = _real(args, cfg, device)
        held["reg"], held["warm"] = reg, (ep.fused_edge_layer.launches,
                                          blocked_counts())
        eng = reg.get("rollout").engine
        held["steps"] = 0
        real_batch = eng.rollout_batch

        def counting(scenes, *a, **kw):
            held["steps"] += int(scenes[0]["steps"])
            return real_batch(scenes, *a, **kw)

        eng.rollout_batch = counting
        return gw, server, reg

    reset_all_counts()
    t0 = time.perf_counter()
    with mock.patch.object(ptg, "boot_gateway", boot):
        rc, lines = run_tool(ptg.main, argv + ["--device", dev.type])
    inproc = json.loads(lines[-1])
    reg = held["reg"]
    fused_batches = reg.get("fused").engine.metrics.snapshot()[
        "batches_executed"]
    L = reg.get("fused").engine.model.n_layers
    B = reg.get("fused").engine.max_batch
    fwd = ep.fused_edge_layer.launches
    timed = fwd - held["warm"][0]
    bl, widths = blocked_counts(), blocked_widths()
    want = blocked_want(L, steps=held["steps"])
    s = held["steps"]
    print(f"phase 19 (c) in process ({time.perf_counter() - t0:.1f} s): "
          f"fused_edge_fwd_f32 {timed} for {fused_batches} fused batches "
          f"(+ {held['warm'][0]} warmup); {s} rollout steps: "
          f"blocked_seg_sum {bl[0]} {widths[0]}, blocked_gather {bl[1]} "
          f"{widths[1]}, blocked_plan {bl[2]} (want {want})")
    check(rc == 0 and inproc["completed"] > 0, "tools (c): in-process "
          "replay completed nothing")
    check(timed == L * B * fused_batches, f"tools (c): {timed} fused "
          f"launches for {fused_batches} batches")
    check(held["warm"][1] == (0, 0, 0) and widths == want[:2]
          and bl == (s * 2 * L, s * 2 * L, s),
          f"tools (c): one-hot launches {bl} {widths} != {want}")
    launches = {"fwd": fwd, "widths": widths, "plan": bl[2]}

    # the same replay over --url against a gateway process: the clients and
    # the gateway no longer share an interpreter
    env = dict(os.environ, PYTHONPATH=root)
    err_path = os.path.join(tmp, "tools_gateway.stderr")
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "distegnn_tpu_torch.serve.gateway",
             "--config_path", path, "--port", "0", "--obs-dir", "",
             "--device", dev.type], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            port = None
            for line in proc.stdout:
                if "listening on http://" in line:
                    port = int(line.split("http://")[1].split()[0]
                               .rsplit(":", 1)[1])
                    break
            check(port is not None, "tools (c): the gateway process printed "
                  "no listening line: " + open(err_path).read()[-2000:])
            while http_call(port, "GET", "/readyz")[0] != 200:
                check(time.perf_counter() - t0 < 120, "tools (c): /readyz "
                      "never answered 200")
                time.sleep(0.05)
            up_s = time.perf_counter() - t0
            rc, lines = run_tool(ptg.main, argv + [
                "--url", f"http://127.0.0.1:{port}"])
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                code = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                code = proc.wait()
    remote = json.loads(lines[-1])
    check(code == 0, f"tools (c): the gateway process exited {code}")
    check(rc == 0 and remote["completed"] > 0, "tools (c): the --url replay "
          "completed nothing")
    for label, rec in (("in process", inproc), ("--url", remote)):
        ph = rec["phases"]
        print(f"phase 19 (c) {label}: completed {rec['completed']}/"
              f"{rec['requests']}, shed {rec['shed']}, errors {rec['errors']}"
              f", lost {rec['lost']}, {rec['throughput_rps']} req/s; "
              + "; ".join(
                  f"{p} n={ph[p]['count']} ok={ph[p]['ok']} p50 "
                  f"{ph[p]['p50_ms']} p99 {ph[p]['p99_ms']} interactive p99 "
                  f"{ph[p]['interactive_p99_ms']} slo "
                  f"{'PASS' if ph[p].get('slo_pass') else 'BREACH'}"
                  for p in ("pre", "spike", "post"))
              + f"; SLO overall {'PASS' if rec['slo']['pass'] else 'BREACH'}")
        check(rec["lost"] == 0, f"tools (c) {label}: {rec['lost']} requests "
              "got no answer")
    check({p: v["count"] for p, v in inproc["phases"].items()}
          == {p: v["count"] for p, v in remote["phases"].items()},
          "tools (c): the two replays' phases differ")
    print(f"phase 19 (c): the gateway process was ready in {up_s:.1f} s and "
          f"drained to exit 0 on SIGTERM")
    return {"inproc": inproc, "remote": remote}, launches


def tools_remat(dev, tmp):
    """(d): measure_remat_memory on the flagship model (bf16, H=64, L=4,
    C=3) at the script's default sizes and at 113140 nodes."""
    from distegnn_tpu_torch.scripts import measure_remat_memory as premat

    out = os.path.join(tmp, "remat.json")
    run_tool(premat.main, ["--nodes", *map(str, TOOLS_REMAT_NODES),
                           "--xla-temp", "--device", dev.type, "--json",
                           out])
    with open(out) as f:
        rows = json.load(f)["rows"]
    by = {(r["n_nodes"], r["remat"]): r for r in rows}
    for n in TOOLS_REMAT_NODES:
        off, on = by[n, False], by[n, True]
        print(f"phase 19 (d) N={n} E={off['n_edges']}: saved "
              f"{mib(off['residual_bytes'])} without remat, "
              f"{mib(on['residual_bytes'])} with; the card's peak over a "
              f"grad step {mib(off['temp_bytes'])} without, "
              f"{mib(on['temp_bytes'])} with (peak allocated "
              f"{mib(off['peak_bytes'])} / {mib(on['peak_bytes'])})")
        check(on["residual_bytes"] < off["residual_bytes"]
              and on["temp_bytes"] < off["temp_bytes"],
              f"tools (d): remat saved nothing at N={n}")
    return rows


def tools_evaluate(root, dev, tmp):
    """(e): evaluate_rollout's n-body leg on the port's generator's data
    with model.blocked_impl pallas: exact one-hot launches."""
    import yaml

    from distegnn_tpu_torch.data.nbody_sim import generate_nbody_files
    from distegnn_tpu_torch.scripts import evaluate_rollout as pro

    with open(os.path.join(root, "configs", "nbody_fastegnn.yaml")) as f:
        raw = yaml.safe_load(f)
    data_dir = os.path.join(tmp, "nbody")
    raw["data"]["data_dir"] = data_dir
    raw["model"]["blocked_impl"] = "pallas"
    path = os.path.join(tmp, "nbody_eval.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    t0 = time.perf_counter()
    generate_nbody_files(os.path.join(data_dir, raw["data"]["dataset_name"]),
                         n_isolated=100, num_test=TOOLS_EVAL_SAMPLES,
                         length=TOOLS_EVAL_FRAMES * 100, sample_freq=100,
                         seed=43, device=dev)
    gen_s = time.perf_counter() - t0
    L = raw["model"]["n_layers"]
    reset_all_counts()
    t0 = time.perf_counter()
    _, lines = run_tool(pro.main, ["--config_path", path, "--samples",
                                   str(TOOLS_EVAL_SAMPLES), "--device",
                                   dev.type])
    eval_s = time.perf_counter() - t0
    rec = json.loads(lines[-1])
    got = blocked_counts(), blocked_widths()
    steps = rec["steps"] * rec["samples"]
    want = blocked_want(L, steps=steps)
    print(f"phase 19 (e): {rec['samples']} n-body trajectories generated in "
          f"{gen_s:.1f} s, evaluated in {eval_s:.1f} s: horizons "
          f"{rec['horizons']}; blocked_seg_sum {got[0][0]} {got[1][0]}, "
          f"blocked_gather {got[0][1]} {got[1][1]}, blocked_plan "
          f"{got[0][2]} (want {want} for {steps} steps)")
    check(rec["steps"] >= 2 and all(math.isfinite(v)
                                    for v in rec["horizons"].values()),
          "tools (e): bad horizons")
    check(got[1] == want[:2] and got[0] == (steps * 2 * L, steps * 2 * L,
                                            steps),
          f"tools (e): launches {got} != {want}")
    return rec, got


def _tools_phase(root, dev, tmp):
    t_phase = time.perf_counter()
    # the host the open loops share: threads that earlier phases left
    # running in this interpreter compete with the clients and the gateway
    names = collections.Counter(
        "".join(c for c in t.name if not c.isdigit()).rstrip("-_ ")
        for t in threading.enumerate())
    print(f"phase 19: at its start {threading.active_count()} threads in "
          f"this process ({dict(names)}), load average "
          f"{tuple(round(x, 2) for x in os.getloadavg())}")
    r0, _ = rollout_radius()
    t = [time.perf_counter()]
    rates, fwd = tools_bench_http(root, dev, tmp)
    t.append(time.perf_counter())
    bench_rollout, rl = tools_bench_rollout(root, dev, tmp, r0)
    t.append(time.perf_counter())
    traffic, tl = tools_traffic(root, dev, tmp, r0)
    t.append(time.perf_counter())
    remat = tools_remat(dev, tmp)
    t.append(time.perf_counter())
    evaluate, el = tools_evaluate(root, dev, tmp)
    t.append(time.perf_counter())
    secs = [round(b - a, 1) for a, b in zip(t, t[1:])]
    print(f"phase 19 (the tools): passed in {time.perf_counter() - t_phase:.1f}"
          f" s ((a) {secs[0]}, (b) {secs[1]}, (c) {secs[2]}, (d) {secs[3]},"
          f" (e) {secs[4]} s)")
    widths = [collections.Counter() for _ in range(2)]
    for i in (0, 1):
        for w in (rl[1][i], tl["widths"][i], el[1][i]):
            widths[i].update(w)
    return {"rates": rates, "rollout": bench_rollout, "traffic": traffic,
            "remat": remat, "evaluate": evaluate, "fwd": fwd + tl["fwd"],
            "widths": [dict(w) for w in widths],
            "plan": rl[0][2] + tl["plan"] + el[0][2]}


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
    root = os.path.dirname(os.path.abspath(__file__))
    scene_work = start_scene_work(root)

    def build():
        t = time.perf_counter()
        return build_all(["fused_edge_fwd", "fused_edge_bwd", "prefix_scan",
                          "fused_stack_fwd", "blocked_onehot"]), \
            time.perf_counter() - t

    # the phases' host inputs are made while nvcc builds
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(build)
        t0 = time.perf_counter()
        clouds = [fluid_cloud(300 + i) for i in range(6)]
        stack_clouds = [fluid_cloud(400 + i, n=STACK_FLUID_N)
                        for i in range(6)]
        scenes = serve_scenes()
        # phase 19 (d)'s clouds (the remat script caches them a size)
        from distegnn_tpu_torch.scripts import measure_remat_memory
        for n in TOOLS_REMAT_NODES:
            measure_remat_memory._fluid_batch(n)
        inputs_s = time.perf_counter() - t0
        reports, build_s = building.result()
    print(f"built {len(reports)} kernel source(s) in {build_s:.1f} s")
    join_scene_work(scene_work, time.perf_counter())
    for name, rep in reports.items():
        for line in rep.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line or "error" in line):
                print(f"  {name}: {line.strip()}")

    dev = torch.device(DEVICE)
    profile = "--profile" in sys.argv[1:]
    e = [c["edge_index"].shape[1] for c in clouds]
    print(f"clouds: 6 x N={FLUID_N}, edges {min(e)}..{max(e)} (mean degree "
          f"{np.mean(e) / FLUID_N:.2f}); serve scenes; built in "
          f"{inputs_s:.1f} s, beside the kernel build")

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
    dist = dist_phase(root, dev, clouds)
    preempt = preempt_phase(root, dev, clouds)
    data = data_phase(root, dev)
    gate = gateway_phase(root, dev)
    promo = promote_phase(root, dev, gate)
    tiled = tiled_phase(root, dev)
    fam = family_phase(root, dev)
    mesh = mesh_phase(root, dev, clouds[0], dist["part"])
    scan = scan_epoch_phase(root, dev, clouds, stack_clouds)
    scenes_res = scene_phase(root, dev, scene_work)
    tools = tools_phase(root, dev)
    print(f"main-path launches: fused_edge_fwd {launches} (serve) + "
          f"{gate['fwd']} (gateway) + {promo['sub_fwd']} (worker children) "
          f"+ {tiled['launches']} (tiled serve) + {tools['fwd']} (the "
          f"tools: serve_bench http, traffic_gen in process) "
          f"+ {promo['drill_fwd']} (promotion drill children) + "
          f"{train_fwd} (train) + {stack['launches'][1]} (stack train "
          f"backward) + {dist['launches'][0]} (distributed train, "
          f"{DIST_WS} ranks) + {mesh['launches'][0]} (tensor axis, HX = "
          f"{HIDDEN // MESH_TP[2]}), fused_edge_bwd {train_bwd} (train) + "
          f"{stack['launches'][2]} (stack train backward) + "
          f"{dist['launches'][1]} (distributed train) + "
          f"{mesh['launches'][1]} (tensor axis), prefix_scan "
          f"{serve_scans} (serve cumsum) + "
          f"{sum(plain['widths'].values())} (plain train), suffix "
          f"{plain['suffix']}, fused_stack_fwd {serve_stacks} (serve) + "
          f"{stack['launches'][0]} (stack train), blocked_seg_sum "
          f"{rollout['launches'][0][0]} + {rollout['launches'][1][0]} "
          f"(rollout, rollout_batch) + {blocked['launches'][0]} (blocked "
          f"train), blocked_gather {rollout['launches'][0][1]} + "
          f"{rollout['launches'][1][1]} + {blocked['launches'][1]}, "
          f"blocked_plan {rollout['launches'][0][2]} + "
          f"{rollout['launches'][1][2]} + {blocked['launches'][2]}; "
          f"gateway rollouts: blocked_seg_sum {gate['blocked'][0]}, "
          f"blocked_gather {gate['blocked'][1]}, blocked_plan "
          f"{gate['blocked'][2]}; "
          f"preemption drill run A: fused_edge_fwd "
          f"{preempt['launches'][0]}, fused_edge_bwd "
          f"{preempt['launches'][1]}; Water-3D fused train (phase 11 (b)): "
          f"fused_edge_fwd {data['launches'][0]} (all on the f32 kernel), "
          f"fused_edge_bwd {data['launches'][1]}; scanned epoch (phase 17, "
          f"graph replays): cell (d) {scan['a']['replayed']}, n-body "
          f"{scan['b']}, stack {scan['c']['replayed']}; Fluid113K scenes "
          f"(phase 18 (a)): fused_edge_fwd {scenes_res['launches'][0]}, "
          f"fused_edge_bwd {scenes_res['launches'][1]}; the tools (phase "
          f"19): blocked_seg_sum {tools['widths'][0]}, blocked_gather "
          f"{tools['widths'][1]}, blocked_plan {tools['plan']}")

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
            launches + gate["fwd"] + promo["fwd"] + tools["fwd"],
            source="fused_edge_fwd"),
        row("fused_edge_fwd_f32", f"tiled serve f32 {tiled['shape']}",
            tiled["row"], fwd_tpu, tiled["launches"],
            source="fused_edge_fwd"),
        row(flagship["fused_edge_fwd"]["kernel"],
            f"train {flagship['fused_edge_fwd']['dtype']} "
            f"{flagship['fused_edge_fwd']['shape']}",
            flagship["fused_edge_fwd"], fwd_tpu, train_fwd,
            source="fused_edge_fwd"),
        row("fused_edge_bwd", f"train {flagship['fused_edge_bwd']['dtype']} "
            f"{flagship['fused_edge_bwd']['shape']}",
            flagship["fused_edge_bwd"],
            "distegnn_tpu/ops/edge_pipeline.py:314", train_bwd)]
    dk = dist["kernels"]
    kernels += [
        row(dk["fused_edge_fwd"]["kernel"], f"distributed train "
            f"{dk['fused_edge_fwd']['dtype']} {DIST_WS} ranks, rank 0 "
            f"{dk['fused_edge_fwd']['shape']}", dk["fused_edge_fwd"],
            fwd_tpu, dist["launches"][0], source="fused_edge_fwd"),
        row("fused_edge_bwd", f"distributed train "
            f"{dk['fused_edge_bwd']['dtype']} {DIST_WS} ranks, rank 0 "
            f"{dk['fused_edge_bwd']['shape']}", dk["fused_edge_bwd"],
            "distegnn_tpu/ops/edge_pipeline.py:314", dist["launches"][1])]
    wk = data["kernels"]
    kernels += [
        row(wk["fused_edge_fwd"]["kernel"], f"Water-3D train f32 graph 0 "
            f"{wk['fused_edge_fwd']['shape']}", wk["fused_edge_fwd"],
            fwd_tpu, data["launches"][0], source="fused_edge_fwd"),
        row("fused_edge_bwd", f"Water-3D train f32 graph 0 "
            f"{wk['fused_edge_bwd']['shape']}", wk["fused_edge_bwd"],
            "distegnn_tpu/ops/edge_pipeline.py:314", data["launches"][1])]
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
                 [w[i] for w in rollout["widths"]] + [gate["widths"][i],
                                                      tools["widths"][i]]),
                ("blocked train", blocked["rows"], [blocked["widths"][i]])):
            for key, r in sorted(rows.items()):
                n = sum(w.get(key, 0) for w in widths)
                if n:
                    kernels.append(row(
                        name, f"{path} {r[name]['shape']}", r[name],
                        BLOCKED_TPU[name], n, source="blocked_onehot"))
    for path, rows, n in (
            ("rollout serve", rollout["rows"],
             sum(c[2] for c in rollout["launches"]) + gate["blocked"][2]
             + tools["plan"]),
            ("blocked train", blocked["rows"], blocked["launches"][2])):
        r = rows[min(rows)]["blocked_plan"]
        kernels.append(row("blocked_plan", f"{path} {r['shape']}", r,
                           BLOCKED_TPU["blocked_seg_sum"], n,
                           source="blocked_onehot"))
    kernels += family_rows(fam, row)
    kernels += mesh_rows(mesh, row)
    kernels += scanned_epoch_rows(scan, flagship, stack, fam, row)
    sk = scenes_res["kernels"]
    kernels += [
        row(sk["fused_edge_fwd"]["kernel"], f"Fluid113K scenes train "
            f"{sk['fused_edge_fwd']['dtype']} {sk['fused_edge_fwd']['shape']}",
            sk["fused_edge_fwd"], fwd_tpu, scenes_res["launches"][0],
            source="fused_edge_fwd"),
        row("fused_edge_bwd", f"Fluid113K scenes train "
            f"{sk['fused_edge_bwd']['dtype']} {sk['fused_edge_bwd']['shape']}",
            sk["fused_edge_bwd"], "distegnn_tpu/ops/edge_pipeline.py:314",
            scenes_res["launches"][1])]
    print(family_summary(fam))
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
