"""Drive the PyTorch port's serving path, training step, eval path,
parallel paths, MSG modules and checkpoint verifier on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):
  1. environment: card name and power limit (nvidia-smi), torch and CUDA
     versions, and the parallel nvcc build of every kernel in
     graspnet_tpu_torch/csrc, with each kernel's registers, spills and
     shared memory from ptxas;
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at the production main-path shapes with B=2 on a seeded
     synthetic tabletop cloud of 20000 points — indices exactly equal,
     features within FEATURE_TOL; CUDA-event median times; bounds with
     MLP products at the 3xTF32 tensor-core rate and scans at the f32
     CUDA-core rate; K2 (one FPS stage) with its own bound; the ball query
     (K4) at each of a training step's SA1-4
     calls (SA2-4 are a serving forward's), with the points its blocks
     scan and load against the centres' nth-hit tests, and the same for the
     cylinder scan at the CloudCrop's (K5) shapes, B=2 and B=1; the scan
     shares of SA1 (K3) and K5; FPS (K1) stage
     by stage (the chain cut after 1-4 stages, us per argmax step) and
     stage 0 on clusters of 1, 2, 4, 8 and 16 CTAs per scene;
  3. main path: GraspPipeline(GraspNetConfig(), seed=1) on the card —
     get_grasps_topk at B=1 and the batched calls at B=4 give (50, 17)
     finite rows, each forward launches FPS 1, ball query 3, SA1 crop 1 and
     CloudCrop 1 times, the card's top-50 matches the same pipeline on the
     CPU, and p50 latency / sustained frames/s at B=1;
  4. a torch.profiler window over B=1 frames: device time per kernel (K5's
     cylinder scan and MLP launches apart, K3's MLP beside the ball scans of
     K3 and K4) and the device's idle share;
  5. training kernels: the crop group (K6) and the train MLP forward and
     backward (K7) against their plain versions at the training shape
     (B=2, 1024 label points near the tabletop's objects, random
     rotations), with what the cylinder scan's blocks scan and load against
     the centres' nth-hit tests: K7 gradients against a float64 evaluation, as they are and
     with the cotangent zeroed where a pool maximum is ambiguous, and
     against the plain version at the tight bound on one distinct row per
     group; the K7 backward run twice and bitwise equal, and the memory
     one backward call adds;
  6. training step: Trainer(GraspNetConfig(), TrainConfig(), seed=0) on two
     synthetic labelled scenes with host labels from the port's
     label_pipeline — launch counts of step, prepare and step_prepared, a
     loss that falls over 5 steps on a fixed batch, step_compact == step,
     one step's loss and gradients against the same step on the CPU, and
     step times, host label-prep time and peak memory, and a profiled
     step with the K7 forward's (passes 1-3, reductions), backward's
     (pool sums, passes B and C), K4's and K6's time per kernel;
  7. query-family and SA kernels: the multi-depth cylinder query (K8), the
     per-query oracle (K10, a warp per query) and the fused SA2-4 stage
     (K9: K4's ball scan, then the tensor-core MLP) against their plain
     versions at production shapes, B=2, on the tabletop clouds — K8 and
     K10 indices equal to plain, K10 bit-equal to K8 and (ball mode) to K4
     at the SA1-4 calls, K9 within FEATURE_TOL at SA2, SA3 and SA4 on the
     model's own stage points and features; CUDA-event times; K9's scan/MLP
     split (phase sa_feat_split) and a torch.profiler window of K9's and
     K10's kernels by name (phase profile_query_sa), in which K9's three
     calls launch K4's scan and its MLP three times each and nothing else;
  8. train_cli: the training entry point.  The build seconds of the host
     label library (csrc/host.cpp, g++) and the scatter kernels
     (csrc/scatter.cu); the FPS seed chain of two 20000-point scenes on the
     host library and on fps_numpy, indices equal, ms/scene each; five
     Trainer.step calls from one seed twice, losses, parameters and Adam
     state bitwise equal; in a child process with a fixed cuBLAS workspace
     (CUBLAS_WORKSPACE_CONFIG, which only that process sets), five steps
     with the default algorithms and five under
     torch.use_deterministic_algorithms(True), which raises at any op that
     is still non-deterministic, bitwise equal; the scatter-add's two
     kernels at each of a step's five calls (captured from a step): the
     plan kernel's perm, starts and work order bitwise the plain plan's (and
     at five edge cases: a ragged chunk, one row, one filled row, B=1 x
     n=20000, dropped indices), the segment sum against its plain version,
     bitwise against the CPU's sequential sum, within 1e-6 x max(1, scale)
     of a float64 sum, and bitwise repeatable; the plan, the sum and
     torch.index_add under one torch.profiler window (device ms by kernel,
     device operations a call) beside each loop's host and event time;
     then
     scripts/bench_train_pipeline.py's run in-process: one epoch of the
     CLI's loop (apps/train.py::train) with 4 loader worker threads over a
     SyntheticGraspNetDataset at its production shape, the eval pass and the
     checkpoint, with the launches of every kernel along it checked, a
     resume of the checkpoint into a fresh Trainer bitwise equal in
     parameters and Adam state, the sustained ms/step beside the device
     step, stage 1, host prep and finalize times, and the device's busy time
     and idle share over 3 of the loop's steps under torch.profiler, after
     its warm-up, with the loader threads running;
  9. tools: the four timing entry points (graspnet_tpu_torch/scripts/)
     in-process at GraspNetConfig() with short slope windows (2 and 6
     calls, the fastest of 3 each) — every stage
     time finite and > 0, K8 launched by profile_stages and
     crop_train_breakdown, K9 three times per bench_crop_kernels call of
     its stages, K10 by profile_stages — and bench's JSON line;
 10. collision: the collision filter (postproc/collision.py, plain torch)
     after one GraspNetConfig() forward at B=2 on tabletop frames sampled
     from 250k-point raw clouds: detect_batch on the card against the same
     call on the CPU with the same rows and downsampled points, masks and
     IoUs equal, and its ms per frame;
 11. test_app: the eval loop (apps/test.py::inference) through
     scripts/bench_test_app.py's run at GraspNetConfig(), batch 1 and 4,
     over 200 synthetic frames of 250k-point raw clouds with the collision
     filter and the dump: ms/frame and stage means, launches per batch (K1
     1, K3 1, K4 3, K5 1), the device's busy time and idle share over 3
     profiled batches, and the card's dump of two frames against a CPU
     pipeline's dump with the same weights (selection fields equal, floats
     within TOPK_ATOL);
 12. learnability: scripts/learnability_gate.py's run on the card (600
     steps, seed 0): the tiny model trained from scratch, dumped through
     apps/test.py and scored by eval/ap.py; AP(trained) >= 6 > AP(random)
     asserted, the kernels' launches along it counted;
 13. feature_input (run after phase 4): the SA1 routes away from K3 at
     GraspNetConfig() widths, extra input channels (input_feature_dim=3)
     and sa1.normalize_xyz=False: launches K1 1, K3 0, K4 4, K5 1 a
     forward, and the forward equal to the CPU's;
 14. service (after phase 11): apps/service.py's GraspService with seed-1
     weights, card against CPU on two 250k-point requests with the
     collision filter off and on, a TCP round trip equal to the in-process
     reply, and scripts/bench_service.py's run at max_batch 1 and 8 (16
     clients, collision on): requests/s and each dispatch's launches (K1 1,
     K3 1, K4 3, K5 1);
 15. service_success (inside phase 12's directory): the same at the gate's
     tiny config with its trained checkpoint and learnable-scene requests,
     ok > 0 asserted in each mode;
 16. demos (after phase 14): image_demo, demo_pointcloud,
     segmentation_demo, stereo_demo, grasp_tf --once and grasp_base through
     their main(argv) on a synthetic RGB-D frame, image_demo's dump equal
     to a CPU run's, its PLY readable, grasp_tf's pose the service's best;
 17. ddp_train (after phase 8): data-parallel training on the one card: a
     one-rank NCCL group's Trainer.step bitwise the plain step (K7 1); two
     gloo ranks (NCCL takes one rank a card), one scene each of the B=2
     batch, their loss and summed gradients against the single-process
     B=2 probe within the train-correctness bounds, K7 0 and K6 1 on each
     rank; scripts/multiproc_check.py --device cuda --backend gloo ok;
 18. crop_routes: a two-layer crop MLP (3, 16, 32): a B=1 forward through
     K6 and the generic MLP (no K5) equal to the CPU's, and a B=2 training
     probe through K6 and the generic MLP (no K7) within the bounds;
 19. tolerance: data/tolerance.py on a synthetic object of 2048 label
     points x 300*12*4 cells bitwise the CPU's, ms per object, and the CLI
     over a two-object root;
 20. parallel_infer (after phase 16): GraspPipeline(mesh=) on meshes that
     repeat cuda:0 (data 2 at B=4, candidate 4 at B=1, hybrid 2 x 2 at
     B=2): top-50 equal to the unsharded pipeline's within PARALLEL_ATOL,
     K1, K3 and K4 once a scene group, K5 once a seed block; ms per frame
     beside the unsharded pipeline's (the code path on one card, not
     scaling); the service with candidate_devices=2 against one device;
 21. the kernels line (launches per serving forward, per training step,
     per tool run, per eval batch, per feature-input forward, per service
     dispatch, per crop-routes forward and probe, per parallel_infer run,
     per one-rank NCCL step, per rank's step of the two-rank run, per
     rank's step of the 2 x 2 hybrid run, per MSG forward and per
     verify_checkpoint run), printed after phase 24, the nvidia-smi line,
     and last {"ok": true, "device": {...}};
 22. hybrid_train (after phase 17): hybrid data x candidate training on
     the one card: gloo ranks laid out 2 x 2 and 1 x 2 at GraspNetConfig()
     on the B=2 batch, stage 2 on seed blocks of 512; the probe's loss and
     summed gradients against the single-process B=2 probe within the
     train-correctness bounds, every rank's weights and BN buffers bitwise
     equal after a step, each rank's step launching K4 4, K6 1, the
     scatter-add 5 and no K7; on every rank, outside the counted runs, K6
     bitwise its plain version and the scatter-add bitwise the CPU's sum on
     the calls of one more probe (its seed block's shapes);
 23. msg: the MSG modules (models/msg.py) at the PointNet++ classification
     model's SA1 widths (npoint 512, radii 0.1/0.2/0.4, nsample
     16/32/128) and an LFP stage over it, on the B=2 tabletop clouds: FPS
     and K4 indices equal to their plain versions, the forward equal to the
     CPU's, launches FPS 1 and K4 5 a forward;
 24. verify_checkpoint: scripts/verify_checkpoint.py on a fabricated
     reference-layout .tar and a synthetic frame: PASS on the card against
     the CPU's rows, exit 1 on a golden with one row perturbed.

Without CUDA it exits with code 2 before printing any result.  The
deterministic-mode child runs this file with `--deterministic-steps FILE`;
ddp_train's two ranks (hybrid_rank laid out 2 x 1) and hybrid_train's
ranks are spawned processes (torch.multiprocessing).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

DATA_SEED = 0
# Random weights make the objectness logits nearly the same sign for every
# seed point, so a weight seed yields all grasps valid or none; seed 1 gives
# all valid, so NMS and the top-50 have the full 1024 candidates to work on.
WEIGHT_SEED = 1
N_POINTS = 20000
B_KERNELS = 2
FEATURE_TOL = 1e-4  # max |kernel - plain| / max(1, max |plain|): f32 sums in another order
# slope windows of the tools phase: short, so the phase takes tens of seconds
TOOL_K_LO, TOOL_K_HI = 2, 6
TOPK_ATOL = 1e-4  # CPU vs card top-50 floats: CPU BLAS vs cuBLAS f32 sums
PEAK_F32_FLOPS = 67e12  # H100 SXM, non-tensor f32 (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
TEST_FLOPS = {"ball": 8, "cylinder": 21}  # flops per point-center membership test
# K7 pooled x max(1, scale) and stats (tests/test_mlp_train.py's bounds)
MLP_POOLED_TOL, MLP_STATS_TOL = 2e-5, 1e-5
# K7 gradients, max |error| / max(1, max |g|) per leaf, at the training
# shape.  Measured on an H100 (700 W) on this script's inputs:
# - the plain float32 version is 7.7e-3 from a float64 evaluation, with or
#   without pool near-ties: its float32 sums over 524,288 rows cancel;
# - the kernel is 1.7e-3 from float64: 2 M pool maxima over 64 samples
#   include near-ties that another rounding of z3 breaks the other way,
#   routing a group's gradient to another row (layer 3's leaves);
# - with the cotangent zeroed where a maximum is ambiguous (POOL_MARGIN),
#   the kernel is 4.2e-4 from float64 (layers 1-2: its own float32 sums);
# - with one distinct row per group beside 63 equal ones, the kernel is
#   1.2e-5 from the plain version (tests/test_mlp_train.py's bound, 2e-4).
# Each bound leaves 3-6x room over its reading.
MLP_GRAD_TOL, MLP_GRAD_UNAMBIGUOUS_TOL, MLP_GRAD_F64_TOL, MLP_GRAD_PLAIN_TOL = 2e-4, 2e-3, 1e-2, 3e-2
# A pool maximum counts as unambiguous when, in a float64 evaluation, it
# beats every row of another value and clears the relu kink by this much
# x max(1, max |y|): about 100x the float32 rounding of the normalized z3.
POOL_MARGIN = 1e-4
# Card vs CPU step gradients (float32 batch-stat sums in another order, and
# the crop's pool near-ties): per leaf x max(1, max |g|) (7.3e-3 measured),
# relative L2 over all leaves (3.7e-3 measured) and per leaf (4.5e-3
# measured) over the leaves that carry at least LEAF_NORM_FLOOR of the
# gradient's norm: not the BN buffers (no gradient) nor the biases before a
# batch-stat BN (float noise only, ~1e-9 of the norm at GraspNetConfig.tiny()).
GRAD_TOL, GRAD_REL_L2_TOL, LEAF_REL_L2_TOL, LEAF_NORM_FLOOR = 3e-2, 2e-2, 2e-2, 1e-5
STEP_LOSS_RTOL = 1e-5  # card vs CPU loss: batch-stat BN sums in another order
TRAIN_SEED = 0
# train_cli: the scatter-add kernel against a float64 sum, x max(1, scale)
SCATTER_F64_TOL = 1e-6
# train_cli: the CLI loop's timed steps, the steps before them, loader threads
CLI_STEPS, CLI_WARMUP, CLI_WORKERS = 10, 2, 4
# train_cli: the deterministic-mode child, its cuBLAS workspace and time limit
DETERMINISTIC_ENV, DETERMINISTIC_TIMEOUT_S = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}, 600
# collision / test_app: raw cloud size, and apps/test.py's filter settings
RAW_CLOUD_POINTS = 250_000
COLLISION_VOXEL, COLLISION_APPROACH, COLLISION_THRESH = 0.01, 0.05, 0.01
TEST_APP_FRAMES = 200  # frames of the eval loop a batch size, as scripts/bench_test_app.py
GATE_STEPS, GATE_BAR = 600, 6.0  # the learnability gate, as tests/test_learnability.py runs it
# service / service_success: requests a mode and concurrent clients (scripts/bench_service.py's 16)
SERVICE_REQUESTS, SERVICE_CLIENTS = 96, 16
DEMO_FRAME = (240, 320)  # the demos' synthetic RGB-D frame, pixels (height, width)
TOL_LABEL_POINTS = 2048  # tolerance: label points of the synthetic object
# parallel_infer: sharded vs unsharded top-50 floats on the one card (the
# JAX package's sharded-inference bound, tests/test_parallel.py:42), and
# timed calls a mesh
PARALLEL_ATOL, PARALLEL_REPS = 1e-5, 5
MULTIPROC_TIMEOUT_S = 600  # ddp_train: scripts/multiproc_check.py on the card
VERIFY_TIMEOUT_S = 300  # verify_checkpoint: the script's child process on the card
# verify_checkpoint's frame: with WEIGHT_SEED's weights its top 51 pre-NMS
# scores lie at least 1.8e-5 apart on the CPU (rows sorted by a score that
# another rounding moves by ~1e-7 keep their order); frame seeds 0 and 2
# hold pairs 2.9e-7 and 1.9e-6 apart, near enough to swap two rows
VERIFY_FRAME_SEED = 1


def log(**kv) -> None:
    print(json.dumps(kv), flush=True)


def ptxas_records(source: str, out: str) -> list:
    """nvcc -Xptxas -v output -> one record per kernel: its name (template
    arguments as <...>), registers, spill bytes and static shared memory;
    for the tensor-core MLPs and the ring scans also the dynamic shared
    memory they take at GraspNetConfig()'s shapes."""
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.ops.cuda import crop as kcrop
    from graspnet_tpu_torch.ops.cuda import query as kquery

    records, current = [], None
    for line in out.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            name = mangled
            # length-prefixed identifiers; a prefix may follow hex digits of a hash
            lengths = [(m.end(), int(m.group()[i:])) for m in re.finditer(r"\d+", mangled)
                       for i in range(len(m.group()))]
            for end, n in lengths:
                word = mangled[end: end + n]
                if word.endswith("kernel") and re.fullmatch(r"[A-Za-z_]\w*", word):
                    args = re.match(r"I((?:Li\d+E)+)E", mangled[end + n:])
                    values = re.findall(r"Li(\d+)E", args.group(1)) if args else []
                    name = word + (f"<{', '.join(values)}>" if values else "")
                    break
            current = {"source": source, "kernel": name}
            records.append(current)
        elif current is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill:
                current["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
            used = re.search(r"Used (\d+) registers", line)
            if used:
                current["registers"] = int(used.group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                current["static_smem_bytes"] = int(smem.group(1)) if smem else 0
                if current["kernel"].startswith("crop_mlp_tc_kernel"):
                    current["dynamic_smem_bytes"] = kcrop.cylinder_smem_bytes(*GraspNetConfig().crop_mlp[1:])
                elif current["kernel"].startswith("sa1_mlp_tc_kernel"):
                    current["dynamic_smem_bytes"] = kcrop.cylinder_smem_bytes(*GraspNetConfig().sa1.mlp[1:])
                elif current["kernel"].startswith("sa_feat_tc_kernel"):
                    # at SA2's widths and at SA3's (SA4's are SA3's)
                    cfg = GraspNetConfig()
                    current["dynamic_smem_bytes"] = {
                        name: kcrop.sa_feat_smem_bytes(sa.mlp[0] - 3, *sa.mlp[1:])
                        for name, sa in (("sa2", cfg.sa2), ("sa3", cfg.sa3))}
                elif current["kernel"] == "ball_scan_kernel" or current["kernel"].startswith("cylinder_scan_kernel"):
                    # the full ring (N >= 4 stages of points)
                    current["dynamic_smem_bytes"] = kquery.BALL_SCAN_STAGES * (3 * kquery.BALL_SCAN_TILE + 4) * 4
    return records


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median of `reps` CUDA-event timings of fn(), in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float = 0.0, mlp_flops: float = 0.0):
    """The least time of a kernel's work in ms, and what bounds it: the
    larger of its bytes over the memory rate and its operations, each type
    over its own peak.  Scans and membership tests (`flops`) run at the f32
    CUDA-core peak; MLP products (`mlp_flops`) at the least time f32
    accuracy allows, 3xTF32 on the tensor cores (3 x flops / 495 TFLOP/s,
    below flops / 67 TFLOP/s)."""
    t_ops = (flops / PEAK_F32_FLOPS + 3 * mlp_flops / PEAK_TF32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def feature_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want|, raising past FEATURE_TOL x max(1, max |want|)."""
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    if not torch.isfinite(got).all() or err > FEATURE_TOL * scale:
        raise AssertionError(f"features differ: max abs {err} at scale {scale}")
    return err


def mlp_flops(folded, nrows: int) -> int:
    return nrows * sum(2 * w.shape[0] * w.shape[1] for w, _ in folded)


def weight_bytes(folded) -> int:
    return sum((w.numel() + bb.numel()) * 4 for w, bb in folded)


def approach_rotations(cfg, seeds: torch.Tensor) -> torch.Tensor:
    """(B, M, 3) -> (B, M, 3, 3): the rotations of random approach views."""
    from graspnet_tpu_torch.models import geometry

    gen = torch.Generator().manual_seed(DATA_SEED)
    dev = seeds.device
    views = geometry.generate_grasp_views(cfg.num_view, dev)
    pick = torch.randint(0, cfg.num_view, seeds.shape[:2], generator=gen).to(dev)
    return geometry.batch_viewpoint_params_to_matrix(-views[pick], torch.zeros(seeds.shape[:2], device=dev))


def cylinder_scan_blocks(call: str, nth: torch.Tensor, n: int) -> dict:
    """scan_blocks for the cylinder scan at one call's shape."""
    from graspnet_tpu_torch.ops.cuda import query as kquery
    from graspnet_tpu_torch.utils.scan_stats import scan_blocks

    return dict(call=call, b=nth.shape[0], m=nth.shape[1], n=n, centers_per_block=kquery.CYLINDER_SCAN_CENTERS,
                **scan_blocks(nth, n, kquery.CYLINDER_SCAN_CENTERS))


def fps_stage_phase(cloud_b, npoints, want0):
    """K1 stage by stage: the chain cut after 1-4 stages (B=2 and B=1), each
    stage's share and its microseconds per argmax step, and stage 0 on
    clusters of 1, 2, 4, 8 and 16 CTAs per scene (indices equal plain's)."""
    from graspnet_tpu_torch.ops.cuda import fps as kfps

    chain = [cuda_ms(lambda k=k: kfps.fps_chain(cloud_b, npoints[:k]), 10) for k in range(1, len(npoints) + 1)]
    chain_b1 = [cuda_ms(lambda k=k: kfps.fps_chain(cloud_b[:1], npoints[:k]), 10) for k in range(1, len(npoints) + 1)]
    stage = [chain[0]] + [b - a for a, b in zip(chain, chain[1:])]
    steps = [p - 1 for p in npoints]
    sweep = {}
    for c in kfps.CLUSTER_SIZES:
        if not torch.equal(kfps.fps_chain(cloud_b, npoints[:1], c)[0], want0):
            raise AssertionError(f"fps_chain stage 0 on {c}-CTA clusters differs from plain")
        sweep[str(c)] = cuda_ms(lambda c=c: kfps.fps_chain(cloud_b, npoints[:1], c), 10)
    # K2 (fps_pallas): one stage, N_POINTS -> npoints[0], as K1's stage 0
    b = cloud_b.shape[0]
    stage0_bound, stage0_by = bound(cloud_b.numel() * 4 + b * npoints[0] * 8, b * steps[0] * N_POINTS * 9)
    log(phase="fps_stages", b=b, npoints=list(npoints), chain_ms_by_stage_count=chain,
        chain_ms_by_stage_count_b1=chain_b1, stage_ms=stage,
        us_per_step=[1e3 * t / max(n, 1) for t, n in zip(stage, steps)],
        stage0_ms_by_cluster_size=sweep, stage0_equals_plain_for_every_cluster_size=True,
        stage0_plain_ms=cuda_ms(lambda: kfps.fps_chain_plain(cloud_b, npoints[:1]), 2),
        stage0_bound_ms=stage0_bound, stage0_bound_by=stage0_by)


def kernel_phase(cfg, model, cloud_b):
    """Phase 2: every kernel against its plain version at main-path shapes."""
    from graspnet_tpu_torch.nn.layers import fold_bn_eval
    from graspnet_tpu_torch.ops.cuda import crop as kcrop
    from graspnet_tpu_torch.ops.cuda import fps as kfps
    from graspnet_tpu_torch.ops.cuda import query as kquery
    from graspnet_tpu_torch.utils.scan_stats import ball_nth_hits, cylinder_nth_hits, scan_blocks

    rows = []

    # -- FPS chain (K1 + K2) --
    npoints = (cfg.sa1.npoint, cfg.sa2.npoint, cfg.sa3.npoint, cfg.sa4.npoint)
    got = kfps.fps_chain(cloud_b, npoints)
    want = kfps.fps_chain_plain(cloud_b, npoints)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"fps_chain indices differ at {(g != w).nonzero()[:5].tolist()}")
    b = cloud_b.shape[0]
    flops, n = 0, N_POINTS
    for p in npoints:
        flops += b * (p - 1) * n * 9
        n = p
    t_bound, by = bound(cloud_b.numel() * 4 + b * sum(npoints) * 8, flops)
    rows.append(dict(
        name="fps_chain", route="cuda", source="graspnet_tpu_torch/csrc/fps.cu",
        replaces="graspnet_tpu/ops/pallas/fps.py:242 (fps_chain_pallas) + fps.py:161 (fps_pallas)",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: kfps.fps_chain(cloud_b, npoints), 10),
        plain_ms=cuda_ms(lambda: kfps.fps_chain_plain(cloud_b, npoints), 2),
        bound_ms=t_bound, bound_by=by, library_ms=None,
    ))
    fps_stage_phase(cloud_b, npoints, want[0])

    # stage point sets of the main path
    xyz = [cloud_b]
    for idx in got:
        xyz.append(torch.gather(xyz[-1], 1, idx[..., None].expand(-1, -1, 3)))

    # -- ball query (K4): the SA1-4 calls of a training step (as
    # Trainer.prepare makes them), of which SA2-4 are a serving forward's --
    calls = [(xyz[k], xyz[k + 1], sa.radius, sa.nsample)
             for k, sa in enumerate((cfg.sa1, cfg.sa2, cfg.sa3, cfg.sa4))]
    shapes = []
    for name, args in zip(("sa1", "sa2", "sa3", "sa4"), calls):
        g, w = kquery.ball_query(*args), kquery.ball_query_plain(*args)
        if not torch.equal(g, w):
            raise AssertionError(f"ball_query indices differ for {name} at {(g != w).nonzero()[:5].tolist()}")
        nth = ball_nth_hits(*args)
        work = ((args[0].numel() + args[1].numel()) * 4 + w.numel() * 8, nth.sum().item() * TEST_FLOPS["ball"])
        t_bound, by = bound(*work)
        shapes.append(dict(call=name, b=args[0].shape[0], n=args[0].shape[1], m=args[1].shape[1],
                           radius=args[2], ns=args[3], ms=cuda_ms(lambda a=args: kquery.ball_query(*a), 20),
                           plain_ms=cuda_ms(lambda a=args: kquery.ball_query_plain(*a), 5),
                           bound_ms=t_bound, bound_by=by, bytes=work[0], flops=work[1],
                           **scan_blocks(nth, args[0].shape[1], kquery.BALL_SCAN_CENTERS)))
    sa1_nth_flops = shapes[0]["flops"]

    def total(sel):
        """ms, plain ms and the bound of a set of calls, taken together."""
        t_bound, by = bound(sum(c["bytes"] for c in sel), sum(c["flops"] for c in sel))
        return dict(ms=sum(c["ms"] for c in sel), plain_ms=sum(c["plain_ms"] for c in sel),
                    bound_ms=t_bound, bound_by=by)

    # a serving forward makes the SA2-4 calls, a training step all four
    split = {"serving_calls": total(shapes[1:]), "train_step_calls": total(shapes)}
    log(phase="ball_query_shapes", calls=shapes, **split)
    rows.append(dict(
        name="ball_query", route="cuda", source="graspnet_tpu_torch/csrc/query.cu",
        replaces="graspnet_tpu/ops/pallas/query.py:554 (ball_query_pallas -> multi_query_batched_pallas)",
        max_abs_err=0.0, **total(shapes[1:] + shapes), library_ms=None,
    ))

    # -- SA1 fused (K3) --
    sa = cfg.sa1
    folded = fold_bn_eval(model.backbone.sa1.mlp)
    centers = xyz[1]
    g = kcrop.sa1_fused(cloud_b, centers, folded, sa.radius, sa.nsample)
    w = kcrop.crop_fused_plain(cloud_b, centers, None, folded, sa.radius, 0.0, (0.0,),
                               sa.nsample, 1.0 / sa.radius, True)[:, :, 0]
    err = feature_err(g, w)
    nrows = centers.shape[0] * centers.shape[1] * sa.nsample
    t_bound, by = bound((cloud_b.numel() + centers.numel() + g.numel()) * 4 + weight_bytes(folded),
                        sa1_nth_flops, mlp_flops(folded, nrows))
    rows.append(dict(
        name="sa1_fused", route="cuda", source="graspnet_tpu_torch/csrc/crop.cu",
        replaces="graspnet_tpu/ops/pallas/crop.py:297 (sa1_fused_pallas -> crop_fused_pallas(ball=True))",
        max_abs_err=err,
        ms=cuda_ms(lambda: kcrop.sa1_fused(cloud_b, centers, folded, sa.radius, sa.nsample), 10),
        plain_ms=cuda_ms(lambda: kcrop.crop_fused_plain(
            cloud_b, centers, None, folded, sa.radius, 0.0, (0.0,), sa.nsample, 1.0 / sa.radius, True), 3),
        bound_ms=t_bound, bound_by=by, library_ms=None,
    ))
    # its two launches: K4's scan at this shape (the SA1 call above) and the
    # tensor-core MLP
    scan_ms = shapes[0]["ms"]
    log(phase="sa1_fused_split", ms=rows[-1]["ms"], scan_ms=scan_ms, scan_share=scan_ms / rows[-1]["ms"],
        mlp_ms=rows[-1]["ms"] - scan_ms, mlp_gflop=mlp_flops(folded, nrows) / 1e9,
        mlp_tflop_per_s=mlp_flops(folded, nrows) / (rows[-1]["ms"] - scan_ms) / 1e9)

    # -- CloudCrop fused (K5) at the seeds, with approach-view rotations --
    seeds = xyz[2]
    rot = approach_rotations(cfg, seeds)
    folded = fold_bn_eval(model.crop.mlp)
    args = (cloud_b, seeds, rot, folded, cfg.cylinder_radius, cfg.hmin, tuple(cfg.hmax_list), cfg.crop_nsample)
    g = kcrop.crop_fused(*args)
    w = kcrop.crop_fused_plain(*args)
    err = feature_err(g, w)
    nth = cylinder_nth_hits(cfg, cloud_b, seeds, rot)
    tests = nth.sum().item()
    log(phase="cylinder_scan_blocks", shapes=[cylinder_scan_blocks("crop_fused_b2", nth, N_POINTS),
                                              cylinder_scan_blocks("crop_fused_b1", nth[:1], N_POINTS)])
    nrows = seeds.shape[0] * seeds.shape[1] * len(cfg.hmax_list) * cfg.crop_nsample
    t_bound, by = bound((cloud_b.numel() + seeds.numel() + rot.numel() + g.numel()) * 4
                        + weight_bytes(folded), tests * TEST_FLOPS["cylinder"], mlp_flops(folded, nrows))
    rows.append(dict(
        name="crop_fused", route="cuda", source="graspnet_tpu_torch/csrc/crop.cu",
        replaces="graspnet_tpu/ops/pallas/crop.py:297 (crop_fused_pallas)",
        max_abs_err=err,
        ms=cuda_ms(lambda: kcrop.crop_fused(*args), 10),
        plain_ms=cuda_ms(lambda: kcrop.crop_fused_plain(*args), 3),
        bound_ms=t_bound, bound_by=by, library_ms=None,
    ))
    # its two launches: the cylinder scan (the crop group's, timed alone
    # here) and the tensor-core MLP; and both at B=1, a serving frame
    scan_ms = cuda_ms(lambda: kcrop.crop_group(cloud_b, seeds, rot, *args[4:]), 10)
    b1 = (cloud_b[:1], seeds[:1], rot[:1])
    log(phase="crop_fused_split", ms=rows[-1]["ms"], scan_ms=scan_ms, scan_share=scan_ms / rows[-1]["ms"],
        mlp_gflop=mlp_flops(folded, nrows) / 1e9,
        mlp_tflop_per_s=mlp_flops(folded, nrows) / (rows[-1]["ms"] - scan_ms) / 1e9,
        b1_ms=cuda_ms(lambda: kcrop.crop_fused(*b1, *args[3:]), 10),
        b1_scan_ms=cuda_ms(lambda: kcrop.crop_group(*b1, *args[4:]), 10))
    for r in rows:
        log(phase="kernel", **r)
    return rows


def query_sa_kernel_phase(cfg, model, cloud_b):
    """Phase 7: K8, K10 and K9 against their plain versions at production
    shapes, B=2, on the tabletop clouds and the model's own SA features."""
    from graspnet_tpu_torch.nn.layers import fold_bn_eval
    from graspnet_tpu_torch.ops.cuda import crop as kcrop
    from graspnet_tpu_torch.ops.cuda import fps as kfps
    from graspnet_tpu_torch.ops.cuda import query as kquery
    from graspnet_tpu_torch.ops.query import ball_mask
    from graspnet_tpu_torch.utils.scan_stats import ball_nth_hits, cylinder_nth_hits, nth_hit_tests

    bb = model.backbone
    npoints = (cfg.sa1.npoint, cfg.sa2.npoint, cfg.sa3.npoint, cfg.sa4.npoint)
    inds = kfps.fps_chain(cloud_b, npoints)
    xyz = [cloud_b]
    for idx in inds:
        xyz.append(torch.gather(xyz[-1], 1, idx[..., None].expand(-1, -1, 3)))
    rows = []

    # -- K8 multi-depth cylinder query and the K10 oracle in rotate mode --
    seeds = xyz[2]
    rot = approach_rotations(cfg, seeds).contiguous()
    args = (cloud_b, seeds, rot, cfg.cylinder_radius, cfg.hmin, tuple(cfg.hmax_list), cfg.crop_nsample)
    got8 = kquery.cylinder_query_multi(*args)
    got10 = kquery.multi_query(*args)
    want = kquery.cylinder_query_multi_plain(*args)
    for name, got in (("cylinder_query_multi", got8), ("multi_query(rotate=True)", got10)):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} indices differ at {(got != want).nonzero()[:5].tolist()}")
    t_bound, by = bound((cloud_b.numel() + seeds.numel() + rot.numel()) * 4 + want.numel() * 8,
                        cylinder_nth_hits(cfg, cloud_b, seeds, rot).sum().item() * TEST_FLOPS["cylinder"])
    rows.append(dict(
        name="cylinder_query_multi", route="cuda", source="graspnet_tpu_torch/csrc/query.cu",
        replaces="graspnet_tpu/ops/pallas/query.py:554 (cylinder_query_multi_pallas -> "
                 "multi_query_batched_pallas(rotate=True))",
        max_abs_err=0.0, ms=cuda_ms(lambda: kquery.cylinder_query_multi(*args), 20),
        plain_ms=cuda_ms(lambda: kquery.cylinder_query_multi_plain(*args), 3),
        bound_ms=t_bound, bound_by=by, library_ms=None,
    ))
    oracle = dict(
        name="multi_query", route="cuda", source="graspnet_tpu_torch/csrc/query.cu",
        replaces="graspnet_tpu/ops/pallas/query.py:415 (multi_query_pallas)",
        max_abs_err=0.0, ms=cuda_ms(lambda: kquery.multi_query(*args), 10),
        plain_ms=cuda_ms(lambda: kquery.multi_query_plain(*args), 3),
        bound_ms=t_bound, bound_by=by, library_ms=None,
    )

    # -- K10 in ball mode == K4 == plain at the SA1-4 calls --
    calls = [(xyz[k], xyz[k + 1], sa.radius, sa.nsample)
             for k, sa in enumerate((cfg.sa1, cfg.sa2, cfg.sa3, cfg.sa4))]
    ball_tests = 0
    for x, c, r, ns in calls:
        k4 = kquery.ball_query(x, c, r, ns)
        k10 = kquery.multi_query(x, c, None, r, 0.0, (0.0,), ns, rotate=False)[:, :, 0]
        if not (torch.equal(k10, k4) and torch.equal(k4, kquery.ball_query_plain(x, c, r, ns))):
            raise AssertionError(f"multi_query(rotate=False) differs from ball_query for r={r}")
        ball_tests += ball_nth_hits(x, c, r, ns).sum().item()

    # -- K9 fused SA2-4 on the model's stage points and SA1-3 features --
    feats = [kcrop.sa1_fused(cloud_b, xyz[1], fold_bn_eval(bb.sa1.mlp), cfg.sa1.radius, cfg.sa1.nsample)]
    sa_calls = []
    for k, (name, sa) in enumerate((("sa2", cfg.sa2), ("sa3", cfg.sa3), ("sa4", cfg.sa4)), start=1):
        stage = getattr(bb, name)
        sa_calls.append((xyz[k], xyz[k + 1], feats[-1], fold_bn_eval(stage.mlp), sa.radius, sa.nsample))
        feats.append(stage(xyz[k], feats[-1], inds[k])[1])  # the backbone's own path (K4 + gather)
    err = backbone_err = 0.0
    flops = nbytes = mlp = 0
    for call, backbone_out in zip(sa_calls, feats[1:]):
        got, want = kcrop.sa_feat_fused(*call), kcrop.sa_feat_fused_plain(*call)
        err = max(err, feature_err(got, want))
        backbone_err = max(backbone_err, feature_err(got, backbone_out))  # / r there, x (1/r) here
        x, c, f, folded, r, ns = call
        flops += nth_hit_tests(ball_mask(x, c, r), ns).sum().item() * TEST_FLOPS["ball"]
        mlp += mlp_flops(folded, c.shape[0] * c.shape[1] * ns)
        nbytes += (x.numel() + c.numel() + f.numel() + got.numel()) * 4 + weight_bytes(folded)
    t_bound, by = bound(nbytes, flops, mlp)
    rows.append(dict(
        name="sa_feat_fused", route="cuda", source="graspnet_tpu_torch/csrc/crop.cu",
        replaces="graspnet_tpu/ops/pallas/crop.py:547 (sa_feat_fused_pallas -> _sa_feat_fused)",
        max_abs_err=err, ms=sum(cuda_ms(lambda a=a: kcrop.sa_feat_fused(*a), 20) for a in sa_calls),
        plain_ms=sum(cuda_ms(lambda a=a: kcrop.sa_feat_fused_plain(*a), 5) for a in sa_calls),
        bound_ms=t_bound, bound_by=by, library_ms=None,
    ))
    # K9's two launches: K4's scans at the three calls (timed alone), then
    # the MLP; and the device time of K9's and K10's kernels by name
    k9 = rows[-1]
    scan_ms = sum(cuda_ms(lambda a=a: kquery.ball_query(*a[:2], *a[4:]), 20) for a in sa_calls)
    by_name, window = profiled("profile_query_sa",
                               lambda i=0: ([kcrop.sa_feat_fused(*a) for a in sa_calls], kquery.multi_query(*args)),
                               5, "call", {"k9": ("ball_scan_kernel", "sa_feat_tc_kernel"), "k10": ("seed_query_kernel",)})
    # K9's three calls launch K4's scan and the MLP once each, and nothing else
    parts = ("ball_scan_kernel", "sa_feat_tc_kernel", "seed_query_kernel")
    per_call = {p: sum(c for _, k, c in window if p in k) for p in parts}
    others = [k for _, k, _ in window if not any(p in k for p in parts)]
    if window and (others or per_call != {"ball_scan_kernel": 3, "sa_feat_tc_kernel": 3, "seed_query_kernel": 1}):
        raise AssertionError(f"K9 + K10 window: launches per call {per_call}, other kernels {others}")
    k9_dev = by_name["k9_ms_per_call_by_kernel"]
    dev_scan = sum(v for k, v in k9_dev.items() if "ball_scan_kernel" in k)
    dev_mlp = sum(v for k, v in k9_dev.items() if "sa_feat_tc_kernel" in k)
    log(phase="sa_feat_split", ms=k9["ms"], scan_ms=scan_ms, scan_share=scan_ms / k9["ms"], mlp_ms=k9["ms"] - scan_ms,
        device_ms=dev_scan + dev_mlp, device_scan_ms=dev_scan, device_mlp_ms=dev_mlp, mlp_gflop=mlp / 1e9,
        mlp_tflop_per_s=mlp / dev_mlp / 1e9 if dev_mlp else "not measured",
        k10_device_ms=sum(by_name["k10_ms_per_call_by_kernel"].values()) or "not measured",
        k9_k10_launches_per_call=per_call if window else "not measured")
    rows.append(oracle)
    log(phase="query_sa_kernels_checked", k8_equals_plain=True, k10_equals_plain_and_k8=True,
        k10_ball_equals_k4_at_sa1_4=True, k4_tests_sa1_4=ball_tests,
        sa_feat_max_abs_err=err, sa_feat_vs_backbone_path_max_abs_err=backbone_err,
        feature_tol=FEATURE_TOL)
    for r in rows:
        log(phase="kernel", **r)
    return rows


def tools_phase():
    """Phase 8: the four timing entry points in-process at GraspNetConfig(),
    with short slope windows.  Returns the launch counts of one run of all
    four and their records."""
    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.scripts import bench, bench_crop_kernels, crop_train_breakdown, profile_stages
    from graspnet_tpu_torch.utils import timing

    windows = ["--k-lo", str(TOOL_K_LO), "--k-hi", str(TOOL_K_HI)]
    per_tool, records = {}, {}
    for name, run in (
        ("bench_crop_kernels", lambda: bench_crop_kernels.main(windows)),
        ("profile_stages", lambda: profile_stages.main(windows)),
        ("crop_train_breakdown", lambda: crop_train_breakdown.main(windows)),
        ("bench", lambda: bench.main(["--frames", "10", "--repeats", "2", "--sync-frames", "5"])),
    ):
        kernels.reset_launches()
        t0 = time.perf_counter()
        records[name] = run()
        torch.cuda.synchronize()
        per_tool[name] = kernels.launches()
        records[name + "_s"] = time.perf_counter() - t0
    for name in ("bench_crop_kernels", "profile_stages", "crop_train_breakdown"):
        bad = {k: v for k, v in records[name].items() if not (np.isfinite(v) and v > 0)}
        if bad:
            raise AssertionError(f"{name}: stage times not finite and > 0: {bad}")
    if records["bench"]["backend"] != "cuda" or not records["bench"]["value"] > 0:
        raise AssertionError(f"bench: {records['bench']}")
    calls = timing.calls_per_stage()  # fn calls per timed stage
    checks = {
        "profile_stages launches cylinder_query_multi": per_tool["profile_stages"]["cylinder_query_multi"] > 0,
        "crop_train_breakdown launches cylinder_query_multi":
            per_tool["crop_train_breakdown"]["cylinder_query_multi"] > 0,
        "bench_crop_kernels launches sa_feat_fused 3x per stage call":
            per_tool["bench_crop_kernels"]["sa_feat_fused"] == 3 * calls,
        "profile_stages launches multi_query": per_tool["profile_stages"]["multi_query"] > 0,
    }
    total = {k: sum(t[k] for t in per_tool.values()) for k in kernels.launches()}
    log(phase="tools", launches_per_tool=per_tool, calls_per_stage=calls, checks=checks,
        **{k: v for k, v in records.items()})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"tool launch counts: {failed}")
    return total, records


def compare_topk(card: np.ndarray, cpu: np.ndarray, atol: float = TOPK_ATOL) -> dict:
    """Selection fields equal (row order, height, depth, centre, object id);
    score, width and rotation within `atol`."""
    if card.shape != cpu.shape:
        raise AssertionError(f"top-K row counts differ: card {card.shape} cpu {cpu.shape}")
    sel = [2, 3, 13, 14, 15, 16]
    if not np.array_equal(card[:, sel], cpu[:, sel]):
        bad = np.nonzero((card[:, sel] != cpu[:, sel]).any(1))[0]
        raise AssertionError(f"top-K selections differ from row {bad[0]}: card {card[bad[0]]} cpu {cpu[bad[0]]}")
    err = float(np.abs(card - cpu).max()) if card.size else 0.0
    if err > atol:
        raise AssertionError(f"top-K floats differ by {err}")
    return {"rows": int(card.shape[0]), "max_abs_err": err}


def main_path_phase(cfg, pipe, clouds):
    """Phase 3: the serving path through the pipeline's entry points."""
    from graspnet_tpu_torch.apps import GraspPipeline
    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.postproc.nms import nms_keep_mask

    expected = {"fps_chain": 1, "ball_query": 3, "sa1_fused": 1, "crop_fused": 1,
                "crop_group": 0, "crop_mlp_train": 0, "crop_mlp_train_backward": 0,
                "cylinder_query_multi": 0, "sa_feat_fused": 0, "multi_query": 0,
                "scatter_add_rows": 0, "scatter_plan": 0}

    def drive(fn):
        """Run one batched forward; every kernel must launch once for it."""
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = kernels.launches()
        if got != expected:
            raise AssertionError(f"launch counts {got}, expected {expected}")
        return out, got

    def check_rows(gg, name):
        a = gg.grasp_group_array
        if a.shape != (50, 17) or not np.isfinite(a).all():
            raise AssertionError(f"{name}: rows {a.shape}, finite={np.isfinite(a).all()}")

    t0 = time.perf_counter()
    pipe.warmup()
    warm_s = time.perf_counter() - t0
    gg1, launches = drive(lambda: pipe.get_grasps_topk(clouds[0]))
    check_rows(gg1, "get_grasps_topk B=1")
    ggs, _ = drive(lambda: pipe.get_grasps_topk_batch(clouds))
    for gg in ggs:
        check_rows(gg, "get_grasps_topk_batch B=4")
    dec, _ = drive(lambda: pipe.get_grasps_batch(clouds))
    for gg in dec:
        if len(gg) == 0 or not np.isfinite(gg.grasp_group_array).all():
            raise AssertionError("get_grasps_batch B=4 gave no or non-finite rows")
    log(phase="main_path_counts", launches_per_forward=launches, warmup_s=warm_s,
        b1_rows=list(gg1.grasp_group_array.shape), b4_decode_rows=[len(g) for g in dec])

    cpu = GraspPipeline(cfg=cfg, seed=WEIGHT_SEED, device="cpu")
    t0 = time.perf_counter()
    cpu_rows = cpu.get_grasps_topk(clouds[0]).grasp_group_array
    cpu_s = time.perf_counter() - t0
    same = compare_topk(gg1.grasp_group_array, cpu_rows)
    log(phase="card_vs_cpu_top50", cpu_forward_s=cpu_s, **same)

    lat = []
    for i in range(20):
        t0 = time.perf_counter()
        pipe.get_grasps_topk(clouds[i % len(clouds)])
        lat.append((time.perf_counter() - t0) * 1e3)
    frames = 30
    t0 = time.perf_counter()
    for i in range(frames):
        pipe.get_grasps_topk(clouds[i % len(clouds)])
    fps_b1 = frames / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(5):
        pipe.get_grasps_topk_batch(clouds)
    fps_b4 = 5 * len(clouds) / (time.perf_counter() - t0)
    timing = dict(p50_ms_b1=statistics.median(lat), frames_per_s_b1=fps_b1,
                  frames_per_s_b4=fps_b4, nms_sweeps=nms_keep_mask.sweeps)
    log(phase="main_path_timing", **timing)
    return launches, timing


def profiled(name: str, fn, reps: int, unit: str, groups=None):
    """Device time per kernel over `reps` calls of fn(i) under
    torch.profiler; the device's busy share is the summed kernel time over
    the wall time of the window.  Logs the top kernels per call (`unit`) and,
    for each of `groups` ({label: kernel-name parts}), the time per call of
    every kernel whose name holds one of the parts."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels.append((dev_us / reps / 1e3, ev.key[:60], ev.count // reps))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    by_group = {f"{label}_ms_per_{unit}_by_kernel": {k: ms for ms, k, _ in kernels if any(p in k for p in parts)}
                for label, parts in (groups or {}).items()}
    log(**{"phase": name, f"{unit}s": reps, f"wall_ms_per_{unit}": wall_ms / reps,
           f"device_busy_ms_per_{unit}": busy if kernels else "not measured",
           "device_idle_share": (1 - busy * reps / wall_ms) if kernels else "not measured",
           "top": [{"kernel": k, "ms": ms, "launches": c} for ms, k, c in kernels[:15]],
           **{k: v for k, v in by_group.items() if v}})
    return by_group, kernels


def profile_phase(pipe, clouds, frames: int = 5):
    """Where a B=1 serving frame spends device time: a few get_grasps_topk
    calls under torch.profiler."""
    profiled("profile_b1", lambda i=0: pipe.get_grasps_topk(clouds[i % len(clouds)]), frames, "frame",
             {"k5": ("cylinder_scan_kernel", "crop_mlp_tc_kernel"),
              # ball_scan_kernel: K3's scan and K4's 3 calls, 4 launches a frame
              "k3_and_k4": ("ball_scan_kernel", "sa1_mlp_tc_kernel")})


def mlp_train_flops(c1: int, c2: int, c3: int):
    """K7 flops per row: ((forward, backward) of the function, (forward,
    backward) as csrc/mlp_train.cu runs them).

    The function: one forward; in the backward the products dW3 = a2^T dz3,
    da2 = dz3 W3^T, dW2, da1 and dW1 (the grouped offsets take a zero
    gradient, so no dx).  The backward's inputs hold no activations, so any
    version also recomputes the forward once: the bound leaves that out and
    errs low.  The kernels run layer 1 three times, layer 2 twice and layer
    3 once in the forward; in the backward, pass B recomputes layers 1-2 for
    each part of <= 128 layer-3 columns and layer 3 once, then forms dW3 and
    da2, and pass C recomputes layer 1 and forms dW2 and da1.  BN and dW1's
    x-moments are a few flops per element and are not counted."""
    l1, l2, l3 = 2 * 3 * c1, 2 * c1 * c2, 2 * c2 * c3
    parts = c3 // min(c3, 128)
    function = (l1 + l2 + l3, 2 * l3 + 2 * l2 + l1)
    executed = (3 * l1 + 2 * l2 + l3, parts * (l1 + l2) + 3 * l3 + l1 + 2 * l2)
    return function, executed


def unambiguous_pool(mlp64, grouped: torch.Tensor) -> torch.Tensor:
    """(B, Ns, D, S, 3) -> (B, Ns, D, C3) bool: in a float64 evaluation the
    pre-relu pool maximum beats every row of another value, and clears the
    relu kink, by POOL_MARGIN x max(1, max |y|).  Rows of equal value (the
    first-hit padding) are exact ties that every version splits evenly."""
    from graspnet_tpu_torch.nn.layers import dense

    with torch.no_grad():
        *hidden, last = mlp64
        h = grouped.double()
        for layer in hidden:
            h, _ = layer.forward_train(h)
        y, _ = last.bn.forward_train(dense(last.kernel, None, h))
        top = y.amax(dim=3, keepdim=True)
        below = torch.where(y < top, y, -torch.inf).amax(dim=3)
        top = top[:, :, :, 0]
        tau = POOL_MARGIN * max(1.0, y.abs().max().item())
        return (top - below >= tau) & (top.abs() >= tau)


def label_points(rng: np.random.Generator, cloud: torch.Tensor, m: int) -> torch.Tensor:
    """(B, N, 3) tabletop -> (B, m, 3) points within a centimetre of its
    objects (everything above the table plane at z = 0.55)."""
    out = []
    for pts in cloud.cpu().numpy():
        obj = pts[pts[:, 2] < 0.54]
        pick = obj[rng.choice(len(obj), m, replace=len(obj) < m)]
        out.append(pick + rng.normal(0, 0.01, pick.shape))
    return torch.from_numpy(np.stack(out).astype(np.float32)).to(cloud.device)


def random_rotations(rng: np.random.Generator, shape, device) -> torch.Tensor:
    q, _ = np.linalg.qr(rng.normal(size=(*shape, 3, 3)))
    return torch.from_numpy(q.astype(np.float32)).to(device)


def train_kernel_phase(cfg, mlp, cloud_b):
    """Phase 5: K6 and K7 (forward, backward) against their plain versions
    at the training shape: 1024 label points near the objects, random
    rotations, the model's crop MLP."""
    from graspnet_tpu_torch.ops.cuda import crop as kcrop
    from graspnet_tpu_torch.ops.cuda import mlp_train as kmlp
    from graspnet_tpu_torch.utils.scan_stats import cylinder_nth_hits

    rng = np.random.default_rng(TRAIN_SEED)
    b, m = cloud_b.shape[0], cfg.num_seed
    centers = label_points(rng, cloud_b, m)
    rot = random_rotations(rng, (b, m), cloud_b.device)
    geom = (cfg.cylinder_radius, cfg.hmin, tuple(cfg.hmax_list), cfg.crop_nsample)
    rows = []

    # -- K6 crop group: equal indices, so bitwise equal offsets --
    grouped = kcrop.crop_group(cloud_b, centers, rot, *geom)
    want = kcrop.crop_group_plain(cloud_b, centers, rot, *geom)
    err = (grouped - want).abs().max().item()
    if not torch.equal(grouped, want):
        raise AssertionError(f"crop_group offsets differ from the plain version by {err}")
    nth = cylinder_nth_hits(cfg, cloud_b, centers, rot)
    log(phase="cylinder_scan_blocks", shapes=[cylinder_scan_blocks("crop_group_train_b2", nth, N_POINTS)])
    t_bound, by = bound((cloud_b.numel() + centers.numel() + rot.numel() + grouped.numel()) * 4,
                        nth.sum().item() * TEST_FLOPS["cylinder"])
    rows.append(dict(
        name="crop_group", route="cuda", source="graspnet_tpu_torch/csrc/query.cu",
        replaces="graspnet_tpu/ops/pallas/crop.py:423 (crop_group_pallas)",
        max_abs_err=err, ms=cuda_ms(lambda: kcrop.crop_group(cloud_b, centers, rot, *geom), 10),
        plain_ms=cuda_ms(lambda: kcrop.crop_group_plain(cloud_b, centers, rot, *geom), 3),
        bound_ms=t_bound, bound_by=by, library_ms=None,
    ))

    # -- K7 train MLP, forward and backward --
    params = [p for layer in mlp for p in (layer.kernel, layer.bn.scale, layer.bn.offset)]
    w = torch.from_numpy(rng.normal(size=(*grouped.shape[:3], cfg.crop_mlp[-1])).astype(np.float32)).to(cloud_b.device)
    mlp64 = copy.deepcopy(mlp).double()

    def run(fn, net, x, cot):
        pooled, stats = fn(net, x)
        ps = [p for layer in net for p in (layer.kernel, layer.bn.scale, layer.bn.offset)]
        return pooled, stats, torch.autograd.grad(torch.sum(pooled * cot.to(pooled.dtype)), ps)

    leaves = [f"{i}.{n}" for i in range(len(mlp)) for n in ("kernel", "scale", "offset")]

    def grad_errs(got, want):
        """max |got - want| / max(1, max |want|) over the parameters, and
        the leaf where it is largest."""
        errs = [(a.double() - c.double()).abs().max().item() / max(1.0, c.abs().max().item())
                for a, c in zip(got, want)]
        worst = max(range(len(errs)), key=errs.__getitem__)
        return errs[worst], leaves[worst]

    # (a) the main path's grouped offsets
    p_k, st_k, g_k = run(kmlp.crop_mlp_train, mlp, grouped, w)
    p_p, st_p, g_p = run(kmlp.crop_mlp_train_plain, mlp, grouped, w)
    _, _, g_again = run(kmlp.crop_mlp_train, mlp, grouped, w)
    _, _, g_64 = run(kmlp.crop_mlp_train_plain, mlp64, grouped.double(), w)
    torch.cuda.synchronize()
    fwd_err = (p_k - p_p).abs().max().item()
    if not torch.isfinite(p_k).all() or fwd_err > MLP_POOLED_TOL * max(1.0, p_p.abs().max().item()):
        raise AssertionError(f"crop_mlp_train pooled differs by {fwd_err}")
    for a, c in zip(st_k, st_p):
        for k in ("mean", "var"):
            torch.testing.assert_close(a[k], c[k], rtol=MLP_STATS_TOL, atol=MLP_STATS_TOL)
    bwd_err = max((a - c).abs().max().item() for a, c in zip(g_k, g_p))
    if not all(torch.equal(a, c) for a, c in zip(g_k, g_again)):
        raise AssertionError("crop_mlp_train backward is not bitwise repeatable")
    # (b) the same inputs with the cotangent zeroed where a pool maximum is
    # ambiguous: no rounding can route the rest to another row, so every
    # distinct row of every group is held to float64
    keep = unambiguous_pool(mlp64, grouped)
    _, _, gu_k = run(kmlp.crop_mlp_train, mlp, grouped, w * keep)
    _, _, gu_p = run(kmlp.crop_mlp_train_plain, mlp, grouped, w * keep)
    _, _, gu_64 = run(kmlp.crop_mlp_train_plain, mlp64, grouped.double(), w * keep)
    # (c) one distinct row per group beside 63 equal ones: every maximum is
    # unambiguous by construction, so the kernel meets the plain version at
    # the bound of tests/test_mlp_train.py
    clean = grouped.clone()
    clean[:, :, :, 1:] = clean[:, :, :, 1:2]
    clean[:, :, :, 0] = torch.from_numpy(rng.uniform(-0.3, 0.3, clean[:, :, :, 0].shape).astype(np.float32)).to(clean.device)
    _, _, gc_k = run(kmlp.crop_mlp_train, mlp, clean, w)
    _, _, gc_p = run(kmlp.crop_mlp_train_plain, mlp, clean, w)
    checks = {  # name: (error x max(1, scale), its leaf, bound)
        "kernel_vs_f64": (*grad_errs(g_k, g_64), MLP_GRAD_F64_TOL),
        "kernel_vs_plain": (*grad_errs(g_k, g_p), MLP_GRAD_PLAIN_TOL),
        "plain_vs_f64": (*grad_errs(g_p, g_64), MLP_GRAD_PLAIN_TOL),
        "unambiguous_kernel_vs_f64": (*grad_errs(gu_k, gu_64), MLP_GRAD_UNAMBIGUOUS_TOL),
        "unambiguous_plain_vs_f64": (*grad_errs(gu_p, gu_64), MLP_GRAD_PLAIN_TOL),
        "one_distinct_row_kernel_vs_plain": (*grad_errs(gc_k, gc_p), MLP_GRAD_TOL),
    }
    del mlp64, g_64, gu_64
    log(phase="train_kernels_checked", crop_group_max_abs_err=err, mlp_fwd_max_abs_err=fwd_err,
        mlp_bwd_max_abs_err=bwd_err, mlp_grad_err_over_scale_leaf_bound=checks,
        unambiguous_share=keep.double().mean().item(), mlp_bwd_bitwise_repeatable=True)
    failed = [k for k, (e, _, tol) in checks.items() if not e <= tol]
    if failed:
        raise AssertionError(f"crop_mlp_train gradients out of bounds: {failed}")

    c1, c2, c3 = cfg.crop_mlp[1:]
    nrows = grouped[..., 0].numel()
    (f_fwd, f_bwd), (x_fwd, x_bwd) = mlp_train_flops(c1, c2, c3)
    wbytes = sum(p.numel() for p in params) * 4
    x = grouped.reshape(-1, grouped.shape[-2], 3).contiguous()
    wts = [layer.kernel.detach().contiguous() for layer in mlp]
    gb = [torch.stack([layer.bn.scale, layer.bn.offset]).detach().contiguous() for layer in mlp]
    st = [torch.stack([s["mean"], s["var"] * (nrows - 1) / nrows]).contiguous() for s in st_k]
    gpool = w.reshape(x.shape[0], -1).contiguous()
    zext = pool_extreme_z3(mlp, x)
    plain_graph = kmlp.crop_mlp_train_plain(mlp, grouped)[0]
    for name, flops, executed, nbytes, fn, plain, at in (
        ("crop_mlp_train", f_fwd * nrows, x_fwd * nrows, (grouped.numel() + p_k.numel()) * 4 + wbytes,
         lambda: kmlp.crop_mlp_train(mlp, grouped),
         lambda: kmlp.crop_mlp_train_plain(mlp, grouped), "mlp_train.py:334 (_mlp_train_fwd_call)"),
        ("crop_mlp_train_backward", f_bwd * nrows, x_bwd * nrows,
         (grouped.numel() + w.numel()) * 4 + 2 * wbytes,
         lambda: kmlp.crop_mlp_train_backward(x, gpool, zext, wts, gb, st, mlp[0].bn.eps),
         lambda: torch.autograd.grad(plain_graph, params, w, retain_graph=True),
         "mlp_train.py:394 (_mlp_train_bwd_call)"),
    ):
        t_bound, by = bound(nbytes, mlp_flops=flops)
        with torch.no_grad() if name == "crop_mlp_train" else torch.enable_grad():
            ms = cuda_ms(fn, 5)
            plain_ms = cuda_ms(plain, 3)
        rows.append(dict(
            name=name, route="cuda", source="graspnet_tpu_torch/csrc/mlp_train.cu",
            replaces=f"graspnet_tpu/ops/pallas/{at} of crop_mlp_train_pallas",
            max_abs_err=fwd_err if name == "crop_mlp_train" else bwd_err, ms=ms, plain_ms=plain_ms,
            bound_ms=t_bound, bound_by=by, library_ms=None, gflop=flops / 1e9,
            gflop_executed=executed / 1e9,
        ))
    del plain_graph
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kmlp.crop_mlp_train_backward(x, gpool, zext, wts, gb, st, mlp[0].bn.eps)
    torch.cuda.synchronize()
    log(phase="k7_backward_memory", extra_peak_bytes=torch.cuda.max_memory_allocated() - base)
    for r in rows:
        log(phase="kernel", **r)
    return rows


def pool_extreme_z3(mlp, x: torch.Tensor) -> torch.Tensor:
    """(G, S, 3) -> (G, C3): the pre-norm z3 pooled as the backward takes it,
    the max over each group, or the min where gamma3 < 0 (plain torch)."""
    from graspnet_tpu_torch.nn.layers import dense

    with torch.no_grad():
        *hidden, last = mlp
        h = x
        for layer in hidden:
            h, _ = layer.forward_train(h)
        z3 = dense(last.kernel, None, h)
        return torch.where(last.bn.scale >= 0, z3.amax(dim=1), z3.amin(dim=1)).contiguous()


def labelled_scene(rng: np.random.Generator, cloud: np.ndarray, cfg, n_obj: int = 8, n_pts: int = 300):
    """One synthetic labelled scene in the manner of scripts/bench_train.py:
    n_obj objects posed at points of the tabletop's objects, n_pts label
    points each, random (V, A, D) scores, widths and tolerances."""
    v, a, d = cfg.num_view, cfg.num_angle, cfg.num_depth
    obj = cloud[cloud[:, 2] < 0.54]
    poses, pts, scores, widths, tols = [], [], [], [], []
    for _ in range(n_obj):
        r = random_rotations(rng, (), "cpu").numpy()
        r[:, 0] *= np.sign(np.linalg.det(r))  # a proper rotation
        poses.append(np.concatenate([r, obj[rng.integers(len(obj))][:, None]], 1).astype(np.float32))
        pts.append(rng.uniform(-0.03, 0.03, (n_pts, 3)).astype(np.float32))
        scores.append(rng.uniform(0, 1.2, (n_pts, v, a, d)).astype(np.float32))
        widths.append(rng.uniform(0, 0.12, (n_pts, v, a, d)).astype(np.float32))
        tols.append(rng.uniform(0, 0.05, (n_pts, v, a, d)).astype(np.float32))
    return poses, pts, scores, widths, tols


def train_batches(cfg, clouds: np.ndarray):
    """Full-label and compact batches of B scenes, and the host label-prep
    time per scene (FPS seed chain + phase A of the compact path)."""
    from graspnet_tpu_torch.train import label_pipeline as lp

    rng = np.random.default_rng(TRAIN_SEED)
    scenes = [labelled_scene(rng, c, cfg) for c in clouds]  # data generation, not timed
    t0 = time.perf_counter()
    chains, ctxs = [], []
    for cloud, scene in zip(clouds, scenes):
        inds, seed_xyz = lp.seed_chain(cloud, cfg)
        chains.append((inds, seed_xyz))
        ctxs.append(lp.prepare_scene_labels(seed_xyz, *scene, cfg))
    prep_ms = (time.perf_counter() - t0) * 1e3 / len(clouds)
    full_labels = [lp.build_scene_labels(c, seeds, *scene, cfg) for c, (_, seeds), scene in zip(clouds, chains, scenes)]
    small = {
        "point_clouds": clouds,
        "objectness_label": (clouds[..., 2] < 0.54).astype(np.int32),
        "sa_inds": {k: np.stack([ch[0][k] for ch in chains]) for k in ("sa1", "sa2", "sa3", "sa4")},
    }
    full = {k: np.stack([f[k] for f in full_labels]) for k in full_labels[0]}
    full.update(small)
    return full, {**small, "label_ctx": ctxs}, prep_ms


def compare_grads(l_got, g_got, l_want, g_want, what: str) -> dict:
    """A step's loss within STEP_LOSS_RTOL and its gradients within the
    train-correctness bounds (PERF.md section 2): per leaf GRAD_TOL x
    max(1, max |g|), LEAF_REL_L2_TOL relative L2 over the leaves that carry
    LEAF_NORM_FLOOR of the norm, GRAD_REL_L2_TOL over all.  Raises past any."""
    if abs(float(l_got) - float(l_want)) > STEP_LOSS_RTOL * abs(float(l_want)):
        raise AssertionError(f"{what}: loss {float(l_got)} vs {float(l_want)}")
    diff = {k: g_got[k].cpu().double() - g.cpu().double() for k, g in g_want.items()}
    ratios = {k: d.abs().max().item() / max(1.0, g_want[k].abs().max().item()) for k, d in diff.items()}
    norms = {k: g.double().norm().item() for k, g in g_want.items()}
    total = sum(v * v for v in norms.values()) ** 0.5
    rel_l2 = sum(d.square().sum().item() for d in diff.values()) ** 0.5 / total
    leaf_rel = {k: diff[k].norm().item() / norms[k] for k in diff if norms[k] >= LEAF_NORM_FLOOR * total}
    worst, worst_rel = max(ratios, key=ratios.get), max(leaf_rel, key=leaf_rel.get)
    found = dict(loss_got=float(l_got), loss_want=float(l_want),
                 worst_grad_err_over_scale=ratios[worst], worst_leaf=worst, grads_rel_l2=rel_l2,
                 worst_leaf_rel_l2=leaf_rel[worst_rel], worst_rel_leaf=worst_rel,
                 leaves_rel_checked=len(leaf_rel), leaves=len(diff),
                 limits=[GRAD_TOL, GRAD_REL_L2_TOL, LEAF_REL_L2_TOL])
    if ratios[worst] > GRAD_TOL or rel_l2 > GRAD_REL_L2_TOL or leaf_rel[worst_rel] > LEAF_REL_L2_TOL:
        raise AssertionError(f"{what}: gradients out of bounds: {found}")
    return found


def train_phase(cfg, clouds: np.ndarray):
    """Phase 6: the port's Trainer through its entry points on the card.
    Returns the launches of a step, the timings, and the full and compact
    host batches."""
    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer

    full, compact, prep_ms = train_batches(cfg, clouds)
    zero = {k: 0 for k in kernels.launches()}

    def counted(fn, expected):
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = kernels.launches()
        if got != {**zero, **expected}:
            raise AssertionError(f"launch counts {got}, expected {expected}")
        return out, got

    # scatter_add_rows: the backward of SA2-4's feature grouping and FP1-2's interpolation;
    # scatter_plan: its plan, made in those gathers' forwards
    step_counts = {"ball_query": 4, "crop_group": 1, "crop_mlp_train": 1, "crop_mlp_train_backward": 1,
                   "scatter_add_rows": 5, "scatter_plan": 5}
    tr = Trainer(cfg, TrainConfig(), seed=TRAIN_SEED)
    tr.set_epoch(0)
    dev_full = tr.put(full)
    torch.cuda.synchronize()
    (loss_step, _), step_launches = counted(lambda: tr.step(dev_full), step_counts)
    twin = Trainer(cfg, TrainConfig(), seed=TRAIN_SEED)
    twin.set_epoch(0)
    handle, prepare_launches = counted(lambda: twin.prepare(compact), {"ball_query": 4})
    (loss_compact, _), prepared_launches = counted(lambda: twin.step_prepared(handle),
                                                   {**step_counts, "ball_query": 0})
    if float(loss_step) != float(loss_compact):
        raise AssertionError(f"step_compact loss {float(loss_compact)} != step loss {float(loss_step)}")
    losses = [float(loss_step)] + [float(tr.step(dev_full)[0]) for _ in range(4)]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss does not fall over 5 steps: {losses}")
    log(phase="train_step_counts", launches_per_step=step_launches, prepare=prepare_launches,
        step_prepared=prepared_launches, losses=losses, step_compact_loss=float(loss_compact))

    # -- one step on the card against the same step on the CPU --
    card = Trainer(cfg, TrainConfig(), seed=TRAIN_SEED)
    cpu = Trainer(cfg, TrainConfig(), seed=TRAIN_SEED, device="cpu")
    tops = [t.prepare(compact)[2].cpu() for t in (card, cpu)]
    if not torch.equal(*tops):
        raise AssertionError(f"pre-pass top views differ at {(tops[0] != tops[1]).nonzero()[:5].tolist()}")
    l_card, g_card = card.grads_compact(compact)
    t0 = time.perf_counter()
    l_cpu, g_cpu = cpu.grads_compact(compact)
    cpu_s = time.perf_counter() - t0
    found = compare_grads(l_card, g_card, l_cpu, g_cpu, "card vs CPU")
    log(phase="train_card_vs_cpu", cpu_grads_s=cpu_s, top_views_equal=True, **found)

    # -- timing --
    step_ms = cuda_ms(lambda: tr.step(dev_full), 5)
    torch.cuda.reset_peak_memory_stats()
    tr.step(dev_full)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    k = 5
    handle = tr.prepare(compact)
    t0 = time.perf_counter()
    for _ in range(k):
        tr.step_prepared(handle)
        handle = tr.prepare(compact)
    torch.cuda.synchronize()
    pipelined_ms = (time.perf_counter() - t0) * 1e3 / k
    timing = dict(train_step_ms=step_ms, pipelined_compact_step_ms=pipelined_ms,
                  host_label_prep_ms_per_scene=prep_ms, peak_memory_bytes=peak)
    log(phase="train_timing", **timing)
    profiled("profile_train_step", lambda i=0: tr.step(dev_full), 3, "step",
             {"k7_forward": ("mlp_fwd_pass", "chan_reduce"),
              "k7_backward": ("mlp_bwd_pass", "pool_sums_kernel", "finish_layer1", "sum_parts"),
              "k4": ("ball_scan_kernel",), "k6": ("cylinder_scan_kernel",)})
    return step_launches, timing, full, compact

def seed_chain_phase(cfg, clouds: np.ndarray) -> dict:
    """The FPS seed chain of each scene on the host library and on
    fps_numpy: indices and seed points equal; wall ms per scene of each."""
    from graspnet_tpu_torch import native
    from graspnet_tpu_torch.train import label_pipeline as lp

    native.fps(clouds[0][:64], 8)  # loads the library
    lib_ms, numpy_ms = [], []
    for cloud in clouds:
        t0 = time.perf_counter()
        inds, seeds = lp.seed_chain(cloud, cfg)
        lib_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        want, want_seeds = lp.seed_chain(cloud, cfg, fps=lp.fps_numpy)
        numpy_ms.append((time.perf_counter() - t0) * 1e3)
        for k in want:
            if not np.array_equal(inds[k], want[k]):
                bad = np.nonzero(inds[k] != want[k])[0]
                raise AssertionError(f"seed chain {k}: host library != fps_numpy from index {bad[0]}")
        if not np.array_equal(seeds, want_seeds):
            raise AssertionError("seed chain: seed points differ")
    return {"scenes": len(clouds), "points": int(clouds.shape[1]), "indices_equal": True,
            "host_library_ms_per_scene": lib_ms, "fps_numpy_ms_per_scene": numpy_ms}


def five_steps(cfg, full):
    """Five Trainer.step calls on one full batch from TRAIN_SEED: the losses,
    and the model and Adam state after them."""
    from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer

    tr = Trainer(cfg, TrainConfig(), seed=TRAIN_SEED)
    tr.set_epoch(0)
    dev_full = tr.put(full)
    losses = [tr.step(dev_full)[0] for _ in range(5)]
    torch.cuda.synchronize()
    return [float(x) for x in losses], copy.deepcopy(tr.state_dict())


def states_equal(a, b) -> bool:
    """Nested dicts / lists of tensors and numbers, bitwise equal."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(states_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(states_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.shape == b.shape and torch.equal(a.cpu(), b.cpu())
    return a == b


def deterministic_steps(path: str) -> int:
    """The child of repeatability_phase, under DETERMINISTIC_ENV: five steps
    on the batch saved at `path` with the default algorithms, then five
    under torch.use_deterministic_algorithms(True), where any op without a
    deterministic CUDA version raises.  Prints the losses and whether the
    two runs are bitwise equal as its last line."""
    from graspnet_tpu_torch.config import GraspNetConfig

    full = {}
    with np.load(path) as f:
        for key in f.files:  # "sa_inds/sa1" -> full["sa_inds"]["sa1"]
            head, _, sub = key.partition("/")
            if sub:
                full.setdefault(head, {})[sub] = f[key]
            else:
                full[key] = f[key]
    cfg = GraspNetConfig()
    run1, state1 = five_steps(cfg, full)
    torch.use_deterministic_algorithms(True)
    try:
        run2, state2 = five_steps(cfg, full)
    finally:
        torch.use_deterministic_algorithms(False)
    print(json.dumps({"losses": run1, "deterministic_losses": run2,
                      "equal": run1 == run2 and states_equal(state1, state2)}), flush=True)
    return 0


def repeatability_phase(cfg, full) -> dict:
    """Five steps twice in this process, bitwise equal; then the
    deterministic-mode check in a child process (deterministic_steps), whose
    fixed cuBLAS workspace stays out of this process and every other phase."""
    run1, state1 = five_steps(cfg, full)
    run2, state2 = five_steps(cfg, full)
    if run1 != run2 or not states_equal(state1, state2):
        raise AssertionError(f"five steps are not repeatable: losses {run1} vs {run2}, "
                             f"states equal: {states_equal(state1, state2)}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_deterministic_") as tmp:
        path = os.path.join(tmp, "batch.npz")
        flat = {f"{k}/{sub}" if isinstance(v, dict) else k: a
                for k, v in full.items() for sub, a in (v.items() if isinstance(v, dict) else [(None, v)])}
        np.savez(path, **flat)
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--deterministic-steps", path],
                               env={**os.environ, **DETERMINISTIC_ENV}, capture_output=True, text=True,
                               timeout=DETERMINISTIC_TIMEOUT_S)
        child_s = time.perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f"the deterministic-mode child exited {child.returncode}:\n{child.stderr[-4000:]}")
    got = json.loads(child.stdout.strip().splitlines()[-1])
    if not got["equal"]:
        raise AssertionError(f"deterministic mode changed the step: losses {got['losses']} vs "
                             f"{got['deterministic_losses']}, or the states differ")
    return {"losses": run1, "runs_bitwise_equal": True, "deterministic_mode_equal": True,
            "deterministic_env": DETERMINISTIC_ENV, "deterministic_losses": got["deterministic_losses"],
            "child_losses_equal_default_workspace": got["losses"] == run1, "child_s": child_s}


@contextlib.contextmanager
def recording(module, name: str):
    """The calls of `module.<name>` while the block runs, their tensor
    arguments (and tuples of them) copied.  A kernel wrapper counts its
    launches under its module-level name, which is the recorder while the
    block runs when `module` is the wrapper's own: those launches stay out
    of the counts."""
    calls, real = [], getattr(module, name)

    def copied(a):
        if isinstance(a, torch.Tensor):
            return a.clone()
        return tuple(copied(x) for x in a) if isinstance(a, tuple) else a

    def record(*args):
        calls.append(tuple(copied(a) for a in args))
        return real(*args)

    record.launches = real.launches
    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def capture_scatter_calls(cfg, full):
    """The scatter-add calls of one Trainer.step as its backward makes them:
    (g, idx, n, plan), copied."""
    from graspnet_tpu_torch.ops import scatter as gathers
    from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer

    tr = Trainer(cfg, TrainConfig(), seed=TRAIN_SEED)
    dev_full = tr.put(full)
    with recording(gathers, "scatter_add_rows") as calls:
        tr.step(dev_full)
        torch.cuda.synchronize()
    return calls


def check_scatter_call(g, idx, n, plan):
    """The scatter-add's two kernels at one call: the plan (made by the
    plan kernel in the gather's forward) bitwise the plain plan's on the
    card and on the CPU; the sum bitwise repeatable, bitwise the CPU's
    sequential sum (the same adds in the same order) and within
    SCATTER_F64_TOL x max(1, scale) of a float64 sum.  Returns (the
    kernel's sum, |kernel - plain on the card|, its error from float64, the
    scale)."""
    from graspnet_tpu_torch.ops import scatter as ksc

    for want in (ksc.scatter_plan_plain(idx, n), ksc.scatter_plan_plain(idx.cpu(), n)):
        if not all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(plan, want)):
            raise AssertionError(f"scatter_plan at {tuple(idx.shape)} -> {n} differs from the plain plan")
    got = ksc.scatter_add_rows(g, idx, n, plan)
    again = ksc.scatter_add_rows(g, idx, n, plan)
    plain = ksc.scatter_add_rows_plain(g, idx, n)
    cpu = ksc.scatter_add_rows_plain(g.cpu(), idx.cpu(), n)
    f64 = ksc.scatter_add_rows_plain(g.cpu().double(), idx.cpu(), n)
    torch.cuda.synchronize()
    scale = max(1.0, f64.abs().max().item())
    err64 = (got.cpu().double() - f64).abs().max().item()
    if not torch.equal(got, again) or not torch.equal(got.cpu(), cpu) or err64 > SCATTER_F64_TOL * scale:
        raise AssertionError(f"scatter_add_rows at {tuple(g.shape)} -> {n}: repeatable "
                             f"{torch.equal(got, again)}, equal to the CPU's sum {torch.equal(got.cpu(), cpu)}, "
                             f"{err64} from float64 at scale {scale}")
    return got, (got - plain).abs().max().item(), err64, scale


def scatter_plan_edges() -> list:
    """The plan kernel at its edges, bitwise the plain plan on the CPU: a
    ragged last chunk, every key in one row, every row empty but one, B=1 x
    n=20000 (its histograms in global memory) and indices n, -1, 2n and
    -2^40 in every scene (dropped: they sort last)."""
    from graspnet_tpu_torch.ops import scatter as ksc

    rng = np.random.default_rng(DATA_SEED)
    one_row = np.full((2, 5000), -1)
    one_row[1] = 5
    dropped = rng.integers(0, 64, (3, 1500))
    dropped[:, ::5], dropped[:, 1::7], dropped[:, 2::11], dropped[:, 3::13] = 64, -1, 128, -(2**40)
    cases = {"ragged": (rng.integers(0, 40, (3, 4099)), 40), "one_row": (one_row, 9),
             "one_row_filled": (np.full((1, 777), 3), 100), "b1_n20000": (rng.integers(0, 20000, (1, 30000)), 20000),
             "dropped": (dropped, 64)}
    out = []
    for name, (idx, n) in cases.items():
        cpu = torch.from_numpy(np.asarray(idx, np.int64))
        got, want = ksc.scatter_plan(cpu.cuda(), n), ksc.scatter_plan_plain(cpu, n)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
            raise AssertionError(f"scatter_plan at the edge case {name} differs from the plain plan")
        out.append({"case": name, "shape": list(idx.shape), "n": n, "in_range": int(want[1][-1])})
    return out


def scatter_profile_split(calls, reps: int = 10) -> dict:
    """Host and device time of a step's scatter-add calls (`calls`, from
    `capture_scatter_calls`), for the plan (`scatter_plan`), the segment sum
    (`scatter_add_rows` on the captured plans) and torch.index_add on the
    same rows, all in one torch.profiler window, split by kernel name (the
    plan kernel's, the sum kernel's, the rest torch.index_add's): device ms
    per step by kernel and device operations (kernels, memsets, copies) per
    call; then, unprofiled, the host's ms per step to enqueue each loop and
    the loop's CUDA-event ms per step."""
    from torch.profiler import ProfilerActivity, profile

    from graspnet_tpu_torch.ops import scatter as ksc

    flat = [(g.reshape(-1, g.shape[2]), (idx + n * torch.arange(g.shape[0], device=idx.device)[:, None]).reshape(-1),
             torch.zeros(g.shape[0] * n, g.shape[2], device=g.device)) for g, idx, n, _ in calls]
    loops = {"plan": lambda: [ksc.scatter_plan(i, n) for _, i, n, _ in calls],
             "sum": lambda: [ksc.scatter_add_rows(g, i, n, p) for g, i, n, p in calls],
             "index_add": lambda: [torch.index_add(z, 0, r, g2) for g2, r, z in flat]}
    names = {"plan": "scatter_plan_kernel", "sum": "segment_sum_kernel"}
    for fn in loops.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in loops.values():
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    out = {k: {"device_ms_per_step_by_kernel": {}, "device_ops_per_call": 0.0} for k in loops}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            which = next((k for k, part in names.items() if part in ev.key), "index_add")
            out[which]["device_ms_per_step_by_kernel"][ev.key[:80]] = dev_us / reps / 1e3
            out[which]["device_ops_per_call"] += ev.count / reps / len(calls)
    for name, fn in loops.items():
        by_kernel = out[name]["device_ms_per_step_by_kernel"]
        out[name]["device_ms_per_step"] = sum(by_kernel.values()) if by_kernel else "not measured"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name]["host_enqueue_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        out[name]["event_ms_per_step"] = cuda_ms(fn, 20)
    log(phase="scatter_profile_split", reps=reps, **out)
    return out


def scatter_kernel_rows(cfg, full) -> list:
    """The scatter-add's plan and sum kernels at each call of a step
    (`check_scatter_call`) and the plan at its edges
    (`scatter_plan_edges`); times of the step's calls together, and their
    profiler split (`scatter_profile_split`).  Returns the sum's and the
    plan's rows."""
    from graspnet_tpu_torch.ops import scatter as ksc

    calls = capture_scatter_calls(cfg, full)
    if len(calls) != 5:
        raise AssertionError(f"a step made {len(calls)} scatter-add calls, expected 5")
    shapes, err_plain, nbytes, adds, plan_bytes = [], 0.0, 0, 0, 0
    for g, idx, n, plan in calls:
        _, err, err64, scale = check_scatter_call(g, idx, n, plan)
        err_plain = max(err_plain, err)
        b, k, c = g.shape
        nbytes += g.numel() * 4 + idx.numel() * 8 + b * n * c * 4
        adds += g.numel()
        plan_bytes += idx.numel() * (8 + 4) + (2 * b * n + 1) * 4  # idx read; perm, starts, order written
        segs = plan[1][1:] - plan[1][:-1]
        shapes.append({"g": [b, k, c], "n": n, "err_f64": err64, "scale": scale,
                       "longest_segment": int(segs.max()), "empty_rows": int((segs == 0).sum())})
    edges = scatter_plan_edges()
    flat = [(g.reshape(-1, g.shape[2]), (idx + n * torch.arange(g.shape[0], device=idx.device)[:, None]).reshape(-1),
             torch.zeros(g.shape[0] * n, g.shape[2], device=g.device)) for g, idx, n, _ in calls]
    keys = [ksc._keys(idx, n) for _, idx, n, _ in calls]
    bounds = [torch.arange(g.shape[0] * n + 1, device=g.device) for g, _, n, _ in calls]
    t_bound, by = bound(nbytes, adds)
    sum_row = dict(
        name="scatter_add_rows", route="cuda", source="graspnet_tpu_torch/csrc/scatter.cu",
        replaces="no TPU kernel: graspnet_tpu/ops/scatter.py:28 (scatter_add_rows) is XLA",
        max_abs_err=err_plain,
        ms=cuda_ms(lambda: [ksc.scatter_add_rows(g, i, n, p) for g, i, n, p in calls], 20),
        plain_ms=cuda_ms(lambda: [ksc.scatter_add_rows_plain(g, i, n) for g, i, n, _ in calls], 20),
        bound_ms=t_bound, bound_by=by,
        library_ms=cuda_ms(lambda: [torch.index_add(z, 0, r, g2) for g2, r, z in flat], 20),
    )
    t_plan, plan_by = bound(plan_bytes)
    plan_row = dict(
        name="scatter_plan", route="cuda", source="graspnet_tpu_torch/csrc/scatter.cu",
        replaces="no TPU kernel: the plan of the XLA scatter_add_rows' port (graspnet_tpu/ops/scatter.py:28)",
        max_abs_err=0.0,  # perm and starts bitwise the plain plan's (check_scatter_call)
        ms=cuda_ms(lambda: [ksc.scatter_plan(i, n) for _, i, n, _ in calls], 20),
        plain_ms=cuda_ms(lambda: [ksc.scatter_plan_plain(i, n) for _, i, n, _ in calls], 20),
        bound_ms=t_plan, bound_by=plan_by,
        # the library's stable sort and search on the same keys
        library_ms=cuda_ms(lambda: [torch.searchsorted(torch.sort(kk, stable=True)[0], bb)
                                    for kk, bb in zip(keys, bounds)], 20),
    )
    split = scatter_profile_split(calls)
    log(phase="scatter_kernel", calls=shapes, plan_edges=edges, bitwise_plain_plan=True, bitwise_cpu_sum=True,
        repeatable=True, f64_tol=SCATTER_F64_TOL,
        sum={k: sum_row[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        plan={k: plan_row[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        device_ms_per_step={k: v["device_ms_per_step"] for k, v in split.items()})
    return [sum_row, plan_row]


def train_cli_phase(cfg, clouds: np.ndarray, full):
    """Phase 8: the training entry point on the card.  Returns the scatter
    kernels' rows and the phase's timings."""
    from graspnet_tpu_torch.apps import train as cli_train
    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.ops.cuda import build
    from graspnet_tpu_torch.scripts import bench_train_pipeline
    from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer
    from graspnet_tpu_torch.utils import timing as slope
    from graspnet_tpu_torch.utils.logging import MetricLogger

    log(phase="train_cli_build", build_s={k: build.BUILD_SECONDS.get(k) for k in (build.HOST, "scatter")})
    chain = seed_chain_phase(cfg, clouds)
    log(phase="train_cli_seed_chain", **chain)
    rep = repeatability_phase(cfg, full)
    log(phase="train_cli_repeatable", **rep)
    scatter_rows = scatter_kernel_rows(cfg, full)

    slope.reset(TOOL_K_LO, TOOL_K_HI)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_cli_") as log_dir:
        result, trainer, ckpt = bench_train_pipeline.run(
            cfg, torch.device("cuda"), log_dir, steps=CLI_STEPS, warmup=CLI_WARMUP, workers=CLI_WORKERS,
            batch=B_KERNELS)
        s, e = result["train_steps"], 1  # train steps (run() checks them), eval batches
        expected = {**{k: 0 for k in kernels.launches()}, "ball_query": 4 * s + 6 * e, "crop_group": s,
                    "crop_mlp_train": s, "crop_mlp_train_backward": s, "scatter_add_rows": 5 * s,
                    "scatter_plan": 5 * s,
                    "sa1_fused": 2 * e, "crop_fused": e}
        if result["launches"] != expected:
            raise AssertionError(f"CLI loop launches {result['launches']}, expected {expected}")
        fresh = Trainer(cfg, TrainConfig(batch_size=B_KERNELS, max_epoch=1), seed=TRAIN_SEED + 1)
        logger = MetricLogger(log_dir, filename="resume.txt")
        try:
            start = cli_train.resume(fresh, ckpt, logger)
        finally:
            logger.close()
        saved = trainer.state_dict()
        if start != 1 or not states_equal(fresh.state_dict(), saved):
            raise AssertionError(f"resume: start epoch {start}, state equal {states_equal(fresh.state_dict(), saved)}")
    log(phase="train_cli_loop", resumed_bitwise=True, launches_per_loop=result["launches"],
        eval_batches=e, **{k: v for k, v in result.items() if k != "launches"})
    timing = dict(cli_sustained_ms_per_step=result["value"], cli_device_step_ms=result["device_step_ms"],
                  cli_stage1_ms=result["stage1_ms"], cli_host_prep_ms_per_scene=result["host_prep_ms_per_scene"],
                  cli_finalize_ms_per_batch=result["finalize_ms_per_batch"],
                  cli_device_busy_ms_per_step=result["device_busy_ms_per_step"],
                  cli_profiled_wall_ms_per_step=result["profiled_wall_ms_per_step"],
                  cli_loop_idle_share=result["device_idle_share"],
                  cli_loop_idle_share_sustained=result["device_idle_share_sustained"],
                  seed_chain_ms_per_scene_library=statistics.mean(chain["host_library_ms_per_scene"]),
                  seed_chain_ms_per_scene_numpy=statistics.mean(chain["fps_numpy_ms_per_scene"]))
    log(phase="train_cli_timing", **timing)
    return scatter_rows, timing


def collision_phase(pipe) -> dict:
    """Phase 10: the collision filter (`postproc/collision.py`, plain torch)
    on the card against the same call on the CPU: one GraspNetConfig()
    forward at B=2 on tabletop frames sampled from 250k-point raw clouds,
    the raw clouds voxel-downsampled once on the host library, then
    detect_batch with the same rows and points on both devices.  Masks
    and IoUs must be equal."""
    from graspnet_tpu_torch import native
    from graspnet_tpu_torch.postproc.collision import FINGER_WIDTH, _collision_counts_rows_batch, _pack, detect_batch
    from graspnet_tpu_torch.utils.synthetic import tabletop_cloud

    rng = np.random.default_rng(DATA_SEED + 1)
    raw = [tabletop_cloud(rng, RAW_CLOUD_POINTS) for _ in range(B_KERNELS)]
    ggs = pipe.get_grasps_batch(np.stack([pipe.sample_cloud(c, rng) for c in raw]))
    t0 = time.perf_counter()
    ds = [native.voxel_downsample(c, COLLISION_VOXEL) for c in raw]
    downsample_ms = (time.perf_counter() - t0) * 1e3 / len(raw)
    kw = dict(voxel_size=COLLISION_VOXEL, approach_dist=COLLISION_APPROACH, collision_thresh=COLLISION_THRESH,
              pre_downsampled=True)
    card = detect_batch(ds, ggs, device="cuda", **kw)
    t0 = time.perf_counter()
    cpu = detect_batch(ds, ggs, device="cpu", **kw)
    cpu_ms = (time.perf_counter() - t0) * 1e3 / len(raw)
    differing = int(sum((a != b).sum() for a, b in zip(card, cpu)))
    ious = []
    for dev in ("cuda", "cpu"):
        pts, rows = _pack(ds, [g.grasp_group_array for g in ggs], torch.device(dev))
        ious.append(_collision_counts_rows_batch(pts, rows, approach_dist=max(COLLISION_APPROACH, FINGER_WIDTH),
                                                 voxel_size=COLLISION_VOXEL)[0].cpu().numpy())
    iou_equal = bool(np.array_equal(ious[0], ious[1], equal_nan=True))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        detect_batch(ds, ggs, device="cuda", **kw)
        times.append((time.perf_counter() - t0) * 1e3 / len(raw))
    out = dict(b=len(raw), raw_points=RAW_CLOUD_POINTS, voxel=COLLISION_VOXEL, voxels=[len(d) for d in ds],
               grasps=[len(g) for g in ggs], colliding=[int(m.sum()) for m in card], differing_grasps=differing,
               iou_bitwise_equal=iou_equal, ms_per_frame=statistics.median(times), cpu_ms_per_frame=cpu_ms,
               downsample_ms_per_frame=downsample_ms)
    log(phase="collision", **out)
    if differing or not iou_equal or not sum(len(g) for g in ggs):
        raise AssertionError(f"collision masks: {differing} grasps differ card vs CPU, IoUs equal {iou_equal}")
    return out


def test_app_phase(cfg) -> dict:
    """Phase 11: the eval loop (`apps/test.py::inference`) through
    `scripts/bench_test_app.run` at GraspNetConfig(), batch 1 and 4, over
    TEST_APP_FRAMES synthetic frames of 250k-point raw clouds: ms/frame,
    stage means, launches per batch (K1 1, K3 1, K4 3, K5 1), the device's
    busy time and idle share over 3 profiled batches of the loop; then the
    card's dump of two frames against a CPU pipeline's dump of the same
    frames with the same weights."""
    from graspnet_tpu_torch.apps import test as test_app
    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.scripts import bench_test_app

    per_batch = {**{k: 0 for k in kernels.launches()}, "fps_chain": 1, "ball_query": 3, "sa1_fused": 1,
                 "crop_fused": 1}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_test_app_") as work:
        result = bench_test_app.run(cfg, torch.device("cuda"), work, frames=TEST_APP_FRAMES, batch_sizes=(1, 4))
        for row in result["per_batch_size"]:
            if row["launches_per_batch"] != per_batch:
                raise AssertionError(f"eval loop B={row['batch_size']}: launches per batch "
                                     f"{row['launches_per_batch']}, expected {per_batch}")
        ds = bench_test_app.make_dataset(cfg, TEST_APP_FRAMES)
        cpu_dump = os.path.join(work, "dump_cpu")
        t0 = time.perf_counter()
        test_app.inference(bench_test_app.loop_args(cpu_dump, result["checkpoint_path"], cfg, 1, 2, COLLISION_THRESH,
                                                    torch.device("cpu")), cfg, dataset=ds)
        cpu_s = time.perf_counter() - t0
        compared = []
        for i in range(2):
            scene, frame = ds.frames[i]
            rel = os.path.join(scene, "kinect", f"{frame:04d}.npy")
            card = np.load(os.path.join(work, "dump_b1", rel))
            compared.append({"frame": i, **compare_topk(card, np.load(os.path.join(cpu_dump, rel)))})
    keys = ("batch_size", "ms_per_frame", "warmup_s", "stages_ms", "device_busy_ms_per_batch",
            "profiled_wall_ms_per_batch", "device_idle_share", "device_idle_share_sustained")
    rows = [{k: r[k] for k in keys} for r in result["per_batch_size"]]
    log(phase="test_app", frames=TEST_APP_FRAMES, datagen_s=result["datagen_s"], per_batch_size=rows,
        launches_per_batch=per_batch, dump_card_vs_cpu=compared, cpu_dump_s=cpu_s)
    return {"launches_per_batch": per_batch,
            **{f"eval_ms_per_frame_b{r['batch_size']}": r["ms_per_frame"] for r in rows},
            **{f"eval_idle_share_sustained_b{r['batch_size']}": r["device_idle_share_sustained"] for r in rows}}


def learnability_phase() -> dict:
    """Phase 12: the learnability gate on the card (`scripts/
    learnability_gate.run`, 600 steps, seed 0): train the tiny model from
    scratch, dump the test split through apps/test.py with its collision
    filter, score it with eval/ap.py; AP(trained) >= 6 > AP(random),
    asserted, and the kernels' launches along the gate counted.  Then, in
    the gate's directory, the service's success path (phase 15) with the
    gate's data and checkpoint."""
    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.scripts import learnability_gate

    kernels.reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gate_") as work:
        result = learnability_gate.run(work, steps=GATE_STEPS, bar=GATE_BAR, seed=0, device="cuda")
        launches = kernels.launches()
        success = service_success_phase(result)
    steps, forwards = result["steps"], 6  # 2 dumps x (warm-up + 2 test frames)
    expected = {**{k: 0 for k in launches}, "ball_query": 4 * steps + 3 * forwards, "crop_group": steps,
                "crop_mlp_train": steps, "crop_mlp_train_backward": steps, "scatter_add_rows": 5 * steps,
                "scatter_plan": 5 * steps,
                "fps_chain": forwards, "sa1_fused": forwards, "crop_fused": forwards}
    log(phase="learnability", launches=launches,
        **{k: v for k, v in result.items() if k not in ("trajectory", "dataset_root", "checkpoint_path")},
        trajectory_tail=result["trajectory"][-5:])
    if launches != expected:
        raise AssertionError(f"gate launches {launches}, expected {expected}")
    if not (result["ap_trained"] >= GATE_BAR and result["ap_random"] < GATE_BAR):
        raise AssertionError(f"learnability gate: AP(trained) {result['ap_trained']} AP(random) "
                             f"{result['ap_random']}, bar {GATE_BAR}")
    return {k: result[k] for k in ("ap_trained", "ap_trained_08", "ap_trained_04", "ap_random", "train_s",
                                   "dataset_gen_s", "final_loss")} | success


def feature_input_phase() -> dict:
    """Phase 13: the SA1 routes away from K3 at GraspNetConfig() widths,
    seed-1 weights, on two tabletop clouds: extra input channels (an RGB-like
    triple, input_feature_dim=3, SA1 MLP 6-64-64-128) and sa1.normalize_xyz=
    False.  Each forward launches K1 1, K3 0, K4 4 (SA1-4) and K5 1, and
    equals the CPU's: selections exactly, floats within FEATURE_TOL x
    max(1, scale).  Returns the launches of the feature-input forward."""
    import dataclasses

    from graspnet_tpu_torch.config import GraspNetConfig, SAConfig
    from graspnet_tpu_torch.models import GraspNet, init_weights
    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.utils.synthetic import tabletop_cloud

    t_phase = time.perf_counter()
    base = GraspNetConfig()
    cases = {"input_features": GraspNetConfig(input_feature_dim=3, sa1=SAConfig(2048, 0.04, 64, (6, 64, 64, 128))),
             "sa1_unnormalized": dataclasses.replace(base, sa1=dataclasses.replace(base.sa1, normalize_xyz=False))}
    rng = np.random.default_rng(DATA_SEED + 2)
    xyz = np.stack([tabletop_cloud(rng) for _ in range(B_KERNELS)])
    rgb = rng.uniform(0, 1, xyz.shape).astype(np.float32)
    expected = {**{k: 0 for k in kernels.launches()}, "fps_chain": 1, "ball_query": 4, "crop_fused": 1}
    out = {}
    for name, cfg in cases.items():
        clouds = torch.from_numpy(np.concatenate([xyz, rgb[..., :cfg.input_feature_dim]], axis=-1))
        model = init_weights(GraspNet(cfg), WEIGHT_SEED).eval()
        t0 = time.perf_counter()
        with torch.inference_mode():
            want = model(clouds)
        cpu_s = time.perf_counter() - t0
        model.to("cuda")
        kernels.reset_launches()
        with torch.inference_mode():
            got = model(clouds.to("cuda"))
        torch.cuda.synchronize()
        launches = kernels.launches()
        if launches != expected:
            raise AssertionError(f"{name}: launches {launches}, expected {expected}")
        for key in ("sa1_inds", "fp2_inds", "grasp_top_view_inds"):
            if not torch.equal(got[key].cpu(), want[key]):
                raise AssertionError(f"{name}: {key} differs card vs CPU")
        errs = {key: feature_err(got[key].cpu(), want[key])
                for key in ("fp2_features", "objectness_score", "view_score", "grasp_score_pred",
                            "grasp_width_pred", "grasp_tolerance_pred")}
        out[name] = dict(channels=clouds.shape[-1], launches=launches, max_abs_err=errs, cpu_forward_s=cpu_s)
        del model
    log(phase="feature_input", b=B_KERNELS, n=N_POINTS, selections_equal=True, **out,
        phase_s=time.perf_counter() - t_phase)
    return out["input_features"]["launches"]


def service_reply_diff(card: dict, cpu: dict, atol: float = TOPK_ATOL) -> dict:
    """Card vs CPU replies of GraspService.compute(): `ok` equal; with
    grasps, the rows as compare_topk holds them and best_pose / tf_pose
    within `atol`."""
    if card["ok"] != cpu["ok"]:
        raise AssertionError(f"service ok differs: card {card.get('error')} cpu {cpu.get('error')}")
    if not cpu["ok"]:
        return {"ok": False}
    rows = compare_topk(np.asarray(card["grasps"], np.float32), np.asarray(cpu["grasps"], np.float32), atol)
    pose_err = max(float(np.abs(np.asarray(card[k]) - np.asarray(cpu[k])).max()) for k in ("best_pose", "tf_pose"))
    if pose_err > atol:
        raise AssertionError(f"service poses differ by {pose_err}")
    return {"ok": True, **rows, "pose_max_abs_err": pose_err}


def service_phase(ckpt: str) -> dict:
    """Phase 14: apps/service.py on the card with seed-1 weights
    (`ckpt`) at GraspNetConfig(): compute() on two 250k-point requests
    (scripts/bench_service.make_clouds) against the CPU service, with the
    collision filter off (rows as compare_topk holds them, poses within
    TOPK_ATOL) and on (ok and num_grasps equal); one TCP round trip on an
    ephemeral port (a 30k-point request) equal to the in-process reply;
    then bench_service.run: SERVICE_REQUESTS requests from SERVICE_CLIENTS
    threads at max_batch 1 and 8 with the filter on, each dispatch
    launching K1 1, K3 1, K4 3 and K5 1."""
    import socket

    from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig, serve_tcp
    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.scripts import bench_service

    t_phase = time.perf_counter()
    clouds = bench_service.make_clouds(2, RAW_CLOUD_POINTS, seed=DATA_SEED + 3)
    compared = {}
    for thresh in (-1.0, COLLISION_THRESH):
        card = GraspService(ServiceConfig(checkpoint_path=ckpt, collision_thresh=thresh, device="cuda"))
        cpu = GraspService(ServiceConfig(checkpoint_path=ckpt, collision_thresh=thresh, device="cpu"))
        rows = []
        for cloud in clouds:
            got, want = card.compute(cloud), cpu.compute(cloud)
            if thresh <= 0:
                if not want["ok"]:
                    raise AssertionError(f"no grasps without the collision filter: {want['error']}")
                rows.append(service_reply_diff(got, want))
            elif (got["ok"], got.get("num_grasps")) != (want["ok"], want.get("num_grasps")):
                raise AssertionError(f"collision on: card {got.get('num_grasps')} grasps, cpu {want.get('num_grasps')}")
            else:
                rows.append({"ok": got["ok"], "num_grasps": got.get("num_grasps")})
        compared[f"collision_{thresh}"] = rows
        del cpu
        if thresh > 0:
            request = bench_service.make_clouds(1, 30_000, seed=DATA_SEED + 4)[0]
            srv = serve_tcp(card, port=0)
            try:
                with socket.create_connection(("127.0.0.1", srv.server_address[1]), timeout=120) as sock:
                    sock.sendall(json.dumps({"cloud": request.tolist()}).encode() + b"\n")
                    reply = json.loads(sock.makefile("rb").readline().decode())
            finally:
                srv.shutdown()
                srv.server_close()
            local = json.loads(json.dumps(card.compute(request)))
            same = {k: v for k, v in reply.items() if k != "timings_ms"} == \
                {k: v for k, v in local.items() if k != "timings_ms"}
            if not same:
                raise AssertionError("TCP reply differs from the in-process compute()")
            compared["tcp_30k"] = {"ok": reply["ok"], "num_grasps": reply.get("num_grasps"), "equal": same}
        del card
    requests = bench_service.make_clouds(SERVICE_REQUESTS, RAW_CLOUD_POINTS, seed=DATA_SEED + 5)
    result = bench_service.run(requests, SERVICE_CLIENTS, COLLISION_THRESH, checkpoint_path=ckpt, device="cuda")
    per_dispatch = {**{k: 0 for k in kernels.launches()}, "fps_chain": 1, "ball_query": 3, "sa1_fused": 1,
                    "crop_fused": 1}
    for mode in result["modes"]:
        if mode["launches_per_dispatch"] != per_dispatch:
            raise AssertionError(f"service max_batch={mode['max_batch']}: launches per dispatch "
                                 f"{mode['launches_per_dispatch']}, expected {per_dispatch}")
    log(phase="service", card_vs_cpu=compared, requests=SERVICE_REQUESTS, clients=SERVICE_CLIENTS,
        raw_points=RAW_CLOUD_POINTS, collision_thresh=COLLISION_THRESH, bench=result,
        phase_s=time.perf_counter() - t_phase)
    b1, b8 = result["modes"]
    return {"launches_per_dispatch": per_dispatch, "service_requests_per_s_b1": b1["requests_per_s"],
            "service_requests_per_s_b8": b8["requests_per_s"], "service_ms_per_request_b1": b1["ms_per_request_sustained"],
            "service_ms_per_request_b8": b8["ms_per_request_sustained"], "service_dispatches_b8": b8["device_dispatches"]}


def service_success_phase(gate: dict) -> dict:
    """Phase 15 (inside the learnability gate's directory): the port of
    `bench_service --learnable`: the gate's 1024-point tiny config and its
    trained checkpoint, SERVICE_REQUESTS requests drawn from the learnable
    test scene, max_batch 1 and 8, the collision filter on.  The gate's
    dumps carry surviving grasps on these scenes, so every mode must
    answer ok > 0."""
    from graspnet_tpu_torch.scripts import bench_service
    from graspnet_tpu_torch.scripts.learnability_gate import gate_config

    t_phase = time.perf_counter()
    cfg = gate_config()
    clouds = bench_service.make_learnable_clouds(SERVICE_REQUESTS, gate["dataset_root"], cfg)
    result = bench_service.run(clouds, SERVICE_CLIENTS, COLLISION_THRESH, checkpoint_path=gate["checkpoint_path"],
                               model_cfg=cfg, num_point=cfg.num_point, device="cuda", learnable=True)
    rows = [{k: m[k] for k in ("max_batch", "requests", "ok", "requests_per_s", "ms_per_request_sustained",
                               "device_dispatches")} for m in result["modes"]]
    log(phase="service_success", modes=rows, value=result["value"], speedup_vs_unbatched=result["speedup_vs_unbatched"],
        phase_s=time.perf_counter() - t_phase)
    if not all(m["ok"] > 0 for m in rows):
        raise AssertionError(f"service success path: no ok reply in a mode: {rows}")
    return {f"service_success_ok_b{m['max_batch']}": m["ok"] for m in rows} | \
        {f"service_success_requests_per_s_b{m['max_batch']}": m["requests_per_s"] for m in rows}


def demos_phase(ckpt: str) -> dict:
    """Phase 16: the six demos in process through their main(argv) on the
    card with seed-1 weights at GraspNetConfig(), on a synthetic RGB-D frame
    in the reference demo layout (utils/synthetic.py::write_demo_frame,
    DEMO_FRAME pixels): image_demo's dump equal to a --device cpu run of
    the same demo (compare_topk), a --save_ply PLY that reads back with
    32 vertices a grasp plus the scene, demo_pointcloud, segmentation_demo,
    stereo_demo, grasp_tf --once's pose equal to the service's best pose for
    the same frame, and grasp_base.  The demos' own printing goes to a
    buffer."""
    import contextlib
    import io

    from graspnet_tpu_torch.apps import (
        demo_pointcloud,
        grasp_base,
        grasp_tf,
        image_demo,
        segmentation_demo,
        stereo_demo,
    )
    from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig
    from graspnet_tpu_torch.eval.ap import load_ply_points
    from graspnet_tpu_torch.utils.synthetic import write_demo_frame

    t_phase = time.perf_counter()
    out, times = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_demos_") as work:
        paths = write_demo_frame(os.path.join(work, "frame"), np.random.default_rng(DATA_SEED + 6), *DEMO_FRAME)
        frame = os.path.dirname(paths["color.png"])
        j = lambda name: os.path.join(work, name)  # noqa: E731
        ck = ["--checkpoint_path", ckpt]
        runs = {
            "image_demo": lambda: image_demo.main(["--data_dir", frame, "--dump", j("card.npy"), "--save_ply",
                                                   j("card.ply"), *ck]),
            "image_demo_cpu": lambda: image_demo.main(["--data_dir", frame, "--dump", j("cpu.npy"), *ck,
                                                       "--device", "cpu"]),
            "demo_pointcloud": lambda: demo_pointcloud.main(["--cloud_path", paths["cloud.npy"], "--dump",
                                                             j("pc.npy"), *ck]),
            "segmentation_demo": lambda: segmentation_demo.main(["--data_dir", frame, "--mask", paths["mask.png"],
                                                                 "--dump", j("seg.npy"), *ck]),
            "stereo_demo": lambda: stereo_demo.main(["--cloud_path", paths["cloud.npy"], "--intrinsics",
                                                     paths["K.txt"], "--mask_path", paths["mask.png"],
                                                     "--depth_path", paths["depth.png"], *ck]),
            "grasp_tf": lambda: grasp_tf.main(["--data_dir", frame, "--once", "--collision_thresh", "-1", *ck]),
        }
        results, printed = {}, io.StringIO()
        for name, fn in runs.items():
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                results[name] = fn()
            times[name] = time.perf_counter() - t0
        card, cpu = np.load(j("card.npy")), np.load(j("cpu.npy"))
        out["image_demo_card_vs_cpu"] = compare_topk(card, cpu)
        scene = image_demo.load_frame(frame)
        ply = load_ply_points(j("card.ply"))
        if len(ply) != 32 * len(card) + len(scene) or not np.allclose(ply[32 * len(card):], scene, atol=1e-6):
            raise AssertionError(f"image_demo PLY: {len(ply)} vertices for {len(card)} grasps and {len(scene)} points")
        out["ply_vertices"] = len(ply)
        out["rows"] = {"image_demo": len(card), "demo_pointcloud": len(np.load(j("pc.npy"))),
                       "segmentation_demo": len(np.load(j("seg.npy")))}
        out["stereo_demo"] = {"ok": results["stereo_demo"]["ok"], "num_grasps": results["stereo_demo"].get("num_grasps")}
        service = GraspService(ServiceConfig(checkpoint_path=ckpt, collision_thresh=-1.0, device="cuda"))
        best = np.asarray(service.compute(scene)["best_pose"], np.float32)
        if not np.array_equal(results["grasp_tf"], best):
            raise AssertionError(f"grasp_tf pose {results['grasp_tf']} differs from the service's {best}")
        out["grasp_tf_equals_service_best_pose"] = True
        np.save(j("base.npy"), np.eye(4))
        np.save(j("grasp.npy"), results["grasp_tf"])
        with contextlib.redirect_stdout(printed):
            based = grasp_base.main(["--grasp_path", j("grasp.npy"), "--extrinsics_path", j("base.npy")])
        if not np.allclose(based, results["grasp_tf"]):
            raise AssertionError("grasp_base with identity extrinsics moved the grasp")
    log(phase="demos", frame=list(DEMO_FRAME), scene_points=len(scene), seconds=times, **out,
        phase_s=time.perf_counter() - t_phase)
    return {"demos_s": sum(times.values())}


def crop_routes_phase(clouds: np.ndarray):
    """Phase 18: the CloudCrop's routes with a two-layer crop MLP (3, 16, 32)
    and GraspNetConfig()'s other widths: a B=1 forward with seed-1 weights
    takes K6 and the generic MLP, no K5 (K1 1, K3 1, K4 3, K6 1), equal to
    the CPU's (selections exactly, floats within FEATURE_TOL x max(1,
    scale)); one training probe at B=2 (`grads_compact`: pre-pass and
    step) takes K6 and the generic MLP, no K7, card against CPU within the
    train-correctness bounds (set at B=2, section 2 of PERF.md).  Returns the launches of the forward and of
    the probe."""
    import dataclasses

    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.models import GraspNet, init_weights
    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(GraspNetConfig(), crop_mlp=(3, 16, 32))
    zero = {k: 0 for k in kernels.launches()}
    x = torch.from_numpy(clouds[:1])
    model = init_weights(GraspNet(cfg), WEIGHT_SEED).eval()
    with torch.inference_mode():
        want = model(x)
    model.to("cuda")
    kernels.reset_launches()
    with torch.inference_mode():
        got = model(x.to("cuda"))
    torch.cuda.synchronize()
    eval_launches = kernels.launches()
    expected = {**zero, "fps_chain": 1, "ball_query": 3, "sa1_fused": 1, "crop_group": 1}
    if eval_launches != expected:
        raise AssertionError(f"crop_routes eval: launches {eval_launches}, expected {expected}")
    for key in ("fp2_inds", "grasp_top_view_inds"):
        if not torch.equal(got[key].cpu(), want[key]):
            raise AssertionError(f"crop_routes eval: {key} differs card vs CPU")
    errs = {key: feature_err(got[key].cpu(), want[key])
            for key in ("grasp_score_pred", "grasp_angle_cls_pred", "grasp_width_pred", "grasp_tolerance_pred")}
    del model, got
    _, compact, _ = train_batches(cfg, clouds[:B_KERNELS])
    card = Trainer(cfg, TrainConfig(), seed=TRAIN_SEED)
    cpu = Trainer(cfg, TrainConfig(), seed=TRAIN_SEED, device="cpu")
    tops = [t.prepare(compact)[2].cpu() for t in (card, cpu)]
    if not torch.equal(*tops):
        raise AssertionError("crop_routes train: pre-pass top views differ card vs CPU")
    kernels.reset_launches()
    l_card, g_card = card.grads_compact(compact)
    torch.cuda.synchronize()
    step_launches = kernels.launches()
    expected_step = {**zero, "ball_query": 4, "crop_group": 1, "scatter_add_rows": 5, "scatter_plan": 5}
    if step_launches != expected_step:
        raise AssertionError(f"crop_routes train: launches {step_launches}, expected {expected_step}")
    l_cpu, g_cpu = cpu.grads_compact(compact)
    found = compare_grads(l_card, g_card, l_cpu, g_cpu, "crop_routes train, card vs CPU")
    log(phase="crop_routes", crop_mlp=list(cfg.crop_mlp), eval_launches=eval_launches, eval_max_abs_err=errs,
        selections_equal=True, train_launches=step_launches, train_card_vs_cpu=found,
        phase_s=time.perf_counter() - t_phase)
    return eval_launches, step_launches


def tolerance_object(rng: np.random.Generator, n: int, v: int = 300, a: int = 12, d: int = 4):
    """One synthetic object: n label points in a 6 cm box and friction
    scores with mass on the thresholds (0, 0.3, mu = 0.55) beside uniform
    values up to 1.2, as tests/test_torch_port_tolerance.py draws them."""
    pts = rng.uniform(-0.03, 0.03, (n, 3)).astype(np.float32)
    scores = rng.uniform(0.0, 1.2, (n, v, a, d)).astype(np.float32)
    pick = rng.uniform(size=scores.shape)
    scores[pick < 0.4] = 0.3
    scores[(pick >= 0.4) & (pick < 0.45)] = 0.55
    scores[(pick >= 0.45) & (pick < 0.5)] = 0.0
    return pts, scores


def tolerance_phase() -> dict:
    """Phase 19: data/tolerance.py on the card: one synthetic object of
    TOL_LABEL_POINTS label points at V*A*D = 300*12*4, bitwise the CPU
    plain version; host ms per object on the card (median of 3, the
    result fetched); then apps/generate_tolerance.py over a two-object
    synthetic root on the card, its files bitwise the CPU function's."""
    from graspnet_tpu_torch.apps import generate_tolerance as tol_cli
    from graspnet_tpu_torch.data.tolerance import generate_tolerance

    t_phase = time.perf_counter()
    rng = np.random.default_rng(DATA_SEED + 6)
    pts, scores = tolerance_object(rng, TOL_LABEL_POINTS)
    card = generate_tolerance(pts, scores)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        generate_tolerance(pts, scores)
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    cpu = generate_tolerance(pts, scores, device="cpu")
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(card, cpu):
        raise AssertionError(f"tolerance: card differs from CPU at {int((card != cpu).sum())} cells")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tolerance_") as root:
        os.makedirs(os.path.join(root, "grasp_label"))
        objects = [tolerance_object(rng, 512) for _ in range(2)]
        for i, (p, sc) in enumerate(objects):
            np.savez(os.path.join(root, "grasp_label", f"{i:03d}_labels.npz"), points=p, scores=sc)
        t0 = time.perf_counter()
        tol_cli.main(["--dataset_root", root, "--num_objects", "2"])
        cli_s = time.perf_counter() - t0
        for i, (p, sc) in enumerate(objects):
            got = np.load(os.path.join(root, "tolerance", f"{i:03d}_tolerance.npy"))
            if not np.array_equal(got, generate_tolerance(p, sc, device="cpu")):
                raise AssertionError(f"tolerance CLI: object {i} differs from the CPU function")
    out = {"tolerance_ms_per_object": statistics.median(times), "tolerance_label_points": TOL_LABEL_POINTS}
    log(phase="tolerance", **out, runs_ms=times, cpu_s=cpu_s, bitwise_equal=True, nonzero_share=float((card > 0).mean()),
        distinct_radii=int(len(np.unique(card))), cli_two_objects_s=cli_s, phase_s=time.perf_counter() - t_phase)
    return out


def parallel_infer_phase(clouds: np.ndarray, ckpt: str) -> dict:
    """Phase 20: parallel/ on one card whose device the meshes repeat:
    GraspPipeline(mesh=) at GraspNetConfig(), seed-1 weights, with a data
    mesh ['cuda:0'] * 2 at B=4, a candidate mesh ['cuda:0'] * 4 at B=1 and
    the hybrid 2 x 2 at B=2; each top-50 equal to the unsharded card
    pipeline's (selection fields equal, floats within PARALLEL_ATOL), each
    forward launching K1, K3 and K4 once per scene group (K4 three times)
    and K5 once per seed block; host ms per frame with every result
    fetched, beside the unsharded pipeline's at the same batch (one card,
    repeated device: the code path, not scaling).  Then the service with
    candidate_devices=2 on ['cuda:0'] * 2 against the one-device service on
    two 250k-point requests, collision filter off.  Returns the launches of
    the three forwards, summed, and the timings."""
    from graspnet_tpu_torch.apps import GraspPipeline
    from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.parallel import make_mesh
    from graspnet_tpu_torch.scripts import bench_service

    t_phase = time.perf_counter()
    cfg = GraspNetConfig()
    plain = GraspPipeline(cfg=cfg, seed=WEIGHT_SEED)
    zero = {k: 0 for k in kernels.launches()}
    total = dict(zero)
    cases = {"data_2": (("data",), (2,), 4, 2, 1), "candidate_4": (("candidate",), (4,), 1, 1, 4),
             "hybrid_2x2": (("data", "candidate"), (2, 2), 2, 2, 2)}
    found, timing = {}, {}

    def ms_per_frame(pipe, x, b):
        pipe.get_grasps_topk_batch(x)
        times = []
        for _ in range(PARALLEL_REPS):
            t0 = time.perf_counter()
            pipe.get_grasps_topk_batch(x)
            times.append((time.perf_counter() - t0) * 1e3 / b)
        return statistics.median(times)

    for name, (names, shape, b, groups, blocks) in cases.items():
        n = int(np.prod(shape))
        pipe = GraspPipeline(cfg=cfg, seed=WEIGHT_SEED, mesh=make_mesh(n, names, devices=["cuda:0"] * n, shape=shape))
        x = clouds[:b]
        kernels.reset_launches()
        got = pipe.get_grasps_topk_batch(x)
        torch.cuda.synchronize()
        launches = kernels.launches()
        expected = {**zero, "fps_chain": groups, "sa1_fused": groups, "ball_query": 3 * groups,
                    "crop_fused": groups * blocks}
        if launches != expected:
            raise AssertionError(f"parallel_infer {name}: launches {launches}, expected {expected}")
        total = {k: total[k] + v for k, v in launches.items()}
        want = plain.get_grasps_topk_batch(x)
        rows = [compare_topk(g.grasp_group_array, w.grasp_group_array, PARALLEL_ATOL) for g, w in zip(got, want)]
        if any(r["rows"] != 50 for r in rows):
            raise AssertionError(f"parallel_infer {name}: top-50 rows {[r['rows'] for r in rows]}")
        found[name] = dict(batch=b, launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows))
        timing[f"parallel_{name}_ms_per_frame"] = ms_per_frame(pipe, x, b)
        timing[f"parallel_{name}_unsharded_ms_per_frame"] = ms_per_frame(plain, x, b)
        del pipe
    requests = bench_service.make_clouds(2, RAW_CLOUD_POINTS, seed=DATA_SEED + 3)
    one = GraspService(ServiceConfig(checkpoint_path=ckpt, collision_thresh=-1.0))
    two = GraspService(ServiceConfig(checkpoint_path=ckpt, collision_thresh=-1.0, candidate_devices=2,
                                     mesh_devices=("cuda:0",) * 2))
    replies = [service_reply_diff(two.compute(c), one.compute(c), PARALLEL_ATOL) for c in requests]
    if not all(r["ok"] for r in replies):
        raise AssertionError(f"parallel_infer service: no grasps in a reply {replies}")
    del one, two
    log(phase="parallel_infer", what="one card, repeated device: code path, not scaling", cases=found,
        service_candidate_2=replies, atol=PARALLEL_ATOL, **timing, phase_s=time.perf_counter() - t_phase)
    return {"launches": total, **timing}


def _scenes(compact: dict, lo: int, hi: int) -> dict:
    """Scenes [lo, hi) of a compact host batch, as a batch."""
    out = {}
    for k, v in compact.items():
        if k == "sa_inds":
            out[k] = {s: a[lo:hi] for s, a in v.items()}
        else:
            out[k] = v[lo:hi]
    return out


def ddp_train_phase(cfg, full: dict, compact: dict) -> dict:
    """Phase 17: data-parallel training on the card.
    - A one-rank NCCL group: one Trainer(group=).step bitwise the plain
      card step (loss and every state tensor), K7 launched (world size 1).
    - Two ranks on the one card over gloo (NCCL takes one rank a card),
      `hybrid_rank` laid out 2 x 1 (data-parallel), one scene each of the
      B=2 batch, K6 and the scatter-add held against their plain versions
      at a rank's shapes: the probe's loss and summed
      gradients against the single-process B=2 card probe within the
      train-correctness bounds (the routes differ by K7, as card and CPU
      do); each rank launches K7 0 times, K6 and the scatter-add.
    - scripts/multiproc_check.py --device cuda --backend gloo: verdict ok.
    Returns the launches of the one-rank step and of one rank's step."""
    import pickle
    import socket

    import torch.distributed as dist

    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    zero = {k: 0 for k in kernels.launches()}

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        grouped = Trainer(cfg, TrainConfig(), seed=TRAIN_SEED, group=dist.group.WORLD)
        plain = Trainer(cfg, TrainConfig(), seed=TRAIN_SEED)
        for t in (grouped, plain):
            t.set_epoch(0)
        dev_full = plain.put(full)
        kernels.reset_launches()
        l1, _ = grouped.step(dev_full)
        torch.cuda.synchronize()
        one_rank = kernels.launches()
        l0, _ = plain.step(dev_full)
        same = float(l1) == float(l0) and all(
            torch.equal(a, b) for a, b in zip(grouped.model.state_dict().values(), plain.model.state_dict().values()))
        if not same or one_rank["crop_mlp_train"] != 1 or one_rank["crop_mlp_train_backward"] != 1:
            raise AssertionError(f"one-rank NCCL step: bitwise {same}, launches {one_rank}")
        del grouped, plain, dev_full
    finally:
        dist.destroy_process_group()

    ref = Trainer(cfg, TrainConfig(), seed=TRAIN_SEED)
    ref.set_epoch(0)
    l_ref, g_ref = ref.grads_compact(compact)
    del ref
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as tmp:
        batch_path = os.path.join(tmp, "compact.pkl")
        with open(batch_path, "wb") as f:
            pickle.dump(compact, f)
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(hybrid_rank, args=(free_port(), batch_path, tmp, (2, 1)), nprocs=2, join=True)
        ranks_s = time.perf_counter() - t0
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(2)]
    block_kernels = [json.loads(str(r["block_kernels"])) for r in ranks]
    g_ranks = {k[2:]: torch.from_numpy(v) for k, v in ranks[0].items() if k.startswith("g:")}
    found = compare_grads(float(ranks[0]["loss"]), g_ranks, l_ref, g_ref, "2 gloo ranks vs the B=2 step")
    rank_launches = [json.loads(str(r["launches"])) for r in ranks]
    for r, counts in enumerate(rank_launches):
        for what, c in counts.items():
            if c["crop_mlp_train"] or c["crop_mlp_train_backward"] or not c["crop_group"] or not c["scatter_add_rows"] \
                    or c["scatter_plan"] != c["scatter_add_rows"]:
                raise AssertionError(f"rank {r} {what}: launches {c} (K7 must stay off at world size 2)")
    if float(ranks[0]["step_loss"]) != float(ranks[1]["step_loss"]):
        raise AssertionError("the ranks report different global losses")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "graspnet_tpu_torch.scripts.multiproc_check", "--device", "cuda",
                           "--backend", "gloo"], cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=MULTIPROC_TIMEOUT_S)
    verdict = json.loads(proc.stdout.strip().splitlines()[-1]) if proc.stdout.strip() else {}
    if proc.returncode != 0 or not verdict.get("ok"):
        raise AssertionError(f"multiproc_check on the card: rc {proc.returncode}, {verdict or proc.stderr[-2000:]}")
    log(phase="ddp_train", one_rank_nccl_bitwise=True, one_rank_launches=one_rank, two_gloo_ranks=found,
        rank_launches=rank_launches, rank_kernels_vs_plain=block_kernels, two_ranks_s=ranks_s, multiproc_check=verdict,
        multiproc_check_s=time.perf_counter() - t0, phase_s=time.perf_counter() - t_phase)
    return {"one_rank_step": one_rank, "rank_step": rank_launches[0]["step"]}


def block_kernel_checks(crops: list, scatters: list) -> dict:
    """K6 and the scatter-add at one probe's calls (`recording`), each
    against its plain version: K6's offsets bitwise `crop_group_plain`'s,
    the scatter-add as `check_scatter_call` holds it.  The shapes and
    errors."""
    from graspnet_tpu_torch.ops.cuda import crop as kcrop

    if len(crops) != 1 or len(scatters) != 5:
        raise AssertionError(f"a probe made {len(crops)} crop_group and {len(scatters)} scatter-add calls, "
                             f"expected 1 and 5")
    out = {"crop_group": [], "scatter_add_rows": []}
    for args in crops:
        got, want = kcrop.crop_group(*args), kcrop.crop_group_plain(*args)
        if not torch.equal(got, want):
            raise AssertionError(f"crop_group at seeds {tuple(args[1].shape)} differs from its plain version by "
                                 f"{(got - want).abs().max().item()}")
        out["crop_group"].append({"seeds": list(args[1].shape[:2]), "bitwise_plain": True})
    for g, idx, n, plan in scatters:
        _, err, err64, scale = check_scatter_call(g, idx, n, plan)
        out["scatter_add_rows"].append({"g": list(g.shape), "n": n, "max_abs_err_plain": err, "err_f64": err64,
                                        "scale": scale, "bitwise_cpu_sum": True})
    return out


def hybrid_rank(rank: int, port: int, batch_path: str, out_dir: str, layout: tuple) -> None:
    """One rank of hybrid_train_phase (and, laid out 2 x 1, of
    ddp_train_phase) on the card, over gloo: its data row's scenes of the
    B=2 batch through `Trainer(group=, candidate=C)`, stage 2 on its seed
    block: the probe's loss and (summed) gradients, then one step_compact;
    each one's kernel launches and the state after the step.  Then, outside
    the counted runs, one more probe whose K6 and scatter-add calls are
    held against their plain versions (`block_kernel_checks`)."""
    import pickle

    import torch.distributed as dist

    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.models import heads
    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.ops import scatter as gathers
    from graspnet_tpu_torch.parallel import distributed
    from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer

    rows, cand = layout
    distributed.initialize(f"127.0.0.1:{port}", rows * cand, rank, backend="gloo", device="cuda")
    try:
        with open(batch_path, "rb") as f:
            compact = pickle.load(f)
        sl = distributed.process_local_batch_slice(len(compact["label_ctx"]), cand)
        local = _scenes(compact, sl.start, sl.stop)
        tr = Trainer(GraspNetConfig(), TrainConfig(), seed=TRAIN_SEED, group=dist.group.WORLD, candidate=cand)
        tr.set_epoch(0)
        kernels.reset_launches()
        loss, grads = tr.grads_compact(local)
        torch.cuda.synchronize()
        probe = kernels.launches()
        kernels.reset_launches()
        step_loss, _ = tr.step_compact(local)
        torch.cuda.synchronize()
        step = kernels.launches()
        grads = {f"g:{k}": v.cpu().numpy() for k, v in grads.items()} if rank == 0 else {}
        state = {f"s:{k}": v.cpu().numpy() for k, v in tr.model.state_dict().items()}
        with recording(heads, "crop_group") as crops, recording(gathers, "scatter_add_rows") as scatters:
            tr.grads_compact(local)
            torch.cuda.synchronize()
        checked = block_kernel_checks(crops, scatters)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), loss=float(loss), step_loss=float(step_loss),
                 launches=json.dumps({"probe": probe, "step": step}), block_kernels=json.dumps(checked),
                 **grads, **state)
    finally:
        dist.destroy_process_group()


def hybrid_train_phase(cfg, compact: dict) -> dict:
    """Phase 22: hybrid data x candidate training on the card: gloo ranks
    sharing it (NCCL takes one rank a card), laid out 2 x 2 (a scene a data
    row, two seed blocks of 512 each) and 1 x 2 (both scenes, two blocks),
    at GraspNetConfig() on the B=2 batch.  In each layout the probe's loss
    and summed gradients against the single-process B=2 card probe within
    the train-correctness bounds (the routes differ by K7, as card and CPU
    do); every rank's weights and BN buffers after one step bitwise rank
    0's; each rank's step launches K4 4, K6 1, the scatter-add 5 and no K7;
    on every rank, K6 and the scatter-add against their plain versions at
    its seed block's shapes (`hybrid_rank`).  Returns a 2 x 2 rank's step
    launches."""
    import pickle
    import socket

    from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    ref = Trainer(cfg, TrainConfig(), seed=TRAIN_SEED)
    ref.set_epoch(0)
    l_ref, g_ref = ref.grads_compact(compact)
    del ref
    found, step_launches = {}, None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hybrid_") as tmp:
        batch_path = os.path.join(tmp, "compact.pkl")
        with open(batch_path, "wb") as f:
            pickle.dump(compact, f)
        for layout in ((2, 2), (1, 2)):
            name, n = f"{layout[0]}x{layout[1]}", layout[0] * layout[1]
            out_dir = os.path.join(tmp, name)
            os.makedirs(out_dir)
            t0 = time.perf_counter()
            torch.multiprocessing.spawn(hybrid_rank, args=(free_port(), batch_path, out_dir, layout), nprocs=n,
                                        join=True)
            ranks_s = time.perf_counter() - t0
            ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(n)]
            g = {k[2:]: torch.from_numpy(v) for k, v in ranks[0].items() if k.startswith("g:")}
            grads = compare_grads(float(ranks[0]["loss"]), g, l_ref, g_ref, f"hybrid {name} vs the B=2 step")
            states = [k for k in ranks[0] if k.startswith("s:")]
            unequal = [(r, k) for r in range(1, n) for k in states if not np.array_equal(ranks[r][k], ranks[0][k])]
            if unequal:
                raise AssertionError(f"hybrid {name}: rank states differ after a step: {unequal[:5]}")
            if len({float(r["step_loss"]) for r in ranks}) != 1:
                raise AssertionError(f"hybrid {name}: the ranks report different global losses")
            launches = [json.loads(str(r["launches"])) for r in ranks]
            for r, counts in enumerate(launches):
                c = counts["step"]
                want = {**{k: 0 for k in c}, "ball_query": 4, "crop_group": 1, "scatter_add_rows": 5,
                        "scatter_plan": 5}
                if c != want:
                    raise AssertionError(f"hybrid {name} rank {r} step: launches {c}, expected {want}")
            found[name] = dict(card_vs_b2_step=grads, ranks_bitwise_equal=True, state_tensors=len(states),
                               rank_launches=[c["step"] for c in launches], ranks_s=ranks_s,
                               rank_kernels_vs_plain=[json.loads(str(r["block_kernels"])) for r in ranks])
            if layout == (2, 2):
                step_launches = launches[0]["step"]
    log(phase="hybrid_train", **found, phase_s=time.perf_counter() - t_phase)
    return step_launches


# SA-MSG at the PointNet++ classification model's first stage (Qi et al.
# 2017, pointnet2_cls_msg SA1), then an LFP stage back onto 2048 points
MSG_SA = dict(npoint=512, radii=(0.1, 0.2, 0.4), nsamples=(16, 32, 128),
              mlps=((32, 32, 64), (64, 64, 128), (64, 96, 128)))
MSG_LFP = dict(targets=2048, radii=(0.2, 0.4), nsamples=(16, 32), mlps=((128,), (128,)), post=(128,))


def seeded_msg(module, seed: int):
    """Seeded weights for an MSG module: Kaiming-normal kernels and BN
    running statistics and affine drawn away from the identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith("kernel"):
                t.copy_(torch.randn(t.shape, generator=gen) * (2.0 / t.shape[0]) ** 0.5)
            elif name.endswith(("mean", "offset")):
                t.copy_((torch.rand(t.shape, generator=gen) - 0.5) * 0.2)
            elif name.endswith(("var", "scale")):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
    return module


def msg_phase(clouds: np.ndarray) -> dict:
    """Phase 23: the MSG modules (models/msg.py) on the card at published
    widths (MSG_SA, MSG_LFP) on B=2 tabletop clouds of 20000 points, seeded
    weights: the FPS stage and every ball query against their plain
    versions on the card (indices equal), the eval forward against the same
    modules on the CPU (indices equal, features within FEATURE_TOL x max(1,
    scale)); launches a forward: FPS 1, K4 one per SA scale and one per LFP
    scale; CUDA-event ms of the forward.  Returns those launches."""
    from graspnet_tpu_torch import ops
    from graspnet_tpu_torch.models.msg import LFPModuleMSG, SAModuleMSG
    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.ops.cuda import fps as kfps
    from graspnet_tpu_torch.ops.cuda import query as kquery

    t_phase = time.perf_counter()
    sa_cfg, lfp_cfg = MSG_SA, MSG_LFP
    sa = seeded_msg(SAModuleMSG(sa_cfg["mlps"], in_dim=0, npoint=sa_cfg["npoint"], radii=sa_cfg["radii"],
                                nsamples=sa_cfg["nsamples"]), DATA_SEED).eval()
    c_sa = sum(m[-1] for m in sa_cfg["mlps"])
    lfp = seeded_msg(LFPModuleMSG(lfp_cfg["mlps"], lfp_cfg["post"], in_dim=c_sa, skip_dim=0,
                                  radii=lfp_cfg["radii"], nsamples=lfp_cfg["nsamples"]), DATA_SEED + 1).eval()
    x_cpu = torch.from_numpy(clouds[:B_KERNELS])

    def forward(x):
        new_xyz, feat, inds, _ = sa(x)
        up, _ = lfp(x[:, : lfp_cfg["targets"]], new_xyz, None, feat)
        return new_xyz, feat, inds, up

    with torch.inference_mode():
        want = forward(x_cpu)
    sa.cuda(), lfp.cuda()
    x = x_cpu.cuda()
    with torch.inference_mode():
        kernels.reset_launches()
        got = forward(x)
        torch.cuda.synchronize()
        launches = kernels.launches()
        expected = {**{k: 0 for k in launches}, "fps_chain": 1,
                    "ball_query": len(sa_cfg["radii"]) + len(lfp_cfg["radii"])}
        if launches != expected:
            raise AssertionError(f"msg: launches {launches}, expected {expected}")
        inds = ops.furthest_point_sample(x, sa_cfg["npoint"])
        if not torch.equal(inds, kfps.fps_plain(x, sa_cfg["npoint"])):
            raise AssertionError("msg: FPS indices differ from the plain version on the card")
        new_xyz = ops.gather_points(x, inds)
        calls = [(x, new_xyz, r, ns) for r, ns in zip(sa_cfg["radii"], sa_cfg["nsamples"])]
        calls += [(new_xyz, x[:, : lfp_cfg["targets"]], r, ns) for r, ns in zip(lfp_cfg["radii"], lfp_cfg["nsamples"])]
        for args in calls:
            if not torch.equal(kquery.ball_query(*args), kquery.ball_query_plain(*args)):
                raise AssertionError(f"msg: ball query r={args[2]} ns={args[3]} differs from the plain version")
        if not (torch.equal(got[2].cpu(), want[2]) and torch.equal(got[0].cpu(), want[0])):
            raise AssertionError("msg: card and CPU sample different centres")
        # feature_err raises past FEATURE_TOL x max(1, scale) or at a non-finite value
        errs = {"sa_features": feature_err(got[1].cpu(), want[1]), "lfp_features": feature_err(got[3].cpu(), want[3])}
        ms = cuda_ms(lambda: forward(x), 10)
    log(phase="msg", sa=sa_cfg, lfp=lfp_cfg, b=B_KERNELS, n=N_POINTS, launches=launches, card_vs_cpu=errs,
        bound=FEATURE_TOL, indices_equal_plain=True, forward_ms=ms,
        out_shapes=[list(got[1].shape), list(got[3].shape)], phase_s=time.perf_counter() - t_phase)
    return launches


def verify_checkpoint_phase() -> dict:
    """Phase 24: scripts/verify_checkpoint.py on the card.  A fabricated
    reference-layout .tar at GraspNetConfig() (`checkpoint.reference_state_dict`
    of the seed-1 weights: every seed objectness-positive, as phase 3's
    WEIGHT_SEED) and a synthetic RGB-D frame in the example-data layout
    (`write_demo_frame`, DEMO_FRAME pixels); the golden is the script's
    frame_rows on the CPU, (50, 17) pre-NMS rows.  The script in-process on
    the card must PASS (its audit line equal counts), its launches counted
    (the warm-up and the frame: two forwards); in a child process with one
    row of the golden perturbed it must exit 1 with FAIL.  Returns the
    launches of the PASS run."""
    import contextlib
    import io

    from graspnet_tpu_torch import checkpoint
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.models import GraspNet, init_weights
    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.scripts import verify_checkpoint
    from graspnet_tpu_torch.utils.synthetic import write_demo_frame

    t_phase = time.perf_counter()
    cfg = GraspNetConfig()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_verify_") as tmp:
        state = init_weights(GraspNet(cfg), WEIGHT_SEED).state_dict()
        tar = os.path.join(tmp, "checkpoint-rs.tar")
        torch.save({"model_state_dict": checkpoint.reference_state_dict(state), "epoch": 0}, tar)
        frame = os.path.join(tmp, "example_data")
        write_demo_frame(frame, np.random.default_rng(VERIFY_FRAME_SEED), *DEMO_FRAME)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            golden = verify_checkpoint.frame_rows(state, frame, cfg, 50, -1.0, "cpu")
        cpu_s = time.perf_counter() - t0
        if golden.shape != (50, 17):
            raise AssertionError(f"verify_checkpoint: the CPU golden holds {golden.shape} rows")
        paths = {name: os.path.join(tmp, f"{name}.npy") for name in ("golden", "perturbed")}
        np.save(paths["golden"], golden)
        bad = golden.copy()
        bad[7, 0] += 1e-3
        np.save(paths["perturbed"], bad)
        argv = ["--checkpoint", tar, "--data_dir", frame, "--device", "cuda"]
        out = io.StringIO()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = verify_checkpoint.main(argv + ["--golden", paths["golden"]])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = kernels.launches()
        text = out.getvalue()
        n = sum(v.numel() for v in state.values())
        expected = {**{k: 0 for k in launches}, "fps_chain": 2, "ball_query": 6, "sa1_fused": 2, "crop_fused": 2}
        if rc != 0 or "PASS: matches golden dump" not in text or f"converted params: {n:,} values (state dict: " \
                f"{n:,})" not in text or launches != expected:
            raise AssertionError(f"verify_checkpoint on the card: rc {rc}, launches {launches} (expected "
                                 f"{expected}):\n{text}")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "graspnet_tpu_torch.scripts.verify_checkpoint", *argv,
                               "--golden", paths["perturbed"]], cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=VERIFY_TIMEOUT_S)
        child_s = time.perf_counter() - t0
        if proc.returncode != 1 or "FAIL: 1 entries exceed atol=0.0001" not in proc.stdout:
            raise AssertionError(f"verify_checkpoint, perturbed golden: rc {proc.returncode}\n{proc.stdout[-2000:]}"
                                 f"\n{proc.stderr[-2000:]}")
    diff_line = next(line for line in text.splitlines() if line.startswith("max abs diff"))
    log(phase="verify_checkpoint", frame=list(DEMO_FRAME), params=n, card_vs_cpu_golden=diff_line, passed=True,
        perturbed_rc=proc.returncode, min_score_gap_top50=float(np.min(-np.diff(golden[:, 0]))),
        launches=launches, cpu_golden_s=cpu_s, card_run_s=card_s, child_s=child_s,
        phase_s=time.perf_counter() - t_phase)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU", file=sys.stderr)
        return 2

    from graspnet_tpu_torch.apps import GraspPipeline
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.ops.cuda import build
    from graspnet_tpu_torch.utils.synthetic import tabletop_cloud

    smi = nvidia_smi()
    t0 = time.perf_counter()
    nvcc_out = build.build_all()
    build_s = time.perf_counter() - t0
    log(phase="environment", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s)
    log(phase="build", kernels=[r for name, out in nvcc_out.items() for r in ptxas_records(name, out)])

    cfg = GraspNetConfig()
    pipe = GraspPipeline(cfg=cfg, seed=WEIGHT_SEED)  # default device: the card
    rng = np.random.default_rng(DATA_SEED)
    clouds = np.stack([tabletop_cloud(rng) for _ in range(4)])
    dev = pipe.device
    cloud_b = torch.from_numpy(clouds[:B_KERNELS]).to(dev)
    with torch.inference_mode():
        rows = kernel_phase(cfg, pipe.model, cloud_b)
        rows += query_sa_kernel_phase(cfg, pipe.model, cloud_b)
    launches, timing = main_path_phase(cfg, pipe, clouds)
    profile_phase(pipe, clouds)
    del pipe
    feature_launches = feature_input_phase()
    from graspnet_tpu_torch.models import GraspNet, init_weights

    crop_mlp = init_weights(GraspNet(cfg), TRAIN_SEED).crop.mlp.to(dev)
    rows += train_kernel_phase(cfg, crop_mlp, cloud_b)
    train_launches, train_timing, full, compact = train_phase(cfg, clouds[:B_KERNELS])
    scatter_rows, cli_timing = train_cli_phase(cfg, clouds[:B_KERNELS], full)
    rows += scatter_rows
    train_timing.update(cli_timing)
    ddp_launches = ddp_train_phase(cfg, full, compact)
    hybrid_launches = hybrid_train_phase(cfg, compact)
    del full, compact
    msg_launches = msg_phase(clouds)
    verify_launches = verify_checkpoint_phase()
    route_forward_launches, route_step_launches = crop_routes_phase(clouds)
    tolerance = tolerance_phase()
    tool_launches, tool_records = tools_phase()
    eval_pipe = GraspPipeline(cfg=cfg, seed=WEIGHT_SEED)
    collision = collision_phase(eval_pipe)
    del eval_pipe
    eval_timing = test_app_phase(cfg)
    eval_launches = eval_timing.pop("launches_per_batch")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_weights_") as wdir:
        from graspnet_tpu_torch import checkpoint

        ckpt = os.path.join(wdir, f"seed{WEIGHT_SEED}.pt")  # seed 1: the service's replies carry grasps
        checkpoint.save(ckpt, init_weights(GraspNet(cfg), WEIGHT_SEED).state_dict())
        service = service_phase(ckpt)
        service_launches = service.pop("launches_per_dispatch")
        demos = demos_phase(ckpt)
        parallel = parallel_infer_phase(clouds, ckpt)
        parallel_launches = parallel.pop("launches")
    gate = learnability_phase()
    # the counts read after one serving forward, one training step, one tool
    # run, one eval batch, one feature-input forward, one service dispatch
    # (the same at max_batch 1 and at the MicroBatcher's bucket of 8), the
    # two-layer crop MLP's forward and training probe, the three mesh
    # forwards of parallel_infer together, the one-rank NCCL step, one
    # rank's step of the two-rank run and of the 2 x 2 hybrid run, one MSG
    # forward and one verify_checkpoint run
    columns = {"launches_per_forward": launches, "launches_per_train_step": train_launches,
               "launches_per_tool_run": tool_launches, "launches_per_eval_batch": eval_launches,
               "launches_per_feature_forward": feature_launches,
               "launches_per_service_dispatch": service_launches,
               "launches_per_crop_routes_forward": route_forward_launches,
               "launches_per_crop_routes_probe": route_step_launches,
               "launches_per_parallel_infer": parallel_launches,
               "launches_per_ddp1_step": ddp_launches["one_rank_step"],
               "launches_per_ddp2_rank_step": ddp_launches["rank_step"],
               "launches_per_hybrid_rank_step": hybrid_launches,
               "launches_per_msg_forward": msg_launches,
               "launches_per_verify_run": verify_launches}
    for r in rows:
        for col, counts in columns.items():
            r[col] = counts[r["name"]]
        r["launches"] = sum(r[col] for col in columns)
    keys = ("name", "route", "source", "replaces", "launches", *columns, "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}), flush=True)
    log(phase="summary", gpu=smi, **timing, **train_timing, bench=tool_records["bench"],
        collision_ms_per_frame=collision["ms_per_frame"], **eval_timing, **service, **demos, **tolerance,
        **parallel, **{f"gate_{k}": v for k, v in gate.items()})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--deterministic-steps"]:
        sys.exit(deterministic_steps(sys.argv[2]))
    sys.exit(main())
