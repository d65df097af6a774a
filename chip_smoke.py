"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):
  1. environment: card name and power limit (nvidia-smi), torch and CUDA
     versions, and the parallel nvcc build of every kernel in
     graspnet_tpu_torch/csrc;
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at the production main-path shapes with B=2 on a seeded
     synthetic tabletop cloud of 20000 points — indices exactly equal,
     features within FEATURE_TOL; CUDA-event median times;
  3. main path: GraspPipeline(GraspNetConfig(), seed=1) on the card —
     get_grasps_topk at B=1 and the batched calls at B=4 give (50, 17)
     finite rows, each forward launches FPS 1, ball query 3, SA1 crop 1 and
     CloudCrop 1 times, the card's top-50 matches the same pipeline on the
     CPU, and p50 latency / sustained frames/s at B=1;
  4. a torch.profiler window over B=1 frames: device time per kernel and
     the device's idle share;
  5. the kernels line, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.

Without CUDA it exits with code 2 before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
TOPK_ATOL = 1e-4  # CPU vs card top-50 floats: CPU BLAS vs cuBLAS f32 sums
PEAK_F32_FLOPS = 67e12  # H100 SXM, non-tensor f32 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
TEST_FLOPS = {"ball": 8, "cylinder": 21}  # flops per point-center membership test


def log(**kv) -> None:
    print(json.dumps(kv), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def tabletop_cloud(rng: np.random.Generator, n: int = N_POINTS) -> np.ndarray:
    """A camera-frame tabletop: a plane at z=0.55 m with boxes and spheres
    standing on it, about 0.5 m from the camera."""
    parts = []
    n_table = n * 2 // 5
    parts.append(np.stack([rng.uniform(-0.3, 0.3, n_table), rng.uniform(-0.3, 0.3, n_table),
                           0.55 + rng.normal(0, 0.001, n_table)], 1))
    n_obj = n - n_table
    per = n_obj // 6
    for k in range(6):
        cnt = per if k < 5 else n_obj - 5 * per
        cx, cy = rng.uniform(-0.2, 0.2, 2)
        if k % 2 == 0:  # box: points on its faces
            half = rng.uniform(0.02, 0.06, 3)
            p = rng.uniform(-1, 1, (cnt, 3))
            face = rng.integers(0, 3, cnt)
            p[np.arange(cnt), face] = np.sign(p[np.arange(cnt), face])
            p = p * half + [cx, cy, 0.55 - half[2]]
        else:  # sphere
            r = rng.uniform(0.02, 0.05)
            v = rng.normal(size=(cnt, 3))
            p = v / np.linalg.norm(v, axis=1, keepdims=True) * r + [cx, cy, 0.55 - r]
        parts.append(p)
    cloud = np.concatenate(parts, 0).astype(np.float32)
    return cloud[rng.permutation(len(cloud))]


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


def nth_hit_tests(mask: torch.Tensor, ns: int) -> torch.Tensor:
    """Points a first-ns scan tests: up to and including the ns-th hit, or
    all N when there are fewer hits.  mask (..., N) -> (...) int64."""
    n = mask.shape[-1]
    rank = torch.cumsum(mask, dim=-1, dtype=torch.int32)
    target = torch.full((*rank.shape[:-1], 1), ns, dtype=torch.int32, device=mask.device)
    pos = torch.searchsorted(rank.contiguous(), target)[..., 0]
    return torch.clamp(pos + 1, max=n)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_phase(cfg, model, cloud_b):
    """Phase 2: every kernel against its plain version at main-path shapes."""
    from graspnet_tpu_torch.models import geometry
    from graspnet_tpu_torch.nn.layers import fold_bn_eval
    from graspnet_tpu_torch.ops.cuda import crop as kcrop
    from graspnet_tpu_torch.ops.cuda import fps as kfps
    from graspnet_tpu_torch.ops.cuda import query as kquery
    from graspnet_tpu_torch.ops.query import ball_mask, cylinder_masks

    dev = cloud_b.device
    rows = []

    def feature_err(got, want):
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        if not torch.isfinite(got).all() or err > FEATURE_TOL * scale:
            raise AssertionError(f"features differ: max abs {err} at scale {scale}")
        return err

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
    t_bound, by = bound(flops, cloud_b.numel() * 4 + b * sum(npoints) * 8)
    rows.append(dict(
        name="fps_chain", route="cuda", source="graspnet_tpu_torch/csrc/fps.cu",
        replaces="graspnet_tpu/ops/pallas/fps.py:242 (fps_chain_pallas) + fps.py:161 (fps_pallas)",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: kfps.fps_chain(cloud_b, npoints), 10),
        plain_ms=cuda_ms(lambda: kfps.fps_chain_plain(cloud_b, npoints), 2),
        bound_ms=t_bound, bound_by=by, library_ms=None,
    ))

    # stage point sets of the main path
    xyz = [cloud_b]
    for idx in got:
        xyz.append(torch.gather(xyz[-1], 1, idx[..., None].expand(-1, -1, 3)))

    # -- ball query (K4), SA2-4 --
    calls = [(xyz[k], xyz[k + 1], sa.radius, sa.nsample)
             for k, sa in ((1, cfg.sa2), (2, cfg.sa3), (3, cfg.sa4))]
    flops = nbytes = 0
    for args in calls:
        g, w = kquery.ball_query(*args), kquery.ball_query_plain(*args)
        if not torch.equal(g, w):
            raise AssertionError(f"ball_query indices differ for r={args[2]}")
        flops += nth_hit_tests(ball_mask(args[0], args[1], args[2]), args[3]).sum().item() * TEST_FLOPS["ball"]
        nbytes += (args[0].numel() + args[1].numel()) * 4 + w.numel() * 8
    t_bound, by = bound(flops, nbytes)
    rows.append(dict(
        name="ball_query", route="cuda", source="graspnet_tpu_torch/csrc/query.cu",
        replaces="graspnet_tpu/ops/pallas/query.py:554 (ball_query_pallas -> multi_query_batched_pallas)",
        max_abs_err=0.0,
        ms=sum(cuda_ms(lambda a=a: kquery.ball_query(*a), 20) for a in calls),
        plain_ms=sum(cuda_ms(lambda a=a: kquery.ball_query_plain(*a), 5) for a in calls),
        bound_ms=t_bound, bound_by=by, library_ms=None,
    ))

    def mlp_flops(folded, nrows):
        return nrows * sum(2 * w.shape[0] * w.shape[1] for w, _ in folded)

    def weight_bytes(folded):
        return sum((w.numel() + bb.numel()) * 4 for w, bb in folded)

    # -- SA1 fused (K3) --
    sa = cfg.sa1
    folded = fold_bn_eval(model.backbone.sa1.mlp)
    centers = xyz[1]
    g = kcrop.sa1_fused(cloud_b, centers, folded, sa.radius, sa.nsample)
    w = kcrop.crop_fused_plain(cloud_b, centers, None, folded, sa.radius, 0.0, (0.0,),
                               sa.nsample, 1.0 / sa.radius, True)[:, :, 0]
    err = feature_err(g, w)
    tests = sum(nth_hit_tests(ball_mask(cloud_b, centers[:, m0:m0 + 256], sa.radius), sa.nsample).sum().item()
                for m0 in range(0, centers.shape[1], 256))
    flops = tests * TEST_FLOPS["ball"] + mlp_flops(folded, centers.shape[0] * centers.shape[1] * sa.nsample)
    t_bound, by = bound(flops, (cloud_b.numel() + centers.numel() + g.numel()) * 4 + weight_bytes(folded))
    rows.append(dict(
        name="sa1_fused", route="cuda", source="graspnet_tpu_torch/csrc/crop.cu",
        replaces="graspnet_tpu/ops/pallas/crop.py:297 (sa1_fused_pallas -> crop_fused_pallas(ball=True))",
        max_abs_err=err,
        ms=cuda_ms(lambda: kcrop.sa1_fused(cloud_b, centers, folded, sa.radius, sa.nsample), 10),
        plain_ms=cuda_ms(lambda: kcrop.crop_fused_plain(
            cloud_b, centers, None, folded, sa.radius, 0.0, (0.0,), sa.nsample, 1.0 / sa.radius, True), 3),
        bound_ms=t_bound, bound_by=by, library_ms=None,
    ))

    # -- CloudCrop fused (K5) at the seeds, with approach-view rotations --
    gen = torch.Generator().manual_seed(DATA_SEED)
    seeds = xyz[2]
    views = geometry.generate_grasp_views(cfg.num_view, dev)
    pick = torch.randint(0, cfg.num_view, seeds.shape[:2], generator=gen).to(dev)
    rot = geometry.batch_viewpoint_params_to_matrix(-views[pick], torch.zeros(seeds.shape[:2], device=dev))
    folded = fold_bn_eval(model.crop.mlp)
    args = (cloud_b, seeds, rot, folded, cfg.cylinder_radius, cfg.hmin, tuple(cfg.hmax_list), cfg.crop_nsample)
    g = kcrop.crop_fused(*args)
    w = kcrop.crop_fused_plain(*args)
    err = feature_err(g, w)
    tests = 0
    for m0 in range(0, seeds.shape[1], 64):
        masks = cylinder_masks(cloud_b, seeds[:, m0:m0 + 64], rot[:, m0:m0 + 64],
                               cfg.cylinder_radius, cfg.hmin, cfg.hmax_list)
        tests += nth_hit_tests(masks, cfg.crop_nsample).amax(dim=2).sum().item()
    nrows = seeds.shape[0] * seeds.shape[1] * len(cfg.hmax_list) * cfg.crop_nsample
    flops = tests * TEST_FLOPS["cylinder"] + mlp_flops(folded, nrows)
    t_bound, by = bound(flops, (cloud_b.numel() + seeds.numel() + rot.numel() + g.numel()) * 4
                        + weight_bytes(folded))
    rows.append(dict(
        name="crop_fused", route="cuda", source="graspnet_tpu_torch/csrc/crop.cu",
        replaces="graspnet_tpu/ops/pallas/crop.py:297 (crop_fused_pallas)",
        max_abs_err=err,
        ms=cuda_ms(lambda: kcrop.crop_fused(*args), 10),
        plain_ms=cuda_ms(lambda: kcrop.crop_fused_plain(*args), 3),
        bound_ms=t_bound, bound_by=by, library_ms=None,
    ))
    for r in rows:
        log(phase="kernel", **r)
    return rows


def compare_topk(card: np.ndarray, cpu: np.ndarray) -> dict:
    """Selection fields equal (row order, height, depth, centre, object id);
    score, width and rotation within TOPK_ATOL."""
    if card.shape != cpu.shape:
        raise AssertionError(f"top-K row counts differ: card {card.shape} cpu {cpu.shape}")
    sel = [2, 3, 13, 14, 15, 16]
    if not np.array_equal(card[:, sel], cpu[:, sel]):
        bad = np.nonzero((card[:, sel] != cpu[:, sel]).any(1))[0]
        raise AssertionError(f"top-K selections differ from row {bad[0]}: card {card[bad[0]]} cpu {cpu[bad[0]]}")
    err = float(np.abs(card - cpu).max())
    if err > TOPK_ATOL:
        raise AssertionError(f"top-K floats differ by {err}")
    return {"rows": int(card.shape[0]), "max_abs_err": err}


def main_path_phase(cfg, pipe, clouds):
    """Phase 3: the serving path through the pipeline's entry points."""
    from graspnet_tpu_torch.apps import GraspPipeline
    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.postproc.nms import nms_keep_mask

    expected = {"fps_chain": 1, "ball_query": 3, "sa1_fused": 1, "crop_fused": 1}

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


def profile_phase(pipe, clouds, frames: int = 5):
    """Where a B=1 serving frame spends device time: torch.profiler over a
    few get_grasps_topk calls; the device's busy share is the summed kernel
    time over the wall time of the window."""
    from torch.profiler import ProfilerActivity, profile

    pipe.get_grasps_topk(clouds[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(frames):
            pipe.get_grasps_topk(clouds[i % len(clouds)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels.append((dev_us / frames / 1e3, ev.key[:60], ev.count // frames))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    log(phase="profile_b1", frames=frames, wall_ms_per_frame=wall_ms / frames,
        device_busy_ms_per_frame=busy if kernels else "not measured",
        device_idle_share=(1 - busy * frames / wall_ms) if kernels else "not measured",
        top=[{"kernel": k, "ms": ms, "launches": c} for ms, k, c in kernels[:15]])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU", file=sys.stderr)
        return 2

    from graspnet_tpu_torch.apps import GraspPipeline
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.ops.cuda import build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    nvcc_out = build.build_all()
    build_s = time.perf_counter() - t0
    for name, out in nvcc_out.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"nvcc {name}: {line.strip()}", flush=True)
    log(phase="environment", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s)

    cfg = GraspNetConfig()
    pipe = GraspPipeline(cfg=cfg, seed=WEIGHT_SEED)  # default device: the card
    rng = np.random.default_rng(DATA_SEED)
    clouds = np.stack([tabletop_cloud(rng) for _ in range(4)])
    dev = pipe.device
    cloud_b = torch.from_numpy(clouds[:B_KERNELS]).to(dev)
    with torch.inference_mode():
        rows = kernel_phase(cfg, pipe.model, cloud_b)
    launches, timing = main_path_phase(cfg, pipe, clouds)
    profile_phase(pipe, clouds)
    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}), flush=True)
    log(phase="summary", gpu=smi, **timing)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
