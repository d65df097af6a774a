"""Side-by-side timing of the first-hits ball scan (K4), the fused SA1
stage (K3) and the CloudCrop (K5, which shares K3's MLP kernel) in several
checkouts of the port, on one card.

    python3 -m graspnet_tpu_torch.scripts.ab_ball_kernels --trees OLD . . OLD [--out FILE]

Each tree (a directory holding a `graspnet_tpu_torch/`, e.g. a `git
archive` of the parent commit) runs in a process of its own, in the order
given, on the same seeded tabletop clouds (B=2, 20000 points) and the
same random weights.  Per run, CUDA-event medians in ms:

  * `ball_query_sa1_b2`: K4 at the SA1 training shape (2048 centres x 20000
    points, r 0.04, ns 64), as `Trainer.prepare` makes the call;
  * `ball_query_serving_b2`: K4's three serving calls (SA2-4) summed;
  * `sa1_fused_b2` and `sa1_fused_b1`: K3;
  * `crop_fused_b2`: K5 at its serving shape (1024 seeds x 4 depths,
    random approach views);
  * the K4 rows again as `..._chained`: 20 calls back to back between the
    events, over 20, so the host's launch time overlaps the device's;
  * K4, K3 and K5 as `..._device`: the kernels' own device time per call
    under torch.profiler (10 calls), free of the host's launch time, which
    one call's events hold and which the small serving calls are made of.

Every run's outputs are held against the first run's: indices equal,
features (K3, K5) within 1e-4 x max(1, scale).  Prints one JSON line with the runs
and the card's name and power limit; `--out` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

FEATURE_TOL = 1e-4


def event_ms(fn, reps: int, chain: int = 1) -> float:
    """Median of `reps` CUDA-event timings of `chain` calls of fn() back to
    back, over `chain`, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(chain):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / chain)
    return statistics.median(times)


def device_ms(fn, reps: int = 10) -> float:
    """Device time of the CUDA kernels fn() launches, per call, from
    torch.profiler over `reps` calls after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3


def measure(tree: str, data: str, out: str) -> None:
    """One run, in a process of its own: the port of `tree` on the clouds
    in `data`; times to stdout as JSON, outputs to `out`."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import graspnet_tpu_torch
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.models import GraspNet, geometry, init_weights
    from graspnet_tpu_torch.nn.layers import fold_bn_eval
    from graspnet_tpu_torch.ops.cuda import ball_query, crop_fused, fps_chain, sa1_fused

    cfg = GraspNetConfig()
    dev = torch.device("cuda")
    cloud = torch.from_numpy(np.load(data)).to(dev)
    sas = (cfg.sa1, cfg.sa2, cfg.sa3, cfg.sa4)
    with torch.inference_mode():
        xyz = [cloud]
        for idx in fps_chain(cloud, tuple(sa.npoint for sa in sas)):
            xyz.append(torch.gather(xyz[-1], 1, idx[..., None].expand(-1, -1, 3)))
        model = init_weights(GraspNet(cfg), 1).to(dev)
        folded = fold_bn_eval(model.backbone.sa1.mlp)
        seeds = xyz[2]
        pick = torch.randint(0, cfg.num_view, seeds.shape[:2], generator=torch.Generator().manual_seed(0))
        rot = geometry.batch_viewpoint_params_to_matrix(
            -geometry.generate_grasp_views(cfg.num_view, dev)[pick.to(dev)], torch.zeros(seeds.shape[:2], device=dev))
        crop = (cloud, seeds, rot, fold_bn_eval(model.crop.mlp), cfg.cylinder_radius, cfg.hmin,
                tuple(cfg.hmax_list), cfg.crop_nsample)
        calls = [(xyz[k], xyz[k + 1], sa.radius, sa.nsample) for k, sa in enumerate(sas)]
        sa1 = (cloud, xyz[1], folded, cfg.sa1.radius, cfg.sa1.nsample)
        sa1_b1 = tuple(t[:1] if isinstance(t, torch.Tensor) else t for t in sa1)
        outs = {f"ball_query_{k}": ball_query(*c) for k, c in enumerate(calls)}
        outs["sa1_fused"] = sa1_fused(*sa1)
        outs["crop_fused"] = crop_fused(*crop)
        times = {
            "ball_query_sa1_b2": event_ms(lambda: ball_query(*calls[0]), 50),
            "ball_query_serving_b2": sum(event_ms(lambda c=c: ball_query(*c), 50) for c in calls[1:]),
            "sa1_fused_b2": event_ms(lambda: sa1_fused(*sa1), 30),
            "sa1_fused_b1": event_ms(lambda: sa1_fused(*sa1_b1), 30),
            "crop_fused_b2": event_ms(lambda: crop_fused(*crop), 30),
            "ball_query_sa1_b2_chained": event_ms(lambda: ball_query(*calls[0]), 10, 20),
            "ball_query_serving_b2_chained": sum(event_ms(lambda c=c: ball_query(*c), 10, 20) for c in calls[1:]),
            "ball_query_sa1_b2_device": device_ms(lambda: ball_query(*calls[0])),
            "ball_query_serving_b2_device": device_ms(lambda: [ball_query(*c) for c in calls[1:]]),
            "sa1_fused_b2_device": device_ms(lambda: sa1_fused(*sa1)),
            "crop_fused_b2_device": device_ms(lambda: crop_fused(*crop)),
        }
    torch.save({k: v.cpu() for k, v in outs.items()}, out)
    print(json.dumps({"tree": tree, "package": str(Path(graspnet_tpu_torch.__file__).parent), "ms": times}))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True, help="checkouts to run, in order")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_ball_kernels times CUDA kernels and needs a card")
    from graspnet_tpu_torch.utils.synthetic import tabletop_cloud
    from graspnet_tpu_torch.utils.timing import gpu_name_and_power

    rng = np.random.default_rng(0)
    runs, first = [], None
    with tempfile.TemporaryDirectory() as tmp:
        data = str(Path(tmp) / "clouds.npy")
        np.save(data, np.stack([tabletop_cloud(rng) for _ in range(2)]))
        for i, tree in enumerate(args.trees):
            out = str(Path(tmp) / f"run{i}.pt")
            proc = subprocess.run([sys.executable, __file__, "--child", tree, data, out],
                                  capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError(f"run {i} ({tree}) failed:\n{proc.stdout}\n{proc.stderr}")
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            got = torch.load(out)
            first = first or got
            for k, want in first.items():
                if k.startswith("ball_query") and not torch.equal(got[k], want):
                    raise AssertionError(f"run {i} ({tree}): {k} indices differ from run 0")
            for k in ("sa1_fused", "crop_fused"):
                err = (got[k] - first[k]).abs().max().item()
                if err > FEATURE_TOL * max(1.0, first[k].abs().max().item()):
                    raise AssertionError(f"run {i} ({tree}): {k} differs from run 0 by {err}")
                run[f"{k}_max_abs_diff_to_run0"] = err
            runs.append(run)
            print(json.dumps(run), flush=True)
    result = {"runs": runs, "gpu": gpu_name_and_power(),
              "source": "graspnet_tpu_torch/scripts/ab_ball_kernels.py"}
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    return result


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        measure(*sys.argv[2:5])
    else:
        main()
