"""Side-by-side timing of the deterministic scatter-add's plan and segment
sum at a training step's five calls, in several checkouts of the port, on
one card.

    python3 -m graspnet_tpu_torch.scripts.ab_scatter --trees OLD . . OLD [--out FILE]

Each tree (a directory holding a `graspnet_tpu_torch/`: a `git archive` of
another commit, or a copy whose `csrc/scatter.cu` was edited to try a
variant) runs in a process of its own, in the order given.  The five calls
are the gathers of one training-mode backbone forward at GraspNetConfig()
(random weights, seed 0) on two seeded tabletop clouds of 20000 points:
SA2-4's `group_points` and FP1-2's `three_interpolate`, each recorded with
its input's shape and its indices; the gradients are seeded normals.  Per
call, in microseconds:

  * `plan_device_us`, `sum_device_us`, `index_add_device_us`: the device
    time of every operation one call of `scatter_plan`, `scatter_add_rows`
    (on that plan) and `torch.index_add` (its yardstick) launches, from
    torch.profiler, the median over 20 calls with a synchronize after each;
  * `plan_host_us`, `sum_host_us`, `index_add_host_us`: the host's time to
    enqueue one call, the median of 5 windows of 20 calls;

and per step, in ms, `plan_event_ms`, `sum_event_ms`, `index_add_event_ms`:
the five calls in a Python loop between two CUDA events, the median of 20
(what `chip_smoke.py` reports); `backbone_event_ms` and
`backbone_device_ms`: one training-mode backbone forward and the backward
of a loss on its seed features, which makes the five plans and sums among
~300 other operations, event-timed (median of 20) and its device time per
pass (torch.profiler, 5 passes); and `on_device_host_us`, the launchers'
device helper alone.  Every run holds the sum bitwise against the CPU's
sequential sum, and, where the tree has `scatter_plan_plain`, the plan
bitwise against it on the CPU.  The JSON line adds the card's name and
power limit; `--out` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPS = 20


def capture_calls(scatter, backbone, cloud: torch.Tensor) -> list:
    """(C, idx, n) of each gather that makes a plan in one training-mode
    forward of `backbone`."""
    calls, real = [], scatter._plan

    def plan(points, idx):
        if points.requires_grad and torch.is_grad_enabled():  # as `_plan` makes one on the card
            calls.append((points.shape[2], idx.clone(), points.shape[1]))
        return real(points, idx)

    scatter._plan = plan
    try:
        backbone(cloud, train=True)
    finally:
        scatter._plan = real
    return calls


def device_us(fn) -> float:
    """Median device time of one fn() call over REPS calls, every device
    operation it launches, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
            torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    if not events:
        return float("nan")
    per_call = np.array_split(np.array([d for _, d in events]), REPS)
    return statistics.median(float(p.sum()) for p in per_call)


def host_us(fn) -> float:
    """Median over 5 windows of the host's time to enqueue one fn() call."""
    fn()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / REPS)
    torch.cuda.synchronize()
    return statistics.median(times)


def measure(tree: str, data: str) -> None:
    """One run, in a process of its own: the port of `tree` on the clouds in
    `data`; times to stdout as JSON."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import graspnet_tpu_torch
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.models import GraspNet, init_weights
    from graspnet_tpu_torch.ops import scatter
    from graspnet_tpu_torch.ops.cuda import build
    from graspnet_tpu_torch.scripts.ab_ball_kernels import device_ms, event_ms

    build.build_all(("scatter", "fps", "query", "crop"))
    backbone = init_weights(GraspNet(GraspNetConfig()), 0).backbone.to("cuda")
    calls = capture_calls(scatter, backbone, torch.from_numpy(np.load(data)).to("cuda"))
    rng = np.random.default_rng(0)
    args = []
    for c, idx, n in calls:
        g = torch.from_numpy(rng.standard_normal((*idx.shape, c)).astype(np.float32)).to("cuda")
        args.append((g, idx, n, scatter.scatter_plan(idx, n)))
    run = {"tree": tree, "package": str(Path(graspnet_tpu_torch.__file__).parent), "calls": []}
    for g, idx, n, plan in args:
        got = scatter.scatter_add_rows(g, idx, n, plan)
        if not torch.equal(got.cpu(), scatter.scatter_add_rows_plain(g.cpu(), idx.cpu(), n)):
            raise AssertionError(f"{tree}: the sum at {tuple(g.shape)} -> {n} is not the CPU's")
        if hasattr(scatter, "scatter_plan_plain"):
            want = scatter.scatter_plan_plain(idx.cpu(), n)
            if not all(torch.equal(a.cpu(), b) for a, b in zip(plan, want)):
                raise AssertionError(f"{tree}: the plan at {tuple(idx.shape)} -> {n} is not the plain plan")
        rows = (idx + n * torch.arange(idx.shape[0], device="cuda")[:, None]).reshape(-1)
        z = torch.zeros(idx.shape[0] * n, g.shape[2], device="cuda")
        g2 = g.reshape(-1, g.shape[2])
        fns = {"plan": lambda: scatter.scatter_plan(idx, n), "sum": lambda: scatter.scatter_add_rows(g, idx, n, plan),
               "index_add": lambda: torch.index_add(z, 0, rows, g2)}
        segs = plan[1][1:] - plan[1][:-1]
        row = {"g": list(g.shape), "n": n, "longest_segment": int(segs.max()), "empty_rows": int((segs == 0).sum())}
        for name, fn in fns.items():
            row[f"{name}_device_us"] = device_us(fn)
            row[f"{name}_host_us"] = host_us(fn)
        run["calls"].append(row)
    flat = [((g, idx, n, plan), (idx + n * torch.arange(idx.shape[0], device="cuda")[:, None]).reshape(-1),
             torch.zeros(idx.shape[0] * n, g.shape[2], device="cuda")) for g, idx, n, plan in args]
    run["plan_event_ms"] = event_ms(lambda: [scatter.scatter_plan(i, n) for _, i, n, _ in args], REPS)
    run["sum_event_ms"] = event_ms(lambda: [scatter.scatter_add_rows(*a) for a in args], REPS)
    run["index_add_event_ms"] = event_ms(
        lambda: [torch.index_add(z, 0, r, a[0].reshape(-1, a[0].shape[2])) for a, r, z in flat], REPS)

    cloud = torch.from_numpy(np.load(data)).to("cuda")

    def backbone_pass():
        backbone(cloud, train=True)[0].square().mean().backward()

    run["backbone_event_ms"] = event_ms(backbone_pass, REPS)
    run["backbone_device_ms"] = device_ms(backbone_pass, 5)

    def on_device():
        with build.on_device(args[0][0].device):
            pass

    run["on_device_host_us"] = host_us(on_device)
    for key in ("plan_device_us", "sum_device_us", "index_add_device_us"):
        run[key.replace("_us", "_ms_per_step")] = sum(c[key] for c in run["calls"]) / 1e3
    print(json.dumps(run))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True, help="checkouts to run, in order")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_scatter times CUDA kernels and needs a card")
    from graspnet_tpu_torch.utils.synthetic import tabletop_cloud
    from graspnet_tpu_torch.utils.timing import gpu_name_and_power

    rng = np.random.default_rng(0)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        data = str(Path(tmp) / "clouds.npy")
        np.save(data, np.stack([tabletop_cloud(rng) for _ in range(2)]))
        for i, tree in enumerate(args.trees):
            proc = subprocess.run([sys.executable, __file__, "--child", tree, data],
                                  capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError(f"run {i} ({tree}) failed:\n{proc.stdout}\n{proc.stderr}")
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    result = {"runs": runs, "gpu": gpu_name_and_power(), "source": "graspnet_tpu_torch/scripts/ab_scatter.py"}
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    return result


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        measure(*sys.argv[2:4])
    else:
        main()
