"""Validate a converted reference checkpoint end to end.

Counterpart of `scripts/verify_checkpoint.py`.  Given the published torch
checkpoint (`checkpoint-rs.tar` / `checkpoint-kn.tar`, reference
README.md:74-83), it

  1. converts it with `checkpoint.load_torch_checkpoint` and prints the
     parameter-count audit (the converted values against the state dict's,
     torch's `num_batches_tracked` counters left out);
  2. runs the example frame (the reference `doc/example_data` layout)
     through `apps/image_demo.load_frame` -> `GraspPipeline.sample_cloud`
     -> `run(nms=False, top_k=K)` and prints the first grasps;
  3. with `--golden`, a (K, 17) .npy of pre-NMS rows from the reference
     implementation, compares row by row within `--atol` and exits 1 on a
     FAIL: the "bit-matched top-50" gate.

    python -m graspnet_tpu_torch.scripts.verify_checkpoint --checkpoint checkpoint-rs.tar \\
        --data_dir /path/to/doc/example_data [--golden ref_top50.npy] [--device cuda|cpu]

Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def frame_rows(state, data_dir: str, cfg, top_k: int = 50, collision_thresh: float = -1.0,
               device: str = "cuda") -> np.ndarray:
    """The frame in `data_dir` through the pipeline with these weights: its
    (<= top_k, 17) score-sorted rows before NMS."""
    from graspnet_tpu_torch.apps.image_demo import load_frame
    from graspnet_tpu_torch.apps.pipeline import GraspPipeline

    pipe = GraspPipeline(params=state, cfg=cfg, device=device)
    # nms=False: the program the run below takes (golden rows are pre-NMS)
    print(f"compile: {pipe.warmup(nms=False):.1f}s")
    scene_cloud = load_frame(data_dir)
    gg = pipe.run(pipe.sample_cloud(scene_cloud), scene_cloud=scene_cloud, collision_thresh=collision_thresh,
                  nms=False, top_k=top_k)
    return gg.grasp_group_array


def main(argv: Optional[Sequence[str]] = None, *, num_point: Optional[int] = None) -> int:
    """The script; returns its exit code.  `num_point`: the sampled cloud's
    size in place of `GraspNetConfig()`'s 20000 (for a quick run on a CPU)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True, help="reference torch .tar checkpoint")
    p.add_argument("--data_dir", required=True, help="a frame in the reference example_data layout")
    p.add_argument("--golden", default=None, help="reference top-K dump (.npy, pre-NMS rows)")
    p.add_argument("--top_k", type=int, default=50)
    p.add_argument("--collision_thresh", type=float, default=-1.0)
    p.add_argument("--atol", type=float, default=1e-4)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    from graspnet_tpu_torch import checkpoint
    from graspnet_tpu_torch.config import GraspNetConfig

    cfg = GraspNetConfig() if num_point is None else GraspNetConfig(num_point=num_point)
    # --- 1. conversion audit ----------------------------------------------
    state = checkpoint.load_torch_checkpoint(args.checkpoint, cfg)
    raw = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    sd = raw.get("model_state_dict", raw)
    n_params = sum(v.numel() for v in state.values())
    n_sd = sum(v.numel() for k, v in sd.items() if "num_batches_tracked" not in k)
    print(f"converted params: {n_params:,} values (state dict: {n_sd:,})")
    if n_params != n_sd:
        print("WARNING: parameter count mismatch — conversion may be lossy")

    # --- 2. example-frame inference ----------------------------------------
    rows = frame_rows(state, args.data_dir, cfg, args.top_k, args.collision_thresh, args.device)
    print(f"top-{args.top_k} grasps (score-sorted):")
    for g in rows[:5]:
        print(f"  score={g[0]:+.4f} width={g[1]:.4f} depth={g[3]:.3f} "
              f"center=({g[13]:+.4f},{g[14]:+.4f},{g[15]:+.4f})")

    # --- 3. golden comparison ------------------------------------------------
    if args.golden:
        golden = np.load(args.golden)
        ours = rows[: len(golden)]
        if len(ours) != len(golden):
            print(f"FAIL: row count {len(ours)} != golden {len(golden)}")
            return 1
        diff = np.abs(ours - golden)
        print(f"max abs diff vs golden: {diff.max():.2e}")
        if diff.max() > args.atol:
            print(f"FAIL: {int(np.sum(diff > args.atol))} entries exceed atol={args.atol}")
            return 1
        print("PASS: matches golden dump")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
