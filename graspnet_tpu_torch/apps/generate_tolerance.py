"""Offline tolerance-label generation CLI.

Counterpart of `graspnet_tpu/apps/generate_tolerance.py` (reference
dataset/generate_tolerance_label.py, `python generate_tolerance_label.py
--dataset_root ... --num_workers 50`): reads
`{dataset_root}/grasp_label/{obj:03d}_labels.npz` for each object and writes
`{save_dir}/{obj:03d}_tolerance.npy` with the (P, V, A, D) tolerance labels,
one batched computation an object (`data/tolerance.py`) instead of the
reference's pool of one python worker a label point.

    python -m graspnet_tpu_torch.apps.generate_tolerance --dataset_root /data/graspnet

Runs on CUDA unless `--device cpu` is passed.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np

from graspnet_tpu_torch.data.tolerance import generate_tolerance


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset_root", required=True, help="GraspNet-1B root")
    p.add_argument("--save_dir", default=None, help="output dir (default: {dataset_root}/tolerance)")
    p.add_argument("--pos_ratio_thresh", type=float, default=0.8,
                   help="positive-neighbor ratio threshold [reference default 0.8]")
    p.add_argument("--mu_thresh", type=float, default=0.55,
                   help="friction coefficient threshold [reference default 0.55]")
    p.add_argument("--num_objects", type=int, default=88)
    p.add_argument("--objects", default=None, help="comma-separated object ids (default: all present)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    save_dir = args.save_dir or os.path.join(args.dataset_root, "tolerance")
    os.makedirs(save_dir, exist_ok=True)
    label_path = lambda i: os.path.join(args.dataset_root, "grasp_label", f"{i:03d}_labels.npz")  # noqa: E731
    if args.objects:
        obj_ids = [int(x) for x in args.objects.split(",")]
    else:
        obj_ids = [i for i in range(args.num_objects) if os.path.exists(label_path(i))]
    for i in obj_ids:
        t0 = time.time()
        label = np.load(label_path(i))
        tol = generate_tolerance(label["points"].astype(np.float32), label["scores"].astype(np.float32),
                                 pos_ratio_thresh=args.pos_ratio_thresh, mu_thresh=args.mu_thresh,
                                 device=args.device)
        out = os.path.join(save_dir, f"{i:03d}_tolerance.npy")
        np.save(out, tol)
        print(f"object {i:03d}: {tol.shape} -> {out} ({time.time() - t0:.1f}s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
