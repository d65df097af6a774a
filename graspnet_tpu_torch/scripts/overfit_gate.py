"""Overfit convergence gate, the counterpart of `scripts/overfit_gate.py`.

    python -m graspnet_tpu_torch.scripts.overfit_gate [--tiny] [--device cuda|cpu] [--steps N]

Trains on a fixed 4-frame synthetic dataset (`data/synthetic.py`: object
blobs on a table plane) through the dataset, its loader and the compact
label step, and requires within a step budget both a total loss below an
absolute threshold and a stage-1 objectness accuracy above one.  A subtly
wrong BN update or a biased gradient still lets the loss fall, but keeps
the model from memorizing 4 frames.  `--tiny` is the CPU twin
(`GraspNetConfig.tiny()`, small frames, 240 steps, loss < 4); the default
is `GraspNetConfig()` on the card (120 steps, loss < 3).  The JAX
package's thresholds, calibrated with ~2x margin on its healthy runs.
Prints one JSON line and the trajectory; exits 1 without convergence.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.data.dataset import DataLoader
from graspnet_tpu_torch.data.synthetic import SyntheticGraspNetDataset
from graspnet_tpu_torch.device import resolve_device
from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer


def run(tiny: bool, device, steps: Optional[int] = None, loss_thresh: Optional[float] = None,
        acc_thresh: float = 0.9) -> dict:
    """Train until both thresholds hold or the budget runs out; returns
    {converged, converged_at_step, loss, objectness_acc, trajectory, ...}."""
    device = resolve_device(device, "overfit_gate")
    if tiny:
        cfg = GraspNetConfig.tiny()
        ds = SyntheticGraspNetDataset(n_frames=4, n_objects=3, label_points=48, cloud_points=2048,
                                      num_points=cfg.num_point, cfg=cfg, augment=False, seed=7)
        budget, thresh = steps or 240, 4.0 if loss_thresh is None else loss_thresh
    else:
        cfg = GraspNetConfig()
        ds = SyntheticGraspNetDataset(n_frames=4, cfg=cfg, augment=False, seed=7)
        budget, thresh = steps or 120, 3.0 if loss_thresh is None else loss_thresh
    trainer = Trainer(cfg=cfg, tc=TrainConfig(batch_size=2), seed=0, device=device)
    trainer.set_epoch(0)
    loader = DataLoader(ds, 2, shuffle=False, num_workers=2)
    step, hist = 0, []
    t0 = time.perf_counter()
    converged = False
    while step < budget and not converged:
        for batch in loader:  # fixed frames: epoch 0 sampling, no augmentation
            loss, metrics = trainer.step_compact(batch)
            step += 1
            if step >= budget:
                break
        loss_v, acc_v = float(loss), float(metrics["stage1_objectness_acc"])
        hist.append((step, round(loss_v, 3), round(acc_v, 3)))
        converged = loss_v < thresh and acc_v > acc_thresh
    return {
        "metric": "overfit gate",
        "converged": converged,
        "converged_at_step": step if converged else None,
        "loss": loss_v,
        "objectness_acc": acc_v,
        "loss_thresh": thresh,
        "acc_thresh": acc_thresh,
        "steps": step,
        "wall_s": time.perf_counter() - t0,
        "trajectory": hist,
        "backend": device.type,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true", help="GraspNetConfig.tiny() (the CPU twin)")
    ap.add_argument("--steps", type=int, default=None, help="step budget")
    ap.add_argument("--loss_thresh", type=float, default=None)
    ap.add_argument("--acc_thresh", type=float, default=0.9)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run(args.tiny, args.device, args.steps, args.loss_thresh, args.acc_thresh)
    print(json.dumps({k: v for k, v in result.items() if k != "trajectory"}), flush=True)
    print(f"trajectory (step, loss, objectness_acc): {result['trajectory']}")
    if result["converged"]:
        print("OK: overfit gate converged")
        return 0
    print(f"FAIL: no convergence to loss<{result['loss_thresh']} and acc>{args.acc_thresh} "
          f"within {result['steps']} steps")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
