"""The control of `correct` for the Point Transformer V3 cell: the reference
put in the program's place and computed one precision below the
configuration's (TF32 products where it states float32 with TF32 off),
judged by the same comparison as a run (`reference/ptv3.py::compare` and
`order_diff`).  Its readings set the upper end of the `logit_gap` limit; a
run never computes it.

    python3 benchmark/control_ptv3.py --workload infer.ptv3_scannet_b4 --seeds 11 12 13

prints one JSON line a seed with the numbers a run compares.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.drivers import segment_ptv3 as driver  # noqa: E402
from benchmark.reference import judge, ptv3  # noqa: E402


def readings(cell: str, seed: int, device: str = "cuda", overrides=None) -> dict:
    """The numbers a run of `cell` at `seed` compares, with the control in
    the program's place, over the batches a run checks."""
    import numpy as np
    import torch

    workload = harness.load_json("workloads", cell)
    config = harness.load_json("configs", workload["config"])
    ctx = harness.Context(cell=cell, workload=workload, config=config, seed=seed, seconds=0.0, trace=False,
                          device=device, tmp="", t_start=0.0, overrides=overrides or {})
    model = ptv3.PTv3(driver.reference_config(ctx), driver.weights(ctx), device)
    totals = {"logit_gap": 0.0, "label_diff": 0, "order_diff": 0}
    for frags in driver.batches(ctx)[: int(ctx.traffic["check_batches"])]:
        grid = torch.from_numpy(np.concatenate([f[1] for f in frags])).long().to(device)
        batch = torch.repeat_interleave(torch.arange(len(frags), device=device),
                                        torch.tensor([len(f[1]) for f in frags], device=device))
        feat = torch.from_numpy(np.concatenate([f[2] for f in frags])).to(device)
        with judge.precision("tf32"):
            low = model.forward(grid, batch, feat)
        with judge.precision("float32"):
            want = model.forward(grid, batch, feat)
        got = ptv3.compare(low["logits"], low["logits"].argmax(dim=1), want["logits"], ctx.limits["logit_gap"])
        totals["logit_gap"] = max(totals["logit_gap"], got["logit_gap"])
        totals["label_diff"] += got["label_diff"]
        totals["order_diff"] += ptv3.order_diff(low, want)
    return {"cell": cell, "seed": seed, **totals}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
