"""The control of `correct` for the Group-Free-3D cell: the reference put in
the program's place and computed one precision below the configuration's
(TF32 products where it states float32 with TF32 off), judged by the same
comparison as a run (`reference/gf.py::compare`).  Its readings set the
upper end of each limit; a run never computes it.

    python3 benchmark/control_groupfree.py --workload infer.groupfree_scannet_b8 --seeds 11 12 13

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
from benchmark.control_detect import as_rows  # noqa: E402
from benchmark.drivers import detect_groupfree as driver  # noqa: E402
from benchmark.reference import gf, gn, judge  # noqa: E402


def readings(cell: str, seed: int, device: str = "cuda", overrides=None) -> dict:
    """The numbers a run of `cell` at `seed` compares, with the control in
    the program's place, over the batches a run checks."""
    import torch

    workload = harness.load_json("workloads", cell)
    config = harness.load_json("configs", workload["config"])
    ctx = harness.Context(cell=cell, workload=workload, config=config, seed=seed, seconds=0.0, trace=False,
                          device=device, tmp="", t_start=0.0, overrides=overrides or {})
    weights = driver.weights(ctx, driver.program_config(ctx))
    det = driver.detector(ctx)
    ref = gf.GroupFree(harness.model_config(ctx.model_fields(), gn), det, weights, device)
    totals = {"head_gap": 0.0, "box_gap": 0.0, "selection_diff": 0}
    for clouds in driver.batches(ctx)[: int(ctx.traffic["check_batches"])]:
        x = torch.as_tensor(clouds, device=device)
        with judge.precision("tf32"):
            low = ref.forward(x)
            low_res = gf.parse_predictions(low, x[..., :3], det, ref.mean_size)
        with judge.precision("float32"):
            out = ref.forward(x, follow=low["size_cls_layers"], tie=ctx.limits["head_gap"])
            res = gf.parse_predictions(out, x[..., :3], det, ref.mean_size)
        got = gf.compare(as_rows(low_res), low["head"].cpu().numpy(), out["head"].cpu().numpy(), res, x[..., :3], det)
        for k, v in got.items():
            totals[k] = max(totals[k], v) if k.endswith("_gap") else totals[k] + v
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
