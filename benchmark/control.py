"""The control of `correct`: the reference put in the program's place and
computed one precision below the configuration's (TF32 products where the
configuration states float32 with TF32 off), judged by the same
comparison as a run.  Its readings set the upper end of each limit; a run
never computes it.

    python3 benchmark/control.py --workload infer.robot_b1 --seeds 11 12 13

prints one JSON line a seed with the numbers a run compares.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.inputs.tabletop import capture_pool  # noqa: E402
from benchmark.reference import gn, judge  # noqa: E402
from benchmark.weights import make_weights  # noqa: E402


def readings(cell: str, seed: int, device: str = "cuda", overrides=None) -> dict:
    """The numbers a run of `cell` at `seed` compares, with the control in
    the program's place."""
    workload = harness.load_json("workloads", cell)
    config = harness.load_json("configs", workload["config"])
    overrides = overrides or {}
    params = {**workload["params"], **overrides.get("params", {})}
    fields = overrides.get("model", config["model"])
    s = {**config["serving"], **params.get("serving", {})}
    cfg = harness.model_config(fields, gn)
    shapes = {k: tuple(v.shape) for k, v in gn.GraspNet(cfg).state_dict().items()}
    weights = make_weights(shapes, int(overrides.get("weight_seed", config["weights"]["seed"])), device)
    ref = judge.Reference(cfg, weights, device, "float32")
    low = judge.Reference(cfg, weights, device, "tf32")
    raw = capture_pool(seed, int(params["captures"]), int(params["points"]))
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32 & 0xFFFFFFFF, 0xC4EC])
    if workload["driver"] != "robot":
        raise ValueError(f"no control for the driver {workload['driver']!r}")
    gap, diff = 0.0, 0
    k = min(int(params["check_captures"]), len(raw))
    for c in sorted(rng.choice(len(raw), k, replace=False).tolist()):
        got = judge.service_reply(low, raw[c], s)[1]
        ref_all, ref_sel = judge.service_reply(ref, raw[c], s)
        g, d = judge.compare(np.zeros((0, 17)) if got is None else got, ref_all,
                             np.zeros((0, 17)) if ref_sel is None else ref_sel)
        gap, diff = max(gap, g), diff + d
    return {"cell": cell, "seed": seed, "rows_gap": gap, "selection_diff": diff}


def train_readings(cell: str, seed: int, device: str = "cuda", overrides=None) -> dict:
    """The training cell's numbers with the control (the reference in TF32)
    in the program's place, and with the fault of half of each batch left
    out (the loss the mean over the other scene), planted in the reference.
    A step that leaves the state unchanged reads 1 in `change_gap` and
    needs no run."""
    from benchmark.inputs.scenes import make_scene
    from benchmark.reference import train_ref

    workload = harness.load_json("workloads", cell)
    config = harness.load_json("configs", workload["config"])
    overrides = overrides or {}
    params = {**workload["params"], **overrides.get("params", {})}
    fields = overrides.get("model", config["model"])
    cfg = harness.model_config(fields, gn)
    shapes = {k: tuple(v.shape) for k, v in gn.GraspNet(cfg).state_dict().items()}
    seed_w = int(overrides.get("weight_seed", config["weights"]["seed"]))
    weights = {k: v.to("cpu") for k, v in make_weights(shapes, seed_w, device).items()}
    scene = make_scene(seed, cfg.num_view, cfg.num_angle, cfg.num_depth, int(params["objects"]),
                       int(params["label_points"]), int(params["cloud_points"]), device=device)
    tc, frames, steps = config["train"], int(params["frames"]), int(params["check_steps"])
    ref = train_ref.follow(fields, tc, scene, weights, frames, steps, device)
    out = {"cell": cell, "seed": seed}
    for name, kw in (("control", {"prec": "tf32"}), ("half_batch", {"keep_scenes": 1})):
        got = train_ref.follow(fields, tc, scene, weights, frames, steps, device, **kw)
        out[name] = train_ref.compare(got, ref, weights)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    train = harness.load_json("workloads", args.workload)["driver"] == "train_loop"
    for seed in args.seeds:
        print(json.dumps((train_readings if train else readings)(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
