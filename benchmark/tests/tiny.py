"""Small shapes for running the benchmark's cells on the CPU in tests:
`GraspNetConfig.tiny()`'s widths, small captures and scenes, and a weight
seed under which every tiny seed point is objectness-valid."""

from __future__ import annotations

import dataclasses

TINY_WEIGHT_SEED = 8  # all 64 seeds valid at tiny(): decode, filter and NMS have rows
# at tiny() widths on 4000-point captures the 0.01 threshold leaves 0-2 of
# 64 rows; 0.1 leaves about half, so the filter both keeps and drops rows
TINY_FILTER = {"collision_thresh": 0.1}

PARAMS = {
    "infer.robot_b1": {"points": 4000, "captures": 3, "check_captures": 2, "warm_requests": 1, "trace_requests": 2,
                       "serving": TINY_FILTER},
    "infer.robot_nofilter_b1": {"points": 4000, "captures": 3, "check_captures": 2, "warm_requests": 1,
                                "trace_requests": 2},
    "train.recipe_b2": {"frames": 64, "objects": 3, "label_points": 40, "cloud_points": 2000, "warm_steps": 3,
                        "trace_steps": 2},
}


def model_fields() -> dict:
    """GraspNetConfig.tiny() as a configuration file's "model" entry."""
    from graspnet_tpu_torch.config import GraspNetConfig

    c = GraspNetConfig.tiny()
    out = {}
    for f in dataclasses.fields(c):
        v = getattr(c, f.name)
        out[f.name] = dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    return out


def overrides(cell: str) -> dict:
    return {"model": model_fields(), "params": PARAMS[cell], "weight_seed": TINY_WEIGHT_SEED}
