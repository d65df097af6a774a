"""The reference's side of `correct` for the inference cells: the plain
model's rows for a cloud, the plain post-processing, and the two numbers
that compare what the program returned with them.

Rows are matched by their grasp centre: a row's centre is its seed point,
a point of the sampled cloud that both sides were given, so the program's
row and the reference's row of one seed carry the same three floats.

- `rows_gap`: the widest absolute difference, over every row the program
  returned and every column of it, from the reference's row of the same
  seed; a row whose seed the reference does not have reads infinity.
- `selection_diff`: how many rows lie in one of the two selections (the
  program's, the reference's) and not in the other: the objectness mask,
  the collision filter, the NMS and the top-K together.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import gn
from .gn import postproc

PRECISIONS = ("float32", "tf32")  # the configuration's, and the control's one step below it


@contextlib.contextmanager
def precision(name: str):
    """float32 products (TF32 off), or the control's TF32 products."""
    if name not in PRECISIONS:
        raise ValueError(f"precision {name!r} is not one of {PRECISIONS}")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = name == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Reference:
    """The plain GraspNet with the benchmark's weights, in eval mode."""

    def __init__(self, cfg: gn.GraspNetConfig, weights: Dict[str, torch.Tensor], device, prec: str = "float32"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.prec = prec
        model = gn.GraspNet(cfg)
        model.load_state_dict({k: v.detach().to("cpu") for k, v in weights.items()}, strict=True)
        self.model = model.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def rows(self, clouds: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(B, N, 3) sampled clouds -> (B, Ns, 17) decoded rows and (B, Ns) objectness masks."""
        with precision(self.prec):
            x = torch.as_tensor(np.asarray(clouds, np.float32), device=self.device)
            grasps, valid = gn.pred_decode(self.model(x), self.cfg)
        return grasps.cpu().numpy(), valid.cpu().numpy()


def sample_like_service(cloud: np.ndarray, n: int) -> np.ndarray:
    """The service's sampling of a depth-filtered capture to n points: a
    generator seeded 0 for every request (`GraspPipeline.sample_cloud`)."""
    rng = np.random.default_rng(0)
    if len(cloud) >= n:
        idx = rng.choice(len(cloud), n, replace=False)
    else:
        idx = np.concatenate([np.arange(len(cloud)), rng.choice(len(cloud), n - len(cloud), replace=True)])
    return cloud[idx]


def filter_rows(rows: np.ndarray, valid: np.ndarray, scene: Optional[np.ndarray], serving: dict,
                device) -> np.ndarray:
    """The objectness-valid rows, less those that collide with the scene
    when the configuration's collision threshold is positive."""
    kept = rows[valid]
    if serving["collision_thresh"] > 0 and scene is not None and len(kept):
        mask = postproc.collision_mask(scene, kept, serving["voxel_size"], serving["approach_dist"],
                                       serving["collision_thresh"], device)
        kept = kept[~mask]
    return kept


def _keys(rows: np.ndarray):
    """Each row's grasp centre as bytes: its seed."""
    return [np.asarray(r[13:16], np.float32).tobytes() for r in rows]


def compare(got: np.ndarray, ref_all: np.ndarray, ref_selected: np.ndarray) -> Tuple[float, int]:
    """(rows_gap, selection_diff) of the program's rows `got` against the
    reference's decoded rows of every seed and its selection."""
    got = np.asarray(got, np.float32).reshape(-1, 17)
    by_seed = {k: r for k, r in zip(_keys(ref_all), np.asarray(ref_all, np.float32))}
    gap = 0.0
    for k, row in zip(_keys(got), got):
        ref = by_seed.get(k)
        gap = max(gap, float("inf") if ref is None else float(np.max(np.abs(row.astype(np.float64) - ref))))
    a, b = set(_keys(got)), set(_keys(ref_selected))
    return gap, len(a ^ b) + abs(len(got) - len(a)) + abs(len(ref_selected) - len(b))


def service_reply(ref: Reference, cloud: np.ndarray, serving: dict) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The reference's answer to one capture as `GraspService.compute`
    states it: the depth window, the sampling, the forward and decode, the
    collision filter, the score sort and NMS, the top-K.  Returns the
    decoded rows of every seed and the selected rows (None where the
    service answers that too few points lie in the depth window)."""
    z = cloud[:, 2]
    scene = cloud[(z >= serving["depth_min"]) & (z <= serving["depth_max"])]
    n = ref.cfg.num_point
    if len(scene) < max(100, n // 10):
        return np.zeros((0, 17), np.float32), None
    rows, valid = ref.rows(sample_like_service(scene, n)[None])
    kept = filter_rows(rows[0], valid[0], scene, serving, ref.device)
    kept = postproc.nms(postproc.sort_by_score(kept))
    return rows[0], postproc.sort_by_score(kept)[: serving["top_k"]]

