"""Candidate-axis (intra-scene) and scene-axis (data) parallel inference.

Counterpart of `graspnet_tpu/parallel/candidate.py`, sharded by hand over a
`Mesh` of torch devices instead of by `shard_map` and GSPMD:

* `data_parallel_infer`: the scene batch splits over the mesh's devices,
  one weight replica a distinct device; each device runs the forward and
  the decode of its scenes; the rows are gathered on the first device.
  The eval-throughput path.
* `candidate_sharded_infer`: stage 1 (backbone and approach head, which
  need the whole cloud) runs once per scene group; stage 2 and the decode
  (`_stage2_decode`: the fused crop, operation and tolerance heads,
  `pred_decode`), which are per seed, run on a block of num_seed / n seeds
  on each device of the candidate axis; the rows are gathered in seed order
  on the first device.  The latency path for robot serving.  With a 2-D
  mesh and `data_axis`, the scenes also split over that axis (hybrid).

The work of each device is enqueued in turn from the calling thread: no
step of the forward or the decode reads a result on the host, so on
distinct cards the devices run at once.  On one card a mesh that repeats it
runs the same code path, one device's work after another.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.models.graspnet import GraspNet, pred_decode
from graspnet_tpu_torch.parallel.mesh import Mesh, axis_devices, replicate

Infer = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _stage2_decode(
    model: GraspNet, crop_seed, input_xyz, crop_rot, view_xyz, objectness, cfg: GraspNetConfig
):
    """Per-seed stage 2 + decode on a (B, ns_block) block of seeds."""
    vp_features, _ = model.crop(crop_seed, input_xyz, crop_rot, train=False)
    ep: Dict[str, Any] = {"fp2_xyz": crop_seed, "grasp_top_view_xyz": view_xyz,
                          "objectness_score": objectness}
    ep.update(model.operation(vp_features, train=False))
    ep.update(model.tolerance(vp_features, train=False))
    return pred_decode(ep, cfg)


def _gather(parts, device: torch.device, dim: int):
    grasps = torch.cat([g.to(device) for g, _ in parts], dim=dim)
    valid = torch.cat([v.to(device) for _, v in parts], dim=dim)
    return grasps, valid


def candidate_sharded_infer(
    model: GraspNet,
    cfg: GraspNetConfig,
    mesh: Mesh,
    axis: str = "candidate",
    data_axis: Optional[str] = None,
) -> Infer:
    """Build (cloud (B, N, 3)) -> (grasps (B, Ns, 17), valid (B, Ns)) with
    stage 2 sharded over `axis`; Ns must divide by the axis size.  With
    `data_axis` on a 2-D mesh the scenes also shard over it, and B must
    divide by its size.  The results lie on the mesh's first device."""
    n = mesh.shape[axis]
    assert cfg.num_seed % n == 0, f"num_seed {cfg.num_seed} not divisible by mesh axis '{axis}' size {n}"
    axes = [data_axis, axis] if data_axis is not None else [axis]
    other = [a for a in mesh.axis_names if a not in axes]
    assert all(mesh.shape[a] == 1 for a in other), f"mesh axes {other} must have size 1"
    # (scene groups, seed blocks) grid of devices
    grid = np.moveaxis(mesh.devices, [mesh.axis_names.index(a) for a in axes], range(len(axes)))
    grid = grid.reshape(mesh.shape[data_axis] if data_axis else 1, n)
    replicas = replicate(mesh, model)
    block = cfg.num_seed // n
    first = grid[0, 0]

    @torch.inference_mode()
    def infer(cloud: torch.Tensor):
        g = grid.shape[0]
        assert cloud.shape[0] % g == 0, f"batch {cloud.shape[0]} not divisible by mesh axis '{data_axis}' size {g}"
        per = cloud.shape[0] // g
        rows = []
        for gi in range(g):
            home = grid[gi, 0]
            m = replicas[home]
            x = cloud[gi * per : (gi + 1) * per].to(home)
            seed_features, _, ep = m.backbone(x, False)
            ap = m.approach(seed_features, False)
            stage1 = (ep["fp2_xyz"], ap["grasp_top_view_rot"], ap["grasp_top_view_xyz"], ap["objectness_score"])
            parts = []
            for j in range(n):
                dev = grid[gi, j]
                seeds = slice(j * block, (j + 1) * block)
                seed_xyz, rot, view_xyz, obj = (t[:, seeds].to(dev) for t in stage1)
                parts.append(_stage2_decode(replicas[dev], seed_xyz, ep["input_xyz"].to(dev), rot, view_xyz,
                                            obj, cfg))
            rows.append(_gather(parts, first, dim=1))
        return _gather(rows, first, dim=0)

    return infer


def data_parallel_infer(model: GraspNet, cfg: GraspNetConfig, mesh: Mesh, axis: str = "data") -> Infer:
    """Build (clouds (B, N, 3)) -> (grasps, valid) with the scene batch
    split over the mesh's devices and the weights replicated: the
    eval-throughput path.  B must divide by the axis size; the results
    lie on the axis's first device."""
    devs = axis_devices(mesh, axis)
    replicas = replicate(mesh, model)

    @torch.inference_mode()
    def infer(clouds: torch.Tensor):
        n = len(devs)
        assert clouds.shape[0] % n == 0, f"batch {clouds.shape[0]} not divisible by mesh axis '{axis}' size {n}"
        per = clouds.shape[0] // n
        parts = []
        for i, dev in enumerate(devs):
            m = replicas[dev]
            parts.append(pred_decode(m(clouds[i * per : (i + 1) * per].to(dev)), cfg))
        return _gather(parts, devs[0], dim=0)

    return infer
