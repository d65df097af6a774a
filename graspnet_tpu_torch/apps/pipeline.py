"""Single-frame and batched grasp inference: cloud -> network -> decode ->
(optional) collision filter -> NMS/top-K.

Counterpart of `graspnet_tpu/apps/pipeline.py`.  Runs on the card unless
the caller asks for the CPU (`device="cpu"`, as the tests do); asking for
CUDA on a host without it raises instead of running on the CPU.  Matmuls
stay in full float32 (TF32 off), like the XLA f32 path the port is held
against.  The collision filter counts on the pipeline's device
(`postproc/collision.py`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from graspnet_tpu_torch import checkpoint
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.device import resolve_device
from graspnet_tpu_torch.models import GraspNet, init_weights, pred_decode
from graspnet_tpu_torch.postproc import GraspGroup, ModelFreeCollisionDetector, detect_batch
from graspnet_tpu_torch.postproc.nms import nms_top_k


@dataclasses.dataclass
class PipelineTimings:
    infer_s: float = 0.0
    collision_s: float = 0.0


class GraspPipeline:
    """Holds the weights on the device, then serves frames."""

    def __init__(
        self,
        params: Optional[Dict[str, torch.Tensor]] = None,
        cfg: GraspNetConfig = GraspNetConfig(),
        seed: int = 0,
        device: str | torch.device = "cuda",
        checkpoint_path: Optional[str] = None,
    ):
        """`params`: a GraspNet state dict (e.g. from
        `checkpoint.params_from_jax`); else `checkpoint_path`: a reference
        `.tar` checkpoint, or a file of `checkpoint.save` holding a bare
        state dict or the training CLI's state (whose 'model' it takes),
        as the JAX pipeline reads either (`graspnet_tpu/apps/pipeline.py:60-78`);
        neither draws seeded random weights."""
        self.cfg = cfg
        self.device = resolve_device(device, "GraspPipeline")
        if params is None and checkpoint_path is not None:
            if checkpoint_path.endswith(".tar"):
                params = checkpoint.load_torch_checkpoint(checkpoint_path, cfg)
            else:
                params = checkpoint.restore(checkpoint_path)
                params = params.get("model", params)
        model = GraspNet(cfg)
        if params is None:
            init_weights(model, seed)
        else:
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.timings = PipelineTimings()

    # ---- device programs ----
    def _cloud(self, clouds: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(clouds, np.float32)).to(self.device)

    @torch.inference_mode()
    def forward(self, clouds: torch.Tensor) -> Dict[str, torch.Tensor]:
        """graspnet_forward (inference): (B, N, 3) on the device -> end_points."""
        return self.model(clouds)

    @torch.inference_mode()
    def _infer(self, clouds: torch.Tensor):
        return pred_decode(self.model(clouds), self.cfg)

    @torch.inference_mode()
    def _infer_topk(self, clouds: torch.Tensor, top_k: int = 50):
        """Network -> decode -> NMS -> top-K; only (B, K, 17) rows leave."""
        grasps, valid = pred_decode(self.model(clouds), self.cfg)
        return nms_top_k(grasps, valid, k=top_k)

    # ---- public API ----
    def warmup(
        self,
        topk: Optional[bool] = None,
        collision_thresh: float = -1.0,
        nms: bool = True,
        top_k: int = 50,
        batch_size: int = 1,
    ) -> float:
        """One forward on a zero cloud through the program the later calls
        take (builds the kernels on first CUDA use); returns its wall time.
        With collision_thresh <= 0, nms and top_k, `run` takes the fused
        decode + NMS + top-K program, else the raw decode one; `topk`
        forces the choice (the JAX pipeline's keywords)."""
        fused = topk if topk is not None else (collision_thresh <= 0 and nms and bool(top_k))
        dummy = torch.zeros((batch_size, self.cfg.num_point, 3), device=self.device)
        t0 = time.perf_counter()
        if fused:
            rows, _ = self._infer_topk(dummy, top_k=top_k or 50)
        else:
            rows, _ = self._infer(dummy)
        rows.cpu()
        return time.perf_counter() - t0

    def sample_cloud(self, cloud: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Random-sample to num_point, padding with replacement when short."""
        rng = rng or np.random.default_rng(0)
        n = self.cfg.num_point
        if len(cloud) >= n:
            idxs = rng.choice(len(cloud), n, replace=False)
        else:
            idxs = np.concatenate(
                [np.arange(len(cloud)), rng.choice(len(cloud), n - len(cloud), replace=True)]
            )
        return cloud[idxs]

    def get_grasps(self, cloud_sampled: np.ndarray) -> GraspGroup:
        """Run the network on a (num_point, 3) cloud, return decoded grasps."""
        return self.get_grasps_batch(np.asarray(cloud_sampled)[None])[0]

    def get_grasps_batch(self, clouds: np.ndarray) -> list:
        """(B, num_point, 3) -> list of B GraspGroups (objectness-valid rows)."""
        return self.finish_grasps_batch(self.dispatch_grasps_batch(clouds))

    def dispatch_grasps_batch(self, clouds: np.ndarray):
        """Enqueue the decode program and return a handle; the kernels run
        asynchronously on the current CUDA stream."""
        t0 = time.perf_counter()
        return self._infer(self._cloud(clouds)), t0

    def finish_grasps_batch(self, handle) -> list:
        """Blocking half: fetch the rows, build per-frame groups."""
        (grasps, valid), t0 = handle
        grasps, valid = grasps.cpu().numpy(), valid.cpu().numpy()
        self.timings.infer_s = time.perf_counter() - t0
        return [GraspGroup(g[v]) for g, v in zip(grasps, valid)]

    def collision_filter(
        self,
        gg: GraspGroup,
        scene_cloud: np.ndarray,
        collision_thresh: float = 0.01,
        voxel_size: float = 0.01,
        approach_dist: float = 0.05,
    ) -> GraspGroup:
        """The grasps of gg that do not collide with the (raw) scene cloud."""
        t0 = time.perf_counter()
        detector = ModelFreeCollisionDetector(scene_cloud, voxel_size=voxel_size, device=self.device)
        mask = detector.detect(gg, approach_dist=approach_dist, collision_thresh=collision_thresh)
        self.timings.collision_s = time.perf_counter() - t0
        return gg[~mask]

    def collision_filter_batch(
        self,
        ggs,
        scene_clouds,
        collision_thresh: float = 0.01,
        voxel_size: float = 0.01,
        approach_dist: float = 0.05,
        pre_downsampled: bool = False,
    ):
        """`collision_filter` for a batch of frames in one device round
        trip (`detect_batch`), mask-identical frame by frame."""
        t0 = time.perf_counter()
        masks = detect_batch(scene_clouds, ggs, voxel_size=voxel_size, approach_dist=approach_dist,
                             collision_thresh=collision_thresh, pre_downsampled=pre_downsampled,
                             device=self.device)
        self.timings.collision_s = time.perf_counter() - t0
        return [gg[~m] for gg, m in zip(ggs, masks)]

    def get_grasps_topk(self, cloud_sampled: np.ndarray, top_k: int = 50) -> GraspGroup:
        """Serving path: NMS + top-K on the device; ships (K, 17) rows."""
        return self.get_grasps_topk_batch(np.asarray(cloud_sampled)[None], top_k)[0]

    def get_grasps_topk_batch(self, clouds: np.ndarray, top_k: int = 50) -> list:
        """(B, num_point, 3) -> B top-K GraspGroups from one device program."""
        t0 = time.perf_counter()
        rows, vmask = self._infer_topk(self._cloud(clouds), top_k=top_k)
        rows, vmask = rows.cpu().numpy(), vmask.cpu().numpy()
        self.timings.infer_s = time.perf_counter() - t0
        return [GraspGroup(r[v]) for r, v in zip(rows, vmask)]

    def run(
        self,
        cloud_sampled: np.ndarray,
        scene_cloud: Optional[np.ndarray] = None,
        collision_thresh: float = -1.0,
        nms: bool = True,
        top_k: int = 50,
        voxel_size: float = 0.01,
    ) -> GraspGroup:
        """Full frame pipeline; collision_thresh <= 0 skips the filter
        (-1 disables it, the reference convention), which then tests the
        decoded grasps against `scene_cloud` (the raw cloud)."""
        if collision_thresh <= 0 and nms and top_k:
            # nothing between decode and NMS: the fused program ships (K, 17) rows
            return self.get_grasps_topk(cloud_sampled, top_k=top_k)
        gg = self.get_grasps(cloud_sampled)
        if collision_thresh > 0 and scene_cloud is not None:
            gg = self.collision_filter(gg, scene_cloud, collision_thresh, voxel_size)
        gg = gg.sort_by_score()
        if nms:
            gg = gg.nms()
        if top_k:
            gg = gg[:top_k]
        return gg
