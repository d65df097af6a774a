"""Single-frame and batched grasp inference: cloud -> network -> decode ->
NMS/top-K.

Counterpart of `graspnet_tpu/apps/pipeline.py`.  Runs on the card unless
the caller asks for the CPU (`device="cpu"`, as the tests do); asking for
CUDA on a host without it raises instead of running on the CPU.  Matmuls
stay in full float32 (TF32 off), like the XLA f32 path the port is held
against.  The collision filter is not ported yet (ROADMAP item 16).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.device import resolve_device
from graspnet_tpu_torch.models import GraspNet, init_weights, pred_decode
from graspnet_tpu_torch.postproc import GraspGroup
from graspnet_tpu_torch.postproc.nms import nms_top_k


@dataclasses.dataclass
class PipelineTimings:
    infer_s: float = 0.0


class GraspPipeline:
    """Holds the weights on the device, then serves frames."""

    def __init__(
        self,
        params: Optional[Dict[str, torch.Tensor]] = None,
        cfg: GraspNetConfig = GraspNetConfig(),
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        """`params`: a GraspNet state dict (e.g. from
        `checkpoint.params_from_jax`); None draws seeded random weights."""
        self.cfg = cfg
        self.device = resolve_device(device, "GraspPipeline")
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
    def warmup(self, top_k: int = 50, batch_size: int = 1) -> float:
        """One forward on a zero cloud (builds the kernels on first CUDA
        use); returns its wall time."""
        dummy = torch.zeros((batch_size, self.cfg.num_point, 3), device=self.device)
        t0 = time.perf_counter()
        rows, _ = self._infer_topk(dummy, top_k=top_k)
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
        collision_thresh: float = -1.0,
        nms: bool = True,
        top_k: int = 50,
    ) -> GraspGroup:
        """Full frame pipeline; collision_thresh <= 0 skips the filter
        (-1 disables it, the reference convention)."""
        if collision_thresh > 0:
            raise NotImplementedError(
                "the collision filter is not ported yet (ROADMAP queue 1, item 16)"
            )
        if nms and top_k:
            return self.get_grasps_topk(cloud_sampled, top_k=top_k)
        gg = self.get_grasps(cloud_sampled).sort_by_score()
        if nms:
            gg = gg.nms()
        if top_k:
            gg = gg[:top_k]
        return gg
