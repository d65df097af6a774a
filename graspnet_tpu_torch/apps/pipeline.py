"""Single-frame and batched grasp inference: cloud -> network -> decode ->
(optional) collision filter -> NMS/top-K.

Counterpart of `graspnet_tpu/apps/pipeline.py`.  Runs on the card unless
the caller asks for the CPU (`device="cpu"`, as the tests do); asking for
CUDA on a host without it raises instead of running on the CPU.  Matmuls
stay in full float32 (TF32 off), like the XLA f32 path the port is held
against.  The collision filter counts on the pipeline's device
(`postproc/collision.py`).  `mesh=` shards the decode over several devices
(`parallel/candidate.py`), as the JAX pipeline's mesh does.
"""

from __future__ import annotations

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
from graspnet_tpu_torch.utils.tracing import span


class GraspPipeline:
    """Holds the weights on the device, then serves frames."""

    def __init__(
        self,
        params: Optional[Dict[str, torch.Tensor]] = None,
        cfg: GraspNetConfig = GraspNetConfig(),
        seed: int = 0,
        device: str | torch.device = "cuda",
        checkpoint_path: Optional[str] = None,
        mesh=None,
    ):
        """`params`: a GraspNet state dict (e.g. from
        `checkpoint.params_from_jax`); else `checkpoint_path`: a reference
        `.tar` checkpoint, or a file of `checkpoint.save` holding a bare
        state dict or the training CLI's state (whose 'model' it takes),
        as the JAX pipeline reads either (`graspnet_tpu/apps/pipeline.py:60-78`);
        neither draws seeded random weights.

        `mesh`: a `parallel.Mesh`, whose first device takes the place of
        `device` (the weights' home, where rows are gathered, NMS'd and
        fetched).  Its axis names select the strategy
        (`graspnet_tpu/apps/pipeline.py:41-137`): a 'candidate' axis above 1
        (with a 'data' axis: the hybrid mesh) shards each scene's stage 2
        over seed blocks and serves any batch; otherwise the scene batch
        shards over the devices, and a batch the data axis does not divide
        runs unsharded."""
        self.cfg = cfg
        if mesh is not None:
            for d in mesh.distinct():
                resolve_device(d, "GraspPipeline")
            device = mesh.devices.flat[0]
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
        self.mesh = mesh
        self._sharded = None
        self._data_axis_size = 1  # the batch sizes the sharded decode takes
        if mesh is not None:
            from graspnet_tpu_torch.parallel import candidate_sharded_infer, data_parallel_infer

            names = mesh.axis_names
            if "candidate" in names and mesh.shape["candidate"] > 1:
                data_axis = "data" if "data" in names and mesh.shape["data"] > 1 else None
                self._sharded = candidate_sharded_infer(self.model, cfg, mesh, data_axis=data_axis)
                if data_axis is not None:
                    self._data_axis_size = mesh.shape["data"]
            else:
                self._sharded = data_parallel_infer(self.model, cfg, mesh, axis=names[0])
                self._data_axis_size = mesh.shape[names[0]]

    # ---- device programs ----
    def _cloud(self, clouds) -> torch.Tensor:
        """The clouds as float32 on the device: a tensor already there as it
        is, a numpy batch in one copy."""
        if isinstance(clouds, torch.Tensor):
            return clouds.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(clouds, np.float32)).to(self.device)

    @torch.inference_mode()
    def forward(self, clouds: torch.Tensor) -> Dict[str, torch.Tensor]:
        """graspnet_forward (inference): (B, N, 3 + input_feature_dim) on
        the device -> end_points."""
        return self.model(clouds)

    @torch.inference_mode()
    def _infer(self, clouds: torch.Tensor):
        """Network -> decode; sharded over the mesh when it takes the batch
        (`graspnet_tpu/apps/pipeline.py:189-194`)."""
        if self._sharded is not None and clouds.shape[0] % self._data_axis_size == 0:
            return self._sharded(clouds)
        return pred_decode(self.model(clouds), self.cfg)

    @torch.inference_mode()
    def _infer_topk(self, clouds: torch.Tensor, top_k: int = 50):
        """Network -> decode -> NMS -> top-K; only (B, K, 17) rows leave.
        On a mesh, NMS and top-K run on the rows gathered on its first device."""
        grasps, valid = self._infer(clouds)
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
        """One forward on a zero cloud (3 + input_feature_dim channels)
        through the program the later calls take (builds the kernels on
        first CUDA use); returns its wall time.
        With collision_thresh <= 0, nms and top_k, `run` takes the fused
        decode + NMS + top-K program, else the raw decode one; `topk`
        forces the choice (the JAX pipeline's keywords)."""
        fused = topk if topk is not None else (collision_thresh <= 0 and nms and bool(top_k))
        dummy = torch.zeros((batch_size, self.cfg.num_point, 3 + self.cfg.input_feature_dim), device=self.device)
        t0 = time.perf_counter()
        if fused:
            rows, _ = self._infer_topk(dummy, top_k=top_k or 50)
        else:
            rows, _ = self._infer(dummy)
        rows.cpu()
        return time.perf_counter() - t0

    def sample_cloud(self, cloud, rng: Optional[np.random.Generator] = None):
        """Random-sample to num_point, padding with replacement when short
        (`sample_indices`).  A tensor's rows are gathered where it lies, the
        indices drawn on the host and copied over; numpy rows stay numpy."""
        idxs = sample_indices(len(cloud), self.cfg.num_point, rng)
        if isinstance(cloud, torch.Tensor):
            return cloud.index_select(0, torch.from_numpy(idxs).to(cloud.device))
        return cloud[idxs]

    def get_grasps(self, cloud_sampled, timings: Optional[dict] = None) -> GraspGroup:
        """Run the network on a (num_point, 3) cloud, numpy or a tensor
        (one on the device is not copied again), return decoded grasps."""
        return self.get_grasps_batch(_one(cloud_sampled), timings)[0]

    def get_grasps_batch(self, clouds: np.ndarray, timings: Optional[dict] = None) -> list:
        """(B, num_point, 3) -> list of B GraspGroups (objectness-valid rows)."""
        return self.finish_grasps_batch(self.dispatch_grasps_batch(clouds, timings))

    def dispatch_grasps_batch(self, clouds: np.ndarray, timings: Optional[dict] = None):
        """Enqueue the decode program; the kernels run asynchronously on
        the current CUDA stream.  Returns the handle `finish_grasps_batch`
        takes: the device rows, the dispatch's start and `timings`, a dict
        that gets the batch's `infer` seconds, the dispatch's start through
        the rows' arrival on the host, when the handle is finished, and the
        seconds of the `pipeline.dispatch` and `pipeline.fetch` spans."""
        with span("pipeline.dispatch", into=timings) as s:
            rows = self._infer(self._cloud(clouds))
        return rows, s.start_ns, timings

    def finish_grasps_batch(self, handle) -> list:
        """Blocking half: fetch the rows (the wait on the device), build
        per-frame groups."""
        (grasps, valid), start_ns, timings = handle
        with span("pipeline.fetch", into=timings):
            grasps, valid = grasps.cpu().numpy(), valid.cpu().numpy()
            _since(timings, "infer", start_ns)
            return [GraspGroup(g[v]) for g, v in zip(grasps, valid)]

    def collision_filter(
        self,
        gg: GraspGroup,
        scene_cloud,
        collision_thresh: float = 0.01,
        voxel_size: float = 0.01,
        approach_dist: float = 0.05,
        timings: Optional[dict] = None,
    ) -> GraspGroup:
        """The grasps of gg that do not collide with the (raw) scene cloud,
        numpy or a tensor (`ModelFreeCollisionDetector`).  A `timings` dict
        gets the filter's `collision` seconds, the downsample through the
        mask, and those of its spans."""
        start_ns = time.perf_counter_ns()
        detector = ModelFreeCollisionDetector(scene_cloud, voxel_size=voxel_size, device=self.device, timings=timings)
        mask = detector.detect(gg, approach_dist=approach_dist, collision_thresh=collision_thresh, timings=timings)
        _since(timings, "collision", start_ns)
        return gg[~mask]

    def collision_filter_batch(
        self,
        ggs,
        scene_clouds,
        collision_thresh: float = 0.01,
        voxel_size: float = 0.01,
        approach_dist: float = 0.05,
        pre_downsampled: bool = False,
        timings: Optional[dict] = None,
    ):
        """`collision_filter` for a batch of frames in one device round
        trip (`detect_batch`), mask-identical frame by frame."""
        start_ns = time.perf_counter_ns()
        masks = detect_batch(scene_clouds, ggs, voxel_size=voxel_size, approach_dist=approach_dist,
                             collision_thresh=collision_thresh, pre_downsampled=pre_downsampled,
                             device=self.device, timings=timings)
        _since(timings, "collision", start_ns)
        return [gg[~m] for gg, m in zip(ggs, masks)]

    def get_grasps_topk(self, cloud_sampled, top_k: int = 50, timings: Optional[dict] = None) -> GraspGroup:
        """Serving path: NMS + top-K on the device; ships (K, 17) rows."""
        return self.get_grasps_topk_batch(_one(cloud_sampled), top_k, timings)[0]

    def get_grasps_topk_batch(self, clouds: np.ndarray, top_k: int = 50, timings: Optional[dict] = None) -> list:
        """(B, num_point, 3) -> B top-K GraspGroups from one device program."""
        with span("pipeline.dispatch", into=timings) as dispatch:
            rows, vmask = self._infer_topk(self._cloud(clouds), top_k=top_k)
        with span("pipeline.fetch", into=timings):
            rows, vmask = rows.cpu().numpy(), vmask.cpu().numpy()
            _since(timings, "infer", dispatch.start_ns)
            return [GraspGroup(r[v]) for r, v in zip(rows, vmask)]

    def run(
        self,
        cloud_sampled,
        scene_cloud=None,
        collision_thresh: float = -1.0,
        nms: bool = True,
        top_k: int = 50,
        voxel_size: float = 0.01,
        timings: Optional[dict] = None,
    ) -> GraspGroup:
        """Full frame pipeline; collision_thresh <= 0 skips the filter
        (-1 disables it, the reference convention), which then tests the
        decoded grasps against `scene_cloud` (the raw cloud).  Either cloud
        may be numpy or a tensor; a tensor on the device stays there (the
        service's card route hands over both so).  A `timings` dict gets
        this call's `infer` seconds and, when the filter runs, its
        `collision` seconds, and the seconds of the spans under them by name
        (`pipeline.dispatch`, `pipeline.fetch`, `collision.downsample`,
        `collision.detect`)."""
        if collision_thresh <= 0 and nms and top_k:
            # nothing between decode and NMS: the fused program ships (K, 17) rows
            return self.get_grasps_topk(cloud_sampled, top_k=top_k, timings=timings)
        gg = self.get_grasps(cloud_sampled, timings)
        if collision_thresh > 0 and scene_cloud is not None:
            gg = self.collision_filter(gg, scene_cloud, collision_thresh, voxel_size, timings=timings)
        gg = gg.sort_by_score()
        if nms:
            gg = gg.nms()
        if top_k:
            gg = gg[:top_k]
        return gg


def sample_indices(n: int, num_point: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """The rows of an n-point cloud that `sample_cloud` keeps: num_point
    drawn without replacement, or, when n is short, every row in order and
    the rest drawn with replacement; from `default_rng(0)` unless `rng`."""
    rng = rng or np.random.default_rng(0)
    if n >= num_point:
        return rng.choice(n, num_point, replace=False)
    return np.concatenate([np.arange(n), rng.choice(n, num_point - n, replace=True)])


def _one(cloud):
    """A (N, C) cloud as a batch of one, a tensor kept a tensor."""
    return cloud[None] if isinstance(cloud, torch.Tensor) else np.asarray(cloud)[None]


def _since(timings: Optional[dict], key: str, start_ns: int) -> None:
    """Write the seconds since `start_ns` under `key` of a caller's timings."""
    if timings is not None:
        timings[key] = (time.perf_counter_ns() - start_ns) * 1e-9
