"""Grasp containers, NMS (host and device), voxel downsampling and the
collision filter."""

from graspnet_tpu_torch.postproc.collision import (
    ModelFreeCollisionDetector,
    collision_counts_blocked,
    collision_ious,
    detect_batch,
)
from graspnet_tpu_torch.postproc.grasp import GRASP_ARRAY_LEN, Grasp, GraspGroup
from graspnet_tpu_torch.postproc.nms import grasp_nms, nms_keep_mask, nms_top_k
from graspnet_tpu_torch.postproc.voxel import voxel_down_sample

__all__ = ["GRASP_ARRAY_LEN", "Grasp", "GraspGroup", "ModelFreeCollisionDetector", "collision_counts_blocked",
           "collision_ious", "detect_batch", "grasp_nms", "nms_keep_mask", "nms_top_k", "voxel_down_sample"]
