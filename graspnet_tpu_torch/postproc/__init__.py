"""Grasp containers, NMS (host and device), voxel downsampling, the
collision filter and gripper meshes; VoteNet's box post-processing is
`postproc/boxes.py`."""

from graspnet_tpu_torch.postproc.collision import (
    ModelFreeCollisionDetector,
    collision_counts_blocked,
    collision_ious,
    detect_batch,
)
from graspnet_tpu_torch.postproc.grasp import GRASP_ARRAY_LEN, Grasp, GraspGroup
from graspnet_tpu_torch.postproc.gripper import grasp_group_meshes, gripper_mesh, save_meshes_ply
from graspnet_tpu_torch.postproc.nms import grasp_nms, nms_keep_mask, nms_top_k
from graspnet_tpu_torch.postproc.voxel import voxel_down_sample

__all__ = ["GRASP_ARRAY_LEN", "Grasp", "GraspGroup", "ModelFreeCollisionDetector", "collision_counts_blocked",
           "collision_ious", "detect_batch", "grasp_group_meshes", "grasp_nms", "gripper_mesh", "nms_keep_mask", "nms_top_k", "save_meshes_ply", "voxel_down_sample"]
