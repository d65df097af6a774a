"""Grasp containers and NMS (host and device)."""

from graspnet_tpu_torch.postproc.grasp import GRASP_ARRAY_LEN, Grasp, GraspGroup
from graspnet_tpu_torch.postproc.nms import grasp_nms, nms_keep_mask, nms_top_k

__all__ = ["GRASP_ARRAY_LEN", "Grasp", "GraspGroup", "grasp_nms", "nms_keep_mask", "nms_top_k"]
