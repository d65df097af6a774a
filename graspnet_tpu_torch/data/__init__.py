"""Host data pipeline: camera geometry, dataset, label batching (a copy of
`graspnet_tpu/data/`, numpy and the host label library only)."""

from graspnet_tpu_torch.data.camera import (
    CameraInfo,
    create_point_cloud_from_depth_image,
    transform_point_cloud_np,
    compute_point_dists,
    remove_invisible_grasp_points,
    get_workspace_mask,
)

__all__ = [
    "CameraInfo",
    "create_point_cloud_from_depth_image",
    "transform_point_cloud_np",
    "compute_point_dists",
    "remove_invisible_grasp_points",
    "get_workspace_mask",
]
