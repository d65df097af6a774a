"""Applications: the inference pipeline, the training CLI (`apps.train`),
the eval CLI (`apps.test`), the grasp service (`apps.service`: TCP and ROS
nodes, with the MicroBatcher of `apps.batching`) and the demos
(`image_demo`, `demo_pointcloud`, `segmentation_demo`, `stereo_demo`,
`grasp_tf`, `grasp_base`)."""

from graspnet_tpu_torch.apps.pipeline import GraspPipeline

__all__ = ["GraspPipeline"]
