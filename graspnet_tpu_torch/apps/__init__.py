"""Applications: the inference pipeline, the training CLI (`apps.train`)
and the eval CLI (`apps.test`)."""

from graspnet_tpu_torch.apps.pipeline import GraspPipeline

__all__ = ["GraspPipeline"]
