"""Applications: the inference pipeline."""

from graspnet_tpu_torch.apps.pipeline import GraspPipeline

__all__ = ["GraspPipeline"]
