"""The GraspNet model (eval branch) and its decode."""

from graspnet_tpu_torch.models.graspnet import GraspNet, init_weights, pred_decode

__all__ = ["GraspNet", "init_weights", "pred_decode"]
