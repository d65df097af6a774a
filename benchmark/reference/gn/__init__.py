"""A frozen plain-PyTorch copy of GraspNet (graspnet-baseline, Fang et al.,
CVPR 2020) as the port's plain versions compute it: the model, the decode,
the label pipeline, the loss and the post-processing, with no custom
kernel.  It imports nothing of the program."""

from .config import GraspNetConfig, SAConfig
from .graspnet import GraspNet, pred_decode

__all__ = ["GraspNet", "GraspNetConfig", "SAConfig", "pred_decode"]
