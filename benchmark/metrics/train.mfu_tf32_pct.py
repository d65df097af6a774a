"""The training step's share of the card's dense TF32 peak: a B=2 step's
model FLOPs (`roofline.train_step_flops`: the forward and a backward of
twice it) over the mean wall time of the window's untraced steps x 495
TFLOP/s."""

from benchmark.metrics._common import mean
from benchmark.roofline import PEAK_TF32_FLOPS

UNIT = "%"
WORKLOADS = ["train.recipe_b2"]


def read(records):
    step = mean(records.get("untraced_step_s", []))
    if not step:
        return None
    return 100.0 * records["step_flops"] / (step * PEAK_TF32_FLOPS)
