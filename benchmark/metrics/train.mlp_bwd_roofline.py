"""K7 backward's share of its roofline (csrc/mlp_train.cu): the crop
MLP's backward bound at B=2 (`roofline.mlp_train_backward_bound_s`) over
the device time a step of its kernels (`pool_sums_kernel`, the passes B
and C, `sum_parts_kernel`, `finish_layer1_kernel`) in the profiled
stretch."""

from benchmark import trace
from benchmark.metrics._common import stretch

UNIT = "%"
WORKLOADS = ["train.recipe_b2"]
KERNELS = ("pool_sums_kernel", "mlp_bwd_pass_b_kernel", "mlp_bwd_pass_c_kernel", "sum_parts_kernel",
           "finish_layer1_kernel")


def read(records):
    s = stretch(records)
    if s is None:
        return None
    t = trace.kernel_seconds(s, *KERNELS)
    if not t:
        return None
    return 100.0 * records["k7_bwd_bound_s"] / (t / records["traced_steps"])
