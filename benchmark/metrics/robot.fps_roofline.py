"""K1's share of its roofline (csrc/fps.cu): the FPS cascade's bound at
B=1 (`roofline.fps_bound_s`) over `fps_cluster_kernel`'s device time a
request in the profiled stretch."""

from benchmark import trace
from benchmark.metrics._common import stretch

UNIT = "%"
WORKLOADS = ["infer.robot_b1", "infer.robot_nofilter_b1"]


def read(records):
    s = stretch(records)
    if s is None:
        return None
    t = trace.kernel_seconds(s, "fps_cluster_kernel")
    if not t:
        return None
    return 100.0 * records["fps_bound_s"] / (t / records["traced_requests"])
