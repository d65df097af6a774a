"""K1's share of its roofline in a request (csrc/fps.cu): the bound of the
FPS cascade at 40,000 points and of the proposals' FPS of the seeds, for
the request's batch (`roofline_detect.fps_bound_s`), over
`fps_cluster_kernel`'s device time a request in the profiled stretch."""

from benchmark import trace
from benchmark.metrics._common import stretch

UNIT = "%"
WORKLOADS = ["infer.votenet_scannet_b8"]


def read(records):
    s = stretch(records)
    if s is None:
        return None
    t = trace.kernel_seconds(s, "fps_cluster_kernel")
    if not t:
        return None
    return 100.0 * records["fps_bound_s"] / (t / records["traced_requests"])
