"""The submanifold convolution's share of its roofline in a Point
Transformer V3 request (csrc/spconv.cu): the bound of the request's 23
calls, 2 x hits x C_in x C_out operations at the float32 CUDA-core peak or
their gathered rows, weights, output and map bytes
(`roofline_ptv3.spconv_bound_s`), over `subm_conv_kernel`'s device time a
request in the profiled stretch."""

from benchmark import trace
from benchmark.metrics._common import stretch

UNIT = "%"
WORKLOADS = ["infer.ptv3_scannet_b4"]


def read(records):
    s = stretch(records)
    if s is None or "spconv_bound_s" not in records:
        return None
    t = trace.kernel_seconds(s, "subm_conv_kernel")
    if not t:
        return None
    return 100.0 * records["spconv_bound_s"] / (t / records["traced_requests"])
