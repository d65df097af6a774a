"""The width-16 attention's share of its roofline in a Point Transformer V3
request (csrc/attn.cu's variable-length entry): the bound of the request's
22 calls, 4 x sum of L^2 x C operations at the float32 CUDA-core peak or
their q, k, v and output bytes (`roofline_ptv3.attention_bound_s`), over
`attn_fwd_kernel`'s device time a request in the profiled stretch."""

from benchmark import trace
from benchmark.metrics._common import stretch

UNIT = "%"
WORKLOADS = ["infer.ptv3_scannet_b4"]


def read(records):
    s = stretch(records)
    if s is None or "attn_bound_s" not in records:
        return None
    t = trace.kernel_seconds(s, "attn_fwd_kernel")
    if not t:
        return None
    return 100.0 * records["attn_bound_s"] / (t / records["traced_requests"])
