"""The attention kernel's share of its roofline in a request
(csrc/attn.cu): the bound of a request's 24 calls, their operations at the
float32 CUDA-core peak or their q, k, v and output bytes
(`roofline_groupfree.attention_bound_s`), over `attn_fwd_kernel`'s device
time a request in the profiled stretch."""

from benchmark import trace
from benchmark.metrics._common import stretch

UNIT = "%"
WORKLOADS = ["infer.groupfree_scannet_b8"]


def read(records):
    s = stretch(records)
    if s is None:
        return None
    t = trace.kernel_seconds(s, "attn_fwd_kernel")
    if not t:
        return None
    return 100.0 * records["attn_bound_s"] / (t / records["traced_requests"])
