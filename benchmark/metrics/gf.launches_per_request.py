"""Kernel launches a request: the launch calls among the host events of
the profiled stretch (Group-Free-3D's forward, decode and box
post-processing), over the stretch's requests."""

from benchmark.metrics._common import stretch

UNIT = "launches"
WORKLOADS = ["infer.groupfree_scannet_b8"]


def read(records):
    s = stretch(records)
    if s is None or not s["launches"]:
        return None
    return s["launches"] / records["traced_requests"]
