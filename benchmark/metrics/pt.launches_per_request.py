"""Kernel launches a request: the launch calls among the host events of
the profiled stretch (Point Transformer V3's serialization, maps, forward
and labels), over the stretch's requests."""

from benchmark.metrics._common import stretch

UNIT = "launches"
WORKLOADS = ["infer.ptv3_scannet_b4"]


def read(records):
    s = stretch(records)
    if s is None or not s["launches"]:
        return None
    return s["launches"] / records["traced_requests"]
