"""Kernel launches a request: the launch calls among the host events of
the profiled stretch (the model's and everything the request launches),
over the stretch's requests."""

from benchmark.metrics._common import stretch

UNIT = "launches"
WORKLOADS = ["infer.robot_b1", "infer.robot_nofilter_b1"]


def read(records):
    s = stretch(records)
    if s is None or not s["launches"]:
        return None
    return s["launches"] / records["traced_requests"]
