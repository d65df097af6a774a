"""The device's idle share of a Point Transformer V3 request: 1 - the
device's busy time a request in the profiled stretch over the mean latency
of the window's untraced requests (one client in a closed loop: a
request's latency is its share of the wall)."""

from benchmark.metrics._common import mean, stretch, untraced

UNIT = "%"
WORKLOADS = ["infer.ptv3_scannet_b4"]


def read(records):
    s = stretch(records)
    latency = mean(r["latency_s"] for r in untraced(records))
    if s is None or not latency:
        return None
    return 100.0 * (1.0 - s["busy_s"] / records["traced_requests"] / latency)
