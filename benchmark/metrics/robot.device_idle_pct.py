"""The device's idle share of a request: 1 - the device's busy time a
request in the profiled stretch over the mean latency of the window's
untraced requests (one client in a closed loop: a request's latency is
its share of the wall).  The profiler slows the host, so the stretch's
own wall time would overstate the idle share of the requests it
explains."""

from benchmark.metrics._common import mean, stretch, untraced

UNIT = "%"
WORKLOADS = ["infer.robot_b1", "infer.robot_nofilter_b1"]


def read(records):
    s = stretch(records)
    latency = mean(r["latency_s"] for r in untraced(records))
    if s is None or not latency:
        return None
    return 100.0 * (1.0 - s["busy_s"] / records["traced_requests"] / latency)
