"""The service's own host time a request (apps/service.py): the request's
latency less the reply's `timings_ms.infer` and `timings_ms.collision`
(depth filter, sampling, sort, NMS, top-K, the reply), a mean over the
window's untraced requests."""

from benchmark.metrics._common import mean, timed_replies

UNIT = "ms"
WORKLOADS = ["infer.robot_b1", "infer.robot_nofilter_b1"]


def read(records):
    return mean(r["latency_s"] * 1e3 - r["reply"]["timings_ms"]["infer"] - r["reply"]["timings_ms"]["collision"]
                for r in timed_replies(records))
