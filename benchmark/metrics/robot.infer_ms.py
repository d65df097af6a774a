"""The host entry's time a request (apps/pipeline.py): the reply's
`timings_ms.infer` (enqueue, forward, decode, the rows' fetch), a mean
over the window's untraced requests."""

from benchmark.metrics._common import mean, timed_replies

UNIT = "ms"
WORKLOADS = ["infer.robot_b1", "infer.robot_nofilter_b1"]


def read(records):
    return mean(r["reply"]["timings_ms"]["infer"] for r in timed_replies(records))
