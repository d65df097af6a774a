"""The host entry's enqueue a request (apps/pipeline.py): the program's
`pipeline.dispatch` span (the cloud to the card, the forward's and the
decode's launches), a mean over the window's untraced requests."""

from benchmark.metrics._spans import request_ms

UNIT = "ms"
WORKLOADS = ["infer.robot_b1"]


def read(records):
    return request_ms(records, "pipeline.dispatch")
