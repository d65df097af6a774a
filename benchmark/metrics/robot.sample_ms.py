"""The service's sampling a request (apps/service.py): the program's
`service.sample` span (the depth window and the random sample of the
capture to num_point points), a mean over the window's untraced requests."""

from benchmark.metrics._spans import request_ms

UNIT = "ms"
WORKLOADS = ["infer.robot_b1"]


def read(records):
    return request_ms(records, "service.sample")
