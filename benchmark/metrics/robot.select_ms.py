"""The service's selection a request (apps/service.py): the program's
`service.select` span (the sort, the host NMS, the mask and world filters,
the top-K), a mean over the window's untraced requests."""

from benchmark.metrics._spans import request_ms

UNIT = "ms"
WORKLOADS = ["infer.robot_b1"]


def read(records):
    return request_ms(records, "service.select")
