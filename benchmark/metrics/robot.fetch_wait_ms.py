"""The host entry's fetch a request (apps/pipeline.py): the program's
`pipeline.fetch` span (the wait for the device and the rows' copy to the
host, the groups built), a mean over the window's untraced requests."""

from benchmark.metrics._spans import request_ms

UNIT = "ms"
WORKLOADS = ["infer.robot_b1"]


def read(records):
    return request_ms(records, "pipeline.fetch")
