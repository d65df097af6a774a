"""The detection pipeline's fetch a request (apps/detect.py): the
program's `detect.fetch` span (the wait for the device and the proposals'
rows to the host), a mean over the window's untraced requests."""

from benchmark.metrics._spans import request_ms

UNIT = "ms"
WORKLOADS = ["infer.votenet_scannet_b8"]


def read(records):
    return request_ms(records, "detect.fetch")
