"""The collision filter's scan a request (postproc/collision.py): the
program's `collision.detect` span (the rows and points to the card, the
blocked scan, the masks' fetch), a mean over the window's untraced
requests."""

from benchmark.metrics._spans import request_ms

UNIT = "ms"
WORKLOADS = ["infer.robot_b1"]


def read(records):
    return request_ms(records, "collision.detect")
