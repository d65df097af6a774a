"""The box post-processing's enqueue a request (postproc/boxes.py): the
program's `detect.boxes` span (the empty-box count, the NMS sweeps and the
per-class scores launched), a mean over the window's untraced requests."""

from benchmark.metrics._spans import request_ms

UNIT = "ms"
WORKLOADS = ["infer.votenet_scannet_b8"]


def read(records):
    return request_ms(records, "detect.boxes")
