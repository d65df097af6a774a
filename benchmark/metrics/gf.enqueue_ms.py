"""The detection pipeline's enqueue of a Group-Free-3D request
(apps/detect.py): the program's `detect.dispatch` span (the batch to the
card, the forward's, decoder's, decode's and post-processing's launches),
a mean over the window's untraced requests."""

from benchmark.metrics._spans import request_ms

UNIT = "ms"
WORKLOADS = ["infer.groupfree_scannet_b8"]


def read(records):
    return request_ms(records, "detect.dispatch")
