"""The segmentation pipeline's enqueue of a Point Transformer V3 request
(apps/segment.py): the program's `segment.dispatch` span (the batch to the
card, serialization with its host reads, the maps', forward's and
labels' launches), a mean over the window's untraced requests."""

from benchmark.metrics._spans import request_ms

UNIT = "ms"
WORKLOADS = ["infer.ptv3_scannet_b4"]


def read(records):
    return request_ms(records, "segment.dispatch")
