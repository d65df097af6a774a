"""The whole request's share of the card's dense TF32 peak: a batch's Point
Transformer V3 FLOPs (`roofline_ptv3.forward_flops`: attention, sparse
convolutions and dense products at the pool's stage sizes) over the mean
request latency of the window's untraced requests x 495 TFLOP/s."""

from benchmark.metrics._common import mean, untraced
from benchmark.roofline import PEAK_TF32_FLOPS

UNIT = "%"
WORKLOADS = ["infer.ptv3_scannet_b4"]


def read(records):
    lat = mean(r["latency_s"] for r in untraced(records))
    if not lat or "forward_flops" not in records:
        return None
    return 100.0 * records["forward_flops"] / (lat * PEAK_TF32_FLOPS)
