"""The collision filter's host downsample a request (postproc/collision.py):
the program's `collision.downsample` span (the native voxel downsample
of the raw capture), a mean over the window's untraced requests."""

from benchmark.metrics._spans import request_ms

UNIT = "ms"
WORKLOADS = ["infer.robot_b1"]


def read(records):
    return request_ms(records, "collision.downsample")
