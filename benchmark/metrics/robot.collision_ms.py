"""The collision filter's time a request (postproc/collision.py after the
host voxel downsample): the reply's `timings_ms.collision`, a mean over
the window's untraced requests."""

from benchmark.metrics._common import mean, timed_replies

UNIT = "ms"
WORKLOADS = ["infer.robot_b1"]


def read(records):
    return mean(r["reply"]["timings_ms"]["collision"] for r in timed_replies(records))
