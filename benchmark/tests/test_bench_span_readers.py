"""The readers of the program's own spans, on replies that carry them:
each gives the mean over the untraced requests, leaves a traced or failed
request out, and reads nothing when no reply carries its span."""

import pytest

from benchmark import harness

ROBOT = {"robot.sample_ms": "service.sample", "robot.enqueue_ms": "pipeline.dispatch",
         "robot.fetch_wait_ms": "pipeline.fetch", "robot.downsample_ms": "collision.downsample",
         "robot.detect_ms": "collision.detect", "robot.select_ms": "service.select"}


def _request(scale, traced=False, error=None, spans=True):
    """A request whose reply carries each span at `scale` ms."""
    timings = {"infer": 3 * scale, "collision": 2 * scale}
    if spans:
        timings.update({name: scale for name in ROBOT.values()})
    return {"latency_s": 0.04 * scale, "reply": {"ok": True, "timings_ms": timings}, "error": error,
            "traced": traced}


def test_robot_span_readers_mean_the_untraced_requests():
    readers = harness.metric_readers("infer.robot_b1")
    reqs = [_request(1.0), _request(3.0), _request(100.0, traced=True), _request(50.0, error="x"),
            _request(7.0, spans=False), {"latency_s": 0.01, "reply": {"ok": False}, "error": None, "traced": False}]
    for metric in ROBOT:
        assert readers[metric].read({"requests": reqs}) == pytest.approx(2.0), metric  # (1 + 3) / 2


def test_span_readers_read_nothing_without_spans():
    readers = harness.metric_readers("infer.robot_b1")
    older = {"requests": [_request(1.0, spans=False)]}  # a program whose replies carry no spans
    traced_only = {"requests": [_request(1.0, traced=True)]}
    for rec in (older, traced_only, {}):
        for name in ROBOT:
            assert readers[name].read(rec) is None, name
