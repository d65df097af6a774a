"""The detection cell (`drivers/detect.py`) at a small size on the CPU, past
the harness's look for a chip: sound, it comes out correct; with the timed
path broken underneath, once for each fault it can have, it comes out not
correct.  Then its readers on a recorded trace, and the operations its
roofline and MFU readers count at the published widths."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import harness, roofline_detect, run, trace
from benchmark.reference.vn import Detector
from benchmark.tests.test_bench_readers import _trace

CELL = "infer.votenet_scannet_b8"
SEED = 2**31 + 17  # more than 32 signed bits hold, as the checks' seeds do


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def overrides() -> dict:
    """`VoteNetConfig.tiny()` as the configuration file's model and detector,
    4 scans of its 1024 points in batches of 2."""
    from graspnet_tpu_torch.config import VoteNetConfig

    c = VoteNetConfig.tiny()
    model = {f: (dataclasses.asdict(getattr(c, f)) if dataclasses.is_dataclass(getattr(c, f)) else getattr(c, f))
             for f in ("num_point", "input_feature_dim", "sa1", "sa2", "sa3", "sa4", "fp1_mlp", "fp2_mlp")}
    det = {f.name: getattr(c, f.name) for f in dataclasses.fields(Detector)}
    det["mean_size"] = [list(s) for s in c.mean_size]
    return {"model": model, "detector": det, "weight_seed": 1,
            "params": {"scans": 4, "points": c.num_point, "batch_size": 2, "warm_requests": 1, "trace_requests": 2,
                       "check_batches": 2}}


def _run(fault=None, trace_on=False):
    return run.run_cell(CELL, SEED, 1.0, trace_on, device="cpu", overrides=overrides(), fault=fault)


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == {"head_gap", "box_gap", "selection_diff", "failed_requests"}
    assert {"latency_p50_ms", "latency_p95_ms", "setup_s"} <= set(res["metrics"])


def test_a_traced_run_reads_the_span_metrics_and_is_correct():
    res = _run(trace_on=True)
    assert res["correct"], res["checks"]
    # on the CPU the profiler records no device event: the device readers read nothing
    assert {"det.enqueue_ms", "det.fetch_wait_ms", "det.boxes_ms", "det.mfu_tf32_pct"} <= set(res["metrics"])


def _shifted(finish):
    """Every proposal's corners moved by 0.01 where the rows reach the host."""
    def fetch(self, handle):
        dets = finish(self, handle)
        for d in dets:
            d.rows[:, :6] += 0.01
        return dets
    return fetch


def _no_nms(select):
    """The post-processing with no box suppressed: every non-empty box picked."""
    def select_all(rows, state):
        rows, sweeps = select(rows, state)
        rows[..., 10] = rows[..., 9]
        rows[..., 11] = rows[..., 9] * state[2]
        return rows, sweeps
    return select_all


def _head_scaled(forward):
    """The proposal channels 1 % off."""
    def fwd(self, x):
        out = forward(self, x)
        out["head"] = out["head"] * 1.01
        return out
    return fwd


@pytest.mark.parametrize("fault", ["shifted_boxes", "no_nms", "head_scaled"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    from graspnet_tpu_torch.apps.detect import DetectionPipeline
    from graspnet_tpu_torch.models.votenet import VoteNet
    from graspnet_tpu_torch.postproc import boxes

    def plant(_):
        if fault == "shifted_boxes":
            monkeypatch.setattr(DetectionPipeline, "finish", _shifted(DetectionPipeline.finish))
        elif fault == "no_nms":
            monkeypatch.setattr(boxes, "select", _no_nms(boxes.select))
        else:
            monkeypatch.setattr(VoteNet, "forward", _head_scaled(VoteNet.forward))

    res = _run(plant)
    assert not res["correct"], res["checks"]
    failed = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    want = {"shifted_boxes": {"box_gap"}, "no_nms": {"selection_diff"}, "head_scaled": {"head_gap"}}[fault]
    assert want <= failed, res["checks"]
    if fault == "shifted_boxes":
        assert res["checks"]["box_gap"]["value"] == pytest.approx(0.01, rel=1e-3)


def _records(summary):
    timings = {"detect.dispatch": 6.0, "detect.boxes": 1.0, "detect.fetch": 9.0, "detect": 15.5}
    reqs = [{"latency_s": 0.02, "reply": {"ok": True, "timings_ms": timings}, "error": None, "traced": False},
            {"latency_s": 0.03, "reply": {"ok": True, "timings_ms": timings}, "error": None, "traced": False},
            {"latency_s": 0.5, "reply": {"ok": True, "timings_ms": timings}, "error": None, "traced": True}]
    return {"requests": reqs, "trace": summary, "traced_requests": 2, "forward_flops": 495e9, "fps_bound_s": 1e-6,
            "span_counts": {"detect.boxes": {"proposals": 8}, "detect.nms": {"sweeps": 6}}, "boxes_device_s": 5e-4}


def test_readers_on_a_recorded_trace(tmp_path):
    got = {name: r.read(_records(trace.summarize(_trace(tmp_path)))) for name, r in
           harness.metric_readers(CELL).items()}
    assert set(got) == {"det.enqueue_ms", "det.fetch_wait_ms", "det.boxes_ms", "det.launches_per_request",
                        "det.fps_roofline", "det.mfu_tf32_pct", "det.device_idle_pct", "det.boxes_device_ms",
                        "det.nms_sweeps"}
    assert got["det.enqueue_ms"] == pytest.approx(6.0) and got["det.fetch_wait_ms"] == pytest.approx(9.0)
    assert got["det.boxes_ms"] == pytest.approx(1.0)
    assert got["det.launches_per_request"] == pytest.approx(1.0)
    assert got["det.fps_roofline"] == pytest.approx(100 * 1e-6 / 100e-6)
    assert got["det.mfu_tf32_pct"] == pytest.approx(100 * 1e-3 / 0.025)
    assert got["det.device_idle_pct"] == pytest.approx(100 * (1 - 200e-6 / 0.025))
    assert got["det.boxes_device_ms"] == pytest.approx(0.25) and got["det.nms_sweeps"] == pytest.approx(3.0)
    quiet = _records(trace.summarize(_trace(tmp_path, device=False)))
    for name in ("det.launches_per_request", "det.fps_roofline", "det.device_idle_pct"):
        assert harness.metric_readers(CELL)[name].read(quiet) is None, name
    # a program with no such spans (the parent's) leaves both out
    bare = {k: v for k, v in _records(None).items() if k not in ("span_counts", "boxes_device_s")}
    for name in ("det.boxes_device_ms", "det.nms_sweeps"):
        assert harness.metric_readers(CELL)[name].read(bare) is None, name


def test_kernels_launched_under_a_span_are_summed(tmp_path):
    """The post-processing's device time: the kernels whose launch call lies
    inside a named annotation on its thread, matched by correlation id."""
    from benchmark.drivers import detect

    ann = [{"name": "detect.boxes", "cat": "user_annotation", "ts": 100.0, "dur": 50.0, "tid": 1},
           {"name": "detect.nms", "cat": "user_annotation", "ts": 300.0, "dur": 50.0, "tid": 1}]
    launches = [{"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": t, "dur": 2.0, "tid": tid,
                 "args": {"correlation": c}} for t, tid, c in
                [(110.0, 1, 1), (200.0, 1, 2), (310.0, 1, 3), (120.0, 2, 4)]]
    launches.append({"name": "cuLaunchKernel", "cat": "cuda_driver", "ts": 320.0, "dur": 2.0, "tid": 1,
                     "args": {"correlation": 5}})
    kernels = [{"name": f"k{c}", "cat": "kernel", "ts": 400.0, "dur": 10.0 * c, "tid": 7, "args": {"correlation": c}}
               for c in range(1, 6)]
    copy = {"name": "Memcpy DtoH", "cat": "gpu_memcpy", "ts": 500.0, "dur": 99.0, "tid": 7,
            "args": {"correlation": 3}}
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": ann + launches + kernels + [copy]}))
    # correlations 1, 3 and 5: inside a span on thread 1; 2 is outside both, 4 on another thread
    assert detect._kernel_seconds_under(str(p), ("detect.boxes", "detect.nms")) == pytest.approx(90e-6)
    assert detect._kernel_seconds_under(str(p), ("detect.boxes",)) == pytest.approx(10e-6)


def test_the_cells_other_readers_leave_it_alone():
    """The robot and training readers do not list the new cell."""
    assert all(name.startswith("det.") for name in harness.metric_readers(CELL))


def test_roofline_counts_at_the_published_widths():
    """VoteNet at batch 8: the MLPs' products, layer by layer (about 90
    GFLOP, SA1 and SA2 two thirds of it), and K1's bound against the
    cascade's operations."""
    c = harness.load_json("configs", "votenet-scannet.infer")
    from benchmark.reference import gn

    cfg = harness.model_config(c["model"], gn)
    det = Detector.from_fields(c["detector"])
    flops = roofline_detect.forward_flops(cfg, det, 8)
    def mlp(rows, *w):
        return 2 * rows * sum(a * b for a, b in zip(w, w[1:]))

    want = (mlp(8 * 2048 * 64, 4, 64, 64, 128) + mlp(8 * 1024 * 32, 131, 128, 128, 256)
            + mlp(8 * 512 * 16, 259, 128, 128, 256) + mlp(8 * 256 * 16, 259, 128, 128, 256)
            + mlp(8 * 512, 512, 256, 256) + mlp(8 * 1024, 512, 256, 256)
            + mlp(8 * 1024, 256, 256, 256, 259) + mlp(8 * 256 * 16, 259, 128, 128, 128)
            + mlp(8 * 256, 128, 128, 128, 97))
    assert flops == want and 85e9 < flops < 95e9
    steps = 8 * (2047 * 40000 + 1023 * 2048 + 511 * 1024 + 255 * 512 + 255 * 1024)
    assert roofline_detect.fps_bound_s(cfg, det, 8) == pytest.approx(steps * 9 / 67e12)


def test_the_config_file_holds_the_published_settings():
    c = harness.load_json("configs", "votenet-scannet.infer")
    assert c["reduced"] == [] and c["model"]["num_point"] == 40000 and c["model"]["input_feature_dim"] == 1
    d = c["detector"]
    assert (d["num_proposal"], d["num_class"], d["num_size_cluster"], d["num_heading_bin"]) == (256, 18, 18, 1)
    sizes = np.asarray(d["mean_size"])
    assert sizes.shape == (18, 3) and sizes.min() >= 0.2 and sizes.max() <= 2.0
    w = harness.load_json("workloads", CELL)
    assert w["params"]["batch_size"] == 8 and w["params"]["points"] == 40000 and w["chips"] == 1
    assert c["name"] in {e["name"] for e in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["configs"]}


def test_the_control_runs_the_same_comparison():
    """On the CPU TF32 does not exist, so the control reads what a sound
    run does: the same numbers, none past its limit."""
    from benchmark import control_detect

    got = control_detect.readings(CELL, SEED, device="cpu", overrides=overrides())
    limits = harness.load_json("workloads", CELL)["limits"]
    assert all(got[k] <= limits[k] for k in ("head_gap", "box_gap", "selection_diff"))
