"""The per-layer readers and the trace reduction on a recorded small trace,
and the guard against a profiler window with no device events."""

import json

import pytest

from benchmark import harness, trace


def _trace(tmp_path, device=True):
    ev = [
        {"name": trace.WINDOW_SPAN, "cat": "user_annotation", "ts": 1000.0, "dur": 1000.0, "tid": 1},
        {"name": "aten::mm", "cat": "cpu_op", "ts": 1000.0, "dur": 300.0, "tid": 1},
        {"name": "aten::cat", "cat": "cpu_op", "ts": 1400.0, "dur": 500.0, "tid": 1},
        {"name": "inner", "cat": "cpu_op", "ts": 1500.0, "dur": 100.0, "tid": 1},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 1010.0, "dur": 5.0, "tid": 1},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 1410.0, "dur": 5.0, "tid": 1},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 2500.0, "dur": 5.0, "tid": 1},
    ]
    if device:
        ev += [
            {"name": "void fps_cluster_kernel<256>", "cat": "kernel", "ts": 1100.0, "dur": 200.0, "tid": 7},
            {"name": "void mlp_bwd_pass_b_kernel", "cat": "kernel", "ts": 1250.0, "dur": 150.0, "tid": 7},
            {"name": "Memcpy DtoH", "cat": "gpu_memcpy", "ts": 1900.0, "dur": 200.0, "tid": 7},
        ]
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return str(p)


def test_summary_of_a_small_trace(tmp_path):
    s = trace.summarize(_trace(tmp_path))
    assert s["window_s"] == pytest.approx(1e-3)
    # device intervals 1100-1400 (two overlapping kernels) and 1900-2000 (clipped at the window)
    assert s["busy_s"] == pytest.approx(400e-6)
    assert s["launches"] == 2
    assert trace.kernel_seconds(s, "fps_cluster_kernel") == pytest.approx(200e-6)
    # idle 1000-1100 under aten::mm, 1400-1900 under aten::cat (its midpoint 1650: not "inner")
    assert s["idle_gaps"] == pytest.approx({"aten::mm": 100e-6, "aten::cat": 500e-6})
    b = trace.breakdown(s)
    assert b["device_ops"][0][0].startswith("void fps_cluster_kernel") and len(b["idle_gaps"]) == 2


def _records(summary):
    reply = {"ok": True, "timings_ms": {"infer": 8.0, "collision": 3.0}}
    reqs = [{"latency_s": 0.02, "reply": reply, "error": None, "traced": False},
            {"latency_s": 0.03, "reply": reply, "error": None, "traced": False},
            {"latency_s": 0.5, "reply": reply, "error": None, "traced": True}]
    return {"requests": reqs, "trace": summary, "traced_requests": 2, "forward_flops": 495e9,
            "fps_bound_s": 1e-6, "traced_steps": 2, "k7_bwd_bound_s": 3e-6, "spans": [0.004, 0.006],
            "step_flops": 495e9, "window_steps": 10, "window_s": 2.0, "untraced_step_s": [0.1, 0.3],
            "batch_size": 2}


def test_readers_on_the_recorded_trace(tmp_path):
    rec = _records(trace.summarize(_trace(tmp_path)))
    got = {name: r.read(rec) for name, r in harness.metric_readers("infer.robot_b1").items()}
    assert got["robot.service_host_ms"] == pytest.approx(14.0)
    assert got["robot.infer_ms"] == pytest.approx(8.0)
    assert got["robot.collision_ms"] == pytest.approx(3.0)
    assert got["robot.launches_per_request"] == pytest.approx(1.0)
    assert got["robot.fps_roofline"] == pytest.approx(100 * 1e-6 / 100e-6)
    assert got["robot.mfu_tf32_pct"] == pytest.approx(100 * 1e-3 / 0.025)
    # 400 us busy over 2 traced requests, against the untraced mean latency of 25 ms
    assert got["robot.device_idle_pct"] == pytest.approx(100 * (1 - 200e-6 / 0.025))
    train = {name: r.read(rec) for name, r in harness.metric_readers("train.recipe_b2").items()}
    assert train["train.host_prep_ms"] == pytest.approx(5.0)
    assert train["train.device_busy_ms"] == pytest.approx(0.2)
    assert train["train.mlp_bwd_roofline"] == pytest.approx(100 * 3e-6 / 75e-6)
    assert train["train.mfu_tf32_pct"] == pytest.approx(100 * 1e-3 / 0.2)
    assert train["train.scenes_per_s"] == pytest.approx(2 * 2 / 0.4)
    # 400 us busy over 2 traced steps, against the untraced mean step of 0.2 s
    assert train["train.device_idle_pct"] == pytest.approx(100 * (1 - 200e-6 / 0.2))


def test_a_window_without_device_events_reads_nothing(tmp_path):
    rec = _records(trace.summarize(_trace(tmp_path, device=False)))
    assert rec["trace"]["busy_s"] is None
    for cell in ("infer.robot_b1", "train.recipe_b2"):
        for name, r in harness.metric_readers(cell).items():
            if name.endswith(("_roofline", "idle_pct", "busy_ms", "launches_per_request")):
                assert r.read(rec) is None, name


def test_a_metric_file_without_workloads_is_refused(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "any.metric.py").write_text("UNIT = 'ms'\n\n\ndef read(records):\n    return 1.0\n")
    monkeypatch.setattr(harness, "BENCH", tmp_path)
    monkeypatch.setattr(harness, "ROOT", tmp_path.parent)
    with pytest.raises(ValueError, match="WORKLOADS"):
        harness.metric_readers("infer.robot_b1")
