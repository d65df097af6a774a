"""The Group-Free-3D cell (`drivers/detect_groupfree.py`) at a small size on
the CPU, past the harness's look for a chip: sound, it comes out correct;
with the timed path broken underneath, once for each fault it can have, it
comes out not correct.  Then its readers on a recorded trace, and the
operations its roofline and MFU readers count at the published widths."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import harness, roofline_groupfree, run, trace
from benchmark.reference.gf import Detector
from benchmark.tests.test_bench_detect import _no_nms, _shifted
from benchmark.tests.test_bench_readers import _trace

CELL = "infer.groupfree_scannet_b8"
CONFIG = "groupfree3d-scannet-L12-O512-w2x.infer"
SEED = 2**31 + 17  # more than 32 signed bits hold, as the checks' seeds do


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def overrides() -> dict:
    """`GroupFreeConfig.tiny()` as the configuration file's model and
    detector, 4 scans of 2,048 points in batches of 2; weight seed 1 leaves
    boxes non-empty and NMS drops some."""
    from graspnet_tpu_torch.config import GroupFreeConfig

    c = GroupFreeConfig.tiny()
    model = {f: (dataclasses.asdict(getattr(c, f)) if dataclasses.is_dataclass(getattr(c, f)) else getattr(c, f))
             for f in ("num_point", "input_feature_dim", "sa1", "sa2", "sa3", "sa4", "fp1_mlp", "fp2_mlp")}
    model["num_point"] = 2048
    det = {f.name: getattr(c, f.name) for f in dataclasses.fields(Detector)}
    det["mean_size"] = [list(s) for s in c.mean_size]
    return {"model": model, "detector": det, "weight_seed": 1,
            "params": {"scans": 4, "points": 2048, "batch_size": 2, "warm_requests": 1, "trace_requests": 2,
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
    assert {"gf.enqueue_ms", "gf.mfu_tf32_pct"} <= set(res["metrics"])


def _head_scaled(forward):
    """The last head's channels 1 % off."""
    def fwd(self, x):
        out = forward(self, x)
        out["head"] = out["head"] * 1.01
        return out
    return fwd


def _attention_off(q, k, v, heads):
    """The decoder with its attention replaced by the values' mean."""
    return v.mean(dim=1, keepdim=True).expand(-1, q.shape[1], -1).contiguous()


@pytest.mark.parametrize("fault", ["shifted_boxes", "no_nms", "head_scaled", "attention_off"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    from graspnet_tpu_torch.apps.detect import DetectionPipeline
    from graspnet_tpu_torch.models import groupfree
    from graspnet_tpu_torch.postproc import boxes

    def plant(_):
        if fault == "shifted_boxes":
            monkeypatch.setattr(DetectionPipeline, "finish", _shifted(DetectionPipeline.finish))
        elif fault == "no_nms":
            monkeypatch.setattr(boxes, "select", _no_nms(boxes.select))
        elif fault == "head_scaled":
            monkeypatch.setattr(groupfree.GroupFree3D, "forward", _head_scaled(groupfree.GroupFree3D.forward))
        else:
            monkeypatch.setattr(groupfree, "attention", _attention_off)

    res = _run(plant)
    assert not res["correct"], res["checks"]
    failed = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    want = {"shifted_boxes": {"box_gap"}, "no_nms": {"selection_diff"}, "head_scaled": {"head_gap"},
            "attention_off": {"head_gap"}}[fault]
    assert want <= failed, res["checks"]


def _records(summary):
    timings = {"detect.dispatch": 6.0, "detect.boxes": 1.0, "detect.fetch": 9.0, "detect": 15.5}
    reqs = [{"latency_s": 0.02, "reply": {"ok": True, "timings_ms": timings}, "error": None, "traced": False},
            {"latency_s": 0.03, "reply": {"ok": True, "timings_ms": timings}, "error": None, "traced": False},
            {"latency_s": 0.5, "reply": {"ok": True, "timings_ms": timings}, "error": None, "traced": True}]
    return {"requests": reqs, "trace": summary, "traced_requests": 2, "forward_flops": 495e9, "attn_bound_s": 1e-6,
            "decoder_device_s": 5e-4}


def test_readers_on_a_recorded_trace(tmp_path):
    """`_trace`'s stretch: 2 launches, device busy 200 us in which the
    kernel named like the attention's takes nothing (its name is not
    there), so the roofline reads nothing; the rest read their records."""
    got = {name: r.read(_records(trace.summarize(_trace(tmp_path)))) for name, r in
           harness.metric_readers(CELL).items()}
    assert set(got) == {"gf.decoder_device_ms", "gf.attn_roofline", "gf.mfu_tf32_pct", "gf.launches_per_request",
                        "gf.device_idle_pct", "gf.enqueue_ms"}
    assert got["gf.enqueue_ms"] == pytest.approx(6.0)
    assert got["gf.launches_per_request"] == pytest.approx(1.0)
    assert got["gf.attn_roofline"] is None
    assert got["gf.mfu_tf32_pct"] == pytest.approx(100 * 1e-3 / 0.025)
    assert got["gf.device_idle_pct"] == pytest.approx(100 * (1 - 200e-6 / 0.025))
    assert got["gf.decoder_device_ms"] == pytest.approx(0.25)
    summary = trace.summarize(_trace(tmp_path))
    summary["device_time_by_kernel"]["attn_fwd_kernel(float const*, ...)"] = 4e-6
    assert harness.metric_readers(CELL)["gf.attn_roofline"].read(_records(summary)) == pytest.approx(50.0)
    quiet = _records(trace.summarize(_trace(tmp_path, device=False)))
    for name in ("gf.launches_per_request", "gf.attn_roofline", "gf.device_idle_pct"):
        assert harness.metric_readers(CELL)[name].read(quiet) is None, name
    bare = {k: v for k, v in _records(None).items() if k != "decoder_device_s"}
    assert harness.metric_readers(CELL)["gf.decoder_device_ms"].read(bare) is None


def test_the_cells_other_readers_leave_it_alone():
    assert all(name.startswith("gf.") for name in harness.metric_readers(CELL))
    for cell in ("infer.robot_b1", "infer.votenet_scannet_b8", "train.recipe_b2"):
        assert not any(name.startswith("gf.") for name in harness.metric_readers(cell))


def test_roofline_counts_at_the_published_widths():
    """Group-Free-3D at batch 8: the backbone's ~324 GFLOP, the decoder's
    3.42 GFLOP a layer a scan, the attention's 87 GFLOP and its bound at
    the float32 CUDA-core peak."""
    from benchmark.reference import gn

    c = harness.load_json("configs", CONFIG)
    cfg = harness.model_config(c["model"], gn)
    det = Detector.from_fields(c["detector"])

    def mlp(rows, *w):
        return 2 * rows * sum(a * b for a, b in zip(w, w[1:]))

    backbone = (mlp(8 * 2048 * 64, 4, 128, 128, 256) + mlp(8 * 1024 * 32, 259, 256, 256, 512)
                + mlp(8 * 512 * 16, 515, 256, 256, 512) + mlp(8 * 256 * 16, 515, 256, 256, 512)
                + mlp(8 * 512, 1024, 512, 512) + mlp(8 * 1024, 1024, 512, 288))
    assert roofline_groupfree.backbone_flops(cfg, 8) == backbone and 320e9 < backbone < 330e9
    attn = 12 * 8 * 4 * 512 * (512 + 1024) * 288
    assert roofline_groupfree.attention_flops(cfg, det, 8) == attn
    assert roofline_groupfree.attention_bound_s(cfg, det, 8) == pytest.approx(attn / 67e12)
    layer = (mlp(512, 6, 288, 288) + mlp(1024, 3, 288, 288) + mlp(512, 288, 864) + 3 * mlp(512, 288, 288)
             + mlp(1024, 288, 576) + mlp(512, 288, 2048, 288) + mlp(512, 288, 288, 288, 96)
             + 4 * 512 * 1536 * 288)
    assert 3.40e9 < layer < 3.44e9
    head = mlp(1024, 288, 288, 288, 1) + mlp(512, 288, 288, 288, 96) + mlp(512, 288, 288) + mlp(1024, 288, 288)
    assert roofline_groupfree.decoder_flops(cfg, det, 8) == 8 * (12 * layer + head)
    assert roofline_groupfree.forward_flops(cfg, det, 8) == backbone + 8 * (12 * layer + head)


def test_the_config_file_holds_the_published_settings():
    c = harness.load_json("configs", CONFIG)
    assert c["reduced"] == [] and c["model"]["num_point"] == 50000 and c["model"]["input_feature_dim"] == 1
    assert c["source"] == "https://github.com/zeliu98/Group-Free-3D"
    d = c["detector"]
    assert (d["num_proposal"], d["num_decoder_layers"], d["nhead"], d["dim_feedforward"]) == (512, 12, 8, 2048)
    assert (d["num_class"], d["num_size_cluster"], d["num_heading_bin"]) == (18, 18, 1)
    assert c["model"]["fp2_mlp"][-1] == 288 and c["model"]["sa1"]["mlp"] == [4, 128, 128, 256]
    sizes = np.asarray(d["mean_size"])
    vn = harness.load_json("configs", "votenet-scannet.infer")
    assert sizes.shape == (18, 3) and np.array_equal(sizes, np.asarray(vn["detector"]["mean_size"]))
    w = harness.load_json("workloads", CELL)
    assert w["params"]["batch_size"] == 8 and w["params"]["points"] == 50000 and w["chips"] == 1
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert CONFIG in {e["name"] for e in spec["configs"]}
    latency = [m for m in spec["end_to_end"] if m["name"].startswith("latency_")]
    assert latency and all(CELL in m["workloads"] for m in latency)


def test_the_control_runs_the_same_comparison():
    """On the CPU TF32 does not exist, so the control reads what a sound
    run does: the same numbers, none past its limit."""
    from benchmark import control_groupfree

    got = control_groupfree.readings(CELL, SEED, device="cpu", overrides=overrides())
    limits = harness.load_json("workloads", CELL)["limits"]
    assert all(got[k] <= limits[k] for k in ("head_gap", "box_gap", "selection_diff"))
