"""The Point Transformer V3 cell (`drivers/segment_ptv3.py`) at a small size
on the CPU, past the harness's look for a chip: sound, it comes out
correct; with the timed path broken underneath, once for each fault it can
have, it comes out not correct; without the program's segmentation path
(the commit before it) it fails at once.  Then its readers on a recorded
trace, the operations its roofline and MFU readers count at the published
widths, and the configuration and cell files."""

import dataclasses
import json
import sys
import time

import pytest
import torch

from benchmark import harness, roofline_ptv3, run, trace
from benchmark.reference import ptv3 as ref
from benchmark.tests.test_bench_readers import _trace

CELL = "infer.ptv3_scannet_b4"
CONFIG = "ptv3m1-scannet-semseg.infer"
SEED = 2**31 + 17  # more than 32 signed bits hold, as the checks' seeds do


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def overrides() -> dict:
    """`PTv3Config.tiny()` as the configuration file's model, 4 fragments of
    150 to 300 points in batches of 2."""
    from graspnet_tpu_torch.config import PTv3Config

    model = {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(PTv3Config.tiny()).items()}
    params = {"fragments": 4, "points": 300, "scene_points": [150, 400], "batch_size": 2, "warm_requests": 1,
              "trace_requests": 2, "check_batches": 2}
    return {"model": {**model, "stride": [2, 2, 2, 2]}, "params": params}


def _run(fault=None, trace_on=False):
    return run.run_cell(CELL, SEED, 1.0, trace_on, device="cpu", overrides=overrides(), fault=fault)


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == {"logit_gap", "label_diff", "order_diff", "failed_requests"}
    assert {"latency_p50_ms", "latency_p95_ms", "setup_s"} <= set(res["metrics"])


def test_a_traced_run_reads_the_span_metrics_and_is_correct():
    res = _run(trace_on=True)
    assert res["correct"], res["checks"]
    # on the CPU the profiler records no device event: the device readers read nothing
    assert {"pt.enqueue_ms", "pt.mfu_tf32_pct"} <= set(res["metrics"])


def _scaled(finish):
    def fin(self, handle):
        out = finish(self, handle)
        for s in out:
            s.logits *= 1.01
        return out
    return fin


def _swapped(serialize):
    """The third order of stage 1 with two entries exchanged."""
    def ser(*args):
        stages = serialize(*args)
        stages[1].order[2, :2] = stages[1].order[2, :2].flip(0)
        return stages
    return ser


def _map_shifted(kernel_maps):
    """Every stage's map with its first offset's column set to the centre's."""
    def km(stages, cfg):
        stem, hits = kernel_maps(stages, cfg)
        for st in stages:
            st.kmap[:, 0] = st.kmap[:, st.kmap.shape[1] // 2]
        return stem, hits
    return km


@pytest.mark.parametrize("fault", ["logits_scaled", "attention_off", "order_swapped", "map_shifted"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    from graspnet_tpu_torch.apps.segment import SegmentationPipeline
    from graspnet_tpu_torch.models import ptv3

    def plant(_):
        if fault == "logits_scaled":
            monkeypatch.setattr(SegmentationPipeline, "finish", _scaled(SegmentationPipeline.finish))
        elif fault == "attention_off":
            monkeypatch.setattr(ptv3, "attention_varlen", lambda qkv, starts, h, m: qkv[:, 2 * qkv.shape[1] // 3:])
        elif fault == "order_swapped":
            monkeypatch.setattr(ptv3, "serialize", _swapped(ptv3.serialize))
        else:
            monkeypatch.setattr(ptv3, "kernel_maps", _map_shifted(ptv3.kernel_maps))

    res = _run(plant)
    assert not res["correct"], res["checks"]
    failed = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    want = {"logits_scaled": {"logit_gap"}, "attention_off": {"logit_gap"}, "order_swapped": {"order_diff"},
            "map_shifted": {"order_diff", "logit_gap"}}[fault]
    assert want <= failed, res["checks"]


def test_without_the_segmentation_path_the_cell_fails_at_once(monkeypatch):
    """The commit before the program had `apps/segment.py`: the first
    import of `drivers/segment_ptv3.py::run` raises before any input is
    made."""
    monkeypatch.setitem(sys.modules, "graspnet_tpu_torch.apps.segment", None)
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        _run()
    assert time.perf_counter() - t0 < 5.0


def _records(summary):
    timings = {"segment.dispatch": 6.0, "segment.serialize": 2.0, "segment.fetch": 9.0, "segment": 15.5}
    reqs = [{"latency_s": 0.02, "reply": {"ok": True, "timings_ms": timings}, "error": None, "traced": False},
            {"latency_s": 0.03, "reply": {"ok": True, "timings_ms": timings}, "error": None, "traced": False},
            {"latency_s": 0.5, "reply": {"ok": True, "timings_ms": timings}, "error": None, "traced": True}]
    return {"requests": reqs, "trace": summary, "traced_requests": 2, "forward_flops": 495e9, "attn_bound_s": 1e-6,
            "spconv_bound_s": 2e-6, "serialize_device_s": 5e-4}


def test_readers_on_a_recorded_trace(tmp_path):
    """`_trace`'s stretch: 2 launches, device busy 200 us, in which neither
    kernel is named like the attention's or the convolution's, so the
    rooflines read nothing; the rest read their records."""
    got = {name: r.read(_records(trace.summarize(_trace(tmp_path)))) for name, r in
           harness.metric_readers(CELL).items()}
    assert set(got) == {"pt.attn_roofline", "pt.spconv_roofline", "pt.serialize_device_ms",
                        "pt.launches_per_request", "pt.device_idle_pct", "pt.mfu_tf32_pct", "pt.enqueue_ms"}
    assert got["pt.enqueue_ms"] == pytest.approx(6.0)
    assert got["pt.launches_per_request"] == pytest.approx(1.0)
    assert got["pt.attn_roofline"] is None and got["pt.spconv_roofline"] is None
    assert got["pt.mfu_tf32_pct"] == pytest.approx(100 * 1e-3 / 0.025)
    assert got["pt.device_idle_pct"] == pytest.approx(100 * (1 - 200e-6 / 0.025))
    assert got["pt.serialize_device_ms"] == pytest.approx(0.25)
    summary = trace.summarize(_trace(tmp_path))
    summary["device_time_by_kernel"]["void attn_fwd_kernel<16, true>(float const*, ...)"] = 4e-6
    summary["device_time_by_kernel"]["void subm_conv_kernel<64, true>(float const*, ...)"] = 8e-6
    readers = harness.metric_readers(CELL)
    assert readers["pt.attn_roofline"].read(_records(summary)) == pytest.approx(50.0)
    assert readers["pt.spconv_roofline"].read(_records(summary)) == pytest.approx(50.0)
    quiet = _records(trace.summarize(_trace(tmp_path, device=False)))
    for name in ("pt.launches_per_request", "pt.attn_roofline", "pt.spconv_roofline", "pt.device_idle_pct"):
        assert readers[name].read(quiet) is None, name
    bare = {k: v for k, v in _records(None).items() if k not in ("serialize_device_s", "forward_flops")}
    for name in ("pt.serialize_device_ms", "pt.mfu_tf32_pct", "pt.attn_roofline"):
        assert readers[name].read(bare) is None, name


def test_the_cells_other_readers_leave_it_alone():
    assert all(name.startswith("pt.") for name in harness.metric_readers(CELL))
    for cell in ("infer.robot_b1", "infer.votenet_scannet_b8", "infer.groupfree_scannet_b8", "train.recipe_b2"):
        assert not any(name.startswith("pt.") for name in harness.metric_readers(cell))


def _stats(n0=409600, fragments=4, k=1024, density=10):
    """A batch of `fragments` x n0 / 4 points at stage 0, a quarter as
    many at each stage below, every fragment padded to patches of k, each
    site with `density` neighbours (the stem's map 3 x as many)."""
    stages = []
    n = n0
    for _ in range(5):
        per = n // fragments
        lengths = ([k] * -(-per // k) if per > k else [per]) * fragments
        stages.append({"n": n, "lengths": lengths, "hits": density * n})
        n //= 4
    return {"stages": stages, "stem_hits": 3 * density * n0}


def test_roofline_counts_at_the_published_widths():
    """Point Transformer V3 at 4 x 102,400 points: the attention's 4 L^2 C
    a sequence and block, the convolutions' 2 hits C^2, the dense 26 N C^2
    a block, pooling and unpooling, the head; about 1.1 TFLOP a batch."""
    from graspnet_tpu_torch.config import PTv3Config

    cfg = PTv3Config()
    st = _stats()
    blocks = [(c, s, d) for s, (c, d) in enumerate(zip(cfg.enc_channels, cfg.enc_depths))] + \
             [(c, s, d) for s, (c, d) in enumerate(zip(cfg.dec_channels, cfg.dec_depths))]
    attn = sum(d * 4 * c * sum(n * n for n in st["stages"][s]["lengths"]) for c, s, d in blocks)
    assert roofline_ptv3.attention_flops(cfg, st) == attn
    conv = 2 * st["stem_hits"] * 6 * 32 + sum(d * 2 * st["stages"][s]["hits"] * c * c for c, s, d in blocks)
    assert roofline_ptv3.spconv_flops(cfg, st) == conv
    dense = sum(d * 26 * st["stages"][s]["n"] * c * c for c, s, d in blocks)
    ns = [s["n"] for s in st["stages"]]
    dense += sum(2 * ns[s - 1] * cfg.enc_channels[s - 1] * cfg.enc_channels[s] for s in range(1, 5))
    ins = list(cfg.dec_channels[1:]) + [cfg.enc_channels[-1]]
    dense += sum(2 * cfg.dec_channels[s] * (ns[s + 1] * ins[s] + ns[s] * cfg.enc_channels[s]) for s in range(4))
    dense += 2 * ns[0] * 64 * 20
    assert roofline_ptv3.dense_flops(cfg, st) == dense
    total = roofline_ptv3.forward_flops(cfg, st)
    assert total == attn + conv + dense and 0.9e12 < total < 1.4e12
    assert roofline_ptv3.attention_bound_s(cfg, st) == pytest.approx(attn / 67e12)
    assert roofline_ptv3.spconv_bound_s(cfg, st) == pytest.approx(conv / 67e12)


def test_the_config_and_cell_files_hold_the_published_settings():
    c = harness.load_json("configs", CONFIG)
    assert c["reduced"] == [] and c["precision"] == "float32, TF32 off"
    assert c["source"] == "https://github.com/Pointcept/PointTransformerV3"
    m = c["model"]
    assert (m["enc_depths"], m["enc_channels"], m["enc_num_head"]) == ([2, 2, 2, 6, 2], [32, 64, 128, 256, 512],
                                                                       [2, 4, 8, 16, 32])
    assert (m["dec_depths"], m["dec_channels"], m["dec_num_head"]) == ([2, 2, 2, 2], [64, 64, 128, 256],
                                                                       [4, 4, 8, 16])
    assert set(m["enc_patch_size"] + m["dec_patch_size"]) == {1024}
    assert m["order"] == ["z", "z-trans", "hilbert", "hilbert-trans"] and m["stride"] == [2, 2, 2, 2]
    assert (m["in_channels"], m["num_classes"], m["grid_size"], m["mlp_ratio"]) == (6, 20, 0.02, 4)
    w = harness.load_json("workloads", CELL)
    assert w["params"]["batch_size"] == 4 and w["params"]["points"] == 102400 and w["chips"] == 1
    assert w["params"]["scene_points"] == [40960, 128000]
    assert w["limits"]["label_diff"] == w["limits"]["order_diff"] == w["limits"]["failed_requests"] == 0
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert CONFIG in {e["name"] for e in spec["configs"]} and CELL in {e["name"] for e in spec["workloads"]}
    latency = [m for m in spec["end_to_end"] if m["name"].startswith("latency_")]
    assert latency and all(CELL in m["workloads"] for m in latency)
    pt = [m for m in spec["per_layer"] if m["name"].startswith("pt.")]
    assert len(pt) == 7 and all(m["workloads"] == [CELL] and m["moves"] == "latency_p50_ms" for m in pt)


def test_the_control_runs_the_same_comparison():
    """On the CPU TF32 does not exist, so the control reads what a sound
    run does: the same numbers, none past its limit."""
    from benchmark import control_ptv3

    got = control_ptv3.readings(CELL, SEED, device="cpu", overrides=overrides())
    limits = harness.load_json("workloads", CELL)["limits"]
    assert all(got[k] <= limits[k] for k in ("logit_gap", "label_diff", "order_diff"))
