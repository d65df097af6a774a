"""The port's timing entry points on the CPU at `GraspNetConfig.tiny()`:
each runs with `--device cpu --tiny` and the shortest windows, prints every
stage name of its JAX counterpart under `scripts/` (read from that script's
`timeit` calls; the remat row of `crop_train_breakdown.py` has no PyTorch
counterpart), and writes a `dump_records` JSON with `backend: "cpu"`;
`bench` prints one JSON line with `bench.py`'s keys.  The times themselves
are host-clock numbers here and are not checked beyond being finite.
"""

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.ops import cuda as kernels
from graspnet_tpu_torch.scripts import bench_crop_kernels, crop_train_breakdown, profile_stages
from graspnet_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parents[1]
FAST = ["--device", "cpu", "--tiny", "--k-lo", "1", "--k-hi", "2"]


def jax_stage_names(script: str):
    """The literal stage names a JAX timing script passes to timeit."""
    tree = ast.parse((ROOT / "scripts" / script).read_text())
    return [
        node.args[0].value
        for node in ast.walk(tree)
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "timeit"
        and node.args and isinstance(node.args[0], ast.Constant)
    ]


def tiny_sa_names():
    """profile_stages.py's f-string SA rows at the tiny config."""
    cfg = GraspNetConfig.tiny()
    n_in = (cfg.num_point, cfg.sa1.npoint, cfg.sa2.npoint, cfg.sa3.npoint)
    return [f"sa{k + 1} ({n}->{sa.npoint}, ns={sa.nsample})"
            for k, (n, sa) in enumerate(zip(n_in, (cfg.sa1, cfg.sa2, cfg.sa3, cfg.sa4)))]


CASES = {
    "bench_crop_kernels": (bench_crop_kernels, jax_stage_names("bench_crop_kernels.py")),
    "profile_stages": (profile_stages, jax_stage_names("profile_stages.py") + tiny_sa_names()),
    "crop_train_breakdown": (
        crop_train_breakdown,
        [n for n in jax_stage_names("crop_train_breakdown.py") if "remat" not in n],
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_entry_point_prints_jax_stage_names_and_dumps(name, tmp_path, capsys):
    module, expected = CASES[name]
    out = tmp_path / f"{name}.json"
    records = module.main(FAST + ["--out", str(out)])
    printed = capsys.readouterr().out
    assert len(expected) >= 6
    for stage in expected:
        assert stage in printed, stage
        assert math.isfinite(records[stage])
    dumped = json.loads(out.read_text())
    assert dumped["backend"] == "cpu" and dumped["gpu"] is None
    assert dumped["source"] == f"graspnet_tpu_torch/scripts/{name}.py"
    assert dumped["stage_ms"] == records


def test_cpu_entry_points_launch_no_kernel():
    kernels.reset_launches()
    bench_crop_kernels.main(FAST)
    assert set(kernels.launches().values()) == {0}


def test_slope_timer_counts_calls_and_rejects_bad_windows():
    import torch

    calls = []
    timing.reset(2, 5)
    timing.timeit("count", lambda x: calls.append(1) or (x, [x * 2]), torch.ones(3))
    assert len(calls) == timing.calls_per_stage() == 1 + timing.REPS * 7
    assert list(timing.RECORDS) == ["count"] and timing.RUN["backend"] == "cpu"
    with pytest.raises(ValueError):
        timing.reset(3, 3)
    with pytest.raises(ValueError):
        timing.timeit("no tensor", lambda: 0)


def bench_py_keys():
    """The keys of bench.py's result dict."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    result = next(n.value for n in ast.walk(tree)
                  if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "result")
    return {k.value for k in result.keys}


def test_bench_prints_one_json_line_with_bench_py_keys():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run(
        [sys.executable, "-m", "graspnet_tpu_torch.scripts.bench", "--device", "cpu", "--tiny",
         "--frames", "2", "--repeats", "2", "--sync-frames", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert len(bench_py_keys()) == 10 and bench_py_keys() <= set(got)
    assert got["backend"] == "cpu" and got["gpu"] is None and got["vs_baseline"] is None
    assert len(got["observed_spread"]["frames_per_s_runs"]) == 2 and got["value"] > 0


def test_ab_ball_kernels_needs_a_card():
    """The side-by-side K3/K4 timer measures CUDA kernels only: without a
    card it exits before it starts any run, and prints no timing."""
    from graspnet_tpu_torch.scripts import ab_ball_kernels

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a card"):
            ab_ball_kernels.main(["--trees", "."])


def test_ab_scatter_needs_a_card_and_captures_a_steps_calls():
    """The side-by-side scatter-add timer measures CUDA kernels only:
    without a card it exits before it starts any run.  The calls it times
    are the five gathers that make a plan in a training-mode backbone
    forward: SA2-4's grouping and FP1-2's interpolation, with their input's
    channels and rows."""
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.models import GraspNet, init_weights
    from graspnet_tpu_torch.ops import scatter
    from graspnet_tpu_torch.scripts import ab_scatter

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a card"):
            ab_scatter.main(["--trees", "."])
    cfg = GraspNetConfig.tiny()
    backbone = init_weights(GraspNet(cfg), 0).backbone
    cloud = torch.rand(2, cfg.num_point, 3, generator=torch.Generator().manual_seed(0)) * 0.6 - 0.3
    calls = ab_scatter.capture_calls(scatter, backbone, cloud)
    assert scatter._plan is not None and len(calls) == 5
    want_n = [cfg.sa1.npoint, cfg.sa2.npoint, cfg.sa3.npoint, cfg.sa4.npoint, cfg.sa3.npoint]
    assert [n for _, _, n in calls] == want_n
    for (c, idx, n), sa in zip(calls[:3], (cfg.sa2, cfg.sa3, cfg.sa4)):
        assert idx.shape == (2, sa.npoint * sa.nsample) and 0 <= int(idx.min()) and int(idx.max()) < n
    for c, idx, n in calls[3:]:
        assert idx.shape[1] % 3 == 0


def test_ab_crop_scan_needs_a_card_and_reads_ptxas():
    """The side-by-side K5/K6/K8 scan timer measures CUDA kernels only:
    without a card it exits before it starts any run.  Its ptxas reader
    keeps the scan kernels' registers and spills and nothing else."""
    from graspnet_tpu_torch.scripts import ab_crop_scan

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a card"):
            ab_crop_scan.main(["--trees", "."])
    out = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120cylinder_scan_kernelILi1ELi8EEEvPKfS2_S2_Pv' for 'sm_90a'",
        "ptxas info    : Used 56 registers, 32 bytes smem, 420 bytes cmem[0]",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118seed_query_kernelEPKfS1_S1_Pli' for 'sm_90a'",
        "ptxas info    : Used 40 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116ball_scan_kernelEPKfS1_Plii' for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 40 registers, 32 bytes smem",
    ])
    got = ab_crop_scan.ptxas_scan_records(out)
    assert got == {"_ZN12_GLOBAL__N_120cylinder_scan_kernelILi1ELi8EEEvPKfS2_S2_Pv": {"registers": 56, "spill_bytes": 0},
                   "_ZN12_GLOBAL__N_116ball_scan_kernelEPKfS1_Plii": {"registers": 40, "spill_bytes": 12}}


def test_ab_sa_feat_needs_a_card_and_reads_ptxas():
    """The side-by-side K9/K10 timer measures CUDA kernels only: without a
    card it exits before it starts any run.  Its ptxas reader keeps the
    registers and spills of K9's MLP and K10 and nothing else."""
    from graspnet_tpu_torch.scripts import ab_sa_feat

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a card"):
            ab_sa_feat.main(["--trees", "."])
    out = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117sa_feat_tc_kernelILi2EEEvNS_6SaArgsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 167 registers, used 2 barriers, 64 bytes smem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116ball_scan_kernelEPKfS1_Plii' for 'sm_90a'",
        "ptxas info    : Used 40 registers, 32 bytes smem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117seed_query_kernelEPKfS1_S1_PlNS_9QueryArgsE' for 'sm_90a'",
        "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 50 registers, used 0 barriers",
    ])
    assert ab_sa_feat.ptxas_records(out) == {
        "_ZN12_GLOBAL__N_117sa_feat_tc_kernelILi2EEEvNS_6SaArgsE": {"registers": 167, "spill_bytes": 0},
        "_ZN12_GLOBAL__N_117seed_query_kernelEPKfS1_S1_PlNS_9QueryArgsE": {"registers": 50, "spill_bytes": 8}}


def jax_json_keys(script: str):
    """The keys of the dict a JAX training timing script prints: the literal
    in its json.dumps call, or the dict it assigns to `out`."""
    tree = ast.parse((ROOT / "scripts" / script).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "out" \
                and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no printed dict in {script}")


@pytest.mark.parametrize("name,argv", [
    ("bench_train", []),
    ("bench_train_pipeline", ["--steps", "2", "--warmup", "1", "--workers", "2"]),
])
def test_training_timing_scripts_print_jax_keys(name, argv, capsys):
    """`bench_train` and `bench_train_pipeline` at `--device cpu --tiny`:
    the last line is one JSON object holding every key the JAX script
    prints but the pipeline script's prose `note`, with finite times."""
    import importlib

    module = importlib.import_module(f"graspnet_tpu_torch.scripts.{name}")
    kernels.reset_launches()
    result = module.main(["--device", "cpu", "--tiny", "--k-lo", "1", "--k-hi", "2", *argv])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    expected = jax_json_keys(f"{name}.py") - {"note"}
    assert len(expected) >= 7 and expected <= set(line), expected - set(line)
    assert line["backend"] == "cpu" and line["gpu"] is None
    for key in ("value", "device_step_ms"):
        assert math.isfinite(line[key]) and line[key] > 0
    assert set(kernels.launches().values()) == {0}


def jax_dict_keys(script: str, name: str):
    """The keys of the dict literal assigned to `name` (or returned) in a JAX script."""
    tree = ast.parse((ROOT / "scripts" / script).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == name \
                and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys}
        if name == "return" and isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no dict {name} in {script}")


def test_bench_service_prints_jax_keys(capsys):
    """`bench_service` at `--device cpu --tiny`: one JSON object with every
    key of the JAX script's result and of each of its modes, the requests
    served at max_batch 1 and 8, a dispatch per request unbatched and fewer
    batched, and no kernel launched on the CPU."""
    from graspnet_tpu_torch.scripts import bench_service

    result = bench_service.main(["--device", "cpu", "--tiny", "--requests", "12", "--clients", "4"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    want = jax_dict_keys("bench_service.py", "result")
    assert {"value", "unit", "speedup_vs_unbatched", "modes"} <= want <= set(line), want - set(line)
    mode_keys = jax_dict_keys("bench_service.py", "return")
    assert "device_dispatches" in mode_keys
    unbatched, batched = line["modes"]
    for mode in (unbatched, batched):
        assert mode_keys <= set(mode), mode_keys - set(mode)
        assert mode["requests"] == mode["ok"] == 12 and math.isfinite(mode["requests_per_s"])
        assert set(mode["launches_per_dispatch"].values()) == {0}
    assert (unbatched["max_batch"], batched["max_batch"]) == (1, 8)
    assert unbatched["device_dispatches"] == 12 and 1 <= batched["device_dispatches"] <= 12
    assert line["unit"] == "requests/s" and line["backend"] == "cpu" and line["gpu"] is None
