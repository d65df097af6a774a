"""The port's eval dump loop (`apps/test.py`), its tracing and its scripts
on the CPU.

* `apps/test.py::inference` at `GraspNetConfig.tiny()` on
  `tests/mini_dataset.py`, the collision filter at 0.01, batch 2 (a padded
  tail batch), against the JAX `apps/test.py` with the same weights (the
  JAX parameters through a reference `.tar` for the JAX pipeline and
  `checkpoint.params_from_jax` for the port): the same frame files, the
  same rows after the filter (selection fields equal, floats within 1e-5,
  the decode's own tolerance in `tests/test_torch_port_pipeline.py`), and
  `evaluate` gives the same AP to 2 decimals.
* The CLI: one card (`--devices` other than 1 is an argparse error), the
  card by default, `--profile_dir` writes a trace.
* `utils/tracing.py` as the loop uses it: the stage means from spans
  recorded on contending threads, the spans in a profiler's trace.
* The scripts at `--device cpu --tiny`: `bench_test_app` (every frame
  dumped, no kernel launched on the CPU), `overfit_gate` (its CPU twin
  converges); `bench_eval_frame`'s timing on a small frame.
"""

import argparse
import json
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from graspnet_tpu import checkpoint as jcheckpoint
from graspnet_tpu.apps import test as japp
from graspnet_tpu.config import GraspNetConfig as JConfig

from graspnet_tpu_torch import checkpoint
from graspnet_tpu_torch.apps import test as app
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.ops import cuda as kernels
from graspnet_tpu_torch.scripts import bench_eval_frame, bench_test_app, overfit_gate
from graspnet_tpu_torch.utils.tracing import TRACE_FILE, device_trace, recording, span

from tests.mini_dataset import make_mini_dataset
from tests.test_checkpoint import params_to_reference_state_dict
from tests.test_torch_port_checkpoint import jax_params
from tests.test_torch_port_pipeline import ATOL, SELECTION_COLS

WEIGHT_SEED = 0


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small CPU work: the suite runs
    in several processes on shared cores, where idle parallel regions
    wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """Both loops over the mini dataset's test split (5 frames) with the
    same weights; returns (root, port dump, JAX dump, weights)."""
    base = tmp_path_factory.mktemp("test_app")
    root = make_mini_dataset(str(base / "mini"), num_view=60, n_frames=5)
    params = jax_params(JConfig.tiny(), WEIGHT_SEED)
    tar = str(base / "weights.tar")
    torch.save(params_to_reference_state_dict(params), tar)
    ours_w = str(base / "weights.pt")
    checkpoint.save(ours_w, checkpoint.params_from_jax(params, GraspNetConfig.tiny()))
    # the JAX pipeline reads the .tar back to exactly these parameters
    back = jax.tree_util.tree_leaves(jcheckpoint.load_torch_checkpoint(tar))
    for a, b in zip(back, jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    common = dict(dataset_root=root, camera="realsense", split="test_seen", num_point=20000,
                  collision_thresh=0.01, voxel_size=0.01, batch_size=2, max_frames=None, profile_dir=None)
    ours = argparse.Namespace(**common, checkpoint_path=ours_w, dump_dir=str(base / "dump_port"), device="cpu",
                              num_workers=1)
    ref = argparse.Namespace(**common, checkpoint_path=tar, dump_dir=str(base / "dump_jax"), devices=1,
                             num_workers=1)
    stats = app.inference(ours, GraspNetConfig.tiny())
    japp.inference(ref, JConfig.tiny())
    return root, ours, ref, stats


def _dumped(dump_dir):
    return sorted(os.path.relpath(os.path.join(d, f), dump_dir)
                  for d, _, fs in os.walk(dump_dir) for f in fs if f[0].isdigit())


def test_dump_matches_the_jax_loop(loop):
    _, ours, ref, stats = loop
    files = _dumped(ours.dump_dir)
    assert files == _dumped(ref.dump_dir) and len(files) == 5
    assert stats["frames"] == 5 and set(stats["stages_ms"]) == {"data", "net", "fetch", "downsample", "collision", "dump"}
    rows = 0
    for rel in files:
        got, want = np.load(os.path.join(ours.dump_dir, rel)), np.load(os.path.join(ref.dump_dir, rel))
        assert got.shape == want.shape, rel
        np.testing.assert_array_equal(got[:, SELECTION_COLS], want[:, SELECTION_COLS], err_msg=rel)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=rel)
        rows += len(got)
    assert rows > 0  # some grasps survive the filter


def test_evaluate_matches_the_jax_ap(loop, capsys):
    _, ours, ref, _ = loop
    res = app.evaluate(ours)
    out = capsys.readouterr().out
    japp.evaluate(ref)
    jout = capsys.readouterr().out
    want = np.load(os.path.join(ref.dump_dir, "ap_realsense.npy"))
    np.testing.assert_array_equal(np.round(res.mean() * 100, 2), np.round(want.mean() * 100, 2))
    line = [l for l in out.splitlines() if l.startswith("test_seen")]
    assert line == [l for l in jout.splitlines() if l.startswith("test_seen")] and line


def test_cli_dumps_and_evaluates(loop, tmp_path):
    root, *_ = loop
    dump = tmp_path / "dump"
    assert app.main(["--dataset_root", root, "--camera", "realsense", "--dump_dir", str(dump), "--tiny",
                     "--device", "cpu", "--batch_size", "3", "--num_workers", "1", "--max_frames", "4",
                     "--profile_dir", str(tmp_path / "prof")]) == 0
    assert len(_dumped(str(dump))) == 4 and (dump / "ap_realsense.npy").exists()
    trace = json.loads((tmp_path / "prof" / TRACE_FILE).read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("flags", [["--devices", "2"], ["--devices", "8"]])
def test_more_than_one_card_is_a_parse_error(flags, capsys):
    """More cards than the host has (on CUDA, the default) is a parse
    error; `--devices N --device cpu` shards over the CPU
    (tests/test_torch_port_parallel.py)."""
    n = int(flags[1])
    if torch.cuda.device_count() >= n:
        pytest.skip(f"this host has {n} cards")
    with pytest.raises(SystemExit):
        app.parse_args(["--dataset_root", "x", "--dump_dir", "y", *flags])
    assert "CUDA device" in capsys.readouterr().err
    assert app.parse_args(["--dataset_root", "x", "--dump_dir", "y", "--device", "cpu", *flags]).devices == n


def test_the_loop_runs_on_the_card_by_default(loop, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    root, *_ = loop
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--dataset_root", root, "--camera", "realsense", "--dump_dir", str(tmp_path), "--tiny",
                  "--skip_eval"])


def test_stage_timer_under_contending_threads():
    """No stage span is lost when threads record one stage at once, and
    the loop's stage means count each (other spans are left out)."""
    stages, n_threads, n = app.StageMeans(), 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with span(app.STAGE + "s"), span("pipeline.fetch"):
                    pass
        with recording() as rec:
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            stages.fold(rec.drain())
    finally:
        sys.setswitchinterval(old)
    assert stages.totals["s"][1] == n_threads * n and set(stages.totals) == {"s"}
    assert "s=" in stages.report() and stages.summary()["s"] >= 0


def test_device_trace_holds_the_stage_scopes(tmp_path):
    with device_trace(None):  # no directory: nothing traced
        pass
    with device_trace(str(tmp_path)):
        with span(app.STAGE + "net"):
            torch.ones(8).sum()
    names = {e.get("name") for e in json.loads((tmp_path / TRACE_FILE).read_text())["traceEvents"]}
    assert app.STAGE + "net" in names


def test_bench_test_app_tiny(tmp_path):
    cfg = GraspNetConfig.tiny()
    r = bench_test_app.run(cfg, torch.device("cpu"), str(tmp_path), frames=5, batch_sizes=(1, 2), cloud_points=4000)
    assert [row["batch_size"] for row in r["per_batch_size"]] == [1, 2]
    for row in r["per_batch_size"]:
        assert row["ms_per_frame"] > 0 and set(row["stages_ms"]) == {"data", "net", "fetch", "downsample", "collision", "dump"}
        assert set(row["launches"].values()) == {0}  # the CPU path launches no kernel
        assert row["device_idle_share"] == "not measured"
    assert r["backend"] == "cpu" and r["gpu"] is None and len(_dumped(str(tmp_path / "dump_b2"))) == 5
    assert set(row["launches"]) == set(kernels.launches())


def test_overfit_gate_tiny_converges():
    r = overfit_gate.run(True, "cpu")
    assert r["converged"] and r["objectness_acc"] > 0.9 and r["loss"] < 4.0, r["trajectory"]


def test_bench_eval_frame_times_the_evaluator():
    from graspnet_tpu_torch.eval.ap import eval_frame

    # the timing of bench_eval_frame.main on a smaller force-closure-heavy frame
    ms, fc_calls, fc_ms, acc = bench_eval_frame._timed(
        eval_frame, bench_eval_frame.build_fc_workload(n_obj=3, model_pts=600, n_grasps=64), 1)
    assert ms > 0 and fc_calls > 0 and 0 < fc_ms < ms and acc.max() > 0
