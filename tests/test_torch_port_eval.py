"""The port's AP evaluator, learnable dataset and learnability gate on the
CPU, held against the JAX package.

* `eval_frame` on the analytic cases of `tests/test_eval.py` and on the
  collision-heavy and force-closure-heavy frames of
  `scripts/bench_eval_frame.py`, `summarize`, and `GraspNetEval.eval_scene`
  on `tests/mini_dataset.py` and on the gate's dumps: bitwise the JAX
  evaluator's.  `eval_all` through its spawned worker processes (which
  hide the card) equals the in-process result.
* `make_learnable_dataset` for seed 0 writes the JAX generator's files:
  the same names, PNG and .npy bytes equal, and the arrays of every .npz
  and .mat file bitwise equal (their zip and MAT headers carry the time of
  writing).  The fast tier generates a smaller dataset (the gate's five
  objects, fewer frames, label and model points: SMALL); the slow tier
  compares the gate's own.
* The gate (`scripts/learnability_gate.py`) at 4 steps on the CPU, on the
  small dataset, finishes with AP(random) 0.0 and its JSON fields; the
  full gate (600 steps, bar 6, the gate's dataset) is slow-tier, as
  `tests/test_learnability.py` is.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch
import scipy.io as scio

from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.data.learnable import make_learnable_dataset as jmake_learnable
from graspnet_tpu.eval import ap as jap

from graspnet_tpu_torch.data.learnable import make_learnable_dataset
from graspnet_tpu_torch.eval import ap, estimate_normals
from graspnet_tpu_torch.scripts import bench_eval_frame, learnability_gate

from tests.mini_dataset import make_mini_dataset
from tests.test_eval import TestAnalyticEndToEnd, make_grasp, make_sphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the learnable dataset of the fast tier: every object kind, ~1/20 of the
# gate's generation time (its scoring scales with label x model points)
SMALL = dict(n_train_frames=4, n_test_frames=2, num_label_points=12, model_points=400)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small CPU work: the suite runs
    in several processes on shared cores, where idle parallel regions
    wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    assert np.array_equal(got, want, equal_nan=True), np.abs(got - want).max()


def _sphere_case(kind):
    rng = np.random.default_rng(0)
    pts = make_sphere(rng=rng)
    normals = estimate_normals(pts, k=12)
    z = 0.028 if kind == "table" else 0.4
    pose = np.concatenate([np.eye(3, dtype=np.float32), np.array([[0.0], [0.0], [z]], np.float32)], 1)
    kw = {}
    if kind == "ring":
        grasps = []
        for i in range(10):
            a = 2 * np.pi * i / 10
            d = np.array([np.cos(a), np.sin(a), 0.0], np.float32)
            grasps.append(make_grasp(np.array([0, 0, 0.4], np.float32) - 0.045 * d, d, 0.08, 0.05,
                                     score=1.0 - 0.01 * i))
        grasps = np.stack(grasps)
    elif kind in ("duplicates", "duplicates_raw"):
        grasps = np.stack([make_grasp([-0.045, 0.0, 0.4], [1, 0, 0], 0.08, 0.05, score=1.0 - 0.01 * i)
                           for i in range(10)])
        kw = {"apply_nms": kind == "duplicates"}
    else:  # a grasp dipping into the table slab
        grasps = make_grasp([-0.045, 0.0, 0.004], [1, 0, 0], 0.08, 0.05)[None]
        kw = {"table": ap.create_table_points(0.4, 0.4, 0.02, dx=-0.2, dy=-0.2, dz=-0.02, grid_size=0.004)}
    return (grasps, [pts], [normals], [pose]), kw


def _frame_case(kind):
    if kind in ("ring", "duplicates", "duplicates_raw", "table"):
        return _sphere_case(kind)
    if kind == "empty":
        return (np.zeros((0, 17), np.float32), [], [], []), {}
    if kind.startswith("analytic"):
        grasps, clouds, normals, poses = TestAnalyticEndToEnd()._scene()
        table = {"table": np.array([[0.0, 0.025, 0.5]], np.float32)} if kind == "analytic_table" else {}
        return (grasps, clouds, normals, poses), table
    build = bench_eval_frame.build_workload if kind == "collision_heavy" else bench_eval_frame.build_fc_workload
    g, clouds, normals, poses, table = build(n_obj=4, model_pts=1000, n_grasps=128)
    return (g, clouds, normals, poses), {"table": table}


@pytest.mark.parametrize("kind", ["ring", "duplicates", "duplicates_raw", "table", "empty", "analytic",
                                  "analytic_table", "collision_heavy", "fc_heavy"])
def test_eval_frame_bitwise_jax(kind):
    args, kw = _frame_case(kind)
    got = ap.eval_frame(*args, **kw)
    assert_bitwise(got, jap.eval_frame(*args, **kw))
    assert_bitwise(ap.accuracy_matrix(got[:, 2]), jap.accuracy_matrix(got[:, 2]))
    s, js = ap.summarize(got[None]), jap.summarize(got[None])
    assert s == js
    if kind == "analytic":
        np.testing.assert_allclose(got, TestAnalyticEndToEnd._expected(), atol=1e-7)
    if kind in ("ring", "fc_heavy"):
        assert got.max() > 0  # the frames score


def test_collision_and_empty_bitwise_jax():
    args, kw = _frame_case("collision_heavy")
    g, clouds, _, poses = args
    scene = np.concatenate([c @ p[:3, :3].T + p[:3, 3] for c, p in zip(clouds, poses)] + [kw["table"]])
    got = ap.collision_and_empty(g, scene, grid=ap._SceneGrid(scene))
    for a, b, c in zip(got, jap.collision_and_empty(g, scene, grid=jap._SceneGrid(scene)),
                       ap.collision_and_empty(g, scene)):
        assert_bitwise(a, b)
        assert_bitwise(a, c)  # the pruning grid changes nothing


def _random_dump(root, dump_dir, scene, camera, rng, n_grasps=200):
    """Grasps near the posed object models of each frame of `scene`."""
    frames = sorted(os.listdir(os.path.join(root, "scenes", scene, camera, "meta")))
    for ff in frames:
        meta = scio.loadmat(os.path.join(root, "scenes", scene, camera, "meta", ff))
        centers = meta["poses"][:, 3, :].T.astype(np.float32)
        g = np.zeros((n_grasps, 17), np.float32)
        g[:, 0] = rng.uniform(0, 1, n_grasps)
        g[:, 1] = rng.uniform(0.02, 0.1, n_grasps)
        g[:, 2] = 0.02
        g[:, 3] = rng.choice([0.01, 0.02, 0.03, 0.04], n_grasps)
        g[:, 4:13] = np.linalg.qr(rng.normal(size=(n_grasps, 3, 3)))[0].reshape(n_grasps, 9)
        g[:, 13:16] = centers[rng.integers(0, len(centers), n_grasps)] + rng.normal(0, 0.02, (n_grasps, 3))
        g[:, 16] = -1
        out = os.path.join(dump_dir, scene, camera)
        os.makedirs(out, exist_ok=True)
        np.save(os.path.join(out, ff.replace(".mat", ".npy")), g)


def test_eval_scene_and_eval_all_on_the_mini_dataset(tmp_path):
    root = make_mini_dataset(str(tmp_path / "mini"), num_view=60, n_frames=3)
    # a second test scene, so that eval_all takes its process pool
    shutil.copytree(os.path.join(root, "scenes", "scene_0100"), os.path.join(root, "scenes", "scene_0101"))
    dump = str(tmp_path / "dump")
    rng = np.random.default_rng(0)
    for scene in ("scene_0100", "scene_0101"):
        _random_dump(root, dump, scene, "realsense", rng)
    ours = ap.GraspNetEval(root, camera="realsense", split="test_seen")
    ref = jap.GraspNetEval(root, camera="realsense", split="test_seen")
    got = ours.eval_scene("scene_0100", dump)
    assert got.shape == (3, ap.TOP_K, 6)
    assert_bitwise(got, ref.eval_scene("scene_0100", dump))
    res, ap_all = ours.eval_all(dump, proc=2)  # spawned workers
    res1, ap1 = ours.eval_all(dump, proc=1)
    assert_bitwise(res, res1)
    assert ap_all == ap1 and ours.evaluated_scenes == ["scene_0100", "scene_0101"]
    assert_bitwise(res1, ref.eval_all(dump, proc=1)[0])


def make_both(base, **kw):
    """The learnable dataset from both generators (seed 0): the port's in
    a gate work directory (base/port/data), the JAX package's in base/jax."""
    make_learnable_dataset(os.path.join(base, "port", "data"), cfg=learnability_gate.gate_config(), seed=0, **kw)
    jmake_learnable(os.path.join(base, "jax"), cfg=dataclasses.replace(JConfig.tiny(), num_point=1024), seed=0, **kw)
    return os.path.join(base, "port"), os.path.join(base, "jax")


@pytest.fixture(scope="module")
def learnable(tmp_path_factory):
    """The small learnable dataset from both generators and a 4-step gate
    run on the port's."""
    base = tmp_path_factory.mktemp("learnable")
    work, jroot = make_both(str(base), **SMALL)
    out = str(base / "gate.json")
    rc = learnability_gate.main(["--root", work, "--steps", "4", "--device", "cpu", "--out", out])
    with open(out) as f:
        result = json.load(f)
    return work, jroot, rc, result


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def assert_same_files(root, jroot):
    names = _files(root)
    assert names == _files(jroot) and len(names) > 20
    for name in names:
        a, b = os.path.join(root, name), os.path.join(jroot, name)
        if name.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files), name
                for k in x.files:
                    assert_bitwise(x[k], y[k])
            with zipfile.ZipFile(a) as x, zipfile.ZipFile(b) as y:
                assert x.namelist() == y.namelist(), name
        elif name.endswith(".mat"):
            x, y = scio.loadmat(a), scio.loadmat(b)
            keys = sorted(k for k in x if not k.startswith("__"))
            assert keys == sorted(k for k in y if not k.startswith("__")), name
            for k in keys:
                assert_bitwise(x[k], y[k])
        else:
            with open(a, "rb") as x, open(b, "rb") as y:
                assert x.read() == y.read(), name


def test_learnable_dataset_matches_jax(learnable):
    work, jroot, *_ = learnable
    assert_same_files(os.path.join(work, "data"), jroot)


@pytest.mark.slow
def test_learnable_dataset_matches_jax_at_the_gate_size(tmp_path):
    work, jroot = make_both(str(tmp_path))
    assert_same_files(os.path.join(work, "data"), jroot)


def test_gate_smoke(learnable):
    work, _, rc, result = learnable
    for key in ("ap_trained", "ap_trained_08", "ap_trained_04", "ap_random", "bar", "passed", "steps", "train_s",
                "dataset_gen_s", "final_loss", "trajectory", "backend"):
        assert key in result, key
    assert result["steps"] == 4 and result["backend"] == "cpu" and result["bar"] == 6.0
    assert result["ap_random"] == 0.0 and np.isfinite(result["final_loss"])
    assert rc == (0 if result["passed"] else 1)
    assert os.path.exists(os.path.join(work, "log", "checkpoint.pt"))  # the training CLI's layout


def test_eval_scene_of_the_gate_dumps_bitwise_jax(learnable):
    """The gate's own dumps (the trained model's after 4 steps, the random
    model's) through both evaluators, on the learnable scene with its
    table slab."""
    work, *_ = learnable
    root = os.path.join(work, "data")
    ours = ap.GraspNetEval(root, camera="realsense", split="test_seen")
    ref = jap.GraspNetEval(root, camera="realsense", split="test_seen")
    for tag in ("trained", "random"):
        dump = os.path.join(work, f"dump_{tag}")
        got = ours.eval_scene("scene_0100", dump)
        assert_bitwise(got, ref.eval_scene("scene_0100", dump))
        assert ap.summarize(got) == jap.summarize(got)


@pytest.mark.slow
def test_learnability_gate_full(tmp_path):
    """The gate at its full budget on the CPU: AP(trained) >= 6 > AP(random)."""
    out = tmp_path / "gate.json"
    proc = subprocess.run(
        [sys.executable, "-m", "graspnet_tpu_torch.scripts.learnability_gate", "--steps", "600", "--bar", "6",
         "--device", "cpu", "--root", str(tmp_path / "work"), "--out", str(out)],
        capture_output=True, text=True, cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, timeout=3600)
    tail = proc.stdout[-3000:] + proc.stderr[-1500:]
    assert proc.returncode == 0, f"gate failed:\n{tail}"
    result = json.loads(out.read_text())
    assert result["ap_trained"] >= 6.0 and result["ap_random"] < 6.0, result
    assert "OK: learnability gate passed" in proc.stdout, tail
