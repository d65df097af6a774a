"""The port's demos and their host modules on the CPU.

* Each demo's `main(argv)` with `--tiny --device cpu` on a synthetic RGB-D
  frame in the reference demo layout (`utils/synthetic.py::write_demo_frame`):
  `image_demo` (dump and `--save_ply`, held against the pipeline it wraps),
  `demo_pointcloud`, `segmentation_demo` (the proximity filter), `stereo_demo`
  (against `GraspService.compute` of the same cloud), `grasp_tf --once` (the
  pipeline's best pose, and the stdout heartbeat's quaternion) and
  `grasp_base`; without `--device` every model demo raises on a host
  without CUDA instead of running on the CPU.
* `tests/test_viz.py`'s gripper-mesh and capture-viz cases against the
  port's `postproc/gripper.py` and `sensors/viz.py`, with meshes, PLY text
  and images equal to the JAX modules' bitwise (numpy on both sides).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from graspnet_tpu.postproc import GraspGroup as JGraspGroup
from graspnet_tpu.postproc import gripper as jgripper
from graspnet_tpu.sensors import viz as jviz

from graspnet_tpu_torch.apps import (
    demo_pointcloud,
    grasp_base,
    grasp_tf,
    image_demo,
    segmentation_demo,
    stereo_demo,
)
from graspnet_tpu_torch.apps.pipeline import GraspPipeline
from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.eval.ap import load_ply_points
from graspnet_tpu_torch.postproc import GraspGroup, grasp_group_meshes, gripper_mesh, save_meshes_ply
from graspnet_tpu_torch.postproc.gripper import DEPTH_BASE, FINGER_WIDTH, TAIL_LENGTH, save_grasps_scene_ply
from graspnet_tpu_torch.sensors.viz import colorize_depth, merge_segmap_into_npz, save_depth_png
from graspnet_tpu_torch.utils.synthetic import write_demo_frame
from graspnet_tpu_torch.utils.transforms import quaternion_to_matrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_TINY = ["--tiny", "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    d = tmp_path_factory.mktemp("frame")
    return str(d), write_demo_frame(str(d), np.random.default_rng(0))


@pytest.fixture(scope="module")
def pipe():
    return GraspPipeline(cfg=GraspNetConfig.tiny(), device="cpu")


def _rows(path):
    rows = np.load(path)
    assert rows.ndim == 2 and rows.shape[1] == 17 and np.isfinite(rows).all()
    return rows


def _ply_vertices(path) -> int:
    with open(path) as f:
        return int(next(line for line in f if line.startswith("element vertex")).split()[-1])


# --------------------------------------------------------------- demos ----


def test_image_demo_dump_and_ply(frame, pipe, tmp_path):
    d, _ = frame
    dump, ply = str(tmp_path / "g.npy"), str(tmp_path / "g.ply")
    image_demo.main(["--data_dir", d, "--dump", dump, "--save_ply", ply, "--top_k", "10", *CPU_TINY])
    rows = _rows(dump)
    scene = image_demo.load_frame(d)
    want = pipe.run(pipe.sample_cloud(scene), scene_cloud=scene, collision_thresh=-1.0, top_k=10)
    assert len(rows) == 10
    np.testing.assert_array_equal(rows, want.grasp_group_array)
    # the PLY: 32 gripper vertices a grasp, then the scene points, readable back
    assert _ply_vertices(ply) == 32 * len(rows) + len(scene)
    np.testing.assert_allclose(load_ply_points(ply)[32 * len(rows):], scene, atol=1e-6)


def test_image_demo_explicit_paths_and_profile(frame, tmp_path):
    d, paths = frame
    dump = str(tmp_path / "g.npy")
    image_demo.main(["--depth_path", paths["depth.png"], "--meta_path", paths["meta.mat"], "--dump", dump,
                     "--profile_dir", str(tmp_path / "trace"), *CPU_TINY])
    assert len(_rows(dump)) > 0 and os.path.exists(tmp_path / "trace" / "trace.json")
    with pytest.raises(SystemExit):
        image_demo.main(CPU_TINY)  # neither --data_dir nor --depth_path + --meta_path


def test_demo_pointcloud(frame, pipe, tmp_path):
    _, paths = frame
    dump, ply = str(tmp_path / "g.npy"), str(tmp_path / "g.ply")
    demo_pointcloud.main(["--cloud_path", paths["cloud.npy"], "--z_max", "0.6", "--collision_thresh", "0.01",
                          "--dump", dump, "--save_ply", ply, *CPU_TINY])
    rows = _rows(dump)
    cloud = np.load(paths["cloud.npy"])
    want = pipe.run(pipe.sample_cloud(cloud), scene_cloud=cloud, collision_thresh=0.01, top_k=100)
    unfiltered = pipe.run(pipe.sample_cloud(cloud), top_k=0)
    assert 0 < len(rows) < len(unfiltered)  # the filter removed some grasps and kept some
    np.testing.assert_array_equal(rows, want.grasp_group_array)
    assert _ply_vertices(ply) == 32 * len(rows) + len(cloud)


def test_segmentation_demo(frame, pipe, tmp_path):
    d, paths = frame
    dump = str(tmp_path / "g.npy")
    segmentation_demo.main(["--data_dir", d, "--mask", paths["mask.png"], "--collision_thresh", "-1",
                            "--seg_proximity_thresh", "0.03", "--dump", dump, *CPU_TINY])
    rows = _rows(dump)
    scene, mask_points = segmentation_demo.load_frame_with_mask(d, paths["mask.png"])
    assert 0 < len(mask_points) < len(scene)
    gg = pipe.run(pipe.sample_cloud(scene), scene_cloud=scene, collision_thresh=-1.0, top_k=0)
    want = GraspService.filter_by_mask_proximity(gg, mask_points, 0.03).sort_by_score()[:50]
    assert 0 < len(rows) < len(gg)
    np.testing.assert_array_equal(rows, want.grasp_group_array)


def test_stereo_demo(frame):
    _, paths = frame
    import PIL.Image

    ply = os.path.join(os.path.dirname(paths["cloud.npy"]), "cloud.ply")
    cloud = np.load(paths["cloud.npy"])
    save_grasps_scene_ply(GraspGroup(), cloud, ply)  # a points-only PLY, as a stereo system writes
    out = stereo_demo.main(["--cloud_path", ply, "--intrinsics", paths["K.txt"], "--mask_path", paths["mask.png"],
                            "--depth_path", paths["depth.png"], "--collision_thresh", "-1",
                            "--seg_proximity_thresh", "0.05", *CPU_TINY])
    service = GraspService(ServiceConfig(model_cfg=GraspNetConfig.tiny(), collision_thresh=-1,
                                         seg_proximity_thresh=0.05, depth_min=0.0, depth_max=1.2, device="cpu"))
    depth = np.asarray(PIL.Image.open(paths["depth.png"])).astype(np.float32) / 1000.0
    K = np.loadtxt(paths["K.txt"]).reshape(3, 3)
    mask_points = stereo_demo.deproject_masked_points(np.asarray(PIL.Image.open(paths["mask.png"])) > 0, depth, K)
    want = service.compute(load_ply_points(ply), mask_points=mask_points)
    assert out["ok"] and want["ok"]
    np.testing.assert_allclose(out["grasps"], want["grasps"], rtol=0, atol=1e-6)


def test_grasp_tf_once_and_heartbeat(frame, pipe):
    d, _ = frame
    pose = grasp_tf.main(["--data_dir", d, "--once", "--collision_thresh", "-1", *CPU_TINY])
    scene = image_demo.load_frame(d)
    want = pipe.run(pipe.sample_cloud(scene), scene_cloud=scene, collision_thresh=-1.0, top_k=1)
    np.testing.assert_array_equal(pose, want[0].to_matrix())
    msg = grasp_tf.heartbeat(pose, "camera_depth_optical_frame")
    assert msg["child_frame_id"] == "estimated_grasp" and msg["translation"] == pose[:3, 3].tolist()
    np.testing.assert_allclose(quaternion_to_matrix(msg["quaternion_xyzw"]), pose[:3, :3], atol=1e-5)


def test_grasp_base(tmp_path, capsys):
    rng = np.random.default_rng(3)
    grasp, base = np.eye(4), np.eye(4)
    grasp[:3, 3], base[:3, 3] = rng.normal(size=3), rng.normal(size=3)
    base[:3, :3], _ = np.linalg.qr(rng.normal(size=(3, 3)))
    np.save(tmp_path / "g.npy", grasp)
    np.save(tmp_path / "b.npy", base)
    got = grasp_base.main(["--grasp_path", str(tmp_path / "g.npy"), "--extrinsics_path", str(tmp_path / "b.npy")])
    np.testing.assert_allclose(got, base @ grasp)
    assert "grasp in base frame" in capsys.readouterr().out
    assert np.get_printoptions()["precision"] == 8  # the print options are restored


def test_model_demos_run_on_the_card_by_default(frame):
    """Without a card, every demo that runs the model raises instead of
    running on the CPU."""
    d, paths = frame
    calls = {
        "image_demo": ["--data_dir", d],
        "demo_pointcloud": ["--cloud_path", paths["cloud.npy"]],
        "segmentation_demo": ["--data_dir", d, "--mask", paths["mask.png"]],
        "stereo_demo": ["--cloud_path", paths["cloud.npy"]],
        "grasp_tf": ["--data_dir", d, "--once"],
    }
    code = (
        "import sys, importlib, torch\n"
        "assert not torch.cuda.is_available()\n"
        f"calls = {calls!r}\n"
        "bad = []\n"
        "for name, argv in calls.items():\n"
        "    try:\n"
        "        importlib.import_module('graspnet_tpu_torch.apps.' + name).main(argv + ['--tiny'])\n"
        "        bad.append(name)\n"
        "    except RuntimeError as e:\n"
        "        if 'CUDA' not in str(e):\n"
        "            bad.append(name)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]


# ------------------------------------------------ gripper meshes (viz) ----


def _row(score=0.5, width=0.08, depth=0.03, R=None, t=(0.1, 0.0, 0.4)):
    R = np.eye(3) if R is None else R
    return np.concatenate([[score, width, 0.02, depth], np.asarray(R).reshape(9), t, [-1.0]]).astype(np.float32)


def _random_rows(n=6):
    rng = np.random.default_rng(4)
    rows = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        rows.append(_row(rng.uniform(-0.2, 1.3), rng.uniform(0.01, 0.1), rng.uniform(0.01, 0.04), q,
                         rng.uniform(-0.3, 0.5, 3)))
    return np.stack(rows)


class TestGripperMesh:
    def test_shapes_and_indices(self):
        v, t, c = gripper_mesh(np.zeros(3), np.eye(3), 0.08, 0.03, 0.7)
        assert v.shape == (32, 3) and t.shape == (48, 3) and c.shape == (3,)
        assert t.min() >= 0 and t.max() < 32

    def test_geometry_spans_gripper_volume(self):
        w, d = 0.08, 0.03
        v, _, _ = gripper_mesh(np.zeros(3), np.eye(3), w, d)
        assert v[:, 0].min() == pytest.approx(-DEPTH_BASE - FINGER_WIDTH - TAIL_LENGTH)
        assert v[:, 0].max() == pytest.approx(d)
        assert v[:, 1].min() == pytest.approx(-w / 2 - FINGER_WIDTH)
        assert v[:, 1].max() == pytest.approx(w / 2 + FINGER_WIDTH)

    def test_rigid_transform_applied(self):
        rng = np.random.default_rng(0)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        t = np.array([0.2, -0.1, 0.5])
        v0, _, _ = gripper_mesh(np.zeros(3), np.eye(3), 0.08, 0.03)
        v1, _, _ = gripper_mesh(t, q, 0.08, 0.03)
        np.testing.assert_allclose(v1, v0 @ q.astype(np.float32).T + t, atol=1e-5)

    def test_group_meshes_and_color_ramp(self):
        gg = GraspGroup(np.stack([_row(score=0.1), _row(score=0.9)]))
        meshes = grasp_group_meshes(gg)
        assert len(meshes) == 2
        assert meshes[0][2][1] == pytest.approx(1.0)  # normalized: low score -> green
        assert meshes[1][2][0] == pytest.approx(1.0)  # high -> red
        assert grasp_group_meshes(GraspGroup(np.zeros((0, 17)))) == []

    @pytest.mark.parametrize("normalize", [True, False])
    def test_meshes_equal_the_jax_module(self, normalize):
        rows = _random_rows()
        got = GraspGroup(rows).meshes(normalize)
        want = JGraspGroup(rows).meshes(normalize)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        for i in range(len(rows)):
            for a, b in zip(GraspGroup(rows)[i].mesh(0.3), JGraspGroup(rows)[i].mesh(0.3)):
                np.testing.assert_array_equal(a, b)

    def test_ply_text_equals_the_jax_module(self, tmp_path):
        rows = _random_rows(3)
        GraspGroup(rows).save_ply(str(tmp_path / "p.ply"))
        JGraspGroup(rows).save_ply(str(tmp_path / "j.ply"))
        assert (tmp_path / "p.ply").read_text() == (tmp_path / "j.ply").read_text()
        text = (tmp_path / "p.ply").read_text()
        assert "element vertex 96" in text and "element face 144" in text
        scene = np.random.default_rng(1).normal(size=(20, 3)).astype(np.float32)
        save_grasps_scene_ply(GraspGroup(rows), scene, str(tmp_path / "ps.ply"))
        jgripper.save_grasps_scene_ply(JGraspGroup(rows), scene, str(tmp_path / "js.ply"))
        assert (tmp_path / "ps.ply").read_text() == (tmp_path / "js.ply").read_text()
        save_meshes_ply([], str(tmp_path / "e.ply"))
        assert "element vertex 0" in (tmp_path / "e.ply").read_text()

    def test_open3d_stays_optional(self):
        """open3d is imported only when an open3d geometry is asked for."""
        gg = GraspGroup(_random_rows(1))
        try:
            import open3d  # noqa: F401
        except ImportError:
            with pytest.raises(ImportError):
                gg.to_open3d_geometry_list()
            with pytest.raises(ImportError):
                gg[0].to_open3d_geometry()
        else:
            assert len(gg.to_open3d_geometry_list()) == 1


class TestCaptureViz:
    def test_colorize_depth(self):
        depth = np.zeros((4, 6), np.uint16)
        depth[1:, :] = np.linspace(300, 600, 18).reshape(3, 6).astype(np.uint16)
        img = colorize_depth(depth)
        assert img.shape == (4, 6, 3) and img.dtype == np.uint8
        assert (img[0] == 0).all()  # the invalid row is black
        assert (img[1:] != 0).any()
        np.testing.assert_array_equal(img, jviz.colorize_depth(depth))
        np.testing.assert_array_equal(colorize_depth(depth, 350, 550), jviz.colorize_depth(depth, 350, 550))

    def test_colorize_all_invalid(self):
        assert (colorize_depth(np.zeros((3, 3))) == 0).all()

    def test_save_depth_png(self, tmp_path):
        from PIL import Image

        depth = (np.ones((5, 5)) * 500).astype(np.uint16)
        save_depth_png(depth, str(tmp_path / "d.png"))
        assert Image.open(tmp_path / "d.png").size == (5, 5)

    def test_merge_segmap(self, tmp_path):
        from PIL import Image

        np.savez(tmp_path / "cap.npz", rgb=np.zeros((8, 10, 3), np.uint8), depth=np.full((8, 10), 500, np.uint16),
                 K=np.eye(3))
        seg = np.zeros((8, 10), np.uint8)
        seg[2:5, 3:7] = 255
        Image.fromarray(seg).save(tmp_path / "seg.png")
        out = merge_segmap_into_npz(str(tmp_path / "cap.npz"), str(tmp_path / "seg.png"), str(tmp_path / "o.npz"))
        assert out["segmap"].shape == (8, 10)
        assert np.load(tmp_path / "o.npz")["segmap"].sum() == seg.sum()

    def test_merge_segmap_shape_mismatch(self, tmp_path):
        from PIL import Image

        np.savez(tmp_path / "cap.npz", depth=np.zeros((8, 10), np.uint16), K=np.eye(3))
        Image.fromarray(np.zeros((4, 4), np.uint8)).save(tmp_path / "seg.png")
        with pytest.raises(ValueError, match="does not match"):
            merge_segmap_into_npz(str(tmp_path / "cap.npz"), str(tmp_path / "seg.png"), str(tmp_path / "o.npz"))
