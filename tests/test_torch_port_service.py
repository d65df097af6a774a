"""The port's serving surface on the CPU: `apps/service.py` (GraspService,
the TCP server, the ROS message helpers), `apps/batching.py` (the
MicroBatcher), `utils/transforms.py`, `sensors/` and the demos' loaders.

Port counterparts of `tests/test_apps.py`'s TestService, TestTransforms,
TestIO and TestRosHelpers and of `tests/test_service_batching.py`, plus:
* `GraspService.compute()` against the JAX `GraspService` with the same
  weights (the JAX parameters through a reference `.tar` for the JAX
  service, `checkpoint.params_from_jax` for the port) and the same clouds,
  collision filter off and on: `ok` equal, the grasp rows' selection
  fields equal and their floats, `best_pose` and `tf_pose` within 1e-5
  (the decode's tolerance in `tests/test_torch_port_pipeline.py`);
* the MicroBatcher against the per-request path at 1e-5;
* `candidate_devices` / `data_devices` raising where they cannot serve
  in ServiceConfig and in the CLI's flags, and the card as the default.
Every blocking wait has a timeout and every server an ephemeral port, so a
hang fails one test.
"""

import concurrent.futures as cf
import json
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from graspnet_tpu.apps.service import GraspService as JService
from graspnet_tpu.apps.service import ServiceConfig as JServiceConfig
from graspnet_tpu.config import GraspNetConfig as JConfig

from graspnet_tpu_torch import checkpoint, native
from graspnet_tpu_torch.apps import service as service_mod
from graspnet_tpu_torch.apps.batching import MicroBatcher, _buckets_for
from graspnet_tpu_torch.apps.demo_pointcloud import load_cloud
from graspnet_tpu_torch.apps.pipeline import GraspPipeline
from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig, serve_tcp
from graspnet_tpu_torch.apps.stereo_demo import deproject_masked_points
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.sensors.cameras import FileCamera, load_intrinsics_txt, save_capture
from graspnet_tpu_torch.utils.transforms import (
    apply_rotation_offsets,
    compose_base_grasp,
    matrix_to_quaternion,
    quaternion_to_matrix,
)

from tests.test_checkpoint import params_to_reference_state_dict
from tests.test_torch_port_checkpoint import jax_params
from tests.test_torch_port_pipeline import ATOL, SELECTION_COLS

WAIT_S = 120  # the longest any test waits on a thread, a future or a socket
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_cloud(rng, n=3000):
    cloud = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    cloud[:, 2] += 0.5
    return cloud


def run_threads(fn, n):
    """fn(i) on n threads; returns the results, raising the first error."""
    with cf.ThreadPoolExecutor(max_workers=n) as pool:
        futures = [pool.submit(fn, i) for i in range(n)]
        return [f.result(timeout=WAIT_S) for f in futures]


def tcp_request(port, payload: bytes, half_close: bool = True) -> dict:
    with socket.create_connection(("127.0.0.1", port), timeout=WAIT_S) as s:
        s.sendall(payload)
        if half_close:
            s.shutdown(socket.SHUT_WR)
        return json.loads(s.makefile("rb").readline().decode())


@pytest.fixture(scope="module")
def tiny_service():
    return GraspService(ServiceConfig(model_cfg=GraspNetConfig.tiny(), depth_min=0.0, depth_max=10.0,
                                      collision_thresh=-1, device="cpu"))


# ------------------------------------------------------------- service ----


class TestService:
    def test_compute(self, tiny_service, rng):
        out = tiny_service.compute(scene_cloud(rng))
        assert out["ok"]
        pose = np.asarray(out["best_pose"])
        assert pose.shape == (4, 4)
        R = pose[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)

    def test_depth_filter_rejects_empty(self, tiny_service, rng):
        far = rng.uniform(20, 30, (500, 3)).astype(np.float32)
        assert not tiny_service.compute(far)["ok"]

    def test_mask_proximity_filter(self, tiny_service, rng):
        cloud = scene_cloud(rng)
        out_all = tiny_service.compute(cloud)
        # a mask far from everything kills all grasps
        out_none = tiny_service.compute(cloud, mask_points=np.full((5, 3), 100.0, dtype=np.float32))
        assert out_all["ok"] and not out_none["ok"]

    def test_empty_segmentation_rejects_all_grasps(self, tiny_service, rng):
        out = tiny_service.compute(scene_cloud(rng), mask_points=np.zeros((0, 3), np.float32))
        assert not out["ok"]

    def test_world_approach_filter(self, tiny_service, rng):
        cfg = tiny_service.cfg
        cfg.max_world_z_for_approach = -2.0  # impossible: rejects everything
        try:
            out = tiny_service.compute(scene_cloud(rng), world_from_camera=np.eye(4, dtype=np.float32))
        finally:
            cfg.max_world_z_for_approach = None
        assert not out["ok"]

    def test_output_carries_tf_pose(self, tiny_service, rng):
        out = tiny_service.compute(scene_cloud(rng))
        assert out["ok"]
        want = apply_rotation_offsets(np.asarray(out["best_pose"]), tiny_service.cfg.tf_rotation_offsets)
        np.testing.assert_allclose(np.asarray(out["tf_pose"]), want, atol=1e-12)

    @pytest.mark.parametrize("half_close", [True, False], ids=["half_close", "newline_framed"])
    def test_tcp_roundtrip(self, tiny_service, rng, half_close):
        """One request per connection, terminated by a half-close or (for a
        client that keeps the socket open) by a newline; equal to the
        in-process compute() of the same cloud."""
        srv = serve_tcp(tiny_service, port=0)
        try:
            cloud = scene_cloud(rng, n=1500)
            payload = json.dumps({"cloud": cloud.tolist()}).encode() + (b"" if half_close else b"\n")
            out = tcp_request(srv.server_address[1], payload, half_close)
        finally:
            srv.shutdown()
            srv.server_close()
        want = tiny_service.compute(cloud)
        assert out["ok"] and out["grasps"] == want["grasps"] and out["tf_pose"] == want["tf_pose"]

    def test_tcp_bad_request_is_reported(self, tiny_service):
        srv = serve_tcp(tiny_service, port=0)
        try:
            out = tcp_request(srv.server_address[1], b'{"points": []}\n')
        finally:
            srv.shutdown()
            srv.server_close()
        assert not out["ok"] and "KeyError" in out["error"]


@pytest.mark.parametrize("field", ["candidate_devices", "data_devices"])
def test_multi_device_flags_raise(field):
    """The multi-device paths raise where they cannot serve: a data mesh
    without a max_batch that is a multiple of it, and more cards than the
    host has (no card stands in for another).  They serve on the CPU and
    on a card list: tests/test_torch_port_parallel.py."""
    if field == "data_devices":
        with pytest.raises(ValueError, match="max_batch"):
            ServiceConfig(model_cfg=GraspNetConfig.tiny(), device="cpu", data_devices=2).mesh()
        with pytest.raises(ValueError, match="max_batch"):
            service_mod.main(["--device", "cpu", "--data_devices", "2"])
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ServiceConfig(model_cfg=GraspNetConfig.tiny(), max_batch=n, **{field: n}).mesh()
    assert ServiceConfig(**{field: 1}).device == "cuda"  # the card by default
    assert ServiceConfig(device="cpu", max_batch=2, **{field: 2}).mesh().devices.tolist() == [torch.device("cpu")] * 2


def test_cli_serves_tcp_until_interrupted(monkeypatch, capsys):
    """`main()` builds the ServiceConfig from its flags, serves TCP on the
    given port, and on an interrupt stops the server and the service."""
    seen = {}

    class FakeService:
        def __init__(self, cfg):
            seen["cfg"] = cfg

        def close(self):
            seen["closed"] = True

    class FakeServer:
        server_address = ("127.0.0.1", 4321)

        def shutdown(self):
            seen["shutdown"] = True

    def serve(service, port):
        seen["port"] = port
        return FakeServer()

    def interrupted(self, timeout=None):
        raise KeyboardInterrupt

    monkeypatch.setattr(service_mod, "GraspService", FakeService)
    monkeypatch.setattr(service_mod, "serve_tcp", serve)
    monkeypatch.setattr(service_mod.threading.Event, "wait", interrupted)
    service_mod.main(["--device", "cpu", "--port", "4321", "--max_batch", "4", "--collision_thresh", "0.02"])
    cfg = seen["cfg"]
    assert (cfg.device, cfg.max_batch, cfg.collision_thresh, seen["port"]) == ("cpu", 4, 0.02, 4321)
    assert seen["shutdown"] and seen["closed"]
    assert "listening on :4321" in capsys.readouterr().out


def test_service_runs_on_the_card_by_default():
    """Without a card, the default service raises instead of using the CPU."""
    code = (
        "import sys, torch\n"
        "assert not torch.cuda.is_available()\n"
        "from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig\n"
        "from graspnet_tpu_torch.config import GraspNetConfig\n"
        "try:\n"
        "    GraspService(ServiceConfig(model_cfg=GraspNetConfig.tiny()))\n"
        "except RuntimeError as e:\n"
        "    sys.exit(0 if 'CUDA' in str(e) else 3)\n"
        "sys.exit(4)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=WAIT_S,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-2000:]


# ------------------------------------------------- against the JAX service --


@pytest.fixture(scope="module")
def both_services(tmp_path_factory):
    """The port's and the JAX service, same weights, collision filter off
    and on: {thresh: (port, jax)}."""
    base = tmp_path_factory.mktemp("service_weights")
    params = jax_params(JConfig.tiny(), 0)
    tar = str(base / "weights.tar")
    torch.save(params_to_reference_state_dict(params), tar)
    ours_w = str(base / "weights.pt")
    checkpoint.save(ours_w, checkpoint.params_from_jax(params, GraspNetConfig.tiny()))
    out = {}
    for thresh in (-1.0, 0.01):
        kw = dict(depth_min=0.0, depth_max=10.0, collision_thresh=thresh)
        out[thresh] = (GraspService(ServiceConfig(model_cfg=GraspNetConfig.tiny(), checkpoint_path=ours_w,
                                                  device="cpu", **kw)),
                       JService(JServiceConfig(model_cfg=JConfig.tiny(), checkpoint_path=tar, **kw)))
    return out


def assert_replies_match(got: dict, want: dict):
    assert got["ok"] == want["ok"], (got.get("error"), want.get("error"))
    if not want["ok"]:
        assert got["error"] == want["error"]
        return
    g, w = np.asarray(got["grasps"]), np.asarray(want["grasps"])
    assert g.shape == w.shape and got["num_grasps"] == want["num_grasps"]
    np.testing.assert_array_equal(g[:, SELECTION_COLS], w[:, SELECTION_COLS])
    np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    for key in ("best_pose", "tf_pose"):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), rtol=0, atol=ATOL, err_msg=key)
    np.testing.assert_allclose([got["best_score"], got["best_width"]], [want["best_score"], want["best_width"]],
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("thresh", [-1.0, 0.01], ids=["no_collision", "collision"])
def test_compute_matches_the_jax_service(both_services, thresh):
    ours, ref = both_services[thresh]
    rng = np.random.default_rng(5)
    table = scene_cloud(rng, 4000)
    table[:2000, 2] = 0.55  # a plane the filter tests grasps against
    mask = table[rng.choice(len(table), 40, replace=False)]
    for cloud, mask_points in ((table, None), (scene_cloud(rng), None), (table, mask)):
        assert_replies_match(ours.compute(cloud, mask_points), ref.compute(cloud, mask_points))


# ------------------------------------------------------------ batching ----


def test_buckets():
    assert _buckets_for(1) == [1]
    assert _buckets_for(8) == [1, 2, 4, 8]
    assert _buckets_for(6) == [1, 2, 4, 6]


@pytest.fixture(scope="module")
def pipe():
    return GraspPipeline(cfg=GraspNetConfig.tiny(), seed=0, device="cpu")


class TestMicroBatcher:
    def test_parity_with_per_request_path(self, pipe, rng):
        """Concurrent batched submits == pipe.run per request (the exact
        compute() semantics: decode -> collision filter -> sort -> NMS)."""
        mb = MicroBatcher(pipe, max_batch=4, max_wait_ms=100.0, collision_thresh=0.01)
        try:
            assert mb.warmup() > 0
            clouds = [scene_cloud(rng) for _ in range(6)]
            sampled = [pipe.sample_cloud(c) for c in clouds]
            ds = [native.voxel_downsample(c, 0.01) for c in clouds]
            results = run_threads(lambda i: mb.submit(sampled[i], ds[i], timeout=WAIT_S), 6)
            assert mb.frames == 6 and mb.dispatches >= 2
            kept = 0
            for i in range(6):
                got = results[i][0].sort_by_score().nms()
                want = pipe.run(sampled[i], scene_cloud=clouds[i], collision_thresh=0.01, top_k=0)
                np.testing.assert_allclose(got.grasp_group_array, want.grasp_group_array, rtol=0, atol=ATOL)
                kept += len(want)
            assert kept > 0
        finally:
            mb.close()

    def test_coalesces_concurrent_requests(self, pipe, rng):
        mb = MicroBatcher(pipe, max_batch=4, max_wait_ms=500.0)
        try:
            sampled = pipe.sample_cloud(scene_cloud(rng))
            run_threads(lambda i: mb.submit(sampled, timeout=WAIT_S), 4)
            assert mb.frames == 4
            # the 500 ms window comfortably coalesces 4 local threads;
            # allow one straggler dispatch for scheduler noise
            assert mb.dispatches <= 2
        finally:
            mb.close()

    @pytest.mark.parametrize("stage", ["dispatch_grasps_batch", "finish_grasps_batch"])
    def test_error_propagates_and_worker_survives(self, pipe, rng, monkeypatch, stage):
        """A failure in either stage (the dispatch thread or the finish
        thread) reaches the caller, and the batcher goes on serving."""
        mb = MicroBatcher(pipe, max_batch=2, max_wait_ms=1.0)
        orig = getattr(pipe, stage)
        calls = {"n": 0}

        def boom(*args):
            calls["n"] += 1
            if calls["n"] == 1:
                raise ValueError(f"injected {stage} failure")
            return orig(*args)

        monkeypatch.setattr(pipe, stage, boom)
        try:
            good = pipe.sample_cloud(scene_cloud(rng))
            with pytest.raises(ValueError, match="injected"):
                mb.submit(good, timeout=WAIT_S)
            gg, _ = mb.submit(good, timeout=WAIT_S)
            assert gg.grasp_group_array.shape[1] == 17
        finally:
            mb.close()

    def test_close_rejects_new_submits_and_stops_threads(self, pipe):
        mb = MicroBatcher(pipe, max_batch=2, max_wait_ms=1.0)
        mb.close()
        assert not mb._thread.is_alive() and not mb._finish_thread.is_alive()
        with pytest.raises(RuntimeError):
            mb.submit(np.zeros((pipe.cfg.num_point, 3), np.float32), timeout=WAIT_S)
        mb.close()  # a second close is a no-op

    def test_forward_records_no_autograd_history(self, pipe, rng):
        """Grad mode is thread-local: the rows the batcher's threads deliver
        come from inference-mode forwards and no-grad collision counts."""
        handle = pipe.dispatch_grasps_batch(np.stack([pipe.sample_cloud(scene_cloud(rng))]))
        (grasps, valid), *_ = handle
        assert not grasps.requires_grad and grasps.grad_fn is None
        pipe.finish_grasps_batch(handle)


class TestBatchedService:
    @pytest.fixture(scope="class")
    def services(self):
        cfg = GraspNetConfig.tiny()

        def mk(max_batch):
            return GraspService(ServiceConfig(model_cfg=cfg, depth_min=0.0, depth_max=10.0, collision_thresh=0.01,
                                              max_batch=max_batch, batch_wait_ms=20.0, device="cpu"))

        batched, plain = mk(4), mk(1)
        yield batched, plain
        batched.close()

    def test_concurrent_computes_match_plain_service(self, services, rng):
        batched, plain = services
        clouds = [scene_cloud(rng) for _ in range(5)]
        outs = run_threads(lambda i: batched.compute(clouds[i]), 5)
        for i in range(5):
            want = plain.compute(clouds[i])
            assert outs[i]["ok"] == want["ok"]
            np.testing.assert_allclose(outs[i]["best_pose"], want["best_pose"], rtol=0, atol=ATOL)
            np.testing.assert_allclose(outs[i]["grasps"], want["grasps"], rtol=0, atol=ATOL)
            assert outs[i]["num_grasps"] == want["num_grasps"]

    def test_tcp_concurrent_requests(self, services, rng):
        batched, plain = services
        srv = serve_tcp(batched, port=0)
        clouds = [scene_cloud(rng, n=1500) for _ in range(3)]
        try:
            outs = run_threads(lambda i: tcp_request(srv.server_address[1],
                                                     json.dumps({"cloud": clouds[i].tolist()}).encode()), 3)
        finally:
            srv.shutdown()
            srv.server_close()
        for out, cloud in zip(outs, clouds):
            assert out["ok"] and out["grasps"] == plain.compute(cloud)["grasps"]


# ---------------------------------------------------------- transforms ----


class TestTransforms:
    def test_quaternion_roundtrip(self, rng):
        from graspnet_tpu_torch.models.geometry import batch_viewpoint_params_to_matrix

        towards = torch.from_numpy(rng.normal(size=(10, 3)).astype(np.float32))
        angles = torch.from_numpy(rng.uniform(0, np.pi, 10).astype(np.float32))
        for R in batch_viewpoint_params_to_matrix(towards, angles).numpy():
            np.testing.assert_allclose(quaternion_to_matrix(matrix_to_quaternion(R)), R, atol=1e-5)

    def test_compose(self):
        T1 = np.eye(4)
        T1[:3, 3] = [1, 2, 3]
        T2 = np.eye(4)
        T2[:3, 3] = [0.1, 0, 0]
        np.testing.assert_allclose(compose_base_grasp(T1, T2)[:3, 3], [1.1, 2, 3])

    def test_rotation_offsets_match_scipy(self, rng):
        """R_raw * R(q1) * R(q2) == scipy Rotation chaining (reference demo.py
        publish_modified_grasp_tf semantics)."""
        from scipy.spatial.transform import Rotation

        q1, q2 = (0.7071068, 0.0, 0.7071068, 0.0), (0.0, 0.0, 0.7071068, 0.7071068)
        raw, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        pose = np.eye(4)
        pose[:3, :3] = raw
        pose[:3, 3] = [0.1, 0.2, 0.3]
        got = apply_rotation_offsets(pose, (q1, q2))
        want = (Rotation.from_matrix(raw) * Rotation.from_quat(q1) * Rotation.from_quat(q2)).as_matrix()
        np.testing.assert_allclose(got[:3, :3], want, atol=1e-6)
        np.testing.assert_allclose(got[:3, 3], pose[:3, 3])  # translation raw

    def test_equal_to_the_jax_module(self, rng):
        from graspnet_tpu.utils import transforms as jt

        for _ in range(20):
            R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            R *= np.sign(np.linalg.det(R))
            q = rng.normal(size=4)
            np.testing.assert_array_equal(matrix_to_quaternion(R), jt.matrix_to_quaternion(R))
            np.testing.assert_array_equal(quaternion_to_matrix(q), jt.quaternion_to_matrix(q))


# ------------------------------------------------------------------ IO ----


class TestIO:
    def test_load_cloud_formats(self, rng, tmp_path):
        pts = rng.normal(size=(50, 3)).astype(np.float32)
        np.save(tmp_path / "c.npy", pts)
        np.savez(tmp_path / "c.npz", points=pts)
        np.testing.assert_allclose(load_cloud(str(tmp_path / "c.npy")), pts)
        np.testing.assert_allclose(load_cloud(str(tmp_path / "c.npz")), pts)
        with open(tmp_path / "c.ply", "w") as f:
            f.write(f"ply\nformat ascii 1.0\nelement vertex {len(pts)}\nproperty float x\nproperty float y\n"
                    "property float z\nend_header\n")
            for p in pts:
                f.write(f"{p[0]:.8e} {p[1]:.8e} {p[2]:.8e}\n")
        np.testing.assert_allclose(load_cloud(str(tmp_path / "c.ply")), pts, rtol=1e-6)
        with pytest.raises(ValueError, match="unsupported"):
            load_cloud(str(tmp_path / "c.xyz"))

    def test_capture_roundtrip(self, rng, tmp_path):
        rgb = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
        depth = rng.uniform(0.3, 0.8, (24, 32)).astype(np.float32)
        K = np.array([[100.0, 0, 16], [0, 100.0, 12], [0, 0, 1]])
        ts = save_capture(str(tmp_path), rgb, depth, K, timestamp=123)
        cam = FileCamera(str(tmp_path / f"rgb_{ts}.png"), str(tmp_path / f"depth_{ts}.png"),
                         str(tmp_path / f"meta_{ts}.mat"))
        cam.connect()
        rgb2, depth2 = cam.get_rgbd()
        cam.disconnect()
        np.testing.assert_allclose(cam.camera_k(), K)
        np.testing.assert_allclose(depth2, depth, atol=1e-3)
        np.testing.assert_allclose(rgb2, rgb, atol=0.01)

    def test_intrinsics_txt(self, tmp_path):
        p4 = tmp_path / "k4.txt"
        p4.write_text("100 110 32 24")
        K = load_intrinsics_txt(str(p4))
        assert K[0, 0] == 100 and K[1, 2] == 24
        p9 = tmp_path / "k9.txt"
        p9.write_text("100 0 32 0 110 24 0 0 1")
        np.testing.assert_allclose(K, load_intrinsics_txt(str(p9)))
        bad = tmp_path / "k5.txt"
        bad.write_text("1 2 3 4 5")
        with pytest.raises(ValueError, match="4 or 9"):
            load_intrinsics_txt(str(bad))

    def test_deproject_masked(self):
        depth = np.full((10, 12), 0.5, dtype=np.float32)
        mask = np.zeros((10, 12), bool)
        mask[5, 6] = True
        K = np.array([[100.0, 0, 6], [0, 100.0, 5], [0, 0, 1]])
        np.testing.assert_allclose(deproject_masked_points(mask, depth, K), [[0.0, 0.0, 0.5]], atol=1e-6)

    def test_sdk_cameras_raise_without_their_sdk(self):
        from graspnet_tpu_torch.sensors import CameraRealsense, CameraZivid

        for cam, sdk in ((CameraRealsense, "pyrealsense2"), (CameraZivid, "zivid")):
            with pytest.raises(ImportError, match=sdk):
                cam()


# --------------------------------------------------------- ROS helpers ----


def _xyz_fields(names="xyz"):
    return [SimpleNamespace(name=c) for c in names]


class TestRosHelpers:
    def test_pointcloud2_to_xyz_with_rgb(self, rng):
        n = 37
        xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        rgb888 = rng.integers(0, 255, (n, 3), dtype=np.uint32)
        packed = (rgb888[:, 0] << 16) | (rgb888[:, 1] << 8) | rgb888[:, 2]
        rows = np.concatenate([xyz, np.zeros((n, 1), np.float32)], axis=1)
        rows[:, 3] = packed.astype(np.uint32).view(np.float32)
        msg = SimpleNamespace(data=rows.tobytes(), point_step=16, fields=_xyz_fields(("x", "y", "z", "rgb")))
        got_xyz, got_rgb = service_mod.pointcloud2_to_xyz(msg)
        np.testing.assert_array_equal(got_xyz, xyz)
        np.testing.assert_allclose(got_rgb, rgb888.astype(np.float32) / 255.0)

    def test_pointcloud2_rejects_bigendian(self):
        msg = SimpleNamespace(data=np.zeros((4, 3), np.float32).tobytes(), point_step=12, is_bigendian=True,
                              fields=_xyz_fields())
        with pytest.raises(ValueError, match="big-endian"):
            service_mod.pointcloud2_to_xyz(msg)

    def test_pointcloud2_rejects_nonfloat_xyz(self):
        fields = [SimpleNamespace(name="x", datatype=7, offset=0), SimpleNamespace(name="y", datatype=7, offset=4),
                  SimpleNamespace(name="z", datatype=4, offset=8)]  # UINT16
        msg = SimpleNamespace(data=np.zeros((4, 3), np.float32).tobytes(), point_step=12, fields=fields)
        with pytest.raises(ValueError, match="datatype"):
            service_mod.pointcloud2_to_xyz(msg)

    def test_pointcloud2_strips_row_padding(self, rng):
        """An organized cloud with row_step > width*point_step decodes the
        real points and drops the per-row padding bytes."""
        h, w = 3, 5
        xyz = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
        rows = np.concatenate([xyz.reshape(h, w * 3), np.full((h, 2), np.nan, np.float32)], axis=1)
        msg = SimpleNamespace(data=rows.tobytes(), point_step=12, height=h, width=w, row_step=w * 12 + 8,
                              fields=_xyz_fields())
        got_xyz, _ = service_mod.pointcloud2_to_xyz(msg)
        np.testing.assert_array_equal(got_xyz, xyz.reshape(-1, 3))
        bad = SimpleNamespace(data=rows.tobytes(), point_step=12, height=h, width=w, row_step=w * 12 - 4,
                              fields=_xyz_fields())
        with pytest.raises(ValueError, match="row_step"):
            service_mod.pointcloud2_to_xyz(bad)

    def test_pointcloud2_to_xyz_reordered_fields(self, rng):
        xyz = rng.uniform(-1, 1, (10, 3)).astype(np.float32)
        rows = np.concatenate([xyz[:, 2:3], xyz[:, 0:1], xyz[:, 1:2]], axis=1)
        msg = SimpleNamespace(data=rows.astype(np.float32).tobytes(), point_step=12, fields=_xyz_fields("zxy"))
        got_xyz, got_rgb = service_mod.pointcloud2_to_xyz(msg)
        np.testing.assert_array_equal(got_xyz, xyz)
        assert got_rgb is None

    def test_pointcloud2_honors_field_offsets(self, rng):
        """The standard padded PCL XYZRGB layout: x@0 y@4 z@8 rgb@16, step 32."""
        n = 11
        xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        rgb888 = rng.integers(0, 255, (n, 3), dtype=np.uint32)
        packed = (rgb888[:, 0] << 16) | (rgb888[:, 1] << 8) | rgb888[:, 2]
        rows = np.zeros((n, 8), np.float32)
        rows[:, 0:3] = xyz
        rows[:, 4] = packed.astype(np.uint32).view(np.float32)
        fields = [SimpleNamespace(name=c, offset=o) for c, o in (("x", 0), ("y", 4), ("z", 8), ("rgb", 16))]
        got_xyz, got_rgb = service_mod.pointcloud2_to_xyz(SimpleNamespace(data=rows.tobytes(), point_step=32,
                                                                          fields=fields))
        np.testing.assert_array_equal(got_xyz, xyz)
        np.testing.assert_allclose(got_rgb, rgb888.astype(np.float32) / 255.0)

    def test_segment_cloud_by_mask(self):
        K = (100.0, 100.0, 6.0, 5.0)
        mask = np.zeros((10, 12), np.uint8)
        mask[5, 6] = 255  # the principal-point pixel is hot
        pts = np.array([[0.0, 0.0, 0.5],  # projects to (6, 5): kept
                        [0.02, 0.0, 0.5],  # projects to (10, 5): cold pixel
                        [0.0, 0.0, -0.5],  # behind the camera
                        [5.0, 5.0, 0.5]],  # out of bounds
                       np.float32)
        np.testing.assert_array_equal(service_mod.segment_cloud_by_mask(pts, mask, K), pts[:1])
        assert service_mod.segment_cloud_by_mask(np.zeros((0, 3), np.float32), mask, K) is None

    def test_helpers_equal_the_jax_ones(self, rng):
        """The message helpers are verbatim copies: the same outputs on a
        padded organized XYZRGB cloud and a random mask."""
        from graspnet_tpu.apps import service as jservice

        h, w = 4, 6
        rows = rng.uniform(-0.2, 0.2, (h, w, 8)).astype(np.float32)
        rows[..., 2] += 0.5
        data = np.concatenate([rows.reshape(h, -1), np.zeros((h, 4), np.float32)], axis=1).tobytes()
        fields = [SimpleNamespace(name=c, offset=o, datatype=7) for c, o in (("x", 0), ("y", 4), ("z", 8),
                                                                              ("rgb", 16))]
        msg = SimpleNamespace(data=data, point_step=32, height=h, width=w, row_step=w * 32 + 16, fields=fields)
        for a, b in zip(service_mod.pointcloud2_to_xyz(msg), jservice.pointcloud2_to_xyz(msg)):
            np.testing.assert_array_equal(a, b)
        cloud = service_mod.pointcloud2_to_xyz(msg)[0]
        mask = rng.integers(0, 256, (16, 16)).astype(np.uint8)
        np.testing.assert_array_equal(service_mod.segment_cloud_by_mask(cloud, mask, (20.0, 20.0, 8.0, 8.0)),
                                      jservice.segment_cloud_by_mask(cloud, mask, (20.0, 20.0, 8.0, 8.0)))


def test_launch_counts_are_exact_under_thread_contention():
    """The service's threads count kernel launches at once: the counter's
    read-modify-write runs under a lock, so no count is lost with more
    threads than cores and a short switch interval."""
    from graspnet_tpu_torch.ops import cuda as kernels
    from graspnet_tpu_torch.ops.cuda import build

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kernels.reset_launches()
        wrapper = kernels.ball_query
        run_threads(lambda i: [build.count_launch(wrapper) for _ in range(2000)], 32)
        assert kernels.launches()["ball_query"] == 32 * 2000
    finally:
        sys.setswitchinterval(old)
        kernels.reset_launches()
