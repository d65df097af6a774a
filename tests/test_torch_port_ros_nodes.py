"""The port's ROS 2 nodes (`apps/service.py::run_ros_node`,
`run_ros_consumer_node`) driven through `tests/test_ros_nodes.py`'s stub
module graph (fake rclpy / tf2_ros / message_filters / std_srvs /
sensor_msgs / geometry_msgs): one trigger round trip and one synchronized
callback cycle, the published `estimated_grasp` TF held against the core
`GraspService.compute()`, the consumer's rate limit on a fake clock, and
failures reported instead of raised.  On the CPU, at
`GraspNetConfig.tiny()`.
"""

import json

import numpy as np
import pytest
import torch

from graspnet_tpu_torch.apps import service as service_mod
from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig
from graspnet_tpu_torch.config import GraspNetConfig

from tests.test_ros_nodes import (  # noqa: F401 — ros_stubs is a fixture
    _assert_tf_matches,
    _cloud_msgs,
    _FakeBroadcaster,
    _FakeRealsense,
    _Trigger,
    ros_stubs,
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def node_service():
    """One tiny service shared by the node tests."""
    return GraspService(ServiceConfig(model_cfg=GraspNetConfig.tiny(), depth_min=0.0, depth_max=10.0,
                                      collision_thresh=-1, seg_proximity_thresh=1.0, max_world_z_for_approach=10.0,
                                      device="cpu"))


@pytest.fixture
def shared_service(monkeypatch, node_service):
    """Make the node constructors reuse the tiny service."""
    monkeypatch.setattr(service_mod, "GraspService", lambda cfg: node_service)
    return node_service


def _trigger(ros_stubs, cfg):
    captured = {}

    def drive(node):
        captured["node"] = node
        assert node.services[0].name == "trigger_grasp_calculation"
        captured["resp"] = node.services[0].callback(_Trigger.Request(), _Trigger.Response())

    ros_stubs.spin_hook = drive
    service_mod.run_ros_node(cfg)
    return captured


class TestTriggerNode:
    def test_trigger_round_trip(self, ros_stubs, shared_service, monkeypatch):
        from graspnet_tpu_torch.sensors import cameras as cameras_mod

        monkeypatch.setattr(cameras_mod, "CameraRealsense", _FakeRealsense)
        captured = _trigger(ros_stubs, shared_service.cfg)
        assert ros_stubs.calls == ["init", "spin", "shutdown"]
        resp = captured["resp"]
        assert resp.success, resp.message
        out = json.loads(resp.message)
        assert out["ok"] and out["num_grasps"] > 0 and "grasps" not in out
        assert not captured["node"].camera.connected  # the camera is released after the request
        assert len(_FakeBroadcaster.sent) == 1
        _assert_tf_matches(_FakeBroadcaster.sent[0], np.asarray(out["tf_pose"]))
        # the same capture through the core gives the published pose
        rgb, depth = _FakeRealsense().get_rgbd()
        k = _FakeRealsense().camera_k()
        from graspnet_tpu_torch.data.camera import CameraInfo, create_point_cloud_from_depth_image

        cam = CameraInfo(depth.shape[1], depth.shape[0], k[0, 0], k[1, 1], k[0, 2], k[1, 2], 1.0)
        want = shared_service.compute(create_point_cloud_from_depth_image(depth, cam, organized=False))
        assert out["tf_pose"] == want["tf_pose"]

    def test_trigger_failure_is_reported_not_raised(self, ros_stubs, shared_service, monkeypatch):
        from graspnet_tpu_torch.sensors import cameras as cameras_mod

        class Broken(_FakeRealsense):
            def get_rgbd(self):
                raise RuntimeError("no frames within 5s")

        monkeypatch.setattr(cameras_mod, "CameraRealsense", Broken)
        resp = _trigger(ros_stubs, shared_service.cfg)["resp"]
        assert not resp.success and "no frames" in resp.message
        assert _FakeBroadcaster.sent == []


class TestConsumerNode:
    def test_synchronized_callback_cycle(self, ros_stubs, shared_service):
        _, pcd, mask, info = _cloud_msgs()
        captured = {}

        def drive(node):
            captured["node"] = node
            assert [s.topic for s in node.ts.subs] == ["/perception/points", "/perception/mask",
                                                       "/perception/camera_info"]
            cb = node.ts.callbacks[0]
            cb(pcd, mask, info)  # runs the pipeline, publishes the TF
            cb(pcd, mask, info)  # < 2 s later: rate-limited, skipped
            node.get_clock().ns += int(5e9)
            cb(pcd, mask, info)  # allowed again

        ros_stubs.spin_hook = drive
        service_mod.run_ros_consumer_node(shared_service.cfg)
        node = captured["node"]
        assert node._logger.errors == []
        assert any("too quickly" in w for w in node._logger.warns)
        assert len(_FakeBroadcaster.sent) == 2

    def test_tf_matches_core_pipeline(self, ros_stubs, shared_service):
        cloud, pcd, mask, info = _cloud_msgs()
        ros_stubs.spin_hook = lambda node: node.ts.callbacks[0](pcd, mask, info)
        service_mod.run_ros_consumer_node(shared_service.cfg)
        assert len(_FakeBroadcaster.sent) == 1
        # the same request through the core (identity world transform; the
        # full mask keeps every point near the cloud)
        k = info.k
        mask_pts = service_mod.segment_cloud_by_mask(cloud, np.full((mask.height, mask.width), 255, np.uint8),
                                                     (k[0], k[4], k[2], k[5]))
        out = shared_service.compute(cloud, mask_points=mask_pts, world_from_camera=np.eye(4, dtype=np.float32))
        assert out["ok"]
        _assert_tf_matches(_FakeBroadcaster.sent[0], np.asarray(out["tf_pose"]))

    def test_bad_mask_encoding_skips_frame(self, ros_stubs, shared_service):
        _, pcd, mask, info = _cloud_msgs()
        mask.encoding = "rgb8"
        captured = {}

        def drive(node):
            captured["node"] = node
            node.ts.callbacks[0](pcd, mask, info)

        ros_stubs.spin_hook = drive
        service_mod.run_ros_consumer_node(shared_service.cfg)
        assert _FakeBroadcaster.sent == []
        assert any("rgb8" in e for e in captured["node"]._logger.errors)

    def test_callback_failure_is_logged(self, ros_stubs, shared_service, monkeypatch):
        _, pcd, mask, info = _cloud_msgs()
        pcd.is_bigendian = True  # the decoder raises; the node logs and keeps running
        captured = {}

        def drive(node):
            captured["node"] = node
            node.ts.callbacks[0](pcd, mask, info)

        ros_stubs.spin_hook = drive
        service_mod.run_ros_consumer_node(shared_service.cfg)
        assert _FakeBroadcaster.sent == []
        assert any("big-endian" in e for e in captured["node"]._logger.errors)
