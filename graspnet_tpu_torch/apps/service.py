"""Grasp service: the reference's ROS 2 deployment surface, transport-agnostic.

Counterpart of `graspnet_tpu/apps/service.py`.  The reference ships four
rclpy nodes (demo.py, grasp_service.py, grasp_segmentation.py,
graspnet_tf.py) that share one core loop: capture/receive a cloud -> filter
-> network -> collision -> segmentation proximity filter -> world-frame
approach filter -> best-grasp pose out.

Here that core is `GraspService` (plain python, fully testable), wrapped by:
  * a JSON-over-TCP trigger server (`serve_tcp`) for ROS-less deployments;
  * an optional rclpy node (`run_ros_node`) with the reference's service name
    `trigger_grasp_calculation` and `estimated_grasp` TF output, and the
    subscription-driven consumer node (`run_ros_consumer_node`), loaded only
    when rclpy is importable.

The service runs on the card unless `ServiceConfig.device` asks for the
CPU.  `candidate_devices` and `data_devices` above 1 shard the network over
a mesh of cards (`parallel/`), as the JAX service does.  Each reply carries
its own request's timings (`GraspService.compute`), and each request runs
under a `service.compute` span whose trace id is the request's number
(`utils/tracing.py`).

    python -m graspnet_tpu_torch.apps.service --port 9876 [--checkpoint_path CKPT]
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import socketserver
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from graspnet_tpu_torch import native
from graspnet_tpu_torch.apps.pipeline import GraspPipeline
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.postproc import GraspGroup
from graspnet_tpu_torch.utils.tracing import span
from graspnet_tpu_torch.utils.transforms import apply_rotation_offsets, matrix_to_quaternion, quaternion_to_matrix

@dataclasses.dataclass
class ServiceConfig:
    checkpoint_path: Optional[str] = None
    model_cfg: Optional[GraspNetConfig] = None  # override (e.g. tiny for tests)
    num_point: int = 20000
    collision_thresh: float = 0.01
    voxel_size: float = 0.01
    depth_min: float = 0.3  # reference demo.py depth range [0.3, 0.6]
    depth_max: float = 0.6
    seg_proximity_thresh: float = 0.02  # reference grasp_service.py mask filter
    max_world_z_for_approach: Optional[float] = None  # world-frame approach gate
    # multi-device paths: each frame's candidate sweep over several devices
    # (latency), coalesced batches one frame a device (throughput; needs
    # max_batch a multiple of it); both > 1 make the hybrid 2-D mesh
    candidate_devices: int = 1
    data_devices: int = 1
    # the mesh's devices, data-major (e.g. ("cuda:0",) * 2 to run the
    # sharded code path on one card); default the cards cuda:0..n-1, or
    # the CPU repeated with device="cpu"
    mesh_devices: Optional[Tuple[str, ...]] = None
    # dynamic micro-batching (apps/batching.py): concurrent requests
    # coalesce into one batched device dispatch, up to max_batch or until
    # batch_wait_ms passes since the first waiter; 1 = per-request calls
    max_batch: int = 1
    batch_wait_ms: float = 3.0
    top_k: int = 50
    # fixed rotation offsets (x, y, z, w quaternions) chained onto the
    # published TF's rotation, R_final = R_raw · R(q1) · R(q2) (reference
    # demo.py:220-224,616-623: q1 = 180° about the (1,0,1)/√2 XZ diagonal,
    # q2 = 90° about Z); translation stays raw.  Set to () to publish the
    # raw grasp rotation.
    tf_rotation_offsets: tuple = (
        (0.7071068, 0.0, 0.7071068, 0.0),
        (0.0, 0.0, 0.7071068, 0.7071068),
    )
    device: str = "cuda"  # the card unless the caller asks for "cpu"

    def mesh(self):
        """The serving mesh of `graspnet_tpu/apps/service.py:76-108`, or
        None on one device."""
        if self.data_devices > 1 and (self.max_batch < self.data_devices or self.max_batch % self.data_devices):
            raise ValueError(
                "data_devices requires micro-batching with max_batch a positive multiple of it "
                f"(got max_batch={self.max_batch}, data_devices={self.data_devices})"
            )
        n = self.data_devices * self.candidate_devices
        if n == 1:
            return None
        from graspnet_tpu_torch.parallel.mesh import make_mesh

        devices = self.mesh_devices
        if devices is None and self.device == "cpu":
            devices = ("cpu",) * n
        if self.candidate_devices > 1 and self.data_devices > 1:
            return make_mesh(n, ("data", "candidate"), devices=devices,
                             shape=(self.data_devices, self.candidate_devices))
        return make_mesh(n, ("candidate",) if self.candidate_devices > 1 else ("data",), devices=devices)


class GraspService:
    """Capture-to-grasp core shared by all deployment wrappers."""

    def __init__(self, cfg: ServiceConfig = ServiceConfig()):
        self.cfg = cfg
        self._requests = itertools.count()  # the trace ids of the requests' spans
        model_cfg = cfg.model_cfg or GraspNetConfig(num_point=cfg.num_point)
        self.pipe = GraspPipeline(cfg=model_cfg, checkpoint_path=cfg.checkpoint_path, device=cfg.device,
                                  mesh=cfg.mesh())
        # warm the program compute() runs: the raw decode (the service
        # filters before truncating, so it never takes the fused top-K)
        self.batcher = None
        if cfg.max_batch > 1:
            from graspnet_tpu_torch.apps.batching import MicroBatcher

            self.batcher = MicroBatcher(
                self.pipe,
                max_batch=cfg.max_batch,
                max_wait_ms=cfg.batch_wait_ms,
                collision_thresh=cfg.collision_thresh,
                voxel_size=cfg.voxel_size,
            )
            self.batcher.warmup()
        else:
            self.pipe.warmup(collision_thresh=cfg.collision_thresh, top_k=0)

    def close(self):
        if self.batcher is not None:
            self.batcher.close()

    # -- filters (reference grasp_service.py:113-150, 263-269) -------------
    @staticmethod
    def filter_by_mask_proximity(gg: GraspGroup, mask_points: np.ndarray, thresh: float) -> GraspGroup:
        """Keep grasps whose center lies near any segmented point."""
        if len(gg) == 0:
            return gg
        if len(mask_points) == 0:
            # a provided-but-empty segmentation means the target object is
            # not visible: nothing may pass the proximity gate (returning
            # everything would aim the robot at an arbitrary object)
            return GraspGroup()
        centers = gg.translations
        d = np.linalg.norm(centers[:, None, :] - mask_points[None, :, :], axis=-1).min(axis=1)
        return gg[d <= thresh]

    @staticmethod
    def filter_by_world_approach(gg: GraspGroup, world_from_camera: np.ndarray, max_world_z: float) -> GraspGroup:
        """Reject grasps whose approach direction, expressed in the world
        frame, points upward beyond max_world_z (reference
        grasp_service.py:298-303)."""
        if len(gg) == 0:
            return gg
        approach_cam = gg.rotation_matrices[:, :, 0]  # x-axis = approach
        approach_world = approach_cam @ world_from_camera[:3, :3].T
        return gg[approach_world[:, 2] <= max_world_z]

    # -- main entry ---------------------------------------------------------
    def compute(
        self,
        cloud: np.ndarray,
        mask_points: Optional[np.ndarray] = None,
        world_from_camera: Optional[np.ndarray] = None,
    ) -> dict:
        """Full request: cloud (N,3) in camera frame -> best grasp + group.

        On the card at `max_batch` 1 the capture crosses to the card once:
        the depth window and the sample's gather run there
        (`depth_window`, `GraspPipeline.sample_cloud`), and the windowed
        scene and the sampled cloud stay there for the collision filter
        and the forward.  Micro-batched, or on the CPU, both are numpy on
        the host.  Either way they are the same rows, bit for bit, and the
        `service.sample` span counts the capture's `points`, the `window`'s
        rows and `card` (1 on the card's route, else 0).

        The reply's `timings_ms` are this request's own: `infer`, from the
        decode's dispatch through the fetch of its rows; `collision`, the
        collision filter (the raw cloud's voxel downsample, on the card
        when the service runs there, through the masks; 0 when the filter
        is off).  Micro-batched (`max_batch` > 1),
        `infer` and `collision` are the request's batch's (`collision`
        then leaves out the downsample, which runs on the request's own
        thread before it queues), `timings_ms.queue` is the wait from the
        request's hand-over to the batcher to its batch's dispatch, and
        the reply's `batch` is that batch's size: the operator's reading
        of queue time and occupancy.  `timings_ms` also holds the ms of
        the request's spans by name (`utils/tracing.py`): its own
        `service.sample`, `collision.downsample` and `service.select`, and
        the `pipeline.dispatch`, `pipeline.fetch` and `collision.detect`
        of its decode and filter (its batch's, micro-batched)."""
        c = self.cfg
        timings = {"collision": 0.0}
        with span("service.compute", trace=next(self._requests)):
            with span("service.sample", into=timings) as sample:
                on_card = self.batcher is None and self.pipe.device.type == "cuda"
                sample.count(points=len(cloud), card=on_card)
                if on_card:
                    cloud = depth_window(cloud, c.depth_min, c.depth_max, self.pipe.device)
                else:
                    z = cloud[:, 2]
                    cloud = cloud[(z >= c.depth_min) & (z <= c.depth_max)]
                sample.count(window=len(cloud))
                # reference demo.py:459 rejects frames with < 10% of num_point valid
                if len(cloud) < max(100, self.pipe.cfg.num_point // 10):
                    return {"ok": False, "error": "not enough points in depth range"}
                sampled = self.pipe.sample_cloud(cloud)
            if self.batcher is not None:
                # micro-batched path: downsample on THIS request thread (host
                # work parallelizes across concurrent requests), then coalesce
                # the device work with concurrent requests.  Result-identical
                # to the per-request path (tests/test_torch_port_service.py)
                ds = None
                if c.collision_thresh > 0:
                    with span("collision.downsample", into=timings) as s:
                        ds = native.voxel_downsample(cloud, c.voxel_size)
                        s.count(points=len(cloud), voxels=len(ds))
                gg, batched = self.batcher.submit(sampled, ds)
                timings.update(batched)
            else:
                gg = self.pipe.run(sampled, scene_cloud=cloud, collision_thresh=c.collision_thresh,
                                   voxel_size=c.voxel_size, nms=False, top_k=0,  # NMS and top-K below
                                   timings=timings)
            with span("service.select", into=timings) as select:
                select.count(rows=len(gg))  # rows into NMS
                gg = gg.sort_by_score().nms()
                if mask_points is not None:
                    gg = self.filter_by_mask_proximity(gg, mask_points, c.seg_proximity_thresh)
                if world_from_camera is not None and c.max_world_z_for_approach is not None:
                    gg = self.filter_by_world_approach(gg, world_from_camera, c.max_world_z_for_approach)
                gg = gg.sort_by_score()[: c.top_k]
            if len(gg) == 0:
                return {"ok": False, "error": "no valid grasp"}
            with span("service.reply"):
                return self._reply(gg, timings)

    def _reply(self, gg: GraspGroup, timings: dict) -> dict:
        best = gg[0]
        tf_pose = apply_rotation_offsets(best.to_matrix(), self.cfg.tf_rotation_offsets)
        reply = {
            "ok": True,
            "best_pose": best.to_matrix().tolist(),
            "tf_pose": tf_pose.tolist(),
            "best_score": best.score,
            "best_width": best.width,
            "num_grasps": len(gg),
            "grasps": gg.grasp_group_array.tolist(),
            "timings_ms": {k: v * 1000 for k, v in timings.items() if k != "batch"},
        }
        if "batch" in timings:
            reply["batch"] = timings["batch"]
        return reply


def depth_window(cloud: np.ndarray, depth_min: float, depth_max: float, device) -> torch.Tensor:
    """The rows of an (N, 3) capture whose z lies in [depth_min, depth_max],
    taken on `device` after one copy of the capture there, in capture
    order: numpy's `cloud[(z >= depth_min) & (z <= depth_max)]`, bit for
    bit.  The bounds are rounded to the capture's dtype, as numpy compares
    a float32 array with a Python float (NEP 50); the window is a stable
    compaction (`nonzero`'s ascending rows, then a gather), and the read of
    its size is the one wait for the device."""
    cloud = np.ascontiguousarray(cloud)
    lo, hi = (float(np.asarray(v, cloud.dtype)) for v in (depth_min, depth_max))
    pts = torch.from_numpy(cloud).to(device)
    z = pts[:, 2]
    return pts.index_select(0, torch.nonzero((z >= lo) & (z <= hi)).squeeze(1))


# --------------------------------------------------- ROS message helpers ----
# Pure functions (no rclpy import) so the message decoding / segmentation
# geometry is unit-testable without a ROS install.


def pointcloud2_to_xyz(msg):
    """PointCloud2 -> ((N, 3) float32 xyz, (N, 3) float rgb or None).

    Assumes float32 x/y/z/rgb fields (the layout the reference consumes,
    grasp_service.py:166-177) but honors each PointField's byte `offset` —
    standard PCL/RealSense XYZRGB clouds pad (x@0 y@4 z@8 rgb@16,
    point_step 32), so the declaration-order column is NOT the byte
    position.  Fields without an `offset` attribute (test doubles) fall
    back to 4-byte declaration-order strides.  Packed rgb floats are
    bit-reinterpreted as uint32.  `msg` needs .data, .point_step and
    .fields — a real sensor_msgs PointCloud2 or any namespace shaped
    like one.

    Layouts outside those assumptions are rejected up front instead of
    decoding to garbage: big-endian messages, consumed fields with a
    non-FLOAT32 datatype (e.g. a uint16 `ring` column is fine as long as
    x/y/z/rgb are floats), and organized clouds whose rows carry padding
    are all raised as ValueError (row padding is stripped per row first).
    """
    if getattr(msg, "is_bigendian", False):
        raise ValueError("big-endian PointCloud2 is not supported")
    cols = {}
    for i, f in enumerate(msg.fields):
        if f.name in ("x", "y", "z", "rgb"):
            dt = getattr(f, "datatype", 7)
            if dt != 7:  # sensor_msgs PointField.FLOAT32
                raise ValueError(f"field {f.name!r} has datatype {dt}, expected FLOAT32 (7)")
        off = getattr(f, "offset", None)
        cols[f.name] = (off if off is not None else 4 * i) // 4
    data = bytes(msg.data)
    height = getattr(msg, "height", 1)
    width = getattr(msg, "width", None)
    row_step = getattr(msg, "row_step", None)
    if height > 1 and row_step and width and row_step != width * msg.point_step:
        if row_step < width * msg.point_step or len(data) < height * row_step:
            raise ValueError(
                f"inconsistent PointCloud2 layout: row_step={row_step}, "
                f"width*point_step={width * msg.point_step}"
            )
        rows = np.frombuffer(data, dtype=np.uint8)[: height * row_step]
        data = rows.reshape(height, row_step)[:, : width * msg.point_step].tobytes()
    cloud = np.frombuffer(data, dtype=np.float32).reshape(-1, msg.point_step // 4)
    xyz = cloud[:, [cols[c] for c in ("x", "y", "z")]]
    rgb = None
    if "rgb" in cols:
        packed = cloud[:, cols["rgb"]].copy()
        packed.dtype = np.uint32
        rgb = (
            np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF], axis=1).astype(np.float32)
            / 255.0
        )
    return np.ascontiguousarray(xyz, dtype=np.float32), rgb


def segment_cloud_by_mask(points: np.ndarray, mask_image: np.ndarray, intrinsics) -> Optional[np.ndarray]:
    """Points whose pinhole projection lands on a hot mask pixel
    (reference grasp_service.py:226-238: project, bounds-check, mask > 127)."""
    if points is None or len(points) == 0:
        return None
    fx, fy, cx, cy = intrinsics
    h, w = mask_image.shape[:2]
    in_front = points[:, 2] > 0
    p = points[in_front]
    u = p[:, 0] * fx / p[:, 2] + cx
    v = p[:, 1] * fy / p[:, 2] + cy
    bounds = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    ui, vi = u[bounds].astype(int), v[bounds].astype(int)
    hot = mask_image[vi, ui] > 127
    return points[np.where(in_front)[0][bounds][hot]]


# ----------------------------------------------------------- TCP wrapper ----


def serve_tcp(
    service: GraspService,
    host: str = "127.0.0.1",
    port: int = 9876,
    request_timeout_s: float = 60.0,
):
    """JSON-over-TCP trigger server: one request per connection, one
    handler thread per connection (concurrent requests reach the service
    together; with max_batch > 1 the batcher coalesces them).

    Request: {"cloud": [[x,y,z],...], "mask_points": [...]? ,
              "world_from_camera": 4x4? } — one JSON document, terminated by
    newline OR by half-closing the socket (shutdown(SHUT_WR)).  json.dumps
    output never contains a raw newline, so readline-framing accepts both
    client styles; a read() -until-EOF server would deadlock forever against
    clients that keep the socket open while waiting for the reply.
    Response: GraspService.compute() dict as one JSON line.  Returns the
    server, already serving on a daemon thread; `shutdown()` stops it.
    """

    class Handler(socketserver.StreamRequestHandler):
        timeout = request_timeout_s  # socketserver closes the request on it

        def handle(self):
            try:
                data = self.rfile.readline()
                req = json.loads(data.decode())
                cloud = np.asarray(req["cloud"], dtype=np.float32)
                mask = np.asarray(req["mask_points"], dtype=np.float32) if "mask_points" in req else None
                wfc = np.asarray(req["world_from_camera"], dtype=np.float32) if "world_from_camera" in req else None
                out = service.compute(cloud, mask, wfc)
            except Exception as e:  # noqa: BLE001 — the server reports and keeps serving
                out = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            self.wfile.write(json.dumps(out).encode() + b"\n")

    srv = socketserver.ThreadingTCPServer((host, port), Handler)
    srv.daemon_threads = True
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv


# ----------------------------------------------------------- ROS wrapper ----


def run_ros_node(service_cfg: ServiceConfig, camera_link: str = "camera_link"):
    """rclpy node exposing the reference's trigger service + TF broadcast.

    Requires ROS 2 (rclpy); import is deferred so the rest of the package
    works without it.
    """
    import rclpy  # noqa: PLC0415
    from rclpy.node import Node
    from std_srvs.srv import Trigger
    from tf2_ros import TransformBroadcaster

    from graspnet_tpu_torch.data.camera import CameraInfo, create_point_cloud_from_depth_image
    from graspnet_tpu_torch.sensors.cameras import CameraRealsense

    class GraspServiceNode(Node):
        def __init__(self):
            super().__init__("graspnet_tpu_service")
            self.service = GraspService(service_cfg)
            self.camera = CameraRealsense()
            self.broadcaster = TransformBroadcaster(self)
            self.srv = self.create_service(Trigger, "trigger_grasp_calculation", self.handle_trigger)

        def handle_trigger(self, request, response):
            try:
                self.camera.connect()
                rgb, depth = self.camera.get_rgbd()
                k = self.camera.camera_k()
                cam = CameraInfo(depth.shape[1], depth.shape[0], k[0, 0], k[1, 1], k[0, 2], k[1, 2], 1.0)
                cloud = create_point_cloud_from_depth_image(depth, cam, organized=False)
                out = self.service.compute(cloud)
                if out["ok"]:
                    # offset-chained rotation, raw translation (demo.py:616-655)
                    _publish_estimated_grasp_tf(self.broadcaster, self.get_clock(), np.asarray(out["tf_pose"]),
                                                camera_link)
                response.success = bool(out["ok"])
                response.message = json.dumps({k: v for k, v in out.items() if k != "grasps"})
            except Exception as e:  # noqa: BLE001 — the node reports and keeps serving
                response.success = False
                response.message = f"{type(e).__name__}: {e}"
            finally:
                try:
                    self.camera.disconnect()
                except Exception:  # noqa: BLE001 — a failed release must not mask the reply
                    pass
            return response

    rclpy.init()
    node = GraspServiceNode()
    try:
        rclpy.spin(node)
    finally:
        node.destroy_node()
        rclpy.shutdown()


def run_ros_consumer_node(
    service_cfg: ServiceConfig,
    camera_link: str = "camera_link",
    world_frame: str = "world",
    points_topic: str = "/perception/points",
    mask_topic: str = "/perception/mask",
    camera_info_topic: str = "/perception/camera_info",
    min_callback_period_s: float = 2.0,
):
    """Subscription-driven variant (reference grasp_service.py): an
    ApproximateTimeSynchronizer over points + mask + camera_info triggers the
    pipeline (rate-limited to one run per `min_callback_period_s`), grasps
    are filtered by mask proximity and world-frame approach (via a TF
    lookup), and the best grasp publishes as the `estimated_grasp` TF."""
    import rclpy  # noqa: PLC0415
    import message_filters
    import tf2_ros
    from rclpy.node import Node
    from sensor_msgs.msg import CameraInfo, Image, PointCloud2

    class GraspNetConsumerNode(Node):
        def __init__(self):
            super().__init__("graspnet_tpu_consumer")
            self.service = GraspService(service_cfg)
            self.broadcaster = tf2_ros.TransformBroadcaster(self)
            self.tf_buffer = tf2_ros.Buffer()
            self.tf_listener = tf2_ros.TransformListener(self.tf_buffer, self)
            self.last_time = None
            subs = [
                message_filters.Subscriber(self, PointCloud2, points_topic),
                message_filters.Subscriber(self, Image, mask_topic),
                message_filters.Subscriber(self, CameraInfo, camera_info_topic),
            ]
            self.ts = message_filters.ApproximateTimeSynchronizer(subs, queue_size=10, slop=0.2)
            self.ts.registerCallback(self.perception_callback)

        def perception_callback(self, pcd_msg, mask_msg, info_msg):
            now = self.get_clock().now()
            if self.last_time is not None and (now - self.last_time).nanoseconds / 1e9 < min_callback_period_s:
                self.get_logger().warn("data arrived too quickly; skipping frame")
                return
            self.last_time = now
            try:
                cloud, _ = pointcloud2_to_xyz(pcd_msg)
                if mask_msg.encoding not in ("mono8", "8UC1"):
                    self.get_logger().error(f"unsupported mask encoding {mask_msg.encoding!r}")
                    return
                # honor row stride: step >= width when rows are padded
                mask = np.frombuffer(bytes(mask_msg.data), np.uint8).reshape(
                    mask_msg.height, mask_msg.step)[:, : mask_msg.width]
                k = info_msg.k
                mask_pts = segment_cloud_by_mask(cloud, mask, (k[0], k[4], k[2], k[5]))
                wfc = None
                if service_cfg.max_world_z_for_approach is not None:
                    tfs = self.tf_buffer.lookup_transform(world_frame, camera_link, rclpy.time.Time())
                    q = tfs.transform.rotation
                    wfc = np.eye(4, dtype=np.float32)
                    wfc[:3, :3] = quaternion_to_matrix([q.x, q.y, q.z, q.w])
                out = self.service.compute(cloud, mask_points=mask_pts, world_from_camera=wfc)
                if out["ok"]:
                    _publish_estimated_grasp_tf(self.broadcaster, self.get_clock(), np.asarray(out["tf_pose"]),
                                                camera_link)
                else:
                    self.get_logger().warn(f"no grasp: {out.get('error')}")
            except Exception as e:  # noqa: BLE001 — the node logs and keeps serving
                self.get_logger().error(f"perception callback failed: {e}")

    rclpy.init()
    node = GraspNetConsumerNode()
    try:
        rclpy.spin(node)
    finally:
        node.destroy_node()
        rclpy.shutdown()


def _publish_estimated_grasp_tf(broadcaster, clock, pose: np.ndarray, parent: str):
    """Broadcast a 4x4 pose as the `estimated_grasp` child TF."""
    from geometry_msgs.msg import TransformStamped

    t = TransformStamped()
    t.header.stamp = clock.now().to_msg()
    t.header.frame_id = parent
    t.child_frame_id = "estimated_grasp"
    t.transform.translation.x = float(pose[0, 3])
    t.transform.translation.y = float(pose[1, 3])
    t.transform.translation.z = float(pose[2, 3])
    q = matrix_to_quaternion(pose[:3, :3])
    t.transform.rotation.x = float(q[0])
    t.transform.rotation.y = float(q[1])
    t.transform.rotation.z = float(q[2])
    t.transform.rotation.w = float(q[3])
    broadcaster.sendTransform(t)


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--port", type=int, default=9876)
    p.add_argument("--ros", action="store_true", help="run as a ROS 2 trigger-service node (reference demo.py)")
    p.add_argument(
        "--ros_consumer", action="store_true",
        help="run as a ROS 2 subscription consumer node (reference grasp_service.py: synchronized "
        "points/mask/camera_info topics)",
    )
    p.add_argument("--collision_thresh", type=float, default=0.01)
    p.add_argument(
        "--num_point", type=int, default=20000,
        help="points sampled per request (reference demo.py's ROS node defaults to 40000; 20000 is the "
        "train/test operating point)",
    )
    p.add_argument("--candidate_devices", type=int, default=1,
                   help="shard each frame's candidate sweep over N cards (latency)")
    p.add_argument("--data_devices", type=int, default=1,
                   help="shard coalesced request batches one frame a card (throughput; needs --max_batch "
                   "a multiple of N)")
    p.add_argument(
        "--max_batch", type=int, default=1,
        help="micro-batch concurrent requests into one device dispatch; 1 disables",
    )
    p.add_argument("--batch_wait_ms", type=float, default=3.0,
                   help="how long the first request of a batch waits for companions")
    p.add_argument("--camera_link", default="camera_link")
    p.add_argument("--world_frame", default="world")
    p.add_argument("--max_world_z_for_approach", type=float, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    cfg = ServiceConfig(
        checkpoint_path=args.checkpoint_path,
        collision_thresh=args.collision_thresh,
        num_point=args.num_point,
        max_world_z_for_approach=args.max_world_z_for_approach,
        candidate_devices=args.candidate_devices,
        data_devices=args.data_devices,
        max_batch=args.max_batch,
        batch_wait_ms=args.batch_wait_ms,
        device=args.device,
    )
    if args.ros_consumer:
        run_ros_consumer_node(cfg, camera_link=args.camera_link, world_frame=args.world_frame)
    elif args.ros:
        run_ros_node(cfg)
    else:
        service = GraspService(cfg)
        srv = serve_tcp(service, port=args.port)
        print(f"grasp service listening on :{srv.server_address[1]} (JSON over TCP)", flush=True)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            srv.shutdown()
            service.close()


if __name__ == "__main__":
    main()
