"""One-shot grasp pose broadcaster (equivalent of reference graspnet_tf.py).

Counterpart of `graspnet_tpu/apps/grasp_tf.py`.  Computes the best grasp
ONCE from fixed input files at startup, then rebroadcasts the resulting
pose periodically — as a ROS 2 TF ('camera_depth_optical_frame' ->
'estimated_grasp', reference graspnet_tf.py:211-246) when rclpy is
available, or as a JSON heartbeat line on stdout otherwise, so downstream
consumers can latch the pose either way.  Runs on the card unless
`--device cpu`; `--tiny` takes `GraspNetConfig.tiny()`.

    python -m graspnet_tpu_torch.apps.grasp_tf --data_dir doc/example_data \
        --checkpoint_path checkpoint-rs.tar --period 0.5
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np

from graspnet_tpu_torch.apps.image_demo import load_frame
from graspnet_tpu_torch.apps.pipeline import GraspPipeline
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.utils.transforms import matrix_to_quaternion


def compute_best_grasp(args) -> np.ndarray | None:
    """Run the full pipeline once; returns a 4x4 pose or None."""
    cfg = GraspNetConfig.tiny() if args.tiny else GraspNetConfig(num_point=args.num_point)
    pipe = GraspPipeline(cfg=cfg, checkpoint_path=args.checkpoint_path, device=args.device)
    pipe.warmup(collision_thresh=args.collision_thresh, top_k=1)
    scene_cloud = load_frame(args.data_dir)
    sampled = pipe.sample_cloud(scene_cloud)
    gg = pipe.run(sampled, scene_cloud=scene_cloud, collision_thresh=args.collision_thresh, top_k=1)
    if len(gg) == 0:
        return None
    return gg[0].to_matrix()


def heartbeat(pose: np.ndarray, frame_id: str) -> dict:
    """The stdout heartbeat's message for a 4x4 pose."""
    q = matrix_to_quaternion(pose[:3, :3])
    return {
        "frame_id": frame_id,
        "child_frame_id": "estimated_grasp",
        "translation": pose[:3, 3].tolist(),
        "quaternion_xyzw": [float(v) for v in q],
    }


def broadcast_stdout(pose: np.ndarray, period: float, frame_id: str):
    msg = heartbeat(pose, frame_id)
    while True:
        print(json.dumps(msg), flush=True)
        time.sleep(period)


def broadcast_ros(pose: np.ndarray, period: float, frame_id: str):
    import rclpy  # noqa: PLC0415
    from geometry_msgs.msg import TransformStamped
    from rclpy.node import Node
    from tf2_ros import TransformBroadcaster

    class GraspTFNode(Node):
        def __init__(self):
            super().__init__("graspnet_tpu_tf_publisher")
            self.broadcaster = TransformBroadcaster(self)
            self.timer = self.create_timer(period, self.tick)

        def tick(self):
            t = TransformStamped()
            t.header.stamp = self.get_clock().now().to_msg()
            t.header.frame_id = frame_id
            t.child_frame_id = "estimated_grasp"
            t.transform.translation.x = float(pose[0, 3])
            t.transform.translation.y = float(pose[1, 3])
            t.transform.translation.z = float(pose[2, 3])
            q = matrix_to_quaternion(pose[:3, :3])
            t.transform.rotation.x = float(q[0])
            t.transform.rotation.y = float(q[1])
            t.transform.rotation.z = float(q[2])
            t.transform.rotation.w = float(q[3])
            self.broadcaster.sendTransform(t)

    rclpy.init()
    node = GraspTFNode()
    try:
        rclpy.spin(node)
    finally:
        node.destroy_node()
        rclpy.shutdown()


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--checkpoint_path", default=None)
    parser.add_argument("--num_point", type=int, default=20000)
    parser.add_argument("--collision_thresh", type=float, default=0.01)
    parser.add_argument("--period", type=float, default=0.5)
    parser.add_argument("--frame_id", default="camera_depth_optical_frame")
    parser.add_argument("--once", action="store_true", help="print the pose once and exit")
    parser.add_argument("--tiny", action="store_true", help="GraspNetConfig.tiny() (tests)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    pose = compute_best_grasp(args)
    if pose is None:
        raise SystemExit("no valid grasp found; nothing to broadcast")
    print("best grasp pose:\n", pose)
    if args.once:
        return pose
    try:
        broadcast_ros(pose, args.period, args.frame_id)
    except ImportError:
        broadcast_stdout(pose, args.period, args.frame_id)


if __name__ == "__main__":
    main()
