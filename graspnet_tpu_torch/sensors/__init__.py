"""Sensor capture layer (reference L6): RealSense / Zivid / file-based.

Hardware SDKs (pyrealsense2, zivid) are optional; each camera class raises a
clear error at construction when its SDK is missing, and `FileCamera` replays
saved captures for SDK-less testing.  All cameras share one contract:

    connect() -> None
    get_rgbd() -> (rgb float [H,W,3] in [0,1], depth float32 [H,W] meters)
    camera_k() -> (3,3) intrinsics
    disconnect() -> None

A copy of `graspnet_tpu/sensors/` (numpy, PIL and scipy; the SDKs stay
lazy imports).
"""

from graspnet_tpu_torch.sensors.cameras import CameraRealsense, CameraZivid, FileCamera, save_capture

__all__ = ["CameraRealsense", "CameraZivid", "FileCamera", "save_capture"]
