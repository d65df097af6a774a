"""Camera implementations.

Equivalent surface to reference realsense.py / zivid.py / npy_realsense.py:
aligned RGB-D capture in meters + intrinsics + the capture file format
(rgb_{ts}.png, 16-bit mm depth_{ts}.png, meta_{ts}.mat with intrinsic_matrix
and factor_depth=1000, reference realsense.py:142-174).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np


def save_capture(
    out_dir: str,
    rgb: np.ndarray,
    depth_m: np.ndarray,
    K: np.ndarray,
    timestamp: Optional[int] = None,
) -> str:
    """Save a capture in the reference's file format; returns the timestamp id."""
    import scipy.io as scio
    from PIL import Image

    ts = timestamp if timestamp is not None else int(time.time())
    os.makedirs(out_dir, exist_ok=True)
    rgb8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    depth_mm = (depth_m * 1000.0).astype(np.uint16)
    Image.fromarray(rgb8).save(os.path.join(out_dir, f"rgb_{ts}.png"))
    Image.fromarray(depth_mm).save(os.path.join(out_dir, f"depth_{ts}.png"))
    scio.savemat(
        os.path.join(out_dir, f"meta_{ts}.mat"),
        {"intrinsic_matrix": K, "factor_depth": np.array([[1000.0]])},
    )
    return str(ts)


class FileCamera:
    """Replays a saved capture (rgb/depth/meta paths) through the camera API."""

    def __init__(self, rgb_path: str, depth_path: str, meta_path: str):
        self.paths = (rgb_path, depth_path, meta_path)

    def connect(self):
        pass

    def disconnect(self):
        pass

    def camera_k(self) -> np.ndarray:
        import scipy.io as scio

        return np.asarray(scio.loadmat(self.paths[2])["intrinsic_matrix"])

    def get_rgbd(self) -> Tuple[np.ndarray, np.ndarray]:
        import scipy.io as scio
        from PIL import Image

        rgb = np.asarray(Image.open(self.paths[0]), dtype=np.float32) / 255.0
        depth_raw = np.asarray(Image.open(self.paths[1]))
        meta = scio.loadmat(self.paths[2])
        factor = float(np.asarray(meta["factor_depth"]).reshape(-1)[0])
        return rgb, depth_raw.astype(np.float32) / factor


class CameraRealsense:
    """Intel RealSense capture (reference realsense.py:16-141).

    Aligned color+depth at 1280x720, depth in meters; fixed exposure/laser
    settings applied per the reference's D435 configuration.
    """

    def __init__(self, serial_number: Optional[str] = None):
        try:
            import pyrealsense2 as rs  # noqa: PLC0415
        except ImportError as e:
            raise ImportError(
                "pyrealsense2 is required for CameraRealsense; use FileCamera "
                "to replay saved captures without the SDK"
            ) from e
        self._rs = rs
        self.serial_number = serial_number
        self.pipeline = None
        self._depth_scale = None
        self._intrinsics = None

    def connect(self, width: int = 1280, height: int = 720, fps: int = 30):
        rs = self._rs
        self.pipeline = rs.pipeline()
        config = rs.config()
        if self.serial_number:
            config.enable_device(self.serial_number)
        config.enable_stream(rs.stream.depth, width, height, rs.format.z16, fps)
        config.enable_stream(rs.stream.color, width, height, rs.format.bgr8, fps)
        profile = self.pipeline.start(config)
        device = profile.get_device()
        depth_sensor = device.first_depth_sensor()
        self._depth_scale = depth_sensor.get_depth_scale()
        if depth_sensor.supports(rs.option.laser_power):
            depth_sensor.set_option(rs.option.laser_power, 360)
        self._align = rs.align(rs.stream.color)
        stream = profile.get_stream(rs.stream.color).as_video_stream_profile()
        intr = stream.get_intrinsics()
        self._intrinsics = np.array(
            [[intr.fx, 0, intr.ppx], [0, intr.fy, intr.ppy], [0, 0, 1]]
        )

    def camera_k(self) -> np.ndarray:
        assert self._intrinsics is not None, "connect() first"
        return self._intrinsics

    def get_rgbd(self, timeout_ms: int = 5000) -> Tuple[np.ndarray, np.ndarray]:
        frames = self.pipeline.wait_for_frames(timeout_ms)
        frames = self._align.process(frames)
        depth = np.asanyarray(frames.get_depth_frame().get_data())
        color = np.asanyarray(frames.get_color_frame().get_data())
        rgb = color[..., ::-1].astype(np.float32) / 255.0  # BGR -> RGB
        return rgb, depth.astype(np.float32) * self._depth_scale

    def disconnect(self):
        if self.pipeline is not None:
            self.pipeline.stop()
            self.pipeline = None


class CameraZivid:
    """Zivid structured-light capture (reference zivid.py:20-238)."""

    def __init__(self):
        try:
            import zivid  # noqa: PLC0415
        except ImportError as e:
            raise ImportError(
                "the zivid SDK is required for CameraZivid; use FileCamera to "
                "replay saved captures without it"
            ) from e
        self._zivid = zivid
        self.app = None
        self.camera = None

    def connect(self):
        self.app = self._zivid.Application()
        self.camera = self.app.connect_camera()

    def camera_k(self) -> np.ndarray:
        intr = self._zivid.experimental.calibration.intrinsics(self.camera)
        cm = intr.camera_matrix
        return np.array([[cm.fx, 0, cm.cx], [0, cm.fy, cm.cy], [0, 0, 1]])

    def get_rgbd(self) -> Tuple[np.ndarray, np.ndarray]:
        settings = self._zivid.Settings(
            acquisitions=[self._zivid.Settings.Acquisition()]
        )
        with self.camera.capture(settings) as frame:
            pc = frame.point_cloud()
            rgba = pc.copy_data("rgba")
            z = pc.copy_data("z")  # mm
        rgb = rgba[..., :3].astype(np.float32) / 255.0
        depth = np.nan_to_num(z.astype(np.float32) / 1000.0)
        return rgb, depth

    def disconnect(self):
        if self.app is not None:
            self.app.release()
            self.app = None


def load_intrinsics_txt(path: str) -> np.ndarray:
    """Parse a K file holding 4 (fx fy cx cy) or 9 (row-major 3x3) numbers
    (reference foundationstereo.py:87-108 / K/K_rgb.txt)."""
    vals = np.loadtxt(path).reshape(-1)
    if vals.size == 9:
        return vals.reshape(3, 3)
    if vals.size == 4:
        fx, fy, cx, cy = vals
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    raise ValueError(f"intrinsics file must have 4 or 9 numbers, got {vals.size}")
