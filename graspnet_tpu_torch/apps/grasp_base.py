"""Compose a saved camera-frame grasp with base<-camera extrinsics
(equivalent of reference grasp_base.py): offline utility printing the grasp
pose in the robot base frame.

Counterpart of `graspnet_tpu/apps/grasp_base.py`: numpy only, it runs no
model, so it has no device.

    python -m graspnet_tpu_torch.apps.grasp_base --grasp_path grasp.npy --extrinsics_path base_T_cam.npy
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from graspnet_tpu_torch.utils.transforms import compose_base_grasp


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--grasp_path", required=True, help=".npy 4x4 camera-frame grasp")
    p.add_argument("--extrinsics_path", required=True, help=".npy 4x4 base<-camera transform")
    args = p.parse_args(argv)
    grasp = np.load(args.grasp_path).reshape(4, 4)
    base_from_camera = np.load(args.extrinsics_path).reshape(4, 4)
    base_grasp = compose_base_grasp(base_from_camera, grasp)
    with np.printoptions(suppress=True, precision=5):
        print("grasp in base frame:\n", base_grasp)
    return base_grasp


if __name__ == "__main__":
    main()
