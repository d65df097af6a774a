"""What the port's timing scripts share: the card's name and power limit,
written beside every number they print, and their common arguments.

The port's timing of record is the benchmark (`benchmark/run.py`, one
cell a run) and, kernel by kernel, `chip_smoke.py`'s CUDA-event phases.
The scripts that use this module time what no cell covers yet: the
batcher (`bench_service`), the eval loop (`bench_test_app`) and several
cards (`bench_scaling`).
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Callable, Optional, Sequence, Tuple

import torch

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.device import resolve_device


def gpu_name_and_power() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cli(
    description: str,
    argv: Optional[Sequence[str]],
    add_arguments: Optional[Callable[[argparse.ArgumentParser], None]] = None,
) -> Tuple[argparse.Namespace, GraspNetConfig, torch.device]:
    """The timing scripts' shared arguments, and a script's own
    (`add_arguments`)."""
    ap = argparse.ArgumentParser(description=description)
    if add_arguments is not None:
        add_arguments(ap)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="GraspNetConfig.tiny() instead of GraspNetConfig()")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    args = ap.parse_args(argv)
    cfg = GraspNetConfig.tiny() if args.tiny else GraspNetConfig()
    device = resolve_device(args.device, ap.prog)
    print(f"backend: {device.type}", flush=True)
    return args, cfg, device
