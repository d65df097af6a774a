"""The device an entry point runs on: CUDA unless the caller asks for the
CPU (as the tests do).  Asking for CUDA on a host without it raises instead
of running on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device, who: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        # full-f32 products, stated explicitly: the port is held against
        # the XLA f32 path, and TF32 keeps only ~3 decimal digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
