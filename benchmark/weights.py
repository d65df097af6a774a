"""Seeded random weights of GraspNet, made by the benchmark on the device.

The scheme of the published graspnet-baseline code's initialisation as the
port states it: Kaiming-normal kernels over their fan-in (a kernel is
shaped (in, out)), zero biases, identity batch norms (scale 1, offset 0,
running mean 0, running variance 1).  All kernels are drawn in one call of
a `torch.Generator` on the device the weights are served on, so set-up
does not walk the leaves on the host.  The program and the reference get
the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

FILL = {"bias": 0.0, "scale": 1.0, "offset": 0.0, "mean": 0.0, "var": 1.0}


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """`shapes`: state-dict name -> shape.  Returns name -> float32 tensor on `device`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kernels = [k for k in shapes if k.endswith("kernel")]
    sizes = [math.prod(shapes[k]) for k in kernels]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for k, part in zip(kernels, torch.split(flat, sizes)):
        shape = shapes[k]
        out[k] = (part.reshape(shape) * math.sqrt(2.0 / shape[0])).contiguous()
    for k, shape in shapes.items():
        if k in out:
            continue
        leaf = k.rsplit(".", 1)[-1]
        if leaf not in FILL:
            raise KeyError(f"no initial value for the state-dict entry {k}")
        out[k] = torch.full(shape, FILL[leaf], dtype=torch.float32, device=device)
    return out
