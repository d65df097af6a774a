"""Device meshes for the in-process parallel inference paths.

Counterpart of `graspnet_tpu/parallel/mesh.py`.  A JAX `Mesh` is an array
of devices with named axes over which XLA shards a program; here it is the
same array of `torch.device`s, and the sharding is done by hand
(`parallel/candidate.py`): `shard_batch` splits a batch along dim 0, one
chunk for each position along an axis, and `replicate` copies a model to
each distinct device.  A device may repeat in an explicit list (the tests'
`["cpu"] * 8`, one card's `["cuda:0"] * 4`): the sharded code path then
runs on fewer devices than positions.  Data-parallel training runs in
processes, one a device, over torch.distributed (`parallel/distributed.py`).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn


class Mesh:
    """An array of torch devices with one name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device array needs {devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct(self) -> list:
        """The distinct devices, in first-appearance order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    devices: Optional[Sequence[Any]] = None,
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Mesh over the first n devices: `devices` when given (which may
    repeat a device), else the cards cuda:0..n-1.  1-D by default; pass
    `shape` for multi-axis meshes, e.g. make_mesh(4, ("data", "candidate"),
    shape=(2, 2)).  Asking for more cards than the host has raises: no card
    stands in for another unless the caller lists it twice."""
    if devices is None:
        have = torch.cuda.device_count()
        n = have if n_devices is None else n_devices
        if n < 1 or n > have:
            raise RuntimeError(
                f"a mesh of {n} CUDA device(s) on a host with {have}; pass devices= to name "
                "them (a device may repeat, e.g. ['cuda:0'] * 2, or ['cpu'] * 2)"
            )
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"a mesh of {n_devices} devices from a list of {len(devs)}")
            devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    assert len(shape) == len(axis_names), (shape, axis_names)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def axis_devices(mesh: Mesh, axis: str) -> list:
    """The device at each position along `axis` (the first along the others)."""
    k = mesh.axis_names.index(axis)
    return list(np.moveaxis(mesh.devices, k, 0).reshape(mesh.shape[axis], -1)[:, 0])


def shard_batch(mesh: Mesh, tree: Any, axis: str = "data") -> list:
    """Split a batch (a tensor, or a dict / list of them) along dim 0 over
    `axis`: one piece for each position, on that position's device.  The
    axis size must divide the batch."""
    devs = axis_devices(mesh, axis)
    n = len(devs)

    def split(x, i):
        if isinstance(x, dict):
            return {k: split(v, i) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(split(v, i) for v in x)
        x = torch.as_tensor(x)
        if x.dim() == 0:
            return x.to(devs[i])
        assert x.shape[0] % n == 0, f"batch {x.shape[0]} not divisible by mesh axis '{axis}' size {n}"
        per = x.shape[0] // n
        return x[i * per : (i + 1) * per].to(devs[i])

    return [split(tree, i) for i in range(n)]


def replicate(mesh: Mesh, model: nn.Module) -> Dict[torch.device, nn.Module]:
    """One copy of `model` on each distinct device of the mesh (the model
    itself where it already lies), keyed by device."""
    home = next(model.parameters()).device
    out = {}
    for d in mesh.distinct():
        out[d] = model if d == home else copy.deepcopy(model).to(d)
    return out
