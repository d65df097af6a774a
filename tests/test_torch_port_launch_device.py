"""Every CUDA launcher makes its tensors' device current around its ctypes
call, through the one helper `ops/cuda/build.py::on_device`.

The C launchers launch on the device `cudaGetDevice` names and set the
shared memory limits there; a tensor on cuda:1 reached from a thread whose
current device is cuda:0 (the parallel paths' meshes) would otherwise be
launched on with another device's stream.  On the CPU no kernel can run, so
each launcher's Python path runs up to the ctypes call on stand-ins: CPU
tensors of a subclass that reports `is_cuda`, a library whose functions
record whether they were called inside `on_device` (and with which device),
and `on_device` replaced by a recorder.  A launcher that called its C
function outside the helper fails here.  The same launches on two cards:
tests/test_torch_port_cuda.py (skips with fewer).
"""

import contextlib

import numpy as np
import pytest
import torch

from graspnet_tpu_torch.ops import scatter
from graspnet_tpu_torch.ops.cuda import build, crop, fps, mlp_train, query


class OnCard(torch.Tensor):
    """A CPU tensor that the launchers take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


def card(x) -> OnCard:
    return torch.as_tensor(x).as_subclass(OnCard)


class FakeLib:
    """Every C function: returns 0 (success) or a size the wrapper accepts,
    and records (name, the device `on_device` made current, or None)."""

    def __init__(self, state):
        self.state = state

    def __getattr__(self, name):
        state = self.state

        def fn(*args):
            state["calls"].append((name, state["current"]))
            if name.endswith("_smem"):
                return 1 << 16
            if name == "gn_mlp_train_dims_ok":
                return 1
            if name == "gn_mlp_train_scratch":
                return 16
            return 0

        fn.argtypes = None
        fn.restype = None
        setattr(self, name, fn)
        return fn


@pytest.fixture
def state(monkeypatch):
    state = {"calls": [], "current": None}

    @contextlib.contextmanager
    def on_device(device):
        state["current"] = device
        try:
            yield 0
        finally:
            state["current"] = None

    lib = FakeLib(state)
    monkeypatch.setattr(build, "on_device", on_device)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(mlp_train, "_sm_count", lambda device: 4)
    return state


def inputs(rng, b=1, n=32, m=4):
    xyz = card(rng.uniform(-0.1, 0.1, (b, n, 3)).astype(np.float32))
    centres = card(rng.uniform(-0.1, 0.1, (b, m, 3)).astype(np.float32))
    rot = card(np.tile(np.eye(3, dtype=np.float32), (b, m, 1, 1)))
    return xyz, centres, rot


def folded(dims):
    return [(card(np.ones((a, c), np.float32)), card(np.zeros(c, np.float32))) for a, c in zip(dims, dims[1:])]


LAUNCHERS = {
    "fps_chain": lambda x, c, r: fps.fps_chain(x, (8, 4)),
    "ball_query": lambda x, c, r: query.ball_query(x, c, 0.05, 8),
    "cylinder_query_multi": lambda x, c, r: query.cylinder_query_multi(x, c, r, 0.05, -0.02, (0.01, 0.02), 8),
    "multi_query": lambda x, c, r: query.multi_query(x, c, r, 0.05, -0.02, (0.01, 0.02), 8),
    "crop_group": lambda x, c, r: crop.crop_group(x, c, r, 0.05, -0.02, (0.01, 0.02), 8),
    "crop_fused": lambda x, c, r: crop.crop_fused(x, c, r, folded((3, 8, 8, 16)), 0.05, -0.02, (0.01, 0.02), 8),
    "sa1_fused": lambda x, c, r: crop.sa1_fused(x, c, folded((3, 8, 8, 16)), 0.05, 8),
    "sa_feat_fused": lambda x, c, r: crop.sa_feat_fused(x, c, card(np.zeros((1, 32, 8), np.float32)),
                                                       folded((11, 8, 8, 16)), 0.05, 8),
    "crop_mlp_train": lambda x, c, r: mlp_train._forward_kernel(
        card(np.zeros((4, 8, 3), np.float32)), [card(np.ones(s, np.float32)) for s in ((3, 8), (8, 8), (8, 16))],
        [card(np.ones((2, w), np.float32)) for w in (8, 8, 16)], 1e-5),
    "crop_mlp_train_backward": lambda x, c, r: mlp_train.crop_mlp_train_backward(
        card(np.zeros((4, 8, 3), np.float32)), card(np.zeros((4, 16), np.float32)),
        card(np.zeros((4, 16), np.float32)), [card(np.ones(s, np.float32)) for s in ((3, 8), (8, 8), (8, 16))],
        [card(np.ones((2, w), np.float32)) for w in (8, 8, 16)],
        [card(np.ones((2, w), np.float32)) for w in (8, 8, 16)], 1e-5),
    "scatter_add_rows": lambda x, c, r: scatter.scatter_add_rows(
        card(np.ones((1, 6, 4), np.float32)), card(np.array([[0, 2, 2, 1, 0, 3]])), 5),
    "scatter_plan": lambda x, c, r: scatter.scatter_plan(card(np.array([[0, 2, 2, 1, 0, 3]])), 5),
}


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_every_launch_is_inside_on_device(state, name):
    xyz, centres, rot = inputs(np.random.default_rng(0))
    LAUNCHERS[name](xyz, centres, rot)
    launches = [(fn, dev) for fn, dev in state["calls"]
                if not fn.endswith(("_smem", "_dims_ok", "_scratch"))]
    assert launches, "no C launcher was reached"
    for fn, dev in launches:
        assert dev == xyz.device, f"{fn} was called outside on_device (current device {dev})"


def test_the_launchers_cover_every_wrapper():
    """Every counted kernel wrapper has a case above (K7's forward counts
    in crop_mlp_train)."""
    from graspnet_tpu_torch.ops.cuda import WRAPPERS

    assert {w.__name__ for w in WRAPPERS} == set(LAUNCHERS)


def test_on_device_makes_the_device_current_and_yields_its_stream(monkeypatch):
    """The helper itself, with torch's device exchange and raw-stream query
    recorded (no card here): the device is current while the launcher runs
    and the one before it is restored after, also when the launcher raises."""
    seen = []
    monkeypatch.setattr(torch.cuda, "_exchange_device", lambda i: seen.append(("enter", i)) or 0)
    monkeypatch.setattr(torch.cuda, "_maybe_exchange_device", lambda i: seen.append(("exit", i)) or 1)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: seen.append(("stream", i)) or 1234,
                        raising=False)
    dev = torch.device("cuda", 1)
    with build.on_device(dev) as stream:
        assert stream == 1234 and seen == [("enter", 1), ("stream", 1)]
    assert seen[-1] == ("exit", 0)
    with pytest.raises(RuntimeError):
        with build.on_device(dev):
            raise RuntimeError("launch failed")
    assert seen[-1] == ("exit", 0)
