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

from graspnet_tpu_torch.ops import scatter, voxel
from graspnet_tpu_torch.ops.cuda import attn, boxes, build, crop, fps, mlp_train, query, sa, spconv


class OnCard(torch.Tensor):
    """A CPU tensor that the launchers take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


def card(x) -> OnCard:
    return torch.as_tensor(x).as_subclass(OnCard)


class FakeLib:
    """Every C function: returns 0 (success) or a size the wrapper accepts,
    and records (name, the device `on_device` made current, or None), and
    its last arguments under its name."""

    def __init__(self, state):
        self.state = state

    def __getattr__(self, name):
        state = self.state

        def fn(*args):
            state["calls"].append((name, state["current"]))
            state["args"][name] = args
            state["typed"][name] = fn.argtypes is not None and len(fn.argtypes) == len(args)
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
    state = {"calls": [], "args": {}, "typed": {}, "current": None}

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
    "voxel_downsample": lambda x, c, r: voxel.voxel_downsample(x[0], 0.01),
    "sa_group": lambda x, c, r: (
        sa.sa_group(x, c, card(np.zeros((1, 32, 1), np.float32)), card(np.zeros((1, 4, 8), np.int64)), 0.05,
                    folded((4, 8))[0]),
        sa.sa_group(x, c, card(np.zeros((1, 32, 8), np.float32)), card(np.zeros((1, 4, 8), np.int64)), None)),
    "sa_bias_relu": lambda x, c, r: (
        sa.sa_bias_relu(card(np.zeros((1, 4, 8, 16), np.float32)), card(np.zeros(16, np.float32))),
        sa.sa_bias_relu(card(np.zeros((1, 4, 8, 16), np.float32)), card(np.zeros(16, np.float32)), pool=True)),
    "attention": lambda x, c, r: attn.attention(
        card(np.zeros((1, 5, 72), np.float32)), card(np.zeros((1, 9, 72), np.float32)),
        card(np.zeros((1, 9, 72), np.float32)), 2),
    "attention_varlen": lambda x, c, r: attn.attention_varlen(
        card(np.zeros((9, 96), np.float32)), card(np.array([0, 4, 9], np.int32)), 2, 5),
    "count_in_boxes": lambda x, c, r: boxes.count_in_boxes(
        card(np.zeros((1, 32, 4), np.float32))[..., :3], c, c + 0.01),
    "kernel_map": lambda x, c, r: spconv.kernel_map(card(np.zeros((32, 3), np.int32)), card(np.zeros(32, np.int32)), 3),
    "subm_conv": lambda x, c, r: spconv.subm_conv(
        card(np.zeros((32, 8), np.float32)), card(np.zeros((32, 27), np.int32)),
        card(np.zeros((27 * 8, 16), np.float32)), card(np.zeros(16, np.float32))),
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
        # an argument without a declared type goes over as a C int: a pointer after it is cut to 32 bits
        assert state["typed"][fn], f"{fn}'s argtypes do not declare every argument it is called with"


def test_the_launchers_cover_every_wrapper():
    """Every counted kernel wrapper has a case above (K7's forward counts
    in crop_mlp_train)."""
    from graspnet_tpu_torch.ops.cuda import WRAPPERS

    assert {w.__name__ for w in WRAPPERS} == set(LAUNCHERS)


def test_attention_loads_its_library_at_the_call(state, monkeypatch):
    """The attention wrapper asks for its own library (`attn`) when it
    launches, and only then; a head width other than 36 raises before."""
    asked = []
    lib = build.load("any")
    monkeypatch.setattr(build, "load", lambda name: asked.append(name) or lib)
    q = card(np.zeros((2, 3, 36), np.float32))
    with pytest.raises(ValueError, match="attention takes"):
        attn.attention(card(np.zeros((2, 3, 32), np.float32)), q, q, 1)
    assert asked == []
    attn.attention(q, q, q, 1)
    assert asked == ["attn"] and [fn for fn, _ in state["calls"]] == ["gn_attention"]


def test_attention_varlen_loads_its_library_at_the_call(state, monkeypatch):
    """The variable-length entry asks for the attention library when it
    launches, and only then, with the packed rows' stride and the
    sequences; a head width other than 16 or starts of another dtype raise
    before.  It counts in `attention_varlen.launches`."""
    asked = []
    lib = build.load("any")
    monkeypatch.setattr(build, "load", lambda name: asked.append(name) or lib)
    qkv, starts = card(np.zeros((100, 96), np.float32)), card(np.array([0, 48, 96, 100], np.int32))
    for bad in ((card(np.zeros((100, 108), np.float32)), starts, 2), (qkv, card(np.array([0, 100])), 2),
                (card(np.zeros((100, 96), np.float64)), starts, 2)):
        with pytest.raises(ValueError, match="attention_varlen takes"):
            attn.attention_varlen(*bad, 48)
    assert asked == []
    before = attn.attention_varlen.launches
    attn.attention_varlen(qkv, starts, 2, 48)
    assert asked == ["attn"] and [fn for fn, _ in state["calls"]] == ["gn_attention_varlen"]
    assert state["args"]["gn_attention_varlen"][3:8] == (96, 3, 48, 2, 16)
    assert attn.attention_varlen.launches == before + 1


def test_sparse_kernels_load_their_library_at_the_call(state, monkeypatch):
    """The map and the convolution ask for their own library (`spconv`)
    when they launch, and only then; what they do not take raises before."""
    asked = []
    lib = build.load("any")
    monkeypatch.setattr(build, "load", lambda name: asked.append(name) or lib)
    grid, batch = card(np.zeros((40, 3), np.int32)), card(np.zeros(40, np.int32))
    with pytest.raises(ValueError, match="kernel_map takes"):
        spconv.kernel_map(grid, batch, 7)
    x, kmap = card(np.zeros((40, 8), np.float32)), card(np.zeros((40, 27), np.int32))
    with pytest.raises(ValueError, match="subm_conv takes"):
        spconv.subm_conv(x, kmap, card(np.zeros((27 * 8, 6), np.float32)))
    assert asked == []
    spconv.kernel_map(grid, batch, 5)
    spconv.subm_conv(x, kmap, card(np.zeros((27 * 8, 8), np.float32)))
    assert asked == ["spconv", "spconv"]
    assert [fn for fn, _ in state["calls"]] == ["gn_kernel_map", "gn_subm_conv"]
    assert state["args"]["gn_kernel_map"][2:4] == (40, 5) and state["args"]["gn_kernel_map"][6] == 128
    assert state["args"]["gn_subm_conv"][3] is None and state["args"]["gn_subm_conv"][5:9] == (40, 8, 8, 27)


def test_box_count_loads_its_library_at_the_call(state, monkeypatch):
    """The box count asks for its own library (`boxes`) when it launches,
    and only then; what the kernel does not take raises before: another
    dtype, rank or width, a last axis that is not unit-stride, corners of
    two shapes or another batch."""
    asked = []
    lib = build.load("any")
    monkeypatch.setattr(build, "load", lambda name: asked.append(name) or lib)
    pts, lo = card(np.zeros((2, 40, 3), np.float32)), card(np.zeros((2, 5, 3), np.float32))
    bad = [(card(np.zeros((2, 40, 3), np.float64)), lo, lo),
           (card(np.zeros((40, 3), np.float32)), lo[0], lo[0]),
           (card(np.zeros((2, 40, 4), np.float32)), lo, lo),
           (card(np.zeros((2, 3, 40), np.float32)).transpose(1, 2), lo, lo),
           (pts, lo, lo[:, :4]),
           (pts, lo[:1], lo[:1])]
    for args in bad:
        with pytest.raises(ValueError, match="count_in_boxes takes"):
            boxes.count_in_boxes(*args)
    assert asked == []
    before = boxes.count_in_boxes.launches
    boxes.count_in_boxes(pts, lo, lo)
    assert asked == ["boxes"] and [fn for fn, _ in state["calls"]] == ["gn_box_count"]
    assert boxes.count_in_boxes.launches == before + 1


@pytest.mark.parametrize("b,p,n,width", [(8, 256, 40000, 4), (8, 512, 50000, 4), (1, 1, 1, 3), (1, 33, 513, 4),
                                         (2, 300, 1000, 3), (3, 64, 1025, 5), (2, 0, 100, 4), (2, 7, 0, 4)])
def test_box_count_hands_the_rows_over_in_place(state, b, p, n, width):
    """The box count passes the kernel the points' and corners' own storage
    and strides (the pipeline's x[..., :3] of wider rows, corners as views
    of one (B, P, 6) array), the sizes and a (B, P) int64 output zeroed
    before the launch; with no boxes or no points it launches nothing and
    returns the zeros."""
    rows = card(np.ones((b, n, width), np.float32))
    corners = card(np.ones((b, p, 6), np.float32))
    pts, lo, hi = rows[..., :3], corners[..., :3], corners[..., 3:]
    before = boxes.count_in_boxes.launches
    got = boxes.count_in_boxes(pts, lo, hi)
    assert got.dtype == torch.int64 and got.shape == (b, p) and not got.any()
    if p == 0 or n == 0:
        assert state["calls"] == [] and boxes.count_in_boxes.launches == before
        return
    assert state["calls"] == [("gn_box_count", pts.device)] and boxes.count_in_boxes.launches == before + 1
    assert state["args"]["gn_box_count"] == (rows.data_ptr(), n * width, width, corners.data_ptr(), 6 * p, 6,
                                             corners.data_ptr() + 12, 6 * p, 6, b, n, p, got.data_ptr(), 0)


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


@pytest.mark.parametrize("n,cluster,ok", [(40000, 0, True), (40000, 8, True), (40000, 2, True),
                                          (196608, 0, True), (196609, 0, False), (24577, 1, False),
                                          (24576, 1, True), (40000, 1, False)])
def test_fps_chain_domain_is_the_slice_a_cta_holds(state, n, cluster, ok):
    """The kernel's limit is ceil(N / cluster) <= MAX_SLICE points a CTA
    (the default cluster is 8), not N: 40,000 points reach the launcher on
    the default cluster, and a slice past the limit raises before it."""
    xyz = card(np.ones((1, n, 3), np.float32))
    if ok:
        fps.fps_chain(xyz, (16, 4), cluster)
        assert [fn for fn, _ in state["calls"]] == ["gn_fps_chain"]
    else:
        ctas = cluster or fps.DEFAULT_CLUSTER
        with pytest.raises(ValueError, match=f"at most {fps.MAX_SLICE} points a CTA: N={n} over a cluster of {ctas}"):
            fps.fps_chain(xyz, (16, 4), cluster)
        assert state["calls"] == []



def _sa_stage_operands(stage, n: int = 48, m_max: int = 24):
    """Stand-ins of an eval SA stage's operands at the stage's widths and
    nsample (B=1, n input points, at most m_max centres)."""
    m = min(stage.npoint, m_max)
    xyz = card(np.zeros((1, n, 3), np.float32))
    new_xyz = card(np.zeros((1, m, 3), np.float32))
    features = card(np.zeros((1, n, stage.mlp[0] - 3), np.float32))
    idx = card(np.zeros((1, m, stage.nsample), np.int64))
    return xyz, new_xyz, features, idx, folded(stage.mlp)


def _featured_stages():
    from graspnet_tpu_torch.config import GraspNetConfig, GroupFreeConfig, VoteNetConfig

    cases = []
    for name, cfg in (("graspnet", GraspNetConfig()), ("graspnet_tiny", GraspNetConfig.tiny()),
                      ("votenet", VoteNetConfig()), ("votenet_tiny", VoteNetConfig.tiny()),
                      ("groupfree", GroupFreeConfig()), ("groupfree_tiny", GroupFreeConfig.tiny())):
        for key in ("sa1", "sa2", "sa3", "sa4"):
            if key != "sa1" or cfg.input_feature_dim:
                cases.append(pytest.param(getattr(cfg, key), id=f"{name}-{key}"))
    return cases


@pytest.mark.parametrize("stage", _featured_stages())
def test_sa_route_domain_covers_every_featured_eval_stage(state, stage):
    """Every eval SA stage with features of the three models' configurations
    and their tiny ones (Group-Free-3D's w2x: a 128-wide fused first layer,
    256- and 512-wide products) reaches the grouping kernel, one epilogue after each
    product but the last and the pooling epilogue after the last, all inside
    `on_device`; a first layer of contraction <= 4 (VoteNet's SA1) is the
    grouping kernel's."""
    xyz, new_xyz, features, idx, layers = _sa_stage_operands(stage)
    got = sa.sa_pool(xyz, new_xyz, features, idx, layers, stage.radius if stage.normalize_xyz else None)
    assert tuple(got.shape) == (1, new_xyz.shape[1], stage.mlp[-1])
    products = len(stage.mlp) - 1 - (stage.mlp[0] <= sa.MAX_FUSED_K)
    want = ["gn_sa_group"] + ["gn_sa_bias_relu"] * (products - 1) + ["gn_sa_bias_relu_max"]
    assert [fn for fn, _ in state["calls"]] == want
    assert all(dev == xyz.device for _, dev in state["calls"])


def _sa_bad_call(case: str):
    """One call outside the featured route's domain (VoteNet's SA1 widths
    and the epilogues' shapes otherwise)."""
    from graspnet_tpu_torch.config import VoteNetConfig

    stage = VoteNetConfig.tiny().sa1
    xyz, new_xyz, features, idx, layers = _sa_stage_operands(stage)
    y = card(np.zeros((1, 4, 8, 16), np.float32))
    bias = card(np.zeros(16, np.float32))
    calls = {
        "features_float64": lambda: sa.sa_group(xyz, new_xyz, card(np.zeros((1, 48, 1))), idx, 0.2, layers[0]),
        "indices_int32": lambda: sa.sa_group(xyz, new_xyz, features, card(np.zeros((1, 24, 16), np.int32)), 0.2),
        "no_features": lambda: sa.sa_group(xyz, new_xyz, None, idx, 0.2),
        "features_of_other_points": lambda: sa.sa_group(xyz, new_xyz, features[:, :40], idx, 0.2),
        "centres_of_other_batch": lambda: sa.sa_group(xyz, card(np.zeros((2, 24, 3), np.float32)), features, idx,
                                                      0.2),
        "radius_zero": lambda: sa.sa_group(xyz, new_xyz, features, idx, 0.0),
        "first_layer_5_wide": lambda: sa.sa_group(xyz, new_xyz, card(np.zeros((1, 48, 2), np.float32)), idx, 0.2,
                                                  folded((5, 8))[0]),
        "first_layer_bias_shape": lambda: sa.sa_group(xyz, new_xyz, features, idx, 0.2,
                                                      (layers[0][0], card(np.zeros(9, np.float32)))),
        "one_fused_layer_only": lambda: sa.sa_pool(xyz, new_xyz, features, idx, layers[:1], 0.2),
        "epilogue_not_contiguous": lambda: sa.sa_bias_relu(y.transpose(1, 2), bias),
        "epilogue_bias_width": lambda: sa.sa_bias_relu(y, card(np.zeros(8, np.float32))),
        "pool_of_3d": lambda: sa.sa_bias_relu(y[0], bias, pool=True),
        "epilogue_float64": lambda: sa.sa_bias_relu(card(np.zeros((4, 16))), bias),
    }
    return calls[case]


@pytest.mark.parametrize("case", ["features_float64", "indices_int32", "no_features", "features_of_other_points",
                                  "centres_of_other_batch", "radius_zero", "first_layer_5_wide",
                                  "first_layer_bias_shape", "one_fused_layer_only", "epilogue_not_contiguous",
                                  "epilogue_bias_width", "pool_of_3d", "epilogue_float64"])
def test_sa_route_outside_its_domain_raises_before_a_launch(state, case):
    """On the card a shape outside the kernels' domain raises ValueError
    before any C function runs: no silent fallback to the plain path."""
    with pytest.raises(ValueError, match="sa_(group|bias_relu|pool) takes"):
        _sa_bad_call(case)()
    assert state["calls"] == []
