"""The arithmetic of the tensor-core crop MLP (csrc/crop.cu, tc_mlp: the
CloudCrop's crop_mlp_tc_kernel and SA1's sa1_mlp_tc_kernel), emulated in
plain torch on the CPU.

The kernel runs layers 2 and 3 as TF32 `mma.sync` products in 3xTF32:
every f32 operand x splits into hi = tf32(x) (10 mantissa bits, round to
nearest with ties away from zero, the bits of `cvt.rna`) and lo = x - hi,
which the tensor core reads as TF32 by dropping its low 13 bits (toward
zero); the f32 accumulator takes lo*hi + hi*lo + hi*hi.  hi + tf32(lo)
meets x within 2^-21, and the dropped lo*lo term is ~2^-22 relative.
Products of TF32 values are exact in f32, so the emulation differs from the
kernel only in the order of its f32 sums.  Layer 1 (K = 3)
stays the plain broadcast-sum.  Rows come from `crop_fused_plain`'s own path
(`crop_group_plain`: the cylinder query, first-hit padding, far seeds that
pad with point 0, the rotation); weights are the model's folded crop MLP.

SA1's rows are built as sa1_mlp_tc_kernel builds them from the ball
scan's padded indices: (xyz[idx] - centre) x float32(1/r), each op rounded;
its weights are the model's folded SA1 MLP (3 -> 64 -> 64 -> 128, tiny 3 ->
8 -> 8 -> 16), with far centres whose every row is point 0's offset, and at
one small cloud the emulation also meets the JAX package's eval SA stage.

Readings on this file's inputs (max |emulated - reference| / max(1, scale),
feature scale 67 at the production widths, 20 at the tiny ones): against
`crop_fused_plain` (f32) 4.6e-07 and 1.9e-07; against a float64 evaluation
2.7e-07 and 1.5e-07, where the plain f32 version itself is 2.5e-07 and
6.4e-08 off; hi rounded with ties to even reads the same.  The gate on the
card is FEATURE_TOL = 1e-4; the float64 check here holds the emulation at
1e-6.  Plain TF32 (hi*hi only) is 3.8e-04 and 4.6e-04 off float64, which is
why the kernel splits.  SA1 (scale 897 and 360: the far centres' offsets
reach ~250 after x 1/r): against plain 2.2e-07 and 1.3e-07, against
float64 2.4e-07 and 1.3e-07; plain TF32 3.8e-04 and 1.1e-03.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspnet_tpu import ops as jops
from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.models.backbone import _sa_stage

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.models import GraspNet, geometry, init_weights
from graspnet_tpu_torch.nn.layers import dense, fold_bn_eval
from graspnet_tpu_torch.ops import gather_points
from graspnet_tpu_torch.ops.cuda.crop import crop_fused_plain, crop_group_plain
from graspnet_tpu_torch.ops.cuda.query import ball_query_plain
from graspnet_tpu_torch.ops.query import group_points

from tests.test_torch_port_ops import perturbed_mlp

FEATURE_TOL = 1e-4  # chip_smoke.py's gate for K5 against its plain version


def tf32(x: torch.Tensor, ties: str = "away") -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits) on the int32 view."""
    bits = x.contiguous().view(torch.int32)
    if ties == "away":  # cvt.rna: add half an ulp to the magnitude, truncate
        bits = bits + 0x1000
    elif ties == "even":
        bits = bits + 0xFFF + ((bits >> 13) & 1)
    # "zero": the tensor core reading an f32 word as TF32
    return (bits & -0x2000).view(torch.float32)


def split(x: torch.Tensor, ties: str = "away"):
    """hi rounded to nearest (ties as given), lo truncated, as the kernel."""
    hi = tf32(x, ties)
    return hi, tf32(x - hi, "zero")


def mm_3xtf32(a: torch.Tensor, w: torch.Tensor, ties: str = "away") -> torch.Tensor:
    """a @ w as the kernel forms it: lo*hi + hi*lo + hi*hi, f32 sums."""
    (ah, al), (wh, wl) = split(a, ties), split(w, ties)
    return al @ wh + ah @ wl + ah @ wh


def emulated_crop(grouped: torch.Tensor, folded, ties: str = "away") -> torch.Tensor:
    """(B, M, D, S, 3) offsets -> (B, M, D, c3): layer 1 plain, layers 2-3
    in 3xTF32, the max over the S samples."""
    (w1, b1), (w2, b2), (w3, b3) = folded
    a1 = torch.relu(dense(w1, b1, grouped))
    a2 = torch.relu(mm_3xtf32(a1, w2, ties) + b2)
    return torch.amax(torch.relu(mm_3xtf32(a2, w3, ties) + b3), dim=3)


def reference_crop(grouped: torch.Tensor, folded, rounding=None) -> torch.Tensor:
    """The same MLP with plain products, each operand of layers 2-3 passed
    through `rounding` first (None: none, as in float64)."""
    r = rounding or (lambda x: x)
    (w1, b1), (w2, b2), (w3, b3) = folded
    a1 = torch.relu(dense(w1, b1, grouped))
    a2 = torch.relu(r(a1) @ r(w2) + b2)
    return torch.amax(torch.relu(r(a2) @ r(w3) + b3), dim=3)


def scene(cfg, seed, b=2, n=20000, m=48):
    """A random cloud, seeds on it plus 3 far seeds per scene (every depth
    pads with point 0), approach-view rotations."""
    rng = np.random.default_rng(seed)
    xyz = torch.from_numpy(rng.uniform(-0.3, 0.3, (b, n, 3)).astype(np.float32))
    seeds = xyz[:, :m].clone()
    seeds[:, -3:] = 10.0
    views = geometry.generate_grasp_views(cfg.num_view)
    pick = torch.from_numpy(rng.integers(0, cfg.num_view, (b, m)))
    rot = geometry.batch_viewpoint_params_to_matrix(-views[pick], torch.zeros(b, m))
    return xyz, seeds, rot


def err_over_scale(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.double() - want.double()).abs().max().item() / max(1.0, want.abs().max().item())


@pytest.mark.parametrize("config", ["tiny", "production"])
@pytest.mark.parametrize("ties", ["away", "even"])
def test_3xtf32_crop_meets_the_feature_gate(config, ties):
    cfg = GraspNetConfig.tiny() if config == "tiny" else GraspNetConfig()
    folded = [(w.detach(), b.detach()) for w, b in fold_bn_eval(init_weights(GraspNet(cfg), 1).crop.mlp)]
    xyz, seeds, rot = scene(cfg, 0 if config == "tiny" else 1, n=cfg.num_point if config == "tiny" else 20000)
    geom = (cfg.cylinder_radius, cfg.hmin, tuple(cfg.hmax_list), cfg.crop_nsample)
    with torch.no_grad():
        grouped = crop_group_plain(xyz, seeds, rot, *geom)
        plain = crop_fused_plain(xyz, seeds, rot, folded, *geom)
        got = emulated_crop(grouped, folded, ties)
        f64 = [(w.double(), b.double()) for w, b in folded]
        want64 = reference_crop(grouped.double(), f64)
        plain_tf32 = reference_crop(grouped, folded, tf32)
    assert got.shape == plain.shape
    assert (plain[:, -3:] > 0).any()  # the far seeds' point-0 rows reach the output
    assert err_over_scale(got, plain) <= FEATURE_TOL
    assert err_over_scale(got, want64) <= 1e-6
    assert err_over_scale(plain_tf32, want64) > 100 * err_over_scale(got, want64)  # plain TF32 is not


def ball_rows(xyz: torch.Tensor, centers: torch.Tensor, radius: float, ns: int) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B, M, 1, ns, 3): SA1's rows as the kernel's
    prologue builds them from the padded ball-query indices."""
    pts = group_points(xyz, ball_query_plain(xyz, centers, radius, ns))
    return ((pts - centers[:, :, None]) * torch.tensor(1.0 / radius, dtype=torch.float32))[:, :, None]


@pytest.mark.parametrize("config", ["tiny", "production"])
def test_3xtf32_sa1_meets_the_feature_gate(config):
    cfg = GraspNetConfig.tiny() if config == "tiny" else GraspNetConfig()
    sa = cfg.sa1
    folded = [(w.detach(), b.detach()) for w, b in fold_bn_eval(init_weights(GraspNet(cfg), 1).backbone.sa1.mlp)]
    rng = np.random.default_rng(2)
    n = cfg.num_point if config == "tiny" else 20000
    xyz = torch.from_numpy(rng.uniform(-0.3, 0.3, (2, n, 3)).astype(np.float32))
    centers = xyz[:, :64].clone()
    centers[:, -3:] = 10.0  # no hits: every row is point 0's offset
    with torch.no_grad():
        rows = ball_rows(xyz, centers, sa.radius, sa.nsample)
        plain = crop_fused_plain(xyz, centers, None, folded, sa.radius, 0.0, (0.0,), sa.nsample,
                                 1.0 / sa.radius, True)
        got = emulated_crop(rows, folded)
        want64 = reference_crop(rows.double(), [(w.double(), b.double()) for w, b in folded])
    assert got.shape == plain.shape == (2, 64, 1, sa.mlp[-1])
    assert (plain[:, -3:] > 0).any()
    assert err_over_scale(got, plain) <= FEATURE_TOL
    assert err_over_scale(got, want64) <= 1e-6


def test_3xtf32_sa1_meets_the_jax_sa_stage():
    """At GraspNetConfig.tiny() on one cloud, with BN statistics that make
    the folding non-trivial: the emulation against the JAX package's eval
    SA1 stage (its XLA path, which divides by r), at
    tests/test_torch_port_crop.py's 1e-5."""
    cfg = GraspNetConfig.tiny()
    sa = cfg.sa1
    jlayers, mlp = perturbed_mlp(sa.mlp, 1)
    xyz = np.random.default_rng(1).uniform(-0.3, 0.3, (2, cfg.num_point, 3)).astype(np.float32)
    inds = np.asarray(jops.furthest_point_sample(xyz, sa.npoint, use_pallas=False))
    _, want, *_ = _sa_stage({"mlp": jlayers}, JConfig.tiny().sa1, jnp.asarray(xyz), None,
                            train=False, eps=cfg.bn_eps, inds=jnp.asarray(inds))
    with torch.no_grad():
        cloud = torch.from_numpy(xyz)
        centers = gather_points(cloud, torch.from_numpy(np.array(inds)))
        got = emulated_crop(ball_rows(cloud, centers, sa.radius, sa.nsample), fold_bn_eval(mlp))[:, :, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("ties", ["away", "even"])
def test_split_is_f32_accurate(ties):
    """hi + lo meets x within 2^-21 relative over 40 binades, both signs."""
    rng = np.random.default_rng(3)
    mant = rng.uniform(1.0, 2.0, 200_000)
    x = torch.from_numpy((mant * 2.0 ** rng.integers(-20, 20, mant.shape) * rng.choice([-1, 1], mant.shape))
                         .astype(np.float32))
    hi, lo = split(x, ties)
    assert torch.equal(tf32(hi, ties), hi) and torch.equal(tf32(lo, ties), lo)  # both TF32
    rel = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert rel.max().item() <= 2.0 ** -21
    assert ((hi.double() - x.double()).abs() / x.double().abs()).max().item() <= 2.0 ** -11
