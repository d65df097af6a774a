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

The SA2-4 stage (K9, sa_feat_tc_kernel) runs all three layers on the tensor
cores: layer 1's K = C feature product in 3xTF32, its xyz part (K = 3) and
the bias added after it in f32 (_sa_feat_kernel's order), then layers 2-3,
over row tiles made of whole centres (a centre takes 16, 32 or 64 rows: ns
17 pads to 32), padded rows zero and left out of each centre's max, the
last tile ragged.  A tile has 128 rows where the kernel's shared-memory
layout holds them with two weight-ring stages, else 64 (`sa_tile_rows`,
sa_layout's arithmetic).  Rows come from the padded ball-query indices
(K4's output): offsets (xyz[idx] - centre) x float32(1/r) beside
features[idx]; far centres take point 0.  It is held against
`sa_feat_fused_plain` at 1e-4 x max(1, scale), a float64 evaluation of the
same rows at 1e-6 and, at GraspNetConfig.tiny(), the JAX package's
interpret-mode `sa_feat_fused_pallas` at 1e-5 (tests/test_torch_port_sa_feat.py's
bound for the plain version).  Readings (scale 86-94: the far centres'
offsets reach ~100 after x 1/r): against plain 2.5e-07 (tiny) and 4.4e-07
(production SA2), against float64 2.0e-07 and 3.2e-07, where plain f32 is
2.1e-07 and 4.0e-07 off; plain TF32 6.3e-04 and 4.0e-04.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspnet_tpu import ops as jops
from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.models.backbone import _sa_stage
from graspnet_tpu.ops.pallas.crop import sa_feat_fused_pallas

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.models import GraspNet, geometry, init_weights
from graspnet_tpu_torch.nn.layers import dense, fold_bn_eval
from graspnet_tpu_torch.ops import gather_points
from graspnet_tpu_torch.ops.cuda.crop import crop_fused_plain, crop_group_plain, sa_feat_fused_plain
from graspnet_tpu_torch.ops.cuda.query import ball_query_plain
from graspnet_tpu_torch.ops.query import group_points

from tests.test_torch_port_ops import perturbed_mlp

FEATURE_TOL = 1e-4  # chip_smoke.py's gate for K5 against its plain version
PALLAS_TOL = 1e-5  # x max(1, scale): tests/test_torch_port_sa_feat.py's bound against interpret-mode Pallas


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


def bank_ld(k, mod):
    """Smallest ld >= k with ld = mod (mod 32) floats (bank_ld, bank8_ld)."""
    return k + ((mod - k) % 32 + 32) % 32


def sa_tile_rows(c_in, c1, c2, c3, smem_bytes=232448 - 1024, slice_k=32):
    """The rows of sa_feat_tc_kernel's row tile (sa_tile_m): 128 where the
    layout (the rows' features then a1, a2, points and centres, then at
    least 2 weight-ring stages of slice_k rows) fits the block's shared
    memory and c1, c2 fit its 8 warps' items, else 64."""
    for rows in (128, 64):
        col_parts = 8 // (rows // 64)
        cols3 = min(c3, 32 * col_parts)
        if max(c1, c2) > 32 * col_parts:  # 4 column tiles an item at most
            continue
        fixed = rows * (bank_ld(max(c_in, c1), 4) + bank_ld(c2, 4) + 6)
        stage = slice_k * bank_ld(max(c1, c2, cols3), 8)
        if (smem_bytes // 4 - fixed) // stage >= 2:
            return rows
    return 0


def sa_feat_plan(xyz, centers, features, folded, radius, ns, ties="away", tile_rows=None):
    """(B, N, 3), (B, M, 3), (B, N, C) -> (B, M, c3) as sa_feat_tc_kernel
    forms it: whole centres a row tile (rows per centre 16, 32 or 64, padded
    slots zero), layer 1's feature product in 3xTF32 then + the xyz part +
    b1, layers 2-3 in 3xTF32, the max over each centre's first ns rows."""
    (w1, b1), (w2, b2), (w3, b3) = folded
    tile_rows = tile_rows or sa_tile_rows(w1.shape[0] - 3, w1.shape[1], w2.shape[1], w3.shape[1])
    b, m = centers.shape[:2]
    idx = ball_query_plain(xyz, centers, radius, ns)  # K4's padded indices
    rpc = 16 * (1 if ns <= 16 else 2 if ns <= 32 else 4)
    per_tile, groups = tile_rows // rpc, b * m
    tiles = -(-groups // per_tile)

    def rows(x):  # (B, M, ns, k) -> (tiles, tile_rows, k), padding zero
        out = x.new_zeros((tiles * per_tile, rpc, x.shape[-1]))
        out[:groups, :ns] = x.reshape(groups, ns, -1)
        return out.reshape(tiles, tile_rows, -1)

    pts = rows(group_points(xyz, idx))
    cen = rows(centers[:, :, None].expand(-1, -1, ns, -1))
    feats = rows(group_points(features, idx))
    off = (pts - cen) * torch.tensor(1.0 / radius, dtype=torch.float32)
    part = off[..., 0:1] * w1[0] + off[..., 1:2] * w1[1] + off[..., 2:3] * w1[2]
    a1 = torch.relu(part + mm_3xtf32(feats, w1[3:], ties) + b1)
    a2 = torch.relu(mm_3xtf32(a1, w2, ties) + b2)
    h3 = torch.relu(mm_3xtf32(a2, w3, ties) + b3).reshape(tiles * per_tile, rpc, -1)
    keep = torch.arange(rpc) < ns
    pooled = torch.where(keep[None, :, None], h3, torch.zeros(())).amax(dim=1)
    return pooled[:groups].reshape(b, m, -1)


def sa_feat_reference(xyz, centers, features, folded, radius, ns, rounding=None):
    """The same rows through the MLP with plain products, each operand
    passed through `rounding` first; in float64 when the weights are."""
    r = rounding or (lambda x: x)
    idx = ball_query_plain(xyz, centers, radius, ns)
    off = (group_points(xyz, idx) - centers[:, :, None]) * torch.tensor(1.0 / radius, dtype=torch.float32)
    h = torch.cat([off, group_points(features, idx)], dim=-1).to(folded[0][0].dtype)
    for w, b in folded:
        h = torch.relu(r(h) @ r(w) + b)
    return h.amax(dim=2)


def sa_scene(n, c_in, seed, b=3, m=13):
    """B scenes of n points in a 0.6 m cube, C-channel features, M centres
    near the first points of each scene, the last 2 of each 10 m away (no
    hits: every slot is point 0).  B M = 39 centres leave the last row tile
    ragged at 16 and 32 rows a centre."""
    rng = np.random.default_rng(seed)
    xyz = torch.from_numpy(rng.uniform(-0.3, 0.3, (b, n, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.normal(0, 1, (b, n, c_in)).astype(np.float32))
    centers = (xyz[:, :m] + torch.from_numpy(rng.normal(0, 0.01, (b, m, 3)).astype(np.float32))).contiguous()
    centers[:, -2:] = 10.0
    return xyz, centers, feats


@pytest.mark.parametrize("config", ["tiny", "production"])
@pytest.mark.parametrize("ns", ["stage", 17])
def test_3xtf32_sa_feat_meets_the_feature_gate(config, ns):
    cfg = GraspNetConfig.tiny() if config == "tiny" else GraspNetConfig()
    sa = cfg.sa2
    ns = sa.nsample if ns == "stage" else ns
    folded = [(w.detach(), b.detach()) for w, b in fold_bn_eval(init_weights(GraspNet(cfg), 1).backbone.sa2.mlp)]
    xyz, centers, feats = sa_scene(cfg.sa1.npoint, cfg.sa1.mlp[-1], ns)
    with torch.no_grad():
        got = sa_feat_plan(xyz, centers, feats, folded, sa.radius, ns)
        plain = sa_feat_fused_plain(xyz, centers, feats, folded, sa.radius, ns)
        want64 = sa_feat_reference(xyz, centers, feats, [(w.double(), b.double()) for w, b in folded], sa.radius, ns)
        plain_tf32 = sa_feat_reference(xyz, centers, feats, folded, sa.radius, ns, tf32)
    assert got.shape == plain.shape == (3, 13, sa.mlp[-1])
    assert (plain[:, -2:] > 0).any()  # the far centres' point-0 rows reach the output
    assert err_over_scale(got, plain) <= FEATURE_TOL
    assert err_over_scale(got, want64) <= 1e-6
    assert err_over_scale(plain_tf32, want64) > 100 * err_over_scale(got, want64)  # plain TF32 is not


def test_sa_feat_tile_rows_at_the_shipped_widths():
    """128-row tiles at SA2's widths, tiny and production, and at the tiny
    SA3-4; 64 at the production SA3-4, whose 256-float feature rows leave
    no room for two ring stages beside 128 rows; none past the domain."""
    for cfg in (GraspNetConfig.tiny(), GraspNetConfig()):
        for sa in (cfg.sa2, cfg.sa3, cfg.sa4):
            want = 64 if sa.mlp[0] - 3 == 256 else 128
            assert sa_tile_rows(sa.mlp[0] - 3, *sa.mlp[1:]) == want
    assert sa_tile_rows(128, 256, 128, 256) == 64  # c1 of 256 needs 8 column parts
    assert sa_tile_rows(2048, 16, 16, 32) == 0


@pytest.mark.parametrize("tile_rows", [64, 128])
def test_sa_feat_plan_is_the_same_at_either_tile_size(tile_rows):
    """Row tiles of 64 or 128 rows group the same rows: each centre's rows
    are computed alike and pooled alone."""
    cfg = GraspNetConfig.tiny()
    sa = cfg.sa3
    folded = [(w.detach(), b.detach()) for w, b in fold_bn_eval(init_weights(GraspNet(cfg), 2).backbone.sa3.mlp)]
    xyz, centers, feats = sa_scene(cfg.sa2.npoint, cfg.sa2.mlp[-1], 5)
    with torch.no_grad():
        got = sa_feat_plan(xyz, centers, feats, folded, sa.radius, sa.nsample, tile_rows=tile_rows)
        base = sa_feat_plan(xyz, centers, feats, folded, sa.radius, sa.nsample, tile_rows=16)
    torch.testing.assert_close(got, base, rtol=0, atol=0)


@pytest.mark.parametrize("far", [0, 4])
def test_3xtf32_sa_feat_meets_the_jax_pallas_kernel(far):
    """At GraspNetConfig.tiny() SA2, with BN statistics that make the
    folding non-trivial: the emulation against the JAX package's
    interpret-mode `sa_feat_fused_pallas` on 16 centres, `far` of them 10 m
    away."""
    cfg = GraspNetConfig.tiny()
    sa = cfg.sa2
    jlayers, mlp = perturbed_mlp(sa.mlp, 4)
    rng = np.random.default_rng(6)
    xyz = rng.uniform(-0.3, 0.3, (2, cfg.sa1.npoint, 3)).astype(np.float32)
    feats = rng.normal(0, 1, (2, cfg.sa1.npoint, cfg.sa1.mlp[-1])).astype(np.float32)
    centers = xyz[:, :16].copy()
    centers[:, 16 - far:] = 10.0
    want = np.asarray(sa_feat_fused_pallas(jnp.asarray(xyz), jnp.asarray(centers), jnp.asarray(feats), jlayers,
                                           sa.radius, sa.nsample, cfg.bn_eps))
    with torch.no_grad():
        got = sa_feat_plan(torch.from_numpy(xyz), torch.from_numpy(centers), torch.from_numpy(feats),
                           fold_bn_eval(mlp), sa.radius, sa.nsample).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= PALLAS_TOL * max(1.0, np.abs(want).max())
