"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here needs the card and skips without one.  The file imports
neither JAX nor the JAX package, so it runs where only torch is installed
(tests/conftest.py imports JAX, hence `--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -m cuda

Indices must be exactly equal (the kernels round every product, as the plain
torch ops do).  Features are held at 1e-4 x max(1, scale): the kernels sum
the MLP in another order than the plain matmuls, in f32.
"""

import numpy as np
import pytest
import torch

from graspnet_tpu_torch import native
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.models import geometry
from graspnet_tpu_torch.ops import cuda as kernels
from graspnet_tpu_torch.ops.cuda import crop as kcrop
from graspnet_tpu_torch.ops.cuda import fps as kfps
from graspnet_tpu_torch.ops.cuda import mlp_train as kmlp
from graspnet_tpu_torch.ops.cuda import query as kquery
from graspnet_tpu_torch.ops.voxel import voxel_downsample, voxel_downsample_plain
from graspnet_tpu_torch.postproc import GraspGroup, ModelFreeCollisionDetector, collision, detect_batch
from graspnet_tpu_torch.utils import tracing
from graspnet_tpu_torch.utils.synthetic import tabletop_cloud

from tests.test_torch_port_voxel import CASES as VOXEL_CASES
from tests.test_torch_port_voxel import grasp_rows, sorted_rows

pytestmark = pytest.mark.cuda
FEATURE_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs the same checks on the card)")
    return torch.device("cuda")


def cloud(rng, b, n, near_origin=10):
    pts = rng.uniform(-0.4, 0.4, (b, n, 3)).astype(np.float32)
    pts[:, rng.choice(n, near_origin, replace=False)] *= 1e-3  # never picked by FPS
    pts[:, 5] = pts[:, 3]  # a duplicate: ties go to the lower index
    return torch.from_numpy(pts)


def folded_weights(dims, seed, device):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn(a, b, generator=gen) * (2.0 / a) ** 0.5
        out.append((w.to(device), (torch.randn(b, generator=gen) * 0.1).to(device)))
    return out


def assert_features_close(got, want):
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= FEATURE_TOL * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("n,npoints", [(20000, (2048, 1024, 512, 256)), (1000, (300, 77, 5)), (700, (1,))])
def test_fps_chain_matches_plain(dev, n, npoints):
    xyz = cloud(np.random.default_rng(n), 2, n).to(dev)
    for g, w in zip(kfps.fps_chain(xyz, npoints), kfps.fps_chain_plain(xyz, npoints)):
        assert torch.equal(g, w)


def tie_lattice(rng, b, n):
    """Coordinates in multiples of 1/8 (exact squares: distances tie), with
    near-origin points that are never picked."""
    pts = (rng.integers(-6, 7, (b, n, 3)) / 8.0).astype(np.float32)
    near = rng.choice(n, max(1, n // 50), replace=False)
    pts[:, near] = rng.uniform(-0.01, 0.01, (b, len(near), 3))
    return torch.from_numpy(pts)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("kind", ["uniform", "lattice"])
def test_fps_chain_full_size_matches_plain(dev, b, kind):
    """N = MAX_SLICE (24,576) with the production cascade, every cluster
    size of stage 0 (the default, 1 and 2 on the 1024-thread variant, 4, 16)."""
    rng = np.random.default_rng(b)
    n = kfps.MAX_SLICE
    xyz = (cloud(rng, b, n) if kind == "uniform" else tie_lattice(rng, b, n)).to(dev)
    npoints = (2048, 1024, 512, 256)
    want = kfps.fps_chain_plain(xyz, npoints)
    for cluster in (0, 1, 2, 4, 16):
        for g, w in zip(kfps.fps_chain(xyz, npoints, cluster), want):
            assert torch.equal(g, w), cluster


@pytest.mark.parametrize("n,npoints", [(20001, (2048, 1024)), (1001, (1001,)), (3000, (3000, 2500)),
                                       (4099, (700,)), (9, (9, 9, 3)), (1, (1,))])
@pytest.mark.parametrize("cluster", [0, 2, 8, 16])
def test_fps_chain_edge_shapes_match_plain(dev, n, npoints, cluster):
    """N not divisible by the cluster size, npoint = N, forwarded stages
    above 2048 points (the 1024-thread variant), one-stage calls, tiny N;
    on a tie lattice with near-origin points."""
    rng = np.random.default_rng(n + cluster)
    xyz = tie_lattice(rng, 2, n).to(dev)
    for g, w in zip(kfps.fps_chain(xyz, npoints, cluster), kfps.fps_chain_plain(xyz, npoints)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cluster", [0, 8, 16, 2])
@pytest.mark.parametrize("kind", ["uniform", "lattice"])
def test_fps_chain_at_40000_points_matches_plain(dev, cluster, kind):
    """VoteNet's ScanNet input, past the N of a single slice: 40,000 points
    on the default cluster and on 8 CTAs (5,000 points a CTA, the 24-a-thread
    register variant), on 16 (2,500) and on 2 (20,000, the 1024-thread
    variant), with VoteNet's cascade."""
    rng = np.random.default_rng(40000 + cluster)
    n = 40000
    xyz = (cloud(rng, 2, n) if kind == "uniform" else tie_lattice(rng, 2, n)).to(dev)
    npoints = (2048, 1024, 512, 256)
    for g, w in zip(kfps.fps_chain(xyz, npoints, cluster), kfps.fps_chain_plain(xyz, npoints)):
        assert torch.equal(g, w), cluster


def test_fps_chain_slice_domain_raises(dev):
    """A cluster whose CTAs would hold more than MAX_SLICE points raises."""
    xyz = torch.ones((1, 40000, 3), device=dev)
    with pytest.raises(ValueError, match="points a CTA"):
        kfps.fps_chain(xyz, (16,), cluster=1)


@pytest.mark.parametrize("radius,ns", [(0.1, 32), (0.2, 16), (0.03, 64), (5.0, 8)])
def test_ball_query_matches_plain(dev, radius, ns):
    rng = np.random.default_rng(int(radius * 100) + ns)
    xyz = cloud(rng, 2, 2048).to(dev)
    centers = torch.cat([xyz[:, :500], torch.full((2, 12, 3), 9.0, device=dev)], dim=1)  # 12 with no hits
    assert torch.equal(kquery.ball_query(xyz, centers, radius, ns),
                       kquery.ball_query_plain(xyz, centers, radius, ns))


def scan_inputs(dev, b, n, m, offset, seed):
    """A tabletop cloud (B, N, 3) whose data starts `offset` floats past a
    16-byte boundary (so every scene's start is ragged for the bulk copies
    when offset > 0 or 12 N is not a multiple of 16), and M centres: points
    of the cloud jittered by 2 mm, the last 3 of each scene far away."""
    from graspnet_tpu_torch.utils.synthetic import tabletop_cloud

    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(np.stack([tabletop_cloud(rng, n) for _ in range(b)]))
    flat = torch.zeros(b * n * 3 + 4, device=dev)
    xyz = flat[offset: offset + b * n * 3].view(b, n, 3)
    xyz.copy_(pts.to(dev))
    pick = torch.from_numpy(rng.integers(0, n, (b, m)))
    centers = torch.gather(pts, 1, pick[..., None].expand(-1, -1, 3)) + torch.from_numpy(
        rng.normal(0, 0.002, (b, m, 3)).astype(np.float32))
    centers[:, -3:] = 9.0
    return xyz, centers.to(dev)


@pytest.mark.parametrize("b,n,m,offset", [(2, 20000, 2048, 0), (2, 20000, 2048, 1), (2, 2050, 1001, 2),
                                          (3, 4099, 37, 3), (2, 1025, 16, 0), (1, 5, 19, 1)])
def test_ball_scan_matches_plain_and_oracle(dev, b, n, m, offset):
    """K4 (the TMA-fed ball scan) at the SA1 training shape (B=2, 2048
    centres x 20000 points, r 0.04, ns 64) and at ragged N, M and scene
    starts (offset floats past a 16-byte boundary, 12 N not a multiple of
    16, N < one stage, M not a multiple of the 16 centres a block takes),
    with far centres that have no hits: equal to the plain version and to
    the per-query oracle (K10, rotate=False) index for index, at SA1's
    radius and at SA2's."""
    xyz, centers = scan_inputs(dev, b, n, m, offset, n + m + offset)
    assert (xyz.data_ptr() // 4) % 4 == offset
    for radius, ns in ((0.04, 64), (0.1, 32)):
        before = kquery.ball_query.launches
        got = kquery.ball_query(xyz, centers, radius, ns)
        assert kquery.ball_query.launches == before + 1
        assert torch.equal(got, kquery.ball_query_plain(xyz, centers, radius, ns))
        oracle = kquery.multi_query(xyz, centers, None, radius, 0.0, (0.0,), ns, rotate=False)[:, :, 0]
        assert torch.equal(got, oracle)
        assert (got[:, -3:] == 0).all()


def test_crop_fused_matches_plain(dev):
    cfg = GraspNetConfig()
    rng = np.random.default_rng(1)
    xyz = cloud(rng, 2, 20000).to(dev)
    seeds = xyz[:, :256].clone()
    seeds[:, -4:] = 10.0  # far seeds: every depth pads with point 0
    views = geometry.generate_grasp_views(cfg.num_view, dev)
    pick = torch.from_numpy(rng.integers(0, cfg.num_view, (2, 256))).to(dev)
    rot = geometry.batch_viewpoint_params_to_matrix(-views[pick], torch.zeros(2, 256, device=dev))
    folded = folded_weights(cfg.crop_mlp, 0, dev)
    args = (xyz, seeds, rot, folded, cfg.cylinder_radius, cfg.hmin, cfg.hmax_list, cfg.crop_nsample)
    assert_features_close(kcrop.crop_fused(*args), kcrop.crop_fused_plain(*args))


@pytest.mark.parametrize("widths", ["tiny", "production"])
@pytest.mark.parametrize("ns", [1, 17, 64])
@pytest.mark.parametrize("ndepth", [1, 4, 8])
def test_crop_fused_tensor_cores_match_plain(dev, widths, ns, ndepth):
    """K5's 3xTF32 tensor-core MLP at ns in {1, 17, 64} (one m16 tile, a
    padded last tile, four tiles) and 1, 4 or 8 depths, tiny (3, 8, 16, 32)
    and production (3, 64, 128, 256) widths, with 3 far seeds whose every
    slot is point 0: features within 1e-4 x max(1, scale)."""
    cfg = GraspNetConfig()
    mlp = GraspNetConfig.tiny().crop_mlp if widths == "tiny" else cfg.crop_mlp
    rng = np.random.default_rng(ns * 10 + ndepth)
    xyz = cloud(rng, 2, 20000).to(dev)
    seeds = xyz[:, :133].clone()
    seeds[:, -3:] = 10.0
    rot = approach_rotations(cfg, rng, 2, 133, dev)
    hmax = tuple(np.linspace(0.01, 0.04, ndepth).tolist())
    folded = folded_weights(mlp, ns, dev)
    args = (xyz, seeds, rot, folded, 0.1, cfg.hmin, hmax, ns)
    got = kcrop.crop_fused(*args)
    assert got.shape == (2, 133, ndepth, mlp[-1])
    assert_features_close(got, kcrop.crop_fused_plain(*args))


def test_crop_fused_rejects_widths_outside_its_domain(dev):
    """The tensor-core crop takes widths that are multiples of 8 and raises
    ValueError before any launch otherwise."""
    xyz = torch.zeros(1, 100, 3, device=dev)
    rot = torch.eye(3, device=dev).expand(1, 4, 3, 3).contiguous()
    before = kcrop.crop_fused.launches
    for dims in ((3, 8, 12, 16), (3, 12, 16, 32), (3, 8, 16, 36)):
        with pytest.raises(ValueError):
            kcrop.crop_fused(xyz, xyz[:, :4], rot, folded_weights(dims, 0, dev), 0.05, -0.02, (0.01,), 8)
    with pytest.raises(ValueError):  # W3 of 128 x 1024 does not fit a block's shared memory
        kcrop.crop_fused(xyz, xyz[:, :4], rot, folded_weights((3, 64, 128, 1024), 0, dev), 0.05, -0.02, (0.01,), 8)
    assert kcrop.crop_fused.launches == before


def test_sa1_fused_matches_plain(dev):
    sa = GraspNetConfig().sa1
    xyz = cloud(np.random.default_rng(2), 2, 20000).to(dev)
    centers = xyz[:, :512]
    folded = folded_weights(sa.mlp, 1, dev)
    got = kcrop.sa1_fused(xyz, centers, folded, sa.radius, sa.nsample)
    want = kcrop.crop_fused_plain(xyz, centers, None, folded, sa.radius, 0.0, (0.0,),
                                  sa.nsample, 1.0 / sa.radius, True)[:, :, 0]
    assert_features_close(got, want)


@pytest.mark.parametrize("widths", ["tiny", "production"])
@pytest.mark.parametrize("ns", [1, 17, 64])
def test_sa1_fused_tensor_cores_match_plain(dev, widths, ns):
    """K3 (K4's scan, then the 3xTF32 tensor-core MLP over rows gathered
    from its indices) at ns in {1, 17, 64}, tiny (3, 8, 8, 16) and
    production (3, 64, 64, 128) widths, on a tabletop cloud of 20001
    points (the second scene's start is not 16-byte aligned) with 3 far
    centres per scene whose every row is point 0: features within 1e-4 x
    max(1, scale); one sa1_fused launch and no ball_query launch counted."""
    cfg = GraspNetConfig()
    dims = GraspNetConfig.tiny().sa1.mlp if widths == "tiny" else cfg.sa1.mlp
    xyz, centers = scan_inputs(dev, 2, 20001, 301, 0, ns)
    folded = folded_weights(dims, ns, dev)
    before = (kcrop.sa1_fused.launches, kquery.ball_query.launches)
    got = kcrop.sa1_fused(xyz, centers, folded, cfg.sa1.radius, ns)
    assert (kcrop.sa1_fused.launches, kquery.ball_query.launches) == (before[0] + 1, before[1])
    assert got.shape == (2, 301, dims[-1])
    want = kcrop.crop_fused_plain(xyz, centers, None, folded, cfg.sa1.radius, 0.0, (0.0,), ns,
                                  1.0 / cfg.sa1.radius, True)[:, :, 0]
    assert_features_close(got, want)


def test_sa1_fused_rejects_inputs_outside_its_domain(dev):
    """K3 takes the tensor-core MLP's domain (widths multiples of 8 whose
    W2 and W3 fit one block's shared memory, ns <= 64) and raises
    ValueError before any launch otherwise."""
    xyz = torch.zeros(1, 100, 3, device=dev)
    before = (kcrop.sa1_fused.launches, kquery.ball_query.launches)
    for dims in ((3, 8, 12, 16), (3, 12, 16, 32), (3, 8, 16, 36), (3, 64, 128, 1024)):
        with pytest.raises(ValueError):
            kcrop.sa1_fused(xyz, xyz[:, :4], folded_weights(dims, 0, dev), 0.05, 8)
    with pytest.raises(ValueError):
        kcrop.sa1_fused(xyz, xyz[:, :4], folded_weights((3, 8, 8, 16), 0, dev), 0.05, 65)
    assert (kcrop.sa1_fused.launches, kquery.ball_query.launches) == before


def test_tiny_pipeline_card_matches_cpu_and_counts_launches(dev):
    from graspnet_tpu_torch.apps import GraspPipeline

    cfg = GraspNetConfig.tiny()
    clouds = np.random.default_rng(3).uniform(-0.3, 0.3, (2, cfg.num_point, 3)).astype(np.float32)
    card = GraspPipeline(cfg=cfg, seed=1)
    cpu = GraspPipeline(cfg=cfg, seed=1, device="cpu")
    kernels.reset_launches()
    got = card.get_grasps_topk_batch(clouds)
    launches = kernels.launches()
    assert launches == {**{k: 0 for k in launches}, "fps_chain": 1, "ball_query": 3, "sa1_fused": 1,
                        "crop_fused": 1, "sa_group": 3, "sa_bias_relu": 9}
    for g, w in zip(got, cpu.get_grasps_topk_batch(clouds)):
        g, w = g.grasp_group_array, w.grasp_group_array
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, [2, 3, 13, 14, 15, 16]], w[:, [2, 3, 13, 14, 15, 16]])
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_wrappers_reject_bad_input(dev):
    xyz = torch.zeros(1, 100, 3, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        kfps.fps_chain(xyz, (10,))
    with pytest.raises(ValueError):
        kfps.fps_chain(xyz.float(), (200,))  # more samples than points
    with pytest.raises(ValueError):
        kquery.ball_query(xyz, xyz[:, :4], 0.1, 8)
    folded = folded_weights((3, 8, 12, 16), 0, dev)  # c2=12 is not a multiple of 8
    with pytest.raises(ValueError):
        kcrop.sa1_fused(xyz.float(), xyz[:, :4].float(), folded, 0.1, 8)


def test_crop_group_matches_plain(dev):
    """K6 at the training shape: 1024 label points near the cloud, random
    rotations; equal indices make the offsets bitwise equal (both round
    every product)."""
    cfg = GraspNetConfig()
    rng = np.random.default_rng(4)
    xyz = cloud(rng, 2, 20000).to(dev)
    centers = xyz[:, :1024] + torch.from_numpy(rng.normal(0, 0.01, (2, 1024, 3)).astype(np.float32)).to(dev)
    centers[:, -4:] = 10.0  # no hits: every slot is point 0
    q, _ = torch.linalg.qr(torch.from_numpy(rng.normal(size=(2, 1024, 3, 3)).astype(np.float32)))
    args = (xyz, centers, q.to(dev).contiguous(), cfg.cylinder_radius, cfg.hmin, cfg.hmax_list, cfg.crop_nsample)
    got = kcrop.crop_group(*args)
    want = kcrop.crop_group_plain(*args[:5], tuple(cfg.hmax_list), cfg.crop_nsample)
    assert torch.equal(got, want)


def mlp_with_stats(dims, seed, device):
    from graspnet_tpu_torch.nn.layers import SharedMLP

    gen = torch.Generator().manual_seed(seed)
    mlp = SharedMLP(dims)
    with torch.no_grad():
        for layer in mlp:
            layer.kernel.copy_(torch.randn(layer.kernel.shape, generator=gen) * (2.0 / layer.kernel.shape[0]) ** 0.5)
            layer.bn.scale.copy_(1.0 + 0.3 * torch.randn(layer.bn.scale.shape, generator=gen))
            layer.bn.offset.copy_(0.2 * torch.randn(layer.bn.offset.shape, generator=gen))
        mlp[-1].bn.scale[0] = -0.7  # the min-pool branch
    return mlp.to(device)


def _mlp_grads(fn, mlp, grouped, w):
    params = [p for layer in mlp for p in (layer.kernel, layer.bn.scale, layer.bn.offset)]
    pooled, stats = fn(mlp, grouped)
    return pooled, stats, torch.autograd.grad(torch.sum(pooled * w.to(pooled.dtype)), params)


def _grad_err(got, want):
    return max((a.double() - c.double()).abs().max().item() / max(1.0, c.abs().max().item())
               for a, c in zip(got, want))


@pytest.mark.parametrize("dims,m,rows", [((3, 8, 16, 32), 24, "random"), ((3, 64, 128, 256), 1024, "unambiguous")])
def test_crop_mlp_train_matches_plain(dev, dims, m, rows):
    """K7 forward and backward against the plain train-mode SharedMLP +
    amax: pooled at 2e-5 x max(1, scale), stats at 1e-5, parameter
    gradients at 2e-4 x max(1, scale) (tests/test_mlp_train.py's bounds;
    f32 sums in another order); two backward runs bitwise equal.  At the
    production shape each group holds one distinct row beside 63 equal
    ones, so every pool maximum is unambiguous (random rows: the next
    test)."""
    rng = np.random.default_rng(m)
    g = rng.uniform(-0.05, 0.05, (2, m, 4, 64, 3)).astype(np.float32)
    g[:, :, :, 1] = g[:, :, :, 0]  # first-hit padding duplicates: pool ties
    if rows == "unambiguous":
        g[:, :, :, 1:] = g[:, :, :, 1:2]
        g[:, :, :, 0] = rng.uniform(-0.3, 0.3, g[:, :, :, 0].shape)
    grouped = torch.from_numpy(g).to(dev)
    w = torch.from_numpy(rng.normal(size=(2, m, 4, dims[-1])).astype(np.float32)).to(dev)
    mlp = mlp_with_stats(dims, 0, dev)
    p_k, st_k, g_k = _mlp_grads(kmlp.crop_mlp_train, mlp, grouped, w)
    p_p, st_p, g_p = _mlp_grads(kmlp.crop_mlp_train_plain, mlp, grouped, w)
    assert (p_k - p_p).abs().max().item() <= 2e-5 * max(1.0, p_p.abs().max().item())
    for a, b in zip(st_k, st_p):
        for k in ("mean", "var"):
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-5)
    assert _grad_err(g_k, g_p) <= 2e-4
    _, _, again = _mlp_grads(kmlp.crop_mlp_train, mlp, grouped, w)
    for a, b in zip(g_k, again):
        assert torch.equal(a, b)  # no atomics: the backward is bitwise repeatable


def unambiguous_pool(mlp64, grouped, margin=1e-4):
    """(..., S, 3) -> (..., C3) bool: in float64 the pre-relu pool maximum
    beats every row of another value, and clears the relu kink, by margin x
    max(1, max |y|) (chip_smoke.py's POOL_MARGIN); equal rows are exact ties
    that every version splits evenly."""
    from graspnet_tpu_torch.nn.layers import dense

    with torch.no_grad():
        *hidden, last = mlp64
        h = grouped.double()
        for layer in hidden:
            h, _ = layer.forward_train(h)
        y, _ = last.bn.forward_train(dense(last.kernel, None, h))
        top = y.amax(dim=-2, keepdim=True)
        below = torch.where(y < top, y, -torch.inf).amax(dim=-2)
        tau = margin * max(1.0, y.abs().max().item())
        return (top[..., 0, :] - below >= tau) & (top[..., 0, :].abs() >= tau)


@pytest.mark.parametrize("dims", [(3, 8, 16, 32), (3, 64, 128, 256)])
@pytest.mark.parametrize("s,rows", [(1, "random"), (17, "padded"), (64, "duplicate")])
def test_crop_mlp_train_backward_small_groups_and_duplicates(dev, dims, s, rows):
    """K7 backward on s in {1, 17, 64} and on groups of 64 identical rows
    (every maximum a 64-way tie), against float64 with the cotangent zeroed
    where a pool maximum is ambiguous (chip_smoke.py's 2e-3 x max(1, scale)
    bound for that check); bitwise repeatable."""
    rng = np.random.default_rng(s + dims[1])
    g = rng.uniform(-0.3, 0.3, (2, 96, 4, s, 3)).astype(np.float32)
    if rows == "padded":
        g[:, :, :, s // 2:] = g[:, :, :, :1]
    elif rows == "duplicate":
        g[:, ::2] = g[:, ::2, :, :1]
    grouped = torch.from_numpy(g).to(dev)
    mlp = mlp_with_stats(dims, 1, dev)
    mlp64 = mlp_with_stats(dims, 1, dev).double()
    w = torch.from_numpy(rng.normal(size=(2, 96, 4, dims[-1])).astype(np.float32)).to(dev)
    w = w * unambiguous_pool(mlp64, grouped)
    _, _, g_k = _mlp_grads(kmlp.crop_mlp_train, mlp, grouped, w)
    _, _, g_64 = _mlp_grads(kmlp.crop_mlp_train_plain, mlp64, grouped.double(), w)
    _, _, again = _mlp_grads(kmlp.crop_mlp_train, mlp, grouped, w)
    assert _grad_err(g_k, g_64) <= 2e-3
    for a, b in zip(g_k, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dims", [(3, 8, 16, 32), (3, 64, 128, 256)])
@pytest.mark.parametrize("s", [1, 17, 64])
def test_crop_mlp_train_forward_bitwise_repeatable(dev, dims, s):
    """The K7 forward (pass 3's per-thread Chan partials combined in a fixed
    order, per-block partials reduced in block order) gives bitwise equal
    pooled outputs and stats on two runs, and meets the plain version (pooled
    at 2e-5 x max(1, scale), stats at 1e-5) at s in {1, 17, 64}."""
    rng = np.random.default_rng(s + dims[1])
    grouped = torch.from_numpy(rng.uniform(-0.3, 0.3, (2, 300, 4, s, 3)).astype(np.float32)).to(dev)
    mlp = mlp_with_stats(dims, 2, dev)
    with torch.no_grad():
        runs = [kmlp.crop_mlp_train(mlp, grouped) for _ in range(2)]
        p_p, st_p = kmlp.crop_mlp_train_plain(mlp, grouped)
    (p_a, st_a), (p_b, st_b) = runs
    assert torch.equal(p_a, p_b)
    for a, b, c in zip(st_a, st_b, st_p):
        for k in ("mean", "var"):
            assert torch.equal(a[k], b[k])
            torch.testing.assert_close(a[k], c[k], rtol=1e-5, atol=1e-5)
    assert (p_a - p_p).abs().max().item() <= 2e-5 * max(1.0, p_p.abs().max().item())


def test_crop_mlp_train_rejects_unsupported_widths(dev):
    from graspnet_tpu_torch.nn.layers import SharedMLP

    grouped = torch.zeros(1, 2, 4, 64, 3, device=dev)
    with pytest.raises(ValueError):
        kmlp.crop_mlp_train(SharedMLP((3, 128, 64, 32)).to(dev), grouped)  # c1 > 64
    with pytest.raises(ValueError):
        kmlp.crop_mlp_train(SharedMLP((3, 8, 16, 32)).to(dev), torch.zeros(1, 2, 4, 65, 3, device=dev))


def test_crop_mlp_train_pool_near_ties_at_production_shape(dev):
    """Random rows at the production shape: among 2 M pool maxima some are
    near-ties that float32 rounding breaks either way, routing a group's
    gradient to another row.  Against a float64 evaluation, x max(1,
    scale): the kernel at 1e-2 and the plain version, whose own float32
    sums over 524,288 rows cancel, at 3e-2 (chip_smoke.py's bounds; up to
    3.5e-3 and 7.7e-3 measured on an H100); the tight bound is the test
    above."""
    rng = np.random.default_rng(7)
    dims = (3, 64, 128, 256)
    grouped = torch.from_numpy(rng.uniform(-0.05, 0.05, (2, 1024, 4, 64, 3)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(2, 1024, 4, 256)).astype(np.float32)).to(dev)
    mlp = mlp_with_stats(dims, 0, dev)
    _, _, g_k = _mlp_grads(kmlp.crop_mlp_train, mlp, grouped, w)
    _, _, g_p = _mlp_grads(kmlp.crop_mlp_train_plain, mlp, grouped, w)
    _, _, g_64 = _mlp_grads(kmlp.crop_mlp_train_plain, mlp_with_stats(dims, 0, dev).double(), grouped.double(), w)
    assert _grad_err(g_p, g_64) <= 3e-2
    assert _grad_err(g_k, g_64) <= 1e-2


def approach_rotations(cfg, rng, b, m, dev):
    views = geometry.generate_grasp_views(cfg.num_view, dev)
    pick = torch.from_numpy(rng.integers(0, cfg.num_view, (b, m))).to(dev)
    return geometry.batch_viewpoint_params_to_matrix(-views[pick], torch.zeros(b, m, device=dev)).contiguous()


def test_cylinder_query_multi_and_oracle_match_plain(dev):
    """K8 and K10 (rotate=True) at the production shape: 1024 seeds x 4
    depths x 20000 points, random approach rotations, 4 far seeds (zero
    rows) and an unsorted hmax list; indices exactly equal."""
    cfg = GraspNetConfig()
    rng = np.random.default_rng(8)
    xyz = cloud(rng, 2, 20000).to(dev)
    seeds = xyz[:, :1024].clone()
    seeds[:, -4:] = 10.0
    rot = approach_rotations(cfg, rng, 2, 1024, dev)
    for hmax in (cfg.hmax_list, (0.04, 0.01, 0.03)):
        args = (xyz, seeds, rot, cfg.cylinder_radius, cfg.hmin, hmax, cfg.crop_nsample)
        want = kquery.cylinder_query_multi_plain(*args)
        got = kquery.cylinder_query_multi(*args)
        assert torch.equal(got, want)
        assert torch.equal(kquery.multi_query(*args), want)
        assert (got[:, -4:] == 0).all()


@pytest.mark.parametrize("b,n,m,offset", [(2, 20000, 1024, 0), (1, 20000, 1024, 1), (2, 2050, 1001, 2),
                                          (3, 4099, 37, 3), (2, 1025, 16, 0), (1, 5, 19, 1)])
def test_cylinder_scan_matches_plain_and_oracle(dev, b, n, m, offset):
    """The cylinder scan (K4's TMA-fed ring, a warp per centre) as K6 and K8
    run it: at the training shape (B=2, 1024 centres x 20000 points), at
    B=1, and at ragged N, M and scene starts (offset floats past a 16-byte
    boundary, 12 N not a multiple of 16, N < one stage, M not a multiple of
    the block), with far centres that have no hits, random rotations, the
    production geometry and an unsorted hmax list at ns 16: K6's offsets
    bitwise equal to `crop_group_plain`, K8's indices equal to the plain
    version's and to the per-query oracle's (K10)."""
    cfg = GraspNetConfig()
    xyz, centers = scan_inputs(dev, b, n, m, offset, n + m + offset)
    assert (xyz.data_ptr() // 4) % 4 == offset
    q, _ = torch.linalg.qr(torch.from_numpy(np.random.default_rng(m).normal(size=(b, m, 3, 3)).astype(np.float32)))
    rot = q.to(dev).contiguous()
    for hmax, ns in ((tuple(cfg.hmax_list), cfg.crop_nsample), ((0.04, 0.01, 0.03), 16)):
        args = (xyz, centers, rot, cfg.cylinder_radius, cfg.hmin, hmax, ns)
        before = (kcrop.crop_group.launches, kquery.cylinder_query_multi.launches)
        grouped = kcrop.crop_group(*args)
        idx = kquery.cylinder_query_multi(*args)
        assert (kcrop.crop_group.launches, kquery.cylinder_query_multi.launches) == (before[0] + 1, before[1] + 1)
        assert torch.equal(grouped, kcrop.crop_group_plain(*args))
        assert torch.equal(idx, kquery.cylinder_query_multi_plain(*args))
        assert torch.equal(idx, kquery.multi_query(*args))
        assert (idx[:, -3:] == 0).all()


def test_crop_fused_b1_matches_plain(dev):
    """K5 at the serving shape of one frame (B=1, 1024 seeds x 4 depths x
    20000 tabletop points, approach rotations, a scene start one float past
    a 16-byte boundary, 3 far seeds): features within 1e-4 x max(1, scale)."""
    cfg = GraspNetConfig()
    xyz, seeds = scan_inputs(dev, 1, 20000, 1024, 1, 11)
    rot = approach_rotations(cfg, np.random.default_rng(11), 1, 1024, dev)
    args = (xyz, seeds, rot, folded_weights(cfg.crop_mlp, 3, dev), cfg.cylinder_radius, cfg.hmin,
            cfg.hmax_list, cfg.crop_nsample)
    assert_features_close(kcrop.crop_fused(*args), kcrop.crop_fused_plain(*args))


def test_cylinder_scan_is_the_kernel_of_k5_k6_k8(dev):
    """crop_group (K6), crop_fused (K5) and cylinder_query_multi (K8) launch
    the cylinder scan, and neither the block-per-centre crop group kernel
    nor the old warp query kernel (both gone) appears in their profile."""
    from torch.profiler import ProfilerActivity, profile

    cfg = GraspNetConfig()
    xyz, seeds = scan_inputs(dev, 1, 4099, 64, 0, 12)
    rot = approach_rotations(cfg, np.random.default_rng(12), 1, 64, dev)
    geom = (cfg.cylinder_radius, cfg.hmin, cfg.hmax_list, cfg.crop_nsample)
    folded = folded_weights(cfg.crop_mlp, 4, dev)
    calls = {"crop_group": lambda: kcrop.crop_group(xyz, seeds, rot, *geom),
             "crop_fused": lambda: kcrop.crop_fused(xyz, seeds, rot, folded, *geom),
             "cylinder_query_multi": lambda: kquery.cylinder_query_multi(xyz, seeds, rot, *geom)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [ev.key for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA]
        assert any("cylinder_scan_kernel" in k for k in names), (name, names)
        assert not any("crop_group_kernel" in k or "warp_query_kernel" in k for k in names), (name, names)


@pytest.mark.parametrize("stage", ["sa2", "sa3", "sa4"])
def test_multi_query_ball_matches_ball_query(dev, stage):
    """K10 (rotate=False) is bit-equal to K4 at the SA2-4 calls, in every
    depth, with 3 far centres (zero rows)."""
    cfg = GraspNetConfig()
    sa = getattr(cfg, stage)
    n = {"sa2": cfg.sa1.npoint, "sa3": cfg.sa2.npoint, "sa4": cfg.sa3.npoint}[stage]
    xyz = cloud(np.random.default_rng(9), 2, n).to(dev)
    centers = xyz[:, : sa.npoint].clone()
    centers[:, -3:] = 9.0
    want = kquery.ball_query(xyz, centers, sa.radius, sa.nsample)
    assert torch.equal(want, kquery.ball_query_plain(xyz, centers, sa.radius, sa.nsample))
    got = kquery.multi_query(xyz, centers, None, sa.radius, 0.0, (0.0, 0.0), sa.nsample, rotate=False)
    assert torch.equal(got, want[:, :, None].expand(-1, -1, 2, -1))


@pytest.mark.parametrize("stage", ["sa2", "sa3", "sa4"])
def test_sa_feat_fused_matches_plain(dev, stage):
    """K9 at the production SA2-4 shapes (B=2), with 3 far centres whose
    samples are point 0's offset and features: features within 1e-4 x
    max(1, scale)."""
    cfg = GraspNetConfig()
    sa = getattr(cfg, stage)
    prev = {"sa2": cfg.sa1, "sa3": cfg.sa2, "sa4": cfg.sa3}[stage]
    rng = np.random.default_rng(10)
    xyz = cloud(rng, 2, prev.npoint).to(dev)
    feats = torch.from_numpy(rng.normal(size=(2, prev.npoint, prev.mlp[-1])).astype(np.float32)).to(dev)
    centers = xyz[:, : sa.npoint].clone()
    centers[:, -3:] = 9.0
    folded = folded_weights(sa.mlp, 2, dev)
    args = (xyz, centers, feats, folded, sa.radius, sa.nsample)
    assert_features_close(kcrop.sa_feat_fused(*args), kcrop.sa_feat_fused_plain(*args))


def test_new_wrappers_reject_bad_input(dev):
    xyz = torch.zeros(1, 100, 3, device=dev)
    rot = torch.eye(3, device=dev).expand(1, 4, 3, 3).contiguous()
    with pytest.raises(ValueError):
        kquery.cylinder_query_multi(xyz, xyz[:, :4], None, 0.05, -0.02, (0.01,), 8)
    with pytest.raises(ValueError):
        kquery.cylinder_query_multi(xyz, xyz[:, :4], rot, 0.05, -0.02, (0.01,) * 9, 8)  # > 8 depths
    with pytest.raises(ValueError):
        kquery.multi_query(xyz.double(), xyz[:, :4], rot, 0.05, -0.02, (0.01,), 8)
    feats = torch.zeros(1, 100, 6, device=dev)  # C = 6 is not a multiple of 4
    with pytest.raises(ValueError):
        kcrop.sa_feat_fused(xyz, xyz[:, :4], feats, folded_weights((9, 8, 8, 16), 0, dev), 0.1, 8)


def sa_feat_inputs(dev, b, n, m, c_in, seed, feat_offset=0):
    """A tabletop cloud of n points per scene, features (B, N, C) starting
    `feat_offset` floats past a 16-byte boundary, and M centres near the
    cloud's points with the last 3 of each scene 10 m away (point 0's
    offset and features in every slot)."""
    xyz, centers = scan_inputs(dev, b, n, m, 0, seed)
    rng = np.random.default_rng(seed)
    flat = torch.zeros(b * n * c_in + 4, device=dev)
    feats = flat[feat_offset: feat_offset + b * n * c_in].view(b, n, c_in)
    feats.copy_(torch.from_numpy(rng.normal(size=(b, n, c_in)).astype(np.float32)).to(dev))
    centers[:, -3:] = 10.0
    return xyz, centers.contiguous(), feats


@pytest.mark.parametrize("dims", [(19, 16, 16, 32), (131, 128, 128, 256), (259, 128, 128, 256)])
@pytest.mark.parametrize("ns", [1, 16, 17, 32, 64])
@pytest.mark.parametrize("b", [1, 2])
def test_sa_feat_fused_tensor_cores_match_plain(dev, dims, ns, b):
    """K9 (K4's scan, then the 3xTF32 tensor-core MLP over 64-row tiles of
    whole centres) at C 16/128/256 (tiny SA2, production SA2 and SA3
    widths), ns 1/16/17/32/64 (one m16 tile a centre, a padded one, two,
    four), B 1 and 2, 301 centres a scene (the last row tile is ragged at
    every ns), 3 far centres per scene, and at B=1 feature rows whose base
    is one float past a 16-byte boundary: features within 1e-4 x max(1,
    scale); one sa_feat_fused launch and no ball_query launch counted."""
    c_in = dims[0] - 3
    xyz, centers, feats = sa_feat_inputs(dev, b, 2048, 301, c_in, ns + c_in, feat_offset=1 if b == 1 else 0)
    assert (feats.data_ptr() // 4) % 4 == (1 if b == 1 else 0)
    folded = folded_weights(dims, ns, dev)
    before = (kcrop.sa_feat_fused.launches, kquery.ball_query.launches)
    got = kcrop.sa_feat_fused(xyz, centers, feats, folded, 0.1, ns)
    assert (kcrop.sa_feat_fused.launches, kquery.ball_query.launches) == (before[0] + 1, before[1])
    assert got.shape == (b, 301, dims[-1])
    assert_features_close(got, kcrop.sa_feat_fused_plain(xyz, centers, feats, folded, 0.1, ns))


def test_sa_feat_fused_rejects_inputs_outside_its_domain(dev):
    """K9 takes C and widths that are multiples of 8, c1 and c2 <= 256 (its
    8 warps' column tiles), ns <= 64 and a row tile that fits one block's
    shared memory, N >= 1; it raises ValueError before any launch otherwise."""
    xyz = torch.zeros(1, 100, 3, device=dev)
    before = (kcrop.sa_feat_fused.launches, kquery.ball_query.launches)
    for c_in, dims in ((12, (15, 16, 16, 32)), (16, (19, 12, 16, 32)), (16, (19, 16, 20, 32)),
                       (16, (19, 16, 16, 36)), (16, (19, 264, 16, 32)), (2048, (2051, 16, 16, 32))):
        with pytest.raises(ValueError):
            kcrop.sa_feat_fused(xyz, xyz[:, :4], torch.zeros(1, 100, c_in, device=dev),
                                folded_weights(dims, 0, dev), 0.1, 8)
    feats = torch.zeros(1, 100, 16, device=dev)
    with pytest.raises(ValueError):
        kcrop.sa_feat_fused(xyz, xyz[:, :4], feats, folded_weights((19, 16, 16, 32), 0, dev), 0.1, 65)
    with pytest.raises(ValueError):
        kcrop.sa_feat_fused(xyz[:, :0], xyz[:, :4], feats[:, :0], folded_weights((19, 16, 16, 32), 0, dev), 0.1, 8)
    assert (kcrop.sa_feat_fused.launches, kquery.ball_query.launches) == before


@pytest.mark.parametrize("b,n,m,offset", [(2, 20000, 1024, 0), (1, 20000, 1024, 1), (2, 2050, 1001, 2),
                                          (3, 4099, 37, 3), (2, 1025, 16, 0), (1, 5, 19, 1)])
@pytest.mark.parametrize("depths", [1, 4, 8])
def test_multi_query_matches_plain_and_the_ring_scans(dev, b, n, m, offset, depths):
    """K10 (a warp per query) in both modes at the training and serving
    shapes and at ragged N, M and scene starts (offset floats past a 16-byte
    boundary), with far centres and an unsorted hmax list of 1, 4 or 8
    depths: equal to its plain version, and to K8 (cylinder) and K4 (ball)."""
    cfg = GraspNetConfig()
    xyz, centers = scan_inputs(dev, b, n, m, offset, n + m + depths)
    assert (xyz.data_ptr() // 4) % 4 == offset
    q, _ = torch.linalg.qr(torch.from_numpy(np.random.default_rng(m + depths).normal(size=(b, m, 3, 3))
                                            .astype(np.float32)))
    rot = q.to(dev).contiguous()
    hmax = tuple(np.random.default_rng(depths).permutation(np.linspace(0.01, 0.04, depths)).tolist())
    ns = cfg.crop_nsample
    args = (xyz, centers, rot, cfg.cylinder_radius, cfg.hmin, hmax, ns)
    got = kquery.multi_query(*args)
    assert torch.equal(got, kquery.multi_query_plain(*args))
    assert torch.equal(got, kquery.cylinder_query_multi(*args))
    assert (got[:, -3:] == 0).all()
    ball = kquery.multi_query(xyz, centers, None, 0.04, 0.0, hmax, ns, rotate=False)
    assert torch.equal(ball, kquery.multi_query_plain(xyz, centers, None, 0.04, 0.0, hmax, ns, rotate=False))
    assert torch.equal(ball, kquery.ball_query(xyz, centers, 0.04, ns)[:, :, None].expand(-1, -1, depths, -1))


# -------------------------------------------- the deterministic scatter-add --


@pytest.mark.parametrize("b,k,n,c", [(2, 32768, 2048, 128), (2, 3072, 512, 256), (1, 7, 3, 1),
                                     (3, 1000, 64, 33), (2, 4096, 4096, 300), (1, 0, 5, 8)])
def test_scatter_add_rows_is_bitwise_the_cpu_sum(dev, b, k, n, c):
    """At SA2's and FP2's training shapes and ragged ones (C beyond one
    pass of 256 lanes-values, empty segments, K = 0): the kernel's sums are
    bitwise the plain version's sequential sums on the CPU and repeat.  The
    bitwise comparison is the gate: the kernel adds the same terms in the
    same order as `index_add_` on the CPU.  Against a float64 sum it is
    held to the worst-case bound of a float32 sum of s terms,
    s * 2^-24 * sum |g|: the padded half makes segments of up to 16k terms,
    whose sequential float32 rounding (the plain version's too) exceeds
    1e-6 x max(1, scale).  (chip_smoke.py holds the kernel to 1e-6 x max(1, scale) of
    float64 at a training step's own calls.)"""
    from graspnet_tpu_torch.ops import scatter as ksc

    rng = np.random.default_rng(k + c)
    g = torch.from_numpy(rng.standard_normal((b, k, c)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, max(1, n // 4), (b, k)))
    idx[:, k // 2:] = idx[:, :1]  # first-hit padding: long runs of one index
    gd, idd = g.to(dev), idx.to(dev)
    before = ksc.scatter_add_rows.launches
    got = ksc.scatter_add_rows(gd, idd, n)
    assert ksc.scatter_add_rows.launches == before + 1
    assert torch.equal(got.cpu(), ksc.scatter_add_rows_plain(g, idx, n))
    assert torch.equal(got, ksc.scatter_add_rows(gd, idd, n, ksc.scatter_plan(idd, n)))
    # the recursive-summation bound of a float32 sum of s terms: s * 2^-24 * sum |g|
    f64 = ksc.scatter_add_rows_plain(g.double(), idx, n)
    abs_sum = ksc.scatter_add_rows_plain(g.double().abs(), idx, n)
    terms = ksc.scatter_add_rows_plain(torch.ones(b, k, 1, dtype=torch.float64), idx, n)
    assert ((got.cpu().double() - f64).abs() <= terms * 2.0 ** -24 * abs_sum).all()


def test_scatter_add_rows_rejects_what_it_does_not_take(dev):
    from graspnet_tpu_torch.ops import scatter as ksc

    g = torch.zeros(1, 4, 8, device=dev)
    idx = torch.zeros(1, 4, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        ksc.scatter_add_rows(g.double(), idx, 2)
    with pytest.raises(ValueError):
        ksc.scatter_add_rows(g, idx.int(), 2)
    with pytest.raises(ValueError):
        ksc.scatter_plan(idx.int(), 2)
    perm, starts, order = ksc.scatter_plan(idx, 2)
    with pytest.raises(ValueError):  # an int64 plan
        ksc.scatter_add_rows(g, idx, 2, (perm.long(), starts.long(), order))
    with pytest.raises(ValueError):  # no work order
        ksc.scatter_add_rows(g, idx, 2, (perm, starts, order[:1]))


def _plan_cases():
    from tests.test_torch_port_scatter_plan import EDGE_CASES, STEP_CALLS

    return [("step", name) for name in STEP_CALLS] + [("edge", name) for name in EDGE_CASES]


@pytest.mark.parametrize("kind,name", _plan_cases())
def test_scatter_plan_kernel_is_bitwise_the_plain_plan(dev, kind, name):
    """The counting-sort plan kernel at a B=2 step's five calls (first-hit
    padded and three-NN indices, tests/test_torch_port_scatter_plan.py) and
    at its edges (a ragged chunk, one row, B=1 x n=20000 through the global
    histograms, dropped indices): perm, starts and the work order bitwise
    the plain version's on the card and on the CPU, one launch, repeatable;
    the sum over the kernel's plan bitwise the CPU's sequential sum."""
    from graspnet_tpu_torch.ops import scatter as ksc
    from tests.test_torch_port_scatter_plan import edge_idx, step_idx

    idx, n = step_idx(name) if kind == "step" else edge_idx(name)
    cpu = torch.from_numpy(idx)
    card = cpu.to(dev)
    before = ksc.scatter_plan.launches
    plan = ksc.scatter_plan(card, n)
    assert ksc.scatter_plan.launches == before + 1
    for want in (ksc.scatter_plan_plain(cpu, n), ksc.scatter_plan_plain(card, n), ksc.scatter_plan(card, n)):
        assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(plan, want))
    g = torch.from_numpy(np.random.default_rng(1).standard_normal((*idx.shape, 40)).astype(np.float32))
    got = ksc.scatter_add_rows(g.to(dev), card, n, plan)
    assert torch.equal(got.cpu(), ksc.scatter_add_rows_plain(g, cpu, n))


def test_scatter_add_rows_walks_segments_longer_than_a_round(dev):
    """Segments of 1, 31, 32, 33, 64, 65 and 1000 sources (a round is 32
    rows in flight) at C = 256 and a ragged C = 70: bitwise the CPU's sum."""
    from graspnet_tpu_torch.ops import scatter as ksc

    lengths = (1, 31, 32, 33, 64, 65, 1000)
    idx = torch.from_numpy(np.repeat(np.arange(len(lengths)) * 2, lengths)[None])  # odd rows empty
    for c in (256, 70):
        g = torch.from_numpy(np.random.default_rng(c).standard_normal((1, idx.shape[1], c)).astype(np.float32))
        got = ksc.scatter_add_rows(g.to(dev), idx.to(dev), 2 * len(lengths))
        assert torch.equal(got.cpu(), ksc.scatter_add_rows_plain(g, idx, 2 * len(lengths)))


def test_gather_gradients_repeat_bitwise_on_the_card(dev):
    """group_points and three_interpolate backward on colliding indices:
    two backward passes give bitwise equal gradients."""
    from graspnet_tpu_torch import ops

    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((2, 2048, 128)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 64, (2, 1024, 32))).to(dev)
    nidx = torch.from_numpy(rng.integers(0, 16, (2, 1024, 3))).to(dev)
    w = torch.rand(2, 1024, 3, device=dev)
    grads = []
    for _ in range(2):
        f = feats.clone().requires_grad_(True)
        (ops.group_points(f, idx).square().sum() + ops.three_interpolate(f, nidx, w).sum()).backward()
        grads.append(f.grad)
    assert torch.equal(*grads)


def test_tiny_train_steps_repeat_bitwise(dev):
    """Five Trainer steps from one seed, twice: equal losses and parameters."""
    from graspnet_tpu_torch.data.dataset import collate
    from graspnet_tpu_torch.data.synthetic import SyntheticGraspNetDataset
    from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = GraspNetConfig.tiny()
    ds = SyntheticGraspNetDataset(n_frames=2, n_objects=3, label_points=40, cloud_points=1500,
                                  num_points=cfg.num_point, cfg=cfg, label_mode="full")
    batch = collate([ds.get_data_label(0), ds.get_data_label(1)])
    runs = []
    for _ in range(2):
        tr = Trainer(cfg, TrainConfig(), seed=0)
        losses = [float(tr.step(batch)[0]) for _ in range(5)]
        runs.append((losses, {k: v.clone() for k, v in tr.model.state_dict().items()}))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def _routing_cfg(case):
    import dataclasses

    from graspnet_tpu_torch.config import SAConfig

    tiny = GraspNetConfig.tiny()
    return {
        "default": tiny,
        "input_features": dataclasses.replace(tiny, input_feature_dim=3, sa1=SAConfig(128, 0.04, 16, (6, 8, 8, 16))),
        "sa1_unnormalized": dataclasses.replace(tiny, sa1=dataclasses.replace(tiny.sa1, normalize_xyz=False)),
        "sa1_two_layer_mlp": dataclasses.replace(tiny, sa1=SAConfig(128, 0.04, 16, (3, 8, 16))),
    }[case]


@pytest.mark.parametrize("case", ["default", "input_features", "sa1_unnormalized", "sa1_two_layer_mlp"])
def test_sa_routes_on_the_card_match_cpu(dev, case):
    """The JAX gates' SA1 routes on the card: K3 only for an xyz-only,
    normalized, 3-layer stage; input features, normalize_xyz=False and a
    2-layer MLP take K4 and the plain MLP (K3 would raise on the last).
    The forward equals the CPU's: selections exactly, floats within
    FEATURE_TOL x max(1, scale)."""
    from graspnet_tpu_torch.models import GraspNet, init_weights

    cfg = _routing_cfg(case)
    rng = np.random.default_rng(9)
    xyz = rng.uniform(-0.3, 0.3, (2, cfg.num_point, 3)).astype(np.float32)
    clouds = torch.from_numpy(np.concatenate([xyz, rng.uniform(0, 1, (2, cfg.num_point, cfg.input_feature_dim))
                                              .astype(np.float32)], axis=-1))
    model = init_weights(GraspNet(cfg), 1).eval()
    with torch.no_grad():
        want = model(clouds)
        model.to(dev)
        kernels.reset_launches()
        got = model(clouds.to(dev))
    fused = case == "default"
    featured = 3 + (case == "input_features")  # the stages with features take the featured route
    counts = kernels.launches()
    assert (counts["fps_chain"], counts["sa1_fused"], counts["ball_query"], counts["crop_fused"]) == \
        (1, int(fused), 3 + (not fused), 1), counts
    assert (counts["sa_group"], counts["sa_bias_relu"]) == (featured, 3 * featured), counts
    for key in ("sa1_inds", "fp2_inds", "grasp_top_view_inds"):
        assert torch.equal(got[key].cpu(), want[key]), key
    for key in ("fp2_features", "objectness_score", "grasp_score_pred", "grasp_width_pred"):
        assert_features_close(got[key].cpu(), want[key])


@pytest.mark.parametrize("max_batch", [1, 4])
@pytest.mark.parametrize("thresh", [-1.0, 0.01])
def test_tiny_service_card_matches_cpu(dev, max_batch, thresh):
    """GraspService.compute() on the card against the CPU service with the
    same weights: the same replies (selection fields equal, floats within
    1e-4), concurrent requests coalescing on the card."""
    import concurrent.futures as cf

    from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig

    def mk(device):
        return GraspService(ServiceConfig(model_cfg=GraspNetConfig.tiny(), depth_min=0.0, depth_max=10.0,
                                          collision_thresh=thresh, max_batch=max_batch, batch_wait_ms=20.0,
                                          device=device))

    rng = np.random.default_rng(4)
    clouds = [rng.uniform(-0.3, 0.3, (3000, 3)).astype(np.float32) + np.float32([0, 0, 0.5]) for _ in range(4)]
    card, cpu = mk("cuda"), mk("cpu")
    try:
        with cf.ThreadPoolExecutor(max_workers=4) as pool:
            got = [f.result(timeout=120) for f in [pool.submit(card.compute, c) for c in clouds]]
        for g, c in zip(got, clouds):
            w = cpu.compute(c)
            assert g["ok"] == w["ok"] and g.get("num_grasps") == w.get("num_grasps")
            if w["ok"]:
                ga, wa = np.asarray(g["grasps"]), np.asarray(w["grasps"])
                np.testing.assert_array_equal(ga[:, [2, 3, 13, 14, 15, 16]], wa[:, [2, 3, 13, 14, 15, 16]])
                np.testing.assert_allclose(ga, wa, rtol=0, atol=1e-4)
                np.testing.assert_allclose(g["tf_pose"], w["tf_pose"], rtol=0, atol=1e-4)
    finally:
        card.close()
        cpu.close()


def test_kernels_launch_from_concurrent_threads(dev):
    """Host threads launching one kernel at shapes that need different
    dynamic shared memory (K4's ring at 20000, 3000 and 512 points): the
    limit only grows (`csrc/smem_limit.cuh`), so no launch fails, and
    every result equals the plain version's."""
    import concurrent.futures as cf

    rng = np.random.default_rng(11)
    shapes = [(20000, 1024), (512, 256), (3000, 300)]
    cases = []
    for n, m in shapes:
        xyz = cloud(rng, 1, n).to(dev)
        centres = xyz[:, :m].contiguous()
        cases.append((xyz, centres, kquery.ball_query_plain(xyz, centres, 0.1, 16)))

    def work(i):
        for k in range(20):
            xyz, centres, want = cases[(i + k) % len(cases)]
            got = kquery.ball_query(xyz, centres, 0.1, 16)
            torch.cuda.current_stream(dev).synchronize()
            assert torch.equal(got, want)
        return True

    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        assert all(f.result(timeout=120) for f in [pool.submit(work, i) for i in range(8)])


def test_two_layer_crop_mlp_serves_and_trains_on_the_card(dev):
    """The CloudCrop's JAX routes on the card with crop_mlp=(3, 16, 32):
    eval takes K6 and the generic MLP (K5 takes 3 layers only), training
    takes K6 and the generic MLP (K7 likewise).  The forward equals the
    CPU's (selections exactly, floats within FEATURE_TOL x max(1, scale));
    a training probe's loss within 1e-5 relative and its gradients within
    chip_smoke.py's card-vs-CPU bounds (3e-2 x max(1, max |g|) per leaf)."""
    import dataclasses

    from graspnet_tpu_torch.models import GraspNet, init_weights
    from graspnet_tpu_torch.scripts.multiproc_check import build_batch
    from graspnet_tpu_torch.train.trainer import Trainer

    cfg = dataclasses.replace(GraspNetConfig.tiny(), crop_mlp=(3, 16, 32))
    clouds = torch.from_numpy(np.random.default_rng(4).uniform(-0.3, 0.3, (2, cfg.num_point, 3)).astype(np.float32))
    model = init_weights(GraspNet(cfg), 1).eval()
    with torch.no_grad():
        want = model(clouds)
        model.to(dev)
        kernels.reset_launches()
        got = model(clouds.to(dev))
    counts = kernels.launches()
    assert (counts["crop_fused"], counts["crop_group"]) == (0, 1), counts
    for key in ("fp2_inds", "grasp_top_view_inds"):
        assert torch.equal(got[key].cpu(), want[key]), key
    for key in ("grasp_score_pred", "grasp_angle_cls_pred", "grasp_width_pred", "grasp_tolerance_pred"):
        assert_features_close(got[key].cpu(), want[key])
    batch = build_batch(cfg, 0, 0, 2)
    card, cpu = Trainer(cfg, seed=0, device=dev), Trainer(cfg, seed=0, device="cpu")
    kernels.reset_launches()
    l_card, g_card = card.grads_compact(batch)
    counts = kernels.launches()
    assert (counts["crop_mlp_train"], counts["crop_mlp_train_backward"], counts["crop_group"]) == (0, 0, 1), counts
    l_cpu, g_cpu = cpu.grads_compact(batch)
    assert abs(float(l_card) - float(l_cpu)) <= 1e-5 * abs(float(l_cpu))
    for k, g in g_cpu.items():
        err = (g_card[k].cpu() - g).abs().max().item()
        assert err <= 3e-2 * max(1.0, g.abs().max().item()), (k, err)


def test_launchers_take_their_tensors_card_from_another_current_device(dev):
    """With cuda:0 current, kernels on tensors of cuda:1 launch there (the
    launchers enter their inputs' device) and equal the plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: this host has one")
    rng = np.random.default_rng(5)
    xyz = cloud(rng, 2, 4096)
    centres = xyz[:, :256].clone()
    other = torch.device("cuda", 1)
    with torch.cuda.device(0):
        got_fps = kernels.fps_chain(xyz.to(other), (512, 256))
        got_ball = kernels.ball_query(xyz.to(other), centres.to(other), 0.05, 16)
        assert got_ball.device == other
    want_fps = kfps.fps_chain_plain(xyz, (512, 256))
    for g, w in zip(got_fps, want_fps):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got_ball.cpu(), kquery.ball_query_plain(xyz, centres, 0.05, 16))


# ------------------------------------------------------ the voxel downsample --


@pytest.mark.parametrize("name", sorted(VOXEL_CASES))
def test_voxel_downsample_is_bitwise_the_host_library(dev, name):
    """The kernel's rows are the plain version's, bit for bit and in the
    same order (each cell's first point), the same on a second run, and the
    host library's as a set; the result stays on the card."""
    pts, voxel = VOXEL_CASES[name]
    x = torch.from_numpy(pts).to(dev)
    got = voxel_downsample(x, voxel)
    again = voxel_downsample(x, voxel)
    assert got.is_cuda and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = voxel_downsample_plain(torch.from_numpy(pts), voxel)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    np.testing.assert_array_equal(sorted_rows(got.cpu().numpy()), sorted_rows(native.voxel_downsample(pts, voxel)))


def test_collision_filter_downsamples_on_the_card(dev, monkeypatch):
    """The detector and detect_batch on raw clouds give the CPU path's
    masks (and the detector its empty-grasp masks and IoUs) with the scene
    downsampled by the kernel and kept on the card; the host library's
    downsample is never called there."""
    rng = np.random.default_rng(30)
    clouds = [tabletop_cloud(rng, 250000), tabletop_cloud(rng, 120000)]
    groups = [GraspGroup(grasp_rows(rng, c, 256)) for c in clouds]
    kw = dict(approach_dist=0.05, collision_thresh=0.01, return_empty_grasp=True, return_ious=True)
    want = [ModelFreeCollisionDetector(c, voxel_size=0.01, device="cpu").detect(g, **kw)
            for c, g in zip(clouds, groups)]
    want_batch = detect_batch(clouds, groups, voxel_size=0.01, approach_dist=0.05, collision_thresh=0.01,
                              device="cpu")

    def host_library(*args):
        raise AssertionError("the host library's downsample ran on the card's path")

    monkeypatch.setattr(collision.native, "voxel_downsample", host_library)
    kernels.reset_launches()
    for c, g, (mask, empty, ious) in zip(clouds, groups, want):
        det = ModelFreeCollisionDetector(c, voxel_size=0.01, device=dev)
        assert det.scene_points.is_cuda
        got_mask, got_empty, got_ious = det.detect(g, **kw)
        np.testing.assert_array_equal(got_mask, mask)
        np.testing.assert_array_equal(got_empty, empty)
        for a, b in zip(got_ious, ious):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    got_batch = detect_batch(clouds, groups, voxel_size=0.01, approach_dist=0.05, collision_thresh=0.01, device=dev)
    for a, b in zip(got_batch, want_batch):
        np.testing.assert_array_equal(a, b)
    assert 0 < sum(m.sum() for m in want_batch) < sum(len(g) for g in groups)  # some collide, some do not
    assert kernels.launches()["voxel_downsample"] == 4


def test_downsample_span_counts_points_and_voxels_on_the_card(dev):
    cloud = tabletop_cloud(np.random.default_rng(31), 250000)
    with tracing.recording() as rec:
        det = ModelFreeCollisionDetector(cloud, voxel_size=0.01, device=dev)
    spans = [s for s in rec.drain() if s.name == "collision.downsample"]
    assert [s.counts for s in spans] == [{"points": 250000, "voxels": len(native.voxel_downsample(cloud, 0.01))}]
    assert len(det.scene_points) == spans[0].counts["voxels"]


def test_detection_pipeline_card_matches_cpu(dev):
    """VoteNet at its published widths (40,000 points, SA1 with the height
    channel) through `DetectionPipeline` on the card and on the CPU, same
    seeded weights and two seeded room scans: K1 twice (the cascade and the
    proposals' FPS) and K4 five times (SA1-4 and the vote aggregation) a
    batch; the proposals' raw channels within FEATURE_TOL x max(1, scale)
    and every box decision (non-empty, NMS pick, kept, class) equal."""
    from benchmark.inputs.rooms import room_pool
    from graspnet_tpu_torch.apps.detect import DetectionPipeline
    from graspnet_tpu_torch.config import VoteNetConfig
    from graspnet_tpu_torch.postproc import boxes

    cfg = VoteNetConfig()
    clouds = room_pool(21, 2, cfg.num_point)
    card = DetectionPipeline(cfg=cfg, seed=1, device=dev)
    cpu = DetectionPipeline(cfg=cfg, seed=1, device="cpu")
    kernels.reset_launches()
    h = card.dispatch(clouds)
    got = card.finish(h)
    launches = kernels.launches()
    assert launches == {**{k: 0 for k in launches}, "fps_chain": 2, "ball_query": 5, "sa_group": 4,
                        "sa_bias_relu": 11, "count_in_boxes": 1}
    hc = cpu.dispatch(clouds)
    want = cpu.finish(hc)
    head, head_cpu = h.end_points["head"].cpu(), hc.end_points["head"]
    assert (head - head_cpu).abs().max().item() <= FEATURE_TOL * max(1.0, head_cpu.abs().max().item())
    for g, w in zip(got, want):
        for col in (boxes.NONEMPTY, boxes.PICKED, boxes.KEPT, boxes.SEM_CLS):
            np.testing.assert_array_equal(g.rows[:, col], w.rows[:, col])
        assert 0 < w.kept.sum() < w.nonempty.sum()


# ------------------------------------------- the eval SA stages' featured route --

def seeded_bn(model, seed):
    """Every BN statistic and affine drawn away from the identity, so the
    pre-activations of every layer take both signs."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in [*model.named_parameters(), *model.named_buffers()]:
            lo, hi = {"mean": (-0.1, 0.1), "var": (0.5, 2.0), "scale": (0.5, 1.5),
                      "offset": (-0.1, 0.1)}.get(name.rsplit(".", 1)[-1], (None, None))
            if lo is not None:
                p.copy_(lo + (hi - lo) * torch.rand(p.shape, generator=gen))
    return model


def backbone_stages(backbone, clouds):
    """Run an eval backbone forward; each SA stage's (config, xyz, features,
    new_xyz, pooled output) as the forward saw them."""
    seen = {}
    stages = (backbone.sa1, backbone.sa2, backbone.sa3, backbone.sa4)
    hooks = [st.register_forward_hook(lambda mod, args, out: seen.__setitem__(mod, (args[0], args[1], *out[:2])))
             for st in stages]
    try:
        with torch.inference_mode():
            backbone(clouds)
    finally:
        for h in hooks:
            h.remove()
    return [(st.cfg, st.mlp, *seen[st]) for st in stages]


def assert_route_is_the_twin(xyz, new_xyz, features, idx, folded, radius, pooled=None):
    """The featured route on the card against its plain twin on the same
    card, bitwise: the grouping kernel against the plain grouping, and the
    whole stage; `pooled`, what the backbone's forward gave, too."""
    from graspnet_tpu_torch.ops.cuda import sa as ksa

    first = folded[0] if folded[0][0].shape[0] <= ksa.MAX_FUSED_K else None
    before = (ksa.sa_group.launches, ksa.sa_bias_relu.launches)
    got = ksa.sa_pool(xyz, new_xyz, features, idx, folded, radius)
    products = len(folded) - (first is not None)
    assert (ksa.sa_group.launches, ksa.sa_bias_relu.launches) == (before[0] + 1, before[1] + products)
    want = ksa.sa_pool_plain(xyz, new_xyz, features, idx, folded, radius)
    assert torch.equal(got, want)
    assert torch.equal(ksa.sa_group(xyz, new_xyz, features, idx, radius, first),
                       ksa.sa_group_plain(xyz, new_xyz, features, idx, radius, first))
    if pooled is not None:
        assert torch.equal(pooled, want)
    return want


@pytest.mark.parametrize("model", ["votenet_b8", "graspnet_b1", "groupfree_b8"])
def test_sa_route_is_bitwise_the_plain_twin_at_published_widths(dev, model):
    """The featured route on the backbone's own intermediates, bitwise the
    plain twin on the card: VoteNet SA1-SA4 on a batch of 8 of the
    detection cell's 40,000-point room scans (SA1 with the height, its
    3 + 1 -> 64 layer in the grouping kernel), Group-Free-3D's w2x SA1-SA4
    on 8 scans of 50,000 points (the 3 + 1 -> 128 layer, 256- and 512-wide
    products), GraspNet's SA2-4 on one 20,000-point tabletop."""
    from graspnet_tpu_torch.config import GroupFreeConfig, VoteNetConfig
    from graspnet_tpu_torch.models import GraspNet, init_weights
    from graspnet_tpu_torch.models.groupfree import GroupFree3D
    from graspnet_tpu_torch.models.votenet import VoteNet
    from graspnet_tpu_torch.nn.layers import fold_bn_eval

    if model in ("votenet_b8", "groupfree_b8"):
        from benchmark.inputs.rooms import room_pool

        cfg = VoteNetConfig() if model == "votenet_b8" else GroupFreeConfig()
        net = VoteNet(cfg) if model == "votenet_b8" else GroupFree3D(cfg)
        clouds = torch.from_numpy(room_pool(25, 8, cfg.num_point))
    else:
        cfg = GraspNetConfig()
        net = GraspNet(cfg)
        clouds = torch.from_numpy(tabletop_cloud(np.random.default_rng(25))[None])
    net = seeded_bn(init_weights(net, 1), 2).to(dev).eval()
    featured = 0
    for sa, mlp, xyz, features, new_xyz, pooled in backbone_stages(net.backbone, clouds.to(dev)):
        if features is None:
            continue
        featured += 1
        with torch.inference_mode():
            idx = kquery.ball_query(xyz, new_xyz, sa.radius, sa.nsample)
            want = assert_route_is_the_twin(xyz, new_xyz, features, idx, fold_bn_eval(mlp),
                                            sa.radius if sa.normalize_xyz else None, pooled)
        assert (want == 0).any() and (want > 0).any()
    assert featured == (3 if model == "graspnet_b1" else 4)


def sa_route_inputs(dev, b, n, m, c_in, radius, seed):
    """Points in a 1 m box with one at exactly (r, 0, 0) from a centre at
    the origin (not in its ball: the test is d^2 < r^2), a centre far from
    every point (its ball is empty: K4 pads with point 0), features of
    both signs."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32)
    xyz[:, 7] = (radius, 0.0, 0.0)
    centres = xyz[:, rng.choice(n, m, replace=False)].copy()
    centres[:, 0] = 0.0
    centres[:, -1] = (40.0, 40.0, 40.0)
    feats = rng.normal(size=(b, n, c_in)).astype(np.float32)
    return [torch.from_numpy(t).to(dev) for t in (xyz, centres, feats)]


@pytest.mark.parametrize("dims", [(4, 64, 64, 128), (4, 7, 9, 13), (4, 8, 12), (4, 160, 16), (131, 128, 128, 256),
                                  (8, 7, 13), (19, 16, 16, 32)])
@pytest.mark.parametrize("ns", [1, 17, 64])
@pytest.mark.parametrize("normalize", [True, False])
def test_sa_route_edges_are_bitwise_the_plain_twin(dev, dims, ns, normalize):
    """Ragged shapes: M and B x M x ns multiples of no tile, widths not
    multiples of 4 (the epilogues' scalar form), a fused first layer with
    one product after it and one wider than the 128 columns the grouping
    kernel holds in registers, the concat rows; an empty ball's padding, a
    point at exactly r, pre-activations below 0 (a bias of -2 on half the
    channels: whole groups pool to 0)."""
    radius = 0.25
    xyz, centres, feats = sa_route_inputs(dev, 2, 3001, 1001, dims[0] - 3, radius, ns)
    folded = folded_weights(dims, ns, dev)
    folded = [(w, b - 2.0 * (torch.arange(b.numel(), device=dev) % 2)) for w, b in folded]
    with torch.inference_mode():
        idx = kquery.ball_query(xyz, centres, radius, ns)
        assert (idx[:, -1] == 0).all()  # the empty ball
        assert not (idx[:, 0] == 7).any()  # the point at exactly r is out
        want = assert_route_is_the_twin(xyz, centres, feats, idx, folded, radius if normalize else None)
    assert (want == 0).any() and (want > 0).any()


@pytest.mark.parametrize("radius", [0.04, 0.1, 0.2, 0.3, 0.4, 0.8, 1.2, 0.07, 0.013, 1.7, 0.3333])
def test_sa_group_offsets_scale_as_torch_divides(dev, radius):
    """The grouping kernel's offsets x 1/r are bitwise the plain path's
    `grouped / r` on the card (ATen multiplies by 1/r rounded to float32
    once), at every radius of both models and some where 1/r so rounded
    differs from the float32 division 1.0f / (float)r."""
    from graspnet_tpu_torch.ops import group_points
    from graspnet_tpu_torch.ops.cuda import sa as ksa

    xyz, centres, feats = sa_route_inputs(dev, 2, 4096, 513, 5, radius, 1)
    with torch.inference_mode():
        idx = kquery.ball_query(xyz, centres, radius, 32)
        got = ksa.sa_group(xyz, centres, feats, idx, radius)
        assert torch.equal(got, ksa.sa_group_plain(xyz, centres, feats, idx, radius))
        assert torch.equal(got[..., :3], (group_points(xyz, idx) - centres[:, :, None]) / radius)


def test_sa_route_rejects_inputs_outside_its_domain(dev):
    """On the card a shape outside the kernels' domain raises ValueError and
    launches nothing (no fallback to the plain path)."""
    from graspnet_tpu_torch.ops.cuda import sa as ksa

    xyz, centres, feats = sa_route_inputs(dev, 1, 512, 64, 1, 0.2, 0)
    idx = kquery.ball_query(xyz, centres, 0.2, 16)
    folded = folded_weights((4, 8, 16), 0, dev)
    before = (ksa.sa_group.launches, ksa.sa_bias_relu.launches)
    bad = [
        lambda: ksa.sa_group(xyz, centres, feats.double(), idx, 0.2, folded[0]),
        lambda: ksa.sa_group(xyz, centres, feats, idx.int(), 0.2),
        lambda: ksa.sa_group(xyz, centres, None, idx, 0.2),
        lambda: ksa.sa_group(xyz, centres, feats.cpu(), idx, 0.2),
        lambda: ksa.sa_group(xyz, centres, torch.cat([feats, feats], -1), idx, 0.2, folded[0]),
        lambda: ksa.sa_pool(xyz, centres, feats, idx, folded[:1], 0.2),
        lambda: ksa.sa_bias_relu(torch.zeros(1, 16, 4, 8, device=dev).transpose(1, 2), folded[0][1]),
        lambda: ksa.sa_bias_relu(torch.zeros(16, 8, device=dev), folded[0][1], pool=True),
        lambda: ksa.sa_bias_relu(torch.zeros(16, 8, device=dev), folded[1][1]),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert (ksa.sa_group.launches, ksa.sa_bias_relu.launches) == before


# ------------------------------------------------- the service's card route --

ROUTE_CASES = {  # (points, z range) of a capture; the window is [0.3, 0.6]
    "partial": (3000, 0.2, 0.7),  # the bounds' float32 values and their neighbours on the first rows
    "inside": (3000, 0.35, 0.55),
    "short": (400, 0.2, 0.7),  # under num_point (512) in the window: the padded draw
    "rejected": (3000, 0.7, 0.9),  # 4 edge rows in the window, under the 10 % floor
}


def route_capture(rng, n, z_low, z_high):
    pts = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(z_low, z_high, n)
    if z_low < 0.3 or z_high > 0.6:
        pts[:6, 2] = [v for b in (0.3, 0.6) for v in (np.float32(b), np.nextafter(np.float32(b), np.float32(0)),
                                                      np.nextafter(np.float32(b), np.float32(1)))]
    return pts


def route_service(max_batch=1):
    from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig

    # random weights' grasps mostly collide at 0.01: at 0.3 some pass the filter
    return GraspService(ServiceConfig(model_cfg=GraspNetConfig.tiny(), collision_thresh=0.3, max_batch=max_batch,
                                      device="cuda"))


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_service_card_route_is_bitwise_the_host_route(dev, case, monkeypatch):
    """At max_batch 1 on the card, the windowed scene and the sampled cloud
    that `compute` hands the filter and the forward are tensors on the card,
    bitwise the host route's numpy window and sample; the reply's rows are
    those of the same pipeline run on the host route's clouds, and a
    capture under the floor gets the host route's error."""
    svc = route_service()
    n, z_low, z_high = ROUTE_CASES[case]
    cloud = route_capture(np.random.default_rng(50), n, z_low, z_high)
    z = cloud[:, 2]
    window = cloud[(z >= svc.cfg.depth_min) & (z <= svc.cfg.depth_max)]
    handed, run = {}, svc.pipe.run

    def spy(cloud_sampled, scene_cloud=None, **kw):
        handed.update(sampled=cloud_sampled, scene=scene_cloud)
        return run(cloud_sampled, scene_cloud=scene_cloud, **kw)

    monkeypatch.setattr(svc.pipe, "run", spy)
    try:
        reply = svc.compute(cloud)
        if case == "rejected":
            assert len(window) == 4 and not handed
            assert reply == {"ok": False, "error": "not enough points in depth range"}
            return
        if case == "short":
            assert 100 <= len(window) < svc.pipe.cfg.num_point
        sampled = svc.pipe.sample_cloud(window)
        for key, want in (("scene", window), ("sampled", sampled)):
            got = handed[key]
            assert isinstance(got, torch.Tensor) and got.is_cuda, key
            assert torch.equal(got.cpu().view(torch.int32), torch.from_numpy(want).view(torch.int32)), key
        gg = run(sampled, scene_cloud=window, collision_thresh=svc.cfg.collision_thresh,
                 voxel_size=svc.cfg.voxel_size, nms=False, top_k=0)
        want = gg.sort_by_score().nms().sort_by_score()[: svc.cfg.top_k].grasp_group_array
        assert reply["ok"] and len(want) > 0
        np.testing.assert_array_equal(np.asarray(reply["grasps"], np.float32), want)
    finally:
        svc.close()


def test_service_sample_span_counts_the_route(dev):
    """`service.sample` counts card 1 at max_batch 1 and 0 micro-batched,
    the capture's points and the window's rows; on the card route the
    filter's downsample takes the window as it lies (its `points` count is
    the window's)."""
    cloud = route_capture(np.random.default_rng(51), 3000, 0.2, 0.7)
    z = cloud[:, 2]
    kept = int(((z >= np.float32(0.3)) & (z <= np.float32(0.6))).sum())
    for max_batch, card in ((1, 1), (2, 0)):
        svc = route_service(max_batch)
        try:
            with tracing.recording() as rec:
                svc.compute(cloud)
            spans = rec.drain()
        finally:
            svc.close()
        assert [s.counts for s in spans if s.name == "service.sample"] == \
            [{"points": 3000, "card": card, "window": kept}], max_batch
        assert [s.counts["points"] for s in spans if s.name == "collision.downsample"] == [kept], max_batch


# ------------------------------------------------ Group-Free-3D's attention --

def attention_operands(dev, b, lq, lk, heads, seed, scale=1.0, packed=True):
    """q (B, Lq, E) and k, v (B, Lk, E), E = heads x 36: with `packed`, as
    the decoder hands them over, k and v views into one (B, Lk, 2E)
    projection and q a view into a (B, Lq, 3E) one."""
    from graspnet_tpu_torch.ops.cuda import attn

    gen = torch.Generator().manual_seed(seed)
    e = heads * attn.HEAD_DIM
    if packed:
        q = (torch.randn((b, lq, 3 * e), generator=gen) * scale).to(dev)[..., :e]
        kv = (torch.randn((b, lk, 2 * e), generator=gen) * scale).to(dev)
        return q, kv[..., :e], kv[..., e:]
    return tuple((torch.randn((b, n, e), generator=gen) * scale).to(dev) for n in (lq, lk, lk))


@pytest.mark.parametrize("b,lq,lk,heads,scale,packed", [
    (8, 512, 512, 8, 1.0, True),     # the cell's self-attention
    (8, 512, 1024, 8, 1.0, True),    # the cell's cross-attention
    (2, 33, 17, 3, 1.0, False),      # ragged tiles, a warp with no keys
    (1, 70, 1, 2, 1.0, True),        # one key
    (2, 64, 300, 1, 8.0, False),     # scores of hundreds: the online softmax's rescaling
])
def test_attention_kernel_matches_plain(dev, b, lq, lk, heads, scale, packed):
    """The fused kernel against its plain version at head width 36: within
    1e-5 x max(1, scale) of it, or, where the scores run to hundreds and a
    float32 score's rounding moves its weight by more than that, no further
    from the float64 attention than 2 x the plain version is.  Both are
    softmax-weighted means of v summed in another order (the kernel: scores
    in 16-key chunks, exp2 of pre-scaled queries, the four warps' partial
    sums joined at the end).  The launch is counted once."""
    from graspnet_tpu_torch.ops.cuda import attn

    q, k, v = attention_operands(dev, b, lq, lk, heads, seed=lq + lk, scale=scale, packed=packed)
    before = attn.attention.launches
    got = attn.attention(q, k, v, heads)
    assert attn.attention.launches == before + 1
    want = attn.attention_plain(q, k, v, heads)
    assert got.shape == want.shape and got.is_contiguous() and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    if err > 1e-5 * max(1.0, want.abs().max().item()):
        exact = attn.attention_plain(q.double(), k.double(), v.double(), heads)
        assert (got - exact).abs().max().item() <= 2 * (want - exact).abs().max().item(), err


def test_attention_rejects_inputs_outside_its_domain(dev):
    from graspnet_tpu_torch.ops.cuda import attn

    q, k, v = attention_operands(dev, 1, 8, 8, 2, seed=0, packed=False)
    for bad in ((q[..., :64], k[..., :64], v[..., :64], 2),   # head width 32
                (q, k[:, :0], v[:, :0], 2),                   # no keys
                (q.double(), k.double(), v.double(), 2),
                (q, k[:, :4], v, 2)):
        with pytest.raises(ValueError, match="attention takes"):
            attn.attention(*bad)


def test_groupfree_pipeline_on_the_card_matches_the_reference(dev):
    """Group-Free-3D at its published widths (L12 O512 w2x) through
    `DetectionPipeline` on the card, two of the cell's 50,000-point room
    scans, the benchmark's seeded weights: K1 once (the cascade), K4, the
    grouping kernel 4 times and the epilogues 11 times (SA1-4), the
    attention kernel 24 times; then held against the plain reference on
    the card by the cell's own comparison and limits."""
    from benchmark import harness
    from benchmark.drivers.detect_groupfree import groupfree_weights
    from benchmark.inputs.rooms import room_pool
    from benchmark.reference import gf, gn, judge
    from graspnet_tpu_torch.apps.detect import DetectionPipeline
    from graspnet_tpu_torch.config import GroupFreeConfig
    from graspnet_tpu_torch.models.groupfree import GroupFree3D

    cfg = GroupFreeConfig()
    weights = groupfree_weights({k: tuple(v.shape) for k, v in GroupFree3D(cfg).state_dict().items()}, 0, dev)
    clouds = room_pool(2**31 + 5, 2, cfg.num_point)
    pipe = DetectionPipeline(params=weights, cfg=cfg, device=dev)
    kernels.reset_launches()
    handle = pipe.dispatch(clouds)
    rows = np.stack([d.rows for d in pipe.finish(handle)])
    launches = kernels.launches()
    assert launches == {**{k: 0 for k in launches}, "fps_chain": 1, "ball_query": 4, "sa_group": 4,
                        "sa_bias_relu": 11, "attention": 2 * cfg.num_decoder_layers, "count_in_boxes": 1}
    spec = harness.load_json("configs", "groupfree3d-scannet-L12-O512-w2x.infer")
    limits = harness.load_json("workloads", "infer.groupfree_scannet_b8")["limits"]
    det = gf.Detector.from_fields(spec["detector"])
    ref = gf.GroupFree(harness.model_config(spec["model"], gn), det, weights, dev)
    x = torch.as_tensor(clouds, device=dev)
    with judge.precision("float32"):
        out = ref.forward(x, follow=handle.end_points["size_cls_layers"], tie=limits["head_gap"])
        res = gf.parse_predictions(out, x[..., :3], det, ref.mean_size)
    assert torch.equal(handle.end_points["query_inds"], out["query_inds"])
    got = gf.compare(rows, handle.end_points["head"].cpu().numpy(), out["head"].cpu().numpy(), res, x[..., :3], det)
    assert all(got[k] <= limits[k] for k in got), got
    assert 0 < res["kept"].sum() < res["nonempty"].sum()


# ------------------------------------------------------- the empty-box count --

def box_case(rng, b, n, p, width=4, lattice=False):
    """(B, N, width) rows whose x[..., :3] are the points (a strided view at
    width 4, as the pipeline hands them over) and (B, P, 3) corners: boxes
    around points of the scan, 0.05-1.5 m a side, every fourth moved 10 m
    away (empty); or, with `lattice`, points and corners on a 1/8 m
    lattice, so points lie exactly on faces and corners and some boxes
    have no extent."""
    if lattice:
        rows = (rng.integers(0, 17, (b, n, width)) / 8).astype(np.float32)
        lo = (rng.integers(0, 17, (b, p, 3)) / 8).astype(np.float32)
        hi = lo + (rng.integers(0, 5, (b, p, 3)) / 8).astype(np.float32)
    else:
        rows = rng.uniform(0.0, 6.0, (b, n, width)).astype(np.float32)
        centre = rng.uniform(0.0, 6.0, (b, p, 3)).astype(np.float32)
        if n:
            centre = rows[np.arange(b)[:, None], rng.integers(0, n, (b, p)), :3]
        centre[:, 3::4] += 10.0
        half = rng.uniform(0.025, 0.75, (b, p, 3)).astype(np.float32)
        lo, hi = centre - half, centre + half
    return torch.from_numpy(rows), torch.from_numpy(lo), torch.from_numpy(hi)


@pytest.mark.parametrize("b,n,p,width,lattice", [
    (8, 40000, 256, 4, False),   # VoteNet's batch
    (8, 50000, 512, 4, False),   # Group-Free-3D's batch
    (1, 1000, 1, 4, False),      # one box, a ragged step
    (1, 40001, 33, 4, False),    # a ragged tile and a ragged slice
    (1, 777, 300, 3, False),     # contiguous 3-float rows
    (2, 5000, 300, 4, True),     # faces, corners, zero extent
    (3, 513, 40, 3, True),
])
def test_box_count_kernel_is_the_plain_count(dev, b, n, p, width, lattice):
    """`count_in_boxes` on the card equals `points_in_boxes` (torch.equal,
    int64), one launch a call."""
    from graspnet_tpu_torch.ops.cuda import boxes as kboxes

    rows, lo, hi = (t.to(dev) for t in box_case(np.random.default_rng(b * n + p), b, n, p, width, lattice))
    pts = rows[..., :3]
    before = kboxes.count_in_boxes.launches
    got = kboxes.count_in_boxes(pts, lo, hi)
    assert kboxes.count_in_boxes.launches == before + 1
    want = kboxes.points_in_boxes(pts, lo, hi)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert int(want.max()) > 0 and (p < 4 or lattice or int(want.min()) == 0)


def test_box_count_kernel_takes_nan_as_outside(dev):
    """NaN coordinates of points and NaN bounds of boxes fail every
    comparison, on the card as in the plain count."""
    from graspnet_tpu_torch.ops.cuda import boxes as kboxes

    rng = np.random.default_rng(7)
    rows, lo, hi = box_case(rng, 2, 3000, 70)
    rows[:, rng.choice(3000, 300, replace=False), rng.integers(0, 3)] = float("nan")
    lo[:, 2, 1] = float("nan")
    hi[:, 10, 2] = float("nan")
    lo[0, 21] = float("nan")
    rows, lo, hi = rows.to(dev), lo.to(dev), hi.to(dev)
    got = kboxes.count_in_boxes(rows[..., :3], lo, hi)
    assert torch.equal(got, kboxes.points_in_boxes(rows[..., :3], lo, hi))
    assert int(got[:, 2].sum()) == int(got[:, 10].sum()) == int(got[0, 21]) == 0 < int(got.sum())


def test_box_count_kernel_of_no_boxes_and_no_points(dev):
    """No points: every count 0; no boxes: an empty result; neither
    launches the kernel."""
    from graspnet_tpu_torch.ops.cuda import boxes as kboxes

    before = kboxes.count_in_boxes.launches
    rows, lo, hi = (t.to(dev) for t in box_case(np.random.default_rng(3), 2, 0, 5))
    got = kboxes.count_in_boxes(rows[..., :3], lo, hi)
    assert torch.equal(got, torch.zeros((2, 5), dtype=torch.int64, device=dev))
    rows, lo, hi = (t.to(dev) for t in box_case(np.random.default_rng(3), 2, 100, 0))
    assert kboxes.count_in_boxes(rows[..., :3], lo, hi).shape == (2, 0)
    assert kboxes.count_in_boxes.launches == before


@pytest.mark.parametrize("model", ["votenet", "groupfree"])
def test_detection_batch_counts_the_boxes_as_the_plain_count(dev, model, monkeypatch):
    """One batch of two of the cell's room scans through `DetectionPipeline`
    at the published widths, with the kernel and with the plain count in
    its place: the POINTS and NONEMPTY columns equal, and the
    `detect.boxes` span counts card 1 on the card."""
    from benchmark.drivers.detect_groupfree import groupfree_weights
    from benchmark.inputs.rooms import room_pool
    from graspnet_tpu_torch.apps.detect import DetectionPipeline
    from graspnet_tpu_torch.config import GroupFreeConfig, VoteNetConfig
    from graspnet_tpu_torch.models.groupfree import GroupFree3D
    from graspnet_tpu_torch.ops.cuda import boxes as kboxes
    from graspnet_tpu_torch.postproc import boxes

    if model == "votenet":
        cfg = VoteNetConfig()
        pipe = DetectionPipeline(cfg=cfg, seed=1, device=dev)
    else:
        cfg = GroupFreeConfig()
        weights = groupfree_weights({k: tuple(v.shape) for k, v in GroupFree3D(cfg).state_dict().items()}, 0, dev)
        pipe = DetectionPipeline(params=weights, cfg=cfg, device=dev)
    clouds = room_pool(2**31 + 27, 2, cfg.num_point)
    kernels.reset_launches()
    with tracing.recording() as rec:
        got = np.stack([d.rows for d in pipe.detect(clouds)])
    assert kernels.launches()["count_in_boxes"] == 1
    assert [s.counts["card"] for s in rec.drain() if s.name == "detect.boxes"] == [1]
    monkeypatch.setattr(boxes, "count_in_boxes", kboxes.points_in_boxes)
    kernels.reset_launches()
    want = np.stack([d.rows for d in pipe.detect(clouds)])
    assert kernels.launches()["count_in_boxes"] == 0
    for col in (boxes.POINTS, boxes.NONEMPTY):
        np.testing.assert_array_equal(got[..., col], want[..., col])
    assert 0 < want[..., boxes.NONEMPTY].sum() < want[..., boxes.NONEMPTY].size


# ------------------------------------- Point Transformer V3: maps, conv, attention --

def seg_batch(points, lengths, seed):
    """The segmentation cell's room fragments, cut to `lengths`: (N, 3)
    cells and (N,) fragments, int32, on the card."""
    from benchmark.inputs.rooms_seg import fragment_pool

    pool = fragment_pool(seed, len(lengths), points)
    grid = np.concatenate([g[:n] for (_, g, _), n in zip(pool, lengths)])
    batch = np.repeat(np.arange(len(lengths)), lengths)
    return torch.from_numpy(grid).int(), torch.from_numpy(batch).int()


@pytest.mark.parametrize("k", [3, 5])
def test_kernel_map_matches_plain_exactly(dev, k):
    """`kmap_kernel` at the cell's stage-0 shapes (4 fragments, 100,000
    points) and a ragged small batch: the map equals the plain sort-and-
    search element for element, and so do the hits; one counted launch."""
    from graspnet_tpu_torch.ops.cuda import spconv

    for points, lengths in ((102400, (102400, 100000, 60000, 1)), (3000, (3000, 17, 400))):
        grid, batch = seg_batch(points, lengths, seed=2**31 + k)
        before = spconv.kernel_map.launches
        got, hits = spconv.kernel_map(grid.to(dev), batch.to(dev), k)
        assert spconv.kernel_map.launches == before + 1
        want, want_hits = spconv.kernel_map_plain(grid, batch, k)
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
        assert int(hits) == int(want_hits)


@pytest.mark.parametrize("c_in,c_out,k,n", [(6, 32, 5, 20000), (32, 32, 3, 20000), (64, 64, 3, 20000),
                                           (256, 256, 3, 5000), (512, 512, 3, 1500), (20, 48, 3, 777),
                                           (48, 4, 3, 65)])
def test_subm_conv_matches_plain_and_repeats_bitwise(dev, c_in, c_out, k, n):
    """`subm_conv_kernel` against `subm_conv_plain` within 1e-4 x max(1,
    |y|) (float32 sums of up to 27 x 512 products in another order) at the
    stem's 6 -> 32 at 5^3, the blocks' C -> C at 3^3 and widths the
    vectorised path does not take; a second run is bitwise the first."""
    from graspnet_tpu_torch.ops.cuda import spconv

    grid, batch = seg_batch(max(n, 2), (n,), seed=2**31 + n)
    kmap, _ = spconv.kernel_map_plain(grid, batch, k)
    gen = torch.Generator().manual_seed(c_in * c_out)
    x = torch.randn(n, c_in, generator=gen)
    kernel = torch.randn(k ** 3 * c_in, c_out, generator=gen) * (2.0 / (k ** 3 * c_in)) ** 0.5
    bias = torch.randn(c_out, generator=gen) if k == 3 else None
    want = spconv.subm_conv_plain(x, kmap, kernel, bias)
    args = (x.to(dev), kmap.to(dev), kernel.to(dev), None if bias is None else bias.to(dev))
    before = spconv.subm_conv.launches
    got = spconv.subm_conv(*args)
    assert spconv.subm_conv.launches == before + 1
    assert torch.equal(got, spconv.subm_conv(*args))
    err = (got.cpu() - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= 1e-4 * max(1.0, want.abs().max().item()), err


def test_sparse_kernels_reject_inputs_outside_their_domain(dev):
    from graspnet_tpu_torch.ops.cuda import spconv

    grid, batch = seg_batch(100, (100,), seed=1)
    g, b = grid.to(dev), batch.to(dev)
    for bad in ((g.long(), b, 3), (g, b.long(), 3), (g, b, 4), (g[:, :2], b, 3)):
        with pytest.raises(ValueError, match="kernel_map takes"):
            spconv.kernel_map(*bad)
    kmap, _ = spconv.kernel_map(g, b, 3)
    x, w = torch.ones(100, 8, device=dev), torch.ones(27 * 8, 8, device=dev)
    for bad in ((x.double(), kmap, w.double()), (x, kmap.long(), w), (x, kmap, w[:, :6]), (x, kmap, w[:-8])):
        with pytest.raises(ValueError, match="subm_conv takes"):
            spconv.subm_conv(*bad)


@pytest.mark.parametrize("lengths,heads,scale", [
    ((1024,) * 8 + (1000, 77), 2, 1.0),   # full patches, a short fragment, a ragged one
    ((1024,) * 3, 32, 1.0),              # the bottom stage's 32 heads
    ((1, 33, 64, 5), 4, 8.0),            # one point; scores of hundreds
])
def test_attention_varlen_matches_plain(dev, lengths, heads, scale):
    """The width-16 variable-length entry against `attention_plain` on each
    sequence, within 1e-5 x max(1, scale) (or no further from float64 than
    2 x the plain version where the scores run to hundreds); the rows are
    a packed (T, 3C) projection; one counted launch."""
    from graspnet_tpu_torch.ops.cuda import attn

    gen = torch.Generator().manual_seed(sum(lengths) + heads)
    c = heads * 16
    qkv = torch.randn(sum(lengths), 3 * c, generator=gen) * scale
    starts = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int32)
    before = attn.attention_varlen.launches
    got = attn.attention_varlen(qkv.to(dev), starts.to(dev), heads, max(lengths)).cpu()
    assert attn.attention_varlen.launches == before + 1
    want = attn.attention_varlen_plain(qkv.to(dev), starts, heads).cpu()
    err = (got - want).abs().max().item()
    if err > 1e-5 * max(1.0, want.abs().max().item()):
        exact = attn.attention_varlen_plain(qkv.double(), starts, heads)
        assert (got - exact).abs().max().item() <= 2 * (want - exact).abs().max().item(), err


# sha256 of the width-36 kernel's output bytes at `attention_operands`' shapes and seeds, as the
# kernel gave them before the head width became a template parameter (NVIDIA H100 80GB HBM3, sm_90a)
WIDTH_36_DIGESTS = {
    (8, 512, 512, 8, True): "937dfa60582f5836b1b2f1081b61b6c7ab75cad70306ada4d939f5a298bda80b",
    (8, 512, 1024, 8, True): "ed0931ee79c6f4a3333dbda11c661e9045d8dbab2387b43b0e057455fa705290",
    (2, 33, 17, 3, False): "444052e620d9fa5442bd735abae024da19470d8de6ba4f76cd283f5c1f4ae4f7",
}


@pytest.mark.parametrize("b,lq,lk,heads,packed", [(8, 512, 512, 8, True), (8, 512, 1024, 8, True),
                                                  (2, 33, 17, 3, False)])
def test_attention_width_36_is_bitwise_what_it_was(dev, b, lq, lk, heads, packed):
    import hashlib

    from graspnet_tpu_torch.ops.cuda import attn

    q, k, v = attention_operands(dev, b, lq, lk, heads, seed=lq + lk, packed=packed)
    got = hashlib.sha256(attn.attention(q, k, v, heads).cpu().numpy().tobytes()).hexdigest()
    assert got == WIDTH_36_DIGESTS[(b, lq, lk, heads, packed)]


def test_ptv3_pipeline_on_the_card_matches_the_reference(dev):
    """Point Transformer V3 at the published base widths through
    `SegmentationPipeline` on the card, four of the cell's fragments cut to
    30,000, 20,000, 900 and 50 points, the benchmark's seeded weights: the
    maps kernel 6 times (the stem's and five stages'), the convolution 23
    times (the stem and 22 blocks), attention 22 times and no other
    kernel; then held against the plain reference on the card by the
    cell's own comparison and limits."""
    from benchmark import harness
    from benchmark.inputs.rooms_seg import fragment_pool
    from benchmark.reference import judge
    from benchmark.reference import ptv3 as ref
    from benchmark.weights import make_weights
    from graspnet_tpu_torch.apps.segment import Fragment, SegmentationPipeline
    from graspnet_tpu_torch.config import PTv3Config
    from graspnet_tpu_torch.models.ptv3 import PTv3

    cfg = PTv3Config()
    weights = make_weights({k: tuple(v.shape) for k, v in PTv3(cfg).state_dict().items()}, 0, dev)
    lengths = (30000, 20000, 900, 50)
    frags = [Fragment(c[:n], g[:n], f[:n]) for (c, g, f), n in zip(fragment_pool(2**31 + 9, 4, 30000), lengths)]
    pipe = SegmentationPipeline(cfg, params=weights, device=dev)
    kernels.reset_launches()
    handle = pipe.dispatch(frags)
    out = pipe.finish(handle)
    launches = kernels.launches()
    assert launches == {**{k: 0 for k in launches}, "kernel_map": 6, "subm_conv": 23, "attention_varlen": 22}
    limits = harness.load_json("workloads", "infer.ptv3_scannet_b4")["limits"]
    spec = harness.load_json("configs", "ptv3m1-scannet-semseg.infer")
    model = ref.PTv3(ref.Config.from_fields(spec["model"]), weights, dev)
    grid = torch.from_numpy(np.concatenate([f.grid_coord for f in frags])).long().to(dev)
    batch = torch.repeat_interleave(torch.arange(4, device=dev), torch.tensor(lengths, device=dev))
    feat = torch.from_numpy(np.concatenate([f.feat for f in frags])).to(dev)
    with judge.precision("float32"):
        want = model.forward(grid, batch, feat)
    logits = torch.from_numpy(np.concatenate([s.logits for s in out])).to(dev)
    labels = torch.from_numpy(np.concatenate([s.labels for s in out])).to(dev)
    got = ref.compare(logits, labels, want["logits"], limits["logit_gap"])
    got["order_diff"] = ref.order_diff(
        {"stem": handle.stem, "stages": [{"order": s.order, "kmap": s.kmap, "cluster": s.cluster}
                                         for s in handle.stages]}, want)
    assert all(got[k] <= limits[k] for k in got), got
