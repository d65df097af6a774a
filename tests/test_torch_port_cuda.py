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

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.models import geometry
from graspnet_tpu_torch.ops import cuda as kernels
from graspnet_tpu_torch.ops.cuda import crop as kcrop
from graspnet_tpu_torch.ops.cuda import fps as kfps
from graspnet_tpu_torch.ops.cuda import mlp_train as kmlp
from graspnet_tpu_torch.ops.cuda import query as kquery

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
    """N = MAX_POINTS (24,576) with the production cascade, every cluster
    size of stage 0 (the default, 1 and 2 on the 1024-thread variant, 4, 16)."""
    rng = np.random.default_rng(b)
    n = kfps.MAX_POINTS
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
    assert kernels.launches() == {"fps_chain": 1, "ball_query": 3, "sa1_fused": 1, "crop_fused": 1,
                                  "crop_group": 0, "crop_mlp_train": 0, "crop_mlp_train_backward": 0,
                                  "cylinder_query_multi": 0, "sa_feat_fused": 0, "multi_query": 0,
                                  "scatter_add_rows": 0, "scatter_plan": 0}
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
    counts = kernels.launches()
    assert (counts["fps_chain"], counts["sa1_fused"], counts["ball_query"], counts["crop_fused"]) == \
        (1, int(fused), 3 + (not fused), 1), counts
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
