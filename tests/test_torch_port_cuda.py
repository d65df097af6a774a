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


@pytest.mark.parametrize("radius,ns", [(0.1, 32), (0.2, 16), (0.03, 64), (5.0, 8)])
def test_ball_query_matches_plain(dev, radius, ns):
    rng = np.random.default_rng(int(radius * 100) + ns)
    xyz = cloud(rng, 2, 2048).to(dev)
    centers = torch.cat([xyz[:, :500], torch.full((2, 12, 3), 9.0, device=dev)], dim=1)  # 12 with no hits
    assert torch.equal(kquery.ball_query(xyz, centers, radius, ns),
                       kquery.ball_query_plain(xyz, centers, radius, ns))


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


def test_sa1_fused_matches_plain(dev):
    sa = GraspNetConfig().sa1
    xyz = cloud(np.random.default_rng(2), 2, 20000).to(dev)
    centers = xyz[:, :512]
    folded = folded_weights(sa.mlp, 1, dev)
    got = kcrop.sa1_fused(xyz, centers, folded, sa.radius, sa.nsample)
    want = kcrop.crop_fused_plain(xyz, centers, None, folded, sa.radius, 0.0, (0.0,),
                                  sa.nsample, 1.0 / sa.radius, True)[:, :, 0]
    assert_features_close(got, want)


def test_tiny_pipeline_card_matches_cpu_and_counts_launches(dev):
    from graspnet_tpu_torch.apps import GraspPipeline

    cfg = GraspNetConfig.tiny()
    clouds = np.random.default_rng(3).uniform(-0.3, 0.3, (2, cfg.num_point, 3)).astype(np.float32)
    card = GraspPipeline(cfg=cfg, seed=1)
    cpu = GraspPipeline(cfg=cfg, seed=1, device="cpu")
    kernels.reset_launches()
    got = card.get_grasps_topk_batch(clouds)
    assert kernels.launches() == {"fps_chain": 1, "ball_query": 3, "sa1_fused": 1, "crop_fused": 1}
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
    folded = folded_weights((3, 8, 12, 16), 0, dev)  # c2=12 does not divide 256
    with pytest.raises(ValueError):
        kcrop.sa1_fused(xyz.float(), xyz[:, :4].float(), folded, 0.1, 8)
