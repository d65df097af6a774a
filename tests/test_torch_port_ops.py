"""Port parity: the plain versions of the port's ops against the JAX package.

Inputs come from numpy seeds and go through both packages.  Selections
(FPS, ball- and cylinder-query indices) must be exactly equal.  The fused
crops are in test_torch_port_crop.py.  The CUDA kernels themselves are held
against these plain versions on the card (test_torch_port_cuda.py and
chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graspnet_tpu import ops as jops
from graspnet_tpu.models import heads as jheads
from graspnet_tpu.nn import layers as jnn
from graspnet_tpu.ops.pallas.fps import fps_chain_pallas, fps_pallas
from graspnet_tpu.ops.pallas.query import ball_query_pallas

from graspnet_tpu_torch import ops
from graspnet_tpu_torch.nn.layers import SharedMLP
from graspnet_tpu_torch.ops.cuda import fps as kfps
from graspnet_tpu_torch.ops.cuda import query as kquery


def make_cloud(rng, n=500, near_origin=5):
    pts = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    pts[rng.choice(n, near_origin, replace=False)] *= 1e-3  # FPS near-origin skip
    return pts


def t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def perturbed_mlp(dims, seed, eps=1e-5):
    """JAX SharedMLP params with non-trivial BN stats (so folding is
    exercised) and the port's SharedMLP loaded with the same values."""
    rng = np.random.default_rng(seed)
    layers = jnn.shared_mlp_init(jax.random.PRNGKey(seed), tuple(dims))
    for layer in layers:
        for k, lo, hi in (("mean", -0.1, 0.1), ("var", 0.5, 2.0),
                          ("scale", 0.5, 1.5), ("offset", -0.1, 0.1)):
            layer["bn"][k] = jnp.asarray(rng.uniform(lo, hi, layer["bn"][k].shape), jnp.float32)
    mlp = SharedMLP(dims, eps)
    with torch.no_grad():
        for jl, tl in zip(layers, mlp):
            tl.kernel.copy_(t(np.asarray(jl["kernel"])))
            for k in ("scale", "offset", "mean", "var"):
                getattr(tl.bn, k).copy_(t(np.asarray(jl["bn"][k])))
    return layers, mlp


def random_rotations(rng, shape):
    q, _ = np.linalg.qr(rng.normal(size=(*shape, 3, 3)))
    return q.astype(np.float32)


# ------------------------------------------------------------------ FPS --


class TestFPS:
    @pytest.mark.parametrize("n,npoint,near", [(500, 64, 5), (300, 100, 60), (64, 64, 0)])
    def test_matches_xla(self, n, npoint, near):
        rng = np.random.default_rng(n + npoint)
        pts = np.stack([make_cloud(rng, n, near), make_cloud(rng, n, near)])
        want = np.asarray(jops.furthest_point_sample(pts, npoint, use_pallas=False))
        got = ops.furthest_point_sample(t(pts), npoint).numpy()
        np.testing.assert_array_equal(got, want)

    def test_ties_and_duplicates(self):
        # a lattice has many equal distances and every point appears twice:
        # ties must go to the lowest index.  Multiples of 1/8 keep every d2
        # exact, so the ties are ties in any rounding (XLA on the CPU
        # contracts the distance sum into FMAs; the port does not)
        g = np.stack(np.meshgrid(*[np.arange(1, 5, dtype=np.float32) * 0.125] * 3), -1)
        pts = np.concatenate([g.reshape(-1, 3)] * 2)[None]
        want = np.asarray(jops.furthest_point_sample(pts, 40, use_pallas=False))
        got = ops.furthest_point_sample(t(pts), 40).numpy()
        np.testing.assert_array_equal(got, want)

    def test_all_near_origin(self):
        # no valid point: every selection falls back to index 0
        pts = np.full((1, 50, 3), 1e-3, np.float32)
        want = np.asarray(jops.furthest_point_sample(pts, 8, use_pallas=False))
        got = ops.furthest_point_sample(t(pts), 8).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got == 0).all()

    def test_near_origin_never_selected(self):
        pts = make_cloud(np.random.default_rng(4), n=100, near_origin=30)
        got = ops.furthest_point_sample(t(pts[None]), 50).numpy()[0]
        assert np.all(np.sum(pts**2, axis=1)[got[1:]] > 1e-3)

    def test_matches_fps_pallas_interpret(self):
        rng = np.random.default_rng(7)
        pts = np.stack([make_cloud(rng), make_cloud(rng)])
        want = np.asarray(fps_pallas(jnp.asarray(pts), 32))
        np.testing.assert_array_equal(ops.furthest_point_sample(t(pts), 32).numpy(), want)

    def test_chain_matches_fps_chain_pallas_interpret(self):
        rng = np.random.default_rng(8)
        pts = np.stack([make_cloud(rng, 300), make_cloud(rng, 300, near_origin=40)])
        npoints = (128, 24)
        want = fps_chain_pallas(jnp.asarray(pts), npoints)
        got = kfps.fps_chain(t(pts), npoints)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_chain_equals_sequential_stages(self):
        # the port always runs the chain (also where npoint is not a multiple
        # of 128): it must equal FPS + gather stage by stage
        rng = np.random.default_rng(9)
        pts = np.stack([make_cloud(rng, 400), make_cloud(rng, 400)])
        npoints = (100, 50, 20)
        got = kfps.fps_chain(t(pts), npoints)
        cur = pts
        for g, m in zip(got, npoints):
            want = np.asarray(jops.furthest_point_sample(cur, m, use_pallas=False))
            np.testing.assert_array_equal(g.numpy(), want)
            cur = np.take_along_axis(cur, want[..., None], axis=1)

    def test_gather_points(self):
        rng = np.random.default_rng(10)
        pts = rng.normal(size=(2, 30, 5)).astype(np.float32)
        idx = rng.integers(0, 30, (2, 7))
        want = np.asarray(jops.gather_points(jnp.asarray(pts), jnp.asarray(idx)))
        np.testing.assert_array_equal(ops.gather_points(t(pts), t(idx)).numpy(), want)


# -------------------------------------------------------------- queries --


class TestSelectFirstHits:
    @pytest.mark.parametrize("n,ns,density", [(300, 8, 0.05), (129, 16, 0.5), (40, 16, 0.0), (50, 4, 1.0)])
    def test_matches_jax(self, n, ns, density):
        from graspnet_tpu.ops.query import _select_first_hits

        rng = np.random.default_rng(n)
        mask = rng.uniform(size=(3, 5, n)) < density
        want = np.asarray(_select_first_hits(jnp.asarray(mask), ns))
        got = ops.select_first_hits(t(mask), ns).numpy()
        np.testing.assert_array_equal(got, want)


class TestBallQuery:
    @pytest.mark.parametrize("radius,nsample", [(0.04, 64), (0.1, 32), (0.3, 16)])
    def test_matches_xla(self, radius, nsample):
        rng = np.random.default_rng(int(radius * 100))
        pts = np.stack([make_cloud(rng, 400), make_cloud(rng, 400)])
        centers = pts[:, rng.choice(400, 64, replace=False)]
        want = np.asarray(jops.ball_query(pts, centers, radius, nsample, chunk=32, use_pallas=False))
        got = ops.ball_query(t(pts), t(centers), radius, nsample).numpy()
        np.testing.assert_array_equal(got, want)

    def test_empty_and_overfull(self):
        # alternating far (zero hits -> all 0) and central (overfull -> the
        # first nsample in index order) centers
        rng = np.random.default_rng(5)
        xyz = rng.uniform(-0.2, 0.2, (1, 256, 3)).astype(np.float32)
        centers = np.stack([np.full((3,), 10.0), np.zeros(3)] * 8, 0)[None].astype(np.float32)
        want = np.asarray(jops.ball_query(xyz, centers, 0.5, 8, use_pallas=False))
        got = kquery.ball_query_plain(t(xyz), t(centers), 0.5, 8).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[0, 0] == 0).all()
        np.testing.assert_array_equal(got[0, 1], np.arange(8))

    def test_matches_ball_query_pallas_interpret(self):
        rng = np.random.default_rng(3)
        xyz = rng.uniform(-0.3, 0.3, (2, 500, 3)).astype(np.float32)
        centers = xyz[:, :16] + rng.normal(0, 0.01, (2, 16, 3)).astype(np.float32)
        want = np.asarray(ball_query_pallas(jnp.asarray(xyz), jnp.asarray(centers), 0.1, 16))
        got = ops.ball_query(t(xyz), t(centers), 0.1, 16).numpy()
        np.testing.assert_array_equal(got, want)

    def test_group_points(self):
        rng = np.random.default_rng(11)
        pts = rng.normal(size=(2, 40, 6)).astype(np.float32)
        idx = rng.integers(0, 40, (2, 5, 3))
        want = np.asarray(jops.group_points(jnp.asarray(pts), jnp.asarray(idx)))
        np.testing.assert_array_equal(ops.group_points(t(pts), t(idx)).numpy(), want)


class TestCylinderQuery:
    @pytest.mark.parametrize("hmax_list", [(0.01, 0.02, 0.03, 0.04), (0.02, 0.04)])
    def test_matches_xla(self, hmax_list):
        rng = np.random.default_rng(len(hmax_list))
        xyz = rng.uniform(-0.3, 0.3, (2, 500, 3)).astype(np.float32)
        centers = xyz[:, :16] + rng.normal(0, 0.01, (2, 16, 3)).astype(np.float32)
        rot = random_rotations(rng, (2, 16))
        args = (0.05, -0.02, hmax_list, 16)
        want = np.asarray(jheads.cylinder_query_multi_depth(
            jnp.asarray(xyz), jnp.asarray(centers), jnp.asarray(rot), *args, chunk=16))
        got = ops.cylinder_query_multi_depth(t(xyz), t(centers), t(rot), *args).numpy()
        np.testing.assert_array_equal(got, want)

    def test_empty_and_overfull(self):
        rng = np.random.default_rng(6)
        xyz = rng.uniform(-0.3, 0.3, (2, 300, 3)).astype(np.float32)
        centers = np.stack([np.full((8, 3), 10.0), np.zeros((8, 3))]).astype(np.float32)
        rot = random_rotations(rng, (2, 8))
        args = (0.5, -0.5, (0.5,), 8)
        want = np.asarray(jheads.cylinder_query_multi_depth(
            jnp.asarray(xyz), jnp.asarray(centers), jnp.asarray(rot), *args, chunk=8))
        got = ops.cylinder_query_multi_depth(t(xyz), t(centers), t(rot), *args).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[0] == 0).all()


# ------------------------------------------------------------------ knn --


class TestThreeNN:
    def test_three_nn_matches_xla(self):
        rng = np.random.default_rng(12)
        unknown = rng.uniform(-0.5, 0.5, (2, 128, 3)).astype(np.float32)
        known = rng.uniform(-0.5, 0.5, (2, 64, 3)).astype(np.float32)
        known[:, 10] = known[:, 3]  # a duplicate: the lower index wins the tie
        jd, ji = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
        td, ti = ops.three_nn(t(unknown), t(known))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        # XLA on the CPU sums d2 as an FMA chain, the port as separate
        # mul/add (like the TPU kernels): the distances differ by an ULP
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=0)

    def test_three_interpolate_matches_xla(self):
        rng = np.random.default_rng(13)
        feat = rng.normal(size=(2, 64, 8)).astype(np.float32)
        idx = rng.integers(0, 64, (2, 100, 3))
        w = rng.uniform(size=(2, 100, 3)).astype(np.float32)
        want = np.asarray(jops.three_interpolate(jnp.asarray(feat), jnp.asarray(idx), jnp.asarray(w)))
        got = ops.three_interpolate(t(feat), t(idx), t(w)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)  # 3-term f32 sums


# ------------------------------------------------------- wrapper contract --


def test_cpu_wrappers_do_not_count_launches():
    from graspnet_tpu_torch.ops import cuda as kernels

    kernels.reset_launches()
    pts = t(make_cloud(np.random.default_rng(2), 200)[None])
    kfps.fps_chain(pts, (32, 16))
    kquery.ball_query(pts, pts[:, :8], 0.1, 4)
    rot = t(random_rotations(np.random.default_rng(3), (1, 8)))
    kquery.cylinder_query_multi(pts, pts[:, :8], rot, 0.05, -0.02, (0.02, 0.04), 4)
    kquery.multi_query(pts, pts[:, :8], None, 0.1, 0.0, (0.0,), 4, rotate=False)
    assert kernels.launches() == {"fps_chain": 0, "ball_query": 0, "sa1_fused": 0, "crop_fused": 0,
                                  "crop_group": 0, "crop_mlp_train": 0, "crop_mlp_train_backward": 0,
                                  "cylinder_query_multi": 0, "sa_feat_fused": 0, "multi_query": 0,
                                  "scatter_add_rows": 0, "scatter_plan": 0, "voxel_downsample": 0}
