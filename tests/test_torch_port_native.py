"""The port's host label library (`graspnet_tpu_torch/native.py`, built from
its own copy of the C++ source, `csrc/host.cpp`) against the JAX package's
`graspnet_tpu.native` and against the numpy plain versions, bitwise, on
random clouds and label slabs.  Random coordinates have no exact distance
ties, except the duplicates placed on purpose, whose first index wins.
Also: the built library's name changes with what -march=native means, and a
failed build raises."""

import numpy as np
import pytest

from graspnet_tpu import native as jnative

from graspnet_tpu_torch import native
from graspnet_tpu_torch.data.camera import transform_point_cloud_np, visible_mask_plain
from graspnet_tpu_torch.ops.cuda import build
from graspnet_tpu_torch.train import label_pipeline as lp


def cloud(rng, n, near=0):
    pts = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    if near:
        pts[rng.choice(n, near, replace=False)] *= np.float32(1e-3)  # never picked by FPS
    pts[7] = pts[3]  # an exact duplicate
    return pts


@pytest.mark.parametrize("n,npoint,near", [(20000, 2048, 40), (5000, 1024, 0), (600, 128, 5), (300, 300, 30)])
def test_fps_matches_jax_native_and_numpy(n, npoint, near):
    """Above 4096 points the grid-pruned scan, below it the linear one."""
    pts = cloud(np.random.default_rng(n), n, near)
    got = native.fps(pts, npoint)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jnative.fps(pts, npoint))
    np.testing.assert_array_equal(got, lp.fps_numpy(pts, npoint))


def test_seed_chain_on_the_library_equals_numpy_chain():
    from graspnet_tpu_torch.config import GraspNetConfig

    cfg = GraspNetConfig.tiny()
    pts = cloud(np.random.default_rng(9), cfg.num_point, 4)
    inds, seeds = lp.seed_chain(pts, cfg)
    want_inds, want_seeds = lp.seed_chain(pts, cfg, fps=lp.fps_numpy)
    for k in want_inds:
        np.testing.assert_array_equal(inds[k], want_inds[k])
    np.testing.assert_array_equal(seeds, want_seeds)


@pytest.mark.parametrize("nq,nr", [(500, 9000), (300, 60), (1, 1)])
def test_nearest_matches_jax_native_and_numpy(nq, nr):
    rng = np.random.default_rng(nr)
    q = rng.uniform(-0.4, 0.4, (nq, 3)).astype(np.float32)
    r = rng.uniform(-0.4, 0.4, (nr, 3)).astype(np.float32)
    if nr > 100:
        r[100] = r[50]  # an exact duplicate: the first index wins
        q[0] = r[50]
    got = native.nearest(q, r)
    np.testing.assert_array_equal(got, jnative.nearest(q, r))
    np.testing.assert_array_equal(got, lp.nearest(q, r))
    if nr > 100:
        assert got[0] == 50


def slabs(rng, npo=30, v=12, a=6, d=4):
    s = rng.uniform(-0.2, 1.2, (npo, v, a, d)).astype(np.float32)
    offsets = rng.uniform(0, 0.15, (npo, v, a, d, 3)).astype(np.float32)
    s[3, 5] = 0.0  # no masked element: lmin inf, has False
    coll = rng.random(s.shape) < 0.2
    return s, offsets, coll


def test_label_view_stats_matches_jax_native_and_numpy():
    s, offsets, _ = slabs(np.random.default_rng(2))
    w = np.ascontiguousarray(offsets[..., 2])
    got = native.label_view_stats(s, w, 0.1)
    for g, j, p in zip(got, jnative.label_view_stats(s, w, 0.1), lp.label_view_stats(s, w, 0.1)):
        assert g.dtype == j.dtype == p.dtype
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("strided", [True, False])
def test_label_view_stats_masked_matches_jax_native_and_numpy(strided):
    """The width channel as the strided offsets[..., 2] view (stride 3) or
    contiguous; the plain version zeroes the collisions, then reduces."""
    s, offsets, coll = slabs(np.random.default_rng(3))
    w = offsets[..., 2] if strided else np.ascontiguousarray(offsets[..., 2])
    got = native.label_view_stats_masked(s, w, coll, 0.1)
    want_jax = jnative.label_view_stats_masked(s, w, coll, 0.1)
    want_plain = lp.label_view_stats(np.where(coll, 0.0, s).astype(np.float32), np.ascontiguousarray(w), 0.1)
    for g, j, p in zip(got, want_jax, want_plain):
        assert g.dtype == j.dtype == p.dtype
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("th", [0.004, 0.01])
def test_visible_mask_matches_jax_native_and_numpy(th):
    rng = np.random.default_rng(4)
    scene = rng.uniform(-0.1, 0.1, (3000, 3)).astype(np.float32)
    pts = rng.uniform(-0.04, 0.04, (500, 3)).astype(np.float32)
    pose = np.concatenate([np.eye(3), rng.uniform(-0.05, 0.05, (3, 1))], 1).astype(np.float32)
    trans = transform_point_cloud_np(pts, pose)
    got = native.visible_mask(scene, trans, th)
    np.testing.assert_array_equal(got, jnative.visible_mask(scene, trans, th))
    np.testing.assert_array_equal(got, visible_mask_plain(scene, trans, th))
    assert 0 < got.sum() < len(got)


def test_library_name_follows_the_cpu_and_a_failed_build_raises(tmp_path, monkeypatch):
    here = build._target(build.HOST)
    monkeypatch.setattr(build, "_native_target", lambda: b"-march= some-other-cpu")
    assert build._target(build.HOST) != here  # a library built for another CPU is not this one
    (tmp_path / "host.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="host.cpp failed"):
        build.load(build.HOST)
    assert not list((tmp_path / "_build").glob("*.so"))
