"""The port's collision filter, voxel downsample and host NMS against the
JAX package, on the CPU.

* `collision_ious`, `collision_counts_blocked`, `detect_batch` and
  `ModelFreeCollisionDetector.detect` (all three return modes) on the
  cases of `tests/test_postproc.py` (the oracle scene, the blocked scan
  with a ragged last block, ragged batches with an empty group) plus empty
  groups and all-empty batches: masks and counts exactly equal to the JAX
  functions', IoUs within 1e-6 (float32 volumes and one division; the
  integer counts are equal).
* `postproc/voxel.py` bitwise the JAX copy; the host library's voxel
  downsample (its rows unordered: compared as sorted rows), grid and NMS
  bitwise the JAX package's `native`; the library NMS keeps the indices of
  its numpy plain version.
* The filter runs on the card unless asked for the CPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graspnet_tpu import native as jnative
from graspnet_tpu.postproc import GraspGroup as JGraspGroup
from graspnet_tpu.postproc import ModelFreeCollisionDetector as JDetector
from graspnet_tpu.postproc import voxel_down_sample as jvoxel
from graspnet_tpu.postproc.collision import collision_counts_blocked as jblocked
from graspnet_tpu.postproc.collision import collision_ious as jdense
from graspnet_tpu.postproc.collision import detect_batch as jdetect_batch

from graspnet_tpu_torch import native
from graspnet_tpu_torch.postproc import (
    GraspGroup,
    ModelFreeCollisionDetector,
    collision_counts_blocked,
    collision_ious,
    detect_batch,
    voxel_down_sample,
)
from graspnet_tpu_torch.postproc.nms import grasp_nms, grasp_nms_plain

from tests.test_postproc import collision_oracle, random_grasps

IOU_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small CPU work: the suite runs
    in several processes on shared cores, where idle parallel regions
    wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sorted_rows(a):
    a = np.asarray(a)
    return a[np.lexsort(a.T[::-1])]


def test_detector_matches_jax_and_the_oracle(rng):
    scene = rng.uniform(-0.3, 0.3, size=(2000, 3)).astype(np.float32)
    g = random_grasps(rng, 32)
    ours = ModelFreeCollisionDetector(scene, voxel_size=0.01, device="cpu")
    ref = JDetector(scene, voxel_size=0.01)
    np.testing.assert_array_equal(sorted_rows(ours.scene_points), sorted_rows(ref.scene_points))
    got = ours.detect(GraspGroup(g), approach_dist=0.05, collision_thresh=0.01)
    np.testing.assert_array_equal(got, ref.detect(JGraspGroup(g), approach_dist=0.05, collision_thresh=0.01))
    want, _ = collision_oracle(ref.scene_points, g, approach_dist=0.05, voxel_size=0.01, collision_thresh=0.01)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


@pytest.mark.parametrize("modes", [(True, False), (False, True), (True, True)], ids=["empty", "ious", "both"])
def test_detector_return_modes_match_jax(rng, modes):
    empty_grasp, ious = modes
    scene = rng.uniform(-0.3, 0.3, size=(1500, 3)).astype(np.float32)
    g = random_grasps(rng, 16)
    kw = dict(approach_dist=0.05, collision_thresh=0.01, return_empty_grasp=empty_grasp, return_ious=ious)
    got = ModelFreeCollisionDetector(scene, voxel_size=0.01, device="cpu").detect(GraspGroup(g), **kw)
    want = JDetector(scene, voxel_size=0.01).detect(JGraspGroup(g), **kw)
    assert len(got) == len(want) == 1 + empty_grasp + ious
    for a, b in zip(got[: 1 + empty_grasp], want[: 1 + empty_grasp]):  # the masks
        np.testing.assert_array_equal(a, b)
    if ious:
        for a, b in zip(got[-1], want[-1]):
            np.testing.assert_allclose(a, b, rtol=0, atol=IOU_TOL)
    # an empty group in the same mode
    none = ModelFreeCollisionDetector(scene, voxel_size=0.01, device="cpu").detect(
        GraspGroup(np.zeros((0, 17), np.float32)), **kw)
    assert [len(x) for x in none[: 1 + empty_grasp]] == [0] * (1 + empty_grasp)


def _grasp_arrays(rng, m):
    t = rng.uniform(-0.25, 0.25, (m, 3)).astype(np.float32)
    r = np.linalg.qr(rng.normal(size=(m, 3, 3)))[0].astype(np.float32)
    h = np.full(m, 0.02, np.float32)
    d = rng.choice([0.01, 0.02, 0.03, 0.04], m).astype(np.float32)
    w = rng.uniform(0.01, 0.1, m).astype(np.float32)
    return t, r, h, d, w


@pytest.mark.parametrize("n,m,block", [(700, 37, 256), (700, 37, 8192), (1, 5, 256), (0, 4, 256)])
def test_dense_and_blocked_match_jax(rng, n, m, block):
    """The dense form against the JAX dense form, the blocked form (a
    ragged last block when block does not divide n) against the JAX blocked
    form on the JAX test's sentinel-padded scene: counts exact, IoUs within
    IOU_TOL."""
    pts = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    arrays = _grasp_arrays(rng, m)
    kw = dict(approach_dist=0.05, voxel_size=0.01)
    got = collision_ious(*(torch.from_numpy(a) for a in (pts, *arrays)), **kw)
    want = jdense(*(jnp.asarray(a) for a in (pts, *arrays)), **kw)
    pts_p = np.full((max(1024, -(-n // 256) * 256), 3), 1e9, np.float32)
    pts_p[:n] = pts
    got_b = collision_counts_blocked(*(torch.from_numpy(a) for a in (pts, *arrays)), block=block, **kw)
    want_b = jblocked(*(jnp.asarray(a) for a in (pts_p, *arrays)), block=256, **kw)
    for ours, ref in ((got, want), (got_b, want_b)):
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]), rtol=0, atol=IOU_TOL)
        np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), rtol=0, atol=IOU_TOL)
        np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
    if n >= 700:
        assert got[2].sum() > 0  # the scene reaches some grippers


def test_detect_batch_matches_jax_and_per_frame(rng):
    """Ragged frames (cloud sizes and grasp counts, an empty group): the
    port's batch against the JAX batch and the port's per-frame detector."""
    clouds = [rng.uniform(-0.3, 0.3, size=(n, 3)).astype(np.float32) for n in (900, 2500, 4100, 1300)]
    arrays = [random_grasps(rng, m) for m in (32, 300, 0, 7)]
    kw = dict(voxel_size=0.01, approach_dist=0.05, collision_thresh=0.01)
    got = detect_batch(clouds, [GraspGroup(a) for a in arrays], device="cpu", **kw)
    want = jdetect_batch(clouds, [JGraspGroup(a) for a in arrays], **kw)
    assert len(got) == 4
    for cloud, a, mask, ref in zip(clouds, arrays, got, want):
        np.testing.assert_array_equal(mask, ref)
        det = ModelFreeCollisionDetector(cloud, voxel_size=0.01, device="cpu")
        np.testing.assert_array_equal(mask, det.detect(GraspGroup(a), approach_dist=0.05, collision_thresh=0.01))
    # downsampled on the host first, as apps/test.py does
    ds = [native.voxel_downsample(c, 0.01) for c in clouds]
    pre = detect_batch(ds, [GraspGroup(a) for a in arrays], device="cpu", pre_downsampled=True, **kw)
    for a, b in zip(pre, got):
        np.testing.assert_array_equal(a, b)


def test_detect_batch_all_empty_and_empty_list(rng):
    clouds = [rng.uniform(-0.3, 0.3, (500, 3)).astype(np.float32)] * 2
    groups = [GraspGroup(np.zeros((0, 17), np.float32))] * 2
    masks = detect_batch(clouds, groups, voxel_size=0.01, device="cpu")
    assert [m.shape for m in masks] == [(0,), (0,)]
    assert detect_batch([], [], voxel_size=0.01, device="cpu") == []
    with pytest.raises(ValueError):
        detect_batch(clouds, groups[:1], device="cpu")


def test_collision_runs_on_the_card_unless_asked_for_the_cpu(rng):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    cloud = rng.uniform(-0.3, 0.3, (500, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect_batch([cloud], [GraspGroup(random_grasps(rng, 3))])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelFreeCollisionDetector(cloud)


def test_collision_keeps_no_autograd_graph(rng):
    """The counts run under their own no-grad scope, whatever the calling
    thread's grad mode (apps/test.py calls them from worker threads)."""
    pts = torch.from_numpy(rng.uniform(-0.3, 0.3, (300, 3)).astype(np.float32)).requires_grad_(True)
    arrays = [torch.from_numpy(a) for a in _grasp_arrays(rng, 8)]
    with torch.enable_grad():
        for out in (collision_ious(pts, *arrays), collision_counts_blocked(pts, *arrays)):
            assert not any(t.requires_grad for t in out)


@pytest.mark.parametrize("n", [0, 1, 700, 20000])
def test_voxel_down_sample_bitwise_jax(rng, n):
    pts = (rng.normal(size=(n, 3)) * [0.2, 0.2, 0.05] + [0, 0, 0.5]).astype(np.float32)
    for voxel in (0.005, 0.01, 0.02):
        got, want = voxel_down_sample(pts, voxel), jvoxel(pts, voxel)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_native_voxel_downsample_matches_jax_native_and_plain(rng):
    pts = (rng.normal(size=(50000, 3)) * [0.2, 0.2, 0.05] + [0, 0, 0.5]).astype(np.float32)
    for voxel in (0.005, 0.01, 0.02):
        got = native.voxel_downsample(pts, voxel)
        np.testing.assert_array_equal(sorted_rows(got), sorted_rows(jnative.voxel_downsample(pts, voxel)))
    # the library takes the voxel as float32, numpy as float64: at a voxel
    # both represent exactly, the cells and the means are bitwise the same
    for voxel in (2.0**-8, 2.0**-7, 2.0**-6):
        got = native.voxel_downsample(pts, voxel)
        np.testing.assert_array_equal(sorted_rows(got), sorted_rows(voxel_down_sample(pts, voxel)))
    assert native.voxel_downsample(np.zeros((0, 3), np.float32), 0.01).shape == (0, 3)


def test_native_grid_build_matches_jax_native(rng):
    pts = rng.uniform(-0.5, 0.5, (30000, 3)).astype(np.float32)
    for cell in (0.02, 0.08):
        got, want = native.grid_build(pts, cell), jnative.grid_build(pts, cell)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert native.grid_build(pts.astype(np.float64), 0.08) is None  # the dtype rule, not a missing library
    empty = native.grid_build(np.zeros((0, 3), np.float32), 0.08)
    for a, b in zip(empty, jnative.grid_build(np.zeros((0, 3), np.float32), 0.08)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("m,spread", [(1, 0.1), (64, 0.05), (1024, 0.1), (300, 0.01)])
def test_host_nms_matches_jax_native_and_plain(rng, m, spread):
    g = random_grasps(rng, m)
    g[:, 13:16] *= spread / 0.2
    order = np.argsort(-g[:, 0], kind="stable")
    tt2, cos_rt = 0.03 * 0.03, np.cos(np.pi / 6)
    got = native.grasp_nms_fused(g[:, 13:16], g[:, 4:13], order, tt2, cos_rt)
    np.testing.assert_array_equal(got, jnative.grasp_nms_fused(g[:, 13:16], g[:, 4:13], order, tt2, cos_rt))
    np.testing.assert_array_equal(grasp_nms(g), got)
    np.testing.assert_array_equal(grasp_nms(g), grasp_nms_plain(g))
    close = rng.uniform(size=(m, m)) < 0.1
    np.testing.assert_array_equal(native.greedy_suppress(close, order), jnative.greedy_suppress(close, order))
    assert len(grasp_nms(np.zeros((0, 17), np.float32))) == 0
