"""Port parity of the label pipeline and the loss.

* Host half (numpy): every function against its JAX-package twin on the
  same scenes, bitwise (the dicts of arrays equal, dtypes included).  The
  port's `fps_numpy`, `nearest` and `label_view_stats` are held against
  `graspnet_tpu.native`, whichever of its C++ library or numpy fallback
  that module picks on this host.
* Device half (torch): `process_grasp_labels`, `match_grasp_view_and_label`
  and `process_matched_labels` against JAX on identical inputs — equal but
  for the float32 log, which libraries round differently by an ULP (held at
  rtol 1e-6).
* Loss: `get_loss` against the JAX `get_loss` on the same end points
  (tests/test_train.py:77-103 builds them), the loss and every metric at
  rtol 1e-5 (sums of a few thousand float32 terms in another order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graspnet_tpu import native
from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.train import label_pipeline as jlp
from graspnet_tpu.train.loss import get_loss as jget_loss

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.train import label_pipeline as lp
from graspnet_tpu_torch.train.loss import get_loss

from tests.test_labels import make_scene
from tests.test_train import random_end_points
from tests.test_torch_port_ops import make_cloud, t

CFG, JCFG = GraspNetConfig.tiny(), JConfig.tiny()


def assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.default_rng(0)
    return [make_scene(rng, CFG, n_obj=n) for n in (3, 1)]


# --------------------------------------------------------------- host --


@pytest.mark.parametrize("n,npoint,near", [(600, 128, 5), (300, 300, 30)])
def test_fps_numpy_matches_native(n, npoint, near):
    pts = make_cloud(np.random.default_rng(n), n, near)
    np.testing.assert_array_equal(lp.fps_numpy(pts, npoint), native.fps(pts, npoint))


def test_nearest_matches_native():
    rng = np.random.default_rng(1)
    q = rng.uniform(-0.4, 0.4, (500, 3)).astype(np.float32)
    r = rng.uniform(-0.4, 0.4, (9000, 3)).astype(np.float32)  # two blocks of 8192
    r[100] = r[50]  # an exact duplicate: the first index wins
    q[:3] = r[50]
    got = lp.nearest(q, r)
    np.testing.assert_array_equal(got, native.nearest(q, r))
    assert (got[:3] == 50).all()


def test_label_view_stats_matches_native():
    rng = np.random.default_rng(2)
    s = rng.uniform(-0.2, 1.2, (30, 12, 6, 4)).astype(np.float32)
    w = rng.uniform(0, 0.15, s.shape).astype(np.float32)
    s[3, 5] = 0.0  # no masked element: lmin inf, has False
    for g, want in zip(lp.label_view_stats(s, w, 0.1), native.label_view_stats(s, w, 0.1)):
        assert g.dtype == want.dtype
        np.testing.assert_array_equal(g, want)


def test_seed_chain_matches_jax():
    cloud = make_cloud(np.random.default_rng(3), CFG.num_point, 4)
    got, seeds = lp.seed_chain(cloud, CFG)
    want, wseeds = jlp.seed_chain(cloud, JCFG)
    assert_dicts_equal(got, want)
    np.testing.assert_array_equal(seeds, wseeds)


def test_assign_views_matches_jax(scenes):
    pose = scenes[0][1][0]
    for g, w in zip(lp.assign_views(pose[:3, :3], CFG.num_view), jlp.assign_views(pose[:3, :3], JCFG.num_view)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("which", [0, 1])
def test_build_scene_labels_matches_jax(scenes, which):
    seed_xyz, poses, pts, scores, widths, tols = scenes[which]
    got = lp.build_scene_labels(None, seed_xyz, poses, pts, scores, widths, tols, CFG, max_objects=4)
    want = jlp.build_scene_labels(None, seed_xyz, poses, pts, scores, widths, tols, JCFG, max_objects=4)
    assert_dicts_equal(got, want)


@pytest.mark.parametrize("which", [0, 1])
def test_compact_host_phases_match_jax(scenes, which):
    seed_xyz, poses, pts, scores, widths, tols = scenes[which]
    ctx = lp.prepare_scene_labels(seed_xyz, poses, pts, scores, widths, tols, CFG, max_objects=4)
    jctx = jlp.prepare_scene_labels(seed_xyz, poses, pts, scores, widths, tols, JCFG, max_objects=4)
    for k in jlp.SceneLabelContext.__slots__:
        a, b = getattr(ctx, k), getattr(jctx, k)
        for x, y in (zip(a, b) if isinstance(b, list) else [(a, b)]):
            np.testing.assert_array_equal(x, y, err_msg=k)
    top = np.random.default_rng(which).integers(0, CFG.num_view, CFG.num_seed)
    assert_dicts_equal(lp.static_scene_labels(ctx, CFG), jlp.static_scene_labels(jctx, JCFG))
    assert_dicts_equal(lp.matched_scene_labels(ctx, top, CFG), jlp.matched_scene_labels(jctx, top, JCFG))
    assert_dicts_equal(lp.finalize_scene_labels(ctx, top, CFG), jlp.finalize_scene_labels(jctx, top, JCFG))


# ------------------------------------------------------------- device --


def _batch(scenes):
    labels = [lp.build_scene_labels(None, *s, CFG, max_objects=4) for s in scenes]
    return {k: np.stack([lab[k] for lab in labels]) for k in labels[0]}


def _torch(batch):
    return {k: t(v).long() if v.dtype == np.int32 else t(v) for k, v in batch.items()}


def test_process_and_match_labels_match_jax(scenes):
    batch = _batch(scenes)
    top = np.random.default_rng(4).integers(0, CFG.num_view, (2, CFG.num_seed))
    want = jlp.process_grasp_labels({}, {k: jnp.asarray(v) for k, v in batch.items()}, JCFG)
    want.update(jlp.match_grasp_view_and_label({**want, "grasp_top_view_inds": jnp.asarray(top)}, JCFG))
    got = lp.process_grasp_labels({}, _torch(batch), CFG)
    got.update(lp.match_grasp_view_and_label({**got, "grasp_top_view_inds": t(top)}, CFG))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0, err_msg=k)


def test_process_matched_labels_matches_jax(scenes):
    top = np.random.default_rng(5).integers(0, CFG.num_view, CFG.num_seed)
    ctxs = [lp.prepare_scene_labels(*s, CFG, max_objects=4) for s in scenes]
    fin = [lp.finalize_scene_labels(c, top, CFG) for c in ctxs]
    batch = {k: np.stack([f[k] for f in fin]) for k in fin[0]}
    batch["label_u_max"] = np.float32(max(c.scene_umax for c in ctxs))
    want = jlp.process_matched_labels({k: jnp.asarray(v) for k, v in batch.items()}, JCFG)
    got = lp.process_matched_labels({k: t(v) for k, v in batch.items()}, CFG)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0, err_msg=k)


# ---------------------------------------------------------------- loss --


@pytest.mark.parametrize("seed", [0, 1])
def test_get_loss_matches_jax(seed):
    ep = random_end_points(np.random.default_rng(seed), JCFG)
    want, wm = jget_loss({k: jnp.asarray(v) for k, v in ep.items()}, JCFG)
    got, gm = get_loss({k: t(v).long() if v.dtype == np.int32 else t(v) for k, v in ep.items()}, CFG)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_loss_gradient_flows_to_every_prediction():
    ep = {k: t(v).long() if v.dtype == np.int32 else t(v)
          for k, v in random_end_points(np.random.default_rng(2), JCFG).items()}
    preds = [k for k in ep if k.endswith("_pred") or k in ("objectness_score", "view_score")]
    for k in preds:
        ep[k].requires_grad_(True)
    loss, _ = get_loss(ep, CFG)
    grads = torch.autograd.grad(loss, [ep[k] for k in preds])
    for k, g in zip(preds, grads):
        assert torch.isfinite(g).all() and g.abs().sum() > 0, k
