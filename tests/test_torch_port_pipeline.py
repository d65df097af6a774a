"""The slice as a whole: the port's GraspPipeline(device="cpu") against the
JAX GraspPipeline, same weights (through params_from_jax) and same cloud.

End points: selections (FPS/seed indices, top views) exactly equal, floats
within f32 tolerance (atol 1e-5 at the features' unit scale: folded BN and
matmuls summed in another order).  Top-K rows: the selection fields (row
order, height, depth, centre, object id) equal, the floats allclose at 1e-5.
Where a near-tie in an argmax flips a selection, the failure message prints
the margin.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graspnet_tpu.apps.pipeline import GraspPipeline as JPipeline
from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.models import graspnet_forward

from graspnet_tpu_torch.apps import GraspPipeline
from graspnet_tpu_torch.checkpoint import params_from_jax
from graspnet_tpu_torch.config import GraspNetConfig

from tests.test_torch_port_checkpoint import jax_params

ATOL = 1e-5
SELECTION_COLS = [2, 3, 13, 14, 15, 16]


def tabletop(rng, n):
    table = np.stack([rng.uniform(-0.3, 0.3, n // 2), rng.uniform(-0.3, 0.3, n // 2),
                      np.full(n // 2, 0.55)], 1)
    blob = rng.normal([0.0, 0.0, 0.5], 0.05, (n - n // 2, 3))
    return np.concatenate([table, blob]).astype(np.float32)


def build(jcfg, cfg, seed=0):
    params = jax_params(jcfg, seed)
    ours = GraspPipeline(params_from_jax(params, cfg), cfg, device="cpu")
    ref = JPipeline(params=jax.tree_util.tree_map(jnp.asarray, params), cfg=jcfg)
    return params, ours, ref


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = JConfig.tiny(), GraspNetConfig.tiny()
    params, ours, ref = build(jcfg, cfg)
    rng = np.random.default_rng(0)
    clouds = np.stack([tabletop(rng, cfg.num_point), rng.uniform(-0.3, 0.3, (cfg.num_point, 3)).astype(np.float32)])
    return jcfg, params, ours, ref, clouds


def _margin(view_score, b, s):
    top2 = np.sort(view_score[b, s])[-2:]
    return float(top2[1] - top2[0])


def test_forward_end_points_match(tiny):
    jcfg, params, ours, _, clouds = tiny
    want = graspnet_forward(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(clouds), jcfg)
    got = ours.forward(torch.from_numpy(clouds))
    for key in ("fp2_inds", "sa1_inds", "grasp_top_view_inds"):
        w, g = np.asarray(want[key]), got[key].numpy()
        if key == "grasp_top_view_inds" and not np.array_equal(g, w):
            b, s = np.argwhere(g != w)[0]
            pytest.fail(f"top view flipped at scene {b} seed {s}: JAX view-score margin "
                        f"{_margin(np.asarray(want['view_score']), b, s)}")
        np.testing.assert_array_equal(g, w, err_msg=key)
    for key in ("sa1_xyz", "sa2_xyz", "fp2_xyz", "fp2_features", "objectness_score", "view_score",
                "grasp_top_view_score", "grasp_top_view_xyz", "grasp_top_view_rot", "grasp_score_pred",
                "grasp_angle_cls_pred", "grasp_width_pred", "grasp_tolerance_pred"):
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=key)


def _rows_match(got, want):
    assert want.shape[0] > 0, "the case must select some grasps"
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got[:, SELECTION_COLS], want[:, SELECTION_COLS])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("frame", [0, 1])
def test_get_grasps_topk_matches(tiny, frame):
    *_, ours, ref, clouds = tiny
    _rows_match(ours.get_grasps_topk(clouds[frame]).grasp_group_array,
                ref.get_grasps_topk(clouds[frame]).grasp_group_array)


def test_get_grasps_and_batch_match(tiny):
    *_, ours, ref, clouds = tiny
    for g, w in zip(ours.get_grasps_batch(clouds), ref.get_grasps_batch(clouds)):
        _rows_match(g.grasp_group_array, w.grasp_group_array)
    _rows_match(ours.get_grasps(clouds[1]).grasp_group_array, ref.get_grasps(clouds[1]).grasp_group_array)
    handle = ours.dispatch_grasps_batch(clouds)
    assert [len(g) for g in ours.finish_grasps_batch(handle)] == [len(g) for g in ref.get_grasps_batch(clouds)]


def test_run_matches_and_host_path(tiny):
    *_, ours, ref, clouds = tiny
    _rows_match(ours.run(clouds[0]).grasp_group_array, ref.run(clouds[0]).grasp_group_array)
    # no device NMS: decode -> sort -> host NMS -> top 20
    _rows_match(ours.run(clouds[0], nms=True, top_k=0).grasp_group_array[:20],
                ref.run(clouds[0], nms=True, top_k=0).grasp_group_array[:20])


def test_run_collision_filter_not_ported(tiny):
    """The collision filter is ported now: run(collision_thresh > 0) against
    the raw scene cloud keeps the JAX run's rows (the name predates the
    port of the filter)."""
    *_, ours, ref, clouds = tiny
    scene = np.concatenate([clouds[0], clouds[0] + np.float32(0.004)])
    got = ours.run(clouds[0], scene, collision_thresh=0.01)
    want = ref.run(clouds[0], scene, collision_thresh=0.01)
    assert ours.timings.collision_s > 0
    _rows_match(got.grasp_group_array, want.grasp_group_array)
    unfiltered = ours.run(clouds[0], nms=True, top_k=0)
    assert len(ours.run(clouds[0], scene, collision_thresh=0.01, top_k=0)) < len(unfiltered)


def test_sample_cloud_matches(tiny):
    *_, ours, ref, _ = tiny
    cloud = np.random.default_rng(1).normal(size=(700, 3)).astype(np.float32)
    for n in (700, 300):
        np.testing.assert_array_equal(ours.sample_cloud(cloud[:n]), ref.sample_cloud(cloud[:n]))


def test_warmup_and_random_weights():
    cfg = GraspNetConfig.tiny()
    p = GraspPipeline(cfg=cfg, seed=3, device="cpu")
    assert p.warmup() > 0
    q = GraspPipeline(cfg=cfg, seed=3, device="cpu")
    for (k, a), (_, b) in zip(p.model.state_dict().items(), q.model.state_dict().items()):
        assert torch.equal(a, b), k  # a seed fixes the weights


def test_default_device_raises_without_cuda():
    code = (
        "import torch, sys\n"
        "assert not torch.cuda.is_available()\n"
        "from graspnet_tpu_torch.apps import GraspPipeline\n"
        "from graspnet_tpu_torch.config import GraspNetConfig\n"
        "try:\n"
        "    GraspPipeline(cfg=GraspNetConfig.tiny())\n"
        "except RuntimeError as e:\n"
        "    sys.exit(0 if 'CUDA' in str(e) else 3)\n"
        "sys.exit(4)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_production_widths_b1():
    """GraspNetConfig() widths (1024 seeds, 300 views, 64-sample crops,
    full MLPs) at B=1, with the cloud cut to 4096 points to keep the CPU
    run short."""
    jcfg = JConfig(num_point=4096)
    cfg = GraspNetConfig(num_point=4096)
    _, ours, ref = build(jcfg, cfg, seed=1)
    cloud = tabletop(np.random.default_rng(2), 4096)
    _rows_match(ours.get_grasps_topk(cloud).grasp_group_array, ref.get_grasps_topk(cloud).grasp_group_array)
