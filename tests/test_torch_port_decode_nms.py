"""Port parity: pred_decode, device NMS + top-K, host NMS and containers.

Both packages get identical inputs.  Keep masks, top-K order and selection
fields must be exactly equal; decoded floats are held at atol 1e-6 (the
rotation from the decoded angle differs by an ULP, see
test_torch_port_nn_geometry.py).  Cases: NaN scores, tied scores, K > Ns,
invalid rows, and deep suppression chains.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.models import pred_decode as jdecode
from graspnet_tpu.postproc import nms as jnms
from graspnet_tpu.postproc.grasp import GraspGroup as JGraspGroup

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.models import pred_decode
from graspnet_tpu_torch.postproc import GraspGroup, grasp_nms, nms_keep_mask, nms_top_k

from tests.test_torch_port_ops import t


def random_rows(rng, ns, spread=0.05):
    """(ns, 17) grasp rows clustered so that NMS suppresses many."""
    q, _ = np.linalg.qr(rng.normal(size=(ns // 4 + 1, 3, 3)))
    rot = q[rng.integers(0, len(q), ns)] + rng.normal(0, 0.05, (ns, 3, 3))
    g = np.zeros((ns, 17), np.float32)
    g[:, 0] = rng.uniform(0, 1, ns)
    g[:, 1] = rng.uniform(0, 0.1, ns)
    g[:, 2] = 0.02
    g[:, 3] = 0.01 * rng.integers(1, 5, ns)
    g[:, 4:13] = rot.reshape(ns, 9)
    g[:, 13:16] = rng.uniform(-spread, spread, (ns, 3))
    g[:, 16] = -1
    return g


def end_points(rng, b=2, ns=32, a=12, d=4, v=60):
    ep = {
        "grasp_score_pred": rng.normal(size=(b, ns, a, d)),
        "grasp_angle_cls_pred": rng.normal(size=(b, ns, a, d)),
        "grasp_width_pred": rng.uniform(0, 0.1, (b, ns, a, d)),
        "grasp_tolerance_pred": rng.uniform(0, 0.05, (b, ns, a, d)),
        "fp2_xyz": rng.uniform(-0.3, 0.3, (b, ns, 3)),
        "grasp_top_view_xyz": rng.normal(size=(b, ns, 3)),
        "objectness_score": rng.normal(size=(b, ns, 2)),
    }
    ep = {k: x.astype(np.float32) for k, x in ep.items()}
    ep["grasp_top_view_xyz"][0, 0] = (0.0, 0.0, 1.0)  # degenerate vertical approach
    ep["grasp_angle_cls_pred"][1, 2, 3:5, 1] = 7.0  # tied angle logits: first wins
    ep["grasp_score_pred"][1, 3, :, 0:2] = 9.0  # tied depths for every angle
    return ep


@pytest.mark.parametrize("seed", [0, 1])
def test_pred_decode_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ep = end_points(rng)
    jg, jv = jdecode({k: jnp.asarray(x) for k, x in ep.items()}, JConfig())
    g, v = pred_decode({k: t(x) for k, x in ep.items()}, GraspNetConfig())
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    g, jg = g.numpy(), np.asarray(jg)
    sel = [2, 3, 13, 14, 15, 16]  # height, depth, centre, object id
    np.testing.assert_array_equal(g[..., sel], jg[..., sel])
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-6)


def _jax_keep(g, v):
    return np.asarray(jax.vmap(jnms.nms_keep_mask)(jnp.asarray(g), jnp.asarray(v)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_keep_mask_matches_jax(seed):
    rng = np.random.default_rng(seed)
    g = np.stack([random_rows(rng, 64), random_rows(rng, 64, spread=0.01)])
    v = rng.uniform(size=(2, 64)) < 0.8
    got = nms_keep_mask(t(g), t(v)).numpy()
    np.testing.assert_array_equal(got, _jax_keep(g, v))


def test_keep_mask_nan_and_tied_scores():
    rng = np.random.default_rng(7)
    g = random_rows(rng, 48, spread=0.01)[None]
    g[0, 3, 0] = np.nan
    g[0, 10, 0] = np.nan
    g[0, 20:30, 0] = 0.5  # ties: visit in ascending index
    v = np.ones((1, 48), bool)
    v[0, 5] = False
    np.testing.assert_array_equal(nms_keep_mask(t(g), t(v)).numpy(), _jax_keep(g, v))


def test_deep_suppression_chain():
    # grasps on a line 0.02 m apart, descending scores: keep alternates
    ns = 40
    g = random_rows(np.random.default_rng(0), ns)
    g[:, 4:13] = np.eye(3).reshape(9)
    g[:, 13:16] = 0
    g[:, 13] = np.arange(ns) * 0.02
    g[:, 0] = np.linspace(1, 0.1, ns)
    v = np.ones(ns, bool)
    got = nms_keep_mask(t(g[None]), t(v[None])).numpy()[0]
    np.testing.assert_array_equal(got, np.arange(ns) % 2 == 0)
    np.testing.assert_array_equal(got, _jax_keep(g[None], v[None])[0])


@pytest.mark.parametrize("k", [10, 50, 200])
def test_top_k_matches_jax(k):
    rng = np.random.default_rng(k)
    g = np.stack([random_rows(rng, 64), random_rows(rng, 64)])
    g[0, 7, 0] = np.nan
    g[1, 10:20, 0] = 0.25  # tied survivors come out in ascending index
    v = rng.uniform(size=(2, 64)) < 0.9
    jr, jm = jax.vmap(lambda a, b: jnms.nms_top_k(a, b, k=k))(jnp.asarray(g), jnp.asarray(v))
    rows, mask = nms_top_k(t(g), t(v), k=k)
    assert rows.shape == (2, min(k, 64), 17)  # K is clamped to Ns
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))


def test_top_k_all_invalid():
    g = random_rows(np.random.default_rng(3), 16)[None]
    rows, mask = nms_top_k(t(g), torch.zeros(1, 16, dtype=torch.bool), k=5)
    assert rows.shape == (1, 5, 17) and not mask.any()


@pytest.mark.parametrize("seed", [0, 1])
def test_host_grasp_nms_matches_jax(seed):
    g = random_rows(np.random.default_rng(seed), 200, spread=0.03)
    np.testing.assert_array_equal(grasp_nms(g), jnms.grasp_nms(g))


def test_host_nms_equals_device_top_k():
    rng = np.random.default_rng(5)
    g = random_rows(rng, 128, spread=0.02)
    host = GraspGroup(g).sort_by_score().nms()[:50].grasp_group_array
    rows, mask = nms_top_k(t(g[None]), torch.ones(1, 128, dtype=torch.bool), k=50)
    np.testing.assert_array_equal(rows[0][mask[0]].numpy(), host)


def test_grasp_group_matches_jax_containers():
    rng = np.random.default_rng(4)
    arr = random_rows(rng, 20)
    ours, ref = GraspGroup(arr.copy()), JGraspGroup(arr.copy())
    np.testing.assert_array_equal(ours.sort_by_score().grasp_group_array, ref.sort_by_score().grasp_group_array)
    np.testing.assert_array_equal(ours.nms().grasp_group_array, ref.nms().grasp_group_array)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (0.1, -0.2, 0.3)
    np.testing.assert_array_equal(ours.transform(T).grasp_group_array, ref.transform(T).grasp_group_array)
    g = ours[3]
    np.testing.assert_array_equal(g.to_matrix(), ref[3].to_matrix())
    assert (g.score, g.width, g.depth, g.object_id) == (ref[3].score, ref[3].width, ref[3].depth, ref[3].object_id)
    assert len(ours[2:5]) == 3 and len(ours.remove([0, 1])) == 18
    with pytest.raises(ValueError):
        GraspGroup(np.zeros((3, 16), np.float32))


def test_grasp_group_npy_roundtrip(tmp_path):
    arr = random_rows(np.random.default_rng(6), 5)
    path = str(tmp_path / "g.npy")
    GraspGroup(arr).save_npy(path)
    np.testing.assert_array_equal(GraspGroup.from_npy(path).grasp_group_array, arr)
