"""Port parity: the plain fused SA2-4 stage (`sa_feat_fused_plain`, K9's
twin) against the JAX package's `sa_feat_fused_pallas` (interpret mode) and
its XLA `_sa_stage`, at `GraspNetConfig.tiny()` SA2.

The weights are the JAX package's, with randomized BN statistics, carried
into the port by `checkpoint.params_from_jax`.  Tolerances:
- against `sa_feat_fused_pallas`, 1e-5 x max(1, scale): the same
  arithmetic (BN folded into the weights, offsets x (1/r)) summed in
  another order;
- against `_sa_stage`, atol 1e-4, the JAX package's own bound for the same
  comparison (`tests/test_pallas_crop.py:209`): the XLA path divides the
  offsets by r and normalizes with the unfolded BN, ULP-level differences;
- the port's own eval `SAStage` (its generic path, which also divides by r)
  at the same 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graspnet_tpu import ops as jops
from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.models import init_graspnet
from graspnet_tpu.models.backbone import _sa_stage
from graspnet_tpu.ops.pallas.crop import sa_feat_fused_pallas

from graspnet_tpu_torch import ops
from graspnet_tpu_torch.checkpoint import params_from_jax
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.models import GraspNet
from graspnet_tpu_torch.nn.layers import fold_bn_eval
from graspnet_tpu_torch.ops.cuda import crop as kcrop

from tests.test_torch_port_ops import t

PALLAS_TOL = 1e-5  # x max(1, scale)
XLA_ATOL = 1e-4


@pytest.fixture(scope="module")
def sa2():
    """JAX params with randomized SA2 BN stats, the port's model loaded from
    them, and a tiny SA2 input: 128 SA1 points with 16-channel features."""
    cfg = GraspNetConfig.tiny()
    rng = np.random.default_rng(21)
    params = jax.tree_util.tree_map(np.asarray, init_graspnet(jax.random.PRNGKey(3), JConfig.tiny()))
    for layer in params["backbone"]["sa2"]["mlp"]:
        for k, lo, hi in (("mean", -0.1, 0.1), ("var", 0.5, 2.0), ("scale", 0.5, 1.5), ("offset", -0.1, 0.1)):
            layer["bn"][k] = rng.uniform(lo, hi, layer["bn"][k].shape).astype(np.float32)
    model = GraspNet(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    n, c = cfg.sa1.npoint, cfg.sa1.mlp[-1]
    xyz = rng.uniform(-0.3, 0.3, (2, n, 3)).astype(np.float32)
    feats = rng.normal(0, 1, (2, n, c)).astype(np.float32)
    inds = np.asarray(jops.furthest_point_sample(xyz, cfg.sa2.npoint, use_pallas=False))
    return cfg, params, model, xyz, feats, inds


def plain(cfg, model, xyz, new_xyz, feats):
    sa = cfg.sa2
    with torch.no_grad():
        return kcrop.sa_feat_fused(t(xyz), t(new_xyz), t(feats), fold_bn_eval(model.backbone.sa2.mlp),
                                   sa.radius, sa.nsample).numpy()


def close(got, want, tol):
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= tol * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("far", [0, 4])
def test_matches_sa_feat_fused_pallas(sa2, far):
    """`far` centres lie 10 m away: no hits, so every slot is point 0's
    offset (about 100 after x 1/r) and features."""
    cfg, params, model, xyz, feats, inds = sa2
    new_xyz = np.take_along_axis(xyz, inds[..., None], 1)[:, :16].copy()
    new_xyz[:, 16 - far:] = 10.0
    sa = cfg.sa2
    want = np.asarray(sa_feat_fused_pallas(
        jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(feats), params["backbone"]["sa2"]["mlp"],
        sa.radius, sa.nsample, cfg.bn_eps))
    got = plain(cfg, model, xyz, new_xyz, feats)
    assert got.shape == want.shape
    close(got, want, PALLAS_TOL)


def test_matches_xla_sa_stage_and_port_sa_stage(sa2):
    cfg, params, model, xyz, feats, inds = sa2
    new_xyz, want, *_ = _sa_stage(
        params["backbone"]["sa2"], JConfig.tiny().sa2, jnp.asarray(xyz), jnp.asarray(feats),
        train=False, eps=cfg.bn_eps, inds=jnp.asarray(inds))
    got = plain(cfg, model, xyz, np.asarray(new_xyz), feats)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=XLA_ATOL)
    with torch.no_grad():
        _, port, _, _ = model.backbone.sa2(t(xyz), t(feats), t(inds))
    np.testing.assert_allclose(got, port.numpy(), rtol=0, atol=XLA_ATOL)
    np.testing.assert_array_equal(ops.gather_points(t(xyz), t(inds)).numpy(), np.asarray(new_xyz))
