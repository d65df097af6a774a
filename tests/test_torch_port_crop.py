"""Port parity: the plain fused crop (CloudCrop) and fused SA1 against the
JAX package's XLA paths and the interpret-mode `crop_fused_pallas`.

Features are held at atol 1e-5: BN folding reassociates (x @ W - mean) * s
into x @ (W * s) + b', and SA1 multiplies by 1/r where the XLA path divides
by r — ULP-level differences (graspnet_tpu/ops/pallas/crop.py:18-20).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graspnet_tpu import ops as jops
from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.models import heads as jheads
from graspnet_tpu.models.backbone import _sa_stage
from graspnet_tpu.ops.pallas.crop import crop_fused_pallas, fold_bn_eval as jfold

from graspnet_tpu_torch import ops
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.nn.layers import fold_bn_eval
from graspnet_tpu_torch.ops.cuda import crop as kcrop

from tests.test_torch_port_ops import perturbed_mlp, random_rotations, t

FEAT_ATOL = 1e-5


@pytest.fixture(scope="module")
def crop_scene():
    cfg = GraspNetConfig.tiny()
    jlayers, mlp = perturbed_mlp(cfg.crop_mlp, 0)
    rng = np.random.default_rng(0)
    b, n, m = 2, cfg.num_point, cfg.num_seed
    xyz = rng.uniform(-0.3, 0.3, (b, n, 3)).astype(np.float32)
    seeds = xyz[:, :m] + rng.normal(0, 0.005, (b, m, 3)).astype(np.float32)
    rot = random_rotations(rng, (b, m))
    return cfg, jlayers, mlp, xyz, seeds, rot


class TestCropFused:
    def _ours(self, cfg, mlp, xyz, seeds, rot):
        with torch.no_grad():
            return kcrop.crop_fused(
                t(xyz), t(seeds), t(rot), fold_bn_eval(mlp),
                cfg.cylinder_radius, cfg.hmin, cfg.hmax_list, cfg.crop_nsample,
            ).numpy()

    def test_matches_xla_crop_forward(self, crop_scene):
        cfg, jlayers, mlp, xyz, seeds, rot = crop_scene
        want, _ = jheads.crop_forward(
            {"mlp": jlayers}, jnp.asarray(seeds), jnp.asarray(xyz), jnp.asarray(rot), JConfig.tiny())
        got = self._ours(cfg, mlp, xyz, seeds, rot)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FEAT_ATOL)

    def test_empty_seed(self, crop_scene):
        # a seed far from the cloud: every depth pads with point 0.  The
        # offsets are ~10 m, so the features reach ~35 and the JAX package's
        # own check of this case holds them at atol 1e-4
        # (tests/test_pallas_crop.py:70)
        cfg, jlayers, mlp, xyz, seeds, rot = crop_scene
        far = np.full_like(seeds, 10.0)
        want, _ = jheads.crop_forward(
            {"mlp": jlayers}, jnp.asarray(far), jnp.asarray(xyz), jnp.asarray(rot), JConfig.tiny())
        got = self._ours(cfg, mlp, xyz, far, rot)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)

    def test_matches_crop_fused_pallas_interpret(self, crop_scene):
        cfg, jlayers, mlp, xyz, seeds, rot = crop_scene
        m = 8  # a slice of the seeds keeps interpret mode quick
        fw = tuple(x for pair in jfold(jlayers, cfg.bn_eps) for x in pair)
        want = crop_fused_pallas(
            jnp.asarray(xyz), jnp.asarray(seeds[:, :m]), jnp.asarray(rot[:, :m]), fw,
            cfg.cylinder_radius, cfg.hmin, tuple(cfg.hmax_list), cfg.crop_nsample)
        got = self._ours(cfg, mlp, xyz, seeds[:, :m], rot[:, :m])
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FEAT_ATOL)


class TestSA1Fused:
    def test_matches_xla_sa_stage(self):
        cfg = GraspNetConfig.tiny()
        sa = cfg.sa1
        jlayers, mlp = perturbed_mlp(sa.mlp, 1)
        rng = np.random.default_rng(1)
        xyz = rng.uniform(-0.3, 0.3, (2, cfg.num_point, 3)).astype(np.float32)
        inds = np.asarray(jops.furthest_point_sample(xyz, sa.npoint, use_pallas=False))
        _, want, *_ = _sa_stage(
            {"mlp": jlayers}, JConfig.tiny().sa1, jnp.asarray(xyz), None,
            train=False, eps=cfg.bn_eps, inds=jnp.asarray(inds))
        new_xyz = ops.gather_points(t(xyz), t(inds))
        with torch.no_grad():
            got = kcrop.sa1_fused(t(xyz), new_xyz, fold_bn_eval(mlp), sa.radius, sa.nsample).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FEAT_ATOL)
