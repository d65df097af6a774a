"""Port parity: config, eval layers, BN folding and grasp geometry.

The config must equal the JAX package's field for field.  Layer outputs
are f32 products in another library: atol 1e-5 at unit-scale inputs.  The
Fibonacci views are computed in float64 then cast, so they are bitwise
equal.  Rotation matrices are allclose at 1e-6: XLA on the CPU contracts
the norms and the cross product into FMAs, the port (like the TPU kernels)
rounds every product, so entries differ by an ULP or two.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graspnet_tpu import config as jconfig
from graspnet_tpu.models import geometry as jgeom
from graspnet_tpu.nn import layers as jnn
from graspnet_tpu.ops.pallas.crop import fold_bn_eval as jfold

from graspnet_tpu_torch import config
from graspnet_tpu_torch.models import geometry
from graspnet_tpu_torch.nn import layers

from tests.test_torch_port_ops import perturbed_mlp, t


@pytest.mark.parametrize("name", ["default", "tiny"])
def test_config_matches_jax(name):
    ours = config.GraspNetConfig() if name == "default" else config.GraspNetConfig.tiny()
    ref = jconfig.GraspNetConfig() if name == "default" else jconfig.GraspNetConfig.tiny()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    assert ours.num_seed == ref.num_seed


@pytest.mark.parametrize("in_dim,out_dim", [(3, 8), (4, 5), (16, 12)])
def test_dense_matches_jax(in_dim, out_dim):
    rng = np.random.default_rng(in_dim)
    p = jnn.dense_init(jax.random.PRNGKey(in_dim), in_dim, out_dim)
    p["bias"] = jnp.asarray(rng.normal(size=out_dim), jnp.float32)
    x = rng.normal(size=(2, 7, in_dim)).astype(np.float32)
    want = np.asarray(jnn.dense(p, jnp.asarray(x)))
    d = layers.Dense(in_dim, out_dim)
    with torch.no_grad():
        d.kernel.copy_(t(np.asarray(p["kernel"])))
        d.bias.copy_(t(np.asarray(p["bias"])))
        got = d(t(x)).numpy()
    if in_dim <= 4:  # the broadcast-sum runs in the same order: bitwise
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_batch_norm_eval_matches_jax():
    rng = np.random.default_rng(0)
    jl, mlp = perturbed_mlp((3, 6), 3)
    bn = mlp[0].bn
    x = rng.normal(size=(4, 6)).astype(np.float32)
    want, _ = jnn.batch_norm(jl[0]["bn"], jnp.asarray(x), train=False)
    with torch.no_grad():
        got = bn(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def test_shared_mlp_matches_jax():
    rng = np.random.default_rng(1)
    jl, mlp = perturbed_mlp((5, 16, 8), 4)
    x = rng.normal(size=(2, 9, 5)).astype(np.float32)
    want, _ = jnn.shared_mlp(jl, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = mlp(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_fold_bn_eval_matches_jax_and_layers():
    rng = np.random.default_rng(2)
    jl, mlp = perturbed_mlp((3, 8, 16, 32), 5)
    with torch.no_grad():
        folded = layers.fold_bn_eval(mlp)
        for (w, b), (jw, jb) in zip(folded, jfold(jl, 1e-5)):
            np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(b.numpy(), np.asarray(jb)[0], rtol=1e-6, atol=1e-7)
        x = t(rng.normal(size=(5, 3)).astype(np.float32))
        np.testing.assert_allclose(
            layers.folded_mlp(folded, x).numpy(), mlp(x).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [300, 60, 7])
def test_grasp_views_bitwise(n):
    np.testing.assert_array_equal(
        geometry.generate_grasp_views(n).numpy(), np.asarray(jgeom.generate_grasp_views(n)))


def test_rotation_zero_angle_matches_jax():
    # the crop rotations: every approach view with a zero in-plane angle
    views = jgeom.generate_grasp_views_np(300)
    want = np.asarray(jgeom.batch_viewpoint_params_to_matrix(
        jnp.asarray(-views), jnp.zeros(300, jnp.float32)))
    got = geometry.batch_viewpoint_params_to_matrix(t(-views), torch.zeros(300)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_rotation_with_angles_and_degenerate():
    rng = np.random.default_rng(3)
    towards = rng.normal(size=(50, 3)).astype(np.float32)
    towards[0] = (0.0, 0.0, 1.0)  # vertical approach: y falls back to (0, 1, 0)
    towards[1] = (0.0, 0.0, -2.0)
    angle = rng.uniform(0, np.pi, 50).astype(np.float32)
    want = np.asarray(jgeom.batch_viewpoint_params_to_matrix(jnp.asarray(towards), jnp.asarray(angle)))
    got = geometry.batch_viewpoint_params_to_matrix(t(towards), t(angle)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.isfinite(got).all()
    # orthonormal rotations
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.broadcast_to(np.eye(3), got.shape), atol=1e-5)
