"""Port parity: the plain versions of the multi-depth cylinder query (K8),
the per-query oracle (K10) and the single-depth cylinder query against the
JAX package, its Pallas kernels run in interpret mode as
`tests/test_pallas_query.py` runs them.

Inputs come from numpy seeds.  Every comparison is of indices and must be
exact (tolerance 0): random clouds put no point within a rounding of a
boundary, so XLA's FMA contraction on the CPU moves none.  Shapes stay
small (N <= 384, M <= 16), since the interpret-mode kernels run one program
per (scene, seed).  The kernels themselves are held against these plain
versions on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graspnet_tpu import ops as jops
from graspnet_tpu.ops.pallas.query import cylinder_query_multi_pallas, multi_query_pallas

from graspnet_tpu_torch import ops
from graspnet_tpu_torch.ops.cuda import query as kquery

from tests.test_torch_port_ops import random_rotations, t


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    b, n, m = 2, 384, 16
    xyz = rng.uniform(-0.3, 0.3, (b, n, 3)).astype(np.float32)
    centers = xyz[:, :m] + rng.normal(0, 0.01, (b, m, 3)).astype(np.float32)
    return xyz, centers, random_rotations(rng, (b, m))


def far_and_overfull(rng, n=300, m=8):
    """Scene 0's centres lie 10 m away (zero hits: all-zero rows); scene
    1's sit at the cloud's middle with a radius that holds it all (more
    than ns hits: the first ns in index order)."""
    xyz = rng.uniform(-0.2, 0.2, (2, n, 3)).astype(np.float32)
    centers = np.stack([np.full((m, 3), 10.0), np.zeros((m, 3))]).astype(np.float32)
    return xyz, centers, random_rotations(rng, (2, m))


def jax_args(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("hmax_list", [(0.01, 0.02, 0.03, 0.04), (0.04, 0.01, 0.03)])
def test_cylinder_query_multi_plain_matches_pallas(scene, hmax_list):
    xyz, centers, rot = scene
    args = (0.05, -0.02, hmax_list, 16)
    want = np.asarray(cylinder_query_multi_pallas(*jax_args(xyz, centers, rot), *args))
    got = kquery.cylinder_query_multi_plain(t(xyz), t(centers), t(rot), *args).numpy()
    np.testing.assert_array_equal(got, want)
    # the CPU wrapper and the ops entry point run the plain version
    np.testing.assert_array_equal(ops.cylinder_query_multi_depth(t(xyz), t(centers), t(rot), *args).numpy(), want)


def test_cylinder_query_multi_plain_empty_and_overfull():
    xyz, centers, rot = far_and_overfull(np.random.default_rng(12))
    args = (0.5, -0.5, (0.5, 0.1), 8)
    want = np.asarray(cylinder_query_multi_pallas(*jax_args(xyz, centers, rot), *args))
    got = kquery.cylinder_query_multi(t(xyz), t(centers), t(rot), *args).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 0).all()
    assert (got[1, :, 0] == np.arange(8)).all()  # every point is a hit: 0..7


@pytest.mark.parametrize("rotate", [True, False])
def test_multi_query_plain_matches_pallas(scene, rotate):
    xyz, centers, rot = scene
    m = 8  # interpret mode runs a program per seed
    hmax_list = (0.01, 0.02, 0.03, 0.04) if rotate else (0.0, 0.0)
    args = (0.05 if rotate else 0.1, -0.02 if rotate else 0.0, hmax_list, 16)
    want = np.asarray(multi_query_pallas(
        *jax_args(xyz, centers[:, :m]), jnp.asarray(rot[:, :m]) if rotate else None, *args, rotate=rotate))
    got = kquery.multi_query(t(xyz), t(centers[:, :m]), t(rot[:, :m]) if rotate else None,
                             *args, rotate=rotate).numpy()
    np.testing.assert_array_equal(got, want)


def test_multi_query_plain_empty_and_overfull():
    xyz, centers, rot = far_and_overfull(np.random.default_rng(13), m=4)
    for rotate, hmax_list in ((True, (0.5,)), (False, (0.0,))):
        args = (0.5, -0.5, hmax_list, 8)
        want = np.asarray(multi_query_pallas(
            *jax_args(xyz, centers), jnp.asarray(rot) if rotate else None, *args, rotate=rotate))
        got = kquery.multi_query_plain(t(xyz), t(centers), t(rot) if rotate else None, *args, rotate=rotate)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got[0] == 0).all()


@pytest.mark.parametrize("hmax", [0.02, 0.04])
def test_cylinder_query_single_depth_matches_jax(scene, hmax):
    xyz, centers, rot = scene
    args = (0.05, -0.02, hmax, 16)
    want = np.asarray(jops.cylinder_query(*jax_args(xyz, centers, rot), *args))
    got = ops.cylinder_query(t(xyz), t(centers), t(rot), *args).numpy()
    np.testing.assert_array_equal(got, want)
    # the single depth is the multi-depth query's column
    multi = kquery.cylinder_query_multi_plain(t(xyz), t(centers), t(rot), 0.05, -0.02, (hmax,), 16)
    np.testing.assert_array_equal(got, multi[:, :, 0].numpy())
