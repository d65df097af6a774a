"""Port parity, training branch of the building blocks: batch-stat BN and
SharedMLP, the running-stat update, the gradients of the gather ops, the
loss helpers of `models/geometry.py`, and `checkpoint.params_to_jax`.

Inputs come from numpy seeds and go through both packages.  Float32
tolerance: outputs and stats at atol 1e-5 (batch means and variances are
sums over all rows, taken in another order than XLA's); gradients of the
gathers at 1e-6 (scatter-adds of a few terms per row).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graspnet_tpu import ops as jops
from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.models import geometry as jgeom
from graspnet_tpu.nn import layers as jnn

from graspnet_tpu_torch import ops
from graspnet_tpu_torch.checkpoint import params_from_jax, params_to_jax
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.models import GraspNet, geometry
from graspnet_tpu_torch.nn import layers

from tests.test_torch_port_checkpoint import jax_params
from tests.test_torch_port_ops import perturbed_mlp, t

ATOL = 1e-5
GRAD_ATOL = 1e-6


def _np(x):
    return x.detach().numpy()


# ------------------------------------------------------------- BatchNorm --


@pytest.mark.parametrize("shape", [(2, 40, 16), (2, 8, 4, 6, 16)])
def test_batch_norm_train_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(0.3, 2.0, shape).astype(np.float32)
    jl, mlp = perturbed_mlp((3, 16), len(shape))
    bn = mlp[0].bn
    want, wst = jnn.batch_norm(jl[0]["bn"], jnp.asarray(x), train=True)
    got, st = bn.forward_train(t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(st["mean"]), np.asarray(wst["mean"]), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(_np(st["var"]), np.asarray(wst["var"]), rtol=1e-5, atol=ATOL)


def test_shared_mlp_train_matches_jax_and_leaves_buffers():
    rng = np.random.default_rng(0)
    dims = (19, 16, 16, 32)
    jl, mlp = perturbed_mlp(dims, 3)
    x = rng.normal(size=(2, 12, 8, 19)).astype(np.float32)
    before = {k: v.clone() for k, v in mlp.state_dict().items()}
    want, wstats = jnn.shared_mlp(jl, jnp.asarray(x), train=True)
    got, stats = mlp.forward_train(t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)
    assert len(stats) == len(wstats) == 3
    for s, w in zip(stats, wstats):
        for k in ("mean", "var"):
            np.testing.assert_allclose(_np(s[k]), np.asarray(w[k]), rtol=1e-5, atol=ATOL)
            assert not s[k].requires_grad
    # a train-mode forward updates no running stat
    for k, v in mlp.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_bn_update_running_matches_jax():
    rng = np.random.default_rng(1)
    jl, mlp = perturbed_mlp((3, 16, 8), 1)
    stats = [{"mean": rng.normal(size=c).astype(np.float32),
              "var": rng.uniform(0.1, 3, c).astype(np.float32)} for c in (16, 8)]
    momentum = 0.25 * 0.5 ** 3
    want = jnn.shared_mlp_update_stats(
        jl, [{k: jnp.asarray(v) for k, v in s.items()} for s in stats], jnp.float32(momentum))
    layers.shared_mlp_update_stats(mlp, [{k: t(v) for k, v in s.items()} for s in stats], momentum)
    for w, layer in zip(want, mlp):
        np.testing.assert_array_equal(_np(layer.bn.mean), np.asarray(w["bn"]["mean"]))
        np.testing.assert_array_equal(_np(layer.bn.var), np.asarray(w["bn"]["var"]))


# --------------------------------------------------------- op gradients --


def _vjp_close(jfn, tfn, args, cot, diff_args):
    """Gradients of <f(args), cot> w.r.t. the float args `diff_args`
    (positions), port (torch autograd) against JAX (jax.vjp)."""
    jargs = [jnp.asarray(a) for a in args]
    out, vjp = jax.vjp(lambda *fa: jfn(*[fa[diff_args.index(i)] if i in diff_args else jargs[i]
                                         for i in range(len(args))]),
                       *[jargs[i] for i in diff_args])
    want = vjp(jnp.asarray(cot))
    targs = [t(a) for a in args]
    for i in diff_args:
        targs[i].requires_grad_(True)
    got_out = tfn(*targs)
    np.testing.assert_allclose(_np(got_out), np.asarray(out), rtol=0, atol=1e-6)
    got = torch.autograd.grad(got_out, [targs[i] for i in diff_args], t(cot))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=GRAD_ATOL)


def test_gather_points_gradient():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(2, 50, 5)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 30)).astype(np.int64)  # repeats: scatter-add sums them
    cot = rng.normal(size=(2, 30, 5)).astype(np.float32)
    _vjp_close(jops.gather_points, ops.gather_points, (pts, idx), cot, [0])


def test_group_points_gradient():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(2, 40, 6)).astype(np.float32)
    idx = rng.integers(0, 40, (2, 12, 8)).astype(np.int64)
    cot = rng.normal(size=(2, 12, 8, 6)).astype(np.float32)
    _vjp_close(jops.group_points, ops.group_points, (pts, idx), cot, [0])


def test_three_interpolate_gradient():
    rng = np.random.default_rng(4)
    feat = rng.normal(size=(2, 20, 7)).astype(np.float32)
    idx = rng.integers(0, 20, (2, 33, 3)).astype(np.int64)
    w = rng.uniform(0, 1, (2, 33, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 33, 7)).astype(np.float32)
    _vjp_close(jops.three_interpolate, ops.three_interpolate, (feat, idx, w), cot, [0, 2])


# ---------------------------------------------------------------- geometry --


def test_huber_loss_matches_jax():
    x = np.random.default_rng(5).normal(0, 2, 500).astype(np.float32)
    for delta in (1.0, 0.3):
        np.testing.assert_array_equal(_np(geometry.huber_loss(t(x), delta)),
                                      np.asarray(jgeom.huber_loss(jnp.asarray(x), delta)))


@pytest.mark.parametrize("shape", [(3, 3), (3, 4), (4, 4)])
def test_transform_point_cloud_matches_jax(shape):
    rng = np.random.default_rng(6)
    cloud = rng.normal(size=(64, 3)).astype(np.float32)
    tf = rng.normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(_np(geometry.transform_point_cloud(t(cloud), t(tf))),
                               np.asarray(jgeom.transform_point_cloud(jnp.asarray(cloud), jnp.asarray(tf))),
                               rtol=0, atol=1e-6)


# -------------------------------------------------------------- checkpoint --


def test_params_to_jax_round_trip():
    params = jax_params(JConfig.tiny(), 2)
    sd = params_from_jax(params, GraspNetConfig.tiny())
    back = params_to_jax(sd)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (p, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(p))
    model = GraspNet(GraspNetConfig.tiny())
    model.load_state_dict(params_from_jax(back, GraspNetConfig.tiny()), strict=True)
