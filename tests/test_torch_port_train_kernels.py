"""Port parity of the training crop's two kernels, through their plain
versions (what the wrappers run on a CPU tensor):

* K6 `crop_group` (`crop_group_plain`) against the XLA front half of
  `crop_forward` (heads.py:219-232) and against `crop_group_pallas` in
  interpret mode.  Offsets are held at atol 1e-6: equal indices leave only
  the rotation's rounding (XLA on the CPU contracts offset @ R into FMAs,
  up to ~2.4e-7 here), while one index off would move an offset by
  centimetres.
* K7 `crop_mlp_train` (`crop_mlp_train_plain`) against
  `crop_mlp_train_pallas` in interpret mode and against the XLA path, at
  the JAX package's own tolerances (tests/test_mlp_train.py): pooled at
  atol 2e-5 x max(scale, 1), stats at 1e-5, every parameter gradient at
  atol 2e-4 x max(scale, 1); ties split evenly; no gradient to the grouped
  offsets.

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_port_cuda.py and chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graspnet_tpu import ops as jops
from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.models import heads as jheads
from graspnet_tpu.ops.pallas.crop import crop_group_pallas
from graspnet_tpu.ops.pallas.mlp_train import crop_mlp_train_pallas

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.nn.layers import SharedMLP, folded_mlp
from graspnet_tpu_torch.ops import cuda as kernels
from graspnet_tpu_torch.ops.cuda import crop as kcrop
from graspnet_tpu_torch.ops.cuda import mlp_train as kmlp

from tests.test_mlp_train import make_grouped, make_layers, xla_path
from tests.test_torch_port_ops import random_rotations, t

OFFSET_ATOL = 1e-6
EPS = 1e-5


# ------------------------------------------------------------------- K6 --


@pytest.fixture(scope="module")
def label_crop():
    """A tiny cloud, crop centres near its points (as label grasp points
    are) and random rotations."""
    cfg = GraspNetConfig.tiny()
    rng = np.random.default_rng(0)
    b, n, m = 2, cfg.num_point, 24
    xyz = rng.uniform(-0.3, 0.3, (b, n, 3)).astype(np.float32)
    centers = xyz[:, rng.choice(n, m, replace=False)] + rng.normal(0, 0.01, (b, m, 3)).astype(np.float32)
    centers[:, 0] = 5.0  # no hits at all: every slot is point 0
    rot = random_rotations(rng, (b, m))
    return cfg, xyz, centers.astype(np.float32), rot


def _ours(cfg, xyz, centers, rot):
    return kcrop.crop_group(t(xyz), t(centers), t(rot), cfg.cylinder_radius, cfg.hmin,
                            cfg.hmax_list, cfg.crop_nsample).numpy()


def test_crop_group_matches_xla_front_half(label_crop):
    cfg, xyz, centers, rot = label_crop
    jcfg = JConfig.tiny()
    idx = jheads.cylinder_query_multi_depth(
        jnp.asarray(xyz), jnp.asarray(centers), jnp.asarray(rot), jcfg.cylinder_radius,
        jcfg.hmin, jcfg.hmax_list, jcfg.crop_nsample)
    b, m, d, s = idx.shape
    grouped = jops.group_points(jnp.asarray(xyz), idx.reshape(b, m * d, s)).reshape(b, m, d, s, 3)
    grouped = grouped - jnp.asarray(centers)[:, :, None, None, :]
    want = np.asarray(jnp.einsum("bndsi,bnij->bndsj", grouped, jnp.asarray(rot)))
    got = _ours(cfg, xyz, centers, rot)
    assert got.shape == (b, m, len(cfg.hmax_list), cfg.crop_nsample, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=OFFSET_ATOL)


def test_crop_group_matches_pallas_interpret(label_crop):
    cfg, xyz, centers, rot = label_crop
    m = 8  # a slice of the centres keeps interpret mode quick
    want = np.asarray(crop_group_pallas(
        jnp.asarray(xyz), jnp.asarray(centers[:, :m]), jnp.asarray(rot[:, :m]),
        cfg.cylinder_radius, cfg.hmin, tuple(cfg.hmax_list), cfg.crop_nsample))
    got = _ours(cfg, xyz, centers[:, :m], rot[:, :m])
    np.testing.assert_allclose(got, want, rtol=0, atol=OFFSET_ATOL)


def test_crop_group_is_the_fused_crops_front_half(label_crop):
    # the fused eval crop = crop_group_plain -> folded MLP -> max, so both
    # kernels share one selection
    cfg, xyz, centers, rot = label_crop
    gen = torch.Generator().manual_seed(0)
    folded = [(torch.randn(a, c, generator=gen), torch.randn(c, generator=gen))
              for a, c in zip(cfg.crop_mlp[:-1], cfg.crop_mlp[1:])]
    fused = kcrop.crop_fused_plain(t(xyz), t(centers), t(rot), folded, cfg.cylinder_radius,
                                   cfg.hmin, tuple(cfg.hmax_list), cfg.crop_nsample)
    group = torch.from_numpy(_ours(cfg, xyz, centers, rot))
    torch.testing.assert_close(fused, torch.amax(folded_mlp(folded, group), dim=3), rtol=0, atol=0)


def test_crop_group_detaches_and_counts_no_cpu_launch(label_crop):
    cfg, xyz, centers, rot = label_crop
    kernels.reset_launches()
    c = t(centers).requires_grad_(True)
    out = kcrop.crop_group(t(xyz), c, t(rot), cfg.cylinder_radius, cfg.hmin, cfg.hmax_list,
                           cfg.crop_nsample)
    assert not out.requires_grad
    assert kernels.launches()["crop_group"] == 0


# ------------------------------------------------------------------- K7 --


def port_mlp(jlayers):
    dims = (3,) + tuple(int(l["kernel"].shape[1]) for l in jlayers)
    mlp = SharedMLP(dims, EPS)
    with torch.no_grad():
        for jl, layer in zip(jlayers, mlp):
            layer.kernel.copy_(t(np.asarray(jl["kernel"])))
            for k in ("scale", "offset", "mean", "var"):
                getattr(layer.bn, k).copy_(t(np.asarray(jl["bn"][k])))
    return mlp


def port_grads(mlp, grouped, w):
    pooled, _ = kmlp.crop_mlp_train(mlp, t(grouped))
    loss = torch.sum(pooled * t(w))
    params = [p for layer in mlp for p in (layer.kernel, layer.bn.scale, layer.bn.offset)]
    return torch.autograd.grad(loss, params)


def jax_grads(fn, jlayers, grouped, w):
    def loss(layers):
        p, _ = fn(layers, grouped)
        return jnp.sum(p * w)

    g = jax.grad(loss)(jlayers)
    return [np.asarray(x) for l in g for x in (l["kernel"], l["bn"]["scale"], l["bn"]["offset"])]


def assert_grads_close(got, want):
    for g, w in zip(got, want):
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-4 * scale)


def pallas_path(layers, grouped):
    return crop_mlp_train_pallas(layers, grouped, EPS, precision="highest")


@pytest.fixture(scope="module")
def mlp_case():
    rng = np.random.default_rng(0)
    jlayers = make_layers()  # gamma3[0] < 0: the min-pool branch
    grouped = make_grouped(rng)  # duplicated rows: pool ties
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (2, 8, 4, 32)))
    return jlayers, np.asarray(grouped), w


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_crop_mlp_train_forward(mlp_case, ref):
    jlayers, grouped, _ = mlp_case
    fn = xla_path if ref == "xla" else pallas_path
    p_ref, st_ref = fn(jlayers, jnp.asarray(grouped))
    with torch.no_grad():
        p_got, st_got = kmlp.crop_mlp_train(port_mlp(jlayers), t(grouped))
    scale = float(jnp.max(jnp.abs(p_ref)))
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_ref), rtol=0, atol=2e-5 * max(scale, 1.0))
    for a, b in zip(st_ref, st_got):
        for k in ("mean", "var"):
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_crop_mlp_train_param_grads(mlp_case, ref):
    jlayers, grouped, w = mlp_case
    fn = xla_path if ref == "xla" else pallas_path
    want = jax_grads(fn, jlayers, jnp.asarray(grouped), jnp.asarray(w))
    assert_grads_close(port_grads(port_mlp(jlayers), grouped, w), want)


def test_crop_mlp_train_tie_split():
    """Four identical samples per group: the gradient splits evenly across
    the pool group, as jnp.max's VJP (tests/test_mlp_train.py:129-144)."""
    rng = np.random.default_rng(1)
    jlayers = make_layers(negative_gamma=False)
    g0 = make_grouped(rng, s=4, with_ties=False)
    grouped = g0.at[:, :, :, 1:].set(g0[:, :, :, 0:1])
    w = jax.random.normal(jax.random.PRNGKey(7), (2, 8, 4, 32))
    want = jax_grads(xla_path, jlayers, grouped, w)
    assert_grads_close(port_grads(port_mlp(jlayers), np.asarray(grouped), np.asarray(w)), want)


def test_crop_mlp_train_grouped_gets_no_gradient(mlp_case):
    jlayers, grouped, _ = mlp_case
    dg = jax.grad(lambda g: jnp.sum(pallas_path(jlayers, g)[0]))(jnp.asarray(grouped))
    assert float(jnp.max(jnp.abs(dg))) == 0.0
    x = t(grouped).requires_grad_(True)
    pooled, stats = kmlp.crop_mlp_train(port_mlp(jlayers), x)
    (got,) = torch.autograd.grad(pooled.sum(), x, allow_unused=True)
    assert got is None  # detached: the zero cotangent of the JAX kernel
    assert all(not s[k].requires_grad for s in stats for k in s)
