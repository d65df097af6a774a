"""The MSG module library (`graspnet_tpu_torch/models/msg.py`) against the
JAX `graspnet_tpu/models/msg.py`, case by case after `tests/test_msg.py`.

Both get the same weights: the JAX `init_sa_msg` / `init_lfp_msg` draw, BN
statistics perturbed so the eval BN is not the identity, through
`checkpoint.module_params_from_jax`.  The inputs are `tests/test_msg.py`'s.
Selections (FPS and ball-query indices, and the centres they pick) are
exactly equal; features within FEATURE_ATOL x max(1, scale): the MLP's f32
sums in another order.  In train mode the batch statistics agree at the same
bound, and the gradients of sum(out) agree with `jax.grad` within GRAD_ATOL
x max(1, scale): batch-stat BN reduces over every row in another order than
XLA, as `tests/test_torch_port_train_step.py` derives for the model.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graspnet_tpu import ops as jops
from graspnet_tpu.models import msg as jmsg

from graspnet_tpu_torch import ops
from graspnet_tpu_torch.checkpoint import module_params_from_jax
from graspnet_tpu_torch.models.msg import LFPModuleMSG, SAModuleMSG

FEATURE_ATOL = 1e-5
GRAD_ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(b=2, n=64, c=7, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32), rng.normal(size=(b, n, c)).astype(np.float32)


def numpy_params(params, seed):
    """The JAX params as numpy, every BN's statistics and affine perturbed."""
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)

    def visit(tree):
        if isinstance(tree, dict):
            if set(tree) == {"scale", "offset", "mean", "var"}:
                for k, lo, hi in (("mean", -0.1, 0.1), ("var", 0.5, 2.0), ("scale", 0.5, 1.5), ("offset", -0.1, 0.1)):
                    tree[k] = rng.uniform(lo, hi, tree[k].shape).astype(np.float32)
            for v in tree.values():
                visit(v)
        elif isinstance(tree, list):
            for v in tree:
                visit(v)

    visit(params)
    return params


def port(module, params):
    module.load_state_dict(module_params_from_jax(params, module), strict=True)
    return module


def jtree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def close(got, want, atol=FEATURE_ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * max(1.0, float(np.abs(want).max())))


def t(x):
    return torch.from_numpy(np.array(x))


def test_sa_msg_shapes_and_scale_concat():
    xyz, feat = _data()
    params = numpy_params(jmsg.init_sa_msg(jax.random.PRNGKey(0), [(8, 16), (8, 32)], in_dim=7), 0)
    want_xyz, want, want_inds, _ = jmsg.sa_msg_forward(jtree(params), jnp.asarray(xyz), jnp.asarray(feat), npoint=16,
                                                       radii=(0.2, 0.4), nsamples=(8, 16))
    sa = port(SAModuleMSG([(8, 16), (8, 32)], in_dim=7, npoint=16, radii=(0.2, 0.4), nsamples=(8, 16)), params)
    with torch.no_grad():
        new_xyz, out, inds, stats = sa(t(xyz), t(feat))
    assert new_xyz.shape == (2, 16, 3) and out.shape == (2, 16, 16 + 32) and inds.shape == (2, 16)
    assert stats is None
    np.testing.assert_array_equal(inds.numpy(), np.asarray(want_inds))
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(want_xyz))
    close(out, want)


def test_sa_msg_single_scale_matches_jax_and_the_manual_compose():
    """One scale == ball query -> group -> centre-subtract -> MLP -> pool,
    with the JAX FPS indices passed in."""
    xyz, feat = _data(seed=1)
    params = numpy_params(jmsg.init_sa_msg(jax.random.PRNGKey(1), [(8, 16)], in_dim=7), 1)
    inds = jops.furthest_point_sample(jnp.asarray(xyz), 16)
    np.testing.assert_array_equal(ops.furthest_point_sample(t(xyz), 16).numpy(), np.asarray(inds))
    want_xyz, want, _, _ = jmsg.sa_msg_forward(jtree(params), jnp.asarray(xyz), jnp.asarray(feat), npoint=16,
                                               radii=(0.3,), nsamples=(8,), inds=inds)
    sa = port(SAModuleMSG([(8, 16)], in_dim=7, npoint=16, radii=(0.3,), nsamples=(8,)), params)
    with torch.no_grad():
        new_xyz, out, _, _ = sa(t(xyz), t(feat), inds=t(np.asarray(inds)).long())
        centers = ops.gather_points(t(xyz), t(np.asarray(inds)).long())
        idx = ops.ball_query(t(xyz), centers, 0.3, 8)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jops.ball_query(jnp.asarray(xyz), jnp.asarray(centers.numpy()), 0.3, 8)))
        grouped = torch.cat([ops.group_points(t(xyz), idx) - centers[:, :, None], ops.group_points(t(feat), idx)], -1)
        manual = torch.amax(sa.mlps[0](grouped), dim=2)
    close(out, want)
    np.testing.assert_array_equal(out.numpy(), manual.numpy())
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(want_xyz))


def test_sa_msg_votes_inds_passthrough():
    """The Votes contract: given indices are used and returned."""
    xyz, feat = _data(seed=2)
    params = numpy_params(jmsg.init_sa_msg(jax.random.PRNGKey(2), [(8,)], in_dim=7), 2)
    my_inds = np.tile(np.arange(16, dtype=np.int32)[None], (2, 1))
    _, want, _, _ = jmsg.sa_msg_forward(jtree(params), jnp.asarray(xyz), jnp.asarray(feat), npoint=16, radii=(0.3,),
                                        nsamples=(4,), inds=jnp.asarray(my_inds))
    sa = port(SAModuleMSG([(8,)], in_dim=7, npoint=16, radii=(0.3,), nsamples=(4,)), params)
    mine = t(my_inds).long()
    with torch.no_grad():
        new_xyz, out, inds_out, _ = sa(t(xyz), t(feat), inds=mine)
    assert inds_out is mine
    np.testing.assert_array_equal(new_xyz.numpy(), xyz[:, :16])
    close(out, want)


def test_sa_msg_group_all():
    """npoint=None == GroupAll: one group over every point, not centred."""
    xyz, feat = _data(seed=3)
    params = numpy_params(jmsg.init_sa_msg(jax.random.PRNGKey(3), [(8, 16)], in_dim=7), 3)
    _, want, _, _ = jmsg.sa_msg_forward(jtree(params), jnp.asarray(xyz), jnp.asarray(feat), npoint=None, radii=(),
                                        nsamples=())
    sa = port(SAModuleMSG([(8, 16)], in_dim=7, npoint=None), params)
    with torch.no_grad():
        new_xyz, out, inds, _ = sa(t(xyz), t(feat))
        manual = torch.amax(sa.mlps[0](torch.cat([t(xyz), t(feat)], -1)[:, None]), dim=2)
    assert new_xyz is None and inds is None and out.shape == (2, 1, 16)
    close(out, want)
    np.testing.assert_array_equal(out.numpy(), manual.numpy())


@pytest.mark.parametrize("normalize_xyz,use_xyz", [(False, True), (True, True), (False, False)],
                         ids=["default", "normalize_xyz", "no_xyz"])
def test_sa_msg_train_returns_stats_and_grads_flow(normalize_xyz, use_xyz):
    xyz, feat = _data(seed=4)
    params = numpy_params(jmsg.init_sa_msg(jax.random.PRNGKey(4), [(8,), (8,)], in_dim=7, use_xyz=use_xyz), 4)
    kw = dict(npoint=8, radii=(0.2, 0.5), nsamples=(4, 8), use_xyz=use_xyz, normalize_xyz=normalize_xyz)

    def jloss(p):
        _, out, _, stats = jmsg.sa_msg_forward(p, jnp.asarray(xyz), jnp.asarray(feat), train=True, **kw)
        return jnp.sum(out), (out, stats)

    (_, (jout, jstats)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jtree(params))
    sa = port(SAModuleMSG([(8,), (8,)], in_dim=7, **kw), params)
    _, out, _, stats = sa(t(xyz), t(feat), train=True)
    assert stats is not None and len(stats) == 2
    close(out, jout)
    for scale, jscale in zip(stats, jstats):
        for st, jst in zip(scale, jscale):
            close(st["mean"], jst["mean"])
            close(st["var"], jst["var"])
    torch.sum(out).backward()
    grads = {k: p.grad for k, p in sa.named_parameters()}
    assert any(float(g.norm()) > 0 for g in grads.values())
    for name, g in grads.items():  # mlps.k.i.kernel, mlps.k.i.bn.scale / offset: the JAX pytree paths
        want = jgrads
        for part in name.split("."):
            want = want[int(part)] if part.isdigit() else want[part]
        close(g, want, GRAD_ATOL)


def test_lfp_msg_shapes_and_skip_concat():
    xyz1, feat1 = _data(b=2, n=64, c=5, seed=5)
    xyz2, feat2 = _data(b=2, n=24, c=6, seed=6)
    params = numpy_params(jmsg.init_lfp_msg(jax.random.PRNGKey(5), [(8, 16)], (12,), in_dim=5, skip_dim=6), 5)
    lfp = port(LFPModuleMSG([(8, 16)], (12,), in_dim=5, skip_dim=6, radii=(0.4,), nsamples=(8,)), params)
    for skip in (feat2, np.zeros_like(feat2)):
        want, _ = jmsg.lfp_msg_forward(jtree(params), jnp.asarray(xyz2), jnp.asarray(xyz1), jnp.asarray(skip),
                                       jnp.asarray(feat1), radii=(0.4,), nsamples=(8,))
        with torch.no_grad():
            out, stats = lfp(t(xyz2), t(xyz1), t(skip), t(feat1))
        assert out.shape == (2, 24, 12) and stats is None
        close(out, want)
    # the skip features enter before the post MLP: zeroing them changes the output
    with torch.no_grad():
        assert not torch.allclose(lfp(t(xyz2), t(xyz1), t(feat2), t(feat1))[0],
                                  lfp(t(xyz2), t(xyz1), torch.zeros_like(t(feat2)), t(feat1))[0])


def test_lfp_msg_two_scales_in_train_mode():
    """Two scales share the post MLP; train mode returns each scale's MLP
    stats, then the post MLP's, as the JAX list."""
    xyz1, feat1 = _data(b=2, n=64, c=5, seed=7)
    xyz2, feat2 = _data(b=2, n=24, c=6, seed=8)
    params = numpy_params(jmsg.init_lfp_msg(jax.random.PRNGKey(7), [(8, 16), (8, 16)], (12,), in_dim=5, skip_dim=6), 7)
    want, jstats = jmsg.lfp_msg_forward(jtree(params), jnp.asarray(xyz2), jnp.asarray(xyz1), jnp.asarray(feat2),
                                        jnp.asarray(feat1), radii=(0.2, 0.4), nsamples=(4, 8), train=True)
    lfp = port(LFPModuleMSG([(8, 16), (8, 16)], (12,), in_dim=5, skip_dim=6, radii=(0.2, 0.4), nsamples=(4, 8)),
               params)
    out, stats = lfp(t(xyz2), t(xyz1), t(feat2), t(feat1), train=True)
    assert out.shape == (2, 24, 24) and len(stats) == len(jstats) == 4
    close(out, want)
    for mlp_stats, jmlp in zip(stats, jstats):
        for st, jst in zip(mlp_stats, jmlp):
            close(st["mean"], jst["mean"])
            close(st["var"], jst["var"])


def test_module_params_from_jax_rejects_other_widths():
    params = numpy_params(jmsg.init_sa_msg(jax.random.PRNGKey(0), [(8, 16)], in_dim=7), 0)
    with pytest.raises(ValueError, match="SAModuleMSG expects"):
        module_params_from_jax(params, SAModuleMSG([(8, 32)], in_dim=7, npoint=4, radii=(0.2,), nsamples=(4,)))
    with pytest.raises(ValueError, match="missing"):
        module_params_from_jax(params, SAModuleMSG([(8, 16), (8,)], in_dim=7, npoint=4, radii=(0.2, 0.3),
                                                nsamples=(4, 4)))
