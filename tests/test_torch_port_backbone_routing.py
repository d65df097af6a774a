"""The port's SA-stage routing and input channels against the JAX backbone,
and the general kNN against the JAX `knn`.

Same weights through `params_from_jax`, `GraspNetConfig.tiny()` variants,
on the CPU, where the JAX package takes its generic SA path: selections
(FPS and seed indices, top views) exactly equal, floats within 1e-5 (folded
BN and matmuls summed in another order, as `tests/test_torch_port_pipeline.py`
holds the whole forward).  The cases are the configurations the JAX gates
(`graspnet_tpu/models/backbone.py:70-119`) route away from the fused SA1
stage: `normalize_xyz=False` at SA1 and at SA2, a 2-layer SA1 MLP, and extra
input channels (`input_feature_dim=3`, in eval and in the train-mode
backbone forward with batch stats).  The kNN cases hold index for index,
with exact distance ties on coordinates whose squares are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.config import SAConfig as JSA
from graspnet_tpu.models import graspnet_forward
from graspnet_tpu.models.backbone import backbone_forward
from graspnet_tpu.ops.knn import knn as jknn

from graspnet_tpu_torch.checkpoint import params_from_jax
from graspnet_tpu_torch.config import GraspNetConfig, SAConfig
from graspnet_tpu_torch.models import GraspNet
from graspnet_tpu_torch.ops import knn

from tests.test_torch_port_checkpoint import jax_params
from tests.test_torch_port_pipeline import tabletop

ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variant(name: str):
    """(JAX config, port config) of one routing case."""
    base = JConfig.tiny()
    if name == "sa1_unnormalized":
        kw = {"sa1": dataclasses.replace(base.sa1, normalize_xyz=False)}
    elif name == "sa2_unnormalized":
        kw = {"sa2": dataclasses.replace(base.sa2, normalize_xyz=False)}
    elif name == "sa1_two_layer_mlp":
        kw = {"sa1": JSA(128, 0.04, 16, (3, 8, 16))}
    elif name == "input_features":
        kw = {"input_feature_dim": 3, "sa1": JSA(128, 0.04, 16, (6, 8, 8, 16))}
    else:
        raise KeyError(name)
    jcfg = dataclasses.replace(base, **kw)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields.update({k: SAConfig(**dataclasses.asdict(v)) for k, v in fields.items() if isinstance(v, JSA)})
    return jcfg, GraspNetConfig(**fields)


def _clouds(cfg: GraspNetConfig, seed: int = 0) -> np.ndarray:
    """Two clouds (a tabletop and a uniform box) with cfg.input_feature_dim
    extra RGB-like channels in [0, 1]."""
    rng = np.random.default_rng(seed)
    n = cfg.num_point
    xyz = np.stack([tabletop(rng, n), rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)])
    feats = rng.uniform(0, 1, (2, n, cfg.input_feature_dim)).astype(np.float32)
    return np.concatenate([xyz, feats], axis=-1)


def _model(jcfg, cfg, seed: int = 0):
    params = jax_params(jcfg, seed)
    model = GraspNet(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return params, model.eval()


CASES = ["sa1_unnormalized", "sa2_unnormalized", "sa1_two_layer_mlp", "input_features"]


@pytest.mark.parametrize("case", CASES)
def test_eval_forward_matches_jax(case):
    jcfg, cfg = _variant(case)
    params, model = _model(jcfg, cfg)
    clouds = _clouds(cfg)
    want = graspnet_forward(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(clouds), jcfg)
    with torch.no_grad():
        got = model(torch.from_numpy(clouds))
    for key in ("sa1_inds", "fp2_inds", "grasp_top_view_inds"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("input_xyz", "sa1_xyz", "sa2_xyz", "fp2_features", "objectness_score", "view_score",
                "grasp_score_pred", "grasp_width_pred"):
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=key)
    if cfg.input_feature_dim:
        np.testing.assert_array_equal(got["input_features"].numpy(), np.asarray(want["input_features"]))
    else:
        assert got["input_features"] is None and want["input_features"] is None


def _stat_errs(want, got):
    """Per BN layer of every stage: max |got - want| / max(1, max |want|)
    over the batch mean and variance."""
    return {f"{stage} {i} {k}": float(np.abs(np.asarray(g[k]) - np.asarray(w[k])).max()
                                      / max(1.0, float(np.abs(np.asarray(w[k])).max())))
            for stage in want for i, (w, g) in enumerate(zip(want[stage], got[stage])) for k in w}


@pytest.mark.parametrize("case", ["input_features", "sa2_unnormalized"])
def test_train_backbone_matches_jax(case):
    """The train-mode backbone: the FPS and ball-query indices it exports
    exactly equal; its features and batch stats within twice the band the
    JAX backbone moves by against itself with the two scenes of the batch
    swapped (the same math, batch-stat sums in another order).  Batch-stat
    BN divides by the batch std, so float noise grows to ~1e-4 at this size
    (measured: JAX against itself up to 7.4e-4, the port 1.3x that at most);
    1e-5 holds in eval mode only (`test_eval_forward_matches_jax`)."""
    jcfg, cfg = _variant(case)
    params, model = _model(jcfg, cfg, seed=1)
    clouds = _clouds(cfg, seed=1)
    jparams = jax.tree_util.tree_map(jnp.asarray, params["backbone"])
    wf, wxyz, wep = backbone_forward(jparams, jnp.asarray(clouds), jcfg, train=True)
    sf, _, sep = backbone_forward(jparams, jnp.asarray(clouds[::-1].copy()), jcfg, train=True)
    with torch.no_grad():
        gf, gxyz, gep = model.backbone(torch.from_numpy(clouds), train=True)
    np.testing.assert_array_equal(gep["sa1_inds"].numpy(), np.asarray(wep["sa1_inds"]))
    for stage in ("sa1", "sa2", "sa3", "sa4"):
        np.testing.assert_array_equal(gep["sa_query_idx"][stage].numpy(), np.asarray(wep["sa_query_idx"][stage]),
                                      err_msg=stage)
    np.testing.assert_array_equal(gxyz.numpy(), np.asarray(wxyz))
    wf = np.asarray(wf)
    band = float(np.abs(np.asarray(sf)[::-1] - wf).max())
    err = float(np.abs(gf.numpy() - wf).max())
    assert err <= max(2 * band, ATOL), (err, band)
    wstats = wep["bn_stats/backbone"]
    stat_band = max(_stat_errs(wstats, sep["bn_stats/backbone"]).values())
    stat_errs = _stat_errs(wstats, gep["bn_stats/backbone"])
    assert max(stat_errs.values()) <= max(2 * stat_band, ATOL), (stat_errs, stat_band)


def test_feature_channels_reach_sa1_only():
    """Features change SA1's pooled output, never the FPS chain: the same
    xyz with other feature values gives the same selections."""
    _, cfg = _variant("input_features")
    model = GraspNet(cfg).eval()
    clouds = _clouds(cfg)
    other = clouds.copy()
    other[..., 3:] = 1.0 - other[..., 3:]
    with torch.no_grad():
        a, b = model(torch.from_numpy(clouds)), model(torch.from_numpy(other))
    assert torch.equal(a["sa1_inds"], b["sa1_inds"]) and torch.equal(a["input_xyz"], b["input_xyz"])
    assert not torch.allclose(a["fp2_features"], b["fp2_features"])


def _lattice(rng, b, n):
    """Points on a 1/8 lattice: their squared distances are exact in f32,
    so ties are exact in both packages."""
    return (rng.integers(-8, 9, (b, n, 3)) / 8.0).astype(np.float32)


@pytest.mark.parametrize("k", [1, 3, 4, 5, 16])
def test_knn_matches_jax_with_ties(k):
    rng = np.random.default_rng(k)
    ref = _lattice(rng, 2, 60)
    ref[:, 30:40] = ref[:, 0:10]  # duplicate points: equal distances at distinct indices
    query = _lattice(rng, 2, 25)
    want = np.asarray(jknn(jnp.asarray(ref), jnp.asarray(query), k))
    got = knn(torch.from_numpy(ref), torch.from_numpy(query), k)
    assert got.dtype == torch.int64 and got.shape == (2, 25, k)
    np.testing.assert_array_equal(got.numpy(), want)
    # numpy's stable sort of the exact distances: ascending, earliest index first
    d2 = ((ref[:, None, :, :] - query[:, :, None, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=-1, kind="stable")
    np.testing.assert_array_equal(got.numpy(), order[..., :k])
    # the case holds ties at the k-th place: a tie broken the other way would show
    kth = np.take_along_axis(d2, order[..., k - 1:k + 1], axis=-1)
    assert (kth[..., 0] == kth[..., 1]).any()


def test_knn_random_clouds_match_jax():
    rng = np.random.default_rng(7)
    ref = rng.normal(size=(2, 200, 3)).astype(np.float32)
    query = rng.normal(size=(2, 40, 3)).astype(np.float32)
    for k in (2, 8):
        np.testing.assert_array_equal(knn(torch.from_numpy(ref), torch.from_numpy(query), k).numpy(),
                                      np.asarray(jknn(jnp.asarray(ref), jnp.asarray(query), k)))


# The eval SA routes of the port itself (no JAX): which path each stage
# takes, and the plain twin of the card's featured route.

def _backbone(cfg, seed: int = 0):
    """A `Backbone` with Kaiming kernels and every BN statistic and affine
    drawn away from the identity, so pre-activations of both signs reach
    every ReLU."""
    from graspnet_tpu_torch.models.backbone import Backbone
    from graspnet_tpu_torch.models.graspnet import init_weights

    bb = init_weights(Backbone(cfg), seed).eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in [*bb.named_parameters(), *bb.named_buffers()]:
            leaf = name.rsplit(".", 1)[-1]
            lo, hi = {"mean": (-0.1, 0.1), "var": (0.5, 2.0), "scale": (0.5, 1.5),
                      "offset": (-0.1, 0.1)}.get(leaf, (None, None))
            if lo is not None:
                p.copy_(lo + (hi - lo) * torch.rand(p.shape, generator=gen))
    return bb


def _route_config(name: str):
    from graspnet_tpu_torch.config import VoteNetConfig

    if name == "votenet":
        return VoteNetConfig.tiny()
    if name == "graspnet":
        return GraspNetConfig.tiny()
    return _variant(name)[1]


def _route_clouds(cfg, seed: int = 0) -> torch.Tensor:
    """Two clouds of cfg.num_point points in a 1.5 m box (VoteNet's radii
    reach 1.2 m) with cfg.input_feature_dim channels in [0, 1]."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.75, 0.75, (2, cfg.num_point, 3)).astype(np.float32)
    feats = rng.uniform(0, 1, (2, cfg.num_point, cfg.input_feature_dim)).astype(np.float32)
    return torch.from_numpy(np.concatenate([xyz, feats], axis=-1))


def _stage_inputs(bb, clouds):
    """Each SA stage's (stage, xyz, features, FPS inds) of one eval forward."""
    seen = []
    hooks = [stage.register_forward_pre_hook(lambda mod, args: seen.append((mod, *args[:3])))
             for stage in (bb.sa1, bb.sa2, bb.sa3, bb.sa4)]
    try:
        with torch.no_grad():
            bb(clouds)
    finally:
        for h in hooks:
            h.remove()
    return seen


def _previous_generic_path(stage, xyz, features, inds):
    """The backbone's eval generic path as it was before the route, verbatim."""
    from graspnet_tpu_torch import ops
    from graspnet_tpu_torch.nn.layers import fold_bn_eval, folded_mlp
    from graspnet_tpu_torch.ops.cuda import ball_query

    sa = stage.cfg
    new_xyz = ops.gather_points(xyz, inds)
    idx = ball_query(xyz, new_xyz, sa.radius, sa.nsample)
    grouped = ops.group_points(xyz, idx) - new_xyz[:, :, None, :]
    if sa.normalize_xyz:
        grouped = grouped / sa.radius
    if features is not None:
        grouped = torch.cat([grouped, ops.group_points(features, idx)], dim=-1)
    return new_xyz, idx, torch.amax(folded_mlp(fold_bn_eval(stage.mlp), grouped), dim=2)


@pytest.mark.parametrize("name", ["graspnet", "votenet", "input_features"])
def test_plain_twin_is_the_previous_generic_path(name):
    """At each stage with features, `sa_pool_plain` is bitwise the generic
    eval path it replaced, and so is the card route's sequence run through
    the wrappers' plain versions: `sa_group` (with the first layer where its
    contraction is <= 4, VoteNet's SA1), then per remaining layer
    `torch.matmul` and `sa_bias_relu`, pooling after the last."""
    from graspnet_tpu_torch.nn.layers import fold_bn_eval
    from graspnet_tpu_torch.ops.cuda.sa import MAX_FUSED_K, sa_bias_relu, sa_group, sa_pool, sa_pool_plain

    cfg = _route_config(name)
    bb = _backbone(cfg)
    featured = 0
    with torch.no_grad():
        for stage, xyz, features, inds in _stage_inputs(bb, _route_clouds(cfg)):
            if features is None:
                continue
            featured += 1
            new_xyz, idx, want = _previous_generic_path(stage, xyz, features, inds)
            folded = fold_bn_eval(stage.mlp)
            radius = stage.cfg.radius if stage.cfg.normalize_xyz else None
            assert torch.equal(sa_pool_plain(xyz, new_xyz, features, idx, folded, radius), want)
            assert torch.equal(sa_pool(xyz, new_xyz, features, idx, folded, radius), want)
            first = folded[0] if folded[0][0].shape[0] <= MAX_FUSED_K else None
            x = sa_group(xyz, new_xyz, features, idx, radius, first)
            rest = folded[1:] if first is not None else folded
            for i, (w, b) in enumerate(rest):
                x = sa_bias_relu(torch.matmul(x, w), b, pool=i == len(rest) - 1)
            assert torch.equal(x, want)
            assert (want == 0).any() and (want > 0).any()
    assert featured == (4 if name in ("votenet", "input_features") else 3)


ROUTES = {
    # (config, mode): the path of SA1-SA4; "sa_pool/k4" fuses a first layer of contraction <= 4
    ("graspnet", "eval"): ("sa1_fused", "sa_pool", "sa_pool", "sa_pool"),
    ("graspnet", "train"): ("train",) * 4,
    ("input_features", "eval"): ("sa_pool",) * 4,
    ("input_features", "train"): ("train",) * 4,
    ("sa1_unnormalized", "eval"): ("sa_pool_plain", "sa_pool", "sa_pool", "sa_pool"),
    ("sa1_two_layer_mlp", "eval"): ("sa_pool_plain", "sa_pool", "sa_pool", "sa_pool"),
    ("votenet", "eval"): ("sa_pool/k4", "sa_pool", "sa_pool", "sa_pool"),
    ("votenet", "train"): ("train",) * 4,
}


@pytest.mark.parametrize("case", list(ROUTES), ids=lambda c: "-".join(c))
def test_sa_route_table(case, monkeypatch):
    """Which path each SA stage takes, eval and train, with and without
    features: the fused SA1 kernel for an xyz-only stage inside its gate,
    the featured route `sa_pool` for every eval stage with features, the
    plain twin for an xyz-only stage outside the gate, and the plain
    grouping under the batch-stat MLP in training."""
    from graspnet_tpu_torch.models import backbone
    from graspnet_tpu_torch.ops.cuda.sa import MAX_FUSED_K

    name, mode = case
    cfg = _route_config(name)
    seen, plain = [], backbone.sa_pool_plain

    def recorder(label, fn):
        def call(*args):
            seen.append(label)
            return fn(*args)
        return call

    def pool(xyz, new_xyz, features, idx, folded, radius):
        seen.append("sa_pool/k4" if folded[0][0].shape[0] <= MAX_FUSED_K else "sa_pool")
        return plain(xyz, new_xyz, features, idx, folded, radius)

    monkeypatch.setattr(backbone, "sa1_fused", recorder("sa1_fused", backbone.sa1_fused))
    monkeypatch.setattr(backbone, "sa_pool", pool)
    monkeypatch.setattr(backbone, "sa_pool_plain", recorder("sa_pool_plain", backbone.sa_pool_plain))
    monkeypatch.setattr(backbone, "sa_group_plain", recorder("train", backbone.sa_group_plain))
    bb = _backbone(cfg)
    with torch.no_grad():
        bb(_route_clouds(cfg), train=mode == "train")
    assert tuple(seen) == ROUTES[case]
