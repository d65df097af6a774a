"""Port: `checkpoint.params_from_jax`, the JAX params pytree -> GraspNet
state dict, with shape checks and failure on a missing or extra leaf."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.models import init_graspnet

from graspnet_tpu_torch.checkpoint import params_from_jax
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.models import GraspNet


def jax_params(cfg: JConfig, seed: int = 0, perturb_bn: bool = True):
    """init_graspnet params as numpy, with BN stats perturbed as in
    tests/test_pallas_crop.py:19-24 so that BN folding is exercised."""
    params = jax.tree_util.tree_map(np.asarray, init_graspnet(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def visit(tree):
        if isinstance(tree, dict):
            if perturb_bn and set(tree) == {"scale", "offset", "mean", "var"}:
                for k, lo, hi in (("mean", -0.1, 0.1), ("var", 0.5, 2.0),
                                  ("scale", 0.5, 1.5), ("offset", -0.1, 0.1)):
                    tree[k] = rng.uniform(lo, hi, tree[k].shape).astype(np.float32)
            for k, v in tree.items():
                if "bias" == k:
                    tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
                else:
                    visit(v)
        elif isinstance(tree, list):
            for v in tree:
                visit(v)

    visit(params)
    return params


@pytest.fixture(scope="module")
def tiny_params():
    return jax_params(JConfig.tiny())


def test_round_trip_values_and_shapes(tiny_params):
    sd = params_from_jax(tiny_params, GraspNetConfig.tiny())
    model = GraspNet(GraspNetConfig.tiny())
    model.load_state_dict(sd, strict=True)
    msd = model.state_dict()
    assert set(msd) == set(sd)
    np.testing.assert_array_equal(msd["backbone.sa1.mlp.0.kernel"].numpy(),
                                  tiny_params["backbone"]["sa1"]["mlp"][0]["kernel"])
    np.testing.assert_array_equal(msd["backbone.fp2.mlp.1.bn.var"].numpy(),
                                  tiny_params["backbone"]["fp2"]["mlp"][1]["bn"]["var"])
    np.testing.assert_array_equal(msd["approach.conv3.bias"].numpy(), tiny_params["approach"]["conv3"]["bias"])
    np.testing.assert_array_equal(msd["tolerance.bn2.mean"].numpy(), tiny_params["tolerance"]["bn2"]["mean"])
    n_leaves = len(jax.tree_util.tree_leaves(tiny_params))
    assert len(sd) == n_leaves


@pytest.mark.parametrize("name", ["default", "tiny"])
def test_every_leaf_maps(name):
    jcfg = JConfig() if name == "default" else JConfig.tiny()
    cfg = GraspNetConfig() if name == "default" else GraspNetConfig.tiny()
    params = jax.eval_shape(lambda: init_graspnet(jax.random.PRNGKey(0), jcfg))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), params)
    sd = params_from_jax(zeros, cfg)
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in GraspNet(cfg).state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want


def test_missing_leaf_raises(tiny_params):
    p = copy.deepcopy(tiny_params)
    del p["crop"]["mlp"][1]["bn"]["var"]
    with pytest.raises(ValueError, match="missing.*crop.mlp.1.bn.var"):
        params_from_jax(p, GraspNetConfig.tiny())


def test_extra_leaf_raises(tiny_params):
    p = copy.deepcopy(tiny_params)
    p["operation"]["conv4"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="extra.*operation.conv4.kernel"):
        params_from_jax(p, GraspNetConfig.tiny())


def test_wrong_shape_raises(tiny_params):
    p = copy.deepcopy(tiny_params)
    p["approach"]["conv2"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="approach.conv2.kernel"):
        params_from_jax(p, GraspNetConfig.tiny())


def test_config_mismatch_raises(tiny_params):
    with pytest.raises(ValueError):
        params_from_jax(tiny_params, GraspNetConfig())


def test_accepts_jax_arrays(tiny_params):
    as_jax = jax.tree_util.tree_map(jnp.asarray, tiny_params)
    sd = params_from_jax(as_jax, GraspNetConfig.tiny())
    assert all(v.dtype == torch.float32 for v in sd.values())
