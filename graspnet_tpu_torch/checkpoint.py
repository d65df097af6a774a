"""Weights to and from the JAX package's params pytree.

`params_from_jax` turns the JAX params (nested dicts/lists of numpy arrays,
e.g. `jax.tree_util.tree_map(np.asarray, params)`) into a state dict for
`models.GraspNet`.  The module's attribute names mirror the pytree, so a
state-dict key is the pytree path joined by dots
(`backbone.sa1.mlp.0.bn.scale`).  Every leaf is matched by name and shape
against the module built from `cfg`; a missing, extra or misshapen leaf
raises.  `params_to_jax` goes the other way, so tests can compare
parameters and gradients with the JAX package leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from graspnet_tpu_torch.config import GraspNetConfig


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def params_from_jax(params_np: Dict[str, Any], cfg: GraspNetConfig = GraspNetConfig()) -> Dict[str, torch.Tensor]:
    """JAX params pytree (numpy leaves) -> state dict for GraspNet(cfg)."""
    from graspnet_tpu_torch.models.graspnet import GraspNet

    with torch.device("meta"):
        expected = {k: tuple(v.shape) for k, v in GraspNet(cfg).state_dict().items()}
    got = dict(_leaves(params_np))
    missing = sorted(set(expected) - set(got))
    extra = sorted(set(got) - set(expected))
    if missing or extra:
        raise ValueError(f"params do not match GraspNet: missing {missing}, extra {extra}")
    state = {}
    for key, shape in expected.items():
        arr = np.asarray(got[key], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{key}: shape {arr.shape}, GraspNet expects {shape}")
        state[key] = torch.from_numpy(arr.copy())
    return state


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """GraspNet state dict (or gradients keyed the same way) -> the JAX
    params pytree with numpy leaves: the inverse of `params_from_jax`.  A
    key's integer parts are list indices (`mlp.0`), the rest dict keys."""
    tree: Dict[str, Any] = {}
    for key, value in state.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().numpy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)
