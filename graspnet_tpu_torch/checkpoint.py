"""Checkpoints: the port's own torch-format save / restore, the reference's
published `.tar` weights, and weights to and from the JAX package's params
pytree.

`save` / `restore` write and read a torch file atomically (a temporary file,
then `os.replace`): the training CLI's state (`Trainer.state_dict()`) or a
bare GraspNet state dict.  They replace the JAX package's orbax path
(`graspnet_tpu/checkpoint.py:114-130`).  `load_torch_checkpoint` reads a
reference checkpoint (`{epoch, optimizer_state_dict, loss,
model_state_dict}`, reference train.py:211-219) and
`convert_torch_state_dict` maps its module names onto the port's
(`graspnet_tpu/checkpoint.py:1-108`), asserting every name and shape.

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

import os
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


# ------------------------------------------------ the port's own format --


def save(path: str, payload: Any) -> None:
    """torch.save `payload` to `path` atomically: a reader sees the old file
    or the whole new one, never a part."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore(path: str) -> Any:
    """What `save` wrote, with every tensor on the CPU."""
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


# ------------------------------------------------ reference checkpoints --
#
# Reference module tree -> the port's state-dict names (which mirror the JAX
# params pytree, so the map is graspnet_tpu/checkpoint.py's):
#   view_estimator.backbone.sa{k}.mlp_module.layer{i}.conv.weight -> backbone.sa{k}.mlp.{i}.kernel
#   ...layer{i}.bn.bn.{weight,bias,running_mean,running_var}      -> ...mlp.{i}.bn.{scale,offset,mean,var}
#   view_estimator.backbone.fp{k}.mlp.layer{i}.*                  -> backbone.fp{k}.mlp.{i}.*
#   view_estimator.vpmodule.{conv1..3,bn1,bn2}                    -> approach.*
#   grasp_generator.crop.mlps.layer{i}.*                          -> crop.mlp.{i}.*
#   grasp_generator.{operation,tolerance}.{conv1..3,bn1,bn2}      -> operation / tolerance.*
# Torch conv weights are (out, in, 1[, 1]) and become (in, out) kernels.


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    w = np.asarray(w)
    while w.ndim > 2:
        if w.shape[-1] != 1:
            raise ValueError(f"not a 1x1 conv weight: {w.shape}")
        w = w[..., 0]
    return w.T.copy()


def _bn(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[prefix + ".weight"], "offset": sd[prefix + ".bias"],
            "mean": sd[prefix + ".running_mean"], "var": sd[prefix + ".running_var"]}


def _shared_mlp(sd: Dict[str, np.ndarray], prefix: str) -> list:
    layers = []
    while f"{prefix}.layer{len(layers)}.conv.weight" in sd:
        i = len(layers)
        layer: Dict[str, Any] = {"kernel": _conv_kernel(sd[f"{prefix}.layer{i}.conv.weight"])}
        if f"{prefix}.layer{i}.conv.bias" in sd:
            layer["bias"] = sd[f"{prefix}.layer{i}.conv.bias"]
        if f"{prefix}.layer{i}.bn.bn.weight" in sd:
            layer["bn"] = _bn(sd, f"{prefix}.layer{i}.bn.bn")
        layers.append(layer)
    if not layers:
        raise KeyError(f"no SharedMLP layers under '{prefix}'")
    return layers


def _conv_head(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for c in ("conv1", "conv2", "conv3"):
        out[c] = {"kernel": _conv_kernel(sd[f"{prefix}.{c}.weight"])}
        if f"{prefix}.{c}.bias" in sd:
            out[c]["bias"] = sd[f"{prefix}.{c}.bias"]
    for b in ("bn1", "bn2"):
        out[b] = _bn(sd, f"{prefix}.{b}")
    return out


def convert_torch_state_dict(sd: Dict[str, Any], cfg: GraspNetConfig = GraspNetConfig()) -> Dict[str, torch.Tensor]:
    """Reference model state dict -> state dict for GraspNet(cfg); a missing
    or misshapen leaf raises (`params_from_jax`)."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in sd.items()}
    if all(k.startswith("module.") for k in sd):  # DataParallel wrapping (reference train.py:215-218)
        sd = {k[len("module."):]: v for k, v in sd.items()}
    bb = "view_estimator.backbone"
    tree = {
        "backbone": {
            **{f"sa{k}": {"mlp": _shared_mlp(sd, f"{bb}.sa{k}.mlp_module")} for k in (1, 2, 3, 4)},
            **{f"fp{k}": {"mlp": _shared_mlp(sd, f"{bb}.fp{k}.mlp")} for k in (1, 2)},
        },
        "approach": _conv_head(sd, "view_estimator.vpmodule"),
        "crop": {"mlp": _shared_mlp(sd, "grasp_generator.crop.mlps")},
        "operation": _conv_head(sd, "grasp_generator.operation"),
        "tolerance": _conv_head(sd, "grasp_generator.tolerance"),
    }
    return params_from_jax(tree, cfg)


def load_torch_checkpoint(path: str, cfg: GraspNetConfig = GraspNetConfig()) -> Dict[str, torch.Tensor]:
    """A reference `.tar` checkpoint -> state dict for GraspNet(cfg)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["model_state_dict"] if "model_state_dict" in ckpt else ckpt
    return convert_torch_state_dict(sd, cfg)
