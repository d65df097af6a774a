"""The reference's side of `correct` for the training cell: the recipe's
first steps in plain PyTorch, and the numbers that compare the program's
steps with them.

`follow` rebuilds the loader's batches of the epoch's first steps from the
same raw scene (`gn/data.py`, full labels), runs the plain model's
training forward, the loss, the backward, Adam and the BN running-stat
update from the same weights, and keeps each step's loss, the first step's
gradients, and the weights and the BN running means and variances after
the last step.

`compare` gives four numbers, the last three taken by the worst leaf:

- `loss_gap`: the widest relative gap of a step's loss;
- `grad_gap`: the first step's gradient as Adam got it (the program's
  first moment after one step over 1 - beta1), the gap between the two
  norms of a leaf over the larger of the reference's norm of that leaf
  and of the median leaf;
- `change_gap`: the same for each leaf's change over the steps followed;
- `bn_gap`: the same for each BN running mean's and variance's change
  over the steps followed (the buffers the step updates at the recipe's
  momentum, which neither the loss nor the gradients see).

Leaves whose reference gradient is under a thousandth of the median
leaf's (nought to rounding, such as a bias ahead of a batch norm) move
under Adam by round-off alone and are left out of `grad_gap` and
`change_gap`, by that rule.  Every running buffer counts in `bn_gap`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import gn
from .gn import data, layers, loss
from .judge import precision

BETA1 = 0.9
SMALL_GRAD = 1e-3  # of the median leaf's gradient norm: leaves left out


def _lr_at_epoch(tc: Dict[str, Any], epoch: int) -> float:
    lr = tc["learning_rate"]
    for e, r in zip(tc["lr_decay_epochs"], tc["lr_decay_rates"]):
        if epoch >= e:
            lr *= r
    return lr


def _bn_momentum_at_epoch(tc: Dict[str, Any], epoch: int, init: float = 0.5, floor: float = 0.001) -> float:
    return max(init * (tc["bn_decay_rate"] ** (epoch // tc["bn_decay_step"])), floor)


def _apply_bn_updates(model, end_points, momentum: float) -> None:
    bb = end_points["bn_stats/backbone"]
    for k in ("sa1", "sa2", "sa3", "sa4", "fp1", "fp2"):
        layers.shared_mlp_update_stats(getattr(model.backbone, k).mlp, bb[k], momentum)
    layers.shared_mlp_update_stats(model.crop.mlp, end_points["bn_stats/crop"], momentum)
    for mod in ("approach", "operation", "tolerance"):
        st = end_points[f"bn_stats/{mod}"]
        for b in ("bn1", "bn2"):
            layers.bn_update_running(getattr(getattr(model, mod), b), st[b], momentum)


def _device_batch(batch: Dict[str, Any], device) -> Dict[str, Any]:
    def t(a):
        x = torch.as_tensor(np.asarray(a))
        if not x.is_floating_point() and x.dtype != torch.bool:
            x = x.long()
        return x.to(device)

    return {k: ({s: t(a) for s, a in v.items()} if isinstance(v, dict) else t(v)) for k, v in batch.items()}


def follow(cfg_fields: Dict[str, Any], tc: Dict[str, Any], scene: Dict[str, Any], weights: Dict[str, torch.Tensor],
           frames: int, steps: int, device, prec: str = "float32", keep_scenes: int = 0) -> Dict[str, Any]:
    """The first `steps` steps of epoch 0.  `keep_scenes` > 0 keeps only
    that many scenes of each batch (a fault for the control's readings)."""
    from benchmark import harness

    cfg = harness.model_config(cfg_fields, gn)
    labels = data.SceneLabels(scene, cfg, cfg.num_point)
    model = gn.GraspNet(cfg)
    model.load_state_dict({k: v.to("cpu") for k, v in weights.items()}, strict=True)
    model = model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=_lr_at_epoch(tc, 0), betas=(BETA1, 0.999), eps=1e-8,
                           weight_decay=tc["weight_decay"])
    momentum = _bn_momentum_at_epoch(tc, 0)
    losses, grad = [], None
    batches = data.loader_batches(frames, tc["batch_size"])
    for k in range(steps):
        ids = batches[k][:keep_scenes] if keep_scenes else batches[k]
        batch = _device_batch(data.collate([labels.get_data_label(int(i)) for i in ids]), device)
        with precision(prec):
            ep = model(batch["point_clouds"], True, labels=batch)
            ep["objectness_label"] = batch["objectness_label"]
            value, _ = loss.get_loss(ep, cfg)
            opt.zero_grad(set_to_none=True)
            value.backward()
        if k == 0:
            grad = {n: q.grad.detach().to("cpu").clone() for n, q in model.named_parameters() if q.grad is not None}
        opt.step()
        with torch.no_grad():
            _apply_bn_updates(model, ep, momentum)
        losses.append(float(value.detach()))
        del ep, batch, value
    params = {n: q.detach().to("cpu").clone() for n, q in model.named_parameters()}
    buffers = {n: b.detach().to("cpu").clone() for n, b in model.named_buffers()}
    return {"losses": losses, "grad": grad, "params": params, "buffers": buffers}


def _worst_leaf(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], leaves) -> float:
    norms = {n: float(want[n].double().norm()) for n in leaves}
    median = float(np.median(list(norms.values())))
    worst = 0.0
    for n in leaves:
        g = float(got[n].double().norm()) if n in got else 0.0
        worst = max(worst, abs(g - norms[n]) / max(norms[n], median))
    return worst


def gradient_from_adam(exp_avg: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The first step's gradient as Adam got it: its first moment after one
    step is (1 - beta1) x the gradient."""
    return {n: m / (1.0 - BETA1) for n, m in exp_avg.items()}


def compare(got: Dict[str, Any], ref: Dict[str, Any], initial: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """`got`: the program's `losses`, `grad` (the first step's gradients),
    `params` and `buffers` (after the steps followed)."""
    lr, lp = np.asarray(ref["losses"], np.float64), np.asarray(got["losses"], np.float64)
    loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr))) if len(lp) == len(lr) else float("inf")
    rgrad = ref["grad"]
    gnorm = {n: float(g.double().norm()) for n, g in rgrad.items()}
    median = float(np.median(list(gnorm.values())))
    leaves = sorted(n for n, v in gnorm.items() if v >= SMALL_GRAD * median)
    grad_gap = _worst_leaf(got["grad"], rgrad, leaves)
    dp = {n: got["params"][n] - initial[n].to("cpu") for n in leaves}
    dr = {n: ref["params"][n] - initial[n].to("cpu") for n in leaves}
    change_gap = _worst_leaf(dp, dr, leaves)
    stats = sorted(ref["buffers"])
    db = {n: got["buffers"][n] - initial[n].to("cpu") for n in stats if n in got["buffers"]}
    dr = {n: ref["buffers"][n] - initial[n].to("cpu") for n in stats}
    bn_gap = _worst_leaf(db, dr, stats)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap, "bn_gap": bn_gap}
