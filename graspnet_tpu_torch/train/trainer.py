"""Single-card Trainer: optimizer, schedules, the train and eval steps, and
the compact two-phase label path.

Counterpart of `graspnet_tpu/train/trainer.py` on one device.  Reference
recipe (train.py:26-41, 96-112): Adam lr 1e-3 with x0.1 step decay at
epochs 8/12/16, weight decay 0, batch 2, 18 epochs; BN momentum halves from
0.5 every 2 epochs with floor 0.001.  The optimizer is torch's own Adam,
whose weight decay is the coupled L2 that `adam_l2` reproduces in JAX
(trainer.py:65-74); the BN running stats are buffers, not parameters, so
neither the optimizer nor the decay touches them (trainer.py:52-62 masks
them by name).  They get the torch-style momentum update from the step's
batch stats after the optimizer step, in place.

Runs on the card unless the caller asks for the CPU.  The data- and
candidate-parallel branches of the JAX trainer are not ported here.  The
step is bitwise repeatable on the card: the differentiable gathers' backward
is the deterministic scatter-add (`ops/scatter.py`), not torch's atomic one.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.device import resolve_device
from graspnet_tpu_torch.models import GraspNet, init_weights
from graspnet_tpu_torch.nn.layers import bn_update_running, shared_mlp_update_stats
from graspnet_tpu_torch.train.label_pipeline import matched_scene_labels, static_scene_labels
from graspnet_tpu_torch.train.loss import get_loss


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    max_epoch: int = 18
    batch_size: int = 2
    lr_decay_epochs: Tuple[int, ...] = (8, 12, 16)
    lr_decay_rates: Tuple[float, ...] = (0.1, 0.1, 0.1)
    bn_decay_step: int = 2
    bn_decay_rate: float = 0.5
    bn_momentum_init: float = 0.5
    bn_momentum_min: float = 0.001
    # 'bfloat16' ships the three (B, Ns, V, A, D) label slabs of the full
    # path at half width and upcasts them on the card
    label_dtype: str = "float32"


def lr_at_epoch(tc: TrainConfig, epoch: int) -> float:
    """Step-decay schedule (reference train.py:102-112)."""
    lr = tc.learning_rate
    for e, r in zip(tc.lr_decay_epochs, tc.lr_decay_rates):
        if epoch >= e:
            lr *= r
    return lr


def bn_momentum_at_epoch(tc: TrainConfig, epoch: int) -> float:
    """BN momentum schedule (reference train.py:96-99)."""
    m = tc.bn_momentum_init * (tc.bn_decay_rate ** (epoch // tc.bn_decay_step))
    return max(m, tc.bn_momentum_min)


def apply_bn_updates(model: GraspNet, end_points: Dict[str, Any], momentum: float) -> None:
    """Fold a step's batch stats into the running BN buffers, in place."""
    bb = end_points["bn_stats/backbone"]
    for k in ("sa1", "sa2", "sa3", "sa4", "fp1", "fp2"):
        shared_mlp_update_stats(getattr(model.backbone, k).mlp, bb[k], momentum)
    shared_mlp_update_stats(model.crop.mlp, end_points["bn_stats/crop"], momentum)
    for mod in ("approach", "operation", "tolerance"):
        st = end_points[f"bn_stats/{mod}"]
        for b in ("bn1", "bn2"):
            bn_update_running(getattr(getattr(model, mod), b), st[b], momentum)


class Trainer:
    """Holds the model and the optimizer; runs train and eval steps."""

    _LABEL_SLABS = ("grasp_labels", "grasp_widths", "grasp_tolerance")

    def __init__(
        self,
        cfg: GraspNetConfig = GraspNetConfig(),
        tc: TrainConfig = TrainConfig(),
        params: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        """`params`: a GraspNet state dict (e.g. from
        `checkpoint.params_from_jax`); None draws seeded random weights."""
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device, "Trainer")
        model = GraspNet(cfg)
        if params is None:
            init_weights(model, seed)
        else:
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device)
        self.opt = torch.optim.Adam(
            self.model.parameters(), lr=tc.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=tc.weight_decay,
        )
        self.epoch = 0

    # -- epoch-level schedule ---------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        for group in self.opt.param_groups:
            group["lr"] = lr_at_epoch(self.tc, epoch)

    # -- checkpoint state ---------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The training state a resume needs: the model (parameters and BN
        running stats), Adam's moments and step counts, and the epoch."""
        return {"model": self.model.state_dict(), "optimizer": self.opt.state_dict(), "epoch": self.epoch}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore `state_dict()`'s output (tensors on any device); the
        parameters and Adam state come back bitwise.  Adam's state is
        copied: torch's optimizer would keep a same-device tensor it is
        given, and this trainer's steps would then change the caller's."""
        self.model.load_state_dict(state["model"], strict=True)
        self.opt.load_state_dict(copy.deepcopy(state["optimizer"]))
        self.set_epoch(int(state["epoch"]))

    # -- host -> device feed ------------------------------------------------
    def _tensor(self, key: str, a) -> torch.Tensor:
        """One host array on the device: integer indices as int64 (what
        torch's gathers take), label slabs as bf16 when tc.label_dtype asks
        (upcast on the card), the rest as they are.  Large arrays go through
        pinned memory."""
        t = torch.as_tensor(np.asarray(a))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        elif key in self._LABEL_SLABS and self.tc.label_dtype == "bfloat16":
            t = t.to(torch.bfloat16)
        if self.device.type == "cuda" and t.numel() >= 1 << 16:
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def put(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """A host batch (numpy arrays; `sa_inds` a dict of them) on the
        device.  Host-only entries (`label_ctx`) stay behind."""
        out = {}
        for k, v in batch.items():
            if k == "sa_inds":
                out[k] = {s: self._tensor(s, a) for s, a in v.items()}
            elif k != "label_ctx":
                out[k] = self._tensor(k, v)
        return out

    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return batch if isinstance(batch["point_clouds"], torch.Tensor) else self.put(batch)

    # -- steps ----------------------------------------------------------------
    def _forward_loss(self, device_batch: Dict[str, Any], train: bool):
        ep = self.model(device_batch["point_clouds"], train, labels=device_batch)
        ep["objectness_label"] = device_batch["objectness_label"]
        loss, metrics = get_loss(ep, self.cfg)
        return loss, metrics, ep

    def _train_step(self, device_batch: Dict[str, Any]):
        momentum = bn_momentum_at_epoch(self.tc, self.epoch)
        loss, metrics, ep = self._forward_loss(device_batch, train=True)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        apply_bn_updates(self.model, ep, momentum)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def step(self, batch: Dict[str, Any]):
        """One optimization step on a host or device full-label batch."""
        return self._train_step(self._device_batch(batch))

    def eval_step(self, batch: Dict[str, Any]):
        """Running-stat BN, label crops (the reference's eval epoch)."""
        with torch.no_grad():
            loss, metrics, _ = self._forward_loss(self._device_batch(batch), train=False)
        return loss, metrics

    # -- compact two-phase step ---------------------------------------------
    def prepare(self, batch: Dict[str, Any], *, train: bool = True):
        """Phase 1 of the compact step: the stage-1 pre-pass.

        `batch` holds point_clouds / objectness_label / sa_inds arrays and
        'label_ctx', one SceneLabelContext per scene.  The pre-pass runs the
        backbone and the approach net with the BN mode of the step it feeds
        (batch stats for a train step, running stats for eval), so its top
        views are bitwise the ones that step computes; it exports them and
        the ball-query indices, and ships the top-view-independent labels.
        Returns a handle for `step_prepared`."""
        ctxs = batch["label_ctx"]
        small = self.put({k: batch[k] for k in ("point_clouds", "objectness_label", "sa_inds")})
        with torch.no_grad():
            feats, _, ep_bb = self.model.backbone(small["point_clouds"], train, small["sa_inds"])
            top = self.model.approach(feats, train)["grasp_top_view_inds"]
        statics = [static_scene_labels(c, self.cfg) for c in ctxs]
        static = self.put({k: np.stack([s[k] for s in statics]) for k in statics[0]})
        return small, ctxs, top, ep_bb.get("sa_query_idx", {}), static

    def _finalize_batch(self, handle) -> Dict[str, Any]:
        """Phase 2 on the host: the matched slabs at the pre-pass's top
        views and the batch-global u_max, then the whole device batch."""
        small, ctxs, top, qidx, static = handle
        top_np = top.cpu().numpy()
        matched = [matched_scene_labels(c, top_np[i], self.cfg) for i, c in enumerate(ctxs)]
        labels = {k: np.stack([m[k] for m in matched]) for k in matched[0]}
        labels["label_u_max"] = np.float32(max(c.scene_umax for c in ctxs))
        device_batch = {**small, **static, **self.put(labels)}
        if qidx:
            device_batch["sa_query_idx"] = qidx
        return device_batch

    def step_prepared(self, handle):
        """Phase 2: finalize the matched labels, run the full step."""
        return self._train_step(self._finalize_batch(handle))

    def step_compact(self, batch: Dict[str, Any]):
        return self.step_prepared(self.prepare(batch))

    def grads_compact(self, batch: Dict[str, Any]):
        """(loss, gradients by state-dict key) on a compact batch, changing
        no state.  Buffers (the BN running stats) get zero gradients, as
        their leaves do in the JAX package's grads."""
        loss, _, _ = self._forward_loss(self._finalize_batch(self.prepare(batch)), train=True)
        names, params = zip(*self.model.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
        full = {k: grads.get(k, torch.zeros_like(v)) for k, v in self.model.state_dict().items()}
        return loss.detach(), full

    def eval_step_compact(self, batch: Dict[str, Any]):
        """Eval step on a compact batch: the running-stat pre-pass, then
        `eval_step` on the matched slabs (bitwise the full-path eval)."""
        handle = self.prepare(batch, train=False)
        with torch.no_grad():
            loss, metrics, _ = self._forward_loss(self._finalize_batch(handle), train=False)
        return loss, metrics
