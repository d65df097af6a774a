"""The learnability gate's training from the JAX gate's initial weights.

The port's gate (`graspnet_tpu_torch/scripts/learnability_gate.py`) draws
its weights through `Trainer(seed=)`, which are not the JAX gate's
(`init_graspnet(PRNGKey(seed), cfg)`), so its AP cannot be compared with
the JAX gate's run for run.  Here both trainers start from the JAX gate's
seed-0 weights (`params_from_jax`) and train on the same learnable frames,
each through its own package's dataset and loader (the two match bitwise,
tests/test_torch_port_data.py), with the gate's recipe: batch 4, the
compact step, bn_momentum_min 0.05, the gate's schedule at epoch 0.

Tolerances and why:
* Step 1's loss within 1e-5 relative: the one-step bound of
  tests/test_torch_port_train_step.py (batch-stat BN reduces over the rows
  in another order than XLA).
* Each later step's loss within SAFETY x the JAX run's own spread: the JAX
  trainer is run twice from the same weights, the second time with every
  batch's scenes reversed (the same math, its sums in another order).  Adam
  turns that order noise into diverging weights, step by step; the port's
  distance from the JAX run must stay within SAFETY x max(that probe, f32
  rounding of the loss), the rule of `scripts/multiproc_check.py`.  Once
  the probe passes the loss's f32 rounding by CHAOTIC (1e3) the JAX run no
  longer agrees with itself, and SAFETY x the probe would pass almost any
  trajectory: the bound is asserted on the steps before that one only (at
  least two), and the later steps are printed, not held.

The dataset is the small learnable one of tests/test_torch_port_eval.py
(4 train frames: one batch a pass, as the gate's 12 frames give three).
"""

import dataclasses
import glob
import os

import numpy as np
import jax
import pytest
import torch

from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.data import dataset as jdataset
from graspnet_tpu.train.trainer import TrainConfig as JTrainConfig
from graspnet_tpu.train.trainer import Trainer as JTrainer

from graspnet_tpu_torch.checkpoint import params_from_jax
from graspnet_tpu_torch.data import dataset as pdataset
from graspnet_tpu_torch.data.learnable import make_learnable_dataset
from graspnet_tpu_torch.scripts import learnability_gate
from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer

from tests.test_torch_port_checkpoint import jax_params

STEPS = 10
BATCH = 4
LOSS_RTOL = 1e-5
SAFETY = 16.0
EPS32 = 2.0 ** -24
CHAOTIC = 1e3  # the JAX self-probe over the loss's f32 rounding where training turns chaotic
SMALL = dict(n_train_frames=4, n_test_frames=2, num_label_points=12, model_points=400)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reverse(batch):
    """The batch with its scenes in reverse order."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = {s: a[::-1].copy() for s, a in v.items()}
        elif isinstance(v, list):
            out[k] = v[::-1]
        else:
            out[k] = np.ascontiguousarray(v[::-1])
    return out


def batches(mod, root, cfg):
    """STEPS gate batches from one package's dataset and loader, as the gate
    draws them (passes over a shuffled loader, two workers)."""
    n_obj = len(glob.glob(os.path.join(root, "grasp_label", "*_labels.npz")))
    valid, labels = mod.load_grasp_labels(root, num_objects=n_obj)
    ds = mod.GraspNetDataset(root, valid, labels, camera="realsense", split="train", num_points=cfg.num_point,
                             remove_outlier=True, load_label=True, cfg=cfg, augment=True, seed=0)
    loader = mod.DataLoader(ds, min(BATCH, len(ds)), shuffle=True, num_workers=2)
    out = []
    while len(out) < STEPS:
        out.extend(list(loader)[: STEPS - len(out)])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gate_trajectory"))
    cfg = learnability_gate.gate_config()
    jcfg = dataclasses.replace(JConfig.tiny(), num_point=1024)
    make_learnable_dataset(root, cfg=cfg, seed=0, **SMALL)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params = jax_params(jcfg, 0, perturb_bn=False)  # init_graspnet(PRNGKey(0), cfg): the JAX gate's draw
        jb, pb = batches(jdataset, root, jcfg), batches(pdataset, root, cfg)
        for a, b in zip(jb, pb):  # the same frames, augmented the same way
            np.testing.assert_array_equal(a["point_clouds"], b["point_clouds"])

        jt = JTrainer(cfg=jcfg, tc=JTrainConfig(batch_size=BATCH, bn_momentum_min=0.05), params=params)
        jt.set_epoch(0)
        p0, o0 = jt.params, jt.opt_state
        jax_losses = [float(jax.device_get(jt.step_compact(b)[0])) for b in jb]
        jt.params, jt.opt_state = p0, o0
        jax_rev = [float(jax.device_get(jt.step_compact(reverse(b))[0])) for b in jb]

        pt = Trainer(cfg, TrainConfig(batch_size=BATCH, bn_momentum_min=0.05), params=params_from_jax(params, cfg),
                     device="cpu")
        pt.set_epoch(0)
        port = [float(pt.step_compact(b)[0]) for b in pb]
    finally:
        torch.set_num_threads(n)
    return np.asarray(jax_losses), np.asarray(jax_rev), np.asarray(port)


def test_first_step_loss_matches_jax(runs):
    jax_losses, _, port = runs
    np.testing.assert_allclose(port[0], jax_losses[0], rtol=LOSS_RTOL)


def test_trajectory_within_the_jax_runs_own_spread(runs, capsys):
    jax_losses, jax_rev, port = runs
    probe = np.abs(jax_losses - jax_rev)
    tol = SAFETY * np.maximum(probe, EPS32 * np.abs(jax_losses)) + 1e-9
    diff = np.abs(port - jax_losses)
    chaotic = probe > CHAOTIC * EPS32 * np.abs(jax_losses)
    held = int(np.argmax(chaotic)) if chaotic.any() else STEPS  # the steps before the first chaotic one
    with capsys.disabled():
        print(f"\nstep  jax loss     port loss    |port-jax|  |jax-jax reversed|  (steps 1-{held} held)")
        for i in range(STEPS):
            print(f"{i + 1:4d}  {jax_losses[i]:.7f}  {port[i]:.7f}  {diff[i]:.3g}  {probe[i]:.3g}")
    assert np.all(np.isfinite(port))
    assert held >= 2, f"the JAX run departs from itself at step {held + 1}: nothing beyond step 1 to hold"
    assert np.all(diff[:held] <= tol[:held]), (diff[:held] / tol[:held]).max()
