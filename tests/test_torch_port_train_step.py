"""The training slice as a whole: the port's `Trainer(device="cpu")` against
the JAX `Trainer` at `GraspNetConfig.tiny()`, same weights (through
`params_from_jax`) and the same `make_compact_batch` scenes
(tests/test_train.py), plus the port's own invariants.

Tolerances and why:
* Selections (the pre-pass top views, the ball-query indices) exactly
  equal; a failure prints the view-score margin of the first flip.
* Loss and metrics at rtol 1e-5: batch-stat BN reduces over every row in
  another order than XLA (measured ~1e-6 relative at this size).
* Gradients leaf by leaf at atol 1e-3 x max(1, max |g|).  Derived, not
  guessed: the JAX step against itself with the two scenes of the batch
  swapped (the same math, BN sums in another order) moves its own
  gradients by up to 7.6e-4 x max(1, max |g|) at this size; the port sits
  inside that band (1.5e-4).
* BN running stats after one step at atol 3e-5 x max(1, max |stat|),
  derived the same way: the swapped-scene JAX step moves its own running
  stats by up to 1.07e-5 x max(1, max |stat|); the port by 1.1e-5.  The
  noise is absolute, not relative (3.6e-6 on a mean of -0.028 here).
* Parameters after Adam are not compared at a tight tolerance: Adam turns
  float noise in a near-zero gradient into an lr-sized step.  The optimizer
  is checked on its own instead: identical gradients through the port's
  optimizer and the JAX `adam_l2` for 3 steps with weight decay and an lr
  change, at atol 1e-6 (tests/test_train.py's own bound for adam_l2 vs
  torch Adam).
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.train.trainer import TrainConfig as JTrainConfig
from graspnet_tpu.train.trainer import Trainer as JTrainer

from graspnet_tpu_torch.checkpoint import params_from_jax, params_to_jax
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.train.loss import get_loss
from graspnet_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    bn_momentum_at_epoch,
    lr_at_epoch,
)

from tests.test_torch_port_checkpoint import jax_params
from tests.test_train import make_compact_batch

CFG, JCFG = GraspNetConfig.tiny(), JConfig.tiny()
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-3
STAT_ATOL = 3e-5


def port_trainer(params, tc=TrainConfig()):
    tr = Trainer(CFG, tc, params=params_from_jax(params, CFG), device="cpu")
    tr.set_epoch(0)
    return tr


def leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.fixture(scope="module")
def data():
    params = jax_params(JCFG, 0)
    full, compact = make_compact_batch(np.random.default_rng(0), JCFG, 2)
    return params, full, compact


@pytest.fixture(scope="module")
def jax_run(data):
    """The JAX trainer's pre-pass selections, gradients, and one step."""
    params, full, compact = data
    jt = JTrainer(cfg=JCFG, tc=JTrainConfig(), params=jax.tree_util.tree_map(jnp.asarray, params), seed=0)
    jt.set_epoch(0)
    _, _, top, qidx, _ = jt.prepare(compact)
    g_loss, grads = jt.grads_compact(compact)
    loss, metrics = jt.step(full)
    return {
        "top": np.asarray(top), "qidx": {k: np.asarray(v) for k, v in qidx.items()},
        "grad_loss": float(g_loss), "grads": jax.tree_util.tree_map(np.asarray, grads),
        "loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
        "params": jax.tree_util.tree_map(np.asarray, jt.params),
    }


def test_selections_match_jax(data, jax_run):
    params, _, compact = data
    tr = port_trainer(params)
    _, _, top, qidx, _ = tr.prepare(compact)
    top = top.numpy()
    if not np.array_equal(top, jax_run["top"]):
        with torch.no_grad():
            feats, _, _ = tr.model.backbone(tr.put(compact)["point_clouds"], True,
                                            tr.put(compact)["sa_inds"])
            vs = tr.model.approach(feats, True)["view_score"].numpy()
        b, s = np.argwhere(top != jax_run["top"])[0]
        top2 = np.sort(vs[b, s])[-2:]
        pytest.fail(f"top view differs at scene {b} seed {s}: margin {top2[1] - top2[0]}")
    assert set(qidx) == set(jax_run["qidx"])
    for k, v in qidx.items():
        np.testing.assert_array_equal(v.numpy(), jax_run["qidx"][k], err_msg=k)


def test_step_loss_metrics_and_running_stats_match_jax(data, jax_run):
    params, full, _ = data
    tr = port_trainer(params)
    loss, metrics = tr.step(full)
    np.testing.assert_allclose(float(loss), jax_run["loss"], rtol=LOSS_RTOL)
    assert set(metrics) == set(jax_run["metrics"])
    for k, v in jax_run["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    got = dict(leaves(params_to_jax(tr.model.state_dict())))
    n = 0
    for path, want in leaves(jax_run["params"]):
        if path.endswith("['mean']") or path.endswith("['var']"):
            np.testing.assert_allclose(got[path], want, rtol=0,
                                       atol=STAT_ATOL * max(1.0, float(np.abs(want).max())), err_msg=path)
            n += 1
    assert n == sum(1 for k in tr.model.state_dict() if k.endswith((".mean", ".var")))


def test_grads_compact_match_jax(data, jax_run):
    params, _, compact = data
    tr = port_trainer(params)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    loss, grads = tr.grads_compact(compact)
    np.testing.assert_allclose(float(loss), jax_run["grad_loss"], rtol=LOSS_RTOL)
    got = leaves(params_to_jax(grads))
    want = leaves(jax_run["grads"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_ATOL * max(1.0, float(np.abs(w).max())),
                                   err_msg=path)
    for k, v in tr.model.state_dict().items():  # a probe changes no state
        assert torch.equal(v, before[k]), k


def test_optimizer_matches_adam_l2(data):
    """3 steps of identical gradients with weight decay 0.05 and an lr change
    after step 2: the port's torch Adam against the JAX trainer's adam_l2
    (BN running stats masked out of the decay by name there, buffers here)."""
    params = data[0]
    tc_j, tc = JTrainConfig(weight_decay=0.05), TrainConfig(weight_decay=0.05)
    jt = JTrainer(cfg=JCFG, tc=tc_j, params=jax.tree_util.tree_map(jnp.asarray, params), seed=0)
    tr = port_trainer(params, tc)
    rng = np.random.default_rng(9)
    jparams, jstate = jt.params, jt.opt_state
    for step, epoch in enumerate((0, 0, 8)):
        jt.opt_state = jstate
        jt.set_epoch(epoch)
        jstate = jt.opt_state
        tr.set_epoch(epoch)
        g_np = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in tr.model.named_parameters()}
        full = {k: g_np.get(k, np.zeros(v.shape, np.float32)) for k, v in tr.model.state_dict().items()}
        updates, jstate = jt.tx.update(jax.tree_util.tree_map(jnp.asarray, params_to_jax(
            {k: torch.from_numpy(v) for k, v in full.items()})), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tr.model.named_parameters():
            p.grad = torch.from_numpy(g_np[k].copy())
        tr.opt.step()
    got = dict(leaves(params_to_jax(tr.model.state_dict())))
    for path, want in leaves(jparams):
        np.testing.assert_allclose(got[path], want, rtol=0, atol=1e-6, err_msg=path)
    assert tr.opt.param_groups[0]["lr"] == pytest.approx(1e-4)


def test_compact_step_equals_full_step_bitwise(data):
    """The JAX package's own invariant (tests/test_train.py:284-305), in the
    port on the CPU: equal losses and bitwise equal state after 3 steps."""
    params, full, compact = data
    t_full, t_comp = port_trainer(params), port_trainer(params)
    for _ in range(3):
        l1, m1 = t_full.step(full)
        l2, m2 = t_comp.step_compact(compact)
        assert float(l1) == float(l2)
        for k in m1:
            assert torch.equal(m1[k], m2[k]), k
    for (k, a), (_, b) in zip(t_full.model.state_dict().items(), t_comp.model.state_dict().items()):
        assert torch.equal(a, b), k


def test_eval_compact_equals_eval_and_uses_running_stats(data):
    params, full, compact = data
    tr = port_trainer(params)
    tr.step(full)  # running stats move away from the checkpoint's
    l_full, m_full = tr.eval_step(full)
    l_comp, m_comp = tr.eval_step_compact(compact)
    assert float(l_full) == float(l_comp)
    for k in m_full:
        assert torch.equal(m_full[k], m_comp[k]), k
    # eval is running-stat BN: a batch-stat forward on the same labels differs
    dev = tr.put(full)
    with torch.no_grad():
        ep = tr.model(dev["point_clouds"], True, labels=dev)
        ep["objectness_label"] = dev["objectness_label"]
        train_loss, _ = get_loss(ep, CFG)
    assert float(train_loss) != float(l_full)


def test_eval_step_matches_jax(data):
    params, full, _ = data
    jt = JTrainer(cfg=JCFG, tc=JTrainConfig(), params=jax.tree_util.tree_map(jnp.asarray, params), seed=0)
    want, wm = jt.eval_step(full)
    got, gm = port_trainer(params).eval_step(full)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=LOSS_RTOL, atol=1e-6, err_msg=k)


def test_weight_decay_leaves_running_stats_alone(data):
    """Decay reaches the parameters, never the running stats (buffers):
    with weight decay 0.5 they match a weight-decay-0 run bitwise while the
    kernels differ (tests/test_train.py:155-183)."""
    params, full, _ = data
    t0 = port_trainer(params, TrainConfig(weight_decay=0.0))
    t1 = port_trainer(params, TrainConfig(weight_decay=0.5))
    assert all(not k.endswith((".mean", ".var")) for k, _ in t0.model.named_parameters())
    t0.step(full)
    t1.step(full)
    s0, s1 = t0.model.state_dict(), t1.model.state_dict()
    assert torch.equal(s0["backbone.sa1.mlp.0.bn.mean"], s1["backbone.sa1.mlp.0.bn.mean"])
    assert torch.equal(s0["backbone.sa1.mlp.0.bn.var"], s1["backbone.sa1.mlp.0.bn.var"])
    assert not torch.allclose(s0["backbone.sa1.mlp.0.kernel"], s1["backbone.sa1.mlp.0.kernel"])


def test_loss_decreases_and_bf16_labels(data):
    params, full, _ = data
    tr = port_trainer(params)
    losses = [float(tr.step(tr.put(full))[0]) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    l32 = float(port_trainer(params).step(full)[0])
    l16 = float(port_trainer(params, TrainConfig(label_dtype="bfloat16")).step(full)[0])
    assert np.isfinite(l16) and abs(l32 - l16) / abs(l32) < 0.02


def test_schedules():
    tc = TrainConfig()
    assert [lr_at_epoch(tc, e) for e in (0, 8, 12, 17)] == pytest.approx([1e-3, 1e-4, 1e-5, 1e-6])
    assert bn_momentum_at_epoch(tc, 0) == 0.5
    assert bn_momentum_at_epoch(tc, 2) == 0.25
    assert bn_momentum_at_epoch(tc, 17) == 0.5 * 0.5 ** 8
    assert bn_momentum_at_epoch(tc, 40) == 0.001


def test_default_device_raises_without_cuda():
    code = (
        "import torch, sys\n"
        "assert not torch.cuda.is_available()\n"
        "from graspnet_tpu_torch.config import GraspNetConfig\n"
        "from graspnet_tpu_torch.train.trainer import Trainer\n"
        "try:\n"
        "    Trainer(GraspNetConfig.tiny())\n"
        "except RuntimeError as e:\n"
        "    sys.exit(0 if 'CUDA' in str(e) else 3)\n"
        "sys.exit(4)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
