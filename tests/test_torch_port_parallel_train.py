"""Data-parallel training over torch.distributed, and the CloudCrop's
routes, on the CPU.

* A 2-rank gloo group of spawned CPU processes, one scene a rank, against
  the single-process step on the same two scenes
  (`scripts/multiproc_check.py`): the step-0 loss, the gradients, the
  losses of two steps, the parameters and the BN running stats after them,
  each within SAFETY x the reversed-batch-order probe of the single process
  (the tolerance the JAX script derives; its own reading, a max grad diff of
  3.6e-06 in MULTICHIP_r05.json, is printed beside it, not used as a bar).
  A rank-local BN statistic, a rank-local loss count and a rank-local u_max
  (test-only stand-ins patched into the ranks) each fail that check.
* A one-rank group through `Trainer(group=)` is bitwise the one-process
  Trainer.
* `apps/train.py --n_devices 2 --device cpu --dist_backend gloo --tiny`
  trains from one command; rank 0 writes the checkpoint, rank 1 logs to
  `proc1/`, and a resume continues from it.
* `crop_route` case by case against the JAX `crop_forward`'s own choice
  (its Pallas calls stubbed on a pretend-TPU backend), and a two-layer crop
  MLP (3, 16, 32) served and trained by the port and the JAX package with
  the same weights: end points within 1e-5, loss within 1e-5 relative.
"""

import dataclasses
import json
import socket

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.models import graspnet_forward
from graspnet_tpu.models import heads as jheads
from graspnet_tpu.ops.pallas import crop as jpallas_crop
from graspnet_tpu.ops.pallas import mlp_train as jpallas_mlp
from graspnet_tpu.train.trainer import TrainConfig as JTrainConfig
from graspnet_tpu.train.trainer import Trainer as JTrainer

from graspnet_tpu_torch import checkpoint
from graspnet_tpu_torch.apps import train as cli
from graspnet_tpu_torch.checkpoint import params_from_jax
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.models import GraspNet
from graspnet_tpu_torch.models.heads import crop_route
from graspnet_tpu_torch.scripts import multiproc_check as mc
from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer

from tests.mini_dataset import make_mini_dataset
from tests.test_torch_port_checkpoint import jax_params
from tests.test_train import make_compact_batch

ATOL = 1e-5
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    """One intra-op thread here and in every spawned rank (they read the
    environment when they import torch): the suite runs in several
    processes on shared cores, beside timing tests."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ 2 ranks vs 1 ----


@pytest.fixture(scope="module")
def reference():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # before the function-scoped fixtures
    try:
        return mc.reference("cpu")
    finally:
        torch.set_num_threads(n)


def test_two_gloo_ranks_match_the_global_batch_step(reference, capsys):
    ref, rev = reference
    out = mc.verdict(ref, rev, mc.run_ranks("cpu", "gloo"))
    with capsys.disabled():
        print(f"\nmultiproc check: max grad diff {out['max_abs_grad_diff']:.3g} (derived tolerance "
              f"{out['derived_grad_tol']:.3g}; the JAX package read {mc.JAX_MAX_GRAD_DIFF} on its own run)")
    assert out["loss0_ok"] and out["grads_ok"] and out["losses_ok"], out
    assert out["params_ok"] and out["bn_stats_ok"], out
    assert out["ok"]
    # the step-0 loss equal within f32 rounding of the summed shares
    assert out["loss0_diff"] <= 4 * np.finfo(np.float32).eps * abs(out["ref_losses"][0])


def rank_local_bn():
    """Stand-in for a wrong sync-BN: every BatchNorm sees one rank."""
    from graspnet_tpu_torch.nn import layers

    layers.world_size = lambda group: 1


def rank_local_count():
    """Stand-in for a wrong loss: rank-local denominators."""
    from graspnet_tpu_torch.train import loss

    loss._count = lambda x, group: torch.sum(x)


def rank_local_u_max():
    """Stand-in for a wrong label rescale: the rank's own u_max."""
    from graspnet_tpu_torch.train import trainer

    trainer.Trainer._global_u_max = lambda self, u: torch.as_tensor(u, dtype=torch.float32).to(self.device)


@pytest.mark.parametrize("tamper", [rank_local_bn, rank_local_count, rank_local_u_max],
                         ids=["bn", "loss_count", "u_max"])
def test_a_rank_local_reduction_fails_the_check(reference, tamper):
    ref, rev = reference
    out = mc.verdict(ref, rev, mc.run_ranks("cpu", "gloo", tamper))
    assert not out["ok"] and not out["grads_ok"], out
    assert out["grad_tol_ratio"] > 10, out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_one_rank_group_is_bitwise_the_one_process_trainer():
    cfg = GraspNetConfig.tiny()
    _, compact = make_compact_batch(np.random.default_rng(0), JConfig.tiny(), 2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        grouped = Trainer(cfg, seed=0, device="cpu", group=dist.group.WORLD)
        plain = Trainer(cfg, seed=0, device="cpu")
        for tr in (grouped, plain):
            tr.set_epoch(0)
        for _ in range(2):
            (l1, m1), (l2, m2) = grouped.step_compact(compact), plain.step_compact(compact)
            assert torch.equal(l1, l2)
            for k in m1:
                assert torch.equal(m1[k], m2[k]), k
        l1, g1 = grouped.grads_compact(compact)
        l2, g2 = plain.grads_compact(compact)
        assert torch.equal(l1, l2) and all(torch.equal(g1[k], g2[k]) for k in g1)
        for (k, a), (_, b) in zip(grouped.state_dict()["model"].items(), plain.state_dict()["model"].items()):
            assert torch.equal(a, b), k
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- the CLI ----


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # 4 frames a split: two steps an epoch for each of 2 ranks at a global batch of 2
    return make_mini_dataset(str(tmp_path_factory.mktemp("mini_graspnet")), num_view=60, n_frames=4)


def argv(root, log_dir, *extra):
    return ["--dataset_root", root, "--camera", "realsense", "--log_dir", str(log_dir), "--tiny",
            "--device", "cpu", "--num_workers", "1", "--log_every", "1", "--num_objects", "3",
            "--n_devices", "2", "--dist_backend", "gloo", *extra]


def test_cli_trains_two_ranks_from_one_command_and_resumes(root, tmp_path):
    assert cli.main(argv(root, tmp_path, "--max_epoch", "1")) == 0
    train = [r for r in map(json.loads, open(tmp_path / "metrics.jsonl")) if r["prefix"] == "train"]
    assert [r["step"] for r in train] == [1, 2] and np.isfinite(train[-1]["loss/overall_loss"])
    assert "data-parallel rank 0/2 (gloo)" in (tmp_path / "log_train.txt").read_text()
    assert "data-parallel rank 1/2" in (tmp_path / "proc1" / "log_train.txt").read_text()
    assert not (tmp_path / "proc1" / cli.CHECKPOINT).exists()
    state = checkpoint.restore(str(tmp_path / cli.CHECKPOINT))
    assert state["epoch"] == 0
    assert cli.main(argv(root, tmp_path, "--max_epoch", "2", "--checkpoint_path",
                         str(tmp_path / cli.CHECKPOINT))) == 0
    for log in (tmp_path / "log_train.txt", tmp_path / "proc1" / "log_train.txt"):
        text = log.read_text()
        assert "resumed from" in text and "EPOCH 001" in text
    assert checkpoint.restore(str(tmp_path / cli.CHECKPOINT))["epoch"] == 1


# -------------------------------------------------------------- routes ----


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("crop_mlp", [(3, 8, 16, 32), (3, 16, 32), (3, 8, 8, 16, 32)], ids=["3", "2", "4"])
def test_crop_route_is_the_jax_choice(monkeypatch, train, world, crop_mlp):
    """The JAX crop_forward on a pretend-TPU backend of `world` devices with
    its Pallas calls stubbed: the stub it calls names its route."""
    jcfg = dataclasses.replace(JConfig.tiny(), crop_mlp=crop_mlp)
    called = []
    b, ns, nd, s = 1, 4, len(jcfg.hmax_list), jcfg.crop_nsample

    def fused(*a, **k):
        called.append("k5")
        return jnp.zeros((b, ns, nd, crop_mlp[-1]))

    def group(*a, **k):
        called.append("k6")
        return jnp.zeros((b, ns, nd, s, 3))

    def mlp_train(*a, **k):
        called.append("k7")
        return jnp.zeros((b, ns, nd, crop_mlp[-1])), None

    monkeypatch.setattr(jpallas_crop, "crop_fused_pallas", fused)
    monkeypatch.setattr(jpallas_crop, "crop_group_pallas", group)
    monkeypatch.setattr(jpallas_mlp, "crop_mlp_train_pallas", mlp_train)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax, "device_count", lambda: world)
    params = jheads.init_crop(jax.random.PRNGKey(0), jcfg)
    jheads.crop_forward(params, jnp.zeros((b, ns, 3)), jnp.zeros((b, 64, 3)), jnp.tile(jnp.eye(3), (b, ns, 1, 1)),
                        jcfg, train=train)
    want = {("k5",): "k5", ("k6", "k7"): "k7", ("k6",): "k6+mlp"}[tuple(called)]
    cfg = dataclasses.replace(GraspNetConfig.tiny(), crop_mlp=crop_mlp)
    assert crop_route(cfg, train, world) == want


@pytest.fixture(scope="module")
def two_layer_crop():
    jcfg = dataclasses.replace(JConfig.tiny(), crop_mlp=(3, 16, 32))
    cfg = dataclasses.replace(GraspNetConfig.tiny(), crop_mlp=(3, 16, 32))
    return jcfg, cfg, jax_params(jcfg, 0)


def test_two_layer_crop_mlp_serves_like_jax(two_layer_crop):
    jcfg, cfg, params = two_layer_crop
    model = GraspNet(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    cloud = np.random.default_rng(1).uniform(-0.3, 0.3, (2, cfg.num_point, 3)).astype(np.float32)
    with torch.no_grad():
        ep = model(torch.from_numpy(cloud))
    forward = jax.jit(lambda p, x: graspnet_forward(p, x, jcfg, train=False))
    jep = forward(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(cloud))
    for k in ("grasp_score_pred", "grasp_angle_cls_pred", "grasp_width_pred", "grasp_tolerance_pred"):
        want = np.asarray(jep[k])
        got = ep[k].numpy()
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * max(1.0, float(np.abs(want).max())), err_msg=k)


def test_two_layer_crop_mlp_trains_like_jax(two_layer_crop):
    jcfg, cfg, params = two_layer_crop
    full, compact = make_compact_batch(np.random.default_rng(0), jcfg, 2)
    jt = JTrainer(cfg=jcfg, tc=JTrainConfig(), params=jax.tree_util.tree_map(jnp.asarray, params), seed=0)
    jt.set_epoch(0)
    want_loss, _ = jt.step(full)
    tr = Trainer(cfg, TrainConfig(), params=params_from_jax(params, cfg), device="cpu")
    tr.set_epoch(0)
    loss, metrics = tr.step_compact(compact)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert len(metrics["loss/overall_loss"].shape) == 0
