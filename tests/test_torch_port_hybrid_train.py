"""Hybrid data x candidate training over torch.distributed, on the CPU.

The JAX trainer shards stage 2 of its step over a 'candidate' mesh axis
(`graspnet_tpu/train/trainer.py:142-165`) and holds the result against the
one-device step (`tests/test_parallel.py::TestHybridTrain`).  Here gloo
ranks of spawned CPU processes, laid out D x C (`Trainer(candidate=C)`),
run `scripts/multiproc_check.py`'s loop on its two scenes:

* 1 x 2 (one data row, two seed blocks) and 2 x 2 against the
  single-process B=2 run: the probe's loss and gradients, the losses of two
  steps and the parameters and BN running stats after them, each within
  the check's derived bound (SAFETY x the reversed-scene-order probe); and
  every rank's parameters and BN buffers bitwise rank 0's.
* Three test-only stand-ins for a wrong reduction, at 2 x 2, each failing
  the gradient check by a ratio above 10: the stage-1 loss terms counted C
  times, the crop and head BatchNorms over the rank's seed block alone, and
  every column taking the same seed block.  A fourth, the stage-1
  statistics over the whole group (each scene's rows C times), leaves the
  gradients exact but fails the BN running stats: the unbiased variance
  takes a C times too large row count.
* 2 x 2 against the JAX package: from the JAX weights of
  tests/test_torch_port_train_step.py on its two `make_compact_batch`
  scenes, rank 0's probe (the global loss and the summed gradients) against
  the JAX `Trainer.grads_compact` on one device, at that file's one-step
  bounds (loss rtol 1e-5, each gradient leaf 1e-3 x max(1, max |g|)).
* `apps/train.py --n_devices 2 --candidate_devices 2` trains four ranks
  from one command, and 1 epoch + a resume + 1 epoch ends bitwise where 2
  epochs in one run end.
"""

import functools
import json
import os
import pickle
import socket

import numpy as np
import pytest
import torch

from graspnet_tpu_torch import checkpoint
from graspnet_tpu_torch.apps import train as cli
from graspnet_tpu_torch.scripts import multiproc_check as mc

from tests.mini_dataset import make_mini_dataset
from tests.test_torch_port_train_cli import assert_states_equal


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    """One intra-op thread here and in every spawned rank."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return mc.reference("cpu")
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("layout", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_hybrid_ranks_match_the_global_batch_step(reference, layout, capsys):
    ref, rev = reference
    out = mc.verdict(ref, rev, mc.run_ranks("cpu", "gloo", layout=layout))
    with capsys.disabled():
        print(f"\nhybrid {layout[0]}x{layout[1]}: max grad diff {out['max_abs_grad_diff']:.3g} (derived "
              f"tolerance {out['derived_grad_tol']:.3g})")
    assert out["loss0_ok"] and out["grads_ok"] and out["losses_ok"], out
    assert out["params_ok"] and out["bn_stats_ok"], out
    assert out["ranks_equal"], "the ranks' weights or BN buffers differ after the steps"
    assert out["ok"]


def stage1_counted(times: int):
    """Stand-in: every rank's stage-1 loss terms at full weight, as
    denominators counted once a scene give them while the C ranks of a row
    repeat the numerators."""
    from graspnet_tpu_torch.train import loss

    obj, view = loss.compute_objectness_loss, loss.compute_view_loss

    def objectness(ep, group=None):
        value, metrics = obj(ep, group)
        return value * times, metrics

    def view_loss(ep, cfg, group=None):
        value, metrics = view(ep, cfg, group)
        return value * times, metrics

    loss.compute_objectness_loss, loss.compute_view_loss = objectness, view_loss


def stage2_bn_on_the_block():
    """Stand-in: the crop and head BatchNorms take their rank's seed block's
    statistics alone."""
    from graspnet_tpu_torch.train import trainer

    real = trainer.set_process_group

    def patched(module, group):
        real(module, group)
        for name in ("crop", "operation", "tolerance"):
            if hasattr(module, name):
                real(getattr(module, name), None)

    trainer.set_process_group = patched


def one_seed_block():
    """Stand-in: every column crops seed block 0."""
    from graspnet_tpu_torch.train import trainer

    real = trainer.seed_block
    trainer.seed_block = lambda block, candidate, num_seed: real(0, candidate, num_seed)


def stage1_stats_over_the_group():
    """Stand-in: the stage-1 BatchNorms over the whole group, where each
    scene's rows come C times."""
    from graspnet_tpu_torch.train import trainer

    trainer.column_group = lambda group, candidate: group


@pytest.mark.parametrize("tamper", [functools.partial(stage1_counted, 2), stage2_bn_on_the_block, one_seed_block],
                         ids=["stage1_counted_c_times", "stage2_bn_on_the_block", "one_seed_block"])
def test_a_wrong_hybrid_reduction_fails_the_check(reference, tamper, capsys):
    ref, rev = reference
    out = mc.verdict(ref, rev, mc.run_ranks("cpu", "gloo", tamper, layout=(2, 2)))
    with capsys.disabled():
        print(f"\ngradient diff / derived tolerance: {out['grad_tol_ratio']:.3g}")
    assert not out["ok"] and not out["grads_ok"], out
    assert out["grad_tol_ratio"] > 10, out


def test_stage1_statistics_over_the_whole_group_fail_the_bn_check(reference, capsys):
    ref, rev = reference
    out = mc.verdict(ref, rev, mc.run_ranks("cpu", "gloo", stage1_stats_over_the_group, layout=(2, 2)))
    with capsys.disabled():
        print(f"\nBN stat diff {out['max_abs_bn_stat_diff']:.3g}, derived tolerance {out['derived_bn_stat_tol']:.3g}")
    assert out["grads_ok"], out  # the batch mean and variance are exact ...
    assert not out["bn_stats_ok"] and not out["ok"], out  # ... their unbiased count is not


# ------------------------------------------------- against the JAX step ----


def _jax_weights_rank(rank: int, port: int, path: str, out: str) -> None:
    """A rank of a 2 x 2 world: its data row's scene of the pickled batch,
    the pickled weights, one `grads_compact`; rank 0 saves its result."""
    import torch.distributed as dist

    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.parallel import distributed
    from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer

    torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{port}", 4, rank, backend="gloo", device="cpu")
    try:
        with open(path, "rb") as f:
            state, compact = pickle.load(f)
        sl = distributed.process_local_batch_slice(len(compact["label_ctx"]), 2)
        local = {k: ({s: a[sl] for s, a in v.items()} if k == "sa_inds" else v[sl]) for k, v in compact.items()}
        tr = Trainer(GraspNetConfig.tiny(), TrainConfig(), params=state, device="cpu", group=dist.group.WORLD,
                     candidate=2)
        tr.set_epoch(0)
        loss, grads = tr.grads_compact(local)
        if rank == 0:
            torch.save({"loss": float(loss), "grads": grads}, os.path.join(out, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def test_hybrid_2x2_grads_match_the_jax_one_device_step(tmp_path, capsys):
    import jax
    import jax.numpy as jnp

    from graspnet_tpu.config import GraspNetConfig as JConfig
    from graspnet_tpu.train.trainer import TrainConfig as JTrainConfig
    from graspnet_tpu.train.trainer import Trainer as JTrainer
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.train.label_pipeline import SceneLabelContext

    from tests.test_torch_port_checkpoint import jax_params
    from tests.test_torch_port_train_step import GRAD_ATOL, LOSS_RTOL, leaves
    from tests.test_train import make_compact_batch

    jcfg = JConfig.tiny()
    params = jax_params(jcfg, 0)
    _, compact = make_compact_batch(np.random.default_rng(0), jcfg, 2)
    jt = JTrainer(cfg=jcfg, tc=JTrainConfig(), params=jax.tree_util.tree_map(jnp.asarray, params), seed=0)
    jt.set_epoch(0)
    j_loss, j_grads = jt.grads_compact(compact)

    # the JAX label contexts as the port's (the same slots), so the ranks import no JAX
    compact["label_ctx"] = [SceneLabelContext(**{k: getattr(c, k) for k in c.__slots__})
                            for c in compact["label_ctx"]]
    path = str(tmp_path / "batch.pkl")
    with open(path, "wb") as f:
        pickle.dump((checkpoint.params_from_jax(params, GraspNetConfig.tiny()), compact), f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(_jax_weights_rank, args=(port, path, str(tmp_path)), nprocs=4, join=True)
    got = torch.load(str(tmp_path / "rank0.pt"))

    np.testing.assert_allclose(got["loss"], float(j_loss), rtol=LOSS_RTOL)
    mine, want = leaves(checkpoint.params_to_jax(got["grads"])), leaves(jax.tree_util.tree_map(np.asarray, j_grads))
    assert [p for p, _ in mine] == [p for p, _ in want]
    worst = max(float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max())) for (_, g), (_, w) in zip(mine, want))
    with capsys.disabled():
        print(f"\nhybrid 2x2 vs JAX: loss {got['loss']:.7f} / {float(j_loss):.7f}, worst grad diff "
              f"{worst:.3g} x max(1, max |g|) (bound {GRAD_ATOL})")
    for (p, g), (_, w) in zip(mine, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_ATOL * max(1.0, float(np.abs(w).max())), err_msg=p)


# ------------------------------------------------------------- the CLI ----


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # 4 frames a split: two steps an epoch at a global batch of 2 over 2 data rows
    return make_mini_dataset(str(tmp_path_factory.mktemp("mini_graspnet")), num_view=60, n_frames=4)


def argv(root, log_dir, *extra):
    return ["--dataset_root", root, "--camera", "realsense", "--log_dir", str(log_dir), "--tiny",
            "--device", "cpu", "--num_workers", "1", "--log_every", "1", "--num_objects", "3",
            "--n_devices", "2", "--candidate_devices", "2", "--dist_backend", "gloo", *extra]


def test_cli_trains_2x2_ranks_and_resumes_bitwise(root, tmp_path):
    whole, split = tmp_path / "whole", tmp_path / "split"
    assert cli.main(argv(root, whole, "--max_epoch", "2")) == 0
    assert cli.main(argv(root, split, "--max_epoch", "1")) == 0
    assert cli.main(argv(root, split, "--max_epoch", "2", "--checkpoint_path", str(split / cli.CHECKPOINT))) == 0
    train = [r for r in map(json.loads, open(whole / "metrics.jsonl")) if r["prefix"] == "train"]
    assert [r["step"] for r in train] == [1, 2, 3, 4] and np.isfinite(train[-1]["loss/overall_loss"])
    assert "hybrid rank 0/4 (gloo): data row 0 of 2, seed block 0 of 2" in (whole / "log_train.txt").read_text()
    assert "data row 1 of 2, seed block 1 of 2" in (whole / "proc3" / "log_train.txt").read_text()
    assert not any((whole / f"proc{r}" / cli.CHECKPOINT).exists() for r in (1, 2, 3))
    assert "resumed from" in (split / "proc2" / "log_train.txt").read_text()
    a, b = checkpoint.restore(str(whole / cli.CHECKPOINT)), checkpoint.restore(str(split / cli.CHECKPOINT))
    assert a["epoch"] == b["epoch"] == 1
    assert_states_equal(a, b)
