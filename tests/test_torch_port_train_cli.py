"""The port's training CLI (`apps/train.py`) and checkpoints on the CPU.

* The CLI at `--tiny --device cpu` on the on-disk mini dataset
  (`tests/mini_dataset.py`): one epoch writes train and eval metrics and a
  checkpoint; two epochs straight give the model and Adam state of one epoch,
  a resume and one more, bitwise; `--label_mode full` gives the compact
  mode's state bitwise; SIGTERM writes the preemption checkpoint and
  returns (the signal is sent only once the CLI's handler is installed, so
  it can never reach a test worker's own handler); the one-card flags.
* `checkpoint.save` / `restore` round trips, written atomically.
* `load_torch_checkpoint` on a reference-format state dict built with
  `tests/test_checkpoint.py::params_to_reference_state_dict` equals
  `params_from_jax` of the JAX package's `convert_torch_state_dict`;
  `GraspPipeline(checkpoint_path=...)` loads it and the CLI's checkpoint.
"""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from graspnet_tpu import checkpoint as jcheckpoint
from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.models import init_graspnet

from graspnet_tpu_torch import checkpoint
from graspnet_tpu_torch.apps import GraspPipeline
from graspnet_tpu_torch.apps import train as cli
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.train.trainer import Trainer

from tests.mini_dataset import make_mini_dataset
from tests.test_checkpoint import params_to_reference_state_dict

CFG = GraspNetConfig.tiny()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # 4 frames a split: two steps an epoch at batch 2
    return make_mini_dataset(str(tmp_path_factory.mktemp("mini_graspnet")), num_view=60, n_frames=4)


def argv(root, log_dir, *extra):
    return ["--dataset_root", root, "--camera", "realsense", "--log_dir", str(log_dir), "--tiny",
            "--device", "cpu", "--num_workers", "2", "--log_every", "1", "--num_objects", "3", *extra]


def assert_states_equal(a, b, where="state"):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_states_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_states_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_one_epoch_writes_metrics_and_checkpoint(root, tmp_path):
    assert cli.main(argv(root, tmp_path, "--max_epoch", "1")) == 0
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    train = [r for r in records if r["prefix"] == "train"]
    evals = [r for r in records if r["prefix"] == "eval"]
    assert [r["step"] for r in train] == [1, 2] and [r["step"] for r in evals] == [2]
    assert np.isfinite(train[-1]["loss/overall_loss"]) and np.isfinite(evals[0]["loss/overall_loss"])
    state = checkpoint.restore(str(tmp_path / cli.CHECKPOINT))
    assert state["epoch"] == 0 and set(state) == {"model", "optimizer", "epoch"}
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_resume_is_bitwise_an_uninterrupted_run(root, tmp_path):
    straight, split = tmp_path / "straight", tmp_path / "split"
    cli.main(argv(root, straight, "--max_epoch", "2"))
    cli.main(argv(root, split, "--max_epoch", "1"))
    ckpt = str(split / cli.CHECKPOINT)
    cli.main(argv(root, split, "--max_epoch", "2", "--checkpoint_path", ckpt))
    log = (split / "log_train.txt").read_text()
    assert "resumed from" in log and log.count("EPOCH 000") == 1 and log.count("EPOCH 001") == 1
    a = checkpoint.restore(str(straight / cli.CHECKPOINT))
    b = checkpoint.restore(ckpt)
    assert a["epoch"] == b["epoch"] == 1
    assert_states_equal(a, b)
    # the resumed trainer is the saved one, bitwise
    fresh = Trainer(CFG, seed=5, device="cpu")
    fresh.load_state_dict(b)
    assert_states_equal(fresh.state_dict(), b)


def test_full_label_mode_trains_bitwise_as_compact(root, tmp_path):
    cli.main(argv(root, tmp_path / "compact", "--max_epoch", "1"))
    cli.main(argv(root, tmp_path / "full", "--max_epoch", "1", "--label_mode", "full"))
    assert_states_equal(checkpoint.restore(str(tmp_path / "compact" / cli.CHECKPOINT)),
                        checkpoint.restore(str(tmp_path / "full" / cli.CHECKPOINT)))


def test_sigterm_writes_the_preemption_checkpoint_and_returns(root, tmp_path, monkeypatch):
    before = signal.getsignal(signal.SIGTERM)
    step = Trainer.step_prepared
    sent = []

    def step_then_signal(self, handle):
        out = step(self, handle)
        if not sent:
            handler = signal.getsignal(signal.SIGTERM)
            # only the CLI's own handler may receive it: anything else would
            # end this process
            assert getattr(handler, "__qualname__", "").endswith("preemption_flag.<locals>.on_signal"), handler
            sent.append(True)
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(Trainer, "step_prepared", step_then_signal)
    assert cli.main(argv(root, tmp_path, "--max_epoch", "50")) == 0
    assert sent and signal.getsignal(signal.SIGTERM) is before
    log = (tmp_path / "log_train.txt").read_text()
    assert "preemption checkpoint written" in log and "EPOCH 001" not in log
    state = checkpoint.restore(str(tmp_path / cli.CHECKPOINT))
    assert state["epoch"] == -1  # epoch 0 restarts on resume
    assert not any(r["prefix"] == "eval" for r in map(json.loads, open(tmp_path / "metrics.jsonl")))


@pytest.mark.parametrize("flags", [["--n_devices", "2"], ["--candidate_devices", "4"], ["--n_devices", "4"]])
def test_multi_card_and_profile_flags_raise(root, tmp_path, flags):
    """Flags of more than one card are argparse errors.  (--profile_dir was
    one until the CLI traced steps with it: test_profile_dir_writes_a_trace.)"""
    with pytest.raises(SystemExit):
        cli.main(argv(root, tmp_path, *flags))


def test_profile_dir_writes_a_trace(root, tmp_path):
    """--profile_dir traces the first epoch's steps (both of the mini
    dataset's two) into a Chrome trace that names the training step's ops."""
    prof = tmp_path / "prof"
    assert cli.main(argv(root, tmp_path / "log", "--max_epoch", "1", "--profile_dir", str(prof))) == 0
    trace = json.loads((prof / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("Optimizer.step" in n for n in names), sorted(names)[:20]
    assert "trace of steps 0-1 saved" in (tmp_path / "log" / "log_train.txt").read_text()


def test_cuda_default_raises_without_a_card(root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    args = argv(root, tmp_path, "--max_epoch", "1")
    args = args[: args.index("--device")] + args[args.index("--device") + 2:]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)


def test_debug_nans_trains_and_resets_anomaly_mode(root, tmp_path):
    assert cli.main(argv(root, tmp_path, "--max_epoch", "1", "--debug_nans")) == 0
    assert not torch.is_anomaly_enabled()


def test_save_restore_round_trip_is_atomic(tmp_path):
    tr = Trainer(CFG, seed=3, device="cpu")
    path = str(tmp_path / "sub" / "state.pt")
    checkpoint.save(path, tr.state_dict())
    checkpoint.save(path, tr.state_dict())  # replaces the whole file
    assert os.listdir(tmp_path / "sub") == ["state.pt"]
    assert_states_equal(checkpoint.restore(path), tr.state_dict())


@pytest.fixture(scope="module")
def reference_tar(tmp_path_factory):
    jparams = init_graspnet(jax.random.PRNGKey(1), JConfig.tiny())
    sd = params_to_reference_state_dict(jparams)
    path = str(tmp_path_factory.mktemp("ref") / "checkpoint-rs.tar")
    torch.save({"model_state_dict": sd, "epoch": 3, "loss": torch.tensor(0.5), "optimizer_state_dict": {}}, path)
    return path, sd


def test_load_torch_checkpoint_matches_jax_conversion(reference_tar):
    path, sd = reference_tar
    got = checkpoint.load_torch_checkpoint(path, CFG)
    want = checkpoint.params_from_jax(jax.tree_util.tree_map(np.asarray, jcheckpoint.convert_torch_state_dict(sd)), CFG)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    wrapped = checkpoint.convert_torch_state_dict({f"module.{k}": v for k, v in sd.items()}, CFG)
    assert_states_equal(wrapped, got)


def test_convert_raises_on_a_misshapen_leaf(reference_tar):
    _, sd = reference_tar
    bad = dict(sd)
    key = "grasp_generator.crop.mlps.layer0.bn.bn.weight"
    bad[key] = torch.zeros(bad[key].shape[0] + 1)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.convert_torch_state_dict(bad, CFG)


def test_pipeline_loads_reference_and_cli_checkpoints(reference_tar, root, tmp_path):
    path, _ = reference_tar
    pipe = GraspPipeline(cfg=CFG, device="cpu", checkpoint_path=path)
    assert_states_equal(pipe.model.state_dict(), checkpoint.load_torch_checkpoint(path, CFG))
    cli.main(argv(root, tmp_path, "--max_epoch", "1"))
    ckpt = str(tmp_path / cli.CHECKPOINT)
    pipe = GraspPipeline(cfg=CFG, device="cpu", checkpoint_path=ckpt)
    assert_states_equal(pipe.model.state_dict(), checkpoint.restore(ckpt)["model"])
    bare = str(tmp_path / "bare.pt")
    checkpoint.save(bare, checkpoint.restore(ckpt)["model"])
    assert_states_equal(GraspPipeline(cfg=CFG, device="cpu", checkpoint_path=bare).model.state_dict(),
                        pipe.model.state_dict())
