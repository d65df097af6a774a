"""Each cell's run at a small size on the CPU, past the harness's look for
a chip: sound, it comes out correct; with the timed path broken
underneath, once for each fault the cell can have, it comes out not
correct."""

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny

CELLS = sorted(tiny.PARAMS)
SEED = 2**31 + 17  # more than 32 signed bits hold, as the checks' seeds do


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell, fault=None):
    return run.run_cell(cell, SEED, 1.0, False, device="cpu", overrides=tiny.overrides(cell), fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def _altered(finish):
    """A pipeline's fetch of rows with every score moved by 0.01: an answer
    altered where it is produced."""
    def fetch(self, handle):
        groups = finish(self, handle)
        for g in groups:
            g.grasp_group_array[:, 0] += 0.01
        return groups
    return fetch


@pytest.mark.parametrize("cell", ["infer.robot_b1", "infer.robot_nofilter_b1"])
def test_an_altered_answer_is_not_correct(cell, monkeypatch):
    from graspnet_tpu_torch.apps.pipeline import GraspPipeline

    def fault(_):
        monkeypatch.setattr(GraspPipeline, "finish_grasps_batch", _altered(GraspPipeline.finish_grasps_batch))

    res = _run(cell, fault)
    assert not res["correct"], res["checks"]
    assert res["checks"]["rows_gap"]["value"] == pytest.approx(0.01, rel=1e-3)


def _unchanged_state(trainer):
    trainer.opt.step = lambda *a, **k: None


def _half_batch(trainer):
    """Each step on its first scene alone: the loss the mean over it."""
    step = trainer._train_step

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        return x[:1] if torch.is_tensor(x) and x.dim() >= 1 and x.shape[0] == 2 else x

    trainer._train_step = lambda batch: step(cut(batch))


def _bn_stats_not_updated(trainer):
    """The step leaves the BN running means and variances as they were;
    the loss and gradients, which use the batch's stats, do not show it."""
    import graspnet_tpu_torch.train.trainer as trainer_module

    trainer._train_step = _without_bn_updates(trainer._train_step, trainer_module)


def _without_bn_updates(step, module):
    def run(batch):
        keep = module.apply_bn_updates
        module.apply_bn_updates = lambda *a, **k: None
        try:
            return step(batch)
        finally:
            module.apply_bn_updates = keep
    return run


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _bn_stats_not_updated],
                         ids=["unchanged_state", "half_batch", "bn_stats_not_updated"])
def test_a_broken_training_step_is_not_correct(fault):
    res = _run("train.recipe_b2", fault)
    assert not res["correct"], res["checks"]


def test_bn_stats_not_updated_fails_on_bn_gap_alone():
    res = _run("train.recipe_b2", _bn_stats_not_updated)
    failed = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert failed == {"bn_gap"}, res["checks"]
    assert res["checks"]["bn_gap"]["value"] == pytest.approx(1.0)
