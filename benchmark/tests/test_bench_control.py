"""The control of `correct`: the reference put in the program's place one
precision below the configuration's (TF32 products) has to fail one of a
cell's limits, and so does the training cell's half-batch fault.  On the
CPU, where TF32 does not exist, the control's readings are the reference's
own and the test holds the plumbing; on the card (marker `cuda`:
`python -m pytest benchmark/tests/test_bench_control.py -m cuda`) it holds
the limits at each cell's own size on three seeds."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests import tiny

INFER = ["infer.robot_b1", "infer.robot_nofilter_b1"]
SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's TF32 products exist only on the card")
    return "cuda"


@pytest.mark.parametrize("cell", INFER)
def test_control_readings_on_the_cpu(cell):
    r = control.readings(cell, SEEDS[0], "cpu", tiny.overrides(cell))
    assert r["rows_gap"] == 0.0 and r["selection_diff"] == 0  # float32 is float32 on the CPU


def test_training_fault_readings_on_the_cpu():
    r = control.train_readings("train.recipe_b2", SEEDS[0], "cpu", tiny.overrides("train.recipe_b2"))
    limits = harness.load_json("workloads", "train.recipe_b2")["limits"]
    assert any(r["half_batch"][k] > limits[k] for k in limits)


def _fails(readings, limits):
    return any(readings[k] > v for k, v in limits.items() if k in readings)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", INFER)
def test_control_fails_a_limit_on_the_card(cell, card):
    limits = harness.load_json("workloads", cell)["limits"]
    for seed in SEEDS:
        assert _fails(control.readings(cell, seed, card), limits), seed


@pytest.mark.cuda
def test_training_control_and_fault_fail_a_limit_on_the_card(card):
    limits = harness.load_json("workloads", "train.recipe_b2")["limits"]
    for seed in SEEDS:
        r = control.train_readings("train.recipe_b2", seed, card)
        assert _fails(r["control"], limits) and _fails(r["half_batch"], limits), r
