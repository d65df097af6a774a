"""The plain reference against the port's CPU path at `GraspNetConfig.tiny()`:
the same weights and clouds give the same decoded rows, filtered rows and
training steps."""

import numpy as np
import pytest
import torch

from benchmark.inputs.tabletop import capture_pool
from benchmark.reference import gn, judge
from benchmark.tests import tiny
from benchmark.weights import make_weights


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(cfg):
    shapes = {k: tuple(v.shape) for k, v in gn.GraspNet(cfg).state_dict().items()}
    return make_weights(shapes, tiny.TINY_WEIGHT_SEED, "cpu")


def test_decode_rows_equal_the_ports():
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.models import GraspNet, pred_decode

    cfg = gn.GraspNetConfig.tiny()
    w = _weights(cfg)
    model = GraspNet(GraspNetConfig.tiny())
    model.load_state_dict(w)
    model.eval()
    clouds = np.stack([c[:512] for c in capture_pool(3, 2, 4000)])
    with torch.no_grad():
        want, valid = pred_decode(model(torch.from_numpy(clouds)), GraspNetConfig.tiny())
    got, got_valid = judge.Reference(cfg, w, "cpu").rows(clouds)
    assert valid.all() and np.array_equal(got_valid, valid.numpy())
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("thresh", [0.01, -1.0])
def test_service_reply_equals_the_ports(thresh):
    from graspnet_tpu_torch import checkpoint
    from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig
    from graspnet_tpu_torch.config import GraspNetConfig

    cfg = gn.GraspNetConfig.tiny()
    w = _weights(cfg)
    cloud = capture_pool(5, 1, 4000)[0]
    serving = {"collision_thresh": thresh, "voxel_size": 0.01, "approach_dist": 0.05, "top_k": 50,
               "depth_min": 0.3, "depth_max": 0.6}
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "w.pt")
        checkpoint.save(path, w)
        svc = GraspService(ServiceConfig(checkpoint_path=path, model_cfg=GraspNetConfig.tiny(), num_point=512,
                                         collision_thresh=thresh, device="cpu"))
        reply = svc.compute(cloud)
    ref_all, ref_sel = judge.service_reply(judge.Reference(cfg, w, "cpu"), cloud, serving)
    got = np.asarray(reply["grasps"], np.float32)
    assert reply["ok"] and len(got) == len(ref_sel) > 0
    assert judge.compare(got, ref_all, ref_sel) == (0.0, 0)
    assert np.array_equal(got, ref_sel)


def test_compare_reads_a_changed_row_and_a_missing_one():
    rows = np.zeros((3, 17), np.float32)
    rows[:, 13] = [0.1, 0.2, 0.3]
    assert judge.compare(rows, rows, rows) == (0.0, 0)
    moved = rows.copy()
    moved[1, 0] += 0.5
    assert judge.compare(moved, rows, rows)[0] == pytest.approx(0.5)
    assert judge.compare(rows[:2], rows, rows) == (0.0, 1)
    alien = rows.copy()
    alien[0, 14] = 9.0
    assert judge.compare(alien, rows, rows)[0] == float("inf")


def test_training_steps_follow_the_ports():
    from benchmark import run

    res = run.run_cell("train.recipe_b2", 2**33 + 3, 1.0, False, device="cpu", overrides=tiny.overrides("train.recipe_b2"))
    c = res["checks"]
    assert res["correct"], c
    assert c["change_gap"]["value"] == 0.0
    assert c["grad_gap"]["value"] < 1e-6  # the first moment over 1 - beta1 rounds once
