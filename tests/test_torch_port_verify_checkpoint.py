"""The port's `scripts/verify_checkpoint.py` on a fabricated reference
checkpoint and a synthetic frame, against a golden from the JAX pipeline.

The `.tar` holds seeded weights at `GraspNetConfig()` widths in the
reference's module names (`checkpoint.reference_state_dict`, held equal to
`tests/test_checkpoint.params_to_reference_state_dict`), seed 1: its
objectness is positive at every seed, so the top 50 rows are all there.
The frame is `utils/synthetic.py::write_demo_frame` in the example-data
layout.  The golden is the JAX `GraspPipeline`'s pre-NMS top 50 on the same
frame with the JAX conversion of the same file.  The script runs at
NUM_POINT sampled points (its `num_point` keyword): a CPU forward at 20000
takes most of a minute in each package.  Its own `--atol` (1e-4) decides,
as it would on the published files.
"""

import numpy as np
import pytest
import torch

from graspnet_tpu import checkpoint as jcheckpoint
from graspnet_tpu.apps.image_demo import load_frame as jload_frame
from graspnet_tpu.apps.pipeline import GraspPipeline as JPipeline
from graspnet_tpu.config import GraspNetConfig as JConfig

from graspnet_tpu_torch import checkpoint
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.models import GraspNet, init_weights
from graspnet_tpu_torch.scripts import verify_checkpoint
from graspnet_tpu_torch.utils.synthetic import write_demo_frame

from tests.test_checkpoint import params_to_reference_state_dict

NUM_POINT = 4096
WEIGHT_SEED = 1
FRAME = (96, 128)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(the .tar, its state dict, the frame's directory, the JAX golden)."""
    base = tmp_path_factory.mktemp("verify")
    state = init_weights(GraspNet(GraspNetConfig()), WEIGHT_SEED).state_dict()
    sd = checkpoint.reference_state_dict(state)
    tar = str(base / "checkpoint-rs.tar")
    torch.save({"model_state_dict": sd, "epoch": 3, "loss": torch.tensor(0.5), "optimizer_state_dict": {}}, tar)
    frame = str(base / "example_data")
    write_demo_frame(frame, np.random.default_rng(0), *FRAME)
    pipe = JPipeline(params=jcheckpoint.load_torch_checkpoint(tar), cfg=JConfig(num_point=NUM_POINT))
    scene = jload_frame(frame)
    gg = pipe.run(pipe.sample_cloud(scene), scene_cloud=scene, collision_thresh=-1.0, nms=False, top_k=50)
    golden = np.asarray(gg.grasp_group_array)
    np.save(str(base / "golden.npy"), golden)
    return tar, state, sd, frame, golden, base


def test_reference_state_dict_is_the_reference_layout(artifacts):
    _, state, sd, *_ = artifacts
    want = params_to_reference_state_dict(checkpoint.params_to_jax(state))
    assert list(sd) == list(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    back = checkpoint.convert_torch_state_dict(sd)
    assert all(torch.equal(back[k], state[k]) for k in state)


def run(argv, capsys):
    rc = verify_checkpoint.main(argv, num_point=NUM_POINT)
    return rc, capsys.readouterr().out


def test_passes_against_the_jax_golden(artifacts, capsys):
    tar, state, _, frame, golden, base = artifacts
    assert golden.shape == (50, 17)
    rc, out = run(["--checkpoint", tar, "--data_dir", frame, "--golden", str(base / "golden.npy"), "--device", "cpu"],
                  capsys)
    n = sum(v.numel() for v in state.values())
    assert f"converted params: {n:,} values (state dict: {n:,})" in out and "WARNING" not in out
    assert "top-50 grasps (score-sorted):" in out
    with capsys.disabled():
        print("\n" + next(line for line in out.splitlines() if line.startswith("max abs diff")))
    assert rc == 0 and "PASS: matches golden dump" in out, out


def test_fails_on_a_perturbed_golden(artifacts, capsys):
    tar, _, _, frame, golden, base = artifacts
    bad = golden.copy()
    bad[7, 0] += 1e-3  # one row's score
    path = str(base / "golden_perturbed.npy")
    np.save(path, bad)
    rc, out = run(["--checkpoint", tar, "--data_dir", frame, "--golden", path, "--device", "cpu"], capsys)
    assert rc == 1 and "FAIL: 1 entries exceed atol=0.0001" in out, out
    short = str(base / "golden_short.npy")
    np.save(short, np.concatenate([golden, golden[:1]]))
    rc, out = run(["--checkpoint", tar, "--data_dir", frame, "--golden", short, "--device", "cpu"], capsys)
    assert rc == 1 and "FAIL: row count 50 != golden 51" in out, out


def test_cuda_default_raises_without_a_card(artifacts):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    tar, _, _, frame, *_ = artifacts
    with pytest.raises(Exception, match="(?i)cuda"):
        verify_checkpoint.main(["--checkpoint", tar, "--data_dir", frame], num_point=NUM_POINT)
