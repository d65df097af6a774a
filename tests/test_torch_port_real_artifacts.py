"""The published-artifact gates for the port: the counterpart of
`tests/test_real_artifacts.py`, through `graspnet_tpu_torch` alone.

The published checkpoints (`checkpoint-rs.tar` / `checkpoint-kn.tar`,
reference README.md:74-83) and the GraspNet-1B dataset are not in the
repository.  Point the same environment variables at them and run

    GRASPNET_CHECKPOINT=/path/checkpoint-rs.tar \\
    GRASPNET_DATASET_ROOT=/data/graspnet \\
    GRASPNET_EXAMPLE_DATA=/path/doc/example_data \\
    GRASPNET_GOLDEN_TOP50=/path/ref_top50.npy \\
    pytest -m real_artifacts tests/test_torch_port_real_artifacts.py

Each test skips with a reason that names the missing path.  The port runs
on the card when there is one, else on the CPU (`GRASPNET_DEVICE` names
another).  Gate values: `GRASPNET_EXPECT_FRAMES` (256, scene_0100's
frames) and `GRASPNET_MIN_AP` (5.0), as in the JAX file.
"""

import argparse
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.real_artifacts

CKPT = os.environ.get("GRASPNET_CHECKPOINT")
DATASET = os.environ.get("GRASPNET_DATASET_ROOT")
GOLDEN = os.environ.get("GRASPNET_GOLDEN_TOP50")
EXAMPLE_DATA = os.environ.get("GRASPNET_EXAMPLE_DATA")
EXPECT_FRAMES = int(os.environ.get("GRASPNET_EXPECT_FRAMES", "256"))
MIN_AP = float(os.environ.get("GRASPNET_MIN_AP", "5.0"))


def device() -> str:
    """Where the port runs: GRASPNET_DEVICE, else the card when there is one."""
    return os.environ.get("GRASPNET_DEVICE") or ("cuda" if torch.cuda.is_available() else "cpu")


needs_ckpt = pytest.mark.skipif(
    not (CKPT and os.path.exists(CKPT)),
    reason=f"GRASPNET_CHECKPOINT not set / file missing (got {CKPT!r}): point it at the published checkpoint-rs.tar",
)
needs_dataset = pytest.mark.skipif(
    not (DATASET and os.path.isdir(DATASET)),
    reason=f"GRASPNET_DATASET_ROOT not set / dir missing (got {DATASET!r}): point it at the GraspNet-1B root",
)
needs_example = pytest.mark.skipif(
    not (EXAMPLE_DATA and os.path.exists(os.path.join(EXAMPLE_DATA, "color.png"))),
    reason=f"GRASPNET_EXAMPLE_DATA not set / frame missing (got {EXAMPLE_DATA!r}): point it at the reference "
    "doc/example_data",
)


@pytest.fixture(scope="module")
def converted():
    from graspnet_tpu_torch import checkpoint

    return checkpoint.load_torch_checkpoint(CKPT)


@needs_ckpt
class TestCheckpointConversion:
    def test_conversion_consumes_every_weight(self, converted):
        """The converted state dict holds exactly the file's values (torch's
        num_batches_tracked counters left out)."""
        raw = torch.load(CKPT, map_location="cpu", weights_only=True)
        sd = raw.get("model_state_dict", raw)
        n_sd = sum(v.numel() for k, v in sd.items() if "num_batches_tracked" not in k)
        n = sum(v.numel() for v in converted.values())
        assert n == n_sd, f"conversion lost/invented weights: {n:,} vs state dict {n_sd:,}"

    def test_roundtrip_through_the_port_format(self, converted, tmp_path):
        from graspnet_tpu_torch import checkpoint

        path = str(tmp_path / "ckpt.pt")
        checkpoint.save(path, converted)
        back = checkpoint.restore(path)
        assert set(back) == set(converted)
        assert all(torch.equal(back[k], converted[k]) for k in converted)


@needs_ckpt
@needs_example
class TestExampleFrame:
    """The reference demo frame through the converted checkpoint; the golden
    compare is the bit-matched top-50 gate."""

    @pytest.fixture(scope="class")
    def top50(self, converted):
        from graspnet_tpu_torch.apps.image_demo import load_frame
        from graspnet_tpu_torch.apps.pipeline import GraspPipeline
        from graspnet_tpu_torch.config import GraspNetConfig

        pipe = GraspPipeline(params=converted, cfg=GraspNetConfig(), device=device())
        scene_cloud = load_frame(EXAMPLE_DATA)
        return pipe.run(pipe.sample_cloud(scene_cloud), scene_cloud=scene_cloud, collision_thresh=-1.0,
                        nms=False, top_k=50)

    def test_shape_and_ordering(self, top50):
        arr = top50.grasp_group_array
        assert arr.shape[1] == 17
        assert 0 < len(arr) <= 50, "a trained checkpoint finds objectness-positive seeds on the example frame"
        assert np.all(np.diff(arr[:, 0]) <= 1e-6), "rows must be score-sorted"
        assert np.all(arr[:, 1] <= 0.1 + 1e-6), "width clamp (loss_utils)"
        assert np.allclose(arr[:, 2], 0.02), "height contract (graspnet.py:88)"

    @pytest.mark.skipif(
        not (GOLDEN and os.path.exists(GOLDEN)),
        reason=f"GRASPNET_GOLDEN_TOP50 not set / file missing (got {GOLDEN!r}): point it at a (50, 17) .npy "
        "dumped by the reference torch implementation",
    )
    def test_bit_match_vs_reference_dump(self, top50):
        golden = np.load(GOLDEN)
        ours = top50.grasp_group_array[: len(golden)]
        assert ours.shape == golden.shape
        np.testing.assert_allclose(ours, golden, atol=1e-4)


@needs_ckpt
@needs_dataset
class TestOneSceneAP:
    """Dump and AP-evaluate the first seen-split scene: the smallest run of
    the README AP table (reference test.py:89-114)."""

    def test_scene_100_ap(self, tmp_path):
        from graspnet_tpu_torch.apps import test as test_app
        from graspnet_tpu_torch.config import GraspNetConfig
        from graspnet_tpu_torch.eval.ap import GraspNetEval, summarize

        args = argparse.Namespace(
            dataset_root=DATASET, camera="realsense", split="test_seen", checkpoint_path=CKPT,
            dump_dir=str(tmp_path / "dump"), num_point=20000, collision_thresh=0.01, voxel_size=0.01,
            batch_size=1, max_frames=EXPECT_FRAMES, profile_dir=None, device=device())
        test_app.inference(args, GraspNetConfig())
        res = GraspNetEval(DATASET, camera="realsense", split="test_seen").eval_scene("scene_0100",
                                                                                       str(tmp_path / "dump"))
        assert res.shape[0] == EXPECT_FRAMES, "expected all frames dumped"
        s = summarize(res)
        print(f"scene_0100 AP {s['AP']:.2f} AP0.8 {s['AP0.8']:.2f} AP0.4 {s['AP0.4']:.2f}")
        assert np.isfinite(s["AP"]) and 0.0 <= s["AP"] <= 100.0
        # a trained model: an AP of zero would mean the dump or the evaluator is broken
        assert s["AP"] > MIN_AP
