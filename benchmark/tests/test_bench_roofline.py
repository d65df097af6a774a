"""`roofline.py`'s operation and byte counts against hand counts at
`GraspNetConfig.tiny()`."""

import pytest

from benchmark import roofline


@pytest.fixture
def tiny():
    from graspnet_tpu_torch.config import GraspNetConfig

    return GraspNetConfig.tiny()


def test_forward_flops_by_hand(tiny):
    # tiny: 512 points; SA (128, 16, 3-8-8-16), (64, 8, 19-16-16-32), (32, 8, 35-16-16-32) x 2;
    # FP (64-32-32) at 32 and 64 points; 64 seeds, 60 views, 4 depths, 16 samples, crop 3-8-16-32, heads 16
    sa1 = 128 * 16 * 2 * (3 * 8 + 8 * 8 + 8 * 16)
    sa2 = 64 * 8 * 2 * (19 * 16 + 16 * 16 + 16 * 32)
    sa3 = 32 * 8 * 2 * (35 * 16 + 16 * 16 + 16 * 32)
    sa4 = 16 * 8 * 2 * (35 * 16 + 16 * 16 + 16 * 32)
    fp = (32 + 64) * 2 * (64 * 32 + 32 * 32)
    approach = 64 * 2 * (32 * 32 + 32 * 62 + 62 * 62)
    crop = 64 * 4 * 16 * 2 * (3 * 8 + 8 * 16 + 16 * 32)
    heads = 64 * 4 * 2 * ((32 * 16 + 16 * 16 + 16 * 36) + (32 * 16 + 16 * 16 + 16 * 12))
    one = sa1 + sa2 + sa3 + sa4 + fp + approach + crop + heads
    assert roofline.forward_flops(tiny, 1) == one
    assert roofline.forward_flops(tiny, 4) == 4 * one
    assert roofline.train_step_flops(tiny, 2) == 3 * 2 * one


def test_fps_bound_by_hand(tiny):
    flops = 2 * ((128 - 1) * 512 + (64 - 1) * 128 + (32 - 1) * 64 + (16 - 1) * 32) * 9
    nbytes = 2 * 512 * 3 * 4 + 2 * (128 + 64 + 32 + 16) * 8
    assert roofline.fps_bound_s(tiny, 2) == pytest.approx(max(flops / 67e12, nbytes / 3.35e12), rel=1e-12)


def test_mlp_train_backward_bound_by_hand(tiny):
    rows = 2 * 64 * 4 * 16
    flops = rows * (2 * (2 * 16 * 32) + 2 * (2 * 8 * 16) + 2 * 3 * 8)
    wbytes = (3 * 8 + 8 * 16 + 16 * 32 + 2 * (8 + 16 + 32)) * 4
    nbytes = (rows * 3 + 2 * 64 * 4 * 32) * 4 + 2 * wbytes
    want = max(3 * flops / 495e12, nbytes / 3.35e12)
    assert roofline.mlp_train_backward_bound_s(tiny, 2) == pytest.approx(want, rel=1e-12)


def test_bound_takes_the_larger_side():
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(0, flops=67e12) == pytest.approx(1.0)
    assert roofline.bound_s(0, mlp_flops=495e12) == pytest.approx(3.0)
