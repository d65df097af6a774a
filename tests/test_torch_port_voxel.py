"""The voxel downsample's plain version (`ops/voxel.py`) against the host
library's (`native.voxel_downsample`, `csrc/host.cpp`), on the CPU.

The plain version is the twin the card's kernel is held to
(tests/test_torch_port_cuda.py runs the same cases there), so it is held
bitwise to the library as a set of rows: the same cells (the float32
voxel, the double quantisation, the 21-bit-an-axis key) and the same
float32 centroids (each cell's double sum in ascending source order).  The
cases: seeded 250k-point tabletop captures at the voxel sizes the filter
uses, and the edges: no points, one point, one cell holding every point
(a long sum that rounds, so its order shows), duplicates, points exactly
on cell faces, negative coordinates and far outliers that wrap the key.

The collision filter on the CPU still downsamples on the host library and
calls nothing else; its `collision.downsample` span counts the raw points
and the voxels kept.
"""

import numpy as np
import pytest
import torch

from graspnet_tpu_torch import native
from graspnet_tpu_torch.models import geometry
from graspnet_tpu_torch.ops.voxel import voxel_downsample, voxel_downsample_plain
from graspnet_tpu_torch.postproc import GraspGroup, ModelFreeCollisionDetector, collision, detect_batch
from graspnet_tpu_torch.utils import tracing
from graspnet_tpu_torch.utils.synthetic import tabletop_cloud

BIG = np.float32(2.0**40)  # the long cell's cancelling coordinates: ulp 2^-12 in double


def sorted_rows(a):
    a = np.asarray(a)
    return a[np.lexsort(a.T[::-1])]


def _long_cell(rng):
    """20k points in one 2^43 cell: small coordinates with +-2^40 among
    them, so each cell sum rounds and its order shows in the float32 mean."""
    pts = rng.uniform(0, 1, (20000, 3)).astype(np.float32)
    pts[::10] = BIG
    pts[5::10] = -BIG
    return pts, 2.0**43


def _faces(rng):
    """Coordinates on the faces min - voxel / 2 + k * voxel of a 1/8 grid,
    where (p - min_bound) / voxel is an exact integer."""
    k = rng.integers(0, 40, (5000, 3))
    pts = (k * 0.125 - 0.0625).astype(np.float32)
    pts[0] = -0.0625 - 0.0625  # the minimum sets the anchor at -0.1875
    return pts[rng.permutation(len(pts))], 0.125


def grasp_rows(rng, cloud, m):
    """(m, 17) grasp rows centred on points of `cloud`, turned every way,
    so that some collide with it and some do not."""
    g = np.zeros((m, 17), np.float32)
    towards = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32))
    angles = torch.from_numpy(rng.uniform(0, np.pi, m).astype(np.float32))
    g[:, 0] = rng.uniform(0, 1, m)  # score
    g[:, 1] = rng.uniform(0.02, 0.1, m)  # width
    g[:, 2] = 0.02  # height
    g[:, 3] = rng.uniform(0.01, 0.04, m)  # depth
    g[:, 4:13] = geometry.batch_viewpoint_params_to_matrix(towards, angles).numpy().reshape(m, 9)
    g[:, 13:16] = cloud[rng.choice(len(cloud), m, replace=False)] + rng.normal(0, 0.02, (m, 3))
    g[:, 16] = -1
    return g


def voxel_cases():
    """name -> ((N, 3) float32 points, voxel), each from its own seed."""
    cases = {}
    for voxel in (0.01, 0.005):
        cases[f"tabletop_250k_{voxel}"] = (tabletop_cloud(np.random.default_rng(20), 250000), voxel)
    rng = np.random.default_rng(21)
    cases["empty"] = (np.zeros((0, 3), np.float32), 0.01)
    cases["one_point"] = (np.array([[0.1, -0.2, 0.55]], np.float32), 0.01)
    cases["one_cell_long_sum"] = _long_cell(rng)
    base = tabletop_cloud(rng, 3000)
    dup = np.concatenate([base, base[:1000], base[:1000], np.repeat(base[:1], 500, 0)])
    cases["duplicates"] = (dup[rng.permutation(len(dup))], 0.01)
    cases["cell_faces"] = _faces(rng)
    cases["cell_faces_0.01"] = ((rng.integers(-30, 30, (4000, 3)) * 0.01).astype(np.float32), 0.01)
    cases["negative"] = (tabletop_cloud(rng, 20000) - np.float32(1.5), 0.005)
    far = tabletop_cloud(rng, 20000)
    far[rng.choice(len(far), 40, replace=False)] = rng.uniform(-3e4, 3e4, (40, 3))  # past 2^21 cells
    cases["far_outliers"] = (far, 0.005)
    return cases


CASES = voxel_cases()


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_is_bitwise_the_host_library(name):
    pts, voxel = CASES[name]
    got = voxel_downsample_plain(torch.from_numpy(pts), voxel)
    want = native.voxel_downsample(pts, voxel)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(sorted_rows(got.numpy()), sorted_rows(want))
    # the CPU route of the wrapper is the plain version
    assert torch.equal(voxel_downsample(torch.from_numpy(pts), voxel), got)


def test_rows_come_in_the_order_of_each_cells_first_point():
    pts = np.array([[0.5, 0, 0], [0, 0, 0], [0.501, 0, 0], [0.9, 0, 0], [0.002, 0, 0]], np.float32)
    got = voxel_downsample_plain(torch.from_numpy(pts), 0.01).numpy()
    want = np.array([[0.5005, 0, 0], [0.001, 0, 0], [0.9, 0, 0]], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0, 0] > got[1, 0] < got[2, 0]


def test_the_long_cell_sum_depends_on_its_order():
    """The one-cell case means something: summed in reverse, the float32
    mean differs, so only the ascending order matches the library."""
    pts, voxel = CASES["one_cell_long_sum"]
    x = pts.astype(np.float64)
    ahead, back = np.cumsum(x, 0)[-1], np.cumsum(x[::-1], 0)[-1]
    assert not np.array_equal((ahead / len(x)).astype(np.float32), (back / len(x)).astype(np.float32))
    np.testing.assert_array_equal(native.voxel_downsample(pts, voxel)[0], (ahead / len(x)).astype(np.float32))


def test_far_outliers_wrap_the_key_as_the_library_does():
    """Cells 2^21 apart on an axis share a key, in both."""
    pts = np.array([[0, 0, 0], [0.01 * 2**21, 0, 0], [0.5, 0.5, 0.5]], np.float32)
    got = voxel_downsample_plain(torch.from_numpy(pts), 0.01)
    assert len(got) == len(native.voxel_downsample(pts, 0.01)) == 2


def test_plain_rejects_a_wrong_shape():
    with pytest.raises(ValueError):
        voxel_downsample_plain(torch.zeros(4, 2), 0.01)


def test_the_cpu_filter_downsamples_on_the_host_library(monkeypatch):
    """On the CPU the detector and detect_batch call the host library and
    never the kernel route; the span counts points in and voxels out."""
    rng = np.random.default_rng(22)
    cloud = tabletop_cloud(rng, 6000)
    g = grasp_rows(rng, cloud, 16)
    calls = []
    monkeypatch.setattr(collision, "voxel_downsample", lambda *a: calls.append("kernel"))
    want = native.voxel_downsample(cloud, 0.01)
    with tracing.recording() as rec:
        det = ModelFreeCollisionDetector(cloud, voxel_size=0.01, device="cpu")
        detect_batch([cloud, cloud[:3000]], [GraspGroup(g)] * 2, voxel_size=0.01, device="cpu")
    assert calls == []
    assert isinstance(det.scene_points, np.ndarray)
    np.testing.assert_array_equal(sorted_rows(det.scene_points), sorted_rows(want))
    spans = [s for s in rec.drain() if s.name == "collision.downsample"]
    assert [s.counts for s in spans] == [
        {"points": 6000, "voxels": len(want)},
        {"points": 9000, "voxels": len(want) + len(native.voxel_downsample(cloud[:3000], 0.01))}]
