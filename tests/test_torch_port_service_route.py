"""The service's two routes to the forward and the collision filter, on the CPU.

On the card at max_batch 1, `GraspService.compute` windows and samples the
capture there and hands the pipeline and the collision filter tensors on
the card; micro-batched or on the CPU it does both in numpy.  What the
card route is made of is held here on the CPU against the numpy code, bit
for bit: `depth_window` against numpy's boolean window (bounds at the
float32 edges), `sample_indices` against `default_rng(0).choice`,
`sample_cloud`, `GraspPipeline.run` and the collision filter given torch
tensors against the same clouds given as numpy.  The card route itself is
held against the host route in `tests/test_torch_port_cuda.py`.
"""

import numpy as np
import pytest
import torch

from graspnet_tpu_torch.apps.pipeline import GraspPipeline, sample_indices
from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig, depth_window
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.postproc import GraspGroup, ModelFreeCollisionDetector, detect_batch
from graspnet_tpu_torch.utils import tracing
from graspnet_tpu_torch.utils.synthetic import tabletop_cloud

from tests.test_torch_port_voxel import grasp_rows

DEPTH = (0.3, 0.6)  # the service's default window


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def window_edges(dtype=np.float32):
    """z at each bound rounded to `dtype` and at its neighbours on both sides."""
    z = []
    for b in DEPTH:
        v = np.asarray(b, dtype)
        z += [v, np.nextafter(v, dtype(0)), np.nextafter(v, dtype(1))]
    return np.asarray(z, dtype)


def capture(rng, n, z_low=0.2, z_high=0.7, dtype=np.float32):
    """An (n, 3) capture with z in [z_low, z_high] and, when the window
    cuts it, the edges' z on its first rows."""
    pts = rng.uniform(-0.3, 0.3, (n, 3)).astype(dtype)
    pts[:, 2] = rng.uniform(z_low, z_high, n)
    if z_low < DEPTH[0] or z_high > DEPTH[1]:
        pts[:6, 2] = window_edges(dtype)
    return pts


def numpy_window(cloud):
    z = cloud[:, 2]
    return cloud[(z >= DEPTH[0]) & (z <= DEPTH[1])]


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint8), np.ascontiguousarray(want).view(np.uint8))


@pytest.mark.parametrize("case", ["partial", "inside", "float64", "edges_only"])
def test_depth_window_is_numpys_window(case):
    rng = np.random.default_rng(40)
    cloud = {"partial": lambda: capture(rng, 5000),
             "inside": lambda: capture(rng, 5000, 0.35, 0.55),
             "float64": lambda: capture(rng, 5000, dtype=np.float64),
             "edges_only": lambda: capture(rng, 500, 0.7, 0.9)}[case]()
    want = numpy_window(cloud)
    assert_bitwise(depth_window(cloud, *DEPTH, "cpu"), want)
    if case == "partial":  # the bound itself is kept, its outer neighbour is not
        assert 0 < len(want) < len(cloud)
        kept = set(want[:, 2].tolist())
        edges = window_edges()
        assert {edges[0], edges[2], edges[3], edges[4]} <= kept and not {edges[1], edges[5]} & kept


@pytest.mark.parametrize("n", [700, 512, 300])
def test_sample_indices_are_the_seeded_draw(n):
    """Above and at num_point, `default_rng(0).choice` without replacement;
    below it, every row and then a draw with replacement."""
    num_point = 512
    if n >= num_point:
        want = np.random.default_rng(0).choice(n, num_point, replace=False)
    else:
        want = np.concatenate([np.arange(n), np.random.default_rng(0).choice(n, num_point - n, replace=True)])
    np.testing.assert_array_equal(sample_indices(n, num_point), want)
    assert len(set(sample_indices(n, num_point).tolist())) == min(n, num_point)


@pytest.fixture(scope="module")
def pipe():
    return GraspPipeline(cfg=GraspNetConfig.tiny(), seed=0, device="cpu")  # seed 0: valid objectness


@pytest.mark.parametrize("n", [700, 300])
def test_sample_cloud_gathers_a_tensor_where_it_lies(pipe, n):
    cloud = capture(np.random.default_rng(41), n)
    got = pipe.sample_cloud(torch.from_numpy(cloud))
    assert isinstance(got, torch.Tensor)
    assert_bitwise(got, pipe.sample_cloud(cloud))


def test_pipeline_run_takes_tensors(pipe):
    """The forward and the filter given tensors return the rows they return
    for the same clouds as numpy, bit for bit."""
    scene = tabletop_cloud(np.random.default_rng(42), 20000)
    sampled = pipe.sample_cloud(scene)
    # random weights' grasps mostly collide at 0.01: at 0.3 some pass, some do not
    kw = dict(collision_thresh=0.3, voxel_size=0.01, nms=False, top_k=0)
    want = pipe.run(sampled, scene_cloud=scene, **kw).grasp_group_array
    got = pipe.run(torch.from_numpy(sampled), scene_cloud=torch.from_numpy(scene), **kw).grasp_group_array
    assert len(want) > 0
    assert_bitwise(got, want)
    unfiltered = pipe.get_grasps(torch.from_numpy(sampled)).grasp_group_array
    assert_bitwise(unfiltered, pipe.get_grasps(sampled).grasp_group_array)
    assert len(want) < len(unfiltered)  # the filter took some
    top = pipe.get_grasps_topk(torch.from_numpy(sampled), top_k=10).grasp_group_array
    assert_bitwise(top, pipe.get_grasps_topk(sampled, top_k=10).grasp_group_array)


def test_collision_filter_takes_a_tensor_scene():
    rng = np.random.default_rng(43)
    clouds = [tabletop_cloud(rng, 60000), tabletop_cloud(rng, 30000)]
    groups = [GraspGroup(grasp_rows(rng, c, 128)) for c in clouds]
    kw = dict(approach_dist=0.05, collision_thresh=0.01, return_empty_grasp=True, return_ious=True)
    for c, g in zip(clouds, groups):
        want = ModelFreeCollisionDetector(c, voxel_size=0.01, device="cpu")
        got = ModelFreeCollisionDetector(torch.from_numpy(c), voxel_size=0.01, device="cpu")
        assert_bitwise(got.scene_points, want.scene_points)
        (gm, ge, gi), (wm, we, wi) = got.detect(g, **kw), want.detect(g, **kw)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(ge, we)
        for a, b in zip(gi, wi):
            assert_bitwise(a, b)
    batch = dict(voxel_size=0.01, approach_dist=0.05, collision_thresh=0.01, device="cpu")
    want = detect_batch(clouds, groups, **batch)
    got = detect_batch([torch.from_numpy(c) for c in clouds], groups, **batch)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert 0 < sum(m.sum() for m in want) < sum(len(g) for g in groups)


def test_cpu_service_takes_the_host_route():
    """The `service.sample` span counts the capture's points, the window's
    rows and card 0 on the CPU, and the rejection reads as before."""
    svc = GraspService(ServiceConfig(model_cfg=GraspNetConfig.tiny(), collision_thresh=0.01, device="cpu"))
    rng = np.random.default_rng(44)
    cloud, far = capture(rng, 3000), capture(rng, 3000, 0.7, 0.9)  # far: the 4 edge rows in the window
    with tracing.recording() as rec:
        reply = svc.compute(cloud)
        rejected = svc.compute(far)
    assert reply["ok"] and "service.sample" in reply["timings_ms"]
    assert rejected == {"ok": False, "error": "not enough points in depth range"}
    counts = [s.counts for s in rec.drain() if s.name == "service.sample"]
    assert counts == [{"points": 3000, "card": 0, "window": len(numpy_window(cloud))},
                      {"points": 3000, "card": 0, "window": 4}]
