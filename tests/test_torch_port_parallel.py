"""Parallel inference: the port's `parallel/` against the JAX package's, and
the entry points that take a mesh, on the CPU.

* `data_parallel_infer` on ["cpu"] * 2, `candidate_sharded_infer` on 2 and
  4 shards and the hybrid 2 x 2 mesh, against the JAX functions on the
  conftest's virtual CPU devices with the same weights
  (`checkpoint.params_from_jax`): `valid` equal, grasps within 1e-5 (the
  JAX test's bound, tests/test_parallel.py:42).  Each takes ~2 s here.
* The indivisible-axis assertions ("not divisible").
* `GraspPipeline(mesh=)` top-50 against the unsharded pipeline, with a
  batch the data axis does not divide; `GraspService` with
  `candidate_devices=2`, `data_devices=2` and both against the one-device
  service, and the `max_batch` ValueError; `apps/test.py --devices 2`
  dumps equal to `--devices 1`.
* The mesh helpers, the single-process runtime, and the launch
  environment (GRASPNET_* and torchrun) reaching init_process_group.

A mesh that repeats the CPU runs the sharded code path on one device;
whether several cards run at once is for the card.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.parallel import candidate_sharded_infer as jax_candidate
from graspnet_tpu.parallel import data_parallel_infer as jax_data_parallel
from graspnet_tpu.parallel import make_mesh as jax_make_mesh

from graspnet_tpu_torch import checkpoint, parallel
from graspnet_tpu_torch.apps import GraspPipeline
from graspnet_tpu_torch.apps import test as app
from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig
from graspnet_tpu_torch.checkpoint import params_from_jax
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.models import GraspNet
from graspnet_tpu_torch.parallel import distributed
from graspnet_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch

from tests.mini_dataset import make_mini_dataset
from tests.test_torch_port_checkpoint import jax_params

ATOL = 1e-5
SELECTION_COLS = [2, 3, 13, 14, 15, 16]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = JConfig.tiny(), GraspNetConfig.tiny()
    params = jax_params(jcfg, 0)
    model = GraspNet(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    model.eval().requires_grad_(False)
    rng = np.random.default_rng(0)
    clouds = rng.uniform(-0.3, 0.3, (4, cfg.num_point, 3)).astype(np.float32)
    return jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, params), model, clouds


def cpu_mesh(n, names=("data",), shape=None):
    return make_mesh(n, names, devices=["cpu"] * n, shape=shape)


def assert_decode_equal(got, want):
    grasps, valid = (t.numpy() for t in got)
    wg, wv = (np.asarray(t) for t in jax.device_get(want))
    np.testing.assert_array_equal(valid, wv)
    assert valid.any()
    np.testing.assert_allclose(grasps, wg, rtol=0, atol=ATOL)


def test_data_parallel_matches_jax(tiny):
    jcfg, cfg, params, model, clouds = tiny
    got = parallel.data_parallel_infer(model, cfg, cpu_mesh(2))(torch.from_numpy(clouds[:2]))
    want = jax_data_parallel(jcfg, jax_make_mesh(2))(params, jnp.asarray(clouds[:2]))
    assert_decode_equal(got, want)


@pytest.mark.parametrize("n", [2, 4])
def test_candidate_sharded_matches_jax(tiny, n):
    jcfg, cfg, params, model, clouds = tiny
    got = parallel.candidate_sharded_infer(model, cfg, cpu_mesh(n, ("candidate",)))(torch.from_numpy(clouds[:1]))
    want = jax_candidate(jcfg, jax_make_mesh(n, ("candidate",)))(params, jnp.asarray(clouds[:1]))
    assert_decode_equal(got, want)


def test_hybrid_mesh_matches_jax(tiny):
    jcfg, cfg, params, model, clouds = tiny
    mesh = cpu_mesh(4, ("data", "candidate"), shape=(2, 2))
    got = parallel.candidate_sharded_infer(model, cfg, mesh, data_axis="data")(torch.from_numpy(clouds[:2]))
    jmesh = jax_make_mesh(4, ("data", "candidate"), shape=(2, 2))
    want = jax_candidate(jcfg, jmesh, data_axis="data")(params, jnp.asarray(clouds[:2]))
    assert_decode_equal(got, want)


def test_rejects_indivisible_axes(tiny):
    _, cfg, _, model, clouds = tiny
    with pytest.raises(AssertionError, match="not divisible"):
        parallel.candidate_sharded_infer(model, cfg, cpu_mesh(7, ("candidate",)))
    hybrid = parallel.candidate_sharded_infer(model, cfg, cpu_mesh(4, ("data", "candidate"), shape=(2, 2)),
                                              data_axis="data")
    with pytest.raises(AssertionError, match="not divisible"):
        hybrid(torch.from_numpy(clouds[:3]))
    with pytest.raises(AssertionError, match="not divisible"):
        parallel.data_parallel_infer(model, cfg, cpu_mesh(2))(torch.from_numpy(clouds[:3]))


def test_mesh_helpers(tiny):
    _, _, _, model, clouds = tiny
    mesh = cpu_mesh(4, ("data", "candidate"), shape=(2, 2))
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 2, "candidate": 2} and mesh.size == 4
    assert mesh.distinct() == [torch.device("cpu")]
    replicas = replicate(mesh, model)
    assert list(replicas) == [torch.device("cpu")] and replicas[torch.device("cpu")] is model
    parts = shard_batch(mesh, {"x": torch.from_numpy(clouds), "s": torch.tensor(1.0)}, axis="data")
    assert len(parts) == 2 and parts[1]["x"].shape == (2, *clouds.shape[1:]) and parts[1]["s"].item() == 1.0
    np.testing.assert_array_equal(parts[1]["x"].numpy(), clouds[2:])
    assert cpu_mesh(3).shape == {"data": 3}
    # no card stands in for another: more cards than the host has raise
    with pytest.raises(RuntimeError, match="CUDA device"):
        make_mesh(max(2, torch.cuda.device_count() + 1))


def test_distributed_helpers_single_process(monkeypatch):
    for k in ("GRASPNET_COORDINATOR", "GRASPNET_NUM_PROCESSES", "GRASPNET_PROCESS_ID", "MASTER_ADDR",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not distributed.initialize()
    assert distributed.process_local_batch_slice(8) == slice(0, 8)
    assert distributed.local_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("GRASPNET_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize()


def assert_topk_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.grasp_group_array, w.grasp_group_array
        assert g.shape == w.shape and len(g) > 0
        np.testing.assert_array_equal(g[:, SELECTION_COLS], w[:, SELECTION_COLS])
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("names,shape,batches", [
    (("data",), (2,), (2, 4, 3)),
    (("candidate",), (2,), (1, 3)),
    (("data", "candidate"), (2, 2), (2, 1)),
], ids=["data", "candidate", "hybrid"])
def test_pipeline_mesh_topk_matches_unsharded(tiny, names, shape, batches):
    """Top-50 rows through the mesh equal the unsharded pipeline's; a batch
    the data axis does not divide goes through the unsharded program."""
    _, cfg, _, model, clouds = tiny
    plain = GraspPipeline(params=model.state_dict(), cfg=cfg, device="cpu")
    mesh = make_mesh(int(np.prod(shape)), names, devices=["cpu"] * int(np.prod(shape)), shape=shape)
    sharded = GraspPipeline(params=model.state_dict(), cfg=cfg, device="cpu", mesh=mesh)
    calls = []
    inner = sharded._sharded
    sharded._sharded = lambda x: calls.append(x.shape[0]) or inner(x)
    for b in batches:
        assert_topk_equal(sharded.get_grasps_topk_batch(clouds[:b]), plain.get_grasps_topk_batch(clouds[:b]))
        assert_topk_equal(sharded.get_grasps_batch(clouds[:b]), plain.get_grasps_batch(clouds[:b]))
    data = shape[0] if names[0] == "data" else 1
    assert calls == [b for b in batches for _ in range(2) if b % data == 0]


@pytest.fixture(scope="module")
def weights(tmp_path_factory, tiny):
    _, cfg, _, model, _ = tiny
    path = str(tmp_path_factory.mktemp("parallel_weights") / "weights.pt")
    checkpoint.save(path, model.state_dict())
    return path


def service(weights, **kw):
    return GraspService(ServiceConfig(model_cfg=GraspNetConfig.tiny(), checkpoint_path=weights, depth_min=0.0,
                                      depth_max=10.0, collision_thresh=-1, device="cpu", **kw))


@pytest.mark.parametrize("kw", [dict(candidate_devices=2), dict(data_devices=2, max_batch=2),
                                dict(candidate_devices=2, data_devices=2, max_batch=4)],
                         ids=["candidate", "data", "hybrid"])
def test_service_meshes_match_one_device(weights, kw):
    rng = np.random.default_rng(7)
    clouds = []
    for _ in range(2):
        c = rng.uniform(-0.3, 0.3, (3000, 3)).astype(np.float32)
        c[:, 2] += 0.5
        clouds.append(c)
    one = service(weights)
    many = service(weights, **kw)
    try:
        mesh = many.pipe.mesh
        assert mesh is not None and mesh.size == kw.get("candidate_devices", 1) * kw.get("data_devices", 1)
        for c in clouds:
            got, want = many.compute(c), one.compute(c)
            assert got["ok"] and want["ok"]
            np.testing.assert_array_equal(np.asarray(got["grasps"])[:, SELECTION_COLS],
                                          np.asarray(want["grasps"])[:, SELECTION_COLS])
            np.testing.assert_allclose(got["grasps"], want["grasps"], rtol=0, atol=ATOL)
            np.testing.assert_allclose(got["tf_pose"], want["tf_pose"], rtol=0, atol=ATOL)
    finally:
        one.close()
        many.close()


@pytest.mark.parametrize("max_batch", [1, 3])
def test_data_devices_need_a_multiple_max_batch(max_batch):
    with pytest.raises(ValueError, match="max_batch"):
        GraspService(ServiceConfig(model_cfg=GraspNetConfig.tiny(), device="cpu", data_devices=2,
                                   max_batch=max_batch))


def test_test_app_devices_two_dumps_equal_one(tmp_path, weights):
    root = make_mini_dataset(str(tmp_path / "mini"), num_view=60, n_frames=5)
    dumps = {}
    for n in (1, 2):
        dumps[n] = tmp_path / f"dump{n}"
        assert app.main(["--dataset_root", root, "--camera", "realsense", "--dump_dir", str(dumps[n]), "--tiny",
                         "--device", "cpu", "--batch_size", "2", "--devices", str(n), "--num_workers", "1",
                         "--checkpoint_path", weights, "--skip_eval"]) == 0
    files = sorted(os.path.relpath(os.path.join(d, f), dumps[1]) for d, _, fs in os.walk(dumps[1]) for f in fs)
    assert len(files) == 5  # 5 frames at a batch of 2 x 2: the tail batch padded to the mesh
    for rel in files:
        got, want = np.load(dumps[2] / rel), np.load(dumps[1] / rel)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:, SELECTION_COLS], want[:, SELECTION_COLS])
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("env,device,backend,want", [
    ({"GRASPNET_COORDINATOR": "h0:8476", "GRASPNET_NUM_PROCESSES": "4", "GRASPNET_PROCESS_ID": "2"}, "cuda", None,
     ("nccl", "tcp://h0:8476", 4, 2)),
    ({"MASTER_ADDR": "h1", "MASTER_PORT": "29400", "WORLD_SIZE": "2", "RANK": "1"}, "cpu", None,
     ("gloo", "tcp://h1:29400", 2, 1)),
    ({"MASTER_ADDR": "h1", "MASTER_PORT": "29400", "WORLD_SIZE": "2", "RANK": "0"}, "cuda", "gloo",
     ("gloo", "tcp://h1:29400", 2, 0)),
], ids=["graspnet_env", "torchrun_cpu", "named_backend"])
def test_initialize_reads_the_launch_environment(monkeypatch, env, device, backend, want):
    """GRASPNET_* and torchrun's variables reach init_process_group, with
    NCCL for CUDA and gloo for the CPU unless the caller names one."""
    for k in ("GRASPNET_COORDINATOR", "GRASPNET_NUM_PROCESSES", "GRASPNET_PROCESS_ID", "MASTER_ADDR",
              "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = []
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda b, init_method, world_size, rank: seen.append((b, init_method, world_size, rank)))
    assert distributed.initialize(backend=backend, device=device)
    assert seen == [want]
