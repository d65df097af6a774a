"""Import hygiene of the port: `graspnet_tpu_torch` and `chip_smoke.py`
import neither JAX nor anything of the JAX package (`graspnet_tpu.native`
included), build nothing from a path inside `graspnet_tpu/`, and build no
kernel when imported; with JAX blocked, a tiny serving call, a tiny
training step, the training CLI's loop over a synthetic dataset and the
eval dump loop (`apps/test.py`, dump and AP) run on the CPU, loading no library but the host label library; so does a
tiny micro-batched `GraspService.compute()` with the collision filter, a
tiny candidate-sharded pipeline on the CPU repeated twice, and the MSG
modules' forward."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "graspnet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+graspnet_tpu\b(?!_torch)"
    r"|from\s+graspnet_tpu\s+import|from\s+graspnet_tpu\.)",
    re.MULTILINE,
)

BLOCKED_RUN = """
import sys
for name in ("jax", "jaxlib", "graspnet_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib, pkgutil
import numpy as np
import graspnet_tpu_torch
walked = [mod.name for mod in pkgutil.walk_packages(graspnet_tpu_torch.__path__, "graspnet_tpu_torch.")]
for name in walked:
    importlib.import_module(name)
new = {"graspnet_tpu_torch.utils.timing", "graspnet_tpu_torch.native",
       "graspnet_tpu_torch.ops.scatter",
       "graspnet_tpu_torch.data", "graspnet_tpu_torch.data.camera", "graspnet_tpu_torch.data.dataset",
       "graspnet_tpu_torch.data.synthetic", "graspnet_tpu_torch.utils.logging",
       "graspnet_tpu_torch.apps.train",
       "graspnet_tpu_torch.postproc.voxel", "graspnet_tpu_torch.postproc.collision",
       "graspnet_tpu_torch.utils.tracing", "graspnet_tpu_torch.eval", "graspnet_tpu_torch.eval.ap",
       "graspnet_tpu_torch.eval.force_closure", "graspnet_tpu_torch.data.learnable",
       "graspnet_tpu_torch.apps.test", "graspnet_tpu_torch.scripts.learnability_gate",
       "graspnet_tpu_torch.scripts.bench_test_app", "graspnet_tpu_torch.scripts.overfit_gate",
       "graspnet_tpu_torch.scripts.bench_eval_frame",
       "graspnet_tpu_torch.apps.batching", "graspnet_tpu_torch.apps.service", "graspnet_tpu_torch.apps.demo_pointcloud",
       "graspnet_tpu_torch.apps.image_demo", "graspnet_tpu_torch.apps.segmentation_demo",
       "graspnet_tpu_torch.apps.stereo_demo", "graspnet_tpu_torch.apps.grasp_tf", "graspnet_tpu_torch.apps.grasp_base",
       "graspnet_tpu_torch.utils.transforms", "graspnet_tpu_torch.postproc.gripper", "graspnet_tpu_torch.sensors",
       "graspnet_tpu_torch.sensors.cameras", "graspnet_tpu_torch.sensors.viz",
       "graspnet_tpu_torch.scripts.bench_service", "graspnet_tpu_torch.data.tolerance",
       "graspnet_tpu_torch.apps.generate_tolerance", "graspnet_tpu_torch.parallel",
       "graspnet_tpu_torch.parallel.mesh", "graspnet_tpu_torch.parallel.distributed",
       "graspnet_tpu_torch.parallel.candidate", "graspnet_tpu_torch.scripts.multiproc_check",
       "graspnet_tpu_torch.scripts.bench_scaling",
       "graspnet_tpu_torch.models.msg", "graspnet_tpu_torch.scripts.verify_checkpoint"}
assert new <= set(walked), new - set(walked)
import chip_smoke
from graspnet_tpu_torch.apps import GraspPipeline
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.ops.cuda import build
p = GraspPipeline(cfg=GraspNetConfig.tiny(), device="cpu")
gg = p.get_grasps_topk(np.random.default_rng(0).uniform(-0.3, 0.3, (512, 3)).astype(np.float32))
assert gg.grasp_group_array.shape[1] == 17
from graspnet_tpu_torch.parallel import make_mesh
pm = GraspPipeline(cfg=GraspNetConfig.tiny(), device="cpu", mesh=make_mesh(2, ("candidate",), devices=["cpu"] * 2))
assert pm.get_grasps_topk(np.random.default_rng(0).uniform(-0.3, 0.3, (512, 3)).astype(np.float32)).grasp_group_array.shape[1] == 17
import torch
from graspnet_tpu_torch.models.msg import LFPModuleMSG, SAModuleMSG
xyz = torch.from_numpy(np.random.default_rng(2).uniform(-0.3, 0.3, (1, 256, 3)).astype(np.float32))
with torch.no_grad():
    new_xyz, feat, _, _ = SAModuleMSG([(8, 16), (8, 16)], in_dim=0, npoint=32, radii=(0.1, 0.2), nsamples=(8, 16))(xyz)
    up, _ = LFPModuleMSG([(8,)], (8,), in_dim=32, skip_dim=0, radii=(0.2,), nsamples=(8,))(xyz, new_xyz, None, feat)
assert feat.shape == (1, 32, 32) and up.shape == (1, 256, 8)
from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig
svc = GraspService(ServiceConfig(model_cfg=GraspNetConfig.tiny(), depth_min=0.0, depth_max=10.0, device="cpu",
                                 max_batch=2))
reply = svc.compute(np.random.default_rng(1).uniform(0.2, 0.5, (2000, 3)).astype(np.float32))
svc.close()
assert reply["ok"] and len(reply["tf_pose"]) == 4, reply.get("error")
from graspnet_tpu_torch.train import label_pipeline as lp
from graspnet_tpu_torch.train.trainer import Trainer
cfg = GraspNetConfig.tiny()
rng = np.random.default_rng(1)
v, a, d = cfg.num_view, cfg.num_angle, cfg.num_depth
clouds, inds, labels = [], [], []
for _ in range(2):
    cloud = rng.uniform(-0.3, 0.3, (cfg.num_point, 3)).astype(np.float32)
    sa, seeds = lp.seed_chain(cloud, cfg)
    pose = np.concatenate([np.eye(3), rng.uniform(-0.1, 0.1, (3, 1))], 1).astype(np.float32)
    slab = lambda hi: [rng.uniform(0, hi, (30, v, a, d)).astype(np.float32)]
    labels.append(lp.build_scene_labels(cloud, seeds, [pose], [rng.uniform(-0.05, 0.05, (30, 3)).astype(np.float32)],
                                        slab(1.0), slab(0.12), slab(0.05), cfg, max_objects=2))
    clouds.append(cloud)
    inds.append(sa)
batch = {k: np.stack([l[k] for l in labels]) for k in labels[0]}
batch.update(point_clouds=np.stack(clouds), objectness_label=rng.integers(0, 2, (2, cfg.num_point)),
             sa_inds={k: np.stack([s[k] for s in inds]) for k in inds[0]})
loss, _ = Trainer(cfg, device="cpu").step(batch)
assert np.isfinite(float(loss))
import os, tempfile
from graspnet_tpu_torch.apps import train as cli
from graspnet_tpu_torch.data.synthetic import SyntheticGraspNetDataset
from graspnet_tpu_torch.train.trainer import TrainConfig
from graspnet_tpu_torch.utils.logging import MetricLogger
ds = SyntheticGraspNetDataset(n_frames=2, n_objects=2, label_points=40, cloud_points=1200, num_points=cfg.num_point, cfg=cfg)
with tempfile.TemporaryDirectory() as log_dir:
    logger = MetricLogger(log_dir)
    run = cli.train(Trainer(cfg, TrainConfig(max_epoch=1), device="cpu"), ds, ds, logger, log_dir, num_workers=2)
    logger.close()
assert run["epochs_done"] == 1 and len(run["step_end_s"]) == 1
from graspnet_tpu_torch.apps import test as test_app
from tests.mini_dataset import make_mini_dataset
with tempfile.TemporaryDirectory() as tmp:
    root = make_mini_dataset(os.path.join(tmp, "mini"), num_view=60)
    dump = os.path.join(tmp, "dump")
    assert test_app.main(["--dataset_root", root, "--camera", "realsense", "--dump_dir", dump, "--tiny",
                          "--device", "cpu", "--batch_size", "2", "--num_workers", "1"]) == 0
    assert os.path.exists(os.path.join(dump, "ap_realsense.npy"))
    assert len(os.listdir(os.path.join(dump, "scene_0100", "realsense"))) == 2
assert set(build._LIBS) <= {build.HOST}, f"a kernel library was loaded on the CPU path: {set(build._LIBS)}"
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "graspnet_tpu") and sys.modules[m] is not None]
assert not bad, bad
print("ok", len(gg))
"""


def test_port_runs_with_jax_blocked():
    # one intra-op thread: the suite runs in several processes on shared cores
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1].startswith("ok")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    hits = BANNED.findall(path.read_text())
    assert not hits, f"{path.name} imports {hits}"


def test_every_native_source_lies_in_the_port():
    """The port builds its libraries from its own csrc/, never by path from
    the JAX package (the host library is a copy of its C++ source)."""
    from graspnet_tpu_torch.ops.cuda import build

    port_csrc = ROOT / "graspnet_tpu_torch" / "csrc"
    assert build.CSRC == port_csrc and build.BUILD_DIR == ROOT / "graspnet_tpu_torch" / "_build"
    for name in build.SOURCES:
        assert build._source(name).parent == port_csrc and build._source(name).exists(), name
    assert build.HOST in build.SOURCES and build._source(build.HOST).name == "host.cpp"


def test_banned_pattern_catches_imports():
    for line in ("import jax", "from jax import numpy", "import jax.numpy as jnp",
                 "from graspnet_tpu.ops import x", "from graspnet_tpu import ops",
                 "    import graspnet_tpu.models"):
        assert BANNED.search(line), line
    for line in ("import graspnet_tpu_torch", "from graspnet_tpu_torch.ops import x", "import jaxtyping"):
        assert not BANNED.search(line), line


@pytest.mark.parametrize("first", ["graspnet_tpu_torch.ops.query", "graspnet_tpu_torch.ops.scatter",
                                   "graspnet_tpu_torch.ops.knn", "graspnet_tpu_torch.ops.cuda",
                                   "graspnet_tpu_torch.ops.cuda.crop"])
def test_gathers_and_kernel_package_import_in_any_order(first):
    """The plain ops import the gathers at module level and the kernel
    package imports the plain ops: whichever module a process imports
    first, the import completes, the plain ops hold `ops/scatter.py`'s
    gathers and the kernel package counts its scatter-add wrapper."""
    code = f"""
import importlib
importlib.import_module({first!r})
from graspnet_tpu_torch.ops import cuda, query, sampling, scatter
# `ops.knn` names the kNN function, as in the JAX package; the module is in sys.modules
knn = importlib.import_module("graspnet_tpu_torch.ops.knn")
assert query.gather_rows is sampling.gather_rows is scatter.gather_rows
assert knn.three_interpolate is scatter.three_interpolate
assert cuda.scatter_add_rows is scatter.scatter_add_rows and scatter.scatter_add_rows in cuda.WRAPPERS
assert cuda.scatter_plan is scatter.scatter_plan and scatter.scatter_plan in cuda.WRAPPERS
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "ok"
