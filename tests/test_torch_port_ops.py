"""Port parity: the plain versions of the port's ops against the JAX package.

Inputs come from numpy seeds and go through both packages.  Selections
(FPS, ball- and cylinder-query indices) must be exactly equal.  The fused
crops are in test_torch_port_crop.py.  The CUDA kernels themselves are held
against these plain versions on the card (test_torch_port_cuda.py and
chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graspnet_tpu import ops as jops
from graspnet_tpu.models import heads as jheads
from graspnet_tpu.nn import layers as jnn
from graspnet_tpu.ops.pallas.fps import fps_chain_pallas, fps_pallas
from graspnet_tpu.ops.pallas.query import ball_query_pallas

from graspnet_tpu_torch import ops
from graspnet_tpu_torch.nn.layers import SharedMLP
from graspnet_tpu_torch.ops.cuda import fps as kfps
from graspnet_tpu_torch.ops.cuda import query as kquery


def make_cloud(rng, n=500, near_origin=5):
    pts = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    pts[rng.choice(n, near_origin, replace=False)] *= 1e-3  # FPS near-origin skip
    return pts


def t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def perturbed_mlp(dims, seed, eps=1e-5):
    """JAX SharedMLP params with non-trivial BN stats (so folding is
    exercised) and the port's SharedMLP loaded with the same values."""
    rng = np.random.default_rng(seed)
    layers = jnn.shared_mlp_init(jax.random.PRNGKey(seed), tuple(dims))
    for layer in layers:
        for k, lo, hi in (("mean", -0.1, 0.1), ("var", 0.5, 2.0),
                          ("scale", 0.5, 1.5), ("offset", -0.1, 0.1)):
            layer["bn"][k] = jnp.asarray(rng.uniform(lo, hi, layer["bn"][k].shape), jnp.float32)
    mlp = SharedMLP(dims, eps)
    with torch.no_grad():
        for jl, tl in zip(layers, mlp):
            tl.kernel.copy_(t(np.asarray(jl["kernel"])))
            for k in ("scale", "offset", "mean", "var"):
                getattr(tl.bn, k).copy_(t(np.asarray(jl["bn"][k])))
    return layers, mlp


def random_rotations(rng, shape):
    q, _ = np.linalg.qr(rng.normal(size=(*shape, 3, 3)))
    return q.astype(np.float32)


# ------------------------------------------------------------------ FPS --


class TestFPS:
    @pytest.mark.parametrize("n,npoint,near", [(500, 64, 5), (300, 100, 60), (64, 64, 0)])
    def test_matches_xla(self, n, npoint, near):
        rng = np.random.default_rng(n + npoint)
        pts = np.stack([make_cloud(rng, n, near), make_cloud(rng, n, near)])
        want = np.asarray(jops.furthest_point_sample(pts, npoint, use_pallas=False))
        got = ops.furthest_point_sample(t(pts), npoint).numpy()
        np.testing.assert_array_equal(got, want)

    def test_ties_and_duplicates(self):
        # a lattice has many equal distances and every point appears twice:
        # ties must go to the lowest index.  Multiples of 1/8 keep every d2
        # exact, so the ties are ties in any rounding (XLA on the CPU
        # contracts the distance sum into FMAs; the port does not)
        g = np.stack(np.meshgrid(*[np.arange(1, 5, dtype=np.float32) * 0.125] * 3), -1)
        pts = np.concatenate([g.reshape(-1, 3)] * 2)[None]
        want = np.asarray(jops.furthest_point_sample(pts, 40, use_pallas=False))
        got = ops.furthest_point_sample(t(pts), 40).numpy()
        np.testing.assert_array_equal(got, want)

    def test_all_near_origin(self):
        # no valid point: every selection falls back to index 0
        pts = np.full((1, 50, 3), 1e-3, np.float32)
        want = np.asarray(jops.furthest_point_sample(pts, 8, use_pallas=False))
        got = ops.furthest_point_sample(t(pts), 8).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got == 0).all()

    def test_near_origin_never_selected(self):
        pts = make_cloud(np.random.default_rng(4), n=100, near_origin=30)
        got = ops.furthest_point_sample(t(pts[None]), 50).numpy()[0]
        assert np.all(np.sum(pts**2, axis=1)[got[1:]] > 1e-3)

    def test_matches_fps_pallas_interpret(self):
        rng = np.random.default_rng(7)
        pts = np.stack([make_cloud(rng), make_cloud(rng)])
        want = np.asarray(fps_pallas(jnp.asarray(pts), 32))
        np.testing.assert_array_equal(ops.furthest_point_sample(t(pts), 32).numpy(), want)

    def test_chain_matches_fps_chain_pallas_interpret(self):
        rng = np.random.default_rng(8)
        pts = np.stack([make_cloud(rng, 300), make_cloud(rng, 300, near_origin=40)])
        npoints = (128, 24)
        want = fps_chain_pallas(jnp.asarray(pts), npoints)
        got = kfps.fps_chain(t(pts), npoints)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_chain_equals_sequential_stages(self):
        # the port always runs the chain (also where npoint is not a multiple
        # of 128): it must equal FPS + gather stage by stage
        rng = np.random.default_rng(9)
        pts = np.stack([make_cloud(rng, 400), make_cloud(rng, 400)])
        npoints = (100, 50, 20)
        got = kfps.fps_chain(t(pts), npoints)
        cur = pts
        for g, m in zip(got, npoints):
            want = np.asarray(jops.furthest_point_sample(cur, m, use_pallas=False))
            np.testing.assert_array_equal(g.numpy(), want)
            cur = np.take_along_axis(cur, want[..., None], axis=1)

    def test_gather_points(self):
        rng = np.random.default_rng(10)
        pts = rng.normal(size=(2, 30, 5)).astype(np.float32)
        idx = rng.integers(0, 30, (2, 7))
        want = np.asarray(jops.gather_points(jnp.asarray(pts), jnp.asarray(idx)))
        np.testing.assert_array_equal(ops.gather_points(t(pts), t(idx)).numpy(), want)


# -------------------------------------------------------------- queries --


class TestSelectFirstHits:
    @pytest.mark.parametrize("n,ns,density", [(300, 8, 0.05), (129, 16, 0.5), (40, 16, 0.0), (50, 4, 1.0)])
    def test_matches_jax(self, n, ns, density):
        from graspnet_tpu.ops.query import _select_first_hits

        rng = np.random.default_rng(n)
        mask = rng.uniform(size=(3, 5, n)) < density
        want = np.asarray(_select_first_hits(jnp.asarray(mask), ns))
        got = ops.select_first_hits(t(mask), ns).numpy()
        np.testing.assert_array_equal(got, want)


class TestBallQuery:
    @pytest.mark.parametrize("radius,nsample", [(0.04, 64), (0.1, 32), (0.3, 16)])
    def test_matches_xla(self, radius, nsample):
        rng = np.random.default_rng(int(radius * 100))
        pts = np.stack([make_cloud(rng, 400), make_cloud(rng, 400)])
        centers = pts[:, rng.choice(400, 64, replace=False)]
        want = np.asarray(jops.ball_query(pts, centers, radius, nsample, chunk=32, use_pallas=False))
        got = ops.ball_query(t(pts), t(centers), radius, nsample).numpy()
        np.testing.assert_array_equal(got, want)

    def test_empty_and_overfull(self):
        # alternating far (zero hits -> all 0) and central (overfull -> the
        # first nsample in index order) centers
        rng = np.random.default_rng(5)
        xyz = rng.uniform(-0.2, 0.2, (1, 256, 3)).astype(np.float32)
        centers = np.stack([np.full((3,), 10.0), np.zeros(3)] * 8, 0)[None].astype(np.float32)
        want = np.asarray(jops.ball_query(xyz, centers, 0.5, 8, use_pallas=False))
        got = kquery.ball_query_plain(t(xyz), t(centers), 0.5, 8).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[0, 0] == 0).all()
        np.testing.assert_array_equal(got[0, 1], np.arange(8))

    def test_matches_ball_query_pallas_interpret(self):
        rng = np.random.default_rng(3)
        xyz = rng.uniform(-0.3, 0.3, (2, 500, 3)).astype(np.float32)
        centers = xyz[:, :16] + rng.normal(0, 0.01, (2, 16, 3)).astype(np.float32)
        want = np.asarray(ball_query_pallas(jnp.asarray(xyz), jnp.asarray(centers), 0.1, 16))
        got = ops.ball_query(t(xyz), t(centers), 0.1, 16).numpy()
        np.testing.assert_array_equal(got, want)

    def test_group_points(self):
        rng = np.random.default_rng(11)
        pts = rng.normal(size=(2, 40, 6)).astype(np.float32)
        idx = rng.integers(0, 40, (2, 5, 3))
        want = np.asarray(jops.group_points(jnp.asarray(pts), jnp.asarray(idx)))
        np.testing.assert_array_equal(ops.group_points(t(pts), t(idx)).numpy(), want)


class TestCylinderQuery:
    @pytest.mark.parametrize("hmax_list", [(0.01, 0.02, 0.03, 0.04), (0.02, 0.04)])
    def test_matches_xla(self, hmax_list):
        rng = np.random.default_rng(len(hmax_list))
        xyz = rng.uniform(-0.3, 0.3, (2, 500, 3)).astype(np.float32)
        centers = xyz[:, :16] + rng.normal(0, 0.01, (2, 16, 3)).astype(np.float32)
        rot = random_rotations(rng, (2, 16))
        args = (0.05, -0.02, hmax_list, 16)
        want = np.asarray(jheads.cylinder_query_multi_depth(
            jnp.asarray(xyz), jnp.asarray(centers), jnp.asarray(rot), *args, chunk=16))
        got = ops.cylinder_query_multi_depth(t(xyz), t(centers), t(rot), *args).numpy()
        np.testing.assert_array_equal(got, want)

    def test_empty_and_overfull(self):
        rng = np.random.default_rng(6)
        xyz = rng.uniform(-0.3, 0.3, (2, 300, 3)).astype(np.float32)
        centers = np.stack([np.full((8, 3), 10.0), np.zeros((8, 3))]).astype(np.float32)
        rot = random_rotations(rng, (2, 8))
        args = (0.5, -0.5, (0.5,), 8)
        want = np.asarray(jheads.cylinder_query_multi_depth(
            jnp.asarray(xyz), jnp.asarray(centers), jnp.asarray(rot), *args, chunk=8))
        got = ops.cylinder_query_multi_depth(t(xyz), t(centers), t(rot), *args).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[0] == 0).all()


# ------------------------------------------------------------------ knn --


class TestThreeNN:
    def test_three_nn_matches_xla(self):
        rng = np.random.default_rng(12)
        unknown = rng.uniform(-0.5, 0.5, (2, 128, 3)).astype(np.float32)
        known = rng.uniform(-0.5, 0.5, (2, 64, 3)).astype(np.float32)
        known[:, 10] = known[:, 3]  # a duplicate: the lower index wins the tie
        jd, ji = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
        td, ti = ops.three_nn(t(unknown), t(known))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        # XLA on the CPU sums d2 as an FMA chain, the port as separate
        # mul/add (like the TPU kernels): the distances differ by an ULP
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=0)

    def test_three_interpolate_matches_xla(self):
        rng = np.random.default_rng(13)
        feat = rng.normal(size=(2, 64, 8)).astype(np.float32)
        idx = rng.integers(0, 64, (2, 100, 3))
        w = rng.uniform(size=(2, 100, 3)).astype(np.float32)
        want = np.asarray(jops.three_interpolate(jnp.asarray(feat), jnp.asarray(idx), jnp.asarray(w)))
        got = ops.three_interpolate(t(feat), t(idx), t(w)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)  # 3-term f32 sums


# ------------------------------------------------------- wrapper contract --


# Every kernel wrapper, each of whose counts stays 0 on the CPU.
NO_LAUNCHES = {"fps_chain": 0, "ball_query": 0, "sa1_fused": 0, "crop_fused": 0, "crop_group": 0,
               "crop_mlp_train": 0, "crop_mlp_train_backward": 0, "cylinder_query_multi": 0, "sa_feat_fused": 0,
               "multi_query": 0, "scatter_add_rows": 0, "scatter_plan": 0, "voxel_downsample": 0, "sa_group": 0,
               "sa_bias_relu": 0, "attention": 0, "count_in_boxes": 0, "kernel_map": 0, "subm_conv": 0,
               "attention_varlen": 0}


def tiny_cloud(seed: int, n: int = 512) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-0.3, 0.3, (n, 3)).astype(np.float32)


def tiny_pipeline(**kw):
    from graspnet_tpu_torch.apps import GraspPipeline
    from graspnet_tpu_torch.config import GraspNetConfig

    return GraspPipeline(cfg=GraspNetConfig.tiny(), seed=1, device="cpu", **kw)


def tiny_scene(seed: int, n: int = 4000) -> np.ndarray:
    from graspnet_tpu_torch.utils.synthetic import tabletop_cloud

    return tabletop_cloud(np.random.default_rng(seed), n)


def tiny_dataset(label_mode: str = "compact", n_frames: int = 2, **kw):
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.data.synthetic import SyntheticGraspNetDataset

    cfg = GraspNetConfig.tiny()
    return SyntheticGraspNetDataset(n_frames=n_frames, n_objects=2, label_points=40, cloud_points=1200,
                                    num_points=cfg.num_point, cfg=cfg, label_mode=label_mode, **kw)


def rows_of(groups):
    return [(g.grasp_group_array, (None, 17)) for g in groups]


def entry_ops(tmp_path):
    pts = t(make_cloud(np.random.default_rng(2), 200)[None])
    rot = t(random_rotations(np.random.default_rng(3), (1, 8)))
    stage0, stage1 = kfps.fps_chain(pts, (32, 16))
    return [(stage0, (1, 32)), (stage1, (1, 16)),
            (kquery.ball_query(pts, pts[:, :8], 0.1, 4), (1, 8, 4)),
            (kquery.cylinder_query_multi(pts, pts[:, :8], rot, 0.05, -0.02, (0.02, 0.04), 4), (1, 8, 2, 4)),
            (kquery.multi_query(pts, pts[:, :8], None, 0.1, 0.0, (0.0,), 4, rotate=False), (1, 8, 1, 4))]


def entry_topk(tmp_path):
    return rows_of([tiny_pipeline().get_grasps_topk(tiny_cloud(0))])


def entry_batch(tmp_path):
    return rows_of(tiny_pipeline().get_grasps_batch(np.stack([tiny_cloud(0), tiny_cloud(1)])))


def entry_run_filtered(tmp_path):
    pipe, scene = tiny_pipeline(), tiny_scene(0)
    return rows_of([pipe.run(pipe.sample_cloud(scene), scene_cloud=scene, collision_thresh=0.01, top_k=0)])


def entry_filter_pre_downsampled(tmp_path):
    from graspnet_tpu_torch import native

    pipe, scenes = tiny_pipeline(), [tiny_scene(0), tiny_scene(1)]
    ggs = pipe.get_grasps_batch(np.stack([pipe.sample_cloud(c) for c in scenes]))
    voxels = [native.voxel_downsample(c, 0.01) for c in scenes]
    return rows_of(pipe.collision_filter_batch(ggs, voxels, pre_downsampled=True))


def service_reply(max_batch: int):
    from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig
    from graspnet_tpu_torch.config import GraspNetConfig

    svc = GraspService(ServiceConfig(model_cfg=GraspNetConfig.tiny(), device="cpu", max_batch=max_batch))
    try:
        reply = svc.compute(tiny_scene(0))
    finally:
        svc.close()
    assert reply["ok"], reply.get("error")
    return [(np.asarray(reply["tf_pose"]), (4, 4)), (np.asarray(reply["grasps"]), (reply["num_grasps"], 17))]


def entry_service_b1(tmp_path):
    return service_reply(1)


def entry_service_b2(tmp_path):
    return service_reply(2)


def entry_candidate_mesh(tmp_path):
    from graspnet_tpu_torch.parallel import make_mesh

    pipe = tiny_pipeline(mesh=make_mesh(2, ("candidate",), devices=["cpu"] * 2))
    return rows_of([pipe.get_grasps_topk(tiny_cloud(0))])


def entry_data_mesh(tmp_path):
    from graspnet_tpu_torch.parallel import make_mesh

    pipe = tiny_pipeline(mesh=make_mesh(2, ("data",), devices=["cpu"] * 2))
    return rows_of(pipe.get_grasps_topk_batch(np.stack([tiny_cloud(0), tiny_cloud(1)])))


def step_outputs(loss, metrics):
    return [(loss, ())] + [(v, ()) for v in metrics.values()]


def entry_step_full(tmp_path):
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.data.dataset import collate
    from graspnet_tpu_torch.train.trainer import Trainer

    ds = tiny_dataset("full")
    return step_outputs(*Trainer(GraspNetConfig.tiny(), device="cpu").step(collate([ds.get_data_label(i) for i in (0, 1)])))


def entry_step_prepared(tmp_path):
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.data.dataset import collate
    from graspnet_tpu_torch.train.trainer import Trainer

    ds = tiny_dataset("compact")
    trainer = Trainer(GraspNetConfig.tiny(), device="cpu")
    return step_outputs(*trainer.step_prepared(trainer.prepare(collate([ds.get_data_label(i) for i in (0, 1)]))))


def entry_train_cli(tmp_path):
    from graspnet_tpu_torch.apps import train as cli
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer
    from graspnet_tpu_torch.utils.logging import MetricLogger

    ds = tiny_dataset("compact")
    trainer = Trainer(GraspNetConfig.tiny(), TrainConfig(max_epoch=1), device="cpu")
    logger = MetricLogger(str(tmp_path))
    try:
        run = cli.train(trainer, ds, ds, logger, str(tmp_path), num_workers=2)
    finally:
        logger.close()
    assert run["epochs_done"] == 1 and (tmp_path / cli.CHECKPOINT).exists()
    return [(np.asarray(run["step_end_s"]), (1,))] + [(q.detach(), tuple(q.shape)) for q in trainer.model.parameters()]


def entry_test_app(tmp_path):
    import argparse

    from graspnet_tpu_torch import checkpoint
    from graspnet_tpu_torch.apps import test as test_app
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.models import GraspNet, init_weights

    cfg = GraspNetConfig.tiny()
    weights = str(tmp_path / "weights.pt")
    checkpoint.save(weights, init_weights(GraspNet(cfg), 1).state_dict())
    ds = tiny_dataset(n_frames=3, augment=False, with_labels=False)
    args = argparse.Namespace(dataset_root="<synthetic>", camera="kinect", split="train", checkpoint_path=weights,
                              dump_dir=str(tmp_path / "dump"), num_point=cfg.num_point, collision_thresh=0.01,
                              voxel_size=0.01, batch_size=2, max_frames=3, profile_dir=None, device="cpu")
    assert test_app.inference(args, cfg, dataset=ds)["frames"] == 3
    dumped = sorted((tmp_path / "dump").rglob("*.npy"))
    assert len(dumped) == 3
    return [(np.load(f), (None, 17)) for f in dumped]


def entry_detect(tmp_path):
    from graspnet_tpu_torch.apps.detect import DetectionPipeline
    from graspnet_tpu_torch.config import VoteNetConfig
    from tests.test_torch_port_votenet import scans, seeded_state

    cfg = VoteNetConfig.tiny()
    dets = DetectionPipeline(params=seeded_state(cfg, 1), cfg=cfg, device="cpu").detect(scans(cfg, 5))
    assert len(dets) == 2
    return [(d.rows, (cfg.num_proposal, 12 + cfg.num_class)) for d in dets]


def entry_detect_groupfree(tmp_path):
    from graspnet_tpu_torch.apps.detect import DetectionPipeline
    from graspnet_tpu_torch.config import GroupFreeConfig
    from tests.test_torch_port_groupfree import scans, seeded_state

    cfg = GroupFreeConfig.tiny()
    dets = DetectionPipeline(params=seeded_state(cfg, 1), cfg=cfg, device="cpu").detect(scans(cfg, 5))
    assert len(dets) == 2
    return [(d.rows, (cfg.num_proposal, 12 + cfg.num_class)) for d in dets]


def entry_segment_ptv3(tmp_path):
    from graspnet_tpu_torch.apps.segment import SegmentationPipeline
    from graspnet_tpu_torch.config import PTv3Config
    from tests.test_torch_port_ptv3 import LENGTHS, fragments, seeded_state

    cfg = PTv3Config.tiny()
    segs = SegmentationPipeline(cfg, params=seeded_state(cfg, 2), device="cpu").segment(fragments())
    assert len(segs) == len(LENGTHS)
    return [(s.logits, (n, cfg.num_classes)) for s, n in zip(segs, LENGTHS)] + \
        [(s.labels, (n,)) for s, n in zip(segs, LENGTHS)]


def entry_msg(tmp_path):
    from graspnet_tpu_torch.models import init_weights
    from graspnet_tpu_torch.models.msg import LFPModuleMSG, SAModuleMSG

    xyz = t(np.random.default_rng(2).uniform(-0.3, 0.3, (1, 256, 3)).astype(np.float32))
    sa = init_weights(SAModuleMSG([(8, 16), (8, 16)], in_dim=0, npoint=32, radii=(0.1, 0.2), nsamples=(8, 16)), 0)
    lfp = init_weights(LFPModuleMSG([(8,)], (8,), in_dim=32, skip_dim=0, radii=(0.2,), nsamples=(8,)), 1)
    with torch.no_grad():
        new_xyz, feat, _, _ = sa(xyz)
        up, _ = lfp(xyz, new_xyz, None, feat)
    return [(new_xyz, (1, 32, 3)), (feat, (1, 32, 32)), (up, (1, 256, 8))]


def entry_tolerance(tmp_path):
    from graspnet_tpu_torch.data.tolerance import generate_tolerance

    rng = np.random.default_rng(4)
    pts = rng.uniform(-0.02, 0.02, (24, 3)).astype(np.float32)
    scores = rng.uniform(0.0, 1.2, (24, 4, 3, 2)).astype(np.float32)
    return [(generate_tolerance(pts, scores, chunk=16, device="cpu"), (24, 4, 3, 2))]


def entry_voxel(tmp_path):
    from graspnet_tpu_torch.ops.voxel import voxel_downsample

    return [(voxel_downsample(torch.from_numpy(tiny_scene(0)), 0.01), (None, 3))]


def entry_demo_pointcloud(tmp_path):
    from graspnet_tpu_torch.apps import demo_pointcloud

    np.save(tmp_path / "cloud.npy", tiny_scene(0))
    dump = tmp_path / "g.npy"
    demo_pointcloud.main(["--cloud_path", str(tmp_path / "cloud.npy"), "--dump", str(dump), "--tiny",
                          "--device", "cpu"])
    return [(np.load(dump), (None, 17))]


ENTRY_POINTS = {
    "ops_wrappers": entry_ops,
    "get_grasps_topk": entry_topk,
    "get_grasps_batch_b2": entry_batch,
    "run_with_filter": entry_run_filtered,
    "collision_filter_batch_pre_downsampled": entry_filter_pre_downsampled,
    "service_max_batch_1": entry_service_b1,
    "service_max_batch_2": entry_service_b2,
    "candidate_mesh": entry_candidate_mesh,
    "data_mesh": entry_data_mesh,
    "trainer_step_full": entry_step_full,
    "trainer_prepare_step_prepared": entry_step_prepared,
    "train_cli_epoch": entry_train_cli,
    "test_app_dump_loop": entry_test_app,
    "detection_pipeline": entry_detect,
    "groupfree_detection_pipeline": entry_detect_groupfree,
    "ptv3_segmentation_pipeline": entry_segment_ptv3,
    "msg_modules": entry_msg,
    "tolerance": entry_tolerance,
    "voxel_downsample": entry_voxel,
    "demo_pointcloud": entry_demo_pointcloud,
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_cpu_entry_point_launches_no_kernel(entry, tmp_path):
    """Each entry point at `GraspNetConfig.tiny()` (VoteNet's tiny config
    for detection) on the CPU: no CUDA launcher is reached, so every
    wrapper's count stays 0, and each output has its shape and finite
    values."""
    from graspnet_tpu_torch.ops import cuda as kernels

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs in several processes on shared cores
    kernels.reset_launches()
    try:
        outputs = ENTRY_POINTS[entry](tmp_path)
    finally:
        torch.set_num_threads(threads)
    assert kernels.launches() == NO_LAUNCHES
    assert outputs
    for out, shape in outputs:
        out = torch.as_tensor(out)
        assert out.dim() == len(shape) and all(w is None or n == w for n, w in zip(out.shape, shape)), \
            (tuple(out.shape), shape)
        assert torch.isfinite(out.double()).all()
