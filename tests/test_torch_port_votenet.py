"""VoteNet on the port (`models/votenet.py`, `postproc/boxes.py`,
`apps/detect.py`) against the benchmark's plain reference
(`benchmark/reference/vn.py`), at `VoteNetConfig.tiny()` on the CPU with
seeded weights whose BatchNorms are not the identity and whose biases are
not zero.

Tolerances: votes and raw proposal channels within ATOL x max(1, scale):
the port's voting and proposal layers are matmuls on channels-last rows
and fold nothing, the reference's are channels-first `conv1d`/`conv2d`,
so float32 sums of up to 256 products may round in another order.  The
per-class scores and box corners within SCORE_ATOL: products and sums of
a few of those numbers.  Selections (FPS and ball-query indices, the
non-empty, picked and kept sets, the classes) are exactly equal; the
rooms' points carry 5 mm of noise and the weights are fixed, so no box
decision lies within rounding of its threshold here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.inputs.rooms import room_pool
from benchmark.reference import gn, vn
from graspnet_tpu_torch.apps.detect import DetectionPipeline, Detections, floor_height
from graspnet_tpu_torch.config import GraspNetConfig, SAConfig, VoteNetConfig
from graspnet_tpu_torch.models import init_weights
from graspnet_tpu_torch.models.backbone import Backbone
from graspnet_tpu_torch.models.votenet import VoteNet
from graspnet_tpu_torch.ops.cuda import boxes as kboxes
from graspnet_tpu_torch.ops.cuda import build
from graspnet_tpu_torch.postproc import boxes
from graspnet_tpu_torch.utils import tracing

ATOL = 1e-5
SCORE_ATOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_state(cfg: VoteNetConfig, seed: int) -> dict:
    """Kaiming kernels (`init_weights`), then every bias and BatchNorm
    statistic and affine drawn away from zero and the identity."""
    model = init_weights(VoteNet(cfg), seed)
    gen = torch.Generator().manual_seed(seed + 1)
    state = model.state_dict()
    for k, v in state.items():
        leaf = k.rsplit(".", 1)[-1]
        lo, hi = {"bias": (-0.1, 0.1), "mean": (-0.1, 0.1), "var": (0.5, 2.0), "scale": (0.5, 1.5),
                  "offset": (-0.1, 0.1)}.get(leaf, (None, None))
        if lo is not None:
            state[k] = lo + (hi - lo) * torch.rand(v.shape, generator=gen)
    return state


def reference(cfg: VoteNetConfig, state: dict) -> vn.VoteNet:
    fields = {"num_point": cfg.num_point, "input_feature_dim": cfg.input_feature_dim, "sa1": cfg.sa1,
              "sa2": cfg.sa2, "sa3": cfg.sa3, "sa4": cfg.sa4, "fp1_mlp": cfg.fp1_mlp, "fp2_mlp": cfg.fp2_mlp}
    bb = gn.GraspNetConfig(**{k: (gn.SAConfig(*tuple(v.__dict__.values())) if isinstance(v, SAConfig) else v)
                              for k, v in fields.items()})
    return vn.VoteNet(bb, detector(cfg), state, "cpu")


def detector(cfg: VoteNetConfig) -> vn.Detector:
    """The reference's detector fields: VoteNetConfig's of the same names."""
    return vn.Detector(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(vn.Detector)})


def scans(cfg: VoteNetConfig, seed: int, b: int = 2) -> np.ndarray:
    return room_pool(seed, b, cfg.num_point)


def close(got, want, atol=ATOL):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert torch.isfinite(got).all()
    err = (got.double() - want.double()).abs().max().item()
    assert err <= atol * max(1.0, want.abs().max().item()), err


CASES = [(1, 3), (1, 4), (2, 4)]  # (weight seed, scan seed): NMS drops boxes in each


@pytest.mark.parametrize("wseed,sseed", CASES)
def test_votes_and_head_match_the_reference(wseed, sseed):
    cfg = VoteNetConfig.tiny()
    state = seeded_state(cfg, wseed)
    model = VoteNet(cfg)
    model.load_state_dict(state)
    x = torch.from_numpy(scans(cfg, sseed))
    with torch.no_grad():
        got = model.eval()(x)
    want = reference(cfg, state).forward(x)
    assert torch.equal(got["seed_xyz"], want["seed_xyz"])
    assert torch.equal(got["aggregated_vote_inds"], want["aggregated_vote_inds"])
    close(got["vote_xyz"], want["vote_xyz"])
    close(got["aggregated_vote_xyz"], want["aggregated_vote_xyz"])
    close(got["head"], want["head"])
    assert got["head"].shape == (2, cfg.num_proposal, cfg.head_dim)


@pytest.mark.parametrize("wseed,sseed,conf", [(*c, False) for c in CASES] + [(1, 5, True)])
def test_pipeline_selections_match_the_reference(wseed, sseed, conf):
    """The non-empty and kept sets exact, the classes equal, the kept
    boxes' corners, obj_prob and per-class scores within SCORE_ATOL; the
    judge of the benchmark cell reads no gap past its limits.  With
    `conf`, the confidence threshold at the median picked obj_prob, so
    that it drops half the picks."""
    cfg = VoteNetConfig.tiny()
    state = seeded_state(cfg, wseed)
    clouds = scans(cfg, sseed)
    if conf:
        rows = np.stack([d.rows for d in DetectionPipeline(params=state, cfg=cfg, device="cpu").detect(clouds)])
        picked = np.sort(rows[..., boxes.OBJ_PROB][rows[..., boxes.PICKED] > 0])
        cfg = dataclasses.replace(cfg, conf_thresh=float(picked[len(picked) // 2]))
    pipe = DetectionPipeline(params=state, cfg=cfg, device="cpu")
    handle = pipe.dispatch(clouds)
    dets = pipe.finish(handle)
    ref = reference(cfg, state)
    x = torch.from_numpy(clouds)
    out = ref.forward(x)
    res = vn.parse_predictions(out, x[..., :3], detector(cfg), ref.mean_size)
    rows = np.stack([d.rows for d in dets])
    np.testing.assert_array_equal(rows[..., boxes.NONEMPTY] > 0, res["nonempty"])
    np.testing.assert_array_equal(rows[..., boxes.PICKED] > 0, res["picked"])
    np.testing.assert_array_equal(rows[..., boxes.KEPT] > 0, res["kept"])
    np.testing.assert_array_equal(rows[..., boxes.SEM_CLS].astype(np.int64), res["sem_cls"])
    np.testing.assert_array_equal(rows[..., boxes.POINTS].astype(np.int64), res["count"])
    kept = res["kept"]
    assert 0 < kept.sum() < res["nonempty"].sum()  # NMS (or the threshold) has work
    if conf:
        assert kept.sum() < res["picked"].sum()
    close(rows[..., boxes.LO: boxes.HI + 3][kept], np.concatenate([res["lo"], res["hi"]], -1)[kept], SCORE_ATOL)
    close(rows[..., boxes.OBJ_PROB][kept], res["obj_prob"][kept], SCORE_ATOL)
    close(rows[..., boxes.SCORES:][kept], res["scores"][kept], SCORE_ATOL)
    got = vn.compare(rows, handle.end_points["head"].numpy(), out["head"].numpy(), res)
    assert got["selection_diff"] == 0
    assert got["head_gap"] <= 1e-4 and got["box_gap"] <= 1e-4


def test_settling_at_the_fetch_gives_the_greedy_picks():
    """The fetch runs the NMS to its fixpoint: the reference's greedy picks,
    with the sweeps it took in the `detect.nms` span (at least one more
    than the longest chain of suppressions, 2 when a box drops)."""
    cfg = VoteNetConfig.tiny()
    state = seeded_state(cfg, 1)
    clouds = scans(cfg, 5)
    with tracing.recording() as rec:
        dets = DetectionPipeline(params=state, cfg=cfg, device="cpu").detect(clouds)
    ref = reference(cfg, state)
    x = torch.from_numpy(clouds)
    res = vn.parse_predictions(ref.forward(x), x[..., :3], detector(cfg), ref.mean_size)
    picked = np.stack([d.rows[:, boxes.PICKED] > 0 for d in dets])
    np.testing.assert_array_equal(picked, res["picked"])
    assert picked.sum() < res["nonempty"].sum()
    [nms] = [s for s in rec.drain() if s.name == "detect.nms"]
    assert nms.counts["sweeps"] >= 2


def _nms(lo, hi, score, cls, valid, thresh=0.25):
    """The port's device NMS on one batch of hand-made boxes, to the fixpoint."""
    lo, hi = torch.tensor(lo, dtype=torch.float32)[None], torch.tensor(hi, dtype=torch.float32)[None]
    score = torch.tensor(score, dtype=torch.float32)[None]
    cls, valid = torch.tensor(cls)[None], torch.tensor(valid)[None]
    a = boxes.nms_matrix(boxes.overlaps(lo, hi, cls, thresh), score, valid)
    keep, _ = boxes.fixpoint(a, valid)
    return keep[0].numpy()


UNIT = ([0, 0, 0], [1, 1, 1])


@pytest.mark.parametrize("case", ["same_class", "other_class", "tie_by_index", "chain", "empty", "iou_at_threshold"])
def test_box_nms_on_hand_made_boxes(case):
    """Overlapping boxes of one class: the lower score goes; of another
    class: both stay; equal scores: the lower index wins; a chain a > b > c
    where b drops and so c stays; an empty box neither stays nor drops
    another; an IoU of exactly 0.25 does not drop (the threshold is strict)."""
    shift = [0.1, 0, 0]
    lo2 = [[0, 0, 0], shift]
    hi2 = [[1, 1, 1], [1.1, 1, 1]]
    if case == "same_class":
        args, want = (lo2, hi2, [0.5, 0.9], [3, 3], [True, True]), [False, True]
    elif case == "other_class":
        args, want = (lo2, hi2, [0.5, 0.9], [3, 4], [True, True]), [True, True]
    elif case == "tie_by_index":
        args, want = (lo2, hi2, [0.7, 0.7], [3, 3], [True, True]), [True, False]
    elif case == "chain":
        lo = [[0, 0, 0], [0.4, 0, 0], [0.8, 0, 0]]
        hi = [[1, 1, 1], [1.4, 1, 1], [1.8, 1, 1]]  # IoU(a, b) = IoU(b, c) = 0.6/1.4, IoU(a, c) = 0.2/1.8
        args, want = (lo, hi, [0.9, 0.8, 0.7], [1, 1, 1], [True] * 3), [True, False, True]
    elif case == "empty":
        args, want = (lo2, hi2, [0.9, 0.5], [3, 3], [False, True]), [False, True]
    else:
        lo = [[0, 0, 0], [0.6, 0, 0]]
        hi = [[1, 1, 1], [1.6, 1, 1]]  # inter 0.4, union 1.6: IoU 0.25 exactly in float32
        args, want = (lo, hi, [0.9, 0.5], [2, 2], [True, True]), [True, True]
    np.testing.assert_array_equal(_nms(*args), want)
    lo, hi, score, cls, valid = (np.asarray(a) for a in args)
    picked = vn.nms_samecls(lo.astype(np.float32), hi.astype(np.float32), score.astype(np.float32), cls, valid, 0.25)
    np.testing.assert_array_equal(picked, want)


@pytest.mark.parametrize("seed", range(6))
def test_box_nms_matches_greedy_on_crowded_boxes(seed):
    """60 boxes in a 2 m cube, 3 classes, scores drawn from 8 values (ties
    everywhere), a tenth of them empty: the fixpoint equals the
    reference's greedy loop exactly."""
    rng = np.random.default_rng(seed)
    p = 60
    c = rng.uniform(0, 2, (p, 3)).astype(np.float32)
    h = rng.uniform(0.1, 0.6, (p, 3)).astype(np.float32)
    lo, hi = c - h, c + h
    score = (rng.integers(0, 8, p) / 8).astype(np.float32)
    cls = rng.integers(0, 3, p)
    valid = rng.uniform(size=p) > 0.1
    want = vn.nms_samecls(lo, hi, score, cls, valid, 0.25)
    np.testing.assert_array_equal(_nms(lo, hi, score, cls, valid), want)
    assert 0 < want.sum() < valid.sum()


@pytest.mark.parametrize("seed", range(3))
def test_points_in_boxes_counts_the_faces(seed):
    """The count against the reference's, with points exactly on faces and
    corners (lo <= p <= hi holds them) and boxes of zero extent."""
    rng = np.random.default_rng(seed)
    pts = (rng.integers(0, 9, (2, 500, 3)) / 8).astype(np.float32)
    lo = (rng.integers(0, 9, (2, 40, 3)) / 8).astype(np.float32)
    hi = lo + (rng.integers(0, 5, (2, 40, 3)) / 8).astype(np.float32)
    got = kboxes.points_in_boxes(torch.from_numpy(pts), torch.from_numpy(lo), torch.from_numpy(hi))
    for b in range(2):
        want = vn.count_in_boxes(torch.from_numpy(pts[b]), torch.from_numpy(lo[b]), torch.from_numpy(hi[b]))
        assert torch.equal(got[b], want)


def test_points_in_boxes_chunks_give_the_whole(monkeypatch):
    pts = torch.rand((2, 300, 3))
    lo = torch.rand((2, 50, 3)) * 0.5
    hi = lo + 0.4
    want = kboxes.points_in_boxes(pts, lo, hi)
    monkeypatch.setattr(kboxes, "CHUNK_ELEMS", 2 * 300 * 7)  # 7 boxes a chunk, a ragged last one
    assert torch.equal(kboxes.points_in_boxes(pts, lo, hi), want)


def test_points_in_boxes_treats_nan_as_outside():
    """A NaN coordinate in a point, or a NaN bound of a box, fails its
    comparison: the point is outside, as the reference counts it."""
    pts = torch.tensor([[[0.5, 0.5, 0.5], [float("nan"), 0.5, 0.5], [0.5, 0.5, float("nan")], [0.2, 0.2, 0.2]]])
    lo = torch.tensor([[[0.0, 0.0, 0.0], [0.0, float("nan"), 0.0], [0.0, 0.0, 0.0]]])
    hi = torch.tensor([[[1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, float("nan")]]])
    got = kboxes.points_in_boxes(pts, lo, hi)
    assert got.dtype == torch.int64 and got.tolist() == [[2, 0, 0]]
    assert torch.equal(got[0], vn.count_in_boxes(pts[0], lo[0], hi[0]))


def test_count_in_boxes_takes_the_plain_route_on_the_cpu(monkeypatch):
    """CPU tensors: the plain count, strided views read as they are, no
    library loaded and no launch counted."""
    monkeypatch.setattr(build, "load", lambda name: pytest.fail(f"loaded {name} on the CPU"))
    clouds = torch.rand((2, 300, 4))
    lo = torch.rand((2, 33, 3)) * 0.5
    hi = lo + 0.4
    before = kboxes.count_in_boxes.launches
    got = kboxes.count_in_boxes(clouds[..., :3], lo, hi)
    assert kboxes.count_in_boxes.launches == before
    assert torch.equal(got, kboxes.points_in_boxes(clouds[..., :3].contiguous(), lo, hi))


def test_box_count_library_is_built_at_its_first_use_only():
    """`build_all`'s default list (the training CLI's, the robot's) leaves
    the box count's library out; its source lies in the port."""
    assert "boxes" not in build.SOURCES and "boxes" in build.LAZY
    assert build._source("boxes").exists() and build._source("boxes").parent == build.CSRC


def test_negative_sizes_make_the_same_box():
    """A residual below -1 makes mean + residual negative: the box is its
    absolute size, as the published corners' min and max give it."""
    cfg = VoteNetConfig()
    b, p, ns = 1, 2, cfg.num_size_cluster
    size_scores = torch.zeros((b, p, ns))
    size_scores[..., 4] = 1.0
    res = torch.zeros((b, p, ns, 3))
    res[0, 0, 4] = torch.tensor([-2.0, -1.5, 0.5])  # normalised: (mean x (1 + r))
    mean = torch.tensor(cfg.mean_size)
    ep = {"size_scores": size_scores, "size_residuals": res * mean, "center": torch.zeros((b, p, 3))}
    lo, hi = boxes.box_bounds(ep, mean)
    want = torch.abs(mean[4] * torch.tensor([-1.0, -0.5, 1.5])) / 2
    assert torch.allclose(hi[0, 0], want) and torch.allclose(lo[0, 0], -want)
    assert torch.allclose(hi[0, 1], mean[4] / 2)


def test_dispatch_and_fetch_record_their_spans_and_counts():
    cfg = VoteNetConfig.tiny()
    pipe = DetectionPipeline(params=seeded_state(cfg, 1), cfg=cfg, device="cpu")
    timings = {}
    with tracing.recording() as rec:
        handle = pipe.dispatch(scans(cfg, 5), timings)
        dets = pipe.finish(handle)
    spans = {s.name: s for s in rec.drain()}
    assert set(spans) == {"detect.dispatch", "detect.boxes", "detect.fetch", "detect.nms"}
    assert spans["detect.boxes"].parent == spans["detect.dispatch"].id
    assert spans["detect.nms"].parent == spans["detect.fetch"].id
    assert spans["detect.nms"].counts["sweeps"] >= 1
    rows = np.stack([d.rows for d in dets])
    assert spans["detect.boxes"].counts == {"card": 0, "proposals": 2 * cfg.num_proposal,
                                            "nonempty": int((rows[..., boxes.NONEMPTY] > 0).sum()),
                                            "kept": int((rows[..., boxes.KEPT] > 0).sum())}
    assert set(timings) == {"detect.dispatch", "detect.boxes", "detect.fetch", "detect.nms", "detect"}
    assert timings["detect"] >= timings["detect.dispatch"] + timings["detect.fetch"]


def test_detections_report_the_kept_rows():
    cfg = VoteNetConfig.tiny()
    pipe = DetectionPipeline(params=seeded_state(cfg, 2), cfg=cfg, device="cpu")
    d = pipe.detect(scans(cfg, 7))[0]
    k = d.kept
    assert isinstance(d, Detections) and d.rows.shape == (cfg.num_proposal, boxes.SCORES + cfg.num_class)
    np.testing.assert_array_equal(d.index, np.flatnonzero(k))
    assert d.boxes.shape == (k.sum(), 6) and np.all(d.boxes[:, 3:] >= d.boxes[:, :3])
    assert d.scores.shape == (k.sum(), cfg.num_class) and np.all(d.obj_prob > cfg.conf_thresh)
    np.testing.assert_allclose(d.scores.sum(-1), d.obj_prob, rtol=1e-5)  # sem_prob sums to 1
    assert np.all(d.sem_cls == np.argmax(d.scores, -1))
    assert not np.any(k & ~d.nonempty)


def test_pipeline_loads_a_checkpoint_and_warms_up(tmp_path):
    from graspnet_tpu_torch import checkpoint

    cfg = VoteNetConfig.tiny()
    state = seeded_state(cfg, 3)
    path = str(tmp_path / "vn.pt")
    checkpoint.save(path, {"model": state})
    pipe = DetectionPipeline(cfg=cfg, device="cpu", checkpoint_path=path)
    assert all(torch.equal(pipe.model.state_dict()[k], v) for k, v in state.items())
    assert pipe.warmup(batch_size=2) > 0


def test_floor_height_is_the_rooms_fourth_channel():
    cloud = scans(VoteNetConfig.tiny(), 11, 1)[0]
    np.testing.assert_array_equal(floor_height(cloud[:, :3]), cloud)


def test_the_backbone_takes_either_configuration():
    """VoteNet's backbone fields build the same modules as a GraspNetConfig
    with those fields."""
    v = VoteNetConfig.tiny()
    g = GraspNetConfig(num_point=v.num_point, input_feature_dim=v.input_feature_dim, sa1=v.sa1, sa2=v.sa2,
                       sa3=v.sa3, sa4=v.sa4, fp1_mlp=v.fp1_mlp, fp2_mlp=v.fp2_mlp)
    a, b = Backbone(v).state_dict(), Backbone(g).state_dict()
    assert {k: t.shape for k, t in a.items()} == {k: t.shape for k, t in b.items()}


def test_published_widths():
    """The ScanNet configuration's shapes: 97 proposal channels, 259-wide
    vote aggregation, about a million parameters."""
    cfg = VoteNetConfig()
    sd = VoteNet(cfg).state_dict()
    assert cfg.head_dim == 97 and sd["pnet.conv3.kernel"].shape == (128, 97)
    assert sd["pnet.vote_aggregation.mlps.0.0.kernel"].shape == (259, 128)
    assert sd["vgen.conv3.kernel"].shape == (256, 259)
    assert sd["backbone.sa1.mlp.0.kernel"].shape == (4, 64)
    assert 0.9e6 < sum(v.numel() for k, v in sd.items() if k.endswith(("kernel", "bias"))) < 1.1e6
