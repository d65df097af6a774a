"""Group-Free-3D on the port (`models/groupfree.py`, `ops/cuda/attn.py`,
`postproc/boxes.py`, `apps/detect.py`) against the benchmark's plain
reference (`benchmark/reference/gf.py`), at `GroupFreeConfig.tiny()` (a
quarter of every width, 2 decoder layers, 16 queries, 2 heads of 36) on
the CPU with seeded weights whose BatchNorms are not the identity and whose
biases are not zero.

On the CPU the port's attention is its plain version, the reference's
arithmetic op for op (the reference takes the port's layer forms so that on
the card a difference lies in the kernels alone), so the raw head channels
come out bitwise the reference's, and so do the selections (KPS indices,
the non-empty, picked and kept sets, the classes, the in-box counts).  Box
corners, obj_prob and per-class scores within SCORE_ATOL: the program's
device post-processing and the reference's numpy one round a few products
and sums of those numbers on their own.  The attention's plain version
against a softmax written out head by head in float64: 1e-6, float32 sums
of at most 64 terms.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.inputs.rooms import room_pool
from benchmark.reference import gf, gn
from graspnet_tpu_torch.apps.detect import DetectionPipeline
from graspnet_tpu_torch.config import GraspNetConfig, GroupFreeConfig, SAConfig, VoteNetConfig
from graspnet_tpu_torch.models import init_weights
from graspnet_tpu_torch.models import groupfree as gf_model
from graspnet_tpu_torch.models.backbone import Backbone
from graspnet_tpu_torch.models.groupfree import GroupFree3D
from graspnet_tpu_torch.ops.cuda import attn, build
from graspnet_tpu_torch.postproc import boxes
from graspnet_tpu_torch.utils import tracing

SCORE_ATOL = 1e-5
CONFIG = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / "groupfree3d-scannet-L12-O512-w2x.infer.json"
BACKBONE_FIELDS = ("num_point", "input_feature_dim", "sa1", "sa2", "sa3", "sa4", "fp1_mlp", "fp2_mlp")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_state(cfg: GroupFreeConfig, seed: int) -> dict:
    """Kaiming kernels (`init_weights`), then every bias, BatchNorm
    statistic and affine and LayerNorm affine drawn away from zero and the
    identity."""
    model = init_weights(GroupFree3D(cfg), seed)
    gen = torch.Generator().manual_seed(seed + 1)
    state = model.state_dict()
    for k, v in state.items():
        leaf = k.rsplit(".", 1)[-1]
        lo, hi = {"bias": (-0.1, 0.1), "mean": (-0.1, 0.1), "var": (0.5, 2.0), "scale": (0.5, 1.5),
                  "offset": (-0.1, 0.1)}.get(leaf, (None, None))
        if lo is not None:
            state[k] = lo + (hi - lo) * torch.rand(v.shape, generator=gen)
    return state


def detector(cfg: GroupFreeConfig) -> gf.Detector:
    """The reference's detector fields: GroupFreeConfig's of the same names."""
    return gf.Detector(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(gf.Detector)})


def reference(cfg: GroupFreeConfig, state: dict) -> gf.GroupFree:
    fields = {f: getattr(cfg, f) for f in BACKBONE_FIELDS}
    bb = gn.GraspNetConfig(**{k: (gn.SAConfig(*tuple(v.__dict__.values())) if isinstance(v, SAConfig) else v)
                              for k, v in fields.items()})
    return gf.GroupFree(bb, detector(cfg), state, "cpu")


def scans(cfg, seed: int, b: int = 2) -> np.ndarray:
    return room_pool(seed, b, cfg.num_point)


def close(got, want, atol):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert torch.isfinite(got).all()
    err = (got.double() - want.double()).abs().max().item()
    assert err <= atol * max(1.0, want.abs().max().item()), err


CASES = [(1, 4), (2, 5), (3, 6)]  # (weight seed, scan seed): NMS drops boxes in each


@pytest.mark.parametrize("wseed,sseed", CASES)
def test_queries_and_heads_match_the_reference(wseed, sseed):
    cfg = GroupFreeConfig.tiny()
    state = seeded_state(cfg, wseed)
    model = GroupFree3D(cfg)
    model.load_state_dict(state)
    x = torch.from_numpy(scans(cfg, sseed))
    with torch.no_grad():
        got = model.eval()(x)
    want = reference(cfg, state).forward(x)
    assert torch.equal(got["seed_xyz"], want["seed_xyz"])
    assert torch.equal(got["query_inds"], want["query_inds"])
    assert torch.equal(got["query_xyz"], want["query_xyz"])
    assert torch.equal(got["head"], want["head"])
    assert torch.equal(got["size_cls_layers"], want["size_cls_layers"])
    assert got["head"].shape == (2, cfg.num_proposal, cfg.head_dim)
    assert got["size_cls_layers"].shape == (cfg.num_decoder_layers + 1, 2, cfg.num_proposal)


@pytest.mark.parametrize("wseed,sseed", CASES)
def test_pipeline_boxes_and_selections_match_the_reference(wseed, sseed):
    """The non-empty, picked and kept sets exact, the classes and in-box
    counts equal, the kept boxes' corners, obj_prob and per-class scores
    within SCORE_ATOL; the cell's judge reads no selection difference."""
    cfg = GroupFreeConfig.tiny()
    state = seeded_state(cfg, wseed)
    clouds = scans(cfg, sseed)
    pipe = DetectionPipeline(params=state, cfg=cfg, device="cpu")
    handle = pipe.dispatch(clouds)
    dets = pipe.finish(handle)
    ref = reference(cfg, state)
    x = torch.from_numpy(clouds)
    out = ref.forward(x)
    res = gf.parse_predictions(out, x[..., :3], detector(cfg), ref.mean_size)
    rows = np.stack([d.rows for d in dets])
    np.testing.assert_array_equal(rows[..., boxes.NONEMPTY] > 0, res["nonempty"])
    np.testing.assert_array_equal(rows[..., boxes.PICKED] > 0, res["picked"])
    np.testing.assert_array_equal(rows[..., boxes.KEPT] > 0, res["kept"])
    np.testing.assert_array_equal(rows[..., boxes.SEM_CLS].astype(np.int64), res["sem_cls"])
    np.testing.assert_array_equal(rows[..., boxes.POINTS].astype(np.int64), res["count"])
    kept = res["kept"]
    assert 0 < kept.sum() < res["nonempty"].sum()  # NMS has work
    close(rows[..., boxes.LO: boxes.HI + 3][kept], np.concatenate([res["lo"], res["hi"]], -1)[kept], SCORE_ATOL)
    close(rows[..., boxes.OBJ_PROB][kept], res["obj_prob"][kept], SCORE_ATOL)
    close(rows[..., boxes.SCORES:][kept], res["scores"][kept], SCORE_ATOL)
    got = gf.compare(rows, handle.end_points["head"].numpy(), out["head"].numpy(), res, x[..., :3], detector(cfg))
    assert got == {"head_gap": 0.0, "box_gap": got["box_gap"], "selection_diff": 0}
    assert got["box_gap"] <= SCORE_ATOL


def _tie_rows(obj):
    """Two overlapping unit boxes of one class with the objectness `obj`,
    and a third far off, as the program's rows; 30 points inside each."""
    rows = np.zeros((1, 3, boxes.SCORES + 1), np.float32)
    rows[0, :, boxes.LO: boxes.LO + 3] = [[0, 0, 0], [0.1, 0, 0], [5, 5, 5]]
    rows[0, :, boxes.HI: boxes.HI + 3] = rows[0, :, boxes.LO: boxes.LO + 3] + 1
    rows[0, :, boxes.OBJ_PROB] = obj
    rows[0, :, boxes.POINTS] = [30, 30, 30]
    rows[0, :, boxes.NONEMPTY] = 1
    rows[0, :, boxes.SCORES] = obj
    pts = torch.from_numpy(np.concatenate([np.full((30, 3), 0.55), np.full((30, 3), 5.5)]).astype(np.float32))
    return rows, pts[None]


@pytest.mark.parametrize("case", ["sound", "tie_either_way", "no_nms", "count", "class", "scores"])
def test_compare_judges_decisions_on_the_programs_numbers(case):
    """A near-tie of two overlapping boxes' scores (1e-7 apart) that the
    program breaks the other way than the reference's own numbers would is
    no selection difference: its NMS is checked on its own scores, which
    lie within rounding of the reference's.  A pick the NMS would not make,
    a count other than the points in the box, a class other than the
    reference's, or scores off the reference's are."""
    det = gf.Detector(num_class=1, num_size_cluster=1, mean_size=((1.0, 1.0, 1.0),))
    ref_obj = np.array([0.6, 0.6000001, 0.3], np.float32)
    rows, pts = _tie_rows(ref_obj)
    res = {"lo": rows[..., 0:3].copy(), "hi": rows[..., 3:6].copy(), "obj_prob": ref_obj[None].copy(),
           "scores": ref_obj[None, :, None].copy(), "sem_cls": np.zeros((1, 3), np.int64)}
    if case == "tie_either_way":
        rows[0, :, boxes.OBJ_PROB] = rows[0, :, boxes.SCORES] = [0.6000001, 0.6, 0.3]
    picked = gf.decide(rows, pts, det)["picked"]
    rows[..., boxes.PICKED] = rows[..., boxes.KEPT] = picked
    if case == "no_nms":
        rows[..., boxes.PICKED] = rows[..., boxes.KEPT] = 1
    elif case == "count":
        rows[0, 2, boxes.POINTS] = 29
    elif case == "class":
        rows[0, 2, boxes.SEM_CLS] = 1
    elif case == "scores":
        rows[0, 2, boxes.OBJ_PROB] += 0.01
    got = gf.compare(rows, np.zeros((1, 3, 4)), np.zeros((1, 3, 4)), res, pts, det)
    assert got["selection_diff"] == {"sound": 0, "tie_either_way": 0, "no_nms": 2, "count": 1, "class": 1,
                                     "scores": 0}[case]
    assert (got["box_gap"] > 0.009) == (case == "scores")
    if case == "tie_either_way":
        assert picked.tolist() == [[True, False, True]] and got["box_gap"] < 1e-6


@pytest.mark.parametrize("tie", [0.0, 1e9])
def test_the_reference_follows_the_programs_size_classes_within_the_tie(tie):
    """Given the program's size class of every head, the reference takes one
    that scores within `tie` of its own maximum (the next layer then embeds
    the program's box) and counts one further off, keeping its own: a class
    moved to another at layer 0's head parts at a tie of 0 and is followed
    at a tie past every score."""
    cfg = GroupFreeConfig.tiny()
    ref = reference(cfg, seeded_state(cfg, 1))
    x = torch.from_numpy(scans(cfg, 4))
    out = ref.forward(x)
    same = ref.forward(x, follow=out["size_cls_layers"], tie=tie)
    assert torch.equal(same["head"], out["head"]) and same["size_cls_parted"] == 0
    follow = out["size_cls_layers"].clone()
    follow[1, 0, 3] = (follow[1, 0, 3] + 1) % cfg.num_size_cluster
    got = ref.forward(x, follow=follow, tie=tie)
    if tie == 0.0:
        assert got["size_cls_parted"] == 1 and torch.equal(got["head"], out["head"])
    else:
        assert got["size_cls_parted"] == 0 and not torch.equal(got["head"], out["head"])
        assert torch.equal(got["size_cls_layers"][1], follow[1])


def written_out(q, k, v, heads):
    """softmax(q_h k_h^T / sqrt(d)) v_h, one batch, one head, one query at a
    time, in float64."""
    b, lq, e = q.shape
    d = e // heads
    out = torch.zeros((b, lq, e), dtype=torch.float64)
    for i in range(b):
        for h in range(heads):
            cols = slice(h * d, (h + 1) * d)
            for r in range(lq):
                s = (k[i, :, cols].double() @ q[i, r, cols].double()) / d ** 0.5
                p = torch.exp(s - s.max())
                out[i, r, cols] = (p / p.sum()) @ v[i, :, cols].double()
    return out


@pytest.mark.parametrize("b,lq,lk,heads", [(2, 5, 7, 2), (1, 33, 64, 3), (2, 16, 1, 1), (1, 40, 17, 2)])
def test_attention_plain_is_softmax_attention_written_out(b, lq, lk, heads):
    """Lq != Lk, one key, ragged shapes; the keys and values as views into
    one packed projection, as the decoder hands them over."""
    gen = torch.Generator().manual_seed(lq * 100 + lk)
    e = heads * attn.HEAD_DIM
    q = torch.randn((b, lq, e), generator=gen) * 2
    kv = torch.randn((b, lk, 2 * e), generator=gen) * 2
    k, v = kv[..., :e], kv[..., e:]
    want = written_out(q, k, v, heads)
    got = attn.attention_plain(q, k, v, heads)
    assert got.shape == (b, lq, e) and got.dtype == torch.float32
    assert (got.double() - want).abs().max().item() <= 1e-6 * max(1.0, want.abs().max().item())
    before = attn.attention.launches
    assert torch.equal(attn.attention(q, k, v, heads), got)  # the CPU takes the plain version
    assert attn.attention.launches == before


def test_decoder_calls_the_attention_twice_a_layer(monkeypatch):
    """Self- and cross-attention of every layer go through the wrapper: 2
    calls a layer, with the queries, the seeds and the heads."""
    cfg = GroupFreeConfig.tiny()
    calls = []

    def counted(q, k, v, heads):
        calls.append((q.shape[1], k.shape[1], heads))
        return attn.attention_plain(q, k, v, heads)

    monkeypatch.setattr(gf_model, "attention", counted)
    model = GroupFree3D(cfg)
    model.load_state_dict(seeded_state(cfg, 1))
    with torch.no_grad():
        model.eval()(torch.from_numpy(scans(cfg, 4)))
    p, s = cfg.num_proposal, cfg.sa2.npoint
    assert calls == [(p, p, cfg.nhead), (p, s, cfg.nhead)] * cfg.num_decoder_layers


def test_dispatch_records_the_kps_and_decoder_spans():
    """`detect.kps` and `detect.decoder` inside `detect.dispatch`, with their
    counts; the box spans as VoteNet's; a `Detections` a scan."""
    cfg = GroupFreeConfig.tiny()
    pipe = DetectionPipeline(params=seeded_state(cfg, 2), cfg=cfg, device="cpu")
    timings = {}
    with tracing.recording() as rec:
        handle = pipe.dispatch(scans(cfg, 5), timings)
        dets = pipe.finish(handle)
    spans = {s.name: s for s in rec.drain()}
    assert set(spans) == {"detect.dispatch", "detect.kps", "detect.decoder", "detect.boxes", "detect.fetch",
                          "detect.nms"}
    for name in ("detect.kps", "detect.decoder", "detect.boxes"):
        assert spans[name].parent == spans["detect.dispatch"].id
    assert spans["detect.kps"].counts == {"seeds": cfg.sa2.npoint, "queries": cfg.num_proposal}
    assert spans["detect.decoder"].counts == {"layers": cfg.num_decoder_layers, "queries": cfg.num_proposal,
                                              "keys": cfg.sa2.npoint}
    assert spans["detect.boxes"].counts["proposals"] == 2 * cfg.num_proposal
    assert spans["detect.boxes"].counts["card"] == 0  # the plain count ran
    assert set(timings) == {"detect.dispatch", "detect.boxes", "detect.fetch", "detect.nms", "detect"}
    assert len(dets) == 2 and dets[0].rows.shape == (cfg.num_proposal, boxes.SCORES + cfg.num_class)
    k = dets[0].kept
    assert not np.any(k & ~dets[0].nonempty) and np.all(dets[0].obj_prob > cfg.conf_thresh)
    np.testing.assert_allclose(dets[0].scores.sum(-1), dets[0].obj_prob, rtol=1e-5)


def test_pipeline_loads_a_groupfree_checkpoint_and_warms_up(tmp_path):
    from graspnet_tpu_torch import checkpoint

    cfg = GroupFreeConfig.tiny()
    state = seeded_state(cfg, 3)
    path = str(tmp_path / "gf.pt")
    checkpoint.save(path, {"model": state})
    pipe = DetectionPipeline(cfg=cfg, device="cpu", checkpoint_path=path)
    assert isinstance(pipe.model, GroupFree3D)
    assert all(torch.equal(pipe.model.state_dict()[k], v) for k, v in state.items())
    assert pipe.warmup(batch_size=2) > 0


def test_objectness_of_either_head():
    """VoteNet's two logits through a softmax (bitwise what the box
    post-processing computed before it took Group-Free-3D's one logit
    through a sigmoid), Group-Free-3D's through a sigmoid."""
    gen = torch.Generator().manual_seed(0)
    two = torch.randn((2, 9, 2), generator=gen) * 3
    one = torch.randn((2, 9, 1), generator=gen) * 3
    assert torch.equal(boxes.objectness_prob({"objectness_scores": two}), torch.softmax(two, dim=-1)[..., 1])
    assert torch.equal(boxes.objectness_prob({"objectness_scores": one}), torch.sigmoid(one[..., 0]))


def test_votenet_rows_carry_the_softmax_objectness():
    """VoteNet's pipeline after the change: every row's obj_prob is the
    softmax of its two logits, bitwise."""
    from tests.test_torch_port_votenet import scans as vn_scans
    from tests.test_torch_port_votenet import seeded_state as vn_state

    cfg = VoteNetConfig.tiny()
    pipe = DetectionPipeline(params=vn_state(cfg, 1), cfg=cfg, device="cpu")
    handle = pipe.dispatch(vn_scans(cfg, 5))
    rows = np.stack([d.rows for d in pipe.finish(handle)])
    want = torch.softmax(handle.end_points["objectness_scores"], dim=-1)[..., 1].numpy()
    np.testing.assert_array_equal(rows[..., boxes.OBJ_PROB], want)


def test_decode_gives_the_published_box():
    """centre = base + residual; size = the argmax class's mean size plus
    its residual times that mean size; the objectness logit and the
    semantic scores where the published head puts them."""
    cfg = GroupFreeConfig()
    b, p = 1, 2
    head = torch.zeros((b, p, cfg.head_dim))
    head[..., 0] = torch.tensor([0.5, -1.0])
    head[0, 0, 1:4] = torch.tensor([0.1, -0.2, 0.3])
    head[0, :, 6 + 7] = 1.0  # size class 7 (size scores start at 4 + 2 x 1 heading)
    head[0, 0, 6 + 18 + 3 * 7: 6 + 18 + 3 * 8] = torch.tensor([0.5, -0.5, 0.0])
    head[0, :, 78 + 4] = 2.0  # semantic class 4
    mean = torch.tensor(cfg.mean_size)
    base = torch.ones((b, p, 3))
    dec = gf_model.decode_head(head, base, cfg, mean)
    assert torch.equal(dec["center"][0, 0], torch.tensor([1.1, 0.8, 1.3]))
    assert torch.allclose(dec["size"][0, 0], mean[7] * torch.tensor([1.5, 0.5, 1.0]))
    assert torch.equal(dec["size"][0, 1], mean[7])
    assert torch.equal(dec["objectness_scores"][..., 0], head[..., 0])
    assert dec["sem_cls_scores"].shape == (b, p, 18) and int(dec["sem_cls_scores"][0, 0].argmax()) == 4
    lo, hi = boxes.box_bounds(dec, mean)
    assert torch.allclose(hi - lo, dec["size"].abs())


def test_published_widths():
    """L12 O512 w2x: 96 head channels, 8 heads of 36 over 288 channels, a
    2,048-wide feed-forward, the w2x backbone; ~2.4 M parameters in the
    backbone and ~27 M after it."""
    cfg = GroupFreeConfig()
    sd = GroupFree3D(cfg).state_dict()
    assert cfg.head_dim == 96 and cfg.d_model == 288 and cfg.d_model // cfg.nhead == attn.HEAD_DIM
    assert sd["proposal_head.conv3.kernel"].shape == (288, 96)
    assert sd["points_obj_cls.conv3.kernel"].shape == (288, 1)
    assert sd["decoder.11.self_attn.in_proj.kernel"].shape == (288, 864)
    assert sd["decoder.0.linear1.kernel"].shape == (288, 2048)
    assert sd["decoder.0.self_posembed.conv1.kernel"].shape == (6, 288)
    assert sd["decoder.0.cross_posembed.conv1.kernel"].shape == (3, 288)
    assert sd["backbone.sa1.mlp.0.kernel"].shape == (4, 128)
    assert sd["backbone.fp2.mlp.1.kernel"].shape == (512, 288)
    params = {part: sum(v.numel() for k, v in sd.items() if k.endswith(("kernel", "bias"))
                        and k.startswith("backbone.") == (part == "backbone")) for part in ("backbone", "rest")}
    assert 2.3e6 < params["backbone"] < 2.5e6 and 26e6 < params["rest"] < 28e6


def test_the_configuration_file_is_the_published_config():
    """The benchmark's configuration file gives GroupFreeConfig's defaults:
    its model read as the harness reads it (a GraspNetConfig) builds the
    same backbone, and its detector holds the decoder and post-processing
    fields."""
    from graspnet_tpu_torch import config as program_config

    spec = json.loads(CONFIG.read_text())
    assert spec["reduced"] == [] and spec["precision"] == "float32, TF32 off"
    g = harness.model_config(spec["model"], program_config)
    cfg = GroupFreeConfig()
    assert {f: getattr(g, f) for f in BACKBONE_FIELDS} == {f: getattr(cfg, f) for f in BACKBONE_FIELDS}
    a, b = Backbone(g).state_dict(), Backbone(cfg).state_dict()
    assert {k: t.shape for k, t in a.items()} == {k: t.shape for k, t in b.items()}
    det = gf.Detector.from_fields(spec["detector"])
    assert det == detector(cfg)


def test_the_attention_library_is_built_at_its_first_use_only():
    """`build_all`'s default list (the training CLI's, the robot's) leaves
    the attention library out; its source lies in the port."""
    assert "attn" not in build.SOURCES and build.LAZY == ("attn", "boxes", "spconv")
    assert build._source("attn").exists() and build._source("attn").parent == build.CSRC
