"""A plain float32 VoteNet with ScanNet's evaluation post-processing: the
reference that decides `correct` for the detection cells and that the
port's CPU tests hold `DetectionPipeline` against.

It follows facebookresearch/votenet (Qi et al., ICCV 2019): the backbone
of `models/backbone_module.py`, `voting_module.py`, `proposal_module.py`
with `cluster_sampling seed_fps` and `decode_scores`, then
`models/ap_helper.py::parse_predictions` with `remove_empty_box`,
`use_3d_nms`, `cls_nms` and `per_class_proposal`, and
`utils/nms.py::nms_3d_faster_samecls`.  The voting and proposal layers are
channels-first 1x1 convolutions with BatchNorm in eval, as published
(`F.conv1d`, `F.conv2d`, `F.batch_norm`).  It imports nothing of the
program and runs with TF32 off (`judge.precision`).

Departures from the published code:

- The backbone is `gn`'s frozen plain PointNet++ (the same stages as
  votenet's `Pointnet2Backbone`), whose eval SA stages fold BatchNorm into
  the dense weights, a re-association of the same products.
- The in-box test is lo <= p <= hi on each axis of the axis-aligned box;
  the original tests the points against a Delaunay hull of the box's 8
  corners (`extract_pc_in_box3d`), which holds the same points up to
  rounding on the faces.
- NMS visits equal scores by ascending index; the original's `np.argsort`
  leaves their order unspecified.
- Every number is float32; the original post-processing runs in numpy
  float64.  The corners are taken in depth coordinates: the original's
  round trip through upright camera axes is a permutation and a sign flip,
  and the IoU's products keep its axis order (x, then depth z, then depth
  y).
- An all-empty scan keeps no box (the original asserts on it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .gn import ops
from .gn.backbone import Backbone


@dataclasses.dataclass(frozen=True)
class Detector:
    """The configuration file's `detector`: what follows the backbone."""

    num_proposal: int = 256
    vote_factor: int = 1
    vote_radius: float = 0.3
    vote_nsample: int = 16
    vote_mlp: Tuple[int, ...] = (128, 128, 128)
    num_class: int = 18
    num_heading_bin: int = 1
    num_size_cluster: int = 18
    mean_size: Tuple[Tuple[float, float, float], ...] = ()
    min_box_points: int = 5
    nms_iou: float = 0.25
    conf_thresh: float = 0.05

    @staticmethod
    def from_fields(fields: Dict) -> "Detector":
        kw = {k: tuple(tuple(r) for r in v) if k == "mean_size" else (tuple(v) if isinstance(v, list) else v)
              for k, v in fields.items()}
        return Detector(**kw)


class VoteNet:
    """VoteNet in eval mode on the benchmark's weights (the program's state
    dict names: `backbone.*`, `vgen.conv1.kernel`, `pnet.bn2.mean`, ...)."""

    def __init__(self, backbone_cfg, det: Detector, weights: Dict[str, torch.Tensor], device):
        self.det = det
        self.eps = backbone_cfg.bn_eps
        self.device = torch.device(device)
        self.w = {k: v.detach().to(self.device) for k, v in weights.items()}
        bb = Backbone(backbone_cfg)
        bb.load_state_dict({k[len("backbone."):]: v.detach().cpu() for k, v in weights.items()
                            if k.startswith("backbone.")}, strict=True)
        self.backbone = bb.to(self.device).eval().requires_grad_(False)
        self.mean_size = torch.tensor(det.mean_size, dtype=torch.float32, device=self.device)

    def _conv(self, x: torch.Tensor, name: str, bias: bool = True) -> torch.Tensor:
        """A 1x1 convolution, channels-first: the program's (in, out) kernel
        as an (out, in, 1[, 1]) weight."""
        kernel = self.w[f"{name}.kernel"].t()
        if x.dim() == 3:
            return F.conv1d(x, kernel[:, :, None], self.w[f"{name}.bias"] if bias else None)
        return F.conv2d(x, kernel[:, :, None, None], self.w[f"{name}.bias"] if bias else None)

    def _bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w = self.w
        return F.batch_norm(x, w[f"{name}.mean"], w[f"{name}.var"], w[f"{name}.scale"], w[f"{name}.offset"],
                            training=False, eps=self.eps)

    @torch.no_grad()
    def forward(self, clouds: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, N, 3 + 1) -> the seeds, votes, aggregated votes and the raw
        proposal channels `head` (B, P, 2 + 3 + 2 nh + 4 ns + nc)."""
        d = self.det
        seed_feat, seed_xyz, _ = self.backbone(clouds)
        b, s, c = seed_feat.shape
        # voting_module.py
        f = seed_feat.transpose(1, 2)
        net = F.relu(self._bn(self._conv(f, "vgen.conv1"), "vgen.bn1"))
        net = F.relu(self._bn(self._conv(net, "vgen.conv2"), "vgen.bn2"))
        net = self._conv(net, "vgen.conv3").transpose(2, 1).reshape(b, s, d.vote_factor, 3 + c)
        vote_xyz = (seed_xyz.unsqueeze(2) + net[..., 0:3]).reshape(b, s * d.vote_factor, 3)
        vote_feat = (f.transpose(2, 1).unsqueeze(2) + net[..., 3:]).reshape(b, s * d.vote_factor, c)
        vote_feat = vote_feat.transpose(2, 1)
        vote_feat = vote_feat.div(torch.norm(vote_feat, p=2, dim=1).unsqueeze(1))
        # proposal_module.py, seed_fps: PointnetSAModuleVotes with the sampled indices
        inds = ops.fps_plain(seed_xyz, d.num_proposal)
        new_xyz = ops.gather_points(vote_xyz, inds)
        idx = ops.ball_query_plain(vote_xyz, new_xyz, d.vote_radius, d.vote_nsample)
        grouped_xyz = (ops.group_points(vote_xyz, idx) - new_xyz.unsqueeze(2)) / d.vote_radius
        grouped_feat = ops.group_points(vote_feat.transpose(1, 2).contiguous(), idx)
        x = torch.cat([grouped_xyz, grouped_feat], dim=-1).permute(0, 3, 1, 2)  # (B, 3 + C, P, ns)
        for i in range(len(d.vote_mlp)):
            name = f"pnet.vote_aggregation.mlps.0.{i}"
            x = F.relu(self._bn(self._conv(x, name, bias=False), f"{name}.bn"))
        feat = F.max_pool2d(x, kernel_size=[1, x.size(3)]).squeeze(-1)  # (B, 128, P)
        net = F.relu(self._bn(self._conv(feat, "pnet.conv1"), "pnet.bn1"))
        net = F.relu(self._bn(self._conv(net, "pnet.conv2"), "pnet.bn2"))
        head = self._conv(net, "pnet.conv3").transpose(2, 1).contiguous()
        return {"seed_xyz": seed_xyz, "vote_xyz": vote_xyz, "aggregated_vote_xyz": new_xyz,
                "aggregated_vote_inds": inds, "head": head}


def softmax(x: torch.Tensor) -> torch.Tensor:
    """ap_helper.softmax: exp(x - max) over its sum, on the last axis."""
    probs = torch.exp(x - torch.max(x, dim=-1, keepdim=True).values)
    return probs / torch.sum(probs, dim=-1, keepdim=True)


def decode(head: torch.Tensor, agg_xyz: torch.Tensor, det: Detector, mean_size: torch.Tensor) -> Dict:
    """decode_scores and the first half of parse_predictions: each
    proposal's objectness probability, semantic class and probabilities,
    and its box's corners in depth coordinates."""
    nh, ns = det.num_heading_bin, det.num_size_cluster
    b, p, _ = head.shape
    center = agg_xyz + head[..., 2:5]
    size_scores = head[..., 5 + 2 * nh: 5 + 2 * nh + ns]
    size_res = head[..., 5 + 2 * nh + ns: 5 + 2 * nh + 4 * ns].reshape(b, p, ns, 3) * mean_size
    sem_scores = head[..., 5 + 2 * nh + 4 * ns:]
    size_cls = torch.argmax(size_scores, -1)
    res = torch.gather(size_res, 2, size_cls.unsqueeze(-1).unsqueeze(-1).repeat(1, 1, 1, 3)).squeeze(2)
    size = mean_size[size_cls] + res  # class2size; class2angle is 0 on ScanNet
    a, z = center - size / 2, center + size / 2  # get_3d_box's corners, min and max per axis
    return {"lo": torch.minimum(a, z), "hi": torch.maximum(a, z), "obj_prob": softmax(head[..., 0:2])[..., 1],
            "sem_cls": torch.argmax(sem_scores, -1), "sem_prob": softmax(sem_scores),
            "size_scores": size_scores, "sem_scores": sem_scores}


def count_in_boxes(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """remove_empty_box's count, one scan: (N, 3) points, (P, 3) corners ->
    (P,) the points with lo <= p <= hi on every axis."""
    inside = (points[None] >= lo[:, None]) & (points[None] <= hi[:, None])
    return inside.all(dim=-1).sum(dim=-1)


def iou_rows(lo: np.ndarray, hi: np.ndarray, i: int, rest: np.ndarray) -> np.ndarray:
    """nms_3d_faster_samecls's new-type IoU of box i with the boxes `rest`
    (float32; the products in the published axis order)."""
    side = np.maximum(np.float32(0), np.minimum(hi[i], hi[rest]) - np.maximum(lo[i], lo[rest]))
    ext = hi - lo
    area = ext[:, 0] * ext[:, 2] * ext[:, 1]
    inter = side[:, 0] * side[:, 2] * side[:, 1]
    with np.errstate(invalid="ignore", divide="ignore"):
        return inter / (area[i] + area[rest] - inter)


def nms_samecls(lo, hi, score, cls, valid, iou_thresh: float) -> np.ndarray:
    """Greedy class-aware NMS over the `valid` boxes, descending score, ties
    by ascending index -> (P,) bool picked."""
    lo, hi, score, cls = (np.asarray(a) for a in (lo, hi, score, cls))
    cand = np.flatnonzero(valid)
    order = cand[np.lexsort((cand, -score[cand]))]
    picked = np.zeros(len(score), bool)
    while len(order):
        i, rest = order[0], order[1:]
        picked[i] = True
        o = iou_rows(lo, hi, i, rest) * (cls[i] == cls[rest])
        order = rest[~(o > iou_thresh)]
    return picked


def parse_predictions(out: Dict[str, torch.Tensor], points: torch.Tensor, det: Detector,
                      mean_size: torch.Tensor) -> Dict[str, np.ndarray]:
    """(B, N, 3) points -> per proposal (numpy, (B, P, ...)): `lo`, `hi`,
    `obj_prob`, `sem_cls`, `scores` (sem_prob x obj_prob), `count`,
    `nonempty`, `picked` (NMS) and `kept` (picked, obj_prob above
    conf_thresh)."""
    dec = decode(out["head"], out["aggregated_vote_xyz"], det, mean_size)
    count = torch.stack([count_in_boxes(points[i], dec["lo"][i], dec["hi"][i]) for i in range(points.shape[0])])
    res = {k: v.cpu().numpy() for k, v in dec.items()}
    res["count"] = count.cpu().numpy()
    res["nonempty"] = res["count"] >= det.min_box_points
    res["picked"] = np.stack([nms_samecls(res["lo"][i], res["hi"][i], res["obj_prob"][i], res["sem_cls"][i],
                                          res["nonempty"][i], det.nms_iou) for i in range(len(res["lo"]))])
    res["kept"] = res["picked"] & (res["obj_prob"] > np.float32(det.conf_thresh))
    res["scores"] = res["sem_prob"] * res["obj_prob"][..., None]
    return res


# columns of a proposal's row as the program returns it (postproc/boxes.py); then the per-class scores
LO, HI, OBJ_PROB, SEM_CLS, NONEMPTY, KEPT, SCORES = 0, 3, 6, 7, 9, 11, 12


def compare(rows: np.ndarray, head: np.ndarray, ref_head: np.ndarray, res: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The program's rows (B, P, 12 + num_class) and raw channels (B, P,
    head_dim) of a batch against the reference's raw channels and `res`,
    every proposal judged:

    - `head_gap`: the widest difference of a raw channel;
    - `box_gap`: of a box both keep, the widest difference of its corners,
      obj_prob and per-class scores;
    - `selection_diff`: proposals non-empty on one side only, kept on one
      side only, or kept by both with another class."""
    p_nonempty, p_kept = rows[..., NONEMPTY] > 0, rows[..., KEPT] > 0
    p_cls = rows[..., SEM_CLS].astype(np.int64)
    both = p_kept & res["kept"]
    diff = int(np.sum(p_nonempty != res["nonempty"]) + np.sum(p_kept != res["kept"])
               + np.sum(both & (p_cls != res["sem_cls"])))
    gap = 0.0
    if both.any():
        got = np.concatenate([rows[..., LO:HI + 3], rows[..., OBJ_PROB:OBJ_PROB + 1], rows[..., SCORES:]], axis=-1)
        want = np.concatenate([res["lo"], res["hi"], res["obj_prob"][..., None], res["scores"]], axis=-1)
        gap = float(np.abs(got[both].astype(np.float64) - want[both]).max())
    head_gap = float(np.abs(head.astype(np.float64) - ref_head).max())
    return {"head_gap": head_gap, "box_gap": gap, "selection_diff": diff}
