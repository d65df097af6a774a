"""A plain float32 Group-Free-3D with ScanNet's evaluation post-processing:
the reference that decides `correct` for the Group-Free-3D cell and that
the port's CPU tests hold `DetectionPipeline` against.

It follows zeliu98/Group-Free-3D (Liu, Zhang, Cao, Hu, Tong, ICCV 2021),
`models/detector.py::GroupFreeDetector` with `sampling kps`,
`self_position_embedding loc_learned` and `cross_position_embedding
xyz_learned`: votenet's PointNet++ backbone at the configuration's widths,
`modules.py::PointsObjClsModule` and the top-k of its sigmoid,
`PredictHead` (proposal and per-layer), `PositionEmbeddingLearned` and
`transformer.py::TransformerDecoderLayer` in eval (dropout off), with
`nn.MultiheadAttention`'s math written out: the in-projection's query, key
and value parts with their biases, per head `softmax(q k^T / sqrt(d)) v`
(a matmul, a softmax, a matmul), the heads joined and the out-projection;
a ReLU feed-forward and `F.layer_norm`.  The post-processing is `vn.py`'s:
its in-box count, greedy class-aware NMS and softmax.  It imports nothing
of the program and runs with TF32 off (`judge.precision`).

`compare` judges the program's proposals in two steps.  Its numbers (the
last head's raw channels; every proposal's corners, objectness and
per-class scores) against the reference's, each within its limit; then
its decisions exactly, taken as the reference takes them but on the
program's own numbers (`decide`): the in-box count, non-empty, the NMS
picks, kept, and the class, the first maximum of the proposal's per-class
scores.  With random weights the 512 objectness probabilities of a scan
crowd into a band ~0.01 wide, so pairs of them lie within float32
rounding of each other and a greedy NMS that visits boxes by score may
visit two overlapping ones in either order; a face of a box likewise
passes within rounding of some of the 50,000 points, and two classes'
scores may tie.  Judged on the program's numbers, once those are held to
the reference's, such a tie is the program's to break, and every decision
past it is checked exactly.  The decoder makes one decision of its own a
layer, each head's size class, whose box the next layer embeds: given the
program's classes (`forward(follow=...)`), the reference takes the
program's where it scores within a tie (the cell's `head_gap` limit) of
its own maximum, and counts every other that parts.

Departures from the published code:

- The backbone is `gn`'s frozen plain PointNet++ (`vn.py`'s first
  departure: BatchNorm folded into the SA stages' dense weights).
- Every 1x1 convolution and linear layer is `gn.layers.dense` on
  channels-last rows (x @ kernel + bias; a 3-wide input as its
  broadcast-sum), BatchNorm in eval `(x - mean) rsqrt(var + eps) scale +
  offset`, and the decoder runs batch-first (B, L, C) rather than
  sequence-first: the same products as the published channels-first
  convolutions and sequence-first `F.linear`, in the order the program
  takes them, so that a difference between the two lies in the attention
  and the kernels, not in how cuBLAS or cuDNN split a sum.
- A head's seven output convolutions (objectness, centre, heading class
  and residual, size class and residual, semantic class) are one
  convolution to their 96 channels in that order, the same products.
- The decode and the boxes are the last layer's head's; the published
  evaluation (`eval_avg.py`) also reports the proposals of every head
  together, which needs no further model work.
- The post-processing departs from the published as `vn.py`'s does (the
  in-box test, tie order, float32, depth coordinates); the objectness
  probability is the sigmoid of the one logit, as Group-Free-3D's
  `ap_helper` reads it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import vn
from .gn import ops
from .gn.backbone import Backbone
from .gn.layers import dense

# columns of a proposal's row as the program returns it (postproc/boxes.py)
LO, HI, OBJ_PROB, SEM_CLS, POINTS, NONEMPTY, PICKED, KEPT, SCORES = 0, 3, 6, 7, 8, 9, 10, 11, 12


@dataclasses.dataclass(frozen=True)
class Detector:
    """The configuration file's `detector`: what follows the backbone."""

    num_proposal: int = 512
    num_decoder_layers: int = 12
    nhead: int = 8
    dim_feedforward: int = 2048
    num_class: int = 18
    num_heading_bin: int = 1
    num_size_cluster: int = 18
    mean_size: Tuple[Tuple[float, float, float], ...] = ()
    min_box_points: int = 5
    nms_iou: float = 0.25
    conf_thresh: float = 0.05
    ln_eps: float = 1e-5

    @staticmethod
    def from_fields(fields: Dict) -> "Detector":
        kw = {k: tuple(tuple(r) for r in v) if k == "mean_size" else v for k, v in fields.items()}
        return Detector(**kw)


class GroupFree:
    """Group-Free-3D in eval mode on the benchmark's weights (the program's
    state dict names: `backbone.*`, `points_obj_cls.conv1.kernel`,
    `decoder.3.self_attn.in_proj.kernel`, `prediction_heads.11.bn2.var`,
    ...; a kernel is shaped (in, out))."""

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

    def _dense(self, x: torch.Tensor, name: str, cols=slice(None)) -> torch.Tensor:
        """A 1x1 convolution or linear layer on channels-last rows; `cols`
        picks a part of a packed (in, out) kernel."""
        return dense(self.w[f"{name}.kernel"][:, cols], self.w[f"{name}.bias"][cols], x)

    def _bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w = self.w
        inv = torch.rsqrt(w[f"{name}.var"] + self.eps)
        return (x - w[f"{name}.mean"]) * inv * w[f"{name}.scale"] + w[f"{name}.offset"]

    def _ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.scale"], self.w[f"{name}.offset"], self.det.ln_eps)

    def _stack(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """PointsObjClsModule / PredictHead: conv1, bn1, relu, conv2, bn2, relu, conv3."""
        net = F.relu(self._bn(self._dense(x, f"{name}.conv1"), f"{name}.bn1"))
        net = F.relu(self._bn(self._dense(net, f"{name}.conv2"), f"{name}.bn2"))
        return self._dense(net, f"{name}.conv3")

    def _posembed(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """PositionEmbeddingLearned: conv1, bn1, relu, conv2."""
        return self._dense(F.relu(self._bn(self._dense(x, f"{name}.conv1"), f"{name}.bn1")), f"{name}.conv2")

    def _mha(self, name: str, query: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """nn.MultiheadAttention's forward in eval, batch-first (B, L, E), with
        `kv` both key and value (the packed projection at once where it is
        the query too, as torch's does)."""
        e = query.shape[-1]
        h = self.det.nhead
        d = e // h
        proj = f"{name}.in_proj"
        if kv is query:
            qkv = self._dense(query, proj)
            q, k, v = qkv[..., :e], qkv[..., e: 2 * e], qkv[..., 2 * e:]
        else:
            q = self._dense(query, proj, slice(0, e))
            kvp = self._dense(kv, proj, slice(e, 3 * e))
            k, v = kvp[..., :e], kvp[..., e:]
        b, lq, _ = q.shape
        lk = k.shape[1]
        q = q.reshape(b, lq, h, d).transpose(1, 2)
        k = k.reshape(b, lk, h, d).transpose(1, 2)
        v = v.reshape(b, lk, h, d).transpose(1, 2)
        weights = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d), dim=-1)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, lq, e)
        return self._dense(out, f"{name}.out_proj")

    def _layer(self, i: int, query, key, query_pos, key_pos) -> torch.Tensor:
        """TransformerDecoderLayer: query (B, P, C), key (B, S, C), query_pos
        (B, P, 6), key_pos (B, S, 3) -> (B, P, C)."""
        name = f"decoder.{i}"
        qpe = self._posembed(query_pos, f"{name}.self_posembed")
        kpe = self._posembed(key_pos, f"{name}.cross_posembed")
        x = query + qpe  # q = k = v
        query = self._ln(query + self._mha(f"{name}.self_attn", x, x), f"{name}.norm1")
        kv = key + kpe  # with_pos_embed(key, key_pos_embed), the keys and the values alike
        query = self._ln(query + self._mha(f"{name}.multihead_attn", query + qpe, kv), f"{name}.norm2")
        query2 = self._dense(F.relu(self._dense(query, f"{name}.linear1")), f"{name}.linear2")
        return self._ln(query + query2, f"{name}.norm3")

    def _predict(self, features: torch.Tensor, base_xyz: torch.Tensor, name: str, follow=None, tie: float = 0.0):
        """PredictHead: (B, P, C) features, (B, P, 3) base -> the raw (B, P,
        head_dim) channels, the centre, pred_size (B, P, 3), the size class
        (B, P) and the classes that part from `follow`.  With `follow`, the
        program's size classes (B, P), a proposal whose program class scores
        within `tie` of the reference's maximum takes the program's class
        (a tie on numbers held within `tie`); one further off keeps the
        reference's and counts."""
        d = self.det
        nh, ns = d.num_heading_bin, d.num_size_cluster
        head = self._stack(features, name)
        b, p, _ = head.shape
        o = 4 + 2 * nh
        center = base_xyz + head[..., 1:4]
        mean = self.mean_size.unsqueeze(0).unsqueeze(0)
        size_residuals = head[..., o + ns: o + 4 * ns].reshape(b, p, ns, 3) * mean
        scores = head[..., o: o + ns]
        size_cls = torch.argmax(scores, -1)
        parted = 0
        if follow is not None:
            follow = torch.as_tensor(follow, device=head.device).long()
            behind = scores.max(-1).values - torch.gather(scores, 2, follow[..., None])[..., 0]
            parted = int(((behind > tie) & (follow != size_cls)).sum())
            size_cls = torch.where(behind <= tie, follow, size_cls)
        size = torch.gather(size_residuals + mean, 2, size_cls.unsqueeze(-1).unsqueeze(-1).repeat(1, 1, 1, 3)).squeeze(2)
        return head, center, size, size_cls, parted

    @torch.no_grad()
    def forward(self, clouds: torch.Tensor, follow=None, tie: float = 0.0) -> Dict[str, torch.Tensor]:
        """(B, N, 3 + 1) -> the seeds, the KPS queries, the last head's raw
        channels `head` (B, P, head_dim), each head's size class
        `size_cls_layers` (L + 1, B, P), the proposal head's first, and
        `size_cls_parted`: with `follow` (the program's `size_cls_layers`),
        the size classes that part from the program's by more than `tie`
        (`_predict`); within it the reference takes the program's class, so
        that a near-tie the two sides' rounding breaks apart does not send
        the next layers' position embeddings apart."""
        d = self.det
        seed_feat, seed_xyz, _ = self.backbone(clouds)
        logits = self._stack(seed_feat, "points_obj_cls")[..., 0]  # (B, S)
        inds = torch.topk(torch.sigmoid(logits), d.num_proposal)[1]
        xyz = ops.gather_points(seed_xyz, inds)
        feat = ops.gather_points(seed_feat, inds)
        pick = (lambda i: None) if follow is None else (lambda i: follow[i])
        head, center, size, cls, parted = self._predict(feat, xyz, "proposal_head", pick(0), tie)
        classes = [cls]
        query = self._dense(feat, "decoder_query_proj")
        key = self._dense(seed_feat, "decoder_key_proj")
        for i in range(d.num_decoder_layers):
            query = self._layer(i, query, key, torch.cat([center, size], -1), seed_xyz)
            head, center, size, cls, n = self._predict(query, xyz, f"prediction_heads.{i}", pick(i + 1), tie)
            classes.append(cls)
            parted += n
        return {"seed_xyz": seed_xyz, "query_inds": inds, "query_xyz": xyz, "head": head,
                "size_cls_layers": torch.stack(classes), "size_cls_parted": parted}


def decode(head: torch.Tensor, base_xyz: torch.Tensor, det: Detector, mean_size: torch.Tensor,
           size_cls=None) -> Dict:
    """The last head's proposals as `vn.decode` gives VoteNet's: each one's
    objectness probability (the sigmoid of its logit), semantic class and
    probabilities, and its box's corners in depth coordinates; the size
    class by argmax unless `size_cls` (B, P) gives it."""
    nh, ns = det.num_heading_bin, det.num_size_cluster
    b, p, _ = head.shape
    o = 4 + 2 * nh
    center = base_xyz + head[..., 1:4]
    size_scores = head[..., o: o + ns]
    size_res = head[..., o + ns: o + 4 * ns].reshape(b, p, ns, 3) * mean_size
    sem_scores = head[..., o + 4 * ns:]
    if size_cls is None:
        size_cls = torch.argmax(size_scores, -1)
    res = torch.gather(size_res, 2, size_cls.unsqueeze(-1).unsqueeze(-1).repeat(1, 1, 1, 3)).squeeze(2)
    size = mean_size[size_cls] + res
    a, z = center - size / 2, center + size / 2
    return {"lo": torch.minimum(a, z), "hi": torch.maximum(a, z), "obj_prob": torch.sigmoid(head[..., 0]),
            "sem_cls": torch.argmax(sem_scores, -1), "sem_prob": vn.softmax(sem_scores),
            "size_scores": size_scores, "sem_scores": sem_scores}


def parse_predictions(out: Dict[str, torch.Tensor], points: torch.Tensor, det: Detector,
                      mean_size: torch.Tensor) -> Dict[str, np.ndarray]:
    """`vn.parse_predictions` on the last head's proposals: (B, N, 3) points
    -> per proposal (numpy, (B, P, ...)): `lo`, `hi`, `obj_prob`, `sem_cls`,
    `scores`, `count`, `nonempty`, `picked` and `kept`."""
    dec = decode(out["head"], out["query_xyz"], det, mean_size, out["size_cls_layers"][-1])
    count = torch.stack([vn.count_in_boxes(points[i], dec["lo"][i], dec["hi"][i])
                         for i in range(points.shape[0])])
    res = {k: v.cpu().numpy() for k, v in dec.items()}
    res["count"] = count.cpu().numpy()
    res["nonempty"] = res["count"] >= det.min_box_points
    res["picked"] = np.stack([vn.nms_samecls(res["lo"][i], res["hi"][i], res["obj_prob"][i], res["sem_cls"][i],
                                             res["nonempty"][i], det.nms_iou) for i in range(len(res["lo"]))])
    res["kept"] = res["picked"] & (res["obj_prob"] > np.float32(det.conf_thresh))
    res["scores"] = res["sem_prob"] * res["obj_prob"][..., None]
    res["size_cls_parted"] = int(out.get("size_cls_parted", 0))
    return res


def decide(rows: np.ndarray, points: torch.Tensor, det: Detector) -> Dict[str, np.ndarray]:
    """The reference's post-processing on the program's own proposals: the
    (B, P, 12 + num_class) rows' corners, objectness probability and
    per-class scores -> `sem_cls` (the first maximum of the scores),
    `count`, `nonempty`, `picked` and `kept` as `parse_predictions` takes
    them, per proposal (B, P)."""
    lo, hi = rows[..., LO: LO + 3], rows[..., HI: HI + 3]
    obj, cls = rows[..., OBJ_PROB], np.argmax(rows[..., SCORES:], axis=-1)
    count = np.stack([vn.count_in_boxes(points[i], torch.as_tensor(lo[i], device=points.device),
                                        torch.as_tensor(hi[i], device=points.device)).cpu().numpy()
                      for i in range(len(rows))])
    nonempty = count >= det.min_box_points
    picked = np.stack([vn.nms_samecls(lo[i], hi[i], obj[i], cls[i], nonempty[i], det.nms_iou)
                       for i in range(len(rows))])
    return {"sem_cls": cls, "count": count, "nonempty": nonempty, "picked": picked,
            "kept": picked & (obj > np.float32(det.conf_thresh))}


def compare(rows: np.ndarray, head: np.ndarray, ref_head: np.ndarray, res: Dict[str, np.ndarray],
            points: torch.Tensor, det: Detector) -> Dict[str, float]:
    """The program's rows (B, P, 12 + num_class) and last head's raw
    channels (B, P, head_dim) of a batch against the reference's raw
    channels and `res` (`parse_predictions`), every proposal judged:

    - `head_gap`: the widest difference of a raw channel;
    - `box_gap`: the widest difference of a proposal's corners, obj_prob
      or per-class scores;
    - `selection_diff`: proposals whose class, in-box count, non-empty,
      picked or kept entry differs from what the reference's
      post-processing decides on the program's own corners and scores
      (`decide`), each counted once a field, and the heads' size classes
      that part from the program's by more than the tie the reference
      followed them within (`res["size_cls_parted"]`, `GroupFree.forward`)."""
    mine = decide(rows, points, det)
    diff = int(np.sum(rows[..., SEM_CLS].astype(np.int64) != mine["sem_cls"])
               + np.sum(rows[..., POINTS].astype(np.int64) != mine["count"])) + res.get("size_cls_parted", 0)
    for col, key in ((NONEMPTY, "nonempty"), (PICKED, "picked"), (KEPT, "kept")):
        diff += int(np.sum((rows[..., col] > 0) != mine[key]))
    got = np.concatenate([rows[..., LO: HI + 3], rows[..., OBJ_PROB: OBJ_PROB + 1], rows[..., SCORES:]], axis=-1)
    want = np.concatenate([res["lo"], res["hi"], res["obj_prob"][..., None], res["scores"]], axis=-1)
    box_gap = float(np.abs(got.astype(np.float64) - want).max())
    head_gap = float(np.abs(head.astype(np.float64) - ref_head).max())
    return {"head_gap": head_gap, "box_gap": box_gap, "selection_diff": diff}
