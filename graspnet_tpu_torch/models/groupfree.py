"""Group-Free-3D (Liu, Zhang, Cao, Hu, Tong, "Group-Free 3D Object
Detection via Transformers", ICCV 2021) in eval mode, and the decode of its
prediction heads.

The published code is zeliu98/Group-Free-3D: `models/detector.py`
(`GroupFreeDetector`), `transformer.py` (`TransformerDecoderLayer`) and
`modules.py` (`PointsObjClsModule`, `PredictHead`,
`PositionEmbeddingLearned`).  Here it runs channels-last on the port's
modules, with `sampling kps`, `self_position_embedding loc_learned` and
`cross_position_embedding xyz_learned`:

  * the backbone is `models/backbone.py` at the configuration's widths (the
    featured SA route, FP1-2); its 1,024 seeds carry `d_model` channels;
  * KPS: the seeds' objectness logit (two 1x1 convolutions with BN and
    ReLU, then one to 1 channel); the queries are the `num_proposal` seeds
    of the highest sigmoid (`torch.topk`), their xyz `c0` and features;
  * a `PredictHead` (two convolutions with BN and ReLU, then one to the
    `head_dim` channels) gives the proposal boxes, centre `c0` + residual;
  * the queries and the seed features go through a 1x1 projection each,
    then `num_decoder_layers` post-norm transformer decoder layers: self-
    attention with the learned embedding of the previous head's box
    (centre and size, 6 inputs) added to queries, keys and values;
    cross-attention to the seeds with the learned embedding of their xyz
    added to keys and values; a ReLU feed-forward; a LayerNorm after each.
    The attention is torch's `nn.MultiheadAttention` math: the packed
    in-projection with biases, `nhead` heads, the out-projection; the
    attention itself is `ops/cuda/attn.py::attention` (the fused kernel on
    the card).  After every layer a head of its own predicts boxes from
    the base `c0`; its box feeds the next layer's embedding.  The decode
    and the boxes are the last head's.

Module names follow the published ones (`points_obj_cls`, `proposal_head`,
`decoder.3.self_attn`, `prediction_heads.11`, ...) with the port's leaves
(`kernel` shaped (in, out), `bias`, BN `scale`, `offset`, `mean`, `var`,
LayerNorm `scale`, `offset`); a head's seven output convolutions are one
(in, head_dim) kernel, in the published channel order.  Spans:
`detect.kps` (counts `seeds`, `queries`) and `detect.decoder` (the
projections, the layers and their heads; counts `layers`, `queries`,
`keys`).  The post-processing is `postproc/boxes.py`.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from graspnet_tpu_torch import ops
from graspnet_tpu_torch.config import GroupFreeConfig
from graspnet_tpu_torch.models.backbone import Backbone
from graspnet_tpu_torch.nn.layers import BatchNorm, Dense, dense
from graspnet_tpu_torch.ops.cuda.attn import attention
from graspnet_tpu_torch.utils.tracing import span


class ConvBNStack(nn.Module):
    """modules.py's heads: conv1 -> bn1 -> relu -> conv2 -> bn2 -> relu ->
    conv3, 1x1 convolutions with biases on the trailing axis."""

    def __init__(self, c: int, out: int, eps: float):
        super().__init__()
        self.conv1 = Dense(c, c)
        self.bn1 = BatchNorm(c, eps)
        self.conv2 = Dense(c, c)
        self.bn2 = BatchNorm(c, eps)
        self.conv3 = Dense(c, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = torch.relu(self.bn1(self.conv1(x)))
        net = torch.relu(self.bn2(self.conv2(net)))
        return self.conv3(net)


class PositionEmbedding(nn.Module):
    """PositionEmbeddingLearned: conv(in -> c) -> BN -> ReLU -> conv(c -> c)."""

    def __init__(self, in_dim: int, c: int, eps: float):
        super().__init__()
        self.conv1 = Dense(in_dim, c)
        self.bn1 = BatchNorm(c, eps)
        self.conv2 = Dense(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.bn1(self.conv1(x))))


class LayerNorm(nn.Module):
    """nn.LayerNorm over the trailing axis, with the port's leaf names."""

    def __init__(self, c: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.offset = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.offset, self.eps)


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's forward in eval, channels-last: `in_proj`
    (c, 3c) packs the query, key and value projections in that order."""

    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj = Dense(c, 3 * c)
        self.out_proj = Dense(c, c)

    def forward(self, query: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """Attention of `query` (B, Lq, c) over `kv` (B, Lk, c), which is both
        key and value; self-attention when `kv` is `query` (one packed
        projection)."""
        c = query.shape[-1]
        w, b = self.in_proj.kernel, self.in_proj.bias
        if kv is query:
            qkv = self.in_proj(query)
            q, k, v = qkv[..., :c], qkv[..., c: 2 * c], qkv[..., 2 * c:]
        else:
            q = dense(w[:, :c], b[:c], query)
            kvp = dense(w[:, c:], b[c:], kv)
            k, v = kvp[..., :c], kvp[..., c:]
        return self.out_proj(attention(q, k, v, self.heads))


class DecoderLayer(nn.Module):
    """transformer.py::TransformerDecoderLayer in eval (dropout off), with
    its own position embeddings."""

    def __init__(self, cfg: GroupFreeConfig):
        super().__init__()
        c, eps = cfg.d_model, cfg.bn_eps
        self.self_posembed = PositionEmbedding(6, c, eps)
        self.cross_posembed = PositionEmbedding(3, c, eps)
        self.self_attn = MultiheadAttention(c, cfg.nhead)
        self.multihead_attn = MultiheadAttention(c, cfg.nhead)
        self.linear1 = Dense(c, cfg.dim_feedforward)
        self.linear2 = Dense(cfg.dim_feedforward, c)
        self.norm1 = LayerNorm(c, cfg.ln_eps)
        self.norm2 = LayerNorm(c, cfg.ln_eps)
        self.norm3 = LayerNorm(c, cfg.ln_eps)

    def forward(self, query, key, query_pos, key_pos):
        """query (B, P, c), key (B, S, c), query_pos (B, P, 6) the previous
        head's centre and size, key_pos (B, S, 3) the seeds' xyz."""
        qpe = self.self_posembed(query_pos)
        kpe = self.cross_posembed(key_pos)
        x = query + qpe
        query = self.norm1(query + self.self_attn(x, x))
        query = self.norm2(query + self.multihead_attn(query + qpe, key + kpe))
        return self.norm3(query + self.linear2(torch.relu(self.linear1(query))))


class GroupFree3D(nn.Module):
    def __init__(self, cfg: GroupFreeConfig):
        super().__init__()
        self.cfg = cfg
        c, eps = cfg.d_model, cfg.bn_eps
        self.backbone = Backbone(cfg)
        self.points_obj_cls = ConvBNStack(c, 1, eps)
        self.proposal_head = ConvBNStack(c, cfg.head_dim, eps)
        self.decoder_query_proj = Dense(c, c)
        self.decoder_key_proj = Dense(c, c)
        self.decoder = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.num_decoder_layers))
        self.prediction_heads = nn.ModuleList(ConvBNStack(c, cfg.head_dim, eps)
                                              for _ in range(cfg.num_decoder_layers))
        # on the model's device: a tensor made from the host list at each
        # forward would be a pageable copy, which waits for the queued work
        self.register_buffer("mean_size", torch.tensor(cfg.mean_size, dtype=torch.float32), persistent=False)

    def forward(self, point_clouds: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, N, 3 + input_feature_dim) -> end_points: the seeds, the KPS
        queries, the last head's raw channels `head` (B, num_proposal,
        head_dim) and its decode (`decode_head`'s entries), and
        `size_cls_layers` (num_decoder_layers + 1, B, num_proposal): the
        size class each head chose, the proposal head's first, whose box
        the next layer embeds."""
        cfg = self.cfg
        seed_feat, seed_xyz, ep = self.backbone(point_clouds)
        s, p = seed_feat.shape[1], cfg.num_proposal
        with span("detect.kps", seeds=s, queries=p):
            logits = self.points_obj_cls(seed_feat)[..., 0]
            inds = torch.topk(torch.sigmoid(logits), p, dim=1).indices
            base_xyz = ops.gather_points(seed_xyz, inds)
            feat = ops.gather_points(seed_feat, inds)
        dec = decode_head(self.proposal_head(feat), base_xyz, cfg, self.mean_size)
        classes = [dec["size_cls"]]
        with span("detect.decoder", layers=len(self.decoder), queries=p, keys=s):
            query = self.decoder_query_proj(feat)
            key = self.decoder_key_proj(seed_feat)
            for layer, predict in zip(self.decoder, self.prediction_heads):
                query = layer(query, key, torch.cat([dec["center"], dec["size"]], dim=-1), seed_xyz)
                dec = decode_head(predict(query), base_xyz, cfg, self.mean_size)
                classes.append(dec["size_cls"])
        return {"seed_xyz": seed_xyz, "seed_inds": ep["fp2_inds"], "query_inds": inds, "query_xyz": base_xyz,
                "size_cls_layers": torch.stack(classes), **dec}


def decode_head(head: torch.Tensor, base_xyz: torch.Tensor, cfg: GroupFreeConfig,
                mean_size: torch.Tensor) -> Dict[str, torch.Tensor]:
    """PredictHead's outputs from its raw (B, P, head_dim) channels and the
    base xyz: the channels by name (`size_residuals` are the normalised
    residuals times each cluster's mean size), `center` = base + residual,
    `size_cls`, the argmax size class (its first maximum), and `size`, that
    class's mean size plus its residual."""
    nh, ns = cfg.num_heading_bin, cfg.num_size_cluster
    b, p, _ = head.shape
    o = 4 + 2 * nh
    size_scores = head[..., o: o + ns]
    size_residuals = head[..., o + ns: o + 4 * ns].reshape(b, p, ns, 3) * mean_size
    size_cls = torch.argmax(size_scores, dim=-1)
    size = torch.gather(size_residuals + mean_size, 2, size_cls[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
    return {
        "head": head,
        "objectness_scores": head[..., 0:1],
        "center": base_xyz + head[..., 1:4],
        "heading_scores": head[..., 4: 4 + nh],
        "heading_residuals": head[..., 4 + nh: o] * (math.pi / nh),
        "size_scores": size_scores,
        "size_residuals": size_residuals,
        "size_cls": size_cls,
        "size": size,
        "sem_cls_scores": head[..., o + 4 * ns:],
    }
