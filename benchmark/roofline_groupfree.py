"""Operations and bytes of Group-Free-3D's work from the configuration's
shapes, held against `roofline.py`'s peaks of one NVIDIA H100 by its
`bound_s`.

A model's FLOPs are its dense products, 2 x in x out a row of every layer
at the rows the configuration gives it, and the attention's two products,
2 x Lq x Lk x d_model each a call: the backbone's SA MLPs at npoint x
nsample rows and FP MLPs at their targets, KPS at the seeds, the heads and
the queries' layers at the queries, the keys' layers at the seeds.
"""

from __future__ import annotations

from benchmark.roofline import _mlp, bound_s


def backbone_flops(cfg, batch: int) -> int:
    f = 0
    for sa in (cfg.sa1, cfg.sa2, cfg.sa3, cfg.sa4):
        f += _mlp(sa.mlp, batch * sa.npoint * sa.nsample)
    f += _mlp(cfg.fp1_mlp, batch * cfg.sa3.npoint)
    f += _mlp(cfg.fp2_mlp, batch * cfg.sa2.npoint)
    return f


def attention_flops(cfg, det, batch: int) -> int:
    """The attention's scores and weighted sums over every decoder layer:
    self-attention over the queries, cross-attention over the seeds."""
    c, p, s = cfg.fp2_mlp[-1], det.num_proposal, cfg.sa2.npoint
    return det.num_decoder_layers * batch * 4 * p * (p + s) * c


def attention_bound_s(cfg, det, batch: int) -> float:
    """The attention kernel's launches in a request (two a layer): its
    operations at the float32 CUDA-core peak, or q, k, v read once and the
    output written once."""
    c, p, s = cfg.fp2_mlp[-1], det.num_proposal, cfg.sa2.npoint
    nbytes = det.num_decoder_layers * batch * ((p + p + p + p) + (p + s + s + p)) * c * 4
    return bound_s(nbytes, attention_flops(cfg, det, batch))


def decoder_flops(cfg, det, batch: int) -> int:
    """KPS, the proposal head, the two projections and every decoder layer
    with its head, at `batch` scans."""
    c, p, s = cfg.fp2_mlp[-1], det.num_proposal, cfg.sa2.npoint
    head = 1 + 3 + 2 * det.num_heading_bin + 4 * det.num_size_cluster + det.num_class
    f = _mlp((c, c, c, 1), batch * s) + _mlp((c, c, c, head), batch * p)
    f += _mlp((c, c), batch * p) + _mlp((c, c), batch * s)
    layer = _mlp((6, c, c), batch * p) + _mlp((3, c, c), batch * s)  # the position embeddings
    layer += _mlp((c, 3 * c), batch * p) + _mlp((c, c), batch * p)  # self-attention's projections
    layer += _mlp((c, c), batch * p) + _mlp((c, 2 * c), batch * s) + _mlp((c, c), batch * p)  # cross-attention's
    layer += _mlp((c, det.dim_feedforward, c), batch * p) + _mlp((c, c, c, head), batch * p)
    return f + det.num_decoder_layers * layer + attention_flops(cfg, det, batch)


def forward_flops(cfg, det, batch: int) -> int:
    """Dense products of one Group-Free-3D forward of `batch` scans; `cfg`
    has the backbone fields, `det` the detector's (`reference/gf.py::Detector`)."""
    return backbone_flops(cfg, batch) + decoder_flops(cfg, det, batch)
