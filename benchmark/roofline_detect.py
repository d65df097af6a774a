"""Operations and bytes of VoteNet's work from the configuration's shapes,
held against `roofline.py`'s peaks of one NVIDIA H100 by its `bound_s`.

A model's FLOPs are its dense products, 2 x in x out a row of every layer
at the rows the configuration gives it: the SA MLPs at npoint x nsample
rows, the FP MLPs at their targets, the voting layers at the seeds, the
vote aggregation's MLP at num_proposal x vote_nsample rows and the
proposal layers at the proposals.
"""

from __future__ import annotations

from benchmark.roofline import FPS_TEST_FLOPS, _mlp, bound_s


def forward_flops(cfg, det, batch: int) -> int:
    """Dense products of one VoteNet forward of `batch` scans; `cfg` has the
    backbone fields, `det` the detector's (`reference/vn.py::Detector`)."""
    f = 0
    for sa in (cfg.sa1, cfg.sa2, cfg.sa3, cfg.sa4):
        f += _mlp(sa.mlp, batch * sa.npoint * sa.nsample)
    f += _mlp(cfg.fp1_mlp, batch * cfg.sa3.npoint)
    f += _mlp(cfg.fp2_mlp, batch * cfg.sa2.npoint)
    c = cfg.fp2_mlp[-1]
    f += _mlp((c, c, c, (3 + c) * det.vote_factor), batch * cfg.sa2.npoint)
    p, h = det.num_proposal, det.vote_mlp[-1]
    f += _mlp((3 + c, *det.vote_mlp), batch * p * det.vote_nsample)
    head = 2 + 3 + 2 * det.num_heading_bin + 4 * det.num_size_cluster + det.num_class
    f += _mlp((h, h, h, head), batch * p)
    return f


def fps_bound_s(cfg, det, batch: int) -> float:
    """K1 in a request: the cascade num_point -> SA1 -> SA2 -> SA3 -> SA4 and
    the proposals' FPS of the SA2 seeds, of `batch` scans; the points read
    once and the indices written once."""
    npoints = (cfg.sa1.npoint, cfg.sa2.npoint, cfg.sa3.npoint, cfg.sa4.npoint)
    flops, n = 0, cfg.num_point
    for p in npoints:
        flops += batch * (p - 1) * n * FPS_TEST_FLOPS
        n = p
    seeds = cfg.sa2.npoint
    flops += batch * (det.num_proposal - 1) * seeds * FPS_TEST_FLOPS
    nbytes = batch * (cfg.num_point + seeds) * 3 * 4 + batch * (sum(npoints) + det.num_proposal) * 8
    return bound_s(nbytes, flops)
