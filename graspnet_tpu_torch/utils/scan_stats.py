"""What the first-ns scans test, counted from the plain masks: per centre
the points a scan tests up to its ns-th hit, and what the ring scans' blocks
(csrc/query.cu: K4's ball scan, the cylinder scan) scan and load.  For the
card's checks and timings (chip_smoke.py); the
schedule is emulated in tests/test_torch_port_{ball,cylinder}_scan_plan.py.
"""

from __future__ import annotations

import torch

from graspnet_tpu_torch.ops.cuda.query import BALL_SCAN_STAGES, BALL_SCAN_TILE
from graspnet_tpu_torch.ops.query import ball_mask, cylinder_masks


def nth_hit_tests(mask: torch.Tensor, ns: int) -> torch.Tensor:
    """Points a first-ns scan tests: up to and including the ns-th hit, or
    all N when there are fewer hits.  mask (..., N) -> (...) int64."""
    n = mask.shape[-1]
    rank = torch.cumsum(mask, dim=-1, dtype=torch.int32)
    target = torch.full((*rank.shape[:-1], 1), ns, dtype=torch.int32, device=mask.device)
    pos = torch.searchsorted(rank.contiguous(), target)[..., 0]
    return torch.clamp(pos + 1, max=n)


def ball_nth_hits(xyz: torch.Tensor, centers: torch.Tensor, radius: float, ns: int) -> torch.Tensor:
    """(B, M): the points K4's first-ns scan tests for each centre, 256
    centres at a time."""
    return torch.cat([nth_hit_tests(ball_mask(xyz, centers[:, m0:m0 + 256], radius), ns)
                      for m0 in range(0, centers.shape[1], 256)], dim=1)


def cylinder_nth_hits(cfg, xyz: torch.Tensor, centers: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """(B, M): the points the cylinder scan tests for each centre at cfg's
    crop geometry: it stops once every depth has crop_nsample hits."""
    return torch.cat([nth_hit_tests(cylinder_masks(xyz, centers[:, m0:m0 + 64], rot[:, m0:m0 + 64],
                                                   cfg.cylinder_radius, cfg.hmin, cfg.hmax_list),
                                    cfg.crop_nsample).amax(dim=2)
                      for m0 in range(0, centers.shape[1], 64)], dim=1)


def scan_blocks(nth: torch.Tensor, n: int, centers_per_block: int) -> dict:
    """What a ring scan's blocks scan and load, from the centres' nth-hit
    tests (B, M): a block of `centers_per_block` consecutive centres scans
    as far as its slowest centre needs and loads STAGES - 1 tiles past the
    tile it stops in."""
    tile, stages = BALL_SCAN_TILE, BALL_SCAN_STAGES
    slowest = torch.stack([blk.amax(dim=1) for blk in nth.split(centers_per_block, dim=1)], 1).double()
    tiles = -(-n // tile)
    loaded = torch.clamp(tile * torch.clamp(torch.ceil(slowest / tile) - 1 + stages, max=tiles), max=n)
    mean_nth = nth.double().mean().item()
    return dict(mean_nth_hit_tests=mean_nth, mean_block_scanned_points=slowest.mean().item(),
                block_scanned_over_nth_hit_tests=slowest.mean().item() / mean_nth,
                mean_block_loaded_points=loaded.mean().item())
