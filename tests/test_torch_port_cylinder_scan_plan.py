"""The schedule of the cylinder scan (csrc/query.cu, cylinder_scan_kernel:
K8's indices, K6's offsets and K5's first launch), emulated in numpy on
the CPU.

The scan runs on K4's ring (tests/test_torch_port_ball_scan_plan.py): a
block takes BLOCK consecutive centres of one scene, one per warp; thread 0
loads the scene tile by tile (TILE points a stage, STAGES stages) with a
bulk copy for each tile's 16-byte-aligned middle and 4-byte copies for its
ragged head and tail; each warp tests a loaded tile UNROLL chunks of 32
points a step.  Per step the warp rotates each lane's offsets into the
gripper frame, x_r = dx*R0 + dy*R3 + dz*R6 (float32, every product and sum
rounded, in the JAX order), and takes one vote on y_r^2 + z_r^2 < r^2 and
hmin < x_r < top (the largest hmax) over the step's chunks; where some
lane is inside, each depth that has fewer than ns hits takes a ballot per
chunk on x_r < hmax_d, and the ballots give the hits their slots chunk by
chunk (the hits of lower lanes before them).  A hit writes its index (K8)
or its (x_r, y_r, z_r) (K6, K5).  A warp is done after the step in which every depth reaches
ns hits, and the block stops once all its warps are.  An empty slot takes
its depth's first hit, read back from the depth's slot 0; a depth with no
hits takes point 0.

The emulation is held index for index against `cylinder_query_multi_plain`
and the JAX package's `cylinder_query_multi_pallas` in interpret mode, and
its offsets bitwise against `crop_group_plain` and within 1e-6 x max(1,
scale) of `crop_group_pallas` in interpret mode (XLA on the CPU contracts
offset @ R into FMAs: a rounding or two, which
tests/test_pallas_crop.py bounds at 1e-6 for offsets of the crop's size;
the seeds 10 m away have offsets of ~15).  Cases: N not a multiple of the tile, M not a
multiple of the block, depths with no hits and overfull ones, an unsorted
hmax list, points exactly on the radius, on hmax_d and on hmin (coordinates
whose squares are exact and signed-permutation rotations, so the FMAs change
nothing), seeds 10 m away, and a tabletop cloud at the production geometry
(r 0.05, hmin -0.02, hmax 0.01-0.04, ns 64).  It also checks what a block
scans and loads against its centres' nth-hit positions (the slowest depth
of each).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspnet_tpu.ops.pallas.crop import crop_group_pallas
from graspnet_tpu.ops.pallas.query import cylinder_query_multi_pallas

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.ops.cuda.crop import crop_group_plain
from graspnet_tpu_torch.ops.cuda.query import (
    BALL_SCAN_STAGES,
    BALL_SCAN_TILE,
    CYLINDER_SCAN_CENTERS,
    CYLINDER_SCAN_UNROLL,
    cylinder_query_multi_plain,
)
from graspnet_tpu_torch.utils.scan_stats import cylinder_nth_hits, scan_blocks
from graspnet_tpu_torch.utils.synthetic import tabletop_cloud

from tests.test_torch_port_ball_scan_plan import load_tile
from tests.test_torch_port_ops import random_rotations

OFFSET_TOL = 1e-6  # x max(1, scale), against interpret-mode Pallas only: XLA's FMAs in offset @ R


def rotate(p, c, r):
    """(..., 3) points, centres and row-major (..., 3, 3) rotations that
    broadcast against them -> x_r, y_r, z_r as the kernel rounds them:
    (dx*R[0, j] + dy*R[1, j]) + dz*R[2, j]."""
    d = (p - c).astype(np.float32)
    return [(d[..., 0] * r[..., 0, j] + d[..., 1] * r[..., 1, j]) + d[..., 2] * r[..., 2, j] for j in range(3)]


def scan_plan(xyz, centers, rot, radius, hmin, hmax_list, ns, block=CYLINDER_SCAN_CENTERS,
              tile=BALL_SCAN_TILE, stages=BALL_SCAN_STAGES, offset=0, unroll=CYLINDER_SCAN_UNROLL):
    """(B, N, 3), (B, M, 3), (B, M, 3, 3) float32 -> ((B, M, D, ns) int64
    indices, (B, M, D, ns, 3) float32 offsets, per block the points its
    warps scanned at most and the points it loaded)."""
    b_all, n, _ = xyz.shape
    m, nd = centers.shape[1], len(hmax_list)
    r2, lo = np.float32(radius * radius), np.float32(hmin)
    hmax = np.asarray(hmax_list, np.float32)
    tiles = -(-n // tile)
    idx = np.full((b_all, m, nd, ns), -1, np.int64)
    off = np.full((b_all, m, nd, ns, 3), np.nan, np.float32)
    scanned, loaded = [], []
    for b in range(b_all):
        src = xyz[b].reshape(-1)
        for q0 in range(0, m, block):
            warps = [q for q in range(q0, q0 + block) if q < m]  # a missing centre is done from the start
            count = {q: np.zeros(nd, np.int64) for q in warps}
            done = {q: False for q in warps}
            reach = {q: 0 for q in warps}
            last = tiles
            for t in range(tiles):
                stage, shift = load_tile(src, offset, n, t, tile)
                pts = stage[shift: shift + 3 * min(tile, n - t * tile)].reshape(-1, 3)
                for q in warps:
                    for base in range(0, len(pts), 32 * unroll):
                        if done[q]:
                            break
                        reach[q] = t * tile + min(base + 32 * unroll, len(pts))
                        p = base + np.arange(32 * unroll).reshape(unroll, 32)  # (chunk, lane)
                        xr, yr, zr = rotate(pts[np.minimum(p, len(pts) - 1)], centers[b, q], rot[b, q])
                        inside = (p < len(pts)) & (yr * yr + zr * zr < r2) & (xr > lo) & (xr < hmax.max())
                        if not inside.any():  # the vote
                            continue
                        for d in range(nd):
                            if count[q][d] >= ns:  # a full depth takes no ballots
                                continue
                            for u in range(unroll):  # the chunk's ballot, its slots after the chunks before
                                lanes = np.nonzero(inside[u] & (xr[u] < hmax[d]))[0]
                                pos = count[q][d] + np.arange(len(lanes))  # popc of the lower lanes
                                keep = pos < ns
                                idx[b, q, d, pos[keep]] = t * tile + p[u, lanes[keep]]
                                off[b, q, d, pos[keep]] = np.stack([xr[u], yr[u], zr[u]], -1)[lanes[keep]]
                                count[q][d] += len(lanes)
                        done[q] = (count[q] >= ns).all()
                if all(done.values()):  # __syncthreads_count: the block stops
                    last = t + 1
                    break
            for q in warps:
                for d in range(nd):
                    c = count[q][d]
                    if 0 < c < ns:  # pad from slot 0, the first hit
                        idx[b, q, d, c:] = idx[b, q, d, 0]
                        off[b, q, d, c:] = off[b, q, d, 0]
                    elif c == 0:  # point 0
                        idx[b, q, d] = 0
                        off[b, q, d] = np.stack(rotate(xyz[b, 0], centers[b, q], rot[b, q]))
            scanned.append(max(reach.values()))
            loaded.append(min(n, tile * min(tiles, last - 1 + stages) if last < tiles else n))
    return idx, off, np.array(scanned), np.array(loaded)


def nth_hit_tests(xyz, centers, rot, radius, hmin, hmax_list, ns):
    """(B, M): points a first-ns cylinder scan tests, through the ns-th hit
    of its slowest depth, or N."""
    out = np.zeros(centers.shape[:2], np.int64)
    n = xyz.shape[1]
    for b in range(centers.shape[0]):
        for q in range(centers.shape[1]):
            xr, yr, zr = rotate(xyz[b], centers[b, q], rot[b, q])
            base = (yr * yr + zr * zr < np.float32(radius * radius)) & (xr > np.float32(hmin))
            worst = 0
            for h in hmax_list:
                rank = np.cumsum(base & (xr < np.float32(h)))
                worst = max(worst, int(np.argmax(rank >= ns)) + 1 if rank[-1] >= ns else n)
            out[b, q] = worst
    return out


def signed_permutations(rng, shape):
    """Rotations whose entries are 0 and +-1: offset @ R is exact."""
    out = np.zeros((*shape, 3, 3), np.float32)
    for i in np.ndindex(*shape):
        out[i][np.arange(3), rng.permutation(3)] = rng.choice([-1.0, 1.0], 3)
    return out


def cases():
    rng = np.random.default_rng(0)
    uni = rng.uniform(-0.3, 0.3, (2, 1000, 3)).astype(np.float32)
    near = uni[:, 3:40] + rng.normal(0, 0.01, (2, 37, 3)).astype(np.float32)
    ragged = (uni, near, random_rotations(rng, (2, 37)), 0.1, -0.05, (0.02, 0.05, 0.1), 16)
    dense = rng.uniform(-0.3, 0.3, (1, 700, 3)).astype(np.float32)
    dense[:, 100:400] = rng.uniform(-0.01, 0.01, (1, 300, 3))
    mixed = np.concatenate([np.full((1, 5, 3), 10.0, np.float32),  # seeds 10 m away: no hits
                            np.zeros((1, 6, 3), np.float32),  # 300+ hits for 8 slots in every depth
                            dense[:, 500:510]], 1)
    empty_and_overfull = (dense, mixed, random_rotations(rng, (1, 21)), 0.1, -0.1, (0.02, 0.1), 8)
    unsorted = (uni, near, random_rotations(rng, (2, 37)), 0.1, -0.05, (0.1, 0.02, 0.05), 16)
    lat = (rng.integers(-4, 5, (2, 900, 3)) / 8.0).astype(np.float32)
    # y_r^2 + z_r^2 == r^2 at offsets like (0, 2, 0) / 8, x_r == hmax_0 at
    # (1, 0, 0) / 8, x_r == hmin at (-2, 0, 0) / 8
    on_boundary = (lat, lat[:, 50:83], signed_permutations(rng, (2, 33)), 0.25, -0.25, (0.125, 0.25, 0.5), 32)
    table = tabletop_cloud(rng, 3000)[None]
    pick = table[:, rng.choice(3000, 20, replace=False)]
    seeds = np.concatenate([pick + rng.normal(0, 0.002, pick.shape), np.full((1, 2, 3), 10.0)], 1)
    tabletop = (table, seeds.astype(np.float32), random_rotations(rng, (1, 22)), 0.05, -0.02,
                (0.01, 0.02, 0.03, 0.04), 64)
    return {"ragged": ragged, "empty_and_overfull": empty_and_overfull, "unsorted_hmax": unsorted,
            "on_boundary": on_boundary, "tabletop": tabletop}


CASES = cases()
SMALL = {"block": 6, "tile": 64, "stages": 2, "offset": 3, "unroll": 1}
PLANS = {}


def plan(name, schedule):
    if (name, schedule) not in PLANS:
        PLANS[name, schedule] = scan_plan(*CASES[name], **({} if schedule == "kernel" else SMALL))
    return PLANS[name, schedule]


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("schedule", ["kernel", "small"])
def test_plan_matches_plain(name, schedule):
    xyz, centers, rot, radius, hmin, hmax, ns = CASES[name]
    idx, off, _, _ = plan(name, schedule)
    args = (t(xyz), t(centers), t(rot), radius, hmin, hmax, ns)
    np.testing.assert_array_equal(idx, cylinder_query_multi_plain(*args).numpy())
    want = crop_group_plain(*args).numpy()
    assert np.array_equal(off.view(np.int32), want.view(np.int32))  # bitwise
    if name == "empty_and_overfull":
        assert (idx[0, :5] == 0).all()  # no hits: index 0 everywhere
        far = np.stack(rotate(xyz[0, 0], centers[0, 0], rot[0, 0]))
        assert (off[0, 0] == far).all()  # and point 0's offset
        assert (np.diff(idx[0, 5:11], axis=-1) > 0).all()  # overfull: ns distinct hits in index order
    if name == "on_boundary":  # points exactly on each boundary are out, strictly inside in
        xr, yr, zr = rotate(xyz[:, None], centers[:, :, None], rot[:, :, None])
        assert (yr * yr + zr * zr == np.float32(radius * radius)).any()
        assert (xr == np.float32(hmax[0])).any() and (xr == np.float32(hmin)).any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_matches_pallas_interpret(name):
    xyz, centers, rot, radius, hmin, hmax, ns = CASES[name]
    idx, off, _, _ = plan(name, "kernel")
    m = 8  # a slice of the centres keeps interpret mode quick
    jargs = (jnp.asarray(xyz), jnp.asarray(centers[:, :m]), jnp.asarray(rot[:, :m]), radius, hmin, tuple(hmax), ns)
    np.testing.assert_array_equal(idx[:, :m], np.asarray(cylinder_query_multi_pallas(*jargs)))
    want = np.asarray(crop_group_pallas(*jargs))
    np.testing.assert_allclose(off[:, :m], want, rtol=0, atol=OFFSET_TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_plan_at_every_scene_alignment(offset):
    """The loader's bulk middle and 4-byte head and tail at each start of a
    scene modulo 16 bytes give the same selection (3 stages of 64 points)."""
    xyz, centers, rot, radius, hmin, hmax, ns = CASES["ragged"]
    got = scan_plan(xyz, centers, rot, radius, hmin, hmax, ns, tile=64, stages=3, offset=offset)
    np.testing.assert_array_equal(got[0], plan("ragged", "kernel")[0])
    assert np.array_equal(got[1].view(np.int32), plan("ragged", "kernel")[1].view(np.int32))


@pytest.mark.parametrize("ns", [64, 16])
@pytest.mark.parametrize("tile,stages", [(BALL_SCAN_TILE, BALL_SCAN_STAGES), (256, 2)])
def test_block_stops_at_its_slowest_centre(ns, tile, stages):
    """A block scans as far as its slowest centre's slowest depth needs (to
    the end of the warp's step of UNROLL chunks, or of the tile) and loads
    STAGES - 1 tiles past the tile it stops in; a block whose centres never
    fill every depth loads and scans all N.  On the 3000-point tabletop at
    the production geometry, at ns 16 and at ns 64, some blocks of centres
    fill every depth before the end and some do not (a centre short of ns
    hits in depth 0, or the far seeds)."""
    xyz, centers, rot, radius, hmin, hmax, _ = CASES["tabletop"]
    n = xyz.shape[1]
    _, _, scanned, loaded = scan_plan(xyz, centers, rot, radius, hmin, hmax, ns, tile=tile, stages=stages)
    nth = nth_hit_tests(xyz, centers, rot, radius, hmin, hmax, ns)[0]
    slowest = np.array([nth[q0: q0 + CYLINDER_SCAN_CENTERS].max() for q0 in range(0, len(nth), CYLINDER_SCAN_CENTERS)])
    full = slowest < n
    assert full.any() and not full.all()
    assert (scanned >= slowest).all() and (scanned - slowest < 32 * CYLINDER_SCAN_UNROLL).all()
    stop_tile = -(-slowest // tile)
    want = np.where(full, np.minimum(n, tile * np.minimum(stop_tile - 1 + stages, -(-n // tile))), n)
    np.testing.assert_array_equal(loaded, want)
    if (tile, stages) == (BALL_SCAN_TILE, BALL_SCAN_STAGES):  # the card's own count of the same (scan_stats)
        cfg = dataclasses.replace(GraspNetConfig(), cylinder_radius=radius, hmin=hmin, hmax_list=hmax,
                                  crop_nsample=ns)
        stats = scan_blocks(cylinder_nth_hits(cfg, t(xyz), t(centers), t(rot)), n, CYLINDER_SCAN_CENTERS)
        assert stats["mean_nth_hit_tests"] == nth.mean()
        assert stats["mean_block_scanned_points"] == slowest.mean()
        assert stats["mean_block_loaded_points"] == loaded.mean()
