"""The schedule of K4's ball scan (csrc/query.cu, ball_scan_kernel),
emulated in numpy on the CPU.

A block takes BLOCK consecutive centres of one scene, one per warp; thread
0 loads the scene tile by tile (TILE points a stage, STAGES stages in the
ring) with a bulk copy for each tile's 16-byte-aligned middle and 4-byte
copies for its ragged head and tail; each warp scans a loaded tile UNROLL
chunks of 32 points a step, where per chunk a ballot over the 32 lanes
gives each hit its slot (the hits of lower lanes before it) and the first
hit is kept for the padding; a warp stops after the step that gives its
centre ns hits (the chunks it tests past the ns-th hit write nothing), and
the block stops loading and scanning once all its warps have.  The emulation
repeats that arithmetic (float32, every product and sum rounded, in the
JAX order) and is held, index for index, against `ball_query_plain` and the
JAX package's `ball_query_pallas` in interpret mode: N not a multiple of
the tile, M not a multiple of the block, centres with no hits and
overfull ones, points exactly on the radius (coordinates whose squares are
exact, since XLA on the CPU contracts into FMAs), and a small SA1-like case
(r 0.04, ns 64) on a tabletop cloud.  It also checks the loader's
alignment arithmetic for every start of a scene modulo 16 bytes, and what
a block loads and scans against the centres' nth-hit positions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspnet_tpu.ops.pallas.query import ball_query_pallas

from graspnet_tpu_torch.ops.cuda.query import (
    BALL_SCAN_CENTERS,
    BALL_SCAN_STAGES,
    BALL_SCAN_TILE,
    BALL_SCAN_UNROLL,
    ball_query_plain,
)
from graspnet_tpu_torch.utils.synthetic import tabletop_cloud


def load_tile(src: np.ndarray, offset: int, n: int, t: int, tile: int):
    """One stage as load_tile fills it: src is the scene's floats, `offset`
    its first float's index modulo 4 (16-byte units).  Returns the stage
    buffer and the float the tile starts at in it; asserts what the bulk
    copy needs (16-byte-aligned source, destination and size)."""
    head = (4 - offset % 4) & 3
    shift = (4 - head) & 3
    floats = 3 * min(tile, n - t * tile)
    start = 3 * tile * t
    h = min(head, floats)
    mid = (floats - h) & ~3
    stage = np.full(3 * tile + 4, np.nan, np.float32)
    copies = [j for j in range(floats) if not h <= j < h + mid]  # 4-byte cp.async
    for j in copies:
        stage[shift + j] = src[start + j]
    if mid:
        assert (offset + start + h) % 4 == 0 and (shift + h) % 4 == 0 and mid % 4 == 0
        stage[shift + h: shift + h + mid] = src[start + h: start + h + mid]
    assert len(copies) < 8 and shift + floats <= stage.size
    return stage, shift


def scan_plan(xyz, centers, radius, ns, block=BALL_SCAN_CENTERS, tile=BALL_SCAN_TILE,
              stages=BALL_SCAN_STAGES, offset=0, unroll=BALL_SCAN_UNROLL):
    """(B, N, 3), (B, M, 3) float32 -> ((B, M, ns) int64 indices, per block
    the points its warps scanned at most and the points it loaded)."""
    b_all, n, _ = xyz.shape
    m = centers.shape[1]
    r2 = np.float32(radius * radius)
    tiles = -(-n // tile)
    out = np.full((b_all, m, ns), -1, np.int64)
    scanned, loaded = [], []
    for b in range(b_all):
        src = xyz[b].reshape(-1)
        for q0 in range(0, m, block):
            warps = list(range(q0, q0 + block))  # one centre a warp; q >= m is missing
            count = dict.fromkeys(warps, 0)
            first = dict.fromkeys(warps, 0)
            done = [q >= m for q in warps]
            reach = [0] * len(warps)
            last = tiles
            for t in range(tiles):
                stage, shift = load_tile(src, offset, n, t, tile)
                pts = stage[shift: shift + 3 * min(tile, n - t * tile)].reshape(-1, 3)
                for wi, q in enumerate(warps):
                    for base in range(0, len(pts), 32 * unroll):
                        if done[wi]:
                            break
                        reach[wi] = t * tile + min(base + 32 * unroll, len(pts))
                        for chunk in range(base, base + 32 * unroll, 32):
                            lane = np.arange(32)
                            inside = chunk + lane < len(pts)
                            p = pts[np.minimum(chunk + lane, len(pts) - 1)]
                            d = p - centers[b, q]
                            d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
                            hit = inside & (d2 < r2)
                            lanes = np.nonzero(hit)[0]  # the ballot
                            if len(lanes):
                                if count[q] == 0:
                                    first[q] = t * tile + chunk + lanes[0]
                                pos = count[q] + np.arange(len(lanes))  # popc of the lower lanes
                                keep = pos < ns
                                out[b, q, pos[keep]] = t * tile + chunk + lanes[keep]
                                count[q] += len(lanes)
                        done[wi] = count[q] >= ns
                if all(done):  # __syncthreads_count: the block stops
                    last = t + 1
                    break
            for q in count:
                if q < m:
                    out[b, q, min(count[q], ns):] = first[q]
            scanned.append(max(reach))
            loaded.append(min(n, tile * min(tiles, last - 1 + stages) if last < tiles else n))
    return out, np.array(scanned), np.array(loaded)


def nth_hit_tests(xyz, centers, radius, ns):
    """(B, M) points a first-ns scan tests: through the ns-th hit, or N."""
    d = xyz[:, None, :, :] - centers[:, :, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    rank = np.cumsum(d2 < np.float32(radius * radius), axis=-1)
    full = rank[..., -1] >= ns
    return np.where(full, np.argmax(rank >= ns, axis=-1) + 1, xyz.shape[1])


def lattice(rng, b, n):
    return (rng.integers(-4, 5, (b, n, 3)) / 8.0).astype(np.float32)


def cases():
    rng = np.random.default_rng(0)
    uni = rng.uniform(-0.3, 0.3, (2, 1000, 3)).astype(np.float32)
    ragged = (uni, uni[:, 3:40] + rng.normal(0, 0.01, (2, 37, 3)).astype(np.float32), 0.1, 16)
    dense = rng.uniform(-0.3, 0.3, (1, 700, 3)).astype(np.float32)
    dense[:, 100:400] = rng.uniform(-0.01, 0.01, (1, 300, 3))
    mixed = np.concatenate([np.full((1, 5, 3), 9.0, np.float32),  # no hits
                            np.zeros((1, 6, 3), np.float32),  # 300+ hits for 8 slots
                            dense[:, 500:510]], 1)
    lat = lattice(rng, 2, 900)
    on_radius = (lat, lat[:, 50:83], 0.25, 32)  # offsets of (2, 0, 0) / 8 sit on the sphere
    table = np.stack([tabletop_cloud(rng, 3000)])
    sa1_like = (table, table[:, ::83] + np.float32(0.002), 0.04, 64)
    return {"ragged": ragged, "empty_and_overfull": (dense, mixed, 0.1, 8),
            "on_radius": on_radius, "sa1_like": sa1_like}


CASES = cases()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("schedule", ["kernel", "small"])
def test_plan_matches_plain_and_pallas(name, schedule):
    xyz, centers, radius, ns = CASES[name]
    kw = {} if schedule == "kernel" else {"block": 6, "tile": 64, "stages": 2, "offset": 3, "unroll": 1}
    got, _, _ = scan_plan(xyz, centers, radius, ns, **kw)
    plain = ball_query_plain(torch.from_numpy(xyz), torch.from_numpy(centers), radius, ns).numpy()
    np.testing.assert_array_equal(got, plain)
    if schedule == "kernel":
        pallas = np.asarray(ball_query_pallas(jnp.asarray(xyz), jnp.asarray(centers), radius, ns))
        np.testing.assert_array_equal(got, pallas)
    if name == "on_radius":  # points exactly on the sphere are out, strictly inside in
        d = xyz[:, None] - centers[:, :, None]
        assert (np.sum(d * d, -1) == np.float32(radius * radius)).any()
    if name == "empty_and_overfull":
        assert (got[0, :5] == 0).all()  # no hits: index 0 everywhere
        assert (got[0, 5:11] == got[0, 5:6]).all()  # overfull: the first ns hits, all equal centres


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 2, 5, 1023, 1024, 1025, 2050, 4099])
def test_loader_covers_every_tile_at_every_alignment(offset, n):
    src = np.arange(3 * n, dtype=np.float32)
    for t in range(-(-n // BALL_SCAN_TILE)):
        stage, shift = load_tile(src, offset, n, t, BALL_SCAN_TILE)
        floats = 3 * min(BALL_SCAN_TILE, n - t * BALL_SCAN_TILE)
        got = stage[shift: shift + floats]
        np.testing.assert_array_equal(got, src[3 * BALL_SCAN_TILE * t: 3 * BALL_SCAN_TILE * t + floats])


@pytest.mark.parametrize("radius,ns", [(0.04, 64), (0.1, 32)])
@pytest.mark.parametrize("tile,stages", [(BALL_SCAN_TILE, BALL_SCAN_STAGES), (256, 2)])
def test_block_stops_at_its_slowest_centre(radius, ns, tile, stages):
    """A block scans as far as its slowest centre's ns-th hit (to the end
    of the warp's step of UNROLL chunks, or of the tile) and loads STAGES -
    1 tiles past the tile it stops in;
    a block whose centres never fill loads and scans all N.  The tabletop
    of the SA1-like case at r 0.1, ns 32 fills most blocks early; at SA1's
    r 0.04, ns 64, 3000 points fill none."""
    xyz, centers, _, _ = CASES["sa1_like"]
    n = xyz.shape[1]
    _, scanned, loaded = scan_plan(xyz, centers, radius, ns, tile=tile, stages=stages)
    nth = nth_hit_tests(xyz, centers, radius, ns)[0]
    slowest = np.array([nth[q0: q0 + BALL_SCAN_CENTERS].max() for q0 in range(0, len(nth), BALL_SCAN_CENTERS)])
    full = slowest < n
    assert full.any() == (radius > 0.05)
    assert (scanned >= slowest).all() and (scanned - slowest < 32 * BALL_SCAN_UNROLL).all()
    stop_tile = -(-slowest // tile)
    want = np.where(full, np.minimum(n, tile * np.minimum(stop_tile - 1 + stages, -(-n // tile))), n)
    np.testing.assert_array_equal(loaded, want)
