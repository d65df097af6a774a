"""The schedule of K10, the per-query oracle (csrc/query.cu,
seed_query_kernel), emulated in numpy on the CPU.

A warp takes one (scene, centre) and reads the scene's points straight from
device memory, 32 consecutive points a chunk (lane l the chunk's l-th
point), UNROLL chunks a step.  Per depth still short of ns hits, a ballot
per chunk over the 32 lanes' membership bits gives each hit its slot, the
depth's count plus the hits of lower lanes (the chunks of a step in order),
and a hit is written when its slot is < ns; the warp stops after the step in
which every depth has ns hits.  An empty slot takes its depth's first hit,
read back from slot 0; a depth with no hits takes point 0.  The membership
test is float32 with every product and sum rounded, in the JAX order:
ball mode (dx*dx + dy*dy) + dz*dz < r*r in every depth; cylinder mode the
offset rotated into the gripper frame, x_r = (dx*R0 + dy*R3) + dz*R6, then
y_r^2 + z_r^2 < r*r, x_r > hmin and x_r < hmax_d.

The emulation is held index for index against `multi_query_plain` and the
JAX package's `multi_query_pallas` in interpret mode, in both modes: N not
a multiple of 32, centres with more than ns hits and with none, 1, 4 and 8
depths with an unsorted hmax list, and points exactly on the radius, on
hmax_d and on hmin (coordinates whose squares are exact and
signed-permutation rotations, so XLA's FMAs on the CPU change nothing).  It
also checks that a warp stops within one step of its slowest depth's ns-th
hit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspnet_tpu.ops.pallas.query import multi_query_pallas

from graspnet_tpu_torch.ops.cuda.query import SEED_SCAN_UNROLL, multi_query_plain

from tests.test_torch_port_cylinder_scan_plan import rotate, signed_permutations
from tests.test_torch_port_ops import random_rotations


def member_bits(pts, centre, rot, radius, hmin, hmax, rotate_mode):
    """(P, 3) points -> (P, D) bool: the depths each point lies in."""
    r2 = np.float32(radius * radius)
    if not rotate_mode:
        d = (pts - centre).astype(np.float32)
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        return np.repeat((d2 < r2)[:, None], len(hmax), 1)
    xr, yr, zr = rotate(pts, centre, rot)
    base = (yr * yr + zr * zr < r2) & (xr > np.float32(hmin))
    return base[:, None] & (xr[:, None] < np.asarray(hmax, np.float32)[None])


def seed_plan(xyz, centers, rot, radius, hmin, hmax, ns, rotate_mode, unroll=SEED_SCAN_UNROLL):
    """(B, N, 3), (B, M, 3), (B, M, 3, 3) float32 -> ((B, M, D, ns) int64
    indices, (B, M) the points each warp tested)."""
    b_all, n, _ = xyz.shape
    m, nd = centers.shape[1], len(hmax)
    out = np.full((b_all, m, nd, ns), -1, np.int64)
    tested = np.zeros((b_all, m), np.int64)
    for b in range(b_all):
        for q in range(m):
            count = np.zeros(nd, np.int64)
            base = 0
            while base < n and not (count >= ns).all():
                p = base + np.arange(32 * unroll).reshape(unroll, 32)  # (chunk, lane)
                bits = member_bits(xyz[b, np.minimum(p, n - 1)].reshape(-1, 3), centers[b, q],
                                   None if rot is None else rot[b, q], radius, hmin, hmax, rotate_mode)
                bits = bits.reshape(unroll, 32, nd) & (p < n)[..., None]
                for d in range(nd):
                    if count[d] >= ns:  # a full depth takes no ballots
                        continue
                    for u in range(unroll):  # the chunk's ballot, its slots after the chunks before
                        lanes = np.nonzero(bits[u, :, d])[0]
                        pos = count[d] + np.arange(len(lanes))  # popc of the lower lanes
                        keep = pos < ns
                        out[b, q, d, pos[keep]] = p[u, lanes[keep]]
                        count[d] += len(lanes)
                base += 32 * unroll
            tested[b, q] = min(base, n)
            for d in range(nd):
                if count[d] < ns:  # pad from slot 0, the first hit, or point 0
                    out[b, q, d, count[d]:] = out[b, q, d, 0] if count[d] else 0
    return out, tested


def cases():
    rng = np.random.default_rng(0)
    uni = rng.uniform(-0.3, 0.3, (2, 301, 3)).astype(np.float32)  # 301: the last chunk is ragged
    near = uni[:, 3:12] + rng.normal(0, 0.01, (2, 9, 3)).astype(np.float32)
    dense = rng.uniform(-0.3, 0.3, (1, 333, 3)).astype(np.float32)
    dense[:, 100:300] = rng.uniform(-0.01, 0.01, (1, 200, 3))
    mixed = np.concatenate([np.full((1, 3, 3), 10.0, np.float32),  # centres 10 m away: no hits
                            np.zeros((1, 4, 3), np.float32)], 1)  # 200+ hits for 8 slots
    lat = (rng.integers(-4, 5, (2, 290, 3)) / 8.0).astype(np.float32)
    return {
        # name: (xyz, centres, rotations, radius, hmin, hmax list, ns)
        "ragged_one_depth": (uni, near, random_rotations(rng, (2, 9)), 0.1, -0.05, (0.05,), 16),
        "ragged_four_depths": (uni, near, random_rotations(rng, (2, 9)), 0.1, -0.05, (0.1, 0.02, 0.05, 0.03), 16),
        "empty_and_overfull": (dense, mixed, random_rotations(rng, (1, 7)), 0.1, -0.1, (0.02, 0.1), 8),
        # y_r^2 + z_r^2 == r^2 at offsets like (0, 2, 0) / 8, x_r == hmax_d at
        # (1, 0, 0) / 8 and the others, x_r == hmin at (-2, 0, 0) / 8
        "on_boundary_eight_depths": (lat, lat[:, 50:58], signed_permutations(rng, (2, 8)), 0.25, -0.25,
                                     (0.375, 0.125, 0.5, 0.25, 0.0, 0.125, 0.625, 0.25), 12),
    }


CASES = cases()
PLANS = {}


def plan(name, rotate_mode):
    if (name, rotate_mode) not in PLANS:
        xyz, centers, rot, radius, hmin, hmax, ns = CASES[name]
        if not rotate_mode:
            hmin = 0.0
        PLANS[name, rotate_mode] = seed_plan(xyz, centers, rot, radius, hmin, hmax, ns, rotate_mode)
    return PLANS[name, rotate_mode]


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("rotate_mode", [True, False])
def test_plan_matches_plain_and_pallas(name, rotate_mode):
    xyz, centers, rot, radius, hmin, hmax, ns = CASES[name]
    if not rotate_mode:
        hmin = 0.0
    got, _ = plan(name, rotate_mode)
    args = (radius, hmin, tuple(hmax), ns)
    plain = multi_query_plain(t(xyz), t(centers), t(rot) if rotate_mode else None, *args, rotate=rotate_mode)
    np.testing.assert_array_equal(got, plain.numpy())
    pallas = multi_query_pallas(jnp.asarray(xyz), jnp.asarray(centers), jnp.asarray(rot) if rotate_mode else None,
                                *args, rotate=rotate_mode)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    if name == "empty_and_overfull":
        assert (got[0, :3] == 0).all()  # no hits: index 0 everywhere
        assert (np.diff(got[0, 3:], axis=-1) > 0).all()  # overfull: ns distinct hits in index order
    if name == "on_boundary_eight_depths":  # points exactly on each boundary are out, strictly inside in
        xr, yr, zr = rotate(xyz[:, None], centers[:, :, None], rot[:, :, None])
        if rotate_mode:
            assert (yr * yr + zr * zr == np.float32(radius * radius)).any()
            assert (xr == np.float32(hmax[1])).any() and (xr == np.float32(hmin)).any()
        else:
            d = xyz[:, None] - centers[:, :, None]
            assert (np.sum(d * d, -1) == np.float32(radius * radius)).any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_warp_stops_within_a_step_of_its_slowest_depth(name):
    """A warp tests up to its slowest depth's ns-th hit, rounded up to the
    end of its step of UNROLL chunks, or all N."""
    xyz, centers, rot, radius, hmin, hmax, ns = CASES[name]
    _, tested = plan(name, True)
    n = xyz.shape[1]
    for b in range(xyz.shape[0]):
        for q in range(centers.shape[1]):
            rank = np.cumsum(member_bits(xyz[b], centers[b, q], rot[b, q], radius, hmin, hmax, True), axis=0)
            nth = max(int(np.argmax(rank[:, d] >= ns)) + 1 if rank[-1, d] >= ns else n for d in range(len(hmax)))
            step = 32 * SEED_SCAN_UNROLL
            assert tested[b, q] == min(n, -(-nth // step) * step)
