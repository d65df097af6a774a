"""The K1 FPS kernel's cluster plan (csrc/fps.cu), transcribed in plain torch
and held against `fps_plain`'s index sequence.

Stage 0 splits a scene's N points into C contiguous slices, one per CTA of
a thread-block cluster.  In a slice, thread t keeps points t, t + T, ...
(each thread's argmax takes the lowest index on ties), the CTA takes the
best thread by (value desc, index asc), and every CTA combines the C CTA
candidates in rank order by the same rule.  Later stages run on one CTA's
T threads.  Near-origin points hold -1 and slots past the end -2, so
neither is picked while a real point is left.  The plan must give the same
indices for every C, at N from 1 to MAX_SLICE, on lattices whose squares
are exact (multiples of 1/8, so distances tie) and with near-origin points.
"""

import numpy as np
import pytest
import torch

from graspnet_tpu_torch.ops.cuda.fps import INIT_DIST, MAX_SLICE, NEAR_ORIGIN_SQ, fps_chain_plain, fps_plain

THREADS = 256  # threads of a CTA in the register variant


def better(a, b):
    """(value, index) pairs: b beats a on a larger value or, tied, a lower index."""
    return b[0] > a[0] or (b[0] == a[0] and b[1] < a[1])


def cta_best(mind, lo, hi, threads):
    """The CTA owning points [lo, hi): per-thread argmax over its strided
    points, then the best thread."""
    span = hi - lo
    per = max(1, -(-span // threads))
    vals = torch.full((per * threads,), -3.0, dtype=mind.dtype)
    vals[:span] = mind[lo:hi]
    vals = vals.reshape(per, threads)  # row k: points lo + t + k * threads
    k = torch.argmax(vals, dim=0)  # first maximum: the thread's lowest index
    thread_val = vals[k, torch.arange(threads)]
    thread_idx = lo + torch.arange(threads) + k * threads
    top = thread_val.max()
    tie = thread_val == top
    return top.item(), int(thread_idx[tie].min())


def plan_stage(xyz, npoint, cluster, threads=THREADS):
    """One FPS stage of one scene (N, 3) as the cluster kernel runs it."""
    n = xyz.shape[0]
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    valid = (x * x + y * y + z * z) > NEAR_ORIGIN_SQ
    mind = torch.where(valid, torch.full_like(x, INIT_DIST), torch.full_like(x, -1.0))
    slice_len = -(-n // cluster)
    out = [0]
    c = xyz[0]
    for _ in range(1, npoint):
        d = (x - c[0]) * (x - c[0]) + (y - c[1]) * (y - c[1]) + (z - c[2]) * (z - c[2])
        mind = torch.fmin(d, mind)  # -1 stays below every distance
        best = (-3.0, 2**31 - 1)
        for rank in range(cluster):  # rank order
            lo, hi = rank * slice_len, min(n, (rank + 1) * slice_len)
            cand = cta_best(mind, lo, hi, threads) if lo < hi else (-3.0, 2**31 - 1)
            if better(best, cand):
                best = cand
        out.append(best[1])
        c = xyz[best[1]]
    return torch.tensor(out, dtype=torch.int64)


def plan_chain(xyz, npoints, cluster):
    """(B, N, 3) -> per stage (B, npoint): stage 0 on the cluster, later
    stages on one CTA."""
    outs = []
    for b in range(xyz.shape[0]):
        cur, per_scene = xyz[b], []
        for k, npoint in enumerate(npoints):
            idx = plan_stage(cur, npoint, cluster if k == 0 else 1)
            per_scene.append(idx)
            cur = cur[idx]
        outs.append(per_scene)
    return tuple(torch.stack([o[k] for o in outs]) for k in range(len(npoints)))


def cloud(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "lattice":  # squares exact in f32: many equal distances
        pts = rng.integers(-6, 7, (1, n, 3)) / 8.0
    else:
        pts = rng.uniform(-0.4, 0.4, (1, n, 3))
    pts = pts.astype(np.float32)
    if n > 3:
        near = rng.choice(n, max(1, n // 50), replace=False)
        pts[:, near] = rng.uniform(-0.01, 0.01, (1, len(near), 3))  # never picked
    return torch.from_numpy(pts)


@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
@pytest.mark.parametrize("n,npoints,kind", [
    (1, (1,), "uniform"),
    (33, (33,), "lattice"),
    (33, (20, 7, 3), "uniform"),
    (1000, (120, 40, 9), "lattice"),
    (1000, (64,), "uniform"),
    (MAX_SLICE, (24,), "lattice"),
])
def test_cluster_plan_matches_fps_plain(cluster, n, npoints, kind):
    xyz = cloud(kind, n, n + cluster)
    for got, want in zip(plan_chain(xyz, npoints, cluster), fps_chain_plain(xyz, npoints)):
        assert torch.equal(got, want)


def test_cluster_plan_every_point_of_a_tie_lattice():
    """npoint = N on a small lattice with near-origin points: the order of
    every pick, the near-origin ones last, agrees for every C."""
    xyz = cloud("lattice", 40, 3)
    want = fps_plain(xyz, 40)[0]
    for cluster in (1, 2, 8, 16):
        assert torch.equal(plan_stage(xyz[0], 40, cluster), want)
