"""The scatter-add's two kernels (`csrc/scatter.cu`), their schedules
emulated in numpy on the CPU, against the plain versions.

* The plan kernel (`scatter_plan_kernel`): CTAs of PLAN_WARPS warps, each
  CTA a contiguous chunk of PLAN_CHUNK keys and each warp a contiguous
  piece of it, at most one CTA an SM; per-warp histograms, the warps'
  exclusive prefix, the (CTA, row) table, the rows shared out over the CTAs
  for the prefix over CTAs, the scan of the row totals and each row's rank
  in its group of the work order (long, short, empty segments), then each
  warp's placement, 32 keys a step, a key's rank among its step's equal
  keys counted from the lower lanes.  Its perm, starts and order are held
  bitwise against `scatter_plan` (on the CPU, the plain version's
  torch.sort(stable=True) and searchsorted), at a B=2 training step's five
  calls with indices shaped like the ball query's first-hit padding
  (segments of ~200 sources, most rows empty) and three-NN's shared
  neighbours, and at the edges: a ragged last chunk and piece, a grid
  capped below the chunks, all keys in one row, every row empty but one,
  B=1 with n=20000 (the global-memory histograms), and indices outside
  [0, n), which sort last and count in no segment.
* The segment sum (`segment_sum_kernel`): a warp a (row, 32-channel
  slice), 32 source rows a round, each channel's sum in segment order from
  0.0f; held bitwise against `scatter_add_rows_plain` (the CPU's
  sequential `index_add_`) with segments longer than a round, empty rows,
  a ragged last slice and dropped indices.

The kernels themselves run in `tests/test_torch_port_cuda.py` and
`chip_smoke.py` at the same shapes (`step_idx`, `EDGE_CASES`).
"""

import numpy as np
import pytest
import torch

from graspnet_tpu_torch.ops.scatter import (PLAN_CHUNK, PLAN_SMEM_ROWS, PLAN_WARPS, SUM_LONG, scatter_add_rows,
                                            scatter_add_rows_plain, scatter_plan)

H100_SMS = 132
# a B=2 training step's five calls: (B, K, n) of FP1, FP2 (three_interpolate), SA4, SA3, SA2 (group_points)
STEP_CALLS = {"fp1": (2, 3072, 512), "fp2": (2, 1536, 256), "sa4": (2, 4096, 512), "sa3": (2, 8192, 1024),
              "sa2": (2, 32768, 2048)}
NSAMPLE = {"sa4": 16, "sa3": 16, "sa2": 32}


def ball_idx(rng, b, m, s, n):
    """(B, m * s) indices like the ball query's: each centre's hits in
    ascending order from a band of 12 points above an anchor, the anchors
    m / 8 rows of the n, its unfilled slots padded with its first hit, so
    ~8 centres pile their padding onto one row (~100-250 sources) and most
    rows stay empty."""
    out = np.empty((b, m, s), np.int64)
    for bi in range(b):
        surface = np.sort(rng.choice(n, max(1, m // 8), replace=False))
        for c in range(m):
            cnt = min(s, int(rng.geometric(0.25)))
            j = rng.integers(0, len(surface))
            hits = np.unique(surface[np.minimum(j + rng.integers(0, 12, cnt), len(surface) - 1)])
            out[bi, c, : len(hits)] = hits
            out[bi, c, len(hits):] = hits[0]
    return out.reshape(b, m * s)


def nn_idx(rng, b, m, n):
    """(B, m * 3) three-NN indices into n known points: neighbours of
    nearby unknown points overlap, every known point is someone's."""
    base = (np.arange(m) * n // m)[None, :, None]
    out = (base + rng.integers(0, 3, (b, m, 3)) + np.arange(3)[None, None]) % n
    return out.reshape(b, m * 3).astype(np.int64)


def step_idx(name, seed=0):
    """The indices of one of a step's five calls, and its n."""
    rng = np.random.default_rng(seed)
    b, k, n = STEP_CALLS[name]
    if name.startswith("fp"):
        return nn_idx(rng, b, k // 3, n), n
    s = NSAMPLE[name]
    return ball_idx(rng, b, k // s, s, n), n


def _edge(name):
    rng = np.random.default_rng(7)
    if name == "ragged":  # a chunk and a piece cut short, a step of 3 keys
        return rng.integers(0, 40, (3, 4099)), 40
    if name == "one_row":  # every key in row 5 of scene 1
        idx = np.full((2, 5000), -1, np.int64)
        idx[1] = 5
        return idx, 9
    if name == "one_row_filled":  # every row empty but one
        return np.full((1, 777), 3, np.int64), 100
    if name == "b1_n20000":  # B * n + 1 past PLAN_SMEM_ROWS: the histograms in global memory
        return rng.integers(0, 20000, (1, 30000)), 20000
    if name == "dropped":  # n, -1, 2n and a large negative among in-range keys, in every scene
        idx = rng.integers(0, 64, (3, 1500))
        idx[:, ::5] = 64
        idx[:, 1::7] = -1
        idx[:, 2::11] = 128
        idx[:, 3::13] = -(2**40)
        return idx, 64
    raise KeyError(name)


EDGE_CASES = ("ragged", "one_row", "one_row_filled", "b1_n20000", "dropped")


def edge_idx(name):
    idx, n = _edge(name)
    return np.asarray(idx, np.int64), n


def emulate_plan(idx, n, sms=H100_SMS):
    """scatter_plan_kernel's schedule in numpy -> (perm, starts, order) int32."""
    b, k = idx.shape
    total, rows = b * k, b * n + 1
    flat = idx.reshape(-1)
    scene = np.arange(total) // max(k, 1)
    keys = np.where((flat >= 0) & (flat < n), scene * n + flat, rows - 1)
    chunks = -(-total // PLAN_CHUNK) if total else 1
    ctas = min(chunks, sms)
    warps = ctas * PLAN_WARPS
    per_warp = -(-total // (warps * 32)) * 32

    def pieces():
        for c in range(ctas):
            for w in range(PLAN_WARPS):
                lo = min((c * PLAN_WARPS + w) * per_warp, total)
                yield c, w, lo, min(lo + per_warp, total)

    def steps(lo, hi):
        for s in range(lo, hi, 32):
            step = keys[s: min(s + 32, hi)]
            eq = step[:, None] == step[None, :]
            lower = np.tril(np.ones(eq.shape, bool), -1)  # [i, j]: lane j below lane i
            yield s, step, (eq & lower).sum(1), eq.sum(1)

    # 1. per-warp counts: one add of the group's size by its lowest lane
    hist = np.zeros((ctas, PLAN_WARPS, rows), np.int64)
    for c, w, lo, hi in pieces():
        for _, step, rank, count in steps(lo, hi):
            lead = rank == 0
            hist[c, w, step[lead]] += count[lead]
    warp_prefix = np.cumsum(hist, axis=1) - hist
    table = hist.sum(1)  # (CTA, row)
    # 2. each CTA's slice of rows: the prefix over CTAs, the totals' scan,
    # each output row's rank in its group of the work order (long, short,
    # empty segments); 3. the slices before it
    cta_prefix = np.cumsum(table, axis=0) - table
    totals = table.sum(0)
    group = np.where(totals[:-1] >= SUM_LONG, 0, np.where(totals[:-1] > 0, 1, 2))
    starts = np.zeros(rows, np.int64)
    order = np.full(rows - 1, -1, np.int64)
    slice_ = -(-rows // ctas)
    slices = [(min(rows, c * slice_), min(rows, c * slice_ + slice_)) for c in range(ctas)]
    group_base = np.cumsum([0] + [(group == o).sum() for o in range(2)])
    offset, seen = 0, np.zeros(3, np.int64)
    for r0, r1 in slices:
        starts[r0:r1] = offset + np.cumsum(totals[r0:r1]) - totals[r0:r1]
        offset += totals[r0:r1].sum()
        mine = group[r0: min(r1, rows - 1)]
        for o in range(3):
            rank = np.cumsum(mine == o) - (mine == o)
            at = np.flatnonzero(mine == o)
            order[group_base[o] + seen[o] + rank[at]] = r0 + at
            seen[o] += len(at)
    base = cta_prefix + starts[None]
    # 3. placement: each warp's cursor per row, a key's rank from its lower peers
    cursor = base[:, None, :] + warp_prefix
    perm = np.full(total, -1, np.int64)
    for c, w, lo, hi in pieces():
        for s, step, rank, count in steps(lo, hi):
            perm[s + np.arange(len(step))] = cursor[c, w, step] + rank
            lead = rank == 0
            cursor[c, w, step[lead]] += count[lead]
    out = np.empty(total, np.int64)
    out[perm] = np.arange(total)  # perm above holds each source's position
    assert (np.sort(perm) == np.arange(total)).all() and (np.sort(order) == np.arange(rows - 1)).all()
    return out.astype(np.int32), starts.astype(np.int32), order.astype(np.int32)


def assert_plan_equal(idx, n, sms=H100_SMS):
    plan = scatter_plan(torch.from_numpy(idx), n)
    assert all(t.dtype == torch.int32 for t in plan)
    for got, want in zip(emulate_plan(idx, n, sms), plan):
        np.testing.assert_array_equal(got, want.numpy())
    return plan[0].numpy(), plan[1].numpy(), plan[2].numpy()


@pytest.mark.parametrize("name", sorted(STEP_CALLS))
def test_plan_schedule_is_bitwise_the_plain_plan_at_a_step(name):
    idx, n = step_idx(name)
    perm, starts, order = assert_plan_equal(idx, n)
    segs = np.diff(starts)
    if name.startswith("sa"):  # the first-hit padding: long segments, most rows empty
        assert segs.max() >= 100 and (segs == 0).mean() > 0.5, (segs.max(), (segs == 0).mean())
    assert starts[-1] == idx.size  # nothing dropped


@pytest.mark.parametrize("name", EDGE_CASES)
def test_plan_schedule_is_bitwise_the_plain_plan_at_the_edges(name):
    idx, n = edge_idx(name)
    perm, starts, order = assert_plan_equal(idx, n)
    valid = (idx >= 0) & (idx < n)
    assert starts[-1] == valid.sum()
    # the dropped sources sort last, in ascending order
    np.testing.assert_array_equal(perm[starts[-1]:], np.flatnonzero(~valid.reshape(-1)))
    if name == "b1_n20000":
        assert idx.shape[0] * n + 1 > PLAN_SMEM_ROWS


@pytest.mark.parametrize("sms", [1, 3])
def test_plan_schedule_with_the_grid_capped_below_the_chunks(sms):
    """Fewer SMs than chunks: each warp's piece grows past a chunk's share."""
    idx, n = step_idx("sa3")
    assert_plan_equal(idx, n, sms)


def test_plan_keeps_every_source_once_in_stable_order():
    idx, n = step_idx("sa2")
    perm, starts, order = (t.numpy() for t in scatter_plan(torch.from_numpy(idx), n))
    keys = (idx + n * np.arange(2)[:, None]).reshape(-1)
    assert sorted(perm.tolist()) == list(range(idx.size))
    for r in np.flatnonzero(np.diff(starts) > 1)[:200]:
        seg = perm[starts[r]: starts[r + 1]]
        assert (keys[seg] == r).all() and (np.diff(seg) > 0).all()
    # the work order: long segments, then short, then empty, each in ascending row
    lengths = np.diff(starts)[order]
    group = np.where(lengths >= SUM_LONG, 0, np.where(lengths > 0, 1, 2))
    assert (np.diff(group) >= 0).all() and sorted(order.tolist()) == list(range(len(order)))
    assert all((np.diff(order[group == o]) > 0).all() for o in range(3))
    assert (lengths[group == 0] >= SUM_LONG).all() and group[0] == 0


def emulate_sum(g, perm, starts, order):
    """segment_sum_kernel's walk in numpy: a (row, 32-channel slice) item a
    warp, the rows in the plan's work order, 32 perm entries and source rows
    a round, the round's rows added in order, each channel from 0.0, one
    float32 add at a time."""
    flat = g.reshape(-1, g.shape[-1])
    c = flat.shape[1]
    out = np.full((len(order), c), np.nan, np.float32)
    for row in order:
        s0, s1 = starts[row], starts[row + 1]
        for q in range(-(-c // 32)):
            ch = slice(q * 32, min(c, q * 32 + 32))
            acc = np.zeros(ch.stop - ch.start, np.float32)
            for s in range(s0, s1, 32):
                x = flat[perm[s: min(s + 32, s1)], ch]  # the round's loads
                for u in range(len(x)):
                    acc = (acc + x[u]).astype(np.float32)
            out[row, ch] = acc
    return out


@pytest.mark.parametrize("b,k,n,c", [(2, 700, 12, 40), (1, 300, 5, 33), (3, 257, 64, 1)])
def test_sum_schedule_is_bitwise_the_cpu_sum(b, k, n, c):
    rng = np.random.default_rng(k + c)
    g = (rng.standard_normal((b, k, c)) * 1e3 ** rng.integers(-2, 3, (b, k, 1))).astype(np.float32)
    idx = rng.integers(-2, n + 2, (b, k))  # out-of-range indices drop
    idx[:, : k // 2] = idx[:, :1]  # a run past a round of 32
    perm, starts, order = scatter_plan(torch.from_numpy(idx), n)
    assert np.diff(starts.numpy()).max() > 32
    want = scatter_add_rows_plain(torch.from_numpy(g), torch.from_numpy(idx), n).numpy()
    got = emulate_sum(g, perm.numpy(), starts.numpy(), order.numpy()).reshape(b, n, c)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(scatter_add_rows(torch.from_numpy(g), torch.from_numpy(idx), n).numpy(), want)


def test_plain_plan_raises_past_int32():
    with pytest.raises(ValueError):
        scatter_plan(torch.zeros((2, 1), dtype=torch.int64).expand(2, 2**30), 3)
