"""The K7 forward's reductions (csrc/mlp_train.cu), transcribed in plain
torch and held in float64 against torch's own mean, variance and the plain
pooled output.

Batch statistics: pass 3 reduces each thread's tile rows (r = tm + tmt i <
s, i < TM, with TM = 8 and tmt = 8 where c3 > 128, else TM = 4 and tmt =
16) of a column to a (mean, M2) pair, combines the tmt row-threads in
ascending tm with Chan's formula, folds the group's pair into the block's
running pair (block b walks groups b, b + nblk, ...), and
`chan_reduce_kernel` combines the blocks: lane l takes blocks l, l + 32, ...
in order, then lane l absorbs lane l + 1, 2, 4, 8, 16.  Passes 1-2 take
each group's pair in one two-pass sweep over its s rows (`column_stats`).
The algebra is exact, so in float64 the plan meets torch.mean / var at
1e-9 relative.

The pool: the kernel keeps each group's max and min of the pre-norm z3 (the
max over the row-threads' maxima); relu(bn3(.)) is monotone with the sign
of gamma3, so pooling zmax (gamma3 >= 0) or zmin (gamma3 < 0) through it
gives the plain pooled output.  Cases: gamma3 < 0 channels, a gamma3 = 0
channel, s < 64 and groups of 64 identical rows (64-way ties).
"""

import pytest
import numpy as np
import torch

from graspnet_tpu_torch.nn.layers import dense
from graspnet_tpu_torch.ops.cuda.mlp_train import crop_mlp_train_plain

from tests.test_torch_port_mlp_bwd_plan import grouped_rows, make_mlp

REL_TOL = 1e-9
ROWS = 64  # kMaxRows: a group's tile


def chan_add(acc, part):
    """Chan's combine of (mean, m2, n) pairs, as chan_add in the kernel."""
    mean, m2, n = acc
    mt, m2t, nt = part
    if n == 0:
        return mt, m2t, nt
    nn = n + nt
    delta = mt - mean
    return mean + delta * (nt / nn), m2 + m2t + delta * delta * (n * nt / nn), nn


def pair(rows: torch.Tensor):
    """(mean, M2, n) of rows (k, C) in two passes; n = 0 for no rows."""
    if rows.shape[0] == 0:
        return 0.0, 0.0, 0
    mt = rows.sum(dim=0) / rows.shape[0]
    return mt, ((rows - mt) ** 2).sum(dim=0), rows.shape[0]


def group_pair_pass3(z: torch.Tensor, tm_rows: int):
    """A group's (s, C) pre-norm z3 -> its (mean, M2, s) as pass 3 forms it
    from the row-threads' partials, and its max and min."""
    tmt = ROWS // tm_rows
    acc = (0.0, 0.0, 0)
    maxes, mins = [], []
    for tm in range(tmt):
        rows = z[tm::tmt][:tm_rows]
        if rows.shape[0] == 0:
            break
        acc = chan_add(acc, pair(rows))
        maxes.append(rows.amax(dim=0))
        mins.append(rows.amin(dim=0))
    return acc, torch.stack(maxes).amax(dim=0), torch.stack(mins).amin(dim=0)


def block_reduce(pairs, nblk: int):
    """Per-group pairs -> [mean; biased var]: block b folds groups b, b +
    nblk, ... into a running pair; the blocks combine as chan_reduce_kernel."""
    blocks = []
    for b in range(min(nblk, len(pairs))):
        acc = (0.0, 0.0, 0)
        for grp in range(b, len(pairs), nblk):
            acc = chan_add(acc, pairs[grp])
        blocks.append(acc)
    lanes = []
    for lane in range(32):
        acc = (0.0, 0.0, 0)
        for b in range(lane, len(blocks), 32):
            acc = chan_add(acc, blocks[b])
        lanes.append(acc)
    off = 1
    while off < 32:  # lane l absorbs lane l + off, all lanes at once
        lanes = [chan_add(lanes[lane], lanes[lane + off]) if lane + off < 32 and lanes[lane + off][2] else lanes[lane]
                 for lane in range(32)]
        off *= 2
    mean, m2, n = lanes[0]
    return mean, m2 / n


def pre_norm(mlp, grouped: torch.Tensor):
    """(..., s, 3) -> z1, z2, z3 as (G, s, C) each, batch-stat BN between."""
    l1, l2, l3 = mlp
    z1 = dense(l1.kernel, None, grouped)
    a1, _ = l1.forward_train(grouped)
    z2 = dense(l2.kernel, None, a1)
    a2, _ = l2.forward_train(a1)
    z3 = dense(l3.kernel, None, a2)
    return [z.reshape(-1, z.shape[-2], z.shape[-1]) for z in (z1, z2, z3)]


CASES = [
    ((3, 8, 16, 32), (2, 3, 4), 64, "random", "positive", 5),
    ((3, 8, 16, 32), (2, 3, 4), 17, "padded", "negative", 40),
    ((3, 8, 16, 32), (2, 4, 4), 64, "identical", "negative", 7),
    ((3, 8, 16, 32), (2, 5, 4), 1, "random", "negative", 3),
    ((3, 64, 128, 256), (1, 2, 4), 64, "padded", "negative", 3),
    ((3, 64, 128, 256), (1, 4, 4), 64, "identical", "positive", 5),
    ((3, 64, 128, 256), (1, 3, 4), 33, "random", "negative", 132),
    ((3, 64, 128, 256), (1, 3, 4), 9, "random", "positive", 2),
]


@pytest.mark.parametrize("dims,lead,s,rows,gamma3,nblk", CASES)
def test_stats_in_the_kernels_order_meet_torch(dims, lead, s, rows, gamma3, nblk):
    rng = np.random.default_rng(s + dims[1])
    mlp = make_mlp(dims, 0, gamma3)
    with torch.no_grad():
        zs = pre_norm(mlp, grouped_rows(rng, lead, s, rows))
    tm_rows = 8 if dims[-1] > 128 else 4
    for layer, z in enumerate(zs):
        if layer == 2:
            pairs = [group_pair_pass3(zg, tm_rows)[0] for zg in z]
        else:
            pairs = [pair(zg) for zg in z]
        mean, var = block_reduce(pairs, nblk)
        flat = z.reshape(-1, z.shape[-1])
        want_mean, want_var = flat.mean(dim=0), flat.var(dim=0, unbiased=False)
        assert (mean - want_mean).abs().max().item() <= REL_TOL * max(1.0, want_mean.abs().max().item())
        assert (var - want_var).abs().max().item() <= REL_TOL * max(1.0, want_var.abs().max().item())


@pytest.mark.parametrize("dims,lead,s,rows,gamma3,nblk", CASES)
def test_pooled_extreme_through_bn3_is_the_plain_pool(dims, lead, s, rows, gamma3, nblk):
    rng = np.random.default_rng(s + dims[1] + 1)
    mlp = make_mlp(dims, 1, gamma3)
    grouped = grouped_rows(rng, lead, s, rows)
    with torch.no_grad():
        z3 = pre_norm(mlp, grouped)[2]
        want, _ = crop_mlp_train_plain(mlp, grouped)
    tm_rows = 8 if dims[-1] > 128 else 4
    reduced = [group_pair_pass3(zg, tm_rows) for zg in z3]
    zmax = torch.stack([r[1] for r in reduced])
    zmin = torch.stack([r[2] for r in reduced])
    bn = mlp[-1].bn
    mean, var = block_reduce([r[0] for r in reduced], nblk)
    zext = torch.where(bn.scale >= 0, zmax, zmin)
    pooled = torch.relu((zext - mean) * (torch.rsqrt(var + bn.eps) * bn.scale) + bn.offset)
    assert (bn.scale == 0).any() and ((bn.scale < 0).any() or gamma3 == "positive")
    want = want.reshape(-1, dims[-1])
    assert (pooled - want).abs().max().item() <= REL_TOL * max(1.0, want.abs().max().item())
