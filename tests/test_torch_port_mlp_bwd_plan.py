"""The K7 backward's pass split (csrc/mlp_train.cu), transcribed in plain
torch and held in float64 against autograd through `crop_mlp_train_plain`.

The kernel finds T3 = sum r3 zhat3 and S3 = sum r3 without recomputing the
forward: only rows at a pool maximum carry r3 and tied rows share one
zhat3, so both follow from the forward's pooled pre-norm z3 (z_ext) and the
cotangent.  Pass B then recomputes layers 1-3 per layer-3 column part,
forms dz3, dW3 and, per part, r2 = relu'(a2) dz3 W3^T with its T2/S2 share,
storing r2 and zhat2; pass C recomputes layer 1 only and finishes from the
stored r2 and zhat2.  The algebra is exact, so in float64 the plan meets
autograd at 1e-9 relative.  Cases: both test widths, first-hit padded
groups, groups of identical rows (64-way pool ties), gamma3 < 0 channels
(min pool), a gamma3 = 0 channel, and s < 64.
"""

import numpy as np
import pytest
import torch

from graspnet_tpu_torch.nn.layers import SharedMLP
from graspnet_tpu_torch.ops.cuda.mlp_train import crop_mlp_train_plain

REL_TOL = 1e-9
PART = 128  # layer-3 columns a pass-B block owns (kMaxHalf3)


def make_mlp(dims, seed, gamma3):
    gen = torch.Generator().manual_seed(seed)
    mlp = SharedMLP(dims)
    with torch.no_grad():
        for layer in mlp:
            layer.kernel.copy_(torch.randn(layer.kernel.shape, generator=gen) * (2.0 / layer.kernel.shape[0]) ** 0.5)
            layer.bn.scale.copy_(1.0 + 0.3 * torch.randn(layer.bn.scale.shape, generator=gen))
            layer.bn.offset.copy_(0.2 * torch.randn(layer.bn.offset.shape, generator=gen))
        scale3 = mlp[-1].bn.scale
        if gamma3 == "negative":
            scale3[: scale3.shape[0] // 2] *= -1.0
        scale3[1] = 0.0  # no gradient reaches layers 1-2 through this channel
    return mlp.double()


def grouped_rows(rng, lead, s, rows):
    g = rng.uniform(-0.3, 0.3, (*lead, s, 3))
    if rows == "padded":  # first-hit padding: the tail repeats the first hit
        g[..., s // 2:, :] = g[..., :1, :]
    elif rows == "identical":  # every other group is one row 64 times
        g[:, ::2] = g[:, ::2, :, :1]
    return torch.from_numpy(g)


def batch_norm(z, layer):
    """zhat over all rows, gamma / sigma, and the BN output."""
    mean = z.mean(dim=0)
    var = ((z - mean) ** 2).mean(dim=0)
    inv = torch.rsqrt(var + layer.bn.eps)
    zh = (z - mean) * inv
    return zh, layer.bn.scale * inv, zh * layer.bn.scale + layer.bn.offset


def plan_backward(mlp, x, gpool):
    """x (G, s, 3), gpool (G, c3) -> grads of (kernel, scale, offset) per
    layer, as csrc/mlp_train.cu's backward forms them, and the (T3, S3)
    that pass B's dz3 takes from z_ext."""
    l1, l2, l3 = mlp
    g, s, _ = x.shape
    c3 = l3.kernel.shape[1]
    n = g * s
    rows = x.reshape(n, 3)
    with torch.no_grad():
        # the forward, as the forward kernel keeps it: stats and z_ext
        zh1, gs1, y1 = batch_norm(rows @ l1.kernel, l1)
        a1 = torch.relu(y1)
        zh2, gs2, y2 = batch_norm(a1 @ l2.kernel, l2)
        a2 = torch.relu(y2)
        z3 = a2 @ l3.kernel
        zh3, gs3, y3 = batch_norm(z3, l3)
        z3g = z3.reshape(g, s, c3)
        zext = torch.where(l3.bn.scale >= 0, z3g.amax(dim=1), z3g.amin(dim=1))

        # pool sums from z_ext and the cotangent: no recompute
        mean3, var3 = z3.mean(dim=0), ((z3 - z3.mean(dim=0)) ** 2).mean(dim=0)
        zh_ext = (zext - mean3) * torch.rsqrt(var3 + l3.bn.eps)
        at_max = torch.relu(zh_ext * l3.bn.scale + l3.bn.offset) > 0
        t3 = (at_max * gpool * zh_ext).sum(dim=0)
        s3 = (at_max * gpool).sum(dim=0)

        # pass B: r3 from the recomputed pool, dz3, dW3, then r2 per column part
        a3 = torch.relu(y3).reshape(g, s, c3)
        pooled = a3.amax(dim=1, keepdim=True)
        ties = (a3 == pooled).sum(dim=1, keepdim=True)
        r3 = torch.where((a3 == pooled) & (a3 > 0), gpool[:, None] / ties, 0.0).reshape(n, c3)
        dz3 = gs3 * (r3 - s3 / n - zh3 * (t3 / n))
        dw3 = a2.T @ dz3
        dgb3 = ((r3 * zh3).sum(dim=0), r3.sum(dim=0))
        r2_parts, t2, s2 = [], 0.0, 0.0
        for c0 in range(0, c3, min(c3, PART)):
            part = slice(c0, c0 + min(c3, PART))
            r2_h = torch.where(a2 > 0, dz3[:, part] @ l3.kernel[:, part].T, 0.0)
            r2_parts.append(r2_h)
            t2 = t2 + (r2_h * zh2).sum(dim=0)
            s2 = s2 + r2_h.sum(dim=0)
        stored_zh2 = zh2.clone()

        # pass C: layer 1 recomputed; dz2 from the stored r2 parts and zhat2
        r2 = sum(r2_parts)
        dz2 = gs2 * (r2 - s2 / n - stored_zh2 * (t2 / n))
        dw2 = a1.T @ dz2
        r1 = torch.where(a1 > 0, dz2 @ l2.kernel.T, 0.0)
        t1, s1 = (r1 * zh1).sum(dim=0), r1.sum(dim=0)
        xr, xz, sx = rows.T @ r1, rows.T @ zh1, rows.sum(dim=0)
        dw1 = gs1 * (xr - sx[:, None] * (s1 / n) - xz * (t1 / n))
    return [dw1, t1, s1, dw2, t2, s2, dw3, *dgb3], (t3, s3)


@pytest.mark.parametrize(
    "dims,lead,s,rows,gamma3",
    [
        ((3, 8, 16, 32), (2, 3, 4), 64, "random", "positive"),
        ((3, 8, 16, 32), (2, 3, 4), 64, "padded", "negative"),
        ((3, 8, 16, 32), (2, 4, 4), 64, "identical", "negative"),
        ((3, 8, 16, 32), (2, 3, 4), 17, "padded", "positive"),
        ((3, 8, 16, 32), (2, 5, 4), 1, "random", "negative"),
        ((3, 64, 128, 256), (1, 2, 4), 64, "padded", "negative"),
        ((3, 64, 128, 256), (1, 4, 4), 64, "identical", "positive"),
        ((3, 64, 128, 256), (1, 2, 4), 33, "random", "negative"),
    ],
)
def test_pass_split_matches_autograd(dims, lead, s, rows, gamma3):
    rng = np.random.default_rng(s + dims[1])
    mlp = make_mlp(dims, 0, gamma3)
    grouped = grouped_rows(rng, lead, s, rows)
    gpool = torch.from_numpy(rng.normal(size=(*lead, dims[-1])))
    pooled, _ = crop_mlp_train_plain(mlp, grouped)
    params = [p for layer in mlp for p in (layer.kernel, layer.bn.scale, layer.bn.offset)]
    want = torch.autograd.grad(torch.sum(pooled * gpool), params)
    got, _ = plan_backward(mlp, grouped.reshape(-1, s, 3), gpool.reshape(-1, dims[-1]))
    for name, a, b in zip(("dW1", "dgamma1", "dbeta1", "dW2", "dgamma2", "dbeta2", "dW3", "dgamma3", "dbeta3"),
                          got, want):
        scale = max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= REL_TOL * scale, name


@pytest.mark.parametrize("rows", ["identical", "padded"])
def test_pool_sums_need_no_recompute(rows):
    """T3 and S3 from z_ext equal dgamma3 and dbeta3 (the sums over the rows
    that carry r3) wherever gamma3 != 0, with 64-way pool ties in half of
    the groups or padded ones.  Where gamma3 = 0 every row ties with its own
    zhat3, so z_ext's zhat3 is not theirs: dz3 does not read T3 there (its
    factor gamma3 / sigma3 is 0), and the kernel reports dgamma3 and dbeta3
    from pass B's routing instead."""
    rng = np.random.default_rng(5)
    mlp = make_mlp((3, 8, 16, 32), 1, "negative")
    grouped = grouped_rows(rng, (2, 4, 4), 64, rows)
    gpool = torch.from_numpy(rng.normal(size=(2, 4, 4, 32)))
    _, (t3, s3) = plan_backward(mlp, grouped.reshape(-1, 64, 3), gpool.reshape(-1, 32))
    pooled, _ = crop_mlp_train_plain(mlp, grouped)
    l3 = mlp[-1]
    want = torch.autograd.grad(torch.sum(pooled * gpool), (l3.bn.scale, l3.bn.offset))
    live = l3.bn.scale != 0
    assert not live.all()
    torch.testing.assert_close(t3[live], want[0][live], rtol=REL_TOL, atol=REL_TOL)
    torch.testing.assert_close(s3, want[1], rtol=REL_TOL, atol=REL_TOL)
