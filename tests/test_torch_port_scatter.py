"""The port's deterministic gather backward against the JAX `custom_vjp`s.

* `gather_points`, `group_points` and `three_interpolate` take their
  gradients through `ops/scatter.py` (a `torch.autograd.Function` whose
  backward is `scatter_add_rows`).  On the same numpy inputs, with indices
  that collide (the ball query's first-hit padding repeats an index, three-NN
  neighbours are shared), the port's gradients are held against `jax.grad`
  of the JAX functions (`graspnet_tpu/ops/sampling.py:76`,
  `ops/query.py:196`, `ops/knn.py:98`) within 1e-6 x max(1, scale): the
  JAX backward sums by one-hot matmuls, the port's in index order.
* `scatter_add_rows` against the JAX function at the same tolerance, and
  with indices outside [0, n), which the JAX function drops: they add to no
  row of any scene.
* The kernel's plan on the CPU: `scatter_plan`'s sorted segments walked in
  order from 0.0 (what `csrc/scatter.cu` does a warp per row) are bitwise
  the plain version's sequential `index_add_`, so the kernel's sums can be
  held bitwise against the CPU.  The kernel itself runs in
  `tests/test_torch_port_cuda.py` and `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspnet_tpu.ops.knn import three_interpolate as jthree_interpolate
from graspnet_tpu.ops.query import group_points as jgroup_points
from graspnet_tpu.ops.sampling import gather_points as jgather_points
from graspnet_tpu.ops.scatter import scatter_add_rows as jscatter_add_rows

from graspnet_tpu_torch import ops
from graspnet_tpu_torch.ops import cuda as kernels
from graspnet_tpu_torch.ops.scatter import scatter_add_rows, scatter_add_rows_plain, scatter_plan

TOL = 1e-6


def assert_close_scaled(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= TOL * scale


def colliding_idx(rng, b, k, n):
    """Indices into n rows where most rows repeat: the first-hit padding
    pattern (runs of one index) beside random picks of a few rows."""
    idx = rng.integers(0, n, (b, k))
    idx[:, k // 2:] = idx[:, :1]  # a long run of the first hit
    idx[:, ::7] = rng.integers(0, max(1, n // 8), (b, len(idx[0, ::7])))
    return idx


def port_grad(fn, x, *args, cot):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(xt, *args)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), xt.grad.numpy()


def jax_grad(fn, x, *args, cot):
    out, vjp = jax.vjp(lambda p: fn(p, *args), jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("b,n,m,c", [(2, 50, 40, 5), (1, 8, 64, 33), (3, 300, 129, 16)])
def test_gather_points_grad_matches_jax(b, n, m, c):
    rng = np.random.default_rng(b * 100 + c)
    pts = rng.standard_normal((b, n, c)).astype(np.float32)
    idx = colliding_idx(rng, b, m, n)
    cot = rng.standard_normal((b, m, c)).astype(np.float32)
    out, grad = port_grad(ops.gather_points, pts, torch.from_numpy(idx), cot=cot)
    jout, jgrad = jax_grad(jgather_points, pts, jnp.asarray(idx, jnp.int32), cot=cot)
    np.testing.assert_array_equal(out, jout)
    assert_close_scaled(grad, jgrad)


@pytest.mark.parametrize("b,n,m,s,c", [(2, 64, 16, 8, 6), (1, 20, 30, 16, 35), (2, 128, 32, 4, 128)])
def test_group_points_grad_matches_jax(b, n, m, s, c):
    rng = np.random.default_rng(n + s)
    pts = rng.standard_normal((b, n, c)).astype(np.float32)
    idx = colliding_idx(rng, b, m * s, n).reshape(b, m, s)
    cot = rng.standard_normal((b, m, s, c)).astype(np.float32)
    out, grad = port_grad(ops.group_points, pts, torch.from_numpy(idx), cot=cot)
    jout, jgrad = jax_grad(jgroup_points, pts, jnp.asarray(idx, jnp.int32), cot=cot)
    np.testing.assert_array_equal(out, jout)
    assert_close_scaled(grad, jgrad)


@pytest.mark.parametrize("b,m,n,c", [(2, 16, 64, 32), (1, 5, 40, 7)])
def test_three_interpolate_grads_match_jax(b, m, n, c):
    """Both the features' and the weights' gradients, with the neighbours
    and weights of a real three_nn (neighbours shared between points)."""
    rng = np.random.default_rng(m)
    known = rng.uniform(-1, 1, (b, m, 3)).astype(np.float32)
    unknown = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    feats = rng.standard_normal((b, m, c)).astype(np.float32)
    cot = rng.standard_normal((b, n, c)).astype(np.float32)
    dist, idx = ops.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    w = (1.0 / (dist + 1e-8))
    w = (w / w.sum(-1, keepdim=True)).numpy()
    ft = torch.from_numpy(feats).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = ops.three_interpolate(ft, idx, wt)
    out.backward(torch.from_numpy(cot))
    jidx = jnp.asarray(idx.numpy(), jnp.int32)
    jout, vjp = jax.vjp(lambda f, ww: jthree_interpolate(f, jidx, ww), jnp.asarray(feats), jnp.asarray(w))
    jgf, jgw = vjp(jnp.asarray(cot))
    assert_close_scaled(out.detach().numpy(), jout)
    assert_close_scaled(ft.grad.numpy(), jgf)
    assert_close_scaled(wt.grad.numpy(), jgw)
    assert len(np.unique(idx.numpy())) < idx.numel()  # shared neighbours: colliding indices


@pytest.mark.parametrize("b,k,n,c", [(2, 100, 30, 8), (1, 7, 200, 129), (3, 512, 64, 1)])
def test_scatter_add_rows_matches_jax(b, k, n, c):
    rng = np.random.default_rng(k)
    g = rng.standard_normal((b, k, c)).astype(np.float32)
    idx = colliding_idx(rng, b, k, n)
    got = scatter_add_rows(torch.from_numpy(g), torch.from_numpy(idx), n)
    want = jscatter_add_rows(jnp.asarray(g), jnp.asarray(idx, jnp.int32), n)
    assert_close_scaled(got.numpy(), want)


@pytest.mark.parametrize("case", ["minus_one", "n", "every_scene"])
def test_out_of_range_indices_drop_as_in_jax(case):
    """An index outside [0, n) adds to no row: not to the next scene's row
    0 (idx = n) nor to the previous scene's last row (idx = -1)."""
    if case == "every_scene":
        rng = np.random.default_rng(5)
        n = 6
        idx = rng.integers(0, n, (3, 40))
        idx[:, 3], idx[:, 17], idx[:, 31] = n, -1, 2 * n
        g = rng.standard_normal((3, 40, 5)).astype(np.float32)
    else:
        n = 3
        idx = np.array({"minus_one": [[0, 1, 2, 2], [0, 0, 1, -1]], "n": [[0, 1, 3, 2], [0, 0, 1, 1]]}[case])
        g = np.ones((2, 4, 1), np.float32)
    want = np.asarray(jscatter_add_rows(jnp.asarray(g), jnp.asarray(idx, jnp.int32), n))
    for fn in (scatter_add_rows, scatter_add_rows_plain):
        got = fn(torch.from_numpy(g), torch.from_numpy(idx), n).numpy()
        assert_close_scaled(got, want)
    if case != "every_scene":  # sums of ones: exact
        np.testing.assert_array_equal(scatter_add_rows(torch.from_numpy(g), torch.from_numpy(idx), n).numpy(), want)
    _, starts, _ = scatter_plan(torch.from_numpy(idx), n)
    assert starts[-1] == ((idx >= 0) & (idx < n)).sum()


def walk_plan(g, perm, starts, rows, c):
    """csrc/scatter.cu's arithmetic in numpy: each output row sums its
    sorted segment in order, starting from 0.0, one float32 add at a time."""
    flat = g.reshape(-1, c)
    out = np.zeros((rows, c), np.float32)
    for r in range(rows):
        acc = np.zeros(c, np.float32)
        for s in range(starts[r], starts[r + 1]):
            acc = (acc + flat[perm[s]]).astype(np.float32)
        out[r] = acc
    return out


@pytest.mark.parametrize("b,k,n,c", [(2, 96, 24, 5), (1, 40, 3, 33)])
def test_kernel_plan_is_bitwise_the_plain_version(b, k, n, c):
    rng = np.random.default_rng(n)
    g = rng.standard_normal((b, k, c)).astype(np.float32) * np.float32(1e3) ** rng.integers(-2, 3, (b, k, 1))
    idx = colliding_idx(rng, b, k, n)
    gt, it = torch.from_numpy(g.astype(np.float32)), torch.from_numpy(idx)
    perm, starts, _ = scatter_plan(it, n)
    assert starts[0] == 0 and starts[-1] == b * k and (starts[1:] >= starts[:-1]).all()
    keys = (it + n * torch.arange(b)[:, None]).reshape(-1)
    for r in range(b * n):  # each segment lists its source rows in ascending order
        seg = perm[starts[r]: starts[r + 1]]
        assert (keys[seg] == r).all() and (seg[1:] > seg[:-1]).all()
    want = scatter_add_rows_plain(gt, it, n).numpy().reshape(b * n, c)
    np.testing.assert_array_equal(walk_plan(g.astype(np.float32), perm.numpy(), starts.numpy(), b * n, c), want)


def test_gathers_record_nothing_without_grad():
    pts = torch.randn(1, 10, 4)
    idx = torch.randint(0, 10, (1, 6))
    assert ops.gather_points(pts, idx).grad_fn is None
    with torch.no_grad():
        assert ops.gather_points(pts.requires_grad_(True), idx).grad_fn is None
    assert ops.gather_points(pts, idx).grad_fn is not None


def test_cpu_backward_launches_no_kernel():
    kernels.reset_launches()
    pts = torch.randn(2, 30, 8, requires_grad=True)
    ops.group_points(pts, torch.randint(0, 30, (2, 5, 4))).sum().backward()
    assert kernels.launches()["scatter_add_rows"] == kernels.launches()["scatter_plan"] == 0
    assert pts.grad.shape == pts.shape
