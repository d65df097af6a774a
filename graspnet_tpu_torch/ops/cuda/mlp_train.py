"""Train-mode crop MLP (batch-stats BN SharedMLP + max over samples), forward
and backward: the `csrc/mlp_train.cu` kernels and their plain version.

Counterpart of `graspnet_tpu/ops/pallas/mlp_train.py::crop_mlp_train_pallas`
(the forward `_mlp_train_fwd_call`, the backward `_mlp_train_bwd_call` and
the VJP assembly `_make_fused`).  `crop_mlp_train` runs the plain version
(`crop_mlp_train_plain`: the train-mode SharedMLP, then `torch.amax`, which
splits the gradient evenly across ties as `jnp.max`'s VJP does) for a CPU
tensor, and for a CUDA tensor a `torch.autograd.Function` whose forward and
backward are the kernels.  The forward kernel counts in
`crop_mlp_train.launches`, the backward in `crop_mlp_train_backward.launches`.

The kernels compute in float32 on the CUDA cores; the JAX package runs its
kernel with bf16 matmul inputs on the TPU (`mlp_train.py:515-522`), and the
port is held against the XLA float32 path instead.  The backward takes the
forward's pooled pre-norm z3 (`zext`, saved for it); the forward computes
z3 with the backward's products in the same order, so the two agree bitwise
on every pool maximum.  The kernels take s <= 64 samples and widths with
c1 <= 64, c2 <= 128 (multiples of 8) and c3 a multiple of 8 up to 128, or
256 (`gn_mlp_train_dims_ok`), which `crop_mlp_train` checks before
launching.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from graspnet_tpu_torch.nn.layers import SharedMLP, Stats
from graspnet_tpu_torch.ops.cuda import build


def crop_mlp_train_plain(mlp: SharedMLP, grouped: torch.Tensor) -> Tuple[torch.Tensor, List[Stats]]:
    """(B, Ns, D, S, 3) -> pooled (B, Ns, D, C3) and per-layer
    {mean, unbiased var}: `SharedMLP.forward_train`, then the max over S."""
    out, stats = mlp.forward_train(grouped)
    return torch.amax(out, dim=3), stats


def _fn(name: str, npointers: int):
    """A launcher: `npointers` tensors, then (g, s, c1, c2, c3, eps, sm, stream)."""
    fn = getattr(build.load("mlp_train"), name)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * npointers
            + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _scratch(g: int, dims, sm: int, backward: bool, device) -> torch.Tensor:
    fn = build.load("mlp_train").gn_mlp_train_scratch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 7
        fn.restype = ctypes.c_size_t
    s, c1, c2, c3 = dims
    return torch.empty(fn(g, s, c1, c2, c3, sm, int(backward)), dtype=torch.float32, device=device)


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def dims_supported(s: int, c1: int, c2: int, c3: int) -> bool:
    """Whether the kernels take groups of s rows and widths (c1, c2, c3)."""
    fn = build.load("mlp_train").gn_mlp_train_dims_ok
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_int
    return bool(fn(s, c1, c2, c3))


def crop_mlp_train_backward(x, g_pooled, zext, w, gb, st, eps: float):
    """The backward kernels: (G, S, 3) rows, (G, C3) pooled cotangent, the
    forward's (G, C3) pooled pre-norm z3 (the max, or the min where gamma3 <
    0), the three kernels, [gamma; beta] and [mean; biased var] per layer ->
    (dW1, dW2, dW3), ([dgamma; dbeta] per layer)."""
    g, s, _ = x.shape
    c1, c2, c3 = (k.shape[1] for k in w)
    dw = [torch.empty_like(k) for k in w]
    dgb = [torch.empty_like(v) for v in gb]
    sm = _sm_count(x.device)
    scratch = _scratch(g, (s, c1, c2, c3), sm, True, x.device)
    with build.on_device(x.device) as stream:
        err = _fn("gn_mlp_train_bwd", 19)(
            x.data_ptr(), g_pooled.data_ptr(), zext.data_ptr(), w[0].data_ptr(), w[1].data_ptr(),
            w[2].data_ptr(), gb[0].data_ptr(), gb[1].data_ptr(), gb[2].data_ptr(),
            st[0].data_ptr(), st[1].data_ptr(), st[2].data_ptr(),
            dw[0].data_ptr(), dw[1].data_ptr(), dw[2].data_ptr(),
            dgb[0].data_ptr(), dgb[1].data_ptr(), dgb[2].data_ptr(), scratch.data_ptr(),
            g, s, c1, c2, c3, eps, sm, stream,
        )
    build.check(err, "mlp_train backward")
    build.count_launch(crop_mlp_train_backward)
    return dw, dgb


def _forward_kernel(x, w, gb, eps: float):
    """(G, S, 3) -> [mean; biased var] per layer, and the per-group max and
    min of the pre-norm z3, (G, C3) each."""
    g, s, _ = x.shape
    c1, c2, c3 = (k.shape[1] for k in w)
    st = [torch.empty((2, c), dtype=torch.float32, device=x.device) for c in (c1, c2, c3)]
    zmax = torch.empty((g, c3), dtype=torch.float32, device=x.device)
    zmin = torch.empty_like(zmax)
    sm = _sm_count(x.device)
    scratch = _scratch(g, (s, c1, c2, c3), sm, False, x.device)
    with build.on_device(x.device) as stream:
        err = _fn("gn_mlp_train_fwd", 12)(
            x.data_ptr(), w[0].data_ptr(), w[1].data_ptr(), w[2].data_ptr(),
            gb[0].data_ptr(), gb[1].data_ptr(), st[0].data_ptr(), st[1].data_ptr(),
            st[2].data_ptr(), zmax.data_ptr(), zmin.data_ptr(), scratch.data_ptr(),
            g, s, c1, c2, c3, eps, sm, stream,
        )
    build.check(err, "mlp_train forward")
    build.count_launch(crop_mlp_train)
    return st, zmax, zmin


class _CropMLPTrain(torch.autograd.Function):
    """pooled = relu(bn3(gamma3 >= 0 ? max z3 : min z3)) over each group of
    S samples (bn3 is monotone with the sign of gamma3, relu is monotone;
    `mlp_train.py:442-447`); neither the stats outputs nor the grouped
    offsets carry a gradient (`mlp_train.py:462-494`)."""

    @staticmethod
    def forward(ctx, grouped, eps, w1, s1, o1, w2, s2, o2, w3, s3, o3):
        lead = grouped.shape[:-2]
        x = grouped.reshape(-1, grouped.shape[-2], 3).contiguous()
        w = [k.contiguous() for k in (w1, w2, w3)]
        gb = [torch.stack([sc, of]).contiguous() for sc, of in ((s1, o1), (s2, o2), (s3, o3))]
        st, zmax, zmin = _forward_kernel(x, w, gb, eps)
        mean3, var3 = st[2][0], st[2][1]
        zext = torch.where(s3 >= 0.0, zmax, zmin)
        pooled = torch.relu((zext - mean3) * (torch.rsqrt(var3 + eps) * s3) + o3)
        ctx.save_for_backward(x, zext, *w, *gb, *st)
        ctx.eps = eps
        ctx.mark_non_differentiable(*st)
        return (pooled.reshape(*lead, -1), *st)

    @staticmethod
    def backward(ctx, g_pooled, *_g_stats):
        x, zext, w1, w2, w3, gb1, gb2, gb3, st1, st2, st3 = ctx.saved_tensors
        g = g_pooled.reshape(x.shape[0], -1).contiguous()
        dw, dgb = crop_mlp_train_backward(x, g, zext, (w1, w2, w3), (gb1, gb2, gb3), (st1, st2, st3), ctx.eps)
        out = [None, None]
        for k, v in zip(dw, dgb):
            out += [k, v[0], v[1]]
        return tuple(out)


def crop_mlp_train(mlp: SharedMLP, grouped: torch.Tensor) -> Tuple[torch.Tensor, List[Stats]]:
    """Batch-stats SharedMLP 3 -> c1 -> c2 -> c3 + max over samples.

    (B, Ns, D, S, 3) -> pooled (B, Ns, D, C3) and per-layer {mean, unbiased
    var} for the running-stat update.  CUDA tensor: the mlp_train.cu
    kernels; CPU tensor: `crop_mlp_train_plain`.  Gradients reach the
    kernels and the BN scale/offset; the grouped offsets are detached (the
    JAX kernel gives them a zero cotangent: in training they are label
    points and views, which carry no gradient)."""
    grouped = grouped.detach()
    if not grouped.is_cuda:
        return crop_mlp_train_plain(mlp, grouped)
    if len(mlp) != 3 or grouped.dtype != torch.float32 or grouped.shape[-1] != 3:
        raise ValueError("crop_mlp_train takes float32 (..., S, 3) rows and a 3-layer SharedMLP")
    dims = (grouped.shape[-2], *(layer.kernel.shape[1] for layer in mlp))
    if not dims_supported(*dims):
        raise ValueError(f"crop_mlp_train kernels do not take (s, c1, c2, c3) = {dims}")
    eps = mlp[0].bn.eps
    params = [p for layer in mlp for p in (layer.kernel, layer.bn.scale, layer.bn.offset)]
    pooled, *st = _CropMLPTrain.apply(grouped, eps, *params)
    n = grouped[..., 0].numel()
    unbiased = n / max(n - 1, 1)
    return pooled, [{"mean": s[0], "var": s[1] * unbiased} for s in st]


crop_mlp_train.launches = 0
crop_mlp_train_backward.launches = 0
