"""Fused float32 multi-head attention (`csrc/attn.cu`) and its plain versions.

No TPU counterpart: the JAX package has no attention.  Group-Free-3D's
decoder (`models/groupfree.py`) calls `attention` twice a layer, 24 times a
forward at the published 12 layers: self-attention of the queries and
cross-attention to the seeds, 8 heads of 36 channels.  Point Transformer
V3's serialized attention (`models/ptv3.py`) calls `attention_varlen` once
a block: self-attention within each patch of a packed (T, 3C) qkv, heads of
16, the patches given by int32 sequence starts (flash-attn's `cu_seqlens`).
`attention_plain` and `attention_varlen_plain` are the same functions in
plain torch (per head a matmul of the scores, a softmax, a matmul with the
values; per sequence for the variable-length one); the CPU takes them.

On the card both launch `attn_fwd_kernel` (the head width a template
parameter: 36 for the dense entry, 16 for the variable-length one), which
keeps the scores in registers (see the note in the source for what bounds
it and how the design meets that) and sums in another order than the plain
versions: the two agree to float32 rounding, not bitwise.  Each entry
counts its launches (`attention.launches`, `attention_varlen.launches`).
The library is built and loaded at the first call on the card, so a
process that never runs the model never builds or loads it
(`build.SOURCES` leaves it out).  A CUDA
tensor outside the kernel's domain raises ValueError; there is no
fallback.  Like the other eval kernels it carries no gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

from graspnet_tpu_torch.ops.cuda import build

HEAD_DIM = 36  # the dense entry's head width (Group-Free-3D's)
VARLEN_HEAD_DIM = 16  # the variable-length entry's (Point Transformer V3's)
LIBRARY = "attn"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, Lq, E), (B, Lk, E), (B, Lk, E) -> (B, Lq, E): for each head h
    (channels h d .. h d + d - 1, d = E / heads), softmax(q_h k_h^T /
    sqrt(d)) v_h, the heads side by side as they came."""
    b, lq, e = q.shape
    lk, d = k.shape[1], e // heads
    qh = q.reshape(b, lq, heads, d).transpose(1, 2)
    kh = k.reshape(b, lk, heads, d).transpose(1, 2)
    vh = v.reshape(b, lk, heads, d).transpose(1, 2)
    w = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(d), dim=-1)
    return torch.matmul(w, vh).transpose(1, 2).reshape(b, lq, e)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """`t` as the kernel reads it: channels contiguous, row and batch
    strides multiples of 4 floats and a 16-byte aligned base (views into a
    packed projection already are); else a contiguous copy."""
    if t.stride(-1) != 1 or t.stride(1) % 4 or t.stride(0) % 4 or t.data_ptr() % 16:
        t = t.contiguous()
    return t


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Multi-head attention, (B, Lq, E), (B, Lk, E), (B, Lk, E) -> (B, Lq, E)
    contiguous; the operands may be views into packed projections.  CUDA
    tensors: `attn_fwd_kernel` (head width 36, Lk >= 1); CPU tensors:
    `attention_plain`."""
    if not q.is_cuda:
        return attention_plain(q, k, v, heads)
    ok = (
        all(t.dtype == torch.float32 and t.is_cuda and t.dim() == 3 for t in (q, k, v))
        and heads >= 1
        and q.shape[-1] == heads * HEAD_DIM
        and k.shape == v.shape
        and k.shape[0] == q.shape[0]
        and k.shape[-1] == q.shape[-1]
        and k.shape[1] >= 1
        and q.device == k.device == v.device
    )
    if not ok:
        raise ValueError(f"attention takes float32 CUDA (B, Lq, H x {HEAD_DIM}) queries and (B, Lk >= 1, H x "
                         f"{HEAD_DIM}) keys and values on one device")
    q, k, v = (_rows(t.detach()) for t in (q, k, v))
    b, lq, e = q.shape
    out = torch.empty((b, lq, e), dtype=torch.float32, device=q.device)
    fn = getattr(build.load(LIBRARY), "gn_attention")
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _I, _I, _I, _I, _I, _P]
        fn.restype = ctypes.c_int
    with build.on_device(q.device) as stream:
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.stride(0), q.stride(1), k.stride(0),
                 k.stride(1), v.stride(0), v.stride(1), b, lq, k.shape[1], heads, HEAD_DIM, stream)
    build.check(err, "attention")
    build.count_launch(attention)
    return out


def attention_varlen_plain(qkv: torch.Tensor, starts: torch.Tensor, heads: int) -> torch.Tensor:
    """`attention_varlen` in plain torch: `attention_plain` on each
    sequence (`starts` read on the host)."""
    c = qkv.shape[1] // 3
    out = qkv.new_empty((qkv.shape[0], c))
    bounds = starts.tolist()
    for a, b in zip(bounds[:-1], bounds[1:]):
        s = qkv[a:b][None]
        out[a:b] = attention_plain(s[..., :c], s[..., c: 2 * c], s[..., 2 * c:], heads)[0]
    return out


def attention_varlen(qkv: torch.Tensor, starts: torch.Tensor, heads: int, max_len: int) -> torch.Tensor:
    """Self-attention within sequences of packed rows: qkv (T, 3C) (the
    query, key and value projections side by side, heads of C / heads
    channels in each), `starts` (S + 1,) int32, sequence s the rows
    starts[s] .. starts[s + 1] - 1, each 1 to `max_len` long, the last
    start T -> (T, C) contiguous.  CUDA tensors: `attn_fwd_kernel` (head
    width 16); CPU tensors: `attention_varlen_plain`."""
    if not qkv.is_cuda:
        return attention_varlen_plain(qkv, starts, heads)
    t, c3 = qkv.shape if qkv.dim() == 2 else (0, 0)
    ok = (qkv.dtype == torch.float32 and qkv.dim() == 2 and c3 == 3 * heads * VARLEN_HEAD_DIM and heads >= 1
          and starts.dtype == torch.int32 and starts.dim() == 1 and starts.shape[0] >= 1 and starts.is_cuda
          and starts.device == qkv.device and max_len >= 1)
    if not ok:
        raise ValueError("attention_varlen takes float32 CUDA (T, 3 x H x 16) rows and (S + 1,) int32 sequence "
                         "starts on one device")
    qkv, starts = qkv.detach(), starts.contiguous()
    if qkv.stride(0) % 4 or qkv.stride(1) != 1 or qkv.data_ptr() % 16:
        qkv = qkv.contiguous()
    out = torch.empty((t, c3 // 3), dtype=torch.float32, device=qkv.device)
    fn = getattr(build.load(LIBRARY), "gn_attention_varlen")
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _L, _I, _I, _I, _I, _P]
        fn.restype = ctypes.c_int
    with build.on_device(qkv.device) as stream:
        err = fn(qkv.data_ptr(), starts.data_ptr(), out.data_ptr(), qkv.stride(0), starts.shape[0] - 1, max_len,
                 heads, VARLEN_HEAD_DIM, stream)
    build.check(err, "attention_varlen")
    build.count_launch(attention_varlen)
    return out


attention.launches = 0
attention_varlen.launches = 0
