"""Submanifold sparse convolution on a voxel grid (`csrc/spconv.cu`) and
its plain versions.

No TPU counterpart: the JAX package has no sparse convolution.  Point
Transformer V3 (`models/ptv3.py`) runs one 5^3 convolution at its stem and
a 3^3 one at the start of every block (the conditional position encoding).
A site is a point of a grid-sampled batch: its batch index and its integer
grid cell (x, y, z), each in [0, 65535]; no two sites of one batch share a
cell.  The k^3 offsets o = (dx, dy, dz), each in -r..r (r = k // 2), run
with dx slowest and dz fastest (`offsets`).

  * `kernel_map(grid, batch, k)`: the neighbour map, an (N, k^3) int32
    array whose entry (i, o) is the site of i's batch at grid_i + o, or -1
    where there is none; and its hits (the entries >= 0) as a one-element
    int64 tensor on the device (read when the caller wants it).  On the
    card `kmap_kernel` hashes the sites into an open-addressing table and
    looks every offset up; the map is exact, so it equals
    `kernel_map_plain` (sort and `searchsorted`) element for element.
  * `subm_conv(x, kmap, kernel, bias)`: y_i = bias + sum over o of
    x_{kmap(i, o)} @ W_o, absent neighbours adding nothing; `kernel` is
    (k^3 x C_in, C_out), the rows of offset o at o x C_in.  On the card
    `subm_conv_kernel` gathers the input rows through the map into shared
    memory tile by tile and multiplies there; it sums the offsets and
    channels in one fixed order, so a run is bitwise the next, and
    another order than `subm_conv_plain` (one gather and product an
    offset), to which it agrees within float32 rounding.

CPU tensors take the plain versions.  A CUDA tensor outside a kernel's
domain raises ValueError; there is no fallback.  The library is built and
loaded at the first call on the card (`build.LAZY`).  No gradients.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from graspnet_tpu_torch.ops.cuda import build

LIBRARY = "spconv"
KERNEL_SIZES = (3, 5)  # the map kernel's: the blocks' and the stem's
AXIS = 1 << 16  # cells an axis a key holds
MAX_BATCH = 1 << 15

_P, _I = ctypes.c_void_p, ctypes.c_int


def offsets(k: int, device=None) -> torch.Tensor:
    """(k^3, 3) int64: the offsets of a k^3 kernel, dx slowest, dz fastest."""
    r = torch.arange(-(k // 2), k // 2 + 1, device=device)
    dx, dy, dz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1), dz.reshape(-1)], dim=1)


def _keys(grid: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    g = grid.long()
    return ((batch.long() * AXIS + g[:, 0]) * AXIS + g[:, 1]) * AXIS + g[:, 2]


def kernel_map_plain(grid: torch.Tensor, batch: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`kernel_map` in plain torch: the sites' keys sorted once, each
    offset's neighbours found by `searchsorted`."""
    n = grid.shape[0]
    out = torch.full((n, k ** 3), -1, dtype=torch.int32, device=grid.device)
    if n == 0:
        return out, torch.zeros(1, dtype=torch.int64, device=grid.device)
    keys, perm = torch.sort(_keys(grid, batch))
    g = grid.long()
    for j, o in enumerate(offsets(k, grid.device)):
        q = g + o
        inside = ((q >= 0) & (q < AXIS)).all(dim=1)
        qk = _keys(q.clamp(0, AXIS - 1), batch)
        pos = torch.searchsorted(keys, qk).clamp(max=n - 1)
        hit = inside & (keys[pos] == qk)
        out[:, j] = torch.where(hit, perm[pos], -1).to(torch.int32)
    return out, (out >= 0).sum().reshape(1)


def subm_conv_plain(x: torch.Tensor, kmap: torch.Tensor, kernel: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """`subm_conv` in plain torch: for each offset in order, the rows at the
    map's entries (a zero row where there is none) times W_o, summed."""
    n, c_in = x.shape
    k3 = kmap.shape[1]
    w = kernel.reshape(k3, c_in, -1)
    rows = torch.cat([x, x.new_zeros(1, c_in)])  # row n: an absent neighbour
    idx = torch.where(kmap >= 0, kmap.long(), n)
    y = torch.zeros((n, w.shape[2]), dtype=x.dtype, device=x.device)
    for o in range(k3):
        y = y + torch.matmul(rows[idx[:, o]], w[o])
    return y if bias is None else y + bias


def _fn(name: str, argtypes):
    fn = getattr(build.load(LIBRARY), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def kernel_map(grid: torch.Tensor, batch: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 3) grid cells and (N,) batch indices -> the (N, k^3) int32
    neighbour map and its hit count (a one-element int64 tensor).  CUDA:
    `kmap_kernel` (int32 inputs, k 3 or 5; the caller keeps every cell in
    [0, 65535] and the batch below 32768); CPU: `kernel_map_plain`."""
    if not grid.is_cuda:
        return kernel_map_plain(grid, batch, k)
    n = grid.shape[0]
    ok = (grid.dtype == torch.int32 and batch.dtype == torch.int32 and grid.dim() == 2 and grid.shape[1] == 3
          and batch.shape == (n,) and batch.is_cuda and grid.device == batch.device and k in KERNEL_SIZES
          and n < (1 << 30))
    if not ok:
        raise ValueError(f"kernel_map takes int32 CUDA (N, 3) cells and (N,) batch indices on one device and k "
                         f"in {KERNEL_SIZES}")
    grid, batch = grid.contiguous(), batch.contiguous()
    out = torch.empty((n, k ** 3), dtype=torch.int32, device=grid.device)
    hits = torch.zeros(1, dtype=torch.int64, device=grid.device)
    if n == 0:
        return out, hits
    slots = 64
    while slots < 2 * n:
        slots *= 2
    table_keys = torch.full((slots,), -1, dtype=torch.int64, device=grid.device)  # every bit set: empty
    table_vals = torch.full((slots,), 2**31 - 1, dtype=torch.int32, device=grid.device)
    fn = _fn("gn_kernel_map", [_P, _P, _I, _I, _P, _P, _I, _P, _P, _P])
    with build.on_device(grid.device) as stream:
        err = fn(grid.data_ptr(), batch.data_ptr(), n, k, table_keys.data_ptr(), table_vals.data_ptr(), slots,
                 out.data_ptr(), hits.data_ptr(), stream)
    build.check(err, "kernel_map")
    build.count_launch(kernel_map)
    return out, hits


def subm_conv(x: torch.Tensor, kmap: torch.Tensor, kernel: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, C_in) features, the (N, k^3) map, the (k^3 x C_in, C_out)
    kernel and an optional (C_out,) bias -> (N, C_out).  CUDA:
    `subm_conv_kernel` (float32, C_out a multiple of 4); CPU:
    `subm_conv_plain`."""
    if not x.is_cuda:
        return subm_conv_plain(x, kmap, kernel, bias)
    n = x.shape[0]
    ok = (x.dtype == kernel.dtype == torch.float32 and kmap.dtype == torch.int32 and x.dim() == kmap.dim() == 2
          and kernel.dim() == 2 and kmap.shape[0] == n and x.shape[1] >= 1
          and kernel.shape[0] == kmap.shape[1] * x.shape[1] and kernel.shape[1] % 4 == 0
          and kmap.is_cuda and kernel.is_cuda and x.device == kmap.device == kernel.device
          and (bias is None or (bias.dtype == torch.float32 and bias.shape == (kernel.shape[1],)
                                and bias.device == x.device)))
    if not ok:
        raise ValueError("subm_conv takes float32 CUDA (N, C_in) features, an (N, k^3) int32 map, a "
                         "(k^3 x C_in, C_out) kernel with C_out a multiple of 4 and a (C_out,) bias on one device")
    x, kmap, kernel = x.detach().contiguous(), kmap.contiguous(), kernel.detach().contiguous()
    if bias is not None:
        bias = bias.detach().contiguous()
    c_out = kernel.shape[1]
    out = torch.empty((n, c_out), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    fn = _fn("gn_subm_conv", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
    with build.on_device(x.device) as stream:
        err = fn(x.data_ptr(), kmap.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(),
                 out.data_ptr(), n, x.shape[1], c_out, kmap.shape[1], stream)
    build.check(err, "subm_conv")
    build.count_launch(subm_conv)
    return out


kernel_map.launches = 0
subm_conv.launches = 0
