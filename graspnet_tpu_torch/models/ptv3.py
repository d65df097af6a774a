"""Point Transformer V3 (Wu, Jiang, Wang, Liu, Liu, Qiao, Ouyang, He, Zhao,
"Point Transformer V3: Simpler, Faster, Stronger", CVPR 2024) in eval
mode, for semantic segmentation.

The published code is Pointcept's `models/point_transformer_v3/
point_transformer_v3m1_base.py` (`PointTransformerV3`, `Block`,
`SerializedAttention`, `SerializedPooling`, `SerializedUnpooling`,
`Embedding`) with `models/utils/serialization/` (`z_order.py`,
`hilbert.py`) and the `DefaultSegmentorV2` head.  A batch is fragments of
different lengths concatenated; each point has its integer grid cell
(`grid_coord`), its fragment (`batch`) and 6 input channels.

  * Serialization (`serialize`): for each order of `cfg.order`, the code
    batch << 3d | curve(grid_coord), d the bit length of the batch's
    largest cell; "z" is the Morton interleave (bit i of x at 3i + 2, of y
    at 3i + 1, of z at 3i, OCNN's `xyz2key`), "hilbert" the 3-D Hilbert
    index of numpy-hilbert-curve's `encode` (Skilling's transform on the
    coordinates, then their interleave read as a Gray code), "-trans" the
    same with x and y swapped; `order` = argsort of the code, `inverse`
    its inverse.  A grid-sampled fragment holds one point a cell, so the
    codes are unique and each order is exact.  Pooling's clusters follow
    from the first order's codes alone (points whose code >> 3 agree), so
    every stage's points, orders, clusters and patches are computed
    before the network runs, with one host read of the stage's per-
    fragment counts a pooling.
  * Patches (`Patches`): each fragment of n > K points (K the stage's patch
    size) is padded to a multiple of K, the padding slots of its last
    patch repeating the points at the same places in the patch before it
    (`get_padding_and_inverse`); a fragment of n <= K points is one
    sequence of n.  A block's attention gathers its qkv rows by
    order[pad], runs `ops/cuda/attn.py::attention_varlen` over the
    sequences and scatters back by unpad[inverse], dropping the padding.
  * Neighbour maps (`kernel_maps`): the stem's 5^3 and each stage's 3^3 map
    (`ops/cuda/spconv.py::kernel_map`), the 3^3 one shared by the stage's
    encoder and decoder blocks (Pointcept's `indice_key` "stage{s}").
  * Embedding: SubMConv 5^3 (in -> C0, no bias), BatchNorm (eps 1e-3), GELU.
  * Block (pre-norm): x += LN(Linear(SubMConv 3^3(x))) (the conditional
    position encoding); x += Proj(attention(LN1(x))); x += W2 GELU(W1
    LN2(x)); the block at index l of its stage takes order l mod 4.
  * Pooling (stride 2): Linear, then the max over each cluster, BatchNorm,
    GELU; the cluster's cell is grid_coord >> 1 and its codes the codes
    >> 3.  Unpooling: BN GELU(Linear_skip(x_parent)) + (BN GELU(Linear(x)))
    [cluster].  Head: Linear(C -> classes) at every input point.

Departures: the published forward draws a random permutation of the four
orders at the embedding and at every pooling (`shuffle_orders`, in eval
too); here they are taken in `cfg.order`'s order, all four still computed
at every stage.  The published attention runs in half precision through
flash-attn; here in float32.  The points' mean coordinates, which the
published pooling carries along and no layer of this configuration reads
(no relative position encoding), are not computed.

Module names follow the published ones where they exist (`embedding`,
`enc.{s}.down`, `enc.{s}.blocks.{i}`, `dec.{s}.up`, `seg_head`) with the
port's leaves (`kernel` shaped (in, out), `bias`; BN and LayerNorm `scale`,
`offset`, BN `mean`, `var`); a convolution's kernel is (k^3 x C_in,
C_out), the rows of offset o (`spconv.offsets`' order) at o x C_in.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from graspnet_tpu_torch.config import PTv3Config
from graspnet_tpu_torch.models.groupfree import LayerNorm
from graspnet_tpu_torch.nn.layers import BatchNorm, Dense
from graspnet_tpu_torch.ops.cuda.attn import attention_varlen
from graspnet_tpu_torch.ops.cuda.spconv import kernel_map, subm_conv

MAX_DEPTH = 16  # bits an axis a code holds (Pointcept asserts the same)
POOL_SHIFT = 3  # stride 2: one bit an axis


# ---------------------------------------------------------------- the curves --

def _spread(v: torch.Tensor) -> torch.Tensor:
    """Bit i of v (< 2^16) to bit 3i."""
    v = v & 0xFFFF
    v = (v | (v << 16)) & 0x0000FF0000FF
    v = (v | (v << 8)) & 0x00F00F00F00F
    v = (v | (v << 4)) & 0x0C30C30C30C3
    return (v | (v << 2)) & 0x249249249249


def morton(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The Morton code: bit i of x at 3i + 2, of y at 3i + 1, of z at 3i."""
    return (_spread(x) << 2) | (_spread(y) << 1) | _spread(z)


def hilbert(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, depth: int) -> torch.Tensor:
    """numpy-hilbert-curve's 3-D `encode` of the `depth` low bits of each
    axis: Skilling's transform from the top bit down (where a level's bit
    of axis d is set, the lower bits of axis 0 are inverted; where it is
    clear, the lower bits of axes 0 and d are exchanged), the axes'
    interleave (axis 0 highest), then that word read as a Gray code."""
    a = [x.clone(), y.clone(), z.clone()]
    for p in range(depth - 1, -1, -1):
        low = (1 << p) - 1
        for d in range(3):
            bit = (a[d] >> p) & 1
            a[0] = a[0] ^ (bit * low)
            t = ((a[0] ^ a[d]) & low) * (1 - bit)
            a[d] = a[d] ^ t
            a[0] = a[0] ^ t
    g = morton(a[0], a[1], a[2])
    s = 1
    while s < 3 * depth:  # prefix xor from the top bit: Gray to binary
        g = g ^ (g >> s)
        s *= 2
    return g


def curve_codes(grid: torch.Tensor, orders: Sequence[str], depth: int) -> torch.Tensor:
    """(N, 3) int64 cells -> (len(orders), N) codes without the batch; the
    Hilbert orders in one pass over both coordinate permutations."""
    x, y, z = grid.unbind(1)
    hil = [o for o in orders if o.startswith("hilbert")]
    h = {}
    if hil:
        perm = [(y, x) if o == "hilbert-trans" else (x, y) for o in hil]
        out = hilbert(torch.cat([p[0] for p in perm]), torch.cat([p[1] for p in perm]),
                      torch.cat([z] * len(hil)), depth)
        h = dict(zip(hil, out.split(grid.shape[0])))
    codes = []
    for o in orders:
        if o == "z":
            codes.append(morton(x, y, z))
        elif o == "z-trans":
            codes.append(morton(y, x, z))
        elif o in h:
            codes.append(h[o])
        else:
            raise ValueError(f"no serialization order {o!r}")
    return torch.stack(codes)


# ---------------------------------------------------------- stages, patches --

@dataclasses.dataclass
class Patches:
    """A stage's attention sequences at one patch size: `gather` (orders, T)
    and `scatter` (orders, N) are each order's qkv rows (order[pad]) and
    output rows (unpad[inverse]); `starts` (S + 1,) int32."""

    gather: torch.Tensor
    scatter: torch.Tensor
    starts: torch.Tensor
    max_len: int

    @property
    def sequences(self) -> int:
        return self.starts.shape[0] - 1


@dataclasses.dataclass
class Stage:
    """One resolution's points: cells (N, 3) and fragments (N,) int32,
    sites a fragment (host), the code depth, the orders' codes, orders and
    inverses (orders, N) int64, `cluster` (N,) int64, each point's site at
    the next stage (None at the last), its 3^3 neighbour map and its
    patches."""

    grid: torch.Tensor
    batch: torch.Tensor
    counts: List[int]
    depth: int
    code: torch.Tensor
    order: torch.Tensor
    inverse: torch.Tensor
    cluster: Optional[torch.Tensor] = None
    kmap: Optional[torch.Tensor] = None
    patches: Optional[Patches] = None

    @property
    def n(self) -> int:
        return self.grid.shape[0]


def _orders(code: torch.Tensor):
    order = torch.argsort(code, dim=1)
    inverse = torch.empty_like(order)
    inverse.scatter_(1, order, torch.arange(code.shape[1], device=code.device).expand_as(order))
    return order, inverse


def depth_of(grid_max: int) -> int:
    """The code depth of a batch whose largest cell index is `grid_max`."""
    d = int(grid_max).bit_length()
    if d > MAX_DEPTH:
        raise ValueError(f"a cell index of {grid_max} needs {d} bits an axis; codes hold {MAX_DEPTH}")
    return d


def first_stage(grid: torch.Tensor, batch: torch.Tensor, counts: Sequence[int], depth: int,
                orders: Sequence[str]) -> Stage:
    code = curve_codes(grid.long(), orders, depth) | (batch.long() << (3 * depth))
    return Stage(grid, batch, list(counts), depth, code, *_orders(code))


def pool(stage: Stage) -> Stage:
    """Stride-2 pooling's next stage; sets `stage.cluster`.  The clusters
    are the runs of equal code >> 3 along the first order (they never
    cross fragments: the fragment sits in the code's top bits); one host
    read of the per-fragment cluster counts."""
    if stage.depth < 1:
        raise ValueError("a stage of code depth 0 cannot be pooled")
    n, dev = stage.n, stage.code.device
    parent = stage.code[0][stage.order[0]] >> POOL_SHIFT
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = parent[1:] != parent[:-1]
    run = torch.cumsum(head.long(), 0)  # cluster + 1, in sorted order
    ends = torch.tensor(_cumsum(stage.counts)[1:], device=dev) - 1
    total = run[ends].tolist()
    counts = [b - a for a, b in zip([0] + total[:-1], total)]
    m = total[-1]
    cluster_sorted = run - 1
    stage.cluster = torch.empty_like(cluster_sorted).scatter_(0, stage.order[0], cluster_sorted)
    first = torch.full((m,), n, dtype=torch.long, device=dev).scatter_reduce_(
        0, cluster_sorted, torch.arange(n, device=dev), "amin")
    heads = stage.order[0][first]
    code = stage.code[:, heads] >> POOL_SHIFT
    return Stage(stage.grid[heads] >> 1, stage.batch[heads], counts, stage.depth - 1, code, *_orders(code))


def _cumsum(xs: Sequence[int]) -> List[int]:
    out = [0]
    for x in xs:
        out.append(out[-1] + int(x))
    return out


def patches(stage: Stage, k: int) -> Patches:
    """Pointcept's `get_padding_and_inverse` at patch size `k`, for every
    order of the stage."""
    dev = stage.code.device
    counts = stage.counts
    padded = [c if c <= k else -(-c // k) * k for c in counts]
    off, opad = _cumsum(counts), _cumsum(padded)
    starts = []
    for c, a, b in zip(counts, opad[:-1], opad[1:]):
        starts += [a] if c <= k else list(range(a, b, k))
    starts.append(opad[-1])
    frags = torch.arange(len(counts), device=dev)
    t = opad[-1]
    frag = torch.repeat_interleave(frags, torch.tensor(padded, device=dev), output_size=t)
    j = torch.arange(t, device=dev) - torch.tensor(opad[:-1], device=dev)[frag]
    pad = torch.tensor(off[:-1], device=dev)[frag] + j - k * (j >= torch.tensor(counts, device=dev)[frag])
    shift = torch.tensor([p - o for p, o in zip(opad[:-1], off[:-1])], device=dev)
    frag_n = torch.repeat_interleave(frags, torch.tensor(counts, device=dev), output_size=stage.n)
    unpad = torch.arange(stage.n, device=dev) + shift[frag_n]
    max_len = max(min(c, k) for c in counts)
    return Patches(stage.order[:, pad], unpad[stage.inverse],
                   torch.tensor(starts, dtype=torch.int32, device=dev), max_len)


def serialize(grid: torch.Tensor, batch: torch.Tensor, counts: Sequence[int], depth: int,
              cfg: PTv3Config) -> List[Stage]:
    """Every stage's points, orders, clusters and patches for a batch: grid
    (N, 3) and batch (N,) int32 on the device, `counts` the fragments'
    lengths, `depth` the code depth (`depth_of`)."""
    stages = [first_stage(grid, batch, counts, depth, cfg.order)]
    for _ in range(cfg.num_stages - 1):
        stages.append(pool(stages[-1]))
    for s, st in enumerate(stages):
        st.patches = patches(st, cfg.enc_patch_size[s])
    return stages


def kernel_maps(stages: List[Stage], cfg: PTv3Config):
    """The stem's map, each stage's 3^3 map (into `stage.kmap`) and their
    hits together, a one-element int64 tensor on the device."""
    stem, hits = kernel_map(stages[0].grid, stages[0].batch, cfg.stem_kernel)
    for st in stages:
        st.kmap, h = kernel_map(st.grid, st.batch, cfg.cpe_kernel)
        hits = hits + h
    return stem, hits


# ------------------------------------------------------------------ modules --

class SubMConv(nn.Module):
    """A submanifold convolution: `kernel` (k^3 x C_in, C_out), `bias`."""

    def __init__(self, c_in: int, c_out: int, k: int, use_bias: bool):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(k ** 3 * c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out)) if use_bias else None

    def forward(self, x: torch.Tensor, kmap: torch.Tensor) -> torch.Tensor:
        return subm_conv(x, kmap, self.kernel, self.bias)


class Embedding(nn.Module):
    def __init__(self, cfg: PTv3Config):
        super().__init__()
        self.conv = SubMConv(cfg.in_channels, cfg.enc_channels[0], cfg.stem_kernel, False)
        self.norm = BatchNorm(cfg.enc_channels[0], cfg.bn_eps)

    def forward(self, x: torch.Tensor, kmap: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.norm(self.conv(x, kmap)))


class Block(nn.Module):
    def __init__(self, c: int, heads: int, cfg: PTv3Config):
        super().__init__()
        self.heads = heads
        self.cpe_conv = SubMConv(c, c, cfg.cpe_kernel, True)
        self.cpe_linear = Dense(c, c)
        self.cpe_norm = LayerNorm(c, cfg.ln_eps)
        self.norm1 = LayerNorm(c, cfg.ln_eps)
        self.qkv = Dense(c, 3 * c, use_bias=cfg.qkv_bias)
        self.proj = Dense(c, c)
        self.norm2 = LayerNorm(c, cfg.ln_eps)
        self.fc1 = Dense(c, c * cfg.mlp_ratio)
        self.fc2 = Dense(c * cfg.mlp_ratio, c)

    def forward(self, x: torch.Tensor, kmap: torch.Tensor, p: Patches, o: int) -> torch.Tensor:
        x = x + self.cpe_norm(self.cpe_linear(self.cpe_conv(x, kmap)))
        qkv = self.qkv(self.norm1(x))[p.gather[o]]
        x = x + self.proj(attention_varlen(qkv, p.starts, self.heads, p.max_len)[p.scatter[o]])
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class Pooling(nn.Module):
    def __init__(self, c_in: int, c_out: int, eps: float):
        super().__init__()
        self.proj = Dense(c_in, c_out)
        self.norm = BatchNorm(c_out, eps)

    def forward(self, x: torch.Tensor, cluster: torch.Tensor, m: int) -> torch.Tensor:
        y = self.proj(x)
        out = y.new_full((m, y.shape[1]), float("-inf")).scatter_reduce_(0, cluster[:, None].expand_as(y), y, "amax")
        return F.gelu(self.norm(out))


class Unpooling(nn.Module):
    def __init__(self, c_in: int, c_skip: int, c_out: int, eps: float):
        super().__init__()
        self.proj = Dense(c_in, c_out)
        self.proj_norm = BatchNorm(c_out, eps)
        self.skip = Dense(c_skip, c_out)
        self.skip_norm = BatchNorm(c_out, eps)

    def forward(self, x: torch.Tensor, parent: torch.Tensor, cluster: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.skip_norm(self.skip(parent))) + F.gelu(self.proj_norm(self.proj(x)))[cluster]


class EncoderStage(nn.Module):
    def __init__(self, cfg: PTv3Config, s: int):
        super().__init__()
        c = cfg.enc_channels[s]
        self.down = Pooling(cfg.enc_channels[s - 1], c, cfg.bn_eps) if s > 0 else None
        self.blocks = nn.ModuleList(Block(c, cfg.enc_num_head[s], cfg) for _ in range(cfg.enc_depths[s]))


class DecoderStage(nn.Module):
    def __init__(self, cfg: PTv3Config, s: int):
        super().__init__()
        c_in = cfg.dec_channels[s + 1] if s + 1 < len(cfg.dec_channels) else cfg.enc_channels[-1]
        c = cfg.dec_channels[s]
        self.up = Unpooling(c_in, cfg.enc_channels[s], c, cfg.bn_eps)
        self.blocks = nn.ModuleList(Block(c, cfg.dec_num_head[s], cfg) for _ in range(cfg.dec_depths[s]))


class PTv3(nn.Module):
    """The backbone and the segmentation head."""

    def __init__(self, cfg: PTv3Config):
        super().__init__()
        if any(e != d for e, d in zip(cfg.enc_patch_size, cfg.dec_patch_size)):
            raise ValueError("a stage's encoder and decoder blocks share its patches: one patch size a stage")
        self.cfg = cfg
        self.embedding = Embedding(cfg)
        self.enc = nn.ModuleList(EncoderStage(cfg, s) for s in range(cfg.num_stages))
        self.dec = nn.ModuleList(DecoderStage(cfg, s) for s in range(cfg.num_stages - 1))
        self.seg_head = Dense(cfg.dec_channels[0], cfg.num_classes)

    def forward(self, feat: torch.Tensor, stages: List[Stage], stem: torch.Tensor) -> torch.Tensor:
        """(N, in_channels) features, `serialize`'s stages with their maps,
        the stem's map -> (N, num_classes) logits."""
        orders = len(self.cfg.order)
        x = self.embedding(feat, stem)
        skips = []
        for s, stage in enumerate(self.enc):
            st = stages[s]
            if stage.down is not None:
                x = stage.down(x, stages[s - 1].cluster, st.n)
            for i, blk in enumerate(stage.blocks):
                x = blk(x, st.kmap, st.patches, i % orders)
            skips.append(x)
        for s in reversed(range(len(self.dec))):
            stage, st = self.dec[s], stages[s]
            x = stage.up(x, skips[s], st.cluster)
            for i, blk in enumerate(stage.blocks):
                x = blk(x, st.kmap, st.patches, i % orders)
        return self.seg_head(x)
