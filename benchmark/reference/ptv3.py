"""The plain reference of Point Transformer V3 (ScanNet semantic
segmentation, Pointcept's `semseg-pt-v3m1-0-base`) for the segmentation
cell: plain float32 torch, written from the published code
(`point_transformer_v3m1_base.py`, `serialization/{default,z_order,
hilbert}.py`) and independent of the program.

  * the curves as integer loops: OCNN's `xyz2key` bit by bit (bit i of x at
    3i + 2, of y at 3i + 1, of z at 3i) and numpy-hilbert-curve's `encode`
    on arrays of bits (most significant first), its Gray code undone by a
    running parity; "-trans" swaps x and y; the fragment in the code's top
    bits above 3d, d the bit length of the batch's largest cell;
  * pooling as `SerializedPooling` does it: `unique` of the first order's
    code >> 3 (sorted, with the inverse and the counts), the clusters'
    head points, their codes >> 3 re-sorted, cells >> 1; the features'
    max over each cluster by `scatter_reduce` into zeros, the zeros left out;
  * the padding loop of `get_padding_and_inverse`, fragment by fragment;
  * the neighbour map by sort and `searchsorted` over keys of a dense
    (fragment, x, y, z) numbering; SubMConv as one gather and product an
    offset (offsets dx slowest, dz fastest);
  * attention written out per sequence: the scores, softmax and weighted
    sum of each head; on the card, sequences of one length go in blocks
    of at most ~2^28 scores, so that a block fits;
  * LayerNorm, BatchNorm (running statistics), GELU and Linear by
    `torch.nn.functional`.

Departures from the published forward (the program's too): the four
orders in their configured order at every stage (the published forward
draws a permutation, `shuffle_orders`, in eval too); attention in float32
(published: half precision through flash-attn); the pooled points' mean
coordinates, which no layer reads here, are not computed.

The weights are a state dict by name (`kernel` (in, out), `bias`, norms'
`scale`, `offset`, BN `mean`, `var`; a convolution's kernel (k^3 x C_in,
C_out), the rows of offset o at o x C_in).  `state_shapes` derives every
name and shape from the configuration's widths alone (the channels, the
MLP ratio, `qkv_bias`, the kernel sizes, which layers carry a bias), and
`PTv3` takes weights only when their names and shapes are exactly those.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

SCORE_BLOCK = 1 << 28  # scores a block of sequences may hold on the card


@dataclasses.dataclass(frozen=True)
class Config:
    """The sizes the reference reads, from the configuration file's
    `model`; pooling is by stride 2 between every two stages."""

    in_channels: int
    num_classes: int
    order: tuple
    enc_depths: tuple
    enc_channels: tuple
    enc_num_head: tuple
    enc_patch_size: tuple
    dec_depths: tuple
    dec_channels: tuple
    dec_num_head: tuple
    dec_patch_size: tuple
    mlp_ratio: int
    qkv_bias: bool
    stem_kernel: int
    cpe_kernel: int
    bn_eps: float
    ln_eps: float
    stride: tuple = (2, 2, 2, 2)

    def __post_init__(self):
        if tuple(self.stride) != (2,) * (len(self.enc_depths) - 1):
            raise ValueError(f"the reference pools by stride 2 between every two stages, not {self.stride}")

    @staticmethod
    def from_fields(fields: dict) -> "Config":
        names = {f.name for f in dataclasses.fields(Config)}
        return Config(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items() if k in names})


def state_shapes(cfg: Config) -> Dict[str, Tuple[int, ...]]:
    """Every weight's name and shape, from the configuration's widths:
    the stem's SubMConv (no bias) and BatchNorm; each encoder stage's
    pooling Linear and BatchNorm (but the first stage's) and blocks; each
    decoder stage's unpooling (a Linear and BatchNorm on the coarse
    features, another on the skip) and blocks; the head."""
    out: Dict[str, Tuple[int, ...]] = {}

    def linear(name, c_in, c_out, bias=True):
        out[name + ".kernel"] = (c_in, c_out)
        if bias:
            out[name + ".bias"] = (c_out,)

    def norm(name, c, bn=False):
        out.update({name + ".scale": (c,), name + ".offset": (c,)})
        if bn:
            out.update({name + ".mean": (c,), name + ".var": (c,)})

    def block(name, c):
        linear(name + ".cpe_conv", cfg.cpe_kernel ** 3 * c, c)
        linear(name + ".cpe_linear", c, c)
        norm(name + ".cpe_norm", c)
        norm(name + ".norm1", c)
        linear(name + ".qkv", c, 3 * c, cfg.qkv_bias)
        linear(name + ".proj", c, c)
        norm(name + ".norm2", c)
        linear(name + ".fc1", c, c * cfg.mlp_ratio)
        linear(name + ".fc2", c * cfg.mlp_ratio, c)

    enc, dec = cfg.enc_channels, cfg.dec_channels
    linear("embedding.conv", cfg.stem_kernel ** 3 * cfg.in_channels, enc[0], False)
    norm("embedding.norm", enc[0], bn=True)
    for s, c in enumerate(enc):
        if s > 0:
            linear(f"enc.{s}.down.proj", enc[s - 1], c)
            norm(f"enc.{s}.down.norm", c, bn=True)
        for i in range(cfg.enc_depths[s]):
            block(f"enc.{s}.blocks.{i}", c)
    for s, c in enumerate(dec):
        c_in = dec[s + 1] if s + 1 < len(dec) else enc[-1]
        linear(f"dec.{s}.up.proj", c_in, c)
        norm(f"dec.{s}.up.proj_norm", c, bn=True)
        linear(f"dec.{s}.up.skip", enc[s], c)
        norm(f"dec.{s}.up.skip_norm", c, bn=True)
        for i in range(cfg.dec_depths[s]):
            block(f"dec.{s}.blocks.{i}", c)
    linear("seg_head", dec[0], cfg.num_classes)
    return out


# ---------------------------------------------------------------- the curves --

def z_order(x, y, z, depth: int) -> torch.Tensor:
    key = torch.zeros_like(x)
    for i in range(depth):
        key = key | (((x >> i) & 1) << (3 * i + 2)) | (((y >> i) & 1) << (3 * i + 1)) | (((z >> i) & 1) << (3 * i))
    return key


def hilbert(locs: torch.Tensor, depth: int) -> torch.Tensor:
    """numpy-hilbert-curve's `encode` of (N, 3) cells at `depth` bits."""
    shifts = torch.arange(depth - 1, -1, -1, device=locs.device)
    gray = ((locs[:, :, None] >> shifts) & 1).bool()  # (N, 3, depth), most significant bit first
    for bit in range(depth):
        for dim in range(3):
            mask = gray[:, dim, bit].clone()
            gray[:, 0, bit + 1:] ^= mask[:, None]
            to_flip = ~mask[:, None] & (gray[:, 0, bit + 1:] ^ gray[:, dim, bit + 1:])
            gray[:, dim, bit + 1:] ^= to_flip
            gray[:, 0, bit + 1:] ^= to_flip
    bits = gray.transpose(1, 2).reshape(locs.shape[0], 3 * depth).long()
    binary = torch.cumsum(bits, dim=1) % 2  # undo the Gray code: a running parity from the top bit
    weights = 1 << torch.arange(3 * depth - 1, -1, -1, device=locs.device)
    return (binary * weights).sum(dim=1)


def encode(grid: torch.Tensor, batch: torch.Tensor, depth: int, order: str) -> torch.Tensor:
    g = grid.long()
    if order.endswith("-trans"):
        g = g[:, [1, 0, 2]]
    if order.startswith("z"):
        code = z_order(g[:, 0], g[:, 1], g[:, 2], depth)
    elif order.startswith("hilbert"):
        code = hilbert(g, depth)
    else:
        raise ValueError(order)
    return batch.long() << (3 * depth) | code


def inverse_of(order: torch.Tensor) -> torch.Tensor:
    inv = torch.zeros_like(order)
    return inv.scatter_(1, order, torch.arange(order.shape[1], device=order.device).repeat(order.shape[0], 1))


# --------------------------------------------------------- the point stages --

def serialize(grid: torch.Tensor, batch: torch.Tensor, cfg: Config) -> List[dict]:
    """Every stage's cells, fragments, codes, orders, inverses and (but the
    last) clusters and cluster counts."""
    depth = int(grid.max()).bit_length()
    code = torch.stack([encode(grid, batch, depth, o) for o in cfg.order])
    order = torch.argsort(code)
    stages = [dict(grid=grid.long(), batch=batch.long(), code=code, order=order, inverse=inverse_of(order))]
    for _ in range(len(cfg.enc_depths) - 1):
        st = stages[-1]
        code = st["code"] >> 3
        _, cluster, counts = torch.unique(code[0], sorted=True, return_inverse=True, return_counts=True)
        _, indices = torch.sort(cluster, stable=True)
        idx_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, dim=0)])
        head = indices[idx_ptr[:-1]]
        st["cluster"] = cluster
        code = code[:, head]
        order = torch.argsort(code)
        stages.append(dict(grid=st["grid"][head] >> 1, batch=st["batch"][head], code=code, order=order,
                           inverse=inverse_of(order)))
    return stages


def padding(batch: torch.Tensor, k: int):
    """`get_padding_and_inverse`: (pad, unpad, cu_seqlens) of sorted points
    whose fragments are `batch` (sorted)."""
    bincount = torch.bincount(batch)
    offset = torch.cumsum(bincount, dim=0)
    bincount_pad = torch.div(bincount + k - 1, k, rounding_mode="trunc") * k
    mask_pad = bincount > k
    bincount_pad = ~mask_pad * bincount + mask_pad * bincount_pad
    _offset = F.pad(offset, (1, 0))
    _offset_pad = F.pad(torch.cumsum(bincount_pad, dim=0), (1, 0))
    pad = torch.arange(_offset_pad[-1], device=batch.device)
    unpad = torch.arange(_offset[-1], device=batch.device)
    cu_seqlens = []
    for i in range(len(offset)):
        unpad[_offset[i]: _offset[i + 1]] += _offset_pad[i] - _offset[i]
        if bincount[i] != bincount_pad[i]:
            pad[_offset_pad[i + 1] - k + (bincount[i] % k): _offset_pad[i + 1]] = \
                pad[_offset_pad[i + 1] - 2 * k + (bincount[i] % k): _offset_pad[i + 1] - k]
        pad[_offset_pad[i]: _offset_pad[i + 1]] -= _offset_pad[i] - _offset[i]
        cu_seqlens.append(torch.arange(_offset_pad[i], _offset_pad[i + 1], step=k, dtype=torch.int64,
                                       device=batch.device))
    return pad, unpad, torch.cat(cu_seqlens + [_offset_pad[-1:]]).tolist()


def neighbour_map(grid: torch.Tensor, batch: torch.Tensor, k: int) -> torch.Tensor:
    """(N, k^3) int64: the site at grid + offset in the same fragment, -1
    where none; offsets dx slowest, dz fastest."""
    r = k // 2
    ext = int(grid.max()) + 2 * r + 1
    g = grid + r  # every neighbour's index >= 0

    def key(c):
        return ((batch * ext + c[:, 0]) * ext + c[:, 1]) * ext + c[:, 2]

    keys, perm = torch.sort(key(g))
    cols = []
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            for dz in range(-r, r + 1):
                q = key(g + torch.tensor([dx, dy, dz], device=g.device))
                pos = torch.searchsorted(keys, q).clamp(max=len(keys) - 1)
                cols.append(torch.where(keys[pos] == q, perm[pos], -1))
    return torch.stack(cols, dim=1)


# ------------------------------------------------------------------- layers --

def subm_conv(x: torch.Tensor, nmap: torch.Tensor, kernel: torch.Tensor, bias) -> torch.Tensor:
    """SubMConv: for each offset, the rows of the sites the map finds times
    that offset's (C_in, C_out) block of the kernel, added where found."""
    k3 = nmap.shape[1]
    weight = kernel.reshape(k3, x.shape[1], -1)
    y = torch.zeros((x.shape[0], weight.shape[2]), device=x.device)
    for o in range(k3):
        idx = nmap[:, o]
        hit = idx >= 0
        y[hit] += x[idx[hit]] @ weight[o]
    return y if bias is None else y + bias


def attention(qkv: torch.Tensor, cu: Sequence[int], heads: int) -> torch.Tensor:
    """Each sequence's multi-head self-attention, the rows cu[s] ..
    cu[s + 1] - 1 of the packed (T, 3C) qkv -> (T, C)."""
    c = qkv.shape[1] // 3
    d = c // heads
    out = torch.empty((qkv.shape[0], c), device=qkv.device)
    lens = [b - a for a, b in zip(cu[:-1], cu[1:])]
    s = 0
    while s < len(lens):  # a block: consecutive sequences of one length
        length = lens[s]
        per = max(1, SCORE_BLOCK // (heads * length * length))
        e = s
        while e < len(lens) and e - s < per and lens[e] == length:
            e += 1
        rows = qkv[cu[s]: cu[e]].reshape(e - s, length, 3, heads, d)
        q, k, v = (rows[:, :, i].transpose(1, 2) for i in range(3))  # (S, H, L, d)
        attn = torch.softmax((q * d ** -0.5) @ k.transpose(-1, -2), dim=-1)
        out[cu[s]: cu[e]] = (attn @ v).transpose(1, 2).reshape(-1, c)
        s = e
    return out


class PTv3:
    """The reference model with the benchmark's weights on `device`; the
    weights' names and shapes must be `state_shapes(cfg)`'s exactly."""

    def __init__(self, cfg: Config, weights: Dict[str, torch.Tensor], device):
        want = state_shapes(cfg)
        got = {k: tuple(v.shape) for k, v in weights.items()}
        if got != want:
            wrong = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
            raise ValueError(f"the weights differ from the configuration's names and shapes at {wrong[:8]} "
                             f"({len(wrong)} entries)")
        self.cfg = cfg
        self.w = {k: v.detach().to(device=device, dtype=torch.float32) for k, v in weights.items()}

    def linear(self, name: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        return F.linear(x, self.w[name + ".kernel"].t(), self.w[name + ".bias"] if bias else None)

    def ln(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.w[name + ".scale"], self.w[name + ".offset"], self.cfg.ln_eps)

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w = self.w
        return F.batch_norm(x, w[name + ".mean"], w[name + ".var"], w[name + ".scale"], w[name + ".offset"],
                            training=False, eps=self.cfg.bn_eps)

    def block(self, name: str, x, nmap, heads: int, pad, unpad, cu, st: dict, o: int):
        cpe = subm_conv(x, nmap, self.w[name + ".cpe_conv.kernel"], self.w[name + ".cpe_conv.bias"])
        x = x + self.ln(name + ".cpe_norm", self.linear(name + ".cpe_linear", cpe))
        shortcut = x
        qkv = self.linear(name + ".qkv", self.ln(name + ".norm1", x), self.cfg.qkv_bias)[st["order"][o][pad]]
        feat = attention(qkv, cu, heads)[unpad[st["inverse"][o]]]
        x = shortcut + self.linear(name + ".proj", feat)
        return x + self.linear(name + ".fc2", F.gelu(self.linear(name + ".fc1", self.ln(name + ".norm2", x))))

    @torch.no_grad()
    def forward(self, grid: torch.Tensor, batch: torch.Tensor, feat: torch.Tensor) -> dict:
        """(N, 3) cells, (N,) fragments, (N, in_channels) features -> the
        logits (N, classes), the stages (with each one's 3^3 map `kmap`)
        and the stem's map."""
        cfg = self.cfg
        stages = serialize(grid, batch, cfg)
        for st in stages:
            st["kmap"] = neighbour_map(st["grid"], st["batch"], cfg.cpe_kernel)
        stem = neighbour_map(stages[0]["grid"], stages[0]["batch"], cfg.stem_kernel)
        x = F.gelu(self.bn("embedding.norm", subm_conv(feat, stem, self.w["embedding.conv.kernel"], None)))
        skips = []
        for s in range(len(cfg.enc_depths)):
            st = stages[s]
            if s > 0:
                parent = stages[s - 1]
                y = self.linear(f"enc.{s}.down.proj", x)
                pooled = y.new_zeros((st["grid"].shape[0], y.shape[1]))
                pooled.scatter_reduce_(0, parent["cluster"][:, None].expand_as(y), y, "amax", include_self=False)
                x = F.gelu(self.bn(f"enc.{s}.down.norm", pooled))
            pad, unpad, cu = padding(st["batch"][st["order"][0]], cfg.enc_patch_size[s])
            for i in range(cfg.enc_depths[s]):
                x = self.block(f"enc.{s}.blocks.{i}", x, st["kmap"], cfg.enc_num_head[s], pad, unpad, cu, st,
                               i % len(cfg.order))
            skips.append(x)
        for s in reversed(range(len(cfg.dec_depths))):
            st = stages[s]
            up = F.gelu(self.bn(f"dec.{s}.up.proj_norm", self.linear(f"dec.{s}.up.proj", x)))
            x = F.gelu(self.bn(f"dec.{s}.up.skip_norm", self.linear(f"dec.{s}.up.skip", skips[s])))
            x = x + up[st["cluster"]]
            pad, unpad, cu = padding(st["batch"][st["order"][0]], cfg.dec_patch_size[s])
            for i in range(cfg.dec_depths[s]):
                x = self.block(f"dec.{s}.blocks.{i}", x, st["kmap"], cfg.dec_num_head[s], pad, unpad, cu, st,
                               i % len(cfg.order))
        return {"logits": self.linear("seg_head", x), "stages": stages, "stem": stem}


def compare(logits: torch.Tensor, labels: torch.Tensor, ref_logits: torch.Tensor, tie: float) -> dict:
    """`logit_gap`, the widest absolute difference of the program's logits
    from the reference's; `label_diff`, the points whose program label
    scores, in the reference's logits, more than `tie` below the
    reference's maximum (a point whose top classes lie within `tie` of
    each other is a tie, the program's to break)."""
    gap = (logits.double() - ref_logits.double()).abs().max().item() if logits.numel() else 0.0
    ref_max = ref_logits.max(dim=1).values
    chosen = ref_logits.gather(1, labels.long()[:, None])[:, 0]
    return {"logit_gap": gap if logits.shape == ref_logits.shape else float("inf"),
            "label_diff": int((chosen < ref_max - tie).sum())}


def order_diff(got: dict, ref: dict) -> int:
    """Entries of the orders, clusters and neighbour maps of every stage,
    and of the stem's map, where the program's differ from the
    reference's (every entry when a shape differs)."""
    def diff(a, b):
        a, b = torch.as_tensor(a).long(), torch.as_tensor(b).long().to(a.device)
        return int((a != b).sum()) if a.shape == b.shape else max(a.numel(), b.numel(), 1)

    n = diff(got["stem"], ref["stem"])
    if len(got["stages"]) != len(ref["stages"]):
        return n + 1
    for g, r in zip(got["stages"], ref["stages"]):
        n += diff(g["order"], r["order"]) + diff(g["kmap"], r["kmap"])
        if "cluster" in r:
            n += diff(g["cluster"], r["cluster"])
    return n
