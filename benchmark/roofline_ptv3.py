"""Operations and bytes of Point Transformer V3's work on one batch, from
the configuration's widths and the batch's stage sizes, held against
`roofline.py`'s peaks of one NVIDIA H100 by its `bound_s`.

A batch's `stats` (the segmentation driver reads them off the program's
stages): each stage's points `n`, its attention sequences' lengths by
patches (padding slots included: the attention computes them), the
hits of its 3^3 neighbour map, and the stem's 5^3 map's hits.

  * attention: 4 x L^2 x C operations a sequence of L rows a block (the
    scores and the weighted sum, heads of 16 across C channels), against
    q, k and v read and the output written once (T rows x 4C floats);
  * sparse convolution: 2 x hits x C_in x C_out a convolution, against the
    gathered rows (hits x C_in floats), the weights, the output and the
    map read once;
  * dense products: 26 x N x C^2 a block (the CPE's Linear, qkv,
    projection, the 4C MLP), pooling's and unpooling's Linears, the head.
"""

from __future__ import annotations

from benchmark.roofline import bound_s

BYTES = 4  # float32, int32


def _blocks(cfg, stats):
    """(channels, stage stats) for every block of the network."""
    out = []
    for s, st in enumerate(stats["stages"]):
        out += [(cfg.enc_channels[s], st)] * cfg.enc_depths[s]
        if s < len(cfg.dec_depths):
            out += [(cfg.dec_channels[s], st)] * cfg.dec_depths[s]
    return out


def attention_flops(cfg, stats) -> int:
    return sum(4 * c * sum(n * n for n in st["lengths"]) for c, st in _blocks(cfg, stats))


def attention_bytes(cfg, stats) -> int:
    return sum(sum(st["lengths"]) * 4 * c * BYTES for c, st in _blocks(cfg, stats))


def attention_bound_s(cfg, stats) -> float:
    """The attention kernel's launches in a batch (one a block)."""
    return bound_s(attention_bytes(cfg, stats), attention_flops(cfg, stats))


def spconv_flops(cfg, stats) -> int:
    f = 2 * stats["stem_hits"] * cfg.in_channels * cfg.enc_channels[0]
    return f + sum(2 * st["hits"] * c * c for c, st in _blocks(cfg, stats))


def spconv_bytes(cfg, stats) -> int:
    n0, c0, k3 = stats["stages"][0]["n"], cfg.enc_channels[0], cfg.stem_kernel ** 3
    b = (stats["stem_hits"] * cfg.in_channels + k3 * cfg.in_channels * c0 + n0 * c0 + n0 * k3) * BYTES
    k3 = cfg.cpe_kernel ** 3
    return b + sum((st["hits"] * c + k3 * c * c + st["n"] * c + st["n"] * k3) * BYTES
                   for c, st in _blocks(cfg, stats))


def spconv_bound_s(cfg, stats) -> float:
    """The convolution kernel's launches in a batch (the stem and one a block)."""
    return bound_s(spconv_bytes(cfg, stats), spconv_flops(cfg, stats))


def dense_flops(cfg, stats) -> int:
    st = stats["stages"]
    f = sum(26 * s["n"] * c * c for c, s in _blocks(cfg, stats))
    for s in range(1, len(st)):
        f += 2 * st[s - 1]["n"] * cfg.enc_channels[s - 1] * cfg.enc_channels[s]  # pooling, on the parent points
    for s in range(len(cfg.dec_depths)):
        c_in = cfg.dec_channels[s + 1] if s + 1 < len(cfg.dec_channels) else cfg.enc_channels[-1]
        f += 2 * cfg.dec_channels[s] * (st[s + 1]["n"] * c_in + st[s]["n"] * cfg.enc_channels[s])  # unpooling
    return f + 2 * st[0]["n"] * cfg.dec_channels[0] * cfg.num_classes


def forward_flops(cfg, stats) -> int:
    """A batch's forward: attention, sparse convolutions and dense products."""
    return attention_flops(cfg, stats) + spconv_flops(cfg, stats) + dense_flops(cfg, stats)
