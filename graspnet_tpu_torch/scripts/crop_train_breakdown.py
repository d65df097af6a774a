"""Sub-stage timings of the training-mode crop, the counterpart of
`scripts/crop_train_breakdown.py`, at the training operating point (B=2,
20000 points, 1024 seeds x 4 depths x 64 samples): the multi-depth cylinder
query (K8), gather + rotate in plain torch, the crop group (K6), the
batch-stat and eval SharedMLP + pool and the batch-stat one's forward +
backward in plain torch, the fused train MLP (K7) forward and forward +
backward, and `CloudCrop` in train mode, forward and forward + backward.

    python -m graspnet_tpu_torch.scripts.crop_train_breakdown [--out FILE]

Stage names are those of the JAX script, so the records compare key by key.
Its remat row (`jax.checkpoint` around the batch-stat MLP) is left out:
PyTorch has no single call that computes the same thing, and
`torch.utils.checkpoint` would time another program.  A fwd+bwd stage sums
every parameter gradient into its output, as the JAX script does.  Random
weights (seed 0), a uniform random cloud (numpy seed 0), identity
rotations.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from graspnet_tpu_torch import ops
from graspnet_tpu_torch.models.heads import CloudCrop
from graspnet_tpu_torch.ops.cuda import crop_group, crop_mlp_train
from graspnet_tpu_torch.scripts.bench_crop_kernels import random_mlp
from graspnet_tpu_torch.utils.timing import RECORDS, cli, dump_records, timeit

B = 2


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args, cfg, dev = cli(__doc__.splitlines()[0], argv)
    rng = np.random.default_rng(0)
    cloud = torch.from_numpy(rng.uniform(-0.4, 0.4, (B, cfg.num_point, 3)).astype(np.float32)).to(dev)
    seeds = cloud[:, : cfg.num_seed].contiguous()
    rots = torch.eye(3, device=dev).expand(B, cfg.num_seed, 3, 3).contiguous()
    crop = CloudCrop(cfg)
    crop.mlp = random_mlp(cfg.crop_mlp, 0, dev)
    crop = crop.to(dev)
    mlp = crop.mlp
    params = list(mlp.parameters())
    geom = (cfg.cylinder_radius, cfg.hmin, tuple(cfg.hmax_list), cfg.crop_nsample)

    def query(x, s, r):
        return ops.cylinder_query_multi_depth(x, s, r, *geom)

    def gather_rotate(x, s, r, i):
        b, m, d, ss = i.shape
        grouped = ops.group_points(x, i.reshape(b, m * d, ss)).reshape(b, m, d, ss, 3)
        return torch.einsum("bndsi,bnij->bndsj", grouped - s[:, :, None, None, :], r)

    def with_grads(loss):
        """loss + the sum of every parameter gradient: the backward is consumed."""
        grads = torch.autograd.grad(loss, params)
        return loss + sum(g.sum() for g in grads)

    def mlp_train(g):
        out, stats = mlp.forward_train(g)
        return torch.amax(out, dim=3), stats

    with torch.no_grad():
        timeit("cylinder query pallas (B=2)", query, cloud, seeds, rots)
        idx = query(cloud, seeds, rots)
        timeit("gather + rotate (XLA)", gather_rotate, cloud, seeds, rots, idx)
        grouped = gather_rotate(cloud, seeds, rots, idx)
        timeit("fused query+gather+rotate (Pallas)",
               lambda x, s, r: crop_group(x, s, r, *geom), cloud, seeds, rots)
        timeit("shared_mlp train BN + pool", mlp_train, grouped)
        timeit("shared_mlp eval BN + pool", lambda g: torch.amax(mlp(g), dim=3), grouped)
    timeit("shared_mlp train fwd+bwd (all grads)",
           lambda g: with_grads(torch.sum(torch.square(mlp_train(g)[0]))), grouped)
    with torch.no_grad():
        timeit("fused mlp train fwd (pallas)", lambda g: crop_mlp_train(mlp, g), grouped)
    timeit("fused mlp train fwd+bwd (pallas)",
           lambda g: with_grads(torch.sum(torch.square(crop_mlp_train(mlp, g)[0]))), grouped)
    with torch.no_grad():
        timeit("crop_forward train (full)", lambda x, s, r: crop(s, x, r, train=True), cloud, seeds, rots)
    timeit("crop_forward train fwd+bwd (full)",
           lambda x, s, r: with_grads(torch.sum(torch.square(crop(s, x, r, train=True)[0]))),
           cloud, seeds, rots)
    if args.out:
        dump_records(args.out, source="graspnet_tpu_torch/scripts/crop_train_breakdown.py")
    return dict(RECORDS)


if __name__ == "__main__":
    main()
