"""Slope-method timings of the fused kernels alone: the CloudCrop (K5), SA1
(K3), the fused SA2-4 stages (K9) and one FPS stage (the one-stage case of
the FPS chain kernel), at the shapes of `scripts/bench_crop_kernels.py`.

    python -m graspnet_tpu_torch.scripts.bench_crop_kernels [--out FILE]

Stage names are those of the JAX script, so the two records compare key by
key; the shapes in them are `GraspNetConfig()`'s, and `--tiny` scales every
shape down to `GraspNetConfig.tiny()`.  Inputs come from numpy seeds, the
weights from seeded torch generators (random, with identity BN).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from graspnet_tpu_torch.nn.layers import SharedMLP, fold_bn_eval
from graspnet_tpu_torch.ops.cuda import crop_fused, fps_chain, sa1_fused, sa_feat_fused
from graspnet_tpu_torch.utils.timing import RECORDS, cli, dump_records, timeit


def random_mlp(dims: Sequence[int], seed: int, device) -> SharedMLP:
    """A SharedMLP with Kaiming-normal kernels from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    mlp = SharedMLP(dims)
    with torch.no_grad():
        for layer in mlp:
            layer.kernel.copy_(torch.randn(layer.kernel.shape, generator=gen) * (2.0 / layer.kernel.shape[0]) ** 0.5)
    return mlp.to(device)


def uniform(rng: np.random.Generator, shape, device, lo=-0.5, hi=0.5) -> torch.Tensor:
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args, cfg, dev = cli(__doc__.splitlines()[0], argv)
    rng = np.random.default_rng(0)
    cloud = uniform(rng, (1, cfg.num_point, 3), dev)
    data = np.random.default_rng(1)
    seeds = uniform(data, (1, cfg.num_seed, 3), dev)
    rot = torch.eye(3, device=dev).expand(1, cfg.num_seed, 3, 3).contiguous()
    geom = (cfg.cylinder_radius, cfg.hmin, tuple(cfg.hmax_list), cfg.crop_nsample)
    sa1, sa2, sa3, sa4 = cfg.sa1, cfg.sa2, cfg.sa3, cfg.sa4
    with torch.inference_mode():
        crop_w = fold_bn_eval(random_mlp(cfg.crop_mlp, 2, dev))
        timeit("crop_fused (1024 seeds x 4 depths, 20k pts)",
               lambda x: crop_fused(x, seeds, rot, crop_w, *geom), cloud)

        sa1_w = fold_bn_eval(random_mlp(sa1.mlp, 3, dev))
        xyz1 = uniform(data, (1, sa1.npoint, 3), dev)
        timeit("sa1_fused (2048 seeds, 20k pts, ns=64)",
               lambda x: sa1_fused(x, xyz1, sa1_w, sa1.radius, sa1.nsample), cloud)

        # SA2-4 on the first points of one set, as the JAX script slices them
        for name, sa, n_in, c_in, seed in (
            ("sa2_fused (1024 seeds, 2048 pts, ns=32, C=128)", sa2, sa1.npoint, sa1.mlp[-1], 4),
            ("sa3_fused (512 seeds, 1024 pts, ns=16, C=256)", sa3, sa2.npoint, sa2.mlp[-1], 5),
            ("sa4_fused (256 seeds, 512 pts, ns=16, C=256)", sa4, sa3.npoint, sa3.mlp[-1], 6),
        ):
            feats = torch.from_numpy(data.normal(size=(1, n_in, c_in)).astype(np.float32)).to(dev)
            folded = fold_bn_eval(random_mlp(sa.mlp, seed, dev))
            centers = xyz1[:, : sa.npoint]
            timeit(name, lambda x, f=feats, c=centers, w=folded, s=sa: sa_feat_fused(
                x, c, f, w, s.radius, s.nsample), xyz1[:, :n_in])

        timeit("fps_pallas 20000->2048", lambda x: fps_chain(x, (sa1.npoint,)), cloud)
    if args.out:
        dump_records(args.out, source="graspnet_tpu_torch/scripts/bench_crop_kernels.py")
    return dict(RECORDS)


if __name__ == "__main__":
    main()
