"""Per-stage timing of the inference pipeline, the counterpart of
`scripts/profile_stages.py`: the plain and kernel FPS; the SA1 ball query,
grouping and MLP; SA1-4 and FP1-2 through the backbone's own modules; the
whole backbone; the multi-depth cylinder query (K8) at 1024 seeds x 4
depths x 20000 points, and its per-seed oracle (K10); the CloudCrop; and the
full forward + decode.

    python -m graspnet_tpu_torch.scripts.profile_stages [--out FILE]

Stage names are those of the JAX script, so the records compare key by key
(its fixed sizes are `GraspNetConfig()`'s; `--tiny` scales every shape
down); the per-seed oracle row is the port's own.  Each stage is a slope
time (`utils/timing.py`), where the JAX script took a median of host-synced
calls.  Random weights (seed 0), a uniform random cloud (numpy seed 0).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from graspnet_tpu_torch import ops
from graspnet_tpu_torch.models import GraspNet, init_weights, pred_decode
from graspnet_tpu_torch.ops.cuda import fps_chain, multi_query
from graspnet_tpu_torch.ops.cuda.fps import fps_plain
from graspnet_tpu_torch.utils.timing import RECORDS, cli, dump_records, timeit


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args, cfg, dev = cli(__doc__.splitlines()[0], argv)
    rng = np.random.default_rng(0)
    cloud = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, cfg.num_point, 3)).astype(np.float32)).to(dev)
    model = init_weights(GraspNet(cfg), 0).to(dev).eval()
    bb = model.backbone
    sa1 = cfg.sa1
    with torch.inference_mode():
        timeit("fps pure-JAX (20000->2048)", lambda x: fps_plain(x, sa1.npoint), cloud)
        timeit("fps pallas   (20000->2048)", lambda x: fps_chain(x, (sa1.npoint,)), cloud)

        # ball query, grouping and the MLP at SA1 scale
        centers = ops.gather_points(cloud, fps_chain(cloud, (sa1.npoint,))[0])
        timeit("ball_query sa1 (2048c x 20000p, ns=64)",
               lambda x, c: ops.ball_query(x, c, sa1.radius, sa1.nsample), cloud, centers)
        idx = ops.ball_query(cloud, centers, sa1.radius, sa1.nsample)
        timeit("group_points alone (2048x64 gather)", ops.group_points, cloud, idx)
        grouped = ops.group_points(cloud, idx) - centers[:, :, None, :]
        timeit("sa1 mlp alone (1,2048,64,3)->128 + max",
               lambda g: torch.amax(bb.sa1.mlp(g), dim=2), grouped)

        def sa1_mlp(x, c):
            i = ops.ball_query(x, c, sa1.radius, sa1.nsample)
            g = (ops.group_points(x, i) - c[:, :, None, :]) / sa1.radius
            return torch.amax(bb.sa1.mlp(g), dim=2)

        timeit("group+mlp sa1 (2048x64x3 -> 128)", sa1_mlp, cloud, centers)

        # per-stage backbone breakdown: each SA stage with its own FPS
        x, f = cloud, None
        carried = []
        for name, sa in (("sa1", cfg.sa1), ("sa2", cfg.sa2), ("sa3", cfg.sa3), ("sa4", cfg.sa4)):
            stage = getattr(bb, name)

            def run(xx, ff=None, stage=stage, sa=sa):
                return stage(xx, ff, fps_chain(xx, (sa.npoint,))[0])[:2]

            timeit(f"{name} ({x.shape[1]}->{sa.npoint}, ns={sa.nsample})", run, *((x,) if f is None else (x, f)))
            x, f = run(x, f)
            carried.append((x, f))
        (_, _), (s2x, s2f), (s3x, s3f), (s4x, s4f) = carried
        timeit("fp1 (512<-256)", lambda a, b, c, d: bb.fp1(a, b, c, d)[0], s3x, s4x, s3f, s4f)
        f1 = bb.fp1(s3x, s4x, s3f, s4f)[0]
        timeit("fp2 (1024<-512)", lambda a, b, c, d: bb.fp2(a, b, c, d)[0], s2x, s3x, s2f, f1)
        timeit("backbone full", lambda xx: bb(xx)[0], cloud)

        # the cylinder crop at stage-2 scale
        seeds = centers[:, : cfg.num_seed]
        rots = torch.eye(3, device=dev).expand(1, cfg.num_seed, 3, 3).contiguous()
        geom = (cfg.cylinder_radius, cfg.hmin, tuple(cfg.hmax_list), cfg.crop_nsample)
        timeit("cylinder_query_multi (1024s x 4d x 20000p)",
               lambda xx, s, r: ops.cylinder_query_multi_depth(xx, s, r, *geom), cloud, seeds, rots)
        timeit("multi_query per-seed oracle (1024s x 4d x 20000p)",
               lambda xx, s, r: multi_query(xx, s, r, *geom), cloud, seeds, rots)
        timeit("crop_forward (query+group+mlp+pool)",
               lambda s, xx, r: model.crop(s, xx, r)[0], seeds, cloud, rots)

        timeit("FULL forward+decode", lambda xx: pred_decode(model(xx), cfg), cloud)
    if args.out:
        dump_records(args.out, source="graspnet_tpu_torch/scripts/profile_stages.py")
    return dict(RECORDS)


if __name__ == "__main__":
    main()
