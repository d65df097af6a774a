"""Per-stage slope times of the training step, the counterpart of
`scripts/train_stage_times.py`.

    python -m graspnet_tpu_torch.scripts.train_stage_times [--json FILE] [--out FILE]

Splits the time of `Trainer._train_step` (batch 2, 20000 points, compact
labels: `scripts/bench_train.py`'s operating point, eight synthetic
objects of 300 label points a scene) into the forward loss, forward +
backward, the Adam update and each module's forward and forward +
backward, under the JAX script's names, slope-timed between CUDA events
(`utils/timing.py`).  The pieces are diagnostic: they need not sum to the
step.  Prints one line a stage and a JSON summary; `--json` writes the
summary, `--out` the `{stage_ms}` records.  `--device cpu --tiny` runs it
on the CPU at `GraspNetConfig.tiny()` for the tests; no number is then a
device number.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch

from graspnet_tpu_torch.scripts.bench_train import make_scene
from graspnet_tpu_torch.train import label_pipeline as lp
from graspnet_tpu_torch.train.loss import get_loss
from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer
from graspnet_tpu_torch.utils.timing import RECORDS, RUN, cli, dump_records, gpu_name_and_power, timeit

SOURCE = "graspnet_tpu_torch/scripts/train_stage_times.py"


def build_compact_batch(cfg, b: int = 2, seed: int = 0) -> dict:
    """A compact loader batch at the reference operating point."""
    rng = np.random.default_rng(seed)
    clouds = [rng.uniform(-0.4, 0.4, (cfg.num_point, 3)).astype(np.float32) for _ in range(b)]
    ctxs, chains = [], []
    for cloud in clouds:
        inds, seed_xyz = lp.seed_chain(cloud, cfg)
        chains.append(inds)
        ctxs.append(lp.prepare_scene_labels(seed_xyz, *make_scene(rng, cfg), cfg, max_objects=8))
    return {
        "point_clouds": np.stack(clouds),
        "objectness_label": np.stack([rng.integers(0, 2, cfg.num_point).astype(np.int32) for _ in range(b)]),
        "sa_inds": {k: np.stack([c[k] for c in chains])[..., : getattr(cfg, k).npoint]
                    for k in ("sa1", "sa2", "sa3", "sa4")},
        "label_ctx": ctxs,
    }


def _grads(out: torch.Tensor, module: torch.nn.Module):
    return out.detach(), torch.autograd.grad(out, [p for p in module.parameters() if p.requires_grad])


def main(argv: Optional[Sequence[str]] = None) -> dict:
    def own(ap):
        ap.add_argument("--json", default=None, help="write the summary JSON here")

    args, cfg, dev = cli(__doc__.splitlines()[0], argv, own)
    trainer = Trainer(cfg=cfg, tc=TrainConfig(), seed=0, device=dev)
    trainer.set_epoch(0)
    db = trainer._finalize_batch(trainer.prepare(build_compact_batch(cfg)))
    model = trainer.model
    pc = db["point_clouds"]

    timeit("scan overhead baseline", lambda x: x + 1.0, pc)

    def loss_only(pc_, d_):
        ep = model(pc_, True, labels=d_)
        ep["objectness_label"] = d_["objectness_label"]
        return get_loss(ep, cfg)[0]

    timeit("forward-only loss (train mode)", loss_only, pc, db)
    timeit("forward+backward (value_and_grad)", lambda pc_, d_: _grads(loss_only(pc_, d_), model), pc, db)

    trainer.opt.zero_grad(set_to_none=True)
    loss_only(pc, db).backward()
    first = next(model.parameters())
    timeit("optimizer update (adam_l2)", lambda x: (trainer.opt.step(), first)[1], pc)

    def backbone(pc_, si):
        feats, sx, _ = model.backbone(pc_, True, si)
        return feats, sx

    timeit("backbone fwd (train)", backbone, pc, db["sa_inds"])
    timeit("backbone fwd+bwd (train)",
           lambda pc_, si: _grads(sum(t.sum() for t in backbone(pc_, si)), model.backbone), pc, db["sa_inds"])
    timeit("label process_matched_labels",
           lambda pc_, d_: lp.process_matched_labels(d_, cfg)["batch_grasp_point"], pc, db)

    matched = lp.process_matched_labels(db, cfg)
    seeds, rots = matched["batch_grasp_point"], matched["batch_grasp_view_rot"]
    timeit("crop fwd (train, BN batch stats)", lambda pc_, s, r: model.crop(s, pc_, r, True)[0], pc, seeds, rots)
    timeit("crop fwd+bwd (train)", lambda pc_, s, r: _grads(model.crop(s, pc_, r, True)[0].sum(), model.crop),
           pc, seeds, rots)

    vp = model.crop(seeds, pc, rots, True)[0].detach()

    def heads(vp_):
        out = (model.operation(vp_, True)["grasp_score_pred"].sum()
               + model.tolerance(vp_, True)["grasp_tolerance_pred"].sum())
        return _grads(out, torch.nn.ModuleList([model.operation, model.tolerance]))

    timeit("operation+tolerance fwd+bwd", heads, vp)
    feats = torch.zeros((pc.shape[0], cfg.num_seed, cfg.seed_feature_dim), device=dev)

    def approach(f):
        ep = model.approach(f, True)
        return _grads(ep["view_score"].sum() + ep["objectness_score"].sum(), model.approach)

    timeit("approach fwd+bwd", approach, feats)

    summary = {"train_stage_ms": dict(RECORDS), "backend": RUN["backend"], "source": SOURCE,
               "gpu": gpu_name_and_power() if dev.type == "cuda" else None}
    print(json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
            f.write("\n")
    if args.out:
        dump_records(args.out, source=SOURCE)
    return summary


if __name__ == "__main__":
    main()
