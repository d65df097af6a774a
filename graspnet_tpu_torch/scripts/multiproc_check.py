"""Multi-process check of data-parallel training over torch.distributed.

Counterpart of `scripts/multiproc_check.py`:

  parent:   the single-process reference: the compact two-phase training
            loop on a deterministic global batch of GLOBAL_BATCH scenes;
  children: the ranks of one process group (spawned here), each with its
            data row's share of the same global batch, the same loop
            through `Trainer(group=, candidate=)`: by default two data rows
            of one rank (data-parallel), with `--layout DxC` D rows of C
            ranks, each rank running stage 2 on one of C seed blocks
            (hybrid data x candidate training).

Compared: the loss and gradients of a probe at the initial weights
(`grads_compact`, no state change), the losses of STEPS steps, and the
parameters and BN running stats after them.  Not bitwise: the ranks'
all-reduces add the rows of the global batch in another order than the
single process's reductions, and Adam turns float noise in a near-zero
gradient into an lr-sized step.  The tolerances are derived from the run,
as the JAX script derives them (`scripts/multiproc_check.py:18-31`): the
parent repeats its loop with the batch order reversed (the same math, its
sums in another order), and each leaf of the ranks' run must agree with the
parent within SAFETY x max(that probe, the analytic re-ordering bound
2 (n - 1) eps_f32 max|leaf|).  A wrong reduction (a rank-local batch-norm
statistic or loss count, a rank-local u_max) moves gradients by about
|g| / ranks, orders above either term.

The model is `GraspNetConfig.tiny()` with a two-layer crop MLP (3, 16, 32):
the train-MLP kernel (K7) runs only at world size 1 (the JAX gate), so with
tiny()'s three-layer crop MLP the parent and the ranks would take different
crop kernels on the card and the check would see the kernels' rounding
beside the reduction order.  With two layers both take the crop group and
the generic MLP on every device.

Every rank's parameters and BN running stats after the steps must also be
bitwise equal to rank 0's (`ranks_equal`).

Prints one JSON verdict line.  Rank r goes on cuda:(r mod the host's
cards): with fewer cards than ranks several share one, which needs
`--backend gloo` (NCCL takes one rank a card).

    python -m graspnet_tpu_torch.scripts.multiproc_check --device cpu [--layout 2x2]
    python -m graspnet_tpu_torch.scripts.multiproc_check --device cuda --backend gloo
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import sys
import tempfile
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

GLOBAL_BATCH = 2  # scenes a step
LAYOUT = (2, 1)  # (data rows, seed blocks): one scene a rank, data-parallel
STEPS = 2
SAFETY = 16.0
EPS32 = 2.0 ** -24
# the JAX package's own multi-process reading (MULTICHIP_r05.json), a CPU
# number shown beside this run's: not this check's bar
JAX_MAX_GRAD_DIFF = 3.6e-06


def check_config():
    from graspnet_tpu_torch.config import GraspNetConfig

    return dataclasses.replace(GraspNetConfig.tiny(), crop_mlp=(3, 16, 32))


def make_scene(cfg, scene_seed: int):
    """A compact-path scene keyed only by its seed, so the parent and the
    ranks build the same global batch (`scripts/multiproc_check.py:85`, with
    a score ceiling drawn per scene)."""
    from graspnet_tpu_torch.train import label_pipeline as lp

    rng = np.random.default_rng(scene_seed)
    v, a, d = cfg.num_view, cfg.num_angle, cfg.num_depth
    cloud = rng.uniform(-0.4, 0.4, (cfg.num_point, 3)).astype(np.float32)
    inds, seed_xyz = lp.seed_chain(cloud, cfg)
    # a score ceiling of its own, so the scenes' raw maxima differ and a
    # rank-local u_max shows
    top = rng.uniform(0.6, 1.2)
    poses, pts, scores, widths, tols = [], [], [], [], []
    for _ in range(2):
        q = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        poses.append(np.concatenate([q, rng.uniform(-0.2, 0.2, (3, 1)).astype(np.float32)], 1))
        pts.append(rng.uniform(-0.05, 0.05, (24, 3)).astype(np.float32))
        scores.append(rng.uniform(0, top, (24, v, a, d)).astype(np.float32))
        widths.append(rng.uniform(0, 0.15, (24, v, a, d)).astype(np.float32))
        tols.append(rng.uniform(0, 0.05, (24, v, a, d)).astype(np.float32))
    return {
        "point_clouds": cloud,
        "objectness_label": rng.integers(0, 2, cfg.num_point).astype(np.int32),
        "sa_inds": inds,
        "label_ctx": lp.prepare_scene_labels(seed_xyz, poses, pts, scores, widths, tols, cfg, max_objects=4),
    }


def build_batch(cfg, step: int, lo: int, hi: int, order: int = 1):
    scenes = [make_scene(cfg, 10_000 * step + i) for i in range(lo, hi)][::order]
    batch = {}
    for k in scenes[0]:
        if k == "sa_inds":
            batch[k] = {s: np.stack([sc[k][s] for sc in scenes]) for s in scenes[0][k]}
        elif k == "label_ctx":
            batch[k] = [sc[k] for sc in scenes]
        else:
            batch[k] = np.stack([sc[k] for sc in scenes])
    return batch


def run_train(cfg, device, group, lo: int, hi: int, order: int = 1, candidate: int = 1) -> dict:
    """The gradient probe and STEPS compact steps on scenes [lo, hi);
    returns numpy results by name."""
    from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer

    trainer = Trainer(cfg, TrainConfig(), seed=0, device=device, group=group, candidate=candidate)
    trainer.set_epoch(0)
    loss0, grads0 = trainer.grads_compact(build_batch(cfg, 0, lo, hi, order))
    losses = [float(trainer.step_compact(build_batch(cfg, s, lo, hi, order))[0]) for s in range(STEPS)]
    out = {"losses": np.asarray(losses, np.float64), "loss0": np.float64(float(loss0))}
    for k, v in trainer.model.state_dict().items():
        out[f"p:{k}"] = v.detach().cpu().numpy()
    for k, v in grads0.items():
        out[f"g:{k}"] = v.detach().cpu().numpy()
    return out


def rank_device(device: str, rank: int) -> torch.device:
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _child(rank: int, coordinator: str, device: str, backend: Optional[str], out: str,
           tamper: Optional[Callable[[], None]], layout: Tuple[int, int]) -> None:
    import torch.distributed as dist

    from graspnet_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    if tamper is not None:
        tamper()
    rows, candidate = layout
    distributed.initialize(coordinator, rows * candidate, rank, backend=backend, device=device)
    try:
        sl = distributed.process_local_batch_slice(GLOBAL_BATCH, candidate)
        res = run_train(check_config(), rank_device(device, rank), dist.group.WORLD, sl.start, sl.stop,
                        candidate=candidate)
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def run_ranks(device: str, backend: Optional[str], tamper: Optional[Callable[[], None]] = None,
              layout: Tuple[int, int] = LAYOUT) -> dict:
    """The run of `layout` = (data rows, seed blocks) ranks; rank 0's
    results, with `ranks_equal`: whether every rank ends with rank 0's
    parameters and BN running stats, bit for bit.  `tamper`: a picklable
    function each rank calls first (the tests' stand-ins for a wrong
    reduction)."""
    from graspnet_tpu_torch.ops.cuda import build

    build.build_all(build.SOURCES if torch.device(device).type == "cuda" else (build.HOST,))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    processes = layout[0] * layout[1]
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_child, args=(f"127.0.0.1:{port}", device, backend, tmp, tamper, layout),
                                    nprocs=processes, join=True)
        ranks = []
        for r in range(processes):
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as f:
                ranks.append(dict(f))
    out = ranks[0]
    out["ranks_equal"] = np.bool_(all(np.array_equal(out[k], other[k]) for other in ranks[1:]
                                      for k in out if k.startswith("p:")))
    return out


def reference(device: str) -> tuple:
    """The parent's run and its reversed-order probe."""
    cfg = check_config()
    return run_train(cfg, device, None, 0, GLOBAL_BATCH), run_train(cfg, device, None, 0, GLOBAL_BATCH, order=-1)


def _worst(ref: dict, rev: dict, got: dict, keys) -> tuple:
    """(ok, max |diff|, its tolerance, worst diff / tolerance) over the
    leaves `keys`, each at SAFETY x max(|ref - rev|, the analytic
    re-ordering bound) + 1e-9."""
    worst = (0.0, 0.0, 0.0)
    for k in keys:
        a = ref[k].astype(np.float64)
        if not a.size:
            continue
        probe = float(np.max(np.abs(a - rev[k].astype(np.float64))))
        analytic = 2.0 * (GLOBAL_BATCH - 1) * EPS32 * float(np.max(np.abs(a)))
        tol = SAFETY * max(probe, analytic) + 1e-9
        diff = float(np.max(np.abs(a - got[k].astype(np.float64))))
        if diff / tol > worst[0]:
            worst = (diff / tol, diff, tol)
    return worst[0] <= 1.0, worst[1], worst[2], worst[0]


def verdict(ref: dict, rev: dict, got: dict) -> dict:
    """The verdict line: the ranks' run (`got`) against the parent's
    (`ref`) within the tolerances derived from the reversed-order probe
    (`rev`)."""
    g_ok, g_diff, g_tol, g_ratio = _worst(ref, rev, got, [k for k in ref if k.startswith("g:")])
    p_ok, p_diff, p_tol, p_ratio = _worst(ref, rev, got, [k for k in ref if k.startswith("p:")])
    bn_ok, bn_diff, bn_tol, _ = _worst(ref, rev, got, [k for k in ref if k.startswith("p:")
                                                       and k.endswith((".bn.mean", ".bn.var", "bn1.mean",
                                                                       "bn1.var", "bn2.mean", "bn2.var"))])
    loss_probe = abs(float(ref["loss0"]) - float(rev["loss0"]))
    loss_tol = SAFETY * max(loss_probe, 2.0 * (GLOBAL_BATCH - 1) * EPS32 * abs(float(ref["loss0"]))) + 1e-9
    loss0_ok = abs(float(ref["loss0"]) - float(got["loss0"])) <= loss_tol
    losses_ok = bool(np.all(np.abs(ref["losses"] - got["losses"])
                            <= SAFETY * np.maximum(np.abs(ref["losses"] - rev["losses"]),
                                                   EPS32 * np.abs(ref["losses"])) + 1e-9))
    ranks_equal = bool(got.get("ranks_equal", True))
    return {
        "ok": bool(g_ok and p_ok and bn_ok and loss0_ok and losses_ok and ranks_equal),
        "ranks_equal": ranks_equal,
        "loss0_ok": bool(loss0_ok),
        "losses_ok": losses_ok,
        "grads_ok": bool(g_ok),
        "params_ok": bool(p_ok),
        "bn_stats_ok": bool(bn_ok),
        "max_abs_grad_diff": g_diff,
        "derived_grad_tol": g_tol,
        "grad_tol_ratio": g_ratio,
        "jax_max_grad_diff": JAX_MAX_GRAD_DIFF,
        "max_abs_param_diff": p_diff,
        "derived_param_tol": p_tol,
        "param_tol_ratio": p_ratio,
        "max_abs_bn_stat_diff": bn_diff,
        "derived_bn_stat_tol": bn_tol,
        "derived_loss0_tol": loss_tol,
        "loss0_diff": abs(float(ref["loss0"]) - float(got["loss0"])),
        "order_probe_loss0_diff": loss_probe,
        "param_leaves": sum(1 for k in ref if k.startswith("p:")),
        "steps": STEPS,
        "safety_factor": SAFETY,
        "ref_losses": [float(x) for x in ref["losses"]],
        "mp_losses": [float(x) for x in got["losses"]],
        "global_batch": GLOBAL_BATCH,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="the ranks' backend (default: nccl on CUDA, gloo on the CPU)")
    p.add_argument("--layout", default="x".join(map(str, LAYOUT)),
                   help="DxC: D data rows of C ranks, one seed block each (default 2x1: data-parallel)")
    args = p.parse_args(argv)
    from graspnet_tpu_torch.device import resolve_device

    resolve_device(args.device, "multiproc_check")
    layout = tuple(int(x) for x in args.layout.split("x"))
    if len(layout) != 2 or GLOBAL_BATCH % layout[0] or check_config().num_seed % layout[1]:
        p.error(f"--layout {args.layout}: D must divide the global batch {GLOBAL_BATCH} and C the "
                f"{check_config().num_seed} seeds")
    ref, rev = reference(args.device)
    got = run_ranks(args.device, args.backend, layout=layout)
    out = verdict(ref, rev, got)
    out["device"] = args.device
    out["backend"] = args.backend or ("nccl" if torch.device(args.device).type == "cuda" else "gloo")
    out["layout"] = list(layout)
    out["processes"] = layout[0] * layout[1]
    out["devices_distinct"] = len({str(rank_device(args.device, r)) for r in range(out["processes"])})
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
