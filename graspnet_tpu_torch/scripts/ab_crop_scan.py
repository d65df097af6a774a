"""Side-by-side timing of the multi-depth cylinder scan in several checkouts
of the port, on one card: the crop group (K6), the cylinder query (K8) and
the CloudCrop (K5) with its scan alone; the fused SA2-4 stage (K9), whose
MLP shares `csrc/crop.cu` with K5; and the per-query oracle (K10).

    python3 -m graspnet_tpu_torch.scripts.ab_crop_scan --trees OLD . . OLD [--out FILE]

Each tree (a directory holding a `graspnet_tpu_torch/`, e.g. a `git
archive` of the parent commit) runs in a process of its own, in the order
given, on the same seeded tabletop clouds (20000 points) and the same
random weights.  Per run, in ms:

  * `crop_group_train_b2`: K6 at the training shape (B=2, 1024 label
    points within a centimetre of the tabletop's objects, random
    rotations);
  * `cylinder_query_multi_b2`: K8 at the serving seeds (B=2, 1024 FPS
    seeds, random approach views);
  * `crop_fused_b1`, `crop_fused_b2`: K5 at those seeds;
  * `crop_scan_b1`, `crop_scan_b2`: K5's first launch alone (the crop
    group at K5's shapes, the kernel K5 launches first in every tree);
  * `sa_feat_b2`: K9's three calls (SA2-4 on the FPS stage points, random
    features of the stages' widths) summed;
  * `multi_query_b2`: K10 in cylinder mode at K8's shape (B=2, 1024 FPS
    seeds x 4 depths x 20000 points);

each as one call's CUDA-event median (30 calls) and as `..._device`, the
kernels' own device time per call under torch.profiler (10 calls).  Every
run's outputs are held against the first run's: K6's offsets bitwise, K8's
and K10's indices equal, K5 and K9 within 1e-4 x max(1, scale).  Each run also gives the
registers and spill bytes ptxas reports for the scan kernels, when its
process built them.  The JSON line adds, per shape, the points the scan's
blocks of 4 and of 8 centres scan and load against the centres' nth-hit
tests (the cylinder scan's schedule, from the plain masks), and the card's
name and power limit; `--out` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

FEATURE_TOL = 1e-4
TRAIN_SEED = 0
SCAN_KERNELS = ("scan", "crop_group", "warp_query")  # parts of the scan kernels' mangled names


def ptxas_scan_records(out: str) -> dict:
    """nvcc -Xptxas -v output -> {mangled name: registers, spill bytes} of
    the scan kernels."""
    records, current = {}, None
    for line in out.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            current = records.setdefault(name, {}) if any(k in name for k in SCAN_KERNELS) else None
        elif current is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill:
                current["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
            used = re.search(r"Used (\d+) registers", line)
            if used:
                current["registers"] = int(used.group(1))
    return records


def label_points(rng: np.random.Generator, cloud: np.ndarray, m: int) -> np.ndarray:
    """(B, N, 3) tabletop -> (B, m, 3) points within a centimetre of its
    objects (everything above the table plane at z = 0.55)."""
    out = []
    for pts in cloud:
        obj = pts[pts[:, 2] < 0.54]
        pick = obj[rng.choice(len(obj), m, replace=len(obj) < m)]
        out.append(pick + rng.normal(0, 0.01, pick.shape))
    return np.stack(out).astype(np.float32)


def shapes(cfg, cloud: torch.Tensor) -> dict:
    """The (cloud, centres, rotations) of each timed shape, on the card."""
    from graspnet_tpu_torch.models import geometry
    from graspnet_tpu_torch.ops.cuda import fps_chain

    dev = cloud.device
    rng = np.random.default_rng(TRAIN_SEED)
    b, m = cloud.shape[0], cfg.num_seed
    labels = torch.from_numpy(label_points(rng, cloud.cpu().numpy(), m)).to(dev)
    q, _ = np.linalg.qr(rng.normal(size=(b, m, 3, 3)))
    label_rot = torch.from_numpy(q.astype(np.float32)).to(dev)
    xyz = [cloud]
    for idx in fps_chain(cloud, tuple(sa.npoint for sa in (cfg.sa1, cfg.sa2, cfg.sa3, cfg.sa4))):
        xyz.append(torch.gather(xyz[-1], 1, idx[..., None].expand(-1, -1, 3)))
    seeds = xyz[2]
    pick = torch.randint(0, cfg.num_view, seeds.shape[:2], generator=torch.Generator().manual_seed(0))
    rot = geometry.batch_viewpoint_params_to_matrix(
        -geometry.generate_grasp_views(cfg.num_view, dev)[pick.to(dev)], torch.zeros(seeds.shape[:2], device=dev))
    sa = []  # (points, centres, features) of SA2-4
    for k, prev in enumerate((cfg.sa1, cfg.sa2, cfg.sa3), start=1):
        feats = rng.normal(size=(b, prev.npoint, prev.mlp[-1])).astype(np.float32)
        sa.append((xyz[k], xyz[k + 1], torch.from_numpy(feats).to(dev)))
    return {"train_b2": (cloud, labels, label_rot), "serving_b2": (cloud, seeds, rot.contiguous()),
            "serving_b1": (cloud[:1], seeds[:1], rot[:1].contiguous()), "sa_b2": sa}


def measure(tree: str, data: str, out: str) -> None:
    """One run, in a process of its own: the port of `tree` on the clouds in
    `data`; times to stdout as JSON, outputs to `out`."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import graspnet_tpu_torch
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.models import GraspNet, init_weights
    from graspnet_tpu_torch.nn.layers import fold_bn_eval
    from graspnet_tpu_torch.ops.cuda import (build, crop_fused, crop_group, cylinder_query_multi, multi_query,
                                             sa_feat_fused)
    from graspnet_tpu_torch.scripts.ab_ball_kernels import device_ms, event_ms

    ptxas = {name: ptxas_scan_records(text) for name, text in build.build_all(("query", "crop")).items()}
    cfg = GraspNetConfig()
    geom = (cfg.cylinder_radius, cfg.hmin, tuple(cfg.hmax_list), cfg.crop_nsample)
    with torch.inference_mode():
        s = shapes(cfg, torch.from_numpy(np.load(data)).to("cuda"))
        model = init_weights(GraspNet(cfg), 1).to("cuda")
        folded = fold_bn_eval(model.crop.mlp)
        sa_calls = [(x, c, f, fold_bn_eval(getattr(model.backbone, name).mlp), sa.radius, sa.nsample)
                    for (x, c, f), name, sa in zip(s["sa_b2"], ("sa2", "sa3", "sa4"), (cfg.sa2, cfg.sa3, cfg.sa4))]
        calls = {
            "crop_group_train_b2": lambda: crop_group(*s["train_b2"], *geom),
            "cylinder_query_multi_b2": lambda: cylinder_query_multi(*s["serving_b2"], *geom),
            "crop_fused_b1": lambda: crop_fused(*s["serving_b1"], folded, *geom),
            "crop_fused_b2": lambda: crop_fused(*s["serving_b2"], folded, *geom),
            "crop_scan_b1": lambda: crop_group(*s["serving_b1"], *geom),
            "crop_scan_b2": lambda: crop_group(*s["serving_b2"], *geom),
            "sa_feat_b2": lambda: [sa_feat_fused(*a) for a in sa_calls],
            "multi_query_b2": lambda: multi_query(*s["serving_b2"], *geom),
        }
        outs = {k: calls[k]() for k in ("crop_group_train_b2", "cylinder_query_multi_b2", "crop_fused_b1",
                                         "crop_fused_b2", "multi_query_b2")}
        outs["sa_feat_b2"] = torch.cat([o.flatten() for o in calls["sa_feat_b2"]()])
        times = {k: event_ms(fn, 30) for k, fn in calls.items()}
        times.update({f"{k}_device": device_ms(fn) for k, fn in calls.items()})
    torch.save({k: v.cpu() for k, v in outs.items()}, out)
    print(json.dumps({"tree": tree, "package": str(Path(graspnet_tpu_torch.__file__).parent), "ms": times,
                      "ptxas": {k: v for k, v in ptxas.items() if v}}))


def block_ratios(cfg, cloud: torch.Tensor) -> dict:
    """Per shape and block size (4, 8 centres): what the cylinder scan's
    blocks scan and load against the centres' nth-hit tests."""
    from graspnet_tpu_torch.utils.scan_stats import cylinder_nth_hits, scan_blocks

    with torch.inference_mode():
        return {name: {f"blocks_of_{w}": scan_blocks(cylinder_nth_hits(cfg, x, c, r), x.shape[1], w) for w in (4, 8)}
                for name, (x, c, r) in shapes(cfg, cloud).items() if name != "sa_b2"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True, help="checkouts to run, in order")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_crop_scan times CUDA kernels and needs a card")
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.utils.synthetic import tabletop_cloud
    from graspnet_tpu_torch.utils.timing import gpu_name_and_power

    rng = np.random.default_rng(0)
    clouds = np.stack([tabletop_cloud(rng) for _ in range(2)])
    runs, first = [], None
    with tempfile.TemporaryDirectory() as tmp:
        data = str(Path(tmp) / "clouds.npy")
        np.save(data, clouds)
        for i, tree in enumerate(args.trees):
            out = str(Path(tmp) / f"run{i}.pt")
            proc = subprocess.run([sys.executable, __file__, "--child", tree, data, out],
                                  capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError(f"run {i} ({tree}) failed:\n{proc.stdout}\n{proc.stderr}")
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            got = torch.load(out)
            first = first or got
            for k in ("crop_group_train_b2", "cylinder_query_multi_b2", "multi_query_b2"):
                if not torch.equal(got[k], first[k]):
                    raise AssertionError(f"run {i} ({tree}): {k} differs from run 0")
            for k in ("crop_fused_b1", "crop_fused_b2", "sa_feat_b2"):
                err = (got[k] - first[k]).abs().max().item()
                if err > FEATURE_TOL * max(1.0, first[k].abs().max().item()):
                    raise AssertionError(f"run {i} ({tree}): {k} differs from run 0 by {err}")
                run[f"{k}_max_abs_diff_to_run0"] = err
            runs.append(run)
            print(json.dumps(run), flush=True)
    result = {"runs": runs, "blocks": block_ratios(GraspNetConfig(), torch.from_numpy(clouds).to("cuda")),
              "gpu": gpu_name_and_power(), "source": "graspnet_tpu_torch/scripts/ab_crop_scan.py"}
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    return result


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        measure(*sys.argv[2:5])
    else:
        main()
