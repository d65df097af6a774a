"""Side-by-side timing of the fused SA2-4 stage (K9) stage by stage, and of
the per-query oracle (K10), in several checkouts of the port, on one card.

    python3 -m graspnet_tpu_torch.scripts.ab_sa_feat --trees OLD . . OLD [--out FILE]

Each tree (a directory holding a `graspnet_tpu_torch/`: a `git archive` of
another commit, or a copy whose `csrc/crop.cu` was edited to try a variant
of K9's kernel) runs in a process of its own, in the order given, on the
same seeded tabletop clouds (B=2, 20000 points), the FPS stage points and
random features of the stages' widths that `ab_crop_scan.py` makes, and the
model's own folded SA2-4 MLPs (random weights, seed 1).  Per run, in ms:

  * `sa2_b2`, `sa3_b2`, `sa4_b2` and the same at B=1: K9 at one stage, as
    one call's CUDA-event median (20 calls) and as `..._device`, the
    kernels' own device time per call under torch.profiler (10 calls); a
    stage whose widths the tree's kernel does not take (ValueError before
    any launch) reads "out of domain";
  * `..._err`: max |K9 - sa_feat_fused_plain| / max(1, scale) at that stage,
    held at 1e-4;
  * `multi_query_b2_device`, `multi_query_b1_device`: K10 in cylinder mode
    at K8's shape (1024 FPS seeds x 4 depths x 20000 points);

and the registers and spill bytes ptxas reports for `sa_feat_tc_kernel` and
`seed_query_kernel`, when its process built them.  The JSON line adds the
card's name and power limit; `--out` also writes it to a file.
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
KERNELS = ("sa_feat", "seed_query")  # parts of the timed kernels' mangled names


def ptxas_records(out: str) -> dict:
    """nvcc -Xptxas -v output -> {mangled name: registers, spill bytes} of
    the kernels this script times."""
    records, current = {}, None
    for line in out.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            current = records.setdefault(name, {}) if any(k in name for k in KERNELS) else None
        elif current is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill:
                current["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
            used = re.search(r"Used (\d+) registers", line)
            if used:
                current["registers"] = int(used.group(1))
    return records


def measure(tree: str, data: str) -> None:
    """One run, in a process of its own: the port of `tree` on the clouds in
    `data`; times to stdout as JSON."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import graspnet_tpu_torch
    from graspnet_tpu_torch.config import GraspNetConfig
    from graspnet_tpu_torch.models import GraspNet, init_weights
    from graspnet_tpu_torch.nn.layers import fold_bn_eval
    from graspnet_tpu_torch.ops.cuda import build, multi_query, sa_feat_fused
    from graspnet_tpu_torch.ops.cuda.crop import sa_feat_fused_plain
    from graspnet_tpu_torch.scripts.ab_ball_kernels import device_ms, event_ms
    from graspnet_tpu_torch.scripts.ab_crop_scan import shapes

    ptxas = {}
    for text in build.build_all(("query", "crop")).values():
        ptxas.update(ptxas_records(text))
    cfg = GraspNetConfig()
    run = {"tree": tree, "package": str(Path(graspnet_tpu_torch.__file__).parent), "ptxas": ptxas}
    with torch.inference_mode():
        s = shapes(cfg, torch.from_numpy(np.load(data)).to("cuda"))
        model = init_weights(GraspNet(cfg), 1).to("cuda")
        for (x, c, f), name, sa in zip(s["sa_b2"], ("sa2", "sa3", "sa4"), (cfg.sa2, cfg.sa3, cfg.sa4)):
            folded = fold_bn_eval(getattr(model.backbone, name).mlp)
            for b in (2, 1):
                args = (x[:b], c[:b], f[:b], folded, sa.radius, sa.nsample)
                key = f"{name}_b{b}"
                try:
                    got = sa_feat_fused(*args)
                except ValueError:
                    run[key] = "out of domain"
                    continue
                want = sa_feat_fused_plain(*args)
                err = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
                if not err <= FEATURE_TOL:
                    raise AssertionError(f"{tree}: {key} differs from plain by {err} x scale")
                run[f"{key}_err"] = err
                run[key] = event_ms(lambda a=args: sa_feat_fused(*a), 20)
                run[f"{key}_device"] = device_ms(lambda a=args: sa_feat_fused(*a))
        geom = (cfg.cylinder_radius, cfg.hmin, tuple(cfg.hmax_list), cfg.crop_nsample)
        for b in (2, 1):
            run[f"multi_query_b{b}_device"] = device_ms(lambda b=b: multi_query(*s[f"serving_b{b}"], *geom))
    print(json.dumps(run))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True, help="checkouts to run, in order")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_sa_feat times CUDA kernels and needs a card")
    from graspnet_tpu_torch.utils.synthetic import tabletop_cloud
    from graspnet_tpu_torch.utils.timing import gpu_name_and_power

    rng = np.random.default_rng(0)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        data = str(Path(tmp) / "clouds.npy")
        np.save(data, np.stack([tabletop_cloud(rng) for _ in range(2)]))
        for i, tree in enumerate(args.trees):
            proc = subprocess.run([sys.executable, __file__, "--child", tree, data],
                                  capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError(f"run {i} ({tree}) failed:\n{proc.stdout}\n{proc.stderr}")
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    result = {"runs": runs, "gpu": gpu_name_and_power(), "source": "graspnet_tpu_torch/scripts/ab_sa_feat.py"}
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    return result


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        measure(*sys.argv[2:4])
    else:
        main()
