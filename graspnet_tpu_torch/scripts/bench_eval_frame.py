"""AP-evaluator frame throughput on the host, the counterpart of
`scripts/bench_eval_frame.py`.

    python -m graspnet_tpu_torch.scripts.bench_eval_frame [--repeats 10] [--out FILE]

Times `eval/ap.py::eval_frame` on two fixed frames of the real frame's
shape (9 objects x 3000 model points, 256 dumped grasps, the 109k-point
table slab):

  * collision-heavy: random grasps, nearly all of which die at the
    collision / empty stage; times NMS (the host library's), the object
    assignment and the grid-pruned collision sweep;
  * force-closure-heavy: grasps on object surfaces with radial approach
    axes, so the top 50 survive to `min_friction` (contact search and the
    cone ladder), as a trained model's dump does.

Normals are computed once per object and left out (a real eval caches them
per object).  The evaluator is host code: these are host-CPU times, and
`host_cores` says on how many cores; the full-eval projection divides 190
scenes x 256 frames at the force-closure-heavy time over them.
"""

import argparse
import json
import os
import time


def build_workload(seed=0, n_obj=9, model_pts=3000, n_grasps=256):
    import numpy as np
    import scipy.spatial.transform as st

    from graspnet_tpu_torch.eval.ap import create_table_points
    from graspnet_tpu_torch.eval.force_closure import estimate_normals

    rng = np.random.default_rng(seed)
    clouds = [
        rng.uniform(-0.04, 0.04, (model_pts, 3)).astype(np.float32)
        for _ in range(n_obj)
    ]
    normals = [estimate_normals(c) for c in clouds]
    poses = []
    for _ in range(n_obj):
        R = st.Rotation.random(
            random_state=int(rng.integers(1 << 31))
        ).as_matrix().astype(np.float32)
        t = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
        t[2] += 0.5
        P = np.zeros((3, 4), np.float32)
        P[:3, :3] = R
        P[:, 3] = t
        poses.append(P)
    g = np.zeros((n_grasps, 17), np.float32)
    g[:, 0] = rng.uniform(0, 1, n_grasps)
    g[:, 1] = rng.uniform(0.02, 0.1, n_grasps)
    g[:, 2] = 0.02
    g[:, 3] = rng.uniform(0.01, 0.04, n_grasps)
    g[:, 4:13] = (
        st.Rotation.random(n_grasps, random_state=3)
        .as_matrix()
        .reshape(n_grasps, 9)
        .astype(np.float32)
    )
    oi = rng.integers(0, n_obj, n_grasps)
    g[:, 13:16] = np.stack(
        [
            clouds[o][rng.integers(0, model_pts)] @ poses[o][:3, :3].T
            + poses[o][:, 3]
            for o in oi
        ]
    )
    return g, clouds, normals, poses, create_table_points()


def build_fc_workload(seed=0, n_obj=9, model_pts=3000, n_grasps=256):
    """Force-closure-heavy frame: grasps constructed ON object surfaces
    with radial approach axes, so a realistic fraction survives the
    collision/empty stage and min_friction runs hot (the configuration a
    real trained-model eval produces)."""
    import numpy as np

    from graspnet_tpu_torch.eval.ap import create_table_points
    from graspnet_tpu_torch.eval.force_closure import estimate_normals
    from graspnet_tpu_torch.models import geometry

    rng = np.random.default_rng(seed)
    radius = 0.03
    # sphere surfaces (graspable from any radial direction), objects on a
    # spaced grid so cross-object collisions stay realistic, not dominant
    clouds = []
    for o in range(n_obj):
        base = geometry.generate_grasp_views_np(model_pts) * radius
        clouds.append(
            (base + rng.normal(0, 5e-4, base.shape)).astype(np.float32)
        )
    normals = [estimate_normals(c) for c in clouds]
    poses = []
    for o in range(n_obj):
        P = np.zeros((3, 4), np.float32)
        P[:3, :3] = np.eye(3)
        P[:, 3] = [0.25 * (o % 3) - 0.25, 0.25 * (o // 3) - 0.25, 0.5]
        poses.append(P)
    g = np.zeros((n_grasps, 17), np.float32)
    g[:, 0] = rng.uniform(0, 1, n_grasps)
    g[:, 1] = 0.09  # jaws clear the 3 cm sphere, contacts near the poles
    g[:, 2] = 0.02
    g[:, 3] = 0.04
    oi = rng.integers(0, n_obj, n_grasps)
    for k in range(n_grasps):
        o = int(oi[k])
        p = clouds[o][rng.integers(0, model_pts)]
        approach = -p / max(np.linalg.norm(p), 1e-9)  # radial, inward
        rot = geometry.batch_viewpoint_params_to_matrix_np(
            approach[None], rng.uniform(0, np.pi, 1).astype(np.float32)
        )[0]
        g[k, 4:13] = rot.reshape(9)
        g[k, 13:16] = p + poses[o][:, 3]
    return g, clouds, normals, poses, create_table_points()


def _timed(eval_frame, workload, repeats):
    """(ms/frame, fc_calls/frame, fc_ms/frame) for one workload."""
    import graspnet_tpu_torch.eval.ap as ap_mod

    g, clouds, normals, poses, table = workload
    eval_frame(g, clouds, normals, poses, table=table)  # warm
    counters = {"n": 0, "s": 0.0}
    real_mf = ap_mod.min_friction

    def counting_mf(*a, **kw):
        t = time.perf_counter()
        out = real_mf(*a, **kw)
        counters["n"] += 1
        counters["s"] += time.perf_counter() - t
        return out

    ap_mod.min_friction = counting_mf
    try:
        t0 = time.perf_counter()
        for _ in range(repeats):
            acc = eval_frame(g, clouds, normals, poses, table=table)
        ms = (time.perf_counter() - t0) / repeats * 1000
    finally:
        ap_mod.min_friction = real_mf
    return (
        ms,
        counters["n"] / repeats,
        counters["s"] / repeats * 1000,
        acc,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from graspnet_tpu_torch.eval.ap import eval_frame

    coll_ms, coll_n, coll_fc_ms, coll_acc = _timed(
        eval_frame, build_workload(), args.repeats
    )
    fc_ms, fc_n, fc_fc_ms, fc_acc = _timed(
        eval_frame, build_fc_workload(), args.repeats
    )
    # full-eval projection: 190 test scenes x 256 frames, the FC-heavy
    # per-frame cost, divided across eval worker processes
    frames = 190 * 256
    workers = max(os.cpu_count() or 1, 1)
    proj_min = frames * fc_ms / 1000 / 60 / workers
    result = {
        "metric": "eval_frame wall time, force-closure-heavy frame "
        "(9 spheres x 3k pts, 256 surface grasps, 109k-pt table slab)",
        "value": round(fc_ms, 1),
        "unit": "ms/frame",
        "stage_ms": {
            "eval_frame_fc_heavy": round(fc_ms, 3),
            "eval_frame_collision_heavy": round(coll_ms, 3),
        },
        "fc_heavy": {
            "ms_per_frame": round(fc_ms, 2),
            "min_friction_calls_per_frame": round(fc_n, 1),
            "min_friction_ms_per_frame": round(fc_fc_ms, 2),
            "acc_checksum": float(fc_acc.sum()),
        },
        "collision_heavy": {
            "ms_per_frame": round(coll_ms, 2),
            "min_friction_calls_per_frame": round(coll_n, 1),
            "min_friction_ms_per_frame": round(coll_fc_ms, 2),
            "acc_checksum": float(coll_acc.sum()),
        },
        "full_eval_projection": {
            "frames": frames,
            "workers": workers,
            "minutes": round(proj_min, 1),
            "note": "190 scenes x 256 frames at the FC-heavy per-frame "
            "cost across all host cores (eval_all proc pool)",
        },
        "backend": "cpu",
        "source": "graspnet_tpu_torch/scripts/bench_eval_frame.py",
        "host_cores": len(os.sched_getaffinity(0)),
        "note": "host-CPU protocol evaluation; normals excluded (cached "
        "per object across a real eval)",
    }
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    return result


if __name__ == "__main__":
    main()
