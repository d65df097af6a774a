"""The training CLI's loop, `apps/train.py::train`, over seeded scenes.

Set-up builds one `Trainer` (the benchmark's weights, the recipe's Adam)
and one dataset: a subclass of the port's `GraspNetDataset` over a seeded
production-shape scene (`inputs/scenes.py`), so the real `get_data_label`
label prep runs on the loader's threads.  `train` runs once; its `stop`
hook, called after every step, ends set-up after `warm_steps` steps and
the window `--seconds` later.  The epoch holds more steps than any window,
so the epoch-end eval pass and checkpoint never fall inside it.
`train_kernel_ms_per_step` is the device's kernel time over the window
(`trace.KernelClock`, device activity alone, from the window's opening to
its last step) over the steps that ended in it.  The loop is bound by the
host, whose pace differs from process to process by more than an
end-to-end bound may allow, so the scenes per second it reaches are a
per-layer metric (`train.scenes_per_s`, over a traced run's untraced
steps) and, in a `--trace 0` run, a line on standard error.  The first `check_steps` steps (set-up, driven through the
window's own loop and loader) are the ones the reference follows: the
hook keeps their losses, Adam's first moments after step 1, and the
weights and the BN running stats after the last of them.  Traffic
parameters:

- `frames`: frames of the epoch (every frame reads the one scene);
- `objects`, `label_points`, `cloud_points`: the scene's shape;
- `warm_steps`: steps before the window (at least `check_steps`);
- `trace_steps`: steps of the profiled stretch of a `--trace 1` run, from
  a third of the window on;
- `check_steps`: steps the reference follows.
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time


from benchmark import harness, roofline, trace
from benchmark.inputs.scenes import make_scene
from benchmark.weights import make_weights

SCENE = "scene_bench"


def dataset_class():
    """The loader's dataset: the port's `GraspNetDataset` over the scene,
    recording the host time of each `get_data_label`."""
    from graspnet_tpu_torch.data.dataset import GraspNetDataset

    class Scenes(GraspNetDataset):
        def __init__(self, scene, frames: int, cfg, num_workers: int):
            super().__init__(root="<benchmark>", valid_obj_idxs=list(scene["grasp_labels"]),
                             grasp_labels=scene["grasp_labels"], split="train", num_points=cfg.num_point,
                             remove_outlier=False, remove_invisible=True, augment=True, load_label=True,
                             cfg=cfg, seed=0, label_mode="compact")
            self.scene = scene
            self.frames = [(SCENE, f) for f in range(frames)]
            self.collision_labels = {SCENE: scene["collision"]}
            self.spans = []  # (start, end) host seconds of each get_data_label
            self._spans_lock = threading.Lock()

        def _load_frame(self, scene: str, frame: int):
            return self.scene["cloud"], self.scene["seg"], self.scene["meta"]

        def get_data_label(self, index: int):
            t0 = time.perf_counter()
            out = super().get_data_label(index)
            with self._spans_lock:
                self.spans.append((t0, time.perf_counter()))
            return out

    return Scenes


class Logger:
    """The loop's logger: keeps each step's metrics, writes nothing."""

    def __init__(self):
        self.steps = []

    def log(self, msg: str) -> None:
        pass

    def accumulate(self, metrics) -> None:
        self.steps.append({k: float(v) for k, v in metrics.items()})

    def flush(self, *args) -> None:
        pass

    def close(self) -> None:
        pass


def run(ctx) -> None:
    import torch
    from graspnet_tpu_torch import config as program_config
    from graspnet_tpu_torch.apps import train as cli_train
    from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer

    p = ctx.traffic
    tr = ctx.config["train"]
    cfg = harness.model_config(ctx.model_fields(), program_config)
    scene = make_scene(ctx.seed, cfg.num_view, cfg.num_angle, cfg.num_depth, int(p["objects"]),
                       int(p["label_points"]), int(p["cloud_points"]), device=ctx.device)
    ctx.records["scene"] = scene
    ds = dataset_class()(scene, int(p["frames"]), cfg, int(tr["num_workers"]))
    tc = TrainConfig(learning_rate=tr["learning_rate"], weight_decay=tr["weight_decay"], max_epoch=tr["max_epoch"],
                     batch_size=tr["batch_size"], lr_decay_epochs=tuple(tr["lr_decay_epochs"]),
                     lr_decay_rates=tuple(tr["lr_decay_rates"]), bn_decay_step=tr["bn_decay_step"],
                     bn_decay_rate=tr["bn_decay_rate"])
    trainer = Trainer(cfg=cfg, tc=tc, device=ctx.device)
    shapes = {k: tuple(v.shape) for k, v in trainer.model.state_dict().items()}
    weights = make_weights(shapes, ctx.weight_seed(), ctx.device)
    trainer.model.load_state_dict(weights)
    ctx.records["weights"] = {k: v.to("cpu") for k, v in weights.items()}
    del weights
    if ctx.fault is not None:
        ctx.fault(trainer)
    warm, check_steps = int(p["warm_steps"]), int(p["check_steps"])
    if warm < check_steps:
        raise ValueError("the window may not start before the steps the reference follows")
    names = [n for n, _ in trainer.model.named_parameters()]
    state = {"step": 0, "window_from": None, "deadline": None, "prof": None, "clock": None}
    timed_kernels = not ctx.trace and ctx.device != "cpu"
    kept = {}

    def at_step_end() -> bool:
        state["step"] += 1
        step = state["step"]
        if step == 1:
            opt_state = trainer.opt.state
            kept["exp_avg"] = {n: opt_state[q]["exp_avg"].detach().to("cpu").clone()
                               for n, q in zip(names, trainer.model.parameters()) if q in opt_state}
        if step == check_steps:
            kept["params"] = {n: q.detach().to("cpu").clone() for n, q in trainer.model.named_parameters()}
            kept["buffers"] = {n: b.detach().to("cpu").clone() for n, b in trainer.model.named_buffers()}
        if step == warm:
            if ctx.device != "cpu":
                torch.cuda.synchronize()
            if timed_kernels:  # its start-up is set-up's
                state["clock"] = trace.KernelClock().__enter__()
            ctx.setup_done()
            now = time.perf_counter()
            state["window_from"], state["deadline"] = now, now + ctx.seconds
            state["trace_from"] = now + ctx.seconds / 3
            return False
        if state["deadline"] is None:
            return False
        now = time.perf_counter()
        if ctx.trace and state["prof"] is None and now >= state["trace_from"]:
            state["prof"] = trace.Traced(ctx.tmp).__enter__()
            state["prof_from"] = step
        elif state["prof"] is not None and "trace" not in ctx.records and \
                step - state["prof_from"] >= int(p["trace_steps"]):
            state["prof"].__exit__(None, None, None)
            ctx.records["trace"] = trace.summarize(state["prof"].path)
            ctx.records["traced_steps"] = step - state["prof_from"]
            os.remove(state["prof"].path)
        if now < state["deadline"]:
            return False
        if state["clock"] is not None:
            state["clock"].__exit__(None, None, None)
        return True

    logger = Logger()
    out = cli_train.train(trainer, ds, ds, logger, os.path.join(ctx.tmp, "log"), num_workers=int(tr["num_workers"]),
                          label_mode=tr["label_mode"], log_every=1 << 30, stop=at_step_end)
    ctx.read_memory_peak()
    ends = out["step_end_s"]
    if state["window_from"] is None or len(ends) <= warm:
        raise RuntimeError(f"the loop ran {len(ends)} steps: the window never opened")
    steps = len(ends) - warm
    ctx.attempted = steps
    # steps s = warm+1 .. len(ends) end at ends[s-1]; the profiled ones, and
    # the next (which waits for the trace's reduction), are left out
    p0 = state.get("prof_from")
    traced = range(p0 + 1, p0 + ctx.records.get("traced_steps", len(ends)) + 2) if p0 is not None else range(0)
    untraced = [ends[s - 1] - ends[s - 2] for s in range(warm + 1, len(ends) + 1) if s not in traced]
    scenes_per_s = tc.batch_size * steps / (ends[-1] - ends[warm - 1])
    clock = state["clock"]
    if clock is not None:
        if clock.seconds is None:
            raise RuntimeError("the profiler recorded no kernel in the window")
        ctx.end_to_end["train_kernel_ms_per_step"] = (1e3 * clock.seconds / steps, "ms")
        print(f"window: {steps} steps, {clock.kernels} kernels, {scenes_per_s!r} scenes/s (host clock, not bounded)",
              file=sys.stderr)
    ctx.records.update(losses=[s["loss/overall_loss"] for s in logger.steps[:check_steps]], kept=kept,
                       window_s=ends[-1] - ends[warm - 1], window_steps=steps, untraced_step_s=untraced,
                       batch_size=tc.batch_size,
                       step_flops=roofline.train_step_flops(cfg, tc.batch_size),
                       k7_bwd_bound_s=roofline.mlp_train_backward_bound_s(cfg, tc.batch_size),
                       spans=[b - a for a, b in ds.spans], dataset_frames=int(p["frames"]))
    trainer.opt.state.clear()
    del trainer, ds
    gc.collect()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()


def check(ctx) -> None:
    """The reference follows the first `check_steps` steps from the same
    weights on the frames the loader fed them."""
    from benchmark.reference import train_ref

    p = ctx.traffic
    rec = ctx.records
    cfg_fields = ctx.model_fields()
    readings = train_ref.follow(cfg_fields, ctx.config["train"], rec["scene"], rec["weights"], int(p["frames"]),
                                int(p["check_steps"]), ctx.device)
    got = {"losses": rec["losses"], "grad": train_ref.gradient_from_adam(rec["kept"]["exp_avg"]),
           "params": rec["kept"]["params"], "buffers": rec["kept"]["buffers"]}
    for name, value in train_ref.compare(got, readings, rec["weights"]).items():
        if name in ctx.limits:  # a number with no limit is read, not compared (PERF.md §2)
            ctx.check(name, value)
