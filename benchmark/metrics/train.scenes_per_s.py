"""Scenes a second that `apps/train.py::train` reaches: the batch size
times the window's untraced steps over their host time (the profiled
stretch slows the host, so its steps are left out).  The host's pace
differs from process to process by more than an end-to-end bound may
allow, so this rate has no bound (PERF.md §2)."""

UNIT = "scenes/s"
WORKLOADS = ["train.recipe_b2"]


def read(records):
    steps = records.get("untraced_step_s", [])
    if not steps:
        return None
    return records["batch_size"] * len(steps) / sum(steps)
