"""The device's busy time a training step (train/trainer.py's
`step_prepared` and the loop's `prepare`): the union of device intervals
over the profiled stretch of steps past set-up, over its steps."""

from benchmark.metrics._common import stretch

UNIT = "ms"
WORKLOADS = ["train.recipe_b2"]


def read(records):
    s = stretch(records)
    if s is None:
        return None
    return 1e3 * s["busy_s"] / records["traced_steps"]
