"""The device's idle share of a training step: 1 - the device's busy
time a step in the profiled stretch over the mean wall time of the
window's untraced steps.  The profiler slows the host, so the stretch's
own wall time would overstate the idle share of the steps it explains."""

from benchmark.metrics._common import mean, stretch

UNIT = "%"
WORKLOADS = ["train.recipe_b2"]


def read(records):
    s = stretch(records)
    step = mean(records.get("untraced_step_s", []))
    if s is None or not step:
        return None
    return 100.0 * (1.0 - s["busy_s"] / records["traced_steps"] / step)
