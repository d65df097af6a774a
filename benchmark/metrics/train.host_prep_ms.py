"""The training loader's label prep a scene (data/dataset.py): the mean
host time of `get_data_label` on the loader's threads, from the spans the
benchmark's dataset records around each call."""

from benchmark.metrics._common import mean

UNIT = "ms"
WORKLOADS = ["train.recipe_b2"]


def read(records):
    v = mean(records.get("spans", []))
    return None if v is None else v * 1e3
