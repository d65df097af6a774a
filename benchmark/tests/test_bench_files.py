"""The benchmark's data: every configuration and cell file loads and names
what exists, `BENCHMARK.json` agrees with the files, and every name and
unit keeps to the allowed characters."""

import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.BENCH
SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))
CONFIGS = sorted(p.stem for p in (BENCH / "configs").glob("*.json"))


@pytest.mark.parametrize("cell", CELLS)
def test_workload_file_names_what_exists(cell):
    w = harness.load_json("workloads", cell)
    assert w["name"] == cell and NAME.match(cell) and NAME.match(w["traffic"])
    harness.load_json("configs", w["config"])
    assert (BENCH / "drivers" / f"{w['driver']}.py").is_file()
    assert w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    assert w["limits"] and all(isinstance(v, (int, float)) for v in w["limits"].values())


@pytest.mark.parametrize("config", CONFIGS)
def test_config_file_loads_into_both_sides(config):
    from graspnet_tpu_torch import config as program_config

    from benchmark.reference import gn

    c = harness.load_json("configs", config)
    assert c["name"] == config and NAME.match(config)
    assert c["source"].startswith("https://")
    a = harness.model_config(c["model"], program_config)
    b = harness.model_config(c["model"], gn)
    assert str(a) == str(b).replace("benchmark.reference.gn.config", "graspnet_tpu_torch.config")
    assert all(NAME.match(k) for k in c["reduced"])


def test_benchmark_json_matches_the_files():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert {c["name"] for c in SPEC["configs"]} <= set(CONFIGS)
    for c in SPEC["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert harness.load_json("configs", c["name"])["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        f = harness.load_json("workloads", w["name"])
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (f["config"], f["traffic"], f["chips"], f["why"])
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        reader = harness.load_module(BENCH / "metrics" / f"{m['name']}.py", "m")
        assert reader.UNIT == m["unit"]
        assert set(m["workloads"]) <= set(reader.WORKLOADS) and set(m["workloads"]) <= cells


def test_names_and_units_use_the_allowed_characters():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in SPEC["workloads"]] + \
        [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
