"""The port's kept timing scripts on the CPU: `span_cost` prints its three
costs, and `bench_service` at `--device cpu --tiny` prints one JSON line
with the keys of its JAX counterpart under `scripts/`.  The times
themselves are host-clock numbers here and are not checked beyond being
finite and positive.
"""

import ast
import json
import math
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_span_cost_prints_the_three_costs(capsys):
    """The span cost script's three readings, in ns a span, on a short loop
    (the times are the host's and only checked to be positive)."""
    from graspnet_tpu_torch.scripts import span_cost

    assert span_cost.main(["--n", "500", "--repeats", "2"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["spans"] == 500 and all(got[k] > 0 for k in ("off_ns", "on_ns", "profiler_ns"))


def jax_dict_keys(script: str, name: str):
    """The keys of the dict literal assigned to `name` (or returned) in a JAX script."""
    tree = ast.parse((ROOT / "scripts" / script).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == name \
                and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys}
        if name == "return" and isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no dict {name} in {script}")


def test_bench_service_prints_jax_keys(capsys):
    """`bench_service` at `--device cpu --tiny`: one JSON object with every
    key of the JAX script's result and of each of its modes, the requests
    served at max_batch 1 and 8, a dispatch per request unbatched and fewer
    batched, and no kernel launched on the CPU."""
    from graspnet_tpu_torch.scripts import bench_service

    result = bench_service.main(["--device", "cpu", "--tiny", "--requests", "12", "--clients", "4"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    want = jax_dict_keys("bench_service.py", "result")
    assert {"value", "unit", "speedup_vs_unbatched", "modes"} <= want <= set(line), want - set(line)
    mode_keys = jax_dict_keys("bench_service.py", "return")
    assert "device_dispatches" in mode_keys
    unbatched, batched = line["modes"]
    for mode in (unbatched, batched):
        assert mode_keys <= set(mode), mode_keys - set(mode)
        assert mode["requests"] == mode["ok"] == 12 and math.isfinite(mode["requests_per_s"])
        assert set(mode["launches_per_dispatch"].values()) == {0}
    assert (unbatched["max_batch"], batched["max_batch"]) == (1, 8)
    assert unbatched["device_dispatches"] == 12 and 1 <= batched["device_dispatches"] <= 12
    assert line["unit"] == "requests/s" and line["backend"] == "cpu" and line["gpu"] is None
