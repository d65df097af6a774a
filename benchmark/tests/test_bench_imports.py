"""Nothing the benchmark loads is JAX or the JAX package, and the reference
imports nothing of the program; compared by whole top-level names."""

import subprocess
import sys

from benchmark import harness


def test_no_source_imports_what_it_may_not():
    assert harness.import_violations() == []


def test_the_check_compares_whole_top_level_names(tmp_path, monkeypatch):
    assert harness.top_level("graspnet_tpu_torch.models") == "graspnet_tpu_torch"
    assert "graspnet_tpu_torch" not in harness.FORBIDDEN and "graspnet_tpu" in harness.FORBIDDEN
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom graspnet_tpu.models import x\nimport graspnet_tpu_torch\n")
    assert harness.imported_names(bad) == ["jax.numpy", "graspnet_tpu.models", "graspnet_tpu_torch"]


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import run; from benchmark.tests import tiny; "
            "run.run_cell('infer.robot_b1', 3, 0.5, True, device='cpu', overrides=tiny.overrides('infer.robot_b1')); "
            "from benchmark import harness; print(harness.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
