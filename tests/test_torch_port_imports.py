"""Import hygiene of the port: `graspnet_tpu_torch` and `chip_smoke.py`
import neither JAX nor anything of the JAX package, and build no kernel
when imported."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "graspnet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+graspnet_tpu\b(?!_torch)"
    r"|from\s+graspnet_tpu\s+import|from\s+graspnet_tpu\.)",
    re.MULTILINE,
)

BLOCKED_RUN = """
import sys
for name in ("jax", "jaxlib", "graspnet_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib, pkgutil
import numpy as np
import graspnet_tpu_torch
for mod in pkgutil.walk_packages(graspnet_tpu_torch.__path__, "graspnet_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
from graspnet_tpu_torch.apps import GraspPipeline
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.ops.cuda import build
p = GraspPipeline(cfg=GraspNetConfig.tiny(), device="cpu")
gg = p.get_grasps_topk(np.random.default_rng(0).uniform(-0.3, 0.3, (512, 3)).astype(np.float32))
assert gg.grasp_group_array.shape[1] == 17
assert not build._LIBS, "a kernel library was loaded on the CPU path"
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "graspnet_tpu") and sys.modules[m] is not None]
assert not bad, bad
print("ok", len(gg))
"""


def test_port_runs_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("ok")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    hits = BANNED.findall(path.read_text())
    assert not hits, f"{path.name} imports {hits}"


def test_banned_pattern_catches_imports():
    for line in ("import jax", "from jax import numpy", "import jax.numpy as jnp",
                 "from graspnet_tpu.ops import x", "from graspnet_tpu import ops",
                 "    import graspnet_tpu.models"):
        assert BANNED.search(line), line
    for line in ("import graspnet_tpu_torch", "from graspnet_tpu_torch.ops import x", "import jaxtyping"):
        assert not BANNED.search(line), line
