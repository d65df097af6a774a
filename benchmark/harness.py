"""Shared machinery of the benchmark: where its data lives, the guard
against the JAX package, a run's context and the table of checks.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in files of its own and is found by name:
`configs/<config>.json`, `workloads/<cell>.json` (which names its
configuration, its traffic and its driver), `drivers/<driver>.py` and
`metrics/<metric>.py`.  Adding a cell or a metric adds files only.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PROGRAM = "graspnet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "graspnet_tpu")  # top-level module names, compared whole


def top_level(module: str) -> str:
    return module.split(".", 1)[0]


def forbidden_loaded() -> List[str]:
    """Modules in this process whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if top_level(m) in FORBIDDEN})


def imported_names(path: Path) -> List[str]:
    """The absolute module names a source file imports (relative imports left out)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def import_violations() -> List[str]:
    """Sources of the benchmark that import JAX or the JAX package, and
    sources of the reference that import the program."""
    bad = []
    for path in sorted(BENCH.rglob("*.py")):
        in_reference = (BENCH / "reference") in path.parents
        for name in imported_names(path):
            top = top_level(name)
            if top in FORBIDDEN or (in_reference and top == PROGRAM):
                bad.append(f"{path.relative_to(ROOT)} imports {name}")
    return bad


def load_json(kind: str, name: str) -> Dict[str, Any]:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT)})")
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_readers(cell: str) -> Dict[str, Any]:
    """The per-layer metrics whose files list `cell` in `WORKLOADS`, by
    name.  A file without that list is an error: a metric added later
    must not change what the cells before it report."""
    readers = {}
    for path in sorted((BENCH / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        module = load_module(path, f"benchmark_metric_{path.stem.replace('.', '_').replace('-', '_')}")
        cells = getattr(module, "WORKLOADS", None)
        if not isinstance(cells, list):
            raise ValueError(f"{path.relative_to(ROOT)} lists no WORKLOADS")
        if cell in cells:
            readers[path.stem] = module
    return readers


def model_config(fields: Dict[str, Any], module):
    """`fields` (a configuration file's "model") as `module`'s GraspNetConfig
    (the program's or the reference's: both have its fields)."""
    kw = {}
    for k, v in fields.items():
        if k.startswith("sa") and isinstance(v, dict):
            kw[k] = module.SAConfig(v["npoint"], v["radius"], v["nsample"], tuple(v["mlp"]),
                                    v.get("normalize_xyz", True))
        elif isinstance(v, list):
            kw[k] = tuple(v)
        else:
            kw[k] = v
    return module.GraspNetConfig(**kw)


def card_power() -> str:
    """The card's name and power limit, as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else "not read"


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit; it passes at
    or below the limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


@dataclasses.dataclass
class Context:
    """What a driver gets, and what it fills in."""

    cell: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: str
    tmp: str
    t_start: float  # perf_counter at process start
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)  # tests: smaller shapes on the CPU
    fault: Optional[Callable[[Any], None]] = None  # tests: breaks the program under the timed path
    setup_s: Optional[float] = None
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    end_to_end: Dict[str, Tuple[float, str]] = dataclasses.field(default_factory=dict)
    records: Dict[str, Any] = dataclasses.field(default_factory=dict)
    checks: List[Check] = dataclasses.field(default_factory=list)

    @property
    def traffic(self) -> Dict[str, Any]:
        return {**self.workload["params"], **self.overrides.get("params", {})}

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]

    def model_fields(self) -> Dict[str, Any]:
        return self.overrides.get("model", self.config["model"])

    def weight_seed(self) -> int:
        return int(self.overrides.get("weight_seed", self.config["weights"]["seed"]))

    def setup_done(self) -> None:
        """Set-up ends here: the next request, frame or step is timed."""
        if self.setup_s is None:
            self.setup_s = time.perf_counter() - self.t_start

    def read_memory_peak(self) -> None:
        import torch

        if self.device != "cpu":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    def check(self, name: str, value: float) -> None:
        self.checks.append(Check(name, float(value), float(self.limits[name])))
