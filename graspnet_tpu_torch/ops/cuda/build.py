"""Build and load the hand-written CUDA kernels (`graspnet_tpu_torch/csrc`).

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface, which `ctypes` loads; pointers and the
stream go in as `c_void_p`.  Nothing is built when a module is imported:
`load(name)` builds at first CUDA use, and `build_all()` starts one `nvcc`
per source at once so a cold process pays for the slowest build only.
Outputs go to `graspnet_tpu_torch/_build/` (listed in `.gitignore`), named
by a hash of the source and flags, so an edited source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
SOURCES = ("fps", "query", "crop")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (target, process or None if built)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return target, (proc, tmp)


def _finish(name: str, target: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent builder sees a whole file
    return out


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Build every kernel library in parallel; returns nvcc's output per
    source ('' when it was already built)."""
    names = tuple(names)
    jobs = {n: _start(n) for n in names}
    outputs, errors = {}, []
    for n in names:  # wait for every nvcc before raising, so none outlives the call
        try:
            outputs[n] = _finish(n, *jobs[n])
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return outputs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        target, job = _start(name)
        _finish(name, target, job)
        lib = ctypes.CDLL(str(target))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {err}")
