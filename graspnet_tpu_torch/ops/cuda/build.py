"""Build and load the port's native libraries (`graspnet_tpu_torch/csrc`).

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface, which `ctypes` loads; pointers and the
stream go in as `c_void_p`; the `csrc/*.cuh` headers they share are
hashed into each library's name.  `csrc/host.cpp`, the host label library
(`native.py`), compiles with `g++` beside them.  Nothing is built when a
module is imported: `load(name)` builds at first use, and `build_all()`
starts one compiler per source at once so a cold process pays for the
slowest build only.  Outputs go to `graspnet_tpu_torch/_build/` (listed in
`.gitignore`), named by a hash of the source and flags, so an edited source
rebuilds; the host library's name also hashes what `-march=native` means on
this machine, so a library built for one CPU is never loaded on another.
A failed build raises: there is no fallback.  Every launcher makes its
tensors' card current around the ctypes call (`on_device`): the C side
launches on the device that `cudaGetDevice` names.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
HOST = "host"  # csrc/host.cpp, built with g++
# what `build_all` builds by default: the libraries of GraspNet's paths and
# VoteNet's backbone; `attn` (Group-Free-3D's and Point Transformer V3's
# attention), `boxes` (the detectors' empty-box count) and `spconv` (Point
# Transformer V3's sparse convolution) build at their first use only
SOURCES = ("fps", "query", "crop", "mlp_train", "scatter", "voxel", "sa", HOST)
LAZY = ("attn", "boxes", "spconv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# -ffp-contract=off: no FMA contraction, so every distance rounds as the
# numpy plain versions' do and the selections equal theirs
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-shared", "-fopenmp")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()  # loader threads may reach a library's first use at once
BUILD_SECONDS: Dict[str, float] = {}  # wall seconds of each compiler run of this process
_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's `launches`.  Under a lock: the
    service's threads launch kernels at once, and `+=` on an attribute is
    a read-modify-write that a thread switch can split."""
    with _COUNT_LOCK:
        wrapper.launches += 1


@contextlib.contextmanager
def on_device(device: torch.device) -> Iterator[int]:
    """Make `device` the current CUDA device for a launcher's ctypes call
    and yield the handle of its current stream.  The C launchers launch on
    the current device and set its shared memory limits there, so a tensor
    on cuda:1 reached from a thread whose current device is cuda:0 would
    otherwise be launched on with another device's stream.  Through the
    calls beneath `torch.cuda.device` and `current_stream`: their Python
    objects cost most of a small kernel's host time a launch."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    prev = torch.cuda._exchange_device(index)
    try:
        yield torch._C._cuda_getCurrentRawStream(index)
    finally:
        torch.cuda._maybe_exchange_device(prev)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the host label library (csrc/host.cpp) needs it")
    return found


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name == HOST else f"{name}.cu")


def _command(name: str, out: Path) -> list:
    if name == HOST:
        return [_gxx(), *GXX_FLAGS, "-o", str(out), str(_source(name))]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(_source(name))]


def _native_target() -> bytes:
    """What g++'s -march=native resolves to here: the target options it
    prints, which name the CPU and every instruction set it enables."""
    out = subprocess.run([_gxx(), "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.encode()


def _target(name: str) -> Path:
    digest = hashlib.sha256(_source(name).read_bytes())
    if name == HOST:
        digest.update(" ".join(GXX_FLAGS).encode())
        digest.update(_native_target())
    else:
        digest.update(" ".join(NVCC_FLAGS).encode())
        for header in sorted(CSRC.glob("*.cuh")):  # the headers the .cu sources include
            digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start the compiler for one source; returns (target, job or None if built)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        _command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return target, (proc, tmp, time.perf_counter())


def _finish(name: str, target: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp, t0 = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"building csrc/{_source(name).name} failed:\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent builder sees a whole file
    return out


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Build every library in parallel; returns the compiler's output per
    source ('' when it was already built) and records each run's wall
    seconds in BUILD_SECONDS."""
    names = tuple(names)
    with _LOCK:
        jobs = {n: _start(n) for n in names}
        running = {n for n, (_, job) in jobs.items() if job is not None}
        while running:  # each source's time ends when its own compiler does
            for n in list(running):
                proc, _, t0 = jobs[n][1]
                if proc.poll() is not None:
                    BUILD_SECONDS[n] = time.perf_counter() - t0
                    running.discard(n)
            time.sleep(0.02)
        outputs, errors = {}, []
        for n in names:  # every compiler has ended before this raises
            try:
                outputs[n] = _finish(n, *jobs[n])
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return outputs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (or host.cpp), built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            target, job = _start(name)
            _finish(name, target, job)
            if job is not None:
                BUILD_SECONDS[name] = time.perf_counter() - job[2]
            lib = ctypes.CDLL(str(target))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {err}")
