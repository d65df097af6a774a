"""Metric logging: stdout, a log file and a JSONL record per flush.

Counterpart of `graspnet_tpu/utils/logging.py::MetricLogger` (the
reference's log_string + SummaryWriter, train.py:55-60, 114-116): metrics
accumulate per window and flush as one JSONL record per step, which any
dashboard can tail.  The JAX package also mirrors the scalars to
TensorBoard where it is installed; the port does not (`metrics.jsonl` holds
the same numbers).
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Any, Dict

import numpy as np


class MetricLogger:
    def __init__(self, log_dir: str, filename: str = "log_train.txt"):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._file = open(os.path.join(log_dir, filename), "a")
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._acc: Dict[str, list] = defaultdict(list)

    def log(self, msg: str) -> None:
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        self._file.write(line + "\n")
        self._file.flush()

    def accumulate(self, metrics: Dict[str, Any]) -> None:
        """Add one step's scalars (tensors are read to the host here)."""
        for k, v in metrics.items():
            v = float(v)
            if np.isfinite(v):
                self._acc[k].append(v)

    def flush(self, prefix: str, step: int) -> Dict[str, float]:
        means = {k: float(np.mean(v)) for k, v in self._acc.items() if v}
        self._acc.clear()
        self._jsonl.write(json.dumps({"step": step, "prefix": prefix, **means}) + "\n")
        self._jsonl.flush()
        shown = {k: round(v, 4) for k, v in list(means.items())[:6]}
        self.log(f"{prefix} step {step}: {shown}")
        return means

    def close(self) -> None:
        self._file.close()
        self._jsonl.close()
