"""Metrics logging: structured JSONL + optional TensorBoard (a copy of
the JAX package's training/metrics.py): every scalar goes to ``expdir/logs/metrics.jsonl`` (the machine-readable
experiment record) and, when torch.utils.tensorboard is importable, to
TensorBoard event files as well.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricWriter:
    def __init__(self, logdir: str, tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._file = open(self.path, "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(logdir, "tb"))
            except Exception:
                self._tb = None

    def write(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        rec = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            name = f"{prefix}{k}" if prefix else k
            rec[name] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(name, float(v), step)
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()
        if self._tb is not None:
            self._tb.close()
