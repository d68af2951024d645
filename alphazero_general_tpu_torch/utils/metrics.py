"""Scalar metrics to ``metrics.jsonl`` (always) and TensorBoard (where its
package is installed) — the port of alphazero_general_tpu/utils/metrics.py.

The tags are the reference's (Coach.py:278, 360, 393-398, 521-523, 556,
590): ``loss/{policy,value,total,sample_time}``, ``win_rate/{playerN,draws,
avg_game_length,past,baseline,self_play_model}``, plus the JAX package's
``win_rate/past_decided``, ``train/*`` and ``time/*``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsWriter:
    def __init__(self, log_dir: str, run_name: str = ""):
        self.dir = os.path.join(log_dir, run_name) if run_name else log_dir
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=self.dir)
        except ImportError:  # the tensorboard package is optional
            self._tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "ts": time.time()}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    def add_scalar(self, *a, **k) -> None:
        pass

    def close(self) -> None:
        pass


def make_writer(log_dir: Optional[str], run_name: str = ""):
    if not log_dir:
        return NullWriter()
    return MetricsWriter(log_dir, run_name)
