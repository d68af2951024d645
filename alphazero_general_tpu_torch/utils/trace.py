"""Phase tracing — the port of alphazero_general_tpu/utils/trace.py.

Every Coach phase (self-play, train, each arena) runs inside
:meth:`PhaseTracer.phase`, which records its wall seconds as a
``time/<phase>`` scalar through the metrics writer. With a ``profile_dir``
each phase also writes a torch.profiler trace (Chrome trace JSON, device
activity where there is a GPU) to ``<profile_dir>/<phase>-iterNNN.json``
for its first ``max_traces`` occurrences.
"""

from __future__ import annotations

import contextlib
import os
import time


class PhaseTracer:
    def __init__(self, writer, profile_dir: str = "", max_traces: int = 3):
        self.writer = writer
        self.profile_dir = profile_dir or ""
        self.max_traces = int(max_traces)
        self._counts: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str, step: int = 0):
        t0 = time.perf_counter()
        prof = None
        if self.profile_dir and self._counts.get(name, 0) < self.max_traces:
            import torch

            self._counts[name] = self._counts.get(name, 0) + 1
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        try:
            yield
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                os.makedirs(self.profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    self.profile_dir, f"{name}-iter{step:03d}.json"))
            self.writer.add_scalar(f"time/{name}",
                                   time.perf_counter() - t0, step)
