"""Readers of a ``torch.profiler`` trace of the card, kept with the
benchmark: device activity (kernels, copies and fills), its union over the
traced window, time by device operation, and the device's idle gaps named
by the host operation that launched the work ending each gap."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

DEVICE = torch.autograd.DeviceType.CUDA
NAME_CHARS = 120


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


class Traced:
    """A traced window: ``with Traced(host_ops) as t: ...`` synchronises
    the card at both ends and profiles what runs between them; then
    ``t.window_s``, ``t.device`` [(name, start_ns, end_ns, correlation)]
    and, with ``host_ops``, the host's operations too."""

    def __init__(self, host_ops: bool = False):
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if host_ops:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self.host_ops = host_ops
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        torch.cuda.synchronize()
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events = self.prof.profiler.kineto_results.events()
        self.device, self.host = [], []
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DEVICE:
                self.device.append((e.name(), start, end, e.correlation_id()))
            else:
                self.host.append((e.name(), start, end, e.correlation_id()))
        self.device.sort(key=lambda x: x[1])
        return False

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union)."""
        total, cur_s, cur_e = 0, None, None
        for _, s, e, _ in self.device:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e9

    def seconds_of(self, key: str) -> float:
        """Device seconds of the operations whose name contains ``key``."""
        return sum(e - s for n, s, e, _ in self.device if key in n) / 1e9

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most."""
        by = defaultdict(int)
        for n, s, e, _ in self.device:
            by[_short(n)] += e - s
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[name, seconds]]: the device's idle time between its busy
        intervals, summed by the innermost host operation that was running
        when the work ending each gap was launched (needs ``host_ops``)."""
        if not self.host_ops or not self.device:
            return []
        launches = {c: s for n, s, _, c in self.host
                    if n.startswith("cuda") and c}
        ops = sorted((s, e, n) for n, s, e, _ in self.host
                     if not n.startswith("cuda"))
        starts = [o[0] for o in ops]

        def host_op(t):
            i = bisect.bisect_right(starts, t) - 1
            best = None
            for j in range(i, max(i - 256, -1), -1):
                s, e, n = ops[j]
                if e >= t and (best is None or s > best[0]):
                    best = (s, n)
            return best[1] if best else "host outside traced operations"

        by = defaultdict(int)
        cur_e = None
        for n, s, e, c in self.device:
            if cur_e is not None and s > cur_e:
                t = launches.get(c, s)
                by[_short(host_op(t))] += s - cur_e
            cur_e = e if cur_e is None else max(cur_e, e)
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda x: -x[1])[:top]]
