"""Phase tracing and the search's stage spans — the port of
alphazero_general_tpu/utils/trace.py, with spans of its own.

Every Coach phase (self-play, train, each arena) runs inside
:meth:`PhaseTracer.phase`, which records its wall seconds as a
``time/<phase>`` scalar through the metrics writer. With a ``profile_dir``
each phase also writes a torch.profiler trace (Chrome trace JSON, device
activity where there is a GPU) to ``<profile_dir>/<phase>-iterNNN.json``
for its first ``max_traces`` occurrences, and runs inside :func:`tracing`,
so the trace shows the search's stage ranges over the device's kernels.

Spans and counters. The search (``mcts/search.py``) wraps its stages in
:func:`span` and counts its work with :func:`count`:

* ``search``: a whole ``search()`` call;
* ``search.descend``, ``search.expand``, ``search.network``,
  ``search.install``, ``search.backup``: a simulation's stages (a round of
  walks makes one ``search.network`` call);
* ``search.simulations``: the batch simulations a search runs (one
  simulation of every game), and ``network.rows``: the rows it forwards.

Tracing is off by default, and then :func:`span` returns one shared
do-nothing context and :func:`count` returns at once: no torch call, no
allocation, no clock read. Inside :func:`tracing`, a span adds its host
seconds (``time.perf_counter_ns``) and its calls to in-memory totals, and
under an active ``torch.profiler`` it also opens a
``torch.profiler.record_function`` range, which lies on the clock of the
trace's device events. :func:`snapshot` reads the totals and counters,
:func:`reset` clears them; nothing is written from the hot path. The
state is the process's: spans of every thread add to the same totals.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_on = False
_OFF = contextlib.nullcontext()
_totals: dict = {}  # span name -> [calls, host ns]
_counters: dict = {}  # counter name -> total


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        total = _totals.setdefault(self.name, [0, 0])
        total[0] += 1
        total[1] += dt
        return False


def span(name: str):
    """A context that times its body as the span ``name`` while tracing is
    on, and does nothing while it is off."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _on:
        _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def tracing():
    """Turn spans and counters on for the body; restore the state after."""
    global _on
    before = _on
    _on = True
    try:
        yield
    finally:
        _on = before


def snapshot() -> dict:
    """{"spans": {name: {"calls", "host_s"}}, "counters": {name: total}}."""
    return {"spans": {k: {"calls": c, "host_s": ns / 1e9}
                      for k, (c, ns) in _totals.items()},
            "counters": dict(_counters)}


def reset() -> None:
    """Clear the spans' totals and the counters."""
    _totals.clear()
    _counters.clear()


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
            self._counts[name] = self._counts.get(name, 0) + 1
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        try:
            with tracing() if prof is not None else _OFF:
                yield
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                os.makedirs(self.profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    self.profile_dir, f"{name}-iter{step:03d}.json"))
            self.writer.add_scalar(f"time/{name}",
                                   time.perf_counter() - t0, step)
