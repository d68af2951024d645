"""What a run's parts share: the run's context, a driver's result, the
record a traced run hands to the per-layer metrics, and the capture of the
network calls of a checked move."""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from azbench.registry import sub_seed


@dataclasses.dataclass
class Context:
    cell: dict  # the workload's entry of BENCHMARK.json
    cfg: dict  # configs/<config>.json
    traffic: dict  # traffic/<mix>.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float  # process start, time.time()
    #: Also read the control (the reference one precision below, in the
    #: program's place); never set by a benchmark run.
    control: bool = False
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, what: str) -> None:
        """Note the seconds since process start at a step of set-up."""
        self.marks.append((what, time.time() - self.t0))

    def seed_for(self, tag: str) -> int:
        return sub_seed(self.seed, tag)

    def generator(self, tag: str) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(self.seed_for(tag))

    def rng(self, tag: str) -> np.random.Generator:
        return np.random.default_rng(self.seed_for(tag))


@dataclasses.dataclass
class TraceRecord:
    """What the per-layer metrics read in a traced run: the traced
    window's length and device activity, and the driver's counts."""

    cfg: dict
    window_s: float
    busy_s: float
    device_events: int
    kernel_s: dict  # kernel name key -> device seconds in the window
    counters: dict
    breakdown: dict


@dataclasses.dataclass
class Result:
    e2e: dict  # end-to-end metric -> value
    attempted: int
    failed: int
    checks: dict  # correctness number -> value
    window_start: float  # time.time() when the measured window opened
    peak_bytes: int
    trace: Optional[TraceRecord] = None
    #: What the check notes beside its numbers, not compared.
    notes: dict = dataclasses.field(default_factory=dict)


class Capture:
    """Wraps a network ``apply(obs) -> outputs``: while on, keeps every
    call's input and outputs (references, no copy)."""

    def __init__(self, fn):
        self.fn = fn
        self.on = False
        self.calls = []

    def __call__(self, obs):
        out = self.fn(obs)
        if self.on:
            self.calls.append((obs, out))
        return out


def game_state(state_items: dict, g: int) -> dict:
    """One game's fields of a batched state, as NumPy scalars and arrays."""
    out = {}
    for k, x in state_items.items():
        v = x[g].cpu().numpy()
        out[k] = v[()] if v.ndim == 0 else v
    return out


def same_state(ref: dict, prog: dict) -> bool:
    """Whether every field of the reference's state equals the
    program's."""
    return set(ref) == set(prog) and all(
        np.array_equal(np.asarray(ref[k]), np.asarray(prog[k])) for k in ref)
