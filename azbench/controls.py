"""Readings for the limits of the correctness checks, on the card:

    python3 -m azbench.controls --workload c4.selfplay --seeds 1,2,3 --seconds 3

Runs the cell once per seed in one process (short windows: only the
checks are read) and prints one JSON line a seed: the program's numbers
(the lower readings) and the control's, the reference one precision below
the configuration's put in the program's place (``control.*``), and what
the check notes (the replays' near ties). Benchmark runs never compute the
control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from azbench import registry
from azbench.common import Context


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="azbench.controls")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("azbench.controls: no CUDA device", file=sys.stderr)
        return 2
    cell = registry.workload(a.workload)
    traffic = registry.traffic(cell["traffic"])
    driver = registry.driver(traffic["driver"])
    for seed in (int(s) for s in a.seeds.split(",")):
        ctx = Context(cell=cell, cfg=registry.config(cell["config"]),
                      traffic=traffic, seed=seed, seconds=a.seconds,
                      trace=False, device=torch.device("cuda", 0),
                      t0=time.time(), control=True)
        res = driver.run(ctx)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "checks": {k: float(v)
                                     for k, v in res.checks.items()},
                          "e2e": res.e2e, "notes": res.notes,
                          "marks": ctx.marks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
