"""Sets of runs of one cell, each run a process of its own as a check runs
it, and the spread of each end-to-end metric:

    python3 -m azbench.measure --workload c4.selfplay --seeds 1,2,3,4,5,6 \
        --sets 2 --seconds 30 --traced 3 --out chiprun_out/m/c4.selfplay.jsonl

Each set runs every seed once, in order; the sets use the same seeds. Then
``--traced`` more runs with ``--trace 1`` on further seeds. Every result
line is appended to ``--out`` with its set, seed and wall time; the summary
ends standard output. Per set and metric: the median, the quartiles as
``statistics.quantiles`` gives them, the spread (their distance over the
median) and the trimmed spread (the spread with the run farthest from the
median left out, where that narrows it). Per metric, the check's noise
rule: the mean of the sets' trimmed spreads against half the metric's bound
in ``BENCHMARK.json``, the widest untrimmed spread, and the last set's
median against the first's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from azbench import registry


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "azbench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], capture_output=True, text=True, timeout=1800)
    line = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    rec = {"rc": out.returncode, "wall_s": time.time() - t,
           "stderr_tail": out.stderr[-1500:]}
    try:
        rec["result"] = json.loads(line)
    except json.JSONDecodeError:
        rec["result"] = None
    return rec


def spread(values: list) -> tuple:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return statistics.median(values), q1, q3, (q3 - q1) / abs(
        statistics.median(values))


def trimmed_spread(values: list) -> float:
    """The spread, with the run farthest from the median left out where
    that narrows it (as the check reads a set)."""
    whole = spread(values)[3]
    if len(values) < 4:
        return whole
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda k: abs(values[k] - med))
    return min(whole, spread(values[:far] + values[far + 1:])[3])


def rule(metric: str, sets: dict) -> str:
    """The noise rule's reading of one metric over its sets of runs."""
    bound = {m["name"]: m["bound"]
             for m in registry.benchmark()["end_to_end"]}[metric]
    full = [v for v in sets.values() if len(v) >= 2]
    if len(full) < 2:
        return f"rule {metric}: fewer than two sets"
    trims = [trimmed_spread(v) for v in full]
    mean = statistics.mean(trims)
    widest = max(spread(v)[3] for v in full)
    first, last = (statistics.median(v) for v in (full[0], full[-1]))
    return (f"rule {metric} bound={bound!r} trimmed={trims!r} "
            f"mean={mean!r} half_bound={bound / 2!r} "
            f"{'holds' if mean <= bound / 2 else 'FAILS'} "
            f"widest={widest!r} loose_at={8 * widest!r} "
            f"last_over_first={last / first!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="azbench.measure")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--traced", type=int, default=0)
    p.add_argument("--traced-seeds", default="")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    traced = [int(s) for s in a.traced_seeds.split(",") if s][:a.traced]
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    by_set = {}
    with open(a.out, "a") as f:
        plan = [(k, s, 0) for k in range(a.sets) for s in seeds] + \
            [("traced", s, 1) for s in traced]
        for which, seed, trace in plan:
            rec = one_run(a.workload, seed, a.seconds, trace)
            rec.update(set=which, seed=seed, trace=trace,
                       workload=a.workload)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            res = rec["result"]
            brief = None if res is None else {
                "correct": res["correct"],
                **{k: v["value"] for k, v in res["metrics"].items()}}
            print(f"{a.workload} set={which} seed={seed} rc={rec['rc']} "
                  f"wall={rec['wall_s']:.1f}s {brief}", flush=True)
            if res is not None and not trace:
                for k, v in res["metrics"].items():
                    by_set.setdefault(k, {}).setdefault(which, []).append(
                        v["value"])
    for metric, sets in by_set.items():
        for which, vals in sets.items():
            if len(vals) >= 2:
                med, q1, q3, sp = spread(vals)
                print(f"summary {a.workload} {metric} set={which} n="
                      f"{len(vals)} median={med!r} q1={q1!r} q3={q3!r} "
                      f"spread={sp!r} trimmed={trimmed_spread(vals)!r}",
                      flush=True)
        print(f"summary {a.workload} {rule(metric, sets)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
