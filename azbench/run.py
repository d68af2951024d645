"""Run one cell of the benchmark once, on the card:

    python3 -m azbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads and warms up the cell (set-up), measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints as
its last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit,
which also end standard error. Without a CUDA card, or with fewer cards
than the cell asks for, or with JAX loaded, it prints no result and exits
with a code other than 0.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "alphazero_general_tpu")


def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _number(x):
    """A NumPy or torch scalar as a Python number."""
    return x.item() if hasattr(x, "item") else x


def assemble(res, cell: str, trace: bool, device: dict, marks: list):
    """(the result's JSON object, the last lines of standard error) of a
    driver's result: the cell's metrics, the device, the breakdown of a
    traced run, and last each number compared beside its limit."""
    from azbench import registry
    metrics = {}
    if trace:
        for m in registry.per_layer_of(cell):
            value = registry.metric_reader(m["name"])(res.trace)
            if value is not None:
                metrics[m["name"]] = {"value": _number(value),
                                      "unit": m["unit"]}
    else:
        # A metric named <quantity>.<qualifier> is the driver's <quantity>
        # in the cells that list it.
        values = dict(res.e2e, setup_s=res.window_start - T0)
        for m in registry.end_to_end_of(cell):
            value = values[m["name"].split(".")[0]]
            metrics[m["name"]] = {"value": _number(value), "unit": m["unit"]}
    limits = registry.limits(cell)
    checks, correct = {}, True
    for name, value in res.checks.items():
        if name not in limits:
            raise KeyError(f"limits/{cell}.json has no limit for {name}")
        checks[name] = {"value": _number(value), "limit": limits[name]}
        correct = correct and checks[name]["value"] <= limits[name]
    device = dict(device, memory_peak_bytes=int(res.peak_bytes))
    out = {"correct": bool(correct), "attempted": int(res.attempted),
           "failed": int(res.failed), "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = res.trace.busy_s
        device["window_s"] = res.trace.window_s
        out["breakdown"] = res.trace.breakdown
    out["checks"] = checks
    lines = [f"set-up: {what} at {at:.3f} s" for what, at in marks]
    lines += [f"note {k} {v!r}" for k, v in res.notes.items()]
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}"
              for k, c in checks.items()]
    return out, lines


def parse(argv):
    p = argparse.ArgumentParser(prog="azbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse(argv)
    from azbench import registry
    cell = registry.workload(a.workload)
    import torch
    if not torch.cuda.is_available():
        print("azbench: no CUDA device (torch.cuda.is_available() is "
              "False); the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"azbench: {a.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    from azbench.common import Context
    cfg = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    ctx = Context(cell=cell, cfg=cfg, traffic=traffic, seed=a.seed,
                  seconds=a.seconds, trace=bool(a.trace),
                  device=torch.device("cuda", 0), t0=T0)
    res = registry.driver(traffic["driver"]).run(ctx)

    loaded = jax_modules()
    if loaded:
        print(f"azbench: JAX is loaded in this process: {loaded}",
              file=sys.stderr)
        return 3

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]), "power_limit": power_limit(),
              "torch": torch.__version__}
    out, lines = assemble(res, cell["name"], bool(a.trace), device,
                          ctx.marks)
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
