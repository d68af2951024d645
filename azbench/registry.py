"""Everything of a cell is found by name: its configuration in
``configs/<name>.json``, its traffic mix in ``traffic/<name>.json`` (whose
``driver`` names a module of ``drivers/``), the reference network of its
configuration's ``nnet_type`` in ``reference/nets/<nnet_type>.py``, the
limits of its correctness checks in ``limits/<cell>.json``, and each
per-layer metric's reader in ``metrics/<metric>.py``. Adding a cell adds
files and entries; no file here changes."""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(cell: str) -> dict:
    return _json("limits", cell)


def driver(name: str):
    return importlib.import_module(f"azbench.drivers.{name}")


def network(cfg: dict):
    """The reference network module of a configuration's ``nnet_type``
    (``reference/nets/<nnet_type>.py``; its interface is in
    ``reference/nets/__init__.py``)."""
    kind = cfg["args"]["nnet_type"]
    path = HERE / "reference" / "nets" / f"{kind}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"no reference network for nnet_type {kind!r}: expected {path}")
    return importlib.import_module(f"azbench.reference.nets.{kind}")


def metric_reader(name: str):
    """The ``read(record)`` of ``metrics/<name>.py`` (names may hold
    dots, so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"azbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end_of(cell: str) -> list:
    """The end-to-end metrics a cell reports."""
    return [m for m in benchmark()["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_of(cell: str) -> list:
    """The per-layer metrics a cell's traced run reports: those that list
    it, and those without a list that move an end-to-end metric it
    reports."""
    e2e = {m["name"] for m in end_to_end_of(cell)}
    return [m for m in benchmark()["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
