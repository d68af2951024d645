"""The command and the contract of BENCHMARK.json: without a card the
run exits with an error and prints no metric; every name in
BENCHMARK.json finds its files."""

import json
import re
import subprocess
import sys
from pathlib import Path

from azbench import registry

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "azbench.run", "--workload", "c4.selfplay",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_names_find_their_files():
    b = registry.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["azbench"]
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["source"] \
            == c["source"]
        assert c["reduced"] == json.loads(
            (ROOT / c["file"]).read_text())["reduced"]
    used = set()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert w["config"] in configs
        used.add(w["config"])
        tr = registry.traffic(w["traffic"])
        registry.driver(tr["driver"])
        assert registry.limits(w["name"])
        assert len(w["why"]) <= 200
        assert registry.end_to_end_of(w["name"])
        assert registry.per_layer_of(w["name"])
    assert used == set(configs)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        registry.metric_reader(m["name"])
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"]
                                  for x in registry.end_to_end_of(cell)}


def test_sub_seeds_take_large_seeds():
    s = registry.sub_seed(2 ** 33 + 5, "weights")
    assert 0 <= s < 2 ** 63
    assert s != registry.sub_seed(2 ** 33 + 5, "draws")


def test_result_line_is_json_with_checks_last():
    import torch
    from azbench.run import assemble
    from azbench.tests import tiny
    torch.set_num_threads(1)
    for cell in ("c4.selfplay", "c4.play"):
        ctx = tiny.context(cell, seconds=0.3)
        res = registry.driver(ctx.traffic["driver"]).run(ctx)
        out, lines = assemble(res, cell, False, {"platform": "gpu"},
                              ctx.marks)
        back = json.loads(json.dumps(out))
        assert list(back)[-1] == "checks"
        assert back["correct"] is True
        assert {"correct", "attempted", "failed", "metrics",
                "device"} <= set(back)
        assert "setup_s" in back["metrics"]
        assert lines[-1].startswith("check ")
