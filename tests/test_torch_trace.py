"""The search's stage spans and counters (``utils/trace.py``): off, they
leave no range in a profiler's trace and count nothing; on, each stage
runs once a simulation inside its search, in both tree layouts and under
multi-leaf rounds, and the counters hold the search's work; tracing
changes no result; a profiled Coach phase turns them on, an unprofiled
one does not."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.mcts import search as S
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts.tree import SearchSpec
from alphazero_general_tpu_torch.mcts.tree_t import init_tree_t
from alphazero_general_tpu_torch.utils import trace

torch.set_num_threads(1)

STAGES = ("search.descend", "search.expand", "search.network",
          "search.install", "search.backup")
_RNG = np.random.default_rng(0)
_PI = torch.from_numpy(_RNG.dirichlet(np.ones(7), 509).astype(np.float32))
_V = torch.from_numpy(_RNG.dirichlet(np.ones(3), 509).astype(np.float32))
_W = torch.from_numpy(_RNG.integers(1, 509, size=(2, 42)))


def _eval_fn(obs):
    """Table rows indexed by a hash of the stone planes."""
    stones = (obs[:, :2] > 0.5).reshape(obs.shape[0], 2, -1).long()
    h = (stones * _W).sum(dim=(1, 2)) % 509
    return _PI[h], _V[h]


def _draws(sims, batch, seed=3):
    rng = np.random.default_rng(seed)
    return S.SearchDraws(
        tie=torch.from_numpy(rng.random((sims, batch, 7)).astype(np.float32)),
        gammas=torch.from_numpy(rng.gamma(1.5, size=(batch, 7)).astype(
            np.float32)))


# (layout, games, simulations, leaf_batch): a fresh game-minor search, the
# players' batch-major search of one game, and rounds of four walks.
CASES = {"tree_t": ("tree_t", 4, 12, 1), "tree_b1": ("tree", 1, 12, 1),
         "leaf_batch4": ("tree_t", 4, 13, 4)}


def _search(case):
    """One connect4 search of ``case`` from the empty board; its trees."""
    layout, B, sims, K = CASES[case]
    env = get_env("connect4")
    states = env.init(B, "cpu")
    spec = SearchSpec(tie_noise=1e-3)
    tree = (init_tree_t(env, states, sims + 2, 3) if layout == "tree_t"
            else T.init_tree(env, states, sims + 2, 3))
    return S.search(env, tree, spec, _eval_fn, sims,
                    draws=_draws(sims, B), leaf_batch=K)


def _profiled(fn):
    """(fn's result, [(name, start_ns, end_ns)] of the host events of a CPU
    profiler around it)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return out, events


def test_off_span_is_one_shared_context_and_counts_nothing():
    trace.reset()
    assert trace.span("search") is trace.span("search.backup")
    trace.count("search.simulations", 5)
    assert trace.snapshot() == {"spans": {}, "counters": {}}


def test_off_search_leaves_no_span_in_the_profiler_trace():
    trace.reset()
    _, events = _profiled(lambda: _search("tree_t"))
    assert events, "the profiler recorded nothing"
    assert not [n for n, _, _ in events if n.startswith("search")]
    assert trace.snapshot() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_on_each_stage_runs_once_a_simulation_inside_its_search(case):
    _, B, sims, K = CASES[case]
    trace.reset()
    with trace.tracing():
        _, events = _profiled(lambda: _search(case))
    snap = trace.snapshot()
    trace.reset()
    rounds = (sims - 1) // K if K > 1 else 0
    want = {"search": 1, "search.expand": sims, "search.backup": sims,
            # The root's expansion walks nowhere in a fresh TreeT.
            "search.descend": sims - (CASES[case][0] == "tree_t"),
            # A round forwards its K walks in one call, and casts the
            # call's output once before its K installs.
            "search.network": sims - rounds * (K - 1),
            "search.install": sims + rounds}
    assert {k: v["calls"] for k, v in snap["spans"].items()} == want
    got = {}
    for n, _, _ in events:
        got[n] = got.get(n, 0) + 1
    assert {k: got.get(k, 0) for k in want} == want
    assert snap["counters"] == {"search.simulations": sims,
                                "network.rows": sims * B}
    assert all(v["host_s"] > 0 for v in snap["spans"].values())
    (_, s0, s1), = [e for e in events if e[0] == "search"]
    assert all(s0 <= s and e <= s1 for n, s, e in events if n in STAGES)
    # The stages of one simulation never overlap one another.
    stages = sorted((s, e) for n, s, e in events if n in STAGES)
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_tracing_changes_no_result(case):
    off = _search(case)
    with trace.tracing():
        on = _search(case)
    trace.reset()
    for f in dataclasses.fields(off):
        a, b = getattr(off, f.name), getattr(on, f.name)
        pairs = ([(a[k], b[k]) for k in a] if isinstance(a, dict)
                 else [(a, b)])
        assert not isinstance(a, dict) or a.keys() == b.keys()
        for x, y in pairs:
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y), f.name


class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, step))


def test_profiled_phase_traces_the_stage_spans(tmp_path):
    writer = _Writer()
    tracer = trace.PhaseTracer(writer, profile_dir=str(tmp_path),
                               max_traces=1)
    trace.reset()
    with tracer.phase("self_play", 1):
        assert trace.span("a") is not trace.span("a")
        _search("tree_t")
    assert trace.span("a") is trace.span("b")
    with open(tmp_path / "self_play-iter001.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"search", *STAGES} <= names
    # Past max_traces the phase is not profiled, and tracing stays off.
    trace.reset()
    with tracer.phase("self_play", 2):
        assert trace.span("a") is trace.span("b")
        _search("tree_t")
    assert trace.snapshot()["counters"] == {}
    assert not (tmp_path / "self_play-iter002.json").exists()
    assert writer.scalars == [("time/self_play", 1), ("time/self_play", 2)]


def test_unprofiled_phase_leaves_tracing_off():
    tracer = trace.PhaseTracer(_Writer())
    trace.reset()
    with tracer.phase("train", 0):
        assert trace.span("a") is trace.span("b")
        _search("tree_b1")
    assert trace.snapshot() == {"spans": {}, "counters": {}}


def test_tracing_nests_and_restores_the_state_before():
    with trace.tracing():
        with trace.tracing():
            pass
        assert trace.span("a") is not trace.span("a")
    assert trace.span("a") is trace.span("b")
