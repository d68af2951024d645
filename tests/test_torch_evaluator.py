"""The port's live evaluator (players/evaluator.py) on the CPU: the four cases
of the JAX package's tests/test_evaluator_gui.py::TestEvaluator through the
port, ``analyze_blocking`` against the JAX evaluator's with its tie-noise
draws injected, the background thread's stop and restart, and the kernel
library's first build under threads.

``analyze_blocking`` parity: the visit policy, the best and worst actions,
the depth and the simulations equal; the value equal for the uniform
evaluation (zero values back up exactly) and within 1e-5 over a converted
float32 network (as tests/test_torch_players.py states).
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from alphazero_general_tpu.envs import get_env as j_get_env
from alphazero_general_tpu.players.evaluator import (
    MCTSEvaluator as JEvaluator,
)
from alphazero_general_tpu.utils.config import get_args as j_get_args
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.mcts.search import SearchDraws
from alphazero_general_tpu_torch.ops import build
from alphazero_general_tpu_torch.players.evaluator import (
    MCTSEvaluator, greedy_value,
)
from alphazero_general_tpu_torch.utils import get_args
from test_torch_players import nets, states

torch.set_num_threads(1)


def c4(moves):
    env = get_env("connect4")
    s = env.init(1, "cpu")
    for m in moves:
        s = env.step(s, torch.tensor([m], dtype=torch.int32))
    return s


def evaluator_draws(seed, A, sims, tick):
    """The tie draws of a JAX evaluator's analysis from its seed
    (evaluator.py:216-226 and the tick, :115-130): per tick ``key, sub =
    split(key)`` and ``split(sub, tick)``; per simulation ``_, noise =
    split(r)``, the game's key ``split(noise, 1)[0]`` and its tie key the
    second half of its split."""
    key = jax.random.PRNGKey(seed)
    ties = []
    for _ in range(sims // tick):
        key, sub = jax.random.split(key)
        for r in jax.random.split(sub, tick):
            game = jax.random.split(jax.random.split(r)[1], 1)[0]
            ties.append(np.asarray(jax.random.uniform(
                jax.random.split(game)[1], (A,))))
    return SearchDraws(tie=torch.from_numpy(np.stack(ties)[:, None]))


# --- the JAX package's TestEvaluator, through the port ---------------------

def test_blocking_analysis_finds_win():
    ev = MCTSEvaluator(get_env("connect4"), get_args(), max_search_time=20.0,
                       max_sims=240, sims_per_tick=40, device="cpu")
    a = ev.analyze_blocking(c4([2, 0, 3, 0, 4, 1]))  # p0 wins at 1 or 5
    assert a.sims >= 240
    assert a.best_actions[0] in (1, 5), a.best_actions
    assert a.value > 0.8
    assert not a.running


def test_background_analysis_publishes_incrementally():
    ev = MCTSEvaluator(get_env("connect4"), get_args(), max_search_time=30.0,
                       max_sims=2000, sims_per_tick=20, device="cpu")
    ev.start(c4([3]))
    deadline = time.time() + 25
    seen = 0
    while time.time() < deadline:
        a = ev.analysis
        seen = max(seen, a.sims)
        if seen >= 40:
            break
        time.sleep(0.05)
    ev.stop()
    assert seen >= 40, "no incremental updates observed"
    assert 0.0 <= ev.analysis.value <= 1.0


def test_terminal_position_no_crash():
    ev = MCTSEvaluator(get_env("connect4"), get_args(), max_sims=40,
                       device="cpu")
    a = ev.analyze_blocking(c4([2, 0, 3, 0, 4, 0, 5]))  # p0 has won
    assert not a.running and a.sims == 0


def test_greedy_value():
    assert greedy_value(get_env("connect4"),
                        get_env("connect4").init(1, "cpu")) == 0.5


# --- parity with the JAX evaluator -----------------------------------------

@pytest.mark.parametrize("name,sims,tick,with_net", [
    ("connect4", 48, 8, False), ("tictactoe", 60, 20, False),
    ("connect4", 32, 8, True)])
def test_analyze_blocking_matches_jax(name, sims, tick, with_net):
    """``analyze_blocking`` from random positions against the JAX
    evaluator's, uniform or over a converted ResNet, JAX's tie draws
    injected: visit policy, best and worst actions, depth, simulations
    and value."""
    env, jenv = get_env(name), j_get_env(name)
    shim, net = nets(name) if with_net else (None, None)
    for b, (state, js) in enumerate(states(name, 3, seed=21, max_plies=4)):
        jev = JEvaluator(jenv, j_get_args(), nn=None, max_sims=sims,
                         sims_per_tick=tick, seed=b, max_search_time=600.0)
        if with_net:  # the network's evaluation in the JAX tick
            jev._tick = _jax_tick_with(jev, shim.process)
        ev = MCTSEvaluator(env, get_args(), nn=net, max_sims=sims,
                           sims_per_tick=tick, max_search_time=600.0,
                           device="cpu")
        want = jev.analyze_blocking(js)
        got = ev.analyze_blocking(state, draws=evaluator_draws(
            b, env.ACTION_SIZE, sims, tick))
        assert got.sims == want.sims == sims
        assert got.best_actions == want.best_actions
        assert got.worst_actions == want.worst_actions
        assert got.depth == want.depth
        np.testing.assert_array_equal(got.policy, want.policy)
        assert abs(got.value - want.value) <= (1e-5 if with_net else 0.0)
        assert not got.running


def _jax_tick_with(jev, process):
    """The JAX evaluator's tick (evaluator.py:115-130) over ``process`` in
    place of its wrapper's model."""
    import alphazero_general_tpu.mcts.search as JS

    env, spec, tick = jev.env, jev.spec, jev.sims_per_tick

    @jax.jit
    def _tick(trees, rng, first):
        def one(tr, r, adjust):
            return JS.simulate_step(env, tr, spec, process, r,
                                    root_adjust=adjust, walk_impl="xla")

        rngs = jax.random.split(rng, tick)
        trees = jax.lax.cond(first, lambda tr: one(tr, rngs[0], True),
                             lambda tr: one(tr, rngs[0], False), trees)
        trees, _ = jax.lax.scan(lambda tr, r: (one(tr, r, False), None),
                                trees, rngs[1:])
        return trees

    return _tick


def test_analyze_blocking_stops_at_max_sims_and_depth():
    """The last tick stops at ``max_sims`` (the tree has no row for
    more); ``max_search_depth`` stops the search after the first tick
    that reaches it."""
    env = get_env("connect4")
    ev = MCTSEvaluator(env, get_args(), max_sims=30, sims_per_tick=8,
                       device="cpu")
    assert ev.analyze_blocking(env.init(1, "cpu")).sims == 30
    deep = MCTSEvaluator(env, get_args(), max_sims=400, sims_per_tick=8,
                         max_search_depth=2, device="cpu")
    a = deep.analyze_blocking(env.init(1, "cpu"))
    assert a.depth >= 2 and a.sims < 400


def test_row_cap_on_the_card_raises_at_construction():
    """On the card the CUDA descend takes trees of at most MAX_NODES rows;
    an evaluator that would need more raises before any search (the CPU
    has no such cap)."""
    from alphazero_general_tpu_torch.ops.descend import MAX_NODES

    env = get_env("connect4")
    with pytest.raises(ValueError, match=f"at most {MAX_NODES}"):
        MCTSEvaluator(env, get_args(), max_sims=MAX_NODES, device="cuda")
    MCTSEvaluator(env, get_args(), max_sims=MAX_NODES - 3, device="cpu")


def test_stop_and_restart_the_background_thread():
    """start() on a running evaluator stops the old thread first; stop()
    joins it; a stopped evaluator restarts on a new position and
    publishes for it."""
    env = get_env("connect4")
    ev = MCTSEvaluator(env, get_args(), max_search_time=30.0,
                       max_sims=2000, sims_per_tick=8, device="cpu")
    ev.start(c4([3]))
    first = ev._thread
    deadline = time.time() + 20
    while ev.analysis.sims < 16 and time.time() < deadline:
        time.sleep(0.05)
    ev.start(c4([3, 3]))
    assert not first.is_alive() and ev.running
    time.sleep(0.3)
    ev.stop()
    assert not ev.running and ev._thread is None
    stopped = ev.analysis
    assert not stopped.running
    time.sleep(0.2)
    assert ev.analysis == stopped  # nothing runs after stop()
    ev.start(c4([2, 0, 3, 0, 4, 1]))  # the win at 1 or 5
    deadline = time.time() + 20
    while ev.running and time.time() < deadline:
        a = ev.analysis
        if a.sims >= 200:
            break
        time.sleep(0.05)
    ev.stop()
    assert ev.analysis.best_actions[0] in (1, 5)


def test_kernel_library_builds_once_under_threads(monkeypatch, tmp_path):
    """The evaluator's thread may launch the first kernel: the library's
    build and load run once, whichever threads ask at the same time."""
    calls = []

    def slow_build():
        calls.append(threading.get_ident())
        time.sleep(0.2)
        return build.BuildResult(tmp_path / "lib.so", "", 0.0)

    class FakeLib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(build, "_LIBRARY", None)
    monkeypatch.setattr(build, "_build_library", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: FakeLib())
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        build.load_library())) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1 and len(got) == 8
    assert all(g is got[0] for g in got)
