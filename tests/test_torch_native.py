"""The port's ctypes bridge to the C++ host runtime (ops/native.py) on the
CPU: it builds the unchanged ``native/azg_native.cpp`` into the port's
``_build/`` (never over ``native/libazg_native.so``), its raw MCTS equals
the JAX package's bridge's on the same positions and seeds (the same C++
function: best action, visit counts and depth equal; the root value
within 1e-6, since the JAX bridge compiles with ``-march=native``, whose
fused multiply-adds round the depth discount's products otherwise), a
failed build raises NativeUnavailable with the compiler's error, and a
NativeRawMCTSPlayer game ends legally with the JAX player's moves.
"""

import numpy as np
import pytest
import torch

from alphazero_general_tpu.envs import get_env as j_get_env
from alphazero_general_tpu.ops import native as j_native
from alphazero_general_tpu.players.players import (
    NativeRawMCTSPlayer as JNativePlayer,
)
from alphazero_general_tpu.utils.config import get_args as j_get_args
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.ops import native
from alphazero_general_tpu_torch.players.players import NativeRawMCTSPlayer
from alphazero_general_tpu_torch.utils import get_args

torch.set_num_threads(1)

#: The root value against the JAX bridge's (module docstring).
VALUE_TOL = 1e-6


def play(name, moves):
    env = get_env(name)
    s = env.init(1, "cpu")
    for m in moves:
        s = env.step(s, torch.tensor([m], dtype=torch.int32))
    return s


def test_bridge_builds_into_the_port_build_dir():
    lib = native.library_path()
    assert native.available()
    assert lib.is_file() and lib.parent == native.BUILD_DIR
    assert lib.parent.name == "_build"
    assert lib.parent.parent.name == "alphazero_general_tpu_torch"
    assert native.SOURCE.name == "azg_native.cpp"
    assert native.SOURCE.parent.name == "native"


@pytest.mark.parametrize("name,moves,sims,seed,kw", [
    ("connect4", [], 100, 0, {}),
    ("connect4", [3], 100, 5, {}),
    ("connect4", [4, 0, 5, 0, 6, 1], 300, 1, {}),
    ("connect4", [3, 3, 2, 4], 200, 7, dict(min_discount=0.9, cpuct=2.0)),
    ("tictactoe", [0, 3, 1], 400, 2, {}),
    ("tictactoe", [4], 150, 3, dict(fpu_reduction=0.0)),
])
def test_raw_mcts_solve_matches_jax_bridge(name, moves, sims, seed, kw):
    s = play(name, moves)
    args = (name, s.board[0].numpy(), int(s.player[0]), int(s.turns[0]),
            sims)
    best, counts, value, depth = native.raw_mcts_solve(*args, seed=seed,
                                                       **kw)
    j_best, j_counts, j_value, j_depth = j_native.raw_mcts_solve(
        *args, seed=seed, **kw)
    assert (best, depth) == (j_best, j_depth)
    assert abs(value - j_value) <= VALUE_TOL
    np.testing.assert_array_equal(counts, j_counts)
    assert counts.sum() == sims - 1 and counts.dtype == np.int32


def test_finds_wins_and_blocks():
    """The JAX package's engine cases through the port's bridge."""
    s = play("connect4", [4, 0, 5, 0, 6, 1])  # p0: 4, 5, 6 -> wins at 3
    best, counts, value, _ = native.raw_mcts_solve(
        "connect4", s.board[0].numpy(), 0, 6, 300)
    assert best == 3 and value > 0.9, counts
    s = play("tictactoe", [0, 3, 1])  # p1 must block at 2
    best, counts, *_ = native.raw_mcts_solve(
        "tictactoe", s.board[0].numpy(), 1, 3, 400)
    assert best == 2, counts


def test_native_player_game_ends_legally_with_jax_moves():
    """A whole connect4 game of two NativeRawMCTSPlayers: every move
    legal and equal to the JAX players' from the same seeds."""
    env, jenv = get_env("connect4"), j_get_env("connect4")
    args, j_args = (get_args(numMCTSSims=50, startTemp=0.5),
                    j_get_args(numMCTSSims=50, startTemp=0.5))
    players = [NativeRawMCTSPlayer(env, args, seed=1 + k) for k in (0, 1)]
    j_players = [JNativePlayer(jenv, j_args, seed=1 + k) for k in (0, 1)]
    s, js = env.init(1, "cpu"), jenv.init()
    while not bool(env.terminated(s)[0]):
        mover = int(s.player[0])
        a = players[mover].play(s)
        assert bool(env.valid_moves(s)[0, a])
        assert a == j_players[mover].play(js)
        assert abs(players[mover].last_value
                   - j_players[mover].last_value) <= VALUE_TOL
        s = env.step(s, torch.tensor([a], dtype=torch.int32))
        js = jenv.step(js, a)
    assert int(s.turns[0]) <= env.MAX_TURNS


def test_failed_build_raises_with_the_compiler_error(tmp_path, monkeypatch):
    """A source that does not compile: NativeUnavailable with g++'s
    message, again on every later call, and the player raises at
    construction rather than falling back."""
    bad = tmp_path / "azg_native.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    with pytest.raises(native.NativeUnavailable, match="native build failed"):
        native.raw_mcts_solve("connect4", np.zeros(42), 0, 0, 10)
    with pytest.raises(native.NativeUnavailable, match="error"):
        NativeRawMCTSPlayer(get_env("connect4"), get_args())
    assert not native.available()
    assert not (tmp_path / "_build").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "_build").iterdir())


def test_unknown_env_and_bad_board_raise():
    with pytest.raises(native.NativeUnavailable, match="no rules"):
        NativeRawMCTSPlayer(get_env("othello"), get_args())
    with pytest.raises(ValueError, match="42 cells"):
        native.raw_mcts_solve("connect4", np.zeros(9), 0, 0, 10)
