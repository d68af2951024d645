"""Parity of the PyTorch port's tafl envs (brandubh, hnefatafl) with the JAX
envs on the CPU: random rollouts to the end, compared at every ply (board,
player, turns, last action, king flag, valid moves, win state, the fused
win_and_valids, observation, crude value and the 8 symmetries of obs and
pi), and the rule fixtures of tests/test_tafl.py through both envs.

Integers and bools must be equal; floats must be equal too, since every
JAX value here is a float32 of small integers or of a turn fraction that
both sides compute the same way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_general_tpu.envs import tafl as JTafl
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs import tafl as TTafl
from alphazero_general_tpu_torch.envs.core import state_items

torch.set_num_threads(1)

FIELDS = ("board", "player", "turns", "last_action", "king_captured")
JAX_ENVS = {"brandubh": JTafl.Brandubh, "hnefatafl": JTafl.Hnefatafl}


@pytest.fixture(scope="module", params=["brandubh", "hnefatafl"])
def envs(request):
    """(torch env, jax env, jitted vmapped jax functions) of one variant."""
    jenv = JAX_ENVS[request.param]
    fns = dict(
        step=jax.jit(jax.vmap(jenv.step)),
        valid=jax.jit(jax.vmap(jenv.valid_moves)),
        win=jax.jit(jax.vmap(jenv.win_state)),
        wv=jax.jit(jax.vmap(jenv.win_and_valids)),
        obs=jax.jit(jax.vmap(jenv.observation)),
        crude=jax.jit(jax.vmap(jenv.crude_value)),
        sym=jax.jit(jax.vmap(jenv.symmetries)),
    )
    return get_env(request.param), jenv, fns


def to_jax(jenv, items):
    return jenv.State(**{k: jnp.asarray(v) for k, v in items.items()})


def to_torch(env, items):
    return env.State(**{k: torch.from_numpy(np.array(v))
                        for k, v in items.items()})


def assert_same(env, fns, ts, js, rng, with_sym: bool):
    """Every function of both envs equal on the batch of states."""
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    valid = env.valid_moves(ts).numpy()
    win = env.win_state(ts).numpy()
    np.testing.assert_array_equal(valid, np.asarray(fns["valid"](js)))
    np.testing.assert_array_equal(win, np.asarray(fns["win"](js)))
    t_win, t_valid = env.win_and_valids(ts)
    j_win, j_valid = fns["wv"](js)
    np.testing.assert_array_equal(t_win.numpy(), np.asarray(j_win))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    obs = env.observation(ts)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(fns["obs"](js)))
    np.testing.assert_array_equal(env.crude_value(ts).numpy(),
                                  np.asarray(fns["crude"](js)))
    if with_sym:
        pi = rng.random((valid.shape[0], env.ACTION_SIZE)).astype(np.float32)
        t_o, t_p = env.symmetries(obs, torch.from_numpy(pi))
        j_o, j_p = fns["sym"](jnp.asarray(obs.numpy()), jnp.asarray(pi))
        assert t_o.shape[1] == t_p.shape[1] == env.NUM_SYMMETRIES == 8
        np.testing.assert_array_equal(t_o.numpy(), np.asarray(j_o))
        np.testing.assert_array_equal(t_p.numpy(), np.asarray(j_p))
    return valid, win


def test_rollouts_match_jax(envs):
    """Random legal moves until every game has ended; a third of the games
    start a few moves before the draw cap, so that the cap ends them."""
    env, jenv, fns = envs
    B = 12
    rng = np.random.default_rng(0)
    items = {k: v.numpy() for k, v in state_items(env.init(B, "cpu")).items()}
    items["turns"][: B // 3] = env.MAX_TURNS - 1 - np.arange(B // 3) * 2
    ts, js = to_torch(env, items), to_jax(jenv, items)
    ended = np.zeros(B, bool)
    outcomes = set()
    for ply in range(env.MAX_TURNS + 1):
        valid, win = assert_same(env, fns, ts, js, rng, with_sym=ply % 8 == 0)
        done = (win > 0).any(axis=1)
        outcomes |= {int(w.argmax()) for w in win[done & ~ended]}
        ended |= done
        active = ~done
        if not active.any():
            break
        action = np.array([rng.choice(np.flatnonzero(v)) if a else 0
                           for v, a in zip(valid, active)], np.int32)
        t_new = env.step(ts, torch.from_numpy(action))
        j_new = fns["step"](js, jnp.asarray(action))
        t_items = {k: v.numpy() for k, v in state_items(t_new).items()}
        j_items = {k: np.asarray(getattr(j_new, k)) for k in FIELDS}
        for k in FIELDS:  # stepped states equal, finished games included
            np.testing.assert_array_equal(t_items[k], j_items[k], err_msg=k)
        old = {k: getattr(ts, k).numpy() for k in FIELDS}
        keep = {k: np.where(active.reshape((-1,) + (1,) * (old[k].ndim - 1)),
                            t_items[k], old[k]) for k in FIELDS}
        ts, js = to_torch(env, keep), to_jax(jenv, keep)
    else:
        raise AssertionError("rollouts did not end within MAX_TURNS moves")
    assert 2 in outcomes, "no game reached the draw cap"
    assert outcomes & {0, 1}, "no game was won"


def _fixture_board(env_name, cells):
    """An empty board of the variant with its escapes and throne, plus
    ``cells`` {(r, c): value}."""
    board_str = (TTafl.BRANDUBH_BOARD if env_name == "brandubh"
                 else TTafl.HNEFATAFL_BOARD)
    ref = TTafl._parse_board(board_str)
    b = np.zeros_like(ref)
    b[ref == TTafl.ESCAPE] = TTafl.ESCAPE
    b[ref == TTafl.KING_ON_THRONE] = TTafl.THRONE
    for (r, c), v in cells.items():
        b[r, c] = v
    return b


W_, B_, K_, E_ = TTafl.WHITE, TTafl.BLACK, TTafl.KING, TTafl.EMPTY
#: The rule fixtures of tests/test_tafl.py:115-290, as (variant, cells,
#: player to move, move (r, c, r2, c2) or None, checks on the position
#: after the move): cells as {(r, c): value}; checks as {(r, c): value}
#: and the expected win vector (None: not checked).
FIXTURES = {
    "custodial capture": (
        "brandubh", {(2, 2): B_, (2, 4): W_, (2, 5): B_, (5, 5): K_}, 0,
        (2, 2, 2, 3), {(2, 4): E_}, None),
    "capture against the throne": (
        "brandubh", {(3, 2): W_, (5, 1): B_, (6, 3): K_}, 0,
        (5, 1, 3, 1), {(3, 2): E_}, None),
    "no capture without an anvil": (
        "brandubh", {(2, 2): B_, (2, 4): W_, (6, 3): K_}, 0,
        (2, 2, 2, 3), {(2, 4): W_}, None),
    "two-sided king capture, brandubh": (
        "brandubh", {(1, 2): K_, (1, 1): B_, (1, 4): B_, (5, 5): W_}, 0,
        (1, 4, 1, 3), {}, [1, 0, 0]),
    "hnefatafl king not taken by two sides": (
        "hnefatafl", {(4, 4): K_, (3, 4): B_, (4, 3): B_, (4, 5): B_,
                      (6, 4): B_, (9, 9): W_}, 0, None, {}, [0, 0, 0]),
    "hnefatafl king taken on four sides": (
        "hnefatafl", {(4, 4): K_, (3, 4): B_, (4, 3): B_, (4, 5): B_,
                      (6, 4): B_, (9, 9): W_}, 0, (6, 4, 5, 4), {},
        [1, 0, 0]),
    "surround capture": (
        "brandubh", {(5, 1): W_, (5, 2): W_, (5, 3): B_, (4, 1): B_,
                     (4, 2): B_, (6, 1): B_, (6, 2): B_, (2, 0): B_,
                     (1, 1): K_}, 0, (2, 0, 5, 0),
        {(5, 1): E_, (5, 2): E_}, None),
    "no surround capture with a liberty": (
        "brandubh", {(5, 1): W_, (5, 2): W_, (5, 3): B_, (4, 1): B_,
                     (4, 2): B_, (6, 1): B_, (2, 0): B_, (1, 5): K_}, 0,
        (2, 0, 5, 0), {(5, 1): W_, (5, 2): W_}, None),
    "king escape": (
        "brandubh", {(0, 3): K_, (5, 5): B_}, 1, (0, 3, 0, 6),
        {(0, 6): TTafl.KING_ON_ESCAPE}, [0, 1, 0]),
    "lone mobile king is no loss": (
        "brandubh", {(2, 2): K_, (5, 5): B_}, 1, None, {}, [0, 0, 0]),
    "stuck white team": (
        "brandubh", {(0, 2): K_, (0, 1): B_, (0, 3): B_, (1, 2): B_}, 1,
        None, {}, [1, 0, 0]),
    "hnefatafl surround capture of a king group": (
        "hnefatafl", {(0, 4): W_, (0, 5): K_, (0, 3): B_, (1, 4): B_,
                      (1, 5): B_, (0, 7): B_, (2, 6): B_}, 0,
        (2, 6, 0, 6), {(0, 4): E_, (0, 5): K_}, [1, 0, 0]),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_rule_fixtures_match_jax(name):
    variant, cells, player, move, expect, win = FIXTURES[name]
    env, jenv = get_env(variant), JAX_ENVS[variant]
    board = _fixture_board(variant, cells)
    ts = env.init(1, "cpu")
    ts.board = torch.from_numpy(board[None].copy())
    ts.player = torch.tensor([player], dtype=torch.int32)
    js = jenv.init().replace(board=jnp.asarray(board),
                             player=jnp.int32(player))
    if move is not None:
        a = env.encode_action(*move)
        assert a == jenv.encode_action(*move)
        assert env.decode_action(a) == jenv.decode_action(a)
        ts = env.step(ts, torch.tensor([a]))
        js = jenv.step(js, a)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy()[0],
                                      np.asarray(getattr(js, k)), err_msg=k)
    t_win = env.win_state(ts).numpy()[0]
    np.testing.assert_array_equal(t_win, np.asarray(jenv.win_state(js)))
    np.testing.assert_array_equal(env.valid_moves(ts).numpy()[0],
                                  np.asarray(jenv.valid_moves(js)))
    np.testing.assert_array_equal(env.crude_value(ts).numpy()[0],
                                  np.asarray(jenv.crude_value(js)))
    for (r, c), v in expect.items():
        assert ts.board[0, r, c] == v, (r, c)
    if win is not None:
        np.testing.assert_array_equal(t_win, win)


@pytest.mark.parametrize("variant", ["brandubh", "hnefatafl"])
def test_tables_match_jax(variant):
    """Move encoding, initial board and the dihedral action permutations."""
    env, jenv = get_env(variant), JAX_ENVS[variant]
    H, W = env.BOARD_SHAPE
    assert (env.ACTION_SIZE, env.OBS_SHAPE, env.MAX_TURNS, env.MOVE_TYPES) \
        == (jenv.ACTION_SIZE, jenv.OBS_SHAPE, jenv.MAX_TURNS, jenv.MOVE_TYPES)
    np.testing.assert_array_equal(env.init(1, "cpu").board[0].numpy(),
                                  np.asarray(jenv.init().board))
    MT, dest_r, dest_c, between = TTafl._build_tables(H, W)
    j_mt, j_r, j_c, j_between, _ = JTafl._build_tables(H, W)
    assert MT == j_mt
    np.testing.assert_array_equal(dest_r, j_r)
    np.testing.assert_array_equal(dest_c, j_c)
    np.testing.assert_array_equal(between, j_between)
    np.testing.assert_array_equal(TTafl._build_symmetry_perms(H, W, MT),
                                  JTafl._build_symmetry_perms(H, W, MT))


def test_scan_movegen_raises():
    with pytest.raises(ValueError, match="scan"):
        TTafl.make_tafl_env("x", TTafl.BRANDUBH_BOARD, True, 100,
                            movegen="scan")
