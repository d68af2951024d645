"""The port's N-model arena, its evaluate-every-game path and the nim3
search against the JAX package's, on the CPU, with JAX's draws injected
(``test_torch_arena.arena_draws``): wins per model, draws and the average
game length equal.

* nim3 (three players, ``value_size`` 4): a fresh-tree search against
  JAX's ``xla`` walk and its Pallas walk in interpret mode, one table
  evaluation (counts and links equal, q, v within 1e-6); three-model
  arenas through ``make_multi_arena_fn`` against JAX's, with the
  evaluation functions of tests/test_nim.py; and the ValueErrors of a
  count of models other than N and of ``num_games`` not divisible by N.
* The evaluate-every-game path: a tictactoe subclass with ``ALTERNATES =
  False`` through ``make_arena_fn`` against JAX's, and the same games
  with owner routing (grouped routing equals evaluate-every-game), and
  ``route_owner=False``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphazero_general_tpu.mcts.tree as JT
import alphazero_general_tpu.selfplay.arena as JA
from alphazero_general_tpu.envs.nim import Nim3 as JNim3
from alphazero_general_tpu.envs.tictactoe import TicTacToe as JTicTacToe
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs.tictactoe import TicTacToe
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.selfplay import arena as A
from test_torch_arena import arena_draws
from test_torch_envs import assert_search_matches_jax, random_items

torch.set_num_threads(1)

NIM = get_env("nim3")
TAKE, P = 3, 3


def _nim_cfgs(sims, temp):
    kw = dict(add_root_noise=False, add_root_temp=False, num_players=P,
              has_draw=True)
    return (JA.ArenaConfig(sims=sims, arena_temp=temp,
                           spec=JT.SearchSpec(**kw)),
            A.ArenaConfig(sims=sims, arena_temp=temp,
                          spec=T.SearchSpec(**kw)))


def j_uniform(variables, obs):
    B = obs.shape[0]
    return (jnp.full((B, TAKE), -jnp.log(float(TAKE))),
            jnp.full((B, P + 1), -jnp.log(float(P + 1))))


def t_uniform(obs):
    B = obs.shape[0]
    return (torch.full((B, TAKE), -float(np.log(TAKE))),
            torch.full((B, P + 1), -float(np.log(P + 1))))


def j_closer(variables, obs):
    """Takes the whole pile whenever it can (tests/test_nim.py:66)."""
    B = obs.shape[0]
    pile = jnp.argmax(obs[:, 0, 0, :], axis=-1)
    can_win = (pile >= 1) & (pile <= TAKE)
    onehot = jax.nn.one_hot(jnp.clip(pile - 1, 0, TAKE - 1), TAKE)
    probs = jnp.where(can_win[:, None], onehot * 0.999 + 1e-3 / TAKE,
                      jnp.full((B, TAKE), 1.0 / TAKE))
    return jnp.log(probs), j_uniform(variables, obs)[1]


def t_closer(obs):
    B = obs.shape[0]
    pile = obs[:, 0, 0, :].argmax(dim=-1)
    can_win = (pile >= 1) & (pile <= TAKE)
    onehot = torch.nn.functional.one_hot((pile - 1).clamp(0, TAKE - 1),
                                         TAKE).to(torch.float32)
    probs = torch.where(can_win[:, None], onehot * 0.999 + 1e-3 / TAKE,
                        torch.full((B, TAKE), 1.0 / TAKE))
    return torch.log(probs), t_uniform(obs)[1]


def assert_same_result(got, want, games):
    np.testing.assert_array_equal(got.model_wins.numpy(),
                                  np.asarray(want.model_wins))
    assert got.draws == float(want.draws)
    assert got.avg_game_length == float(want.avg_game_length)
    assert got.num_games == int(want.num_games) == games
    assert float(got.model_wins.sum()) + got.draws == games


@pytest.mark.parametrize("min_discount", [1.0, 0.8])
def test_nim3_search_matches_jax(min_discount):
    """Three players, a value vector of 4 with a draw slot that never
    fills: the port's plain versions against JAX's xla walk and its
    Pallas walk in interpret mode."""
    items = random_items(NIM, 8, seed=3, max_plies=6)
    tt = assert_search_matches_jax("nim3", 8, 14, items,
                                   walk_impls=("xla", "pallas_interpret"),
                                   min_discount=min_discount)
    assert tt.value_size == 4


@pytest.mark.parametrize("case", ["uniform", "closer"])
def test_nim3_multi_arena_matches_jax(case):
    """48 games of three models (tests/test_nim.py:98-124): all uniform at
    8 simulations, or the closer against two uniform models at 2
    simulations and temperature 0.25, where it wins the most games."""
    sims, temp = (8, 1.0) if case == "uniform" else (2, 0.25)
    j_cfg, t_cfg = _nim_cfgs(sims, temp)
    j_fns = [j_uniform] * 3 if case == "uniform" else [j_closer, j_uniform,
                                                       j_uniform]
    t_fns = [t_uniform] * 3 if case == "uniform" else [t_closer, t_uniform,
                                                       t_uniform]
    rng = jax.random.PRNGKey(0 if case == "uniform" else 1)
    want = JA.make_multi_arena_fn(JNim3, j_cfg, j_fns, 48)([{}] * 3, rng)
    got = A.make_multi_arena_fn(NIM, t_cfg, t_fns, 48, device="cpu")(
        draws=arena_draws(rng))
    assert_same_result(got, want, 48)
    wins = got.model_wins.numpy()
    assert got.draws == 0
    if case == "uniform":
        assert (wins > 4).all(), wins
    else:
        assert wins[0] > max(wins[1], wins[2]) and wins[0] >= 24, wins


def test_multi_arena_raises_as_jax():
    _, t_cfg = _nim_cfgs(4, 1.0)
    with pytest.raises(ValueError, match="divisible"):
        A.make_multi_arena_fn(NIM, t_cfg, [t_uniform] * 3, 16,
                              device="cpu")()
    with pytest.raises(ValueError, match="need 3"):
        A.make_arena_fn(NIM, t_cfg, t_uniform, 48, device="cpu")()
    with pytest.raises(ValueError, match="need 3"):
        A.play_games(NIM, t_cfg, t_uniform, 48, device="cpu")


class _NoAlt(TicTacToe):
    """TicTacToe flagged non-alternating: the evaluate-every-game path."""

    ALTERNATES = False


class _JNoAlt(JTicTacToe):
    ALTERNATES = False


_CENTER = np.array([0.4, 1, 0.4, 1, 3.0, 1, 0.4, 1, 0.4], np.float32)
_CORNER = np.array([3.0, 1, 3.0, 1, 0.4, 1, 3.0, 1, 3.0], np.float32)


def _j_apply(weights):
    def apply(variables, obs):
        B = obs.shape[0]
        logp = jnp.log(jnp.tile(jnp.asarray(weights / weights.sum()),
                                (B, 1)))
        return logp, jnp.full((B, 3), -jnp.log(3.0))
    return apply


def _t_apply(weights, calls=None):
    def apply(obs):
        B = obs.shape[0]
        if calls is not None:
            calls.append(B)
        logp = torch.log(torch.from_numpy(weights / weights.sum())).expand(
            B, 9)
        return logp, torch.full((B, 3), -float(np.log(3.0)))
    return apply


def test_evaluate_every_game_matches_jax_and_grouped():
    """16 tictactoe games, centre-loving model against corner-loving:
    JAX's evaluate-all path (ALTERNATES = False) and the port's, with the
    same draws, equal; and equal to the port's owner routing and to
    ``route_owner=False``. Grouped routing forwards 8 observations a
    model and simulation, evaluate-every-game 16."""
    B, sims = 16, 8
    j_cfg = JA.ArenaConfig(sims=sims, arena_temp=1.0)
    t_cfg = A.ArenaConfig(sims=sims, arena_temp=1.0)
    rng = jax.random.PRNGKey(7)
    want = JA.make_arena_fn(_JNoAlt, j_cfg, _j_apply(_CENTER), B,
                            apply_fn_b=_j_apply(_CORNER))({}, {}, rng)
    runs = {}
    for key, env, cfg in (("no_alt", _NoAlt, t_cfg),
                          ("grouped", TicTacToe, t_cfg),
                          ("unrouted", TicTacToe,
                           t_cfg._replace(route_owner=False))):
        calls = []
        runs[key] = (A.make_arena_fn(
            env, cfg, _t_apply(_CENTER, calls), B,
            apply_fn_b=_t_apply(_CORNER), device="cpu")(
                draws=arena_draws(rng)), calls)
    for key, (got, calls) in runs.items():
        assert_same_result(got, want, B)
        assert set(calls) == ({B // 2} if key == "grouped" else {B}), key
        assert len(calls) == got.rounds * sims
