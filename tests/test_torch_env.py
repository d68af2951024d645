"""Parity of the PyTorch port's connect4 env with the JAX env: 64 random
rollouts to the end, compared step by step (board, player, turns, last
action, valid moves, win state, observation, symmetries), all exactly
equal."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alphazero_general_tpu.envs.connect4 import Connect4 as JConnect4
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs.core import state_items

B = 64
FIELDS = ("board", "player", "turns", "last_action")

j_init = jax.jit(jax.vmap(lambda _: JConnect4.init()))
j_step = jax.jit(jax.vmap(JConnect4.step))
j_valid = jax.jit(jax.vmap(JConnect4.valid_moves))
j_win = jax.jit(jax.vmap(JConnect4.win_state))
j_obs = jax.jit(jax.vmap(JConnect4.observation))
j_sym = jax.jit(jax.vmap(JConnect4.symmetries))


def _select(active, new, old):
    return {k: np.where(active.reshape((-1,) + (1,) * (new[k].ndim - 1)),
                        new[k], old[k]) for k in new}


def test_connect4_rollouts_match_jax():
    env = get_env("connect4")
    rng = np.random.default_rng(0)
    js = j_init(jnp.arange(B))
    ts = env.init(B, device="cpu")
    for _ in range(env.MAX_TURNS + 1):
        t_items = {k: v.numpy() for k, v in state_items(ts).items()}
        for k in FIELDS:
            np.testing.assert_array_equal(
                t_items[k], np.asarray(getattr(js, k)), err_msg=k)
        valid = env.valid_moves(ts).numpy()
        np.testing.assert_array_equal(valid, np.asarray(j_valid(js)))
        win = env.win_state(ts).numpy()
        np.testing.assert_array_equal(win, np.asarray(j_win(js)))
        obs = env.observation(ts)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(j_obs(js)))
        pi = rng.random((B, env.ACTION_SIZE)).astype(np.float32)
        t_o, t_p = env.symmetries(obs, torch.from_numpy(pi))
        j_o, j_p = j_sym(jnp.asarray(obs.numpy()), jnp.asarray(pi))
        assert t_o.shape[1] == t_p.shape[1] == env.NUM_SYMMETRIES
        np.testing.assert_array_equal(t_o.numpy(), np.asarray(j_o))
        np.testing.assert_array_equal(t_p.numpy(), np.asarray(j_p))

        active = ~(win > 0).any(axis=1) & valid.any(axis=1)
        if not active.any():
            break
        action = np.array([rng.choice(np.flatnonzero(v)) if a else 0
                           for v, a in zip(valid, active)], np.int32)
        j_new = j_step(js, jnp.asarray(action))
        t_new = env.step(ts, torch.from_numpy(action))
        j_sel = _select(active, {k: np.asarray(getattr(j_new, k))
                                 for k in FIELDS},
                        {k: np.asarray(getattr(js, k)) for k in FIELDS})
        js = js.replace(**{k: jnp.asarray(v) for k, v in j_sel.items()})
        t_sel = _select(active, {k: v.numpy() for k, v in
                                 state_items(t_new).items()}, t_items)
        ts = env.State(**{k: torch.from_numpy(v) for k, v in t_sel.items()})
    else:
        raise AssertionError("rollouts did not end within MAX_TURNS moves")
    # Every game ended, with each outcome kind seen at least once.
    outcomes = env.win_state(ts).numpy().argmax(axis=1)
    assert set(outcomes.tolist()) >= {0, 1}


def test_full_column_step_wraps_like_jax():
    """Stepping a full column lands on the bottom row in both envs (the
    search re-steps finished positions into unreachable junk rows)."""
    env = get_env("connect4")
    board = np.zeros((1, 6, 7), np.int8)
    board[0, :, 3] = [1, -1, 1, -1, 1, -1]
    js = j_init(jnp.arange(1)).replace(board=jnp.asarray(board))
    ts = env.init(1, device="cpu")
    ts.board = torch.from_numpy(board.copy())
    action = np.array([3], np.int32)
    np.testing.assert_array_equal(
        env.step(ts, torch.from_numpy(action)).board.numpy(),
        np.asarray(j_step(js, jnp.asarray(action)).board))
