"""Multi-leaf search rounds (``leaf_batch`` > 1) of the port against the
JAX package's on the CPU.

The cases of tests/test_multileaf.py on the port's search (visit
accounting, K = 1, the immediate win, the all-terminal root, self-play),
and the port's search with rounds against JAX's: JAX runs rounds only on
its game-minor kernel path, which its CPU runs with
``walk_impl="pallas_interpret"`` (its ``xla`` path runs one leaf whatever
``leaf_batch`` is). Root noise and tie noise are on, with JAX's draws
recomputed from its keys and injected: a round's install splits its key
into the game keys directly, a single simulation (the first, and the
``(sims - 1) % K`` left over) first splits off a noise key
(mcts/search.py:223, :280, :331). Both sides evaluate with one table
(tests/test_torch_search.py), so their priors are bit-identical; visit
counts and links are held equal, q and v within ``TOL_FLOAT``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphazero_general_tpu.mcts.search as JS
import alphazero_general_tpu.mcts.tree as JT
import alphazero_general_tpu.selfplay.selfplay as JSP
from alphazero_general_tpu.envs import get_env as j_get_env
from alphazero_general_tpu.envs.connect4 import Connect4 as JConnect4
from alphazero_general_tpu.mcts.tree import NOISE_ALPHA_RATIO
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs.core import state_items
from alphazero_general_tpu_torch.mcts import search as S
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts import tree_t as TT
from alphazero_general_tpu_torch.mcts.search import SearchDraws
from alphazero_general_tpu_torch.selfplay import selfplay as SP
from test_torch_search import (random_positions, table_eval_fns,
                               to_jax_states, to_torch_states)

torch.set_num_threads(1)

#: q and v of table-driven searches (tests/test_torch_search.py).
TOL_FLOAT = 1e-6
SPEC = T.SearchSpec(num_players=2, has_draw=True)
B = 128  # the JAX kernel's lane width, as tests/test_multileaf.py


@functools.partial(jax.jit, static_argnames=("sims", "leaf_batch"))
def _jax_draws(rng, valids, sims, leaf_batch):
    """(tie [sims, B, A], gammas [B, A]) that a JAX fresh game-minor search
    of ``sims`` simulations at ``leaf_batch`` draws from ``rng``
    (search.py:288-334): simulation 0 from the first key, simulation k >= 1
    from key k - 1 of ``split(rest, sims - 1)``; a single simulation splits
    off its noise key first, a round's does not; then one key per game,
    split into (gamma key, tie key) (tree_t.py:495)."""
    Bn, A = valids.shape
    first, rest = jax.random.split(rng)
    keys = jax.random.split(rest, sims - 1)
    rounds = (sims - 1) // leaf_batch if leaf_batch > 1 else 0
    noise = jax.vmap(lambda k: jax.random.split(k)[1])
    sim_keys = jnp.concatenate([
        noise(first[None]), keys[:rounds * leaf_batch],
        noise(keys[rounds * leaf_batch:])])
    game_keys = jax.vmap(lambda k: jax.vmap(jax.random.split)(
        jax.random.split(k, Bn)))(sim_keys)  # [sims, B, 2, 2]
    tie = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, (A,))))(
        game_keys[:, :, 1])
    alpha = NOISE_ALPHA_RATIO / jnp.maximum(valids.sum(-1),
                                            1).astype(jnp.float32)
    gammas = jax.vmap(lambda k, a: jax.random.gamma(k, a, (A,)))(
        game_keys[0, :, 0], alpha)
    return tie, gammas


def jax_draws(rng, valids, sims, leaf_batch) -> SearchDraws:
    """``_jax_draws`` as the port's SearchDraws (``valids`` a bool torch
    tensor [B, A] of the roots)."""
    tie, gammas = _jax_draws(rng, jnp.asarray(valids.numpy()), sims=sims,
                             leaf_batch=leaf_batch)
    return SearchDraws(tie=torch.from_numpy(np.array(tie)),
                       gammas=torch.from_numpy(np.array(gammas)))


def count_pending_stops(monkeypatch) -> list:
    """Patch the search's walk to record, per walk, how many games stopped
    at a pending child (allocated, n == 0); returns the list it fills."""
    stops = []
    walk = S.descend_batched_t

    def recording(tt, spec):
        out = walk(tt, spec)
        child = out[2].long()
        games = torch.arange(child.shape[0])
        pending = (child >= 0) & (tt.n[child.clamp(min=0), games] == 0)
        stops.append(int(pending.sum()))
        return out

    monkeypatch.setattr(S, "descend_batched_t", recording)
    return stops


def port_and_jax_search(pos, sims, leaf_batch, rng_seed=0):
    """The port's fresh TreeT search and the JAX package's pallas_interpret
    search of ``pos`` (connect4) at ``leaf_batch``, with the default spec
    (root temperature, Dirichlet and tie noise on), the same table
    evaluation and JAX's draws injected. Returns (port TreeT, JAX Tree)."""
    j_eval, t_eval = table_eval_fns()
    rng = jax.random.PRNGKey(rng_seed)
    jt = JS.init_batched_trees(JConnect4, to_jax_states(pos), sims + 2, 3)
    jt = JS.search(JConnect4, jt, JT.SearchSpec(), j_eval, sims, rng,
                   walk_impl="pallas_interpret", leaf_batch=leaf_batch)
    env = get_env("connect4")
    states = to_torch_states(pos)
    draws = jax_draws(rng, env.valid_moves(states), sims, leaf_batch)
    tt = TT.init_tree_t(env, states, sims + 2, 3)
    S.search(env, tt, T.SearchSpec(), t_eval, sims, draws=draws,
             leaf_batch=leaf_batch)
    return tt, jt


def assert_matches_jax(tt, jt):
    """Root counts, n and links equal below the sink; q, v within
    TOL_FLOAT."""
    np.testing.assert_array_equal(T.counts(tt).numpy(),
                                  np.asarray(jax.vmap(JT.counts)(jt)))
    for name in ("n", "parent", "parent_action"):
        np.testing.assert_array_equal(getattr(tt, name).T.numpy()[:, :-1],
                                      np.asarray(getattr(jt, name))[:, :-1],
                                      err_msg=name)
    for name in ("q", "v"):
        np.testing.assert_allclose(getattr(tt, name).T.numpy()[:, :-1],
                                   np.asarray(getattr(jt, name))[:, :-1],
                                   rtol=TOL_FLOAT, atol=TOL_FLOAT,
                                   err_msg=name)
    np.testing.assert_array_equal(tt.max_depth.numpy(),
                                  np.asarray(jt.max_depth))


@pytest.mark.parametrize("leaf_batch,sims", [(2, 20), (8, 36)])
def test_search_matches_jax(leaf_batch, sims, monkeypatch):
    """At K = 2 (19 simulations after the root's: 9 rounds and 1 single)
    and K = 8 (35: 4 rounds and 3 singles), from random openings, with
    noise on: equal to JAX's search with rounds, and some walk of a round
    stopped at a pending child."""
    pos = random_positions(16, seed=31, max_plies=8)
    stops = count_pending_stops(monkeypatch)
    tt, jt = port_and_jax_search(pos, sims, leaf_batch)
    rounds = (sims - 1) // leaf_batch
    assert len(stops) == sims - 1
    assert sum(stops[:rounds * leaf_batch]) > 0, stops
    assert_matches_jax(tt, jt)
    assert (tt.n[0] == sims).all()


def _search_k(env, states, sims, K, seed=0, eval_fn=None):
    eval_fn = eval_fn or S.uniform_eval_fn(env.ACTION_SIZE, 3,
                                           uniform_value=True)
    tt = TT.init_tree_t(env, states, sims + 2, 3)
    return S.search(env, tt, SPEC, eval_fn, sims,
                    torch.Generator().manual_seed(seed), leaf_batch=K)


def _position(env, moves, batch=B):
    s = env.init(1, "cpu")
    for m in moves:
        s = env.step(s, torch.tensor([m]))
    return env.State(**{k: x.expand((batch,) + x.shape[1:]).clone()
                        for k, x in state_items(s).items()})


@pytest.mark.parametrize("K", [2, 4])
def test_visit_accounting(K):
    """Every simulation backs up once: root n == sims, the root children's
    visits sum to sims - 1 (the first expands the root)."""
    env = get_env("tictactoe")
    tt = _search_k(env, env.init(B, "cpu"), 21, K)
    assert (tt.n[0] == 21).all()
    assert (T.counts(tt).sum(-1) == 20).all()


def test_k1_unchanged_vs_default_path():
    """``leaf_batch=1`` is the default search, field for field, and its
    visit counts are those of the batch-major fresh search with the same
    draws."""
    env = get_env("tictactoe")
    a = _search_k(env, env.init(B, "cpu"), 17, 1, seed=3)
    b = TT.init_tree_t(env, env.init(B, "cpu"), 19, 3)
    S.search(env, b, SPEC, S.uniform_eval_fn(9, 3, uniform_value=True), 17,
             torch.Generator().manual_seed(3))
    for name in ("parent", "parent_action", "n", "q", "v", "prior", "nba",
                 "nbp", "e", "max_depth"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    tree = S.init_batched_trees(env, env.init(B, "cpu"), 19, 3)
    S.search(env, tree, SPEC, S.uniform_eval_fn(9, 3, uniform_value=True),
             17, torch.Generator().manual_seed(3))
    assert torch.equal(T.counts(a), T.counts(tree))


def test_finds_immediate_win_with_rounds():
    """A K = 4 search still piles its visits on the winning move (X at 0
    and 1, O at 3 and 4: X wins at 2)."""
    env = get_env("tictactoe")
    tt = _search_k(env, _position(env, (0, 3, 1, 4)), 40, 4, seed=1)
    assert (T.counts(tt).argmax(-1) == 2).all()


def test_terminal_root_rounds():
    """An all-terminal batch: rounds neither corrupt the statistics nor
    crash (every walk is skipped and backs up the root)."""
    env = get_env("tictactoe")
    tt = _search_k(env, _position(env, (0, 3, 1, 4, 2)), 9, 4, seed=2)
    assert (tt.n[0] == 9).all()
    assert (T.counts(tt).sum(-1) == 0).all()


def test_selfplay_with_leaf_batch():
    """A full tictactoe move at ``leaf_batch=3`` (9 simulations: 2 rounds
    and 2 singles) through ``make_move_fns`` against JAX's ``move_step``
    with ``walk_impl="pallas_interpret"``, which runs the rounds: the same
    policies and actions, with JAX's draws."""
    env, jenv = get_env("tictactoe"), j_get_env("tictactoe")
    spec_kw = dict(num_players=env.NUM_PLAYERS, has_draw=env.HAS_DRAW)
    j_cfg = JSP.SelfPlayConfig(sims_full=9, sims_fast=5, leaf_batch=3,
                               walk_impl="pallas_interpret",
                               spec=JT.SearchSpec(**spec_kw))
    cfg = SP.SelfPlayConfig(sims_full=9, sims_fast=5, leaf_batch=3,
                            spec=T.SearchSpec(**spec_kw))

    def j_eval(obs):  # the uniform network of tests/test_multileaf.py
        zeros = jnp.zeros((obs.shape[0], jenv.ACTION_SIZE))
        return (jnp.exp(jax.nn.log_softmax(zeros)),
                jnp.exp(jax.nn.log_softmax(zeros[:, :3])))

    def t_apply(obs):
        zeros = torch.zeros((obs.shape[0], env.ACTION_SIZE))
        return (torch.log_softmax(zeros, -1),
                torch.log_softmax(zeros[:, :3], -1))

    rng = jax.random.PRNGKey(5)
    _, j_rec = jax.jit(lambda c, r: JSP.move_step(
        jenv, j_cfg, j_eval, c, r, sims_override=9, fast_flag=False))(
            JSP.init_selfplay(jenv, 8, 1.0), rng)
    carry = SP.init_selfplay(env, 8, 1.0, device="cpu")
    _, r_search, r_action, _ = jax.random.split(rng, 4)
    draws = jax_draws(r_search, env.valid_moves(carry.env_state), 9, 3)
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(
        r_action, (8, env.ACTION_SIZE), jnp.float32)))
    _, rec = SP.make_move_fns(env, cfg, t_apply)["full"](
        carry, gumbel=gumbel, search_draws=draws)
    np.testing.assert_array_equal(rec.action.numpy(),
                                  np.asarray(j_rec.action))
    assert (rec.root_visits == 9).all()
    np.testing.assert_allclose(rec.pi.float().numpy(),
                               np.asarray(j_rec.pi, np.float32), rtol=0,
                               atol=2**-11)
