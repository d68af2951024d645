"""The port's whole fresh-tree search against the JAX search, and its prior
install against JAX's with the random draws JAX made.

Both searches are driven by the same table evaluation: policy and value
rows of a float32 table indexed by an integer hash of the stone planes,
computed with integer arithmetic on both sides, so that both sides get
bit-identical priors and the visit counts can be held equal exactly.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphazero_general_tpu.mcts.search as JS
import alphazero_general_tpu.mcts.tree as JT
import alphazero_general_tpu.mcts.tree_t as JTT
from alphazero_general_tpu.envs.connect4 import Connect4 as JConnect4
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.mcts import search as S
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts import tree_t as TT

TABLE_ROWS = 4093


def table_eval_fns(seed=0, rows=TABLE_ROWS):
    """(jax_eval_fn, torch_eval_fn) over one shared float32 table."""
    rng = np.random.default_rng(seed)
    pi_tab = rng.dirichlet(np.ones(7), rows).astype(np.float32)
    v_tab = rng.dirichlet(np.ones(3), rows).astype(np.float32)
    w = rng.integers(1, rows, size=(2, 42)).astype(np.int32)

    def j_eval(obs):
        stones = (obs[:, :2] > 0.5).reshape(obs.shape[0], 2, 42)
        h = jnp.sum(stones.astype(jnp.int32) * jnp.asarray(w),
                    axis=(1, 2)) % rows
        return jnp.asarray(pi_tab)[h], jnp.asarray(v_tab)[h]

    def t_eval(obs):
        stones = (obs[:, :2] > 0.5).reshape(obs.shape[0], 2, 42)
        h = (stones.to(torch.int32) * torch.from_numpy(w)).sum(
            dim=(1, 2)) % rows
        return (torch.from_numpy(pi_tab)[h.long()],
                torch.from_numpy(v_tab)[h.long()])

    return j_eval, t_eval


def random_positions(batch, seed, max_plies):
    """Numpy boards/players/turns of games advanced by random legal moves,
    never into a finished position."""
    rng = np.random.default_rng(seed)
    env = get_env("connect4")
    out = {k: [] for k in ("board", "player", "turns", "last_action")}
    for _ in range(batch):
        s = env.init(1, device="cpu")
        for _ in range(int(rng.integers(0, max_plies + 1))):
            valid = np.flatnonzero(env.valid_moves(s)[0].numpy())
            nxt = env.step(s, torch.tensor([rng.choice(valid)]))
            if env.terminated(nxt)[0] or not env.valid_moves(nxt).any():
                break
            s = nxt
        for k in out:
            out[k].append(getattr(s, k)[0].numpy())
    return {k: np.stack(v) for k, v in out.items()}


def to_jax_states(pos):
    return JConnect4.State(**{k: jnp.asarray(v) for k, v in pos.items()})


def to_torch_states(pos):
    return get_env("connect4").State(
        **{k: torch.from_numpy(v.copy()) for k, v in pos.items()})


@pytest.mark.parametrize("min_discount", [1.0, 0.8])
def test_search_matches_jax(min_discount):
    B, sims = 8, 24
    kw = dict(tie_noise=0.0, add_root_noise=False, min_discount=min_discount)
    j_eval, t_eval = table_eval_fns()
    pos = random_positions(B, seed=11, max_plies=10)

    jt = JS.init_batched_trees(JConnect4, to_jax_states(pos), sims + 2, 3)
    jt = JS.search(JConnect4, jt, JT.SearchSpec(**kw), j_eval, sims,
                   jax.random.PRNGKey(0), walk_impl="xla")
    env = get_env("connect4")
    tt = TT.init_tree_t(env, to_torch_states(pos), sims + 2, 3)
    S.search(env, tt, T.SearchSpec(**kw), t_eval, sims)

    for name in ("n", "parent", "parent_action"):  # sink row excluded
        np.testing.assert_array_equal(getattr(tt, name).T.numpy()[:, :-1],
                                      np.asarray(getattr(jt, name))[:, :-1],
                                      err_msg=name)
    for name in ("q", "v"):
        np.testing.assert_allclose(getattr(tt, name).T.numpy()[:, :-1],
                                   np.asarray(getattr(jt, name))[:, :-1],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(T.counts(tt).numpy(),
                                  np.asarray(jax.vmap(JT.counts)(jt)))
    assert (tt.n[0] == sims).all()


def test_uniform_eval_search_matches_jax():
    """The model-free search (uniform policy, zero values): every score
    ties, so this holds the tie rules of the walk against JAX's."""
    B, sims = 8, 16
    kw = dict(tie_noise=0.0, add_root_noise=False)
    pos = random_positions(B, seed=13, max_plies=10)

    jt = JS.init_batched_trees(JConnect4, to_jax_states(pos), sims + 2, 3)
    jt = JS.search(JConnect4, jt, JT.SearchSpec(**kw),
                   JS.uniform_eval_fn(7, 3), sims, jax.random.PRNGKey(0),
                   walk_impl="xla")
    env = get_env("connect4")
    tt = TT.init_tree_t(env, to_torch_states(pos), sims + 2, 3)
    S.search(env, tt, T.SearchSpec(**kw), S.uniform_eval_fn(7, 3), sims)

    for name in ("n", "parent", "parent_action"):  # sink row excluded
        np.testing.assert_array_equal(getattr(tt, name).T.numpy()[:, :-1],
                                      np.asarray(getattr(jt, name))[:, :-1],
                                      err_msg=name)
    np.testing.assert_allclose(tt.q.T.numpy()[:, :-1],
                               np.asarray(jt.q)[:, :-1], rtol=1e-6,
                               atol=1e-6)
    assert (tt.n[0] == sims).all()


def test_install_prior_matches_jax_with_injected_draws():
    """Root temperature, Dirichlet noise and tie noise, with the gamma and
    uniform draws recomputed from JAX's own keys and passed in."""
    B, A = 16, 7
    spec_kw = dict(tie_noise=1e-6)
    pos = random_positions(B, seed=5, max_plies=30)
    rng = np.random.default_rng(1)
    pi = rng.dirichlet(np.ones(A), B).astype(np.float32)
    leaf = np.where(rng.random(B) < 0.5, 0, 3).astype(np.int32)
    slot = 3

    jtree = JS.init_batched_trees(JConnect4, to_jax_states(pos), 8, 3)
    jt = JTT.tree_to_tree_t(jtree)
    jt, _obs, _e, valids = JTT.expand_root_t(JConnect4, jt)
    jt = jt.replace(leaf=jnp.asarray(leaf))
    keys = jax.random.split(jax.random.PRNGKey(42), B)
    jt = JTT.install_prior_t(jt, jnp.asarray(pi), JT.SearchSpec(**spec_kw),
                             keys, None, None, True, slot, valids)

    # The draws install_prior_t made: per game, key → (noise key, tie key).
    valids = np.array(valids)
    split = jax.vmap(jax.random.split)(keys)
    alpha = (np.float32(JT.NOISE_ALPHA_RATIO)
             / np.maximum(valids.sum(-1), 1).astype(np.float32))
    gammas = np.stack([np.asarray(jax.random.gamma(split[b, 0], alpha[b],
                                                   (A,)))
                       for b in range(B)])
    tie = np.array(jax.vmap(lambda k: jax.random.uniform(k, (A,)))(
        split[:, 1]))

    env = get_env("connect4")
    tt = TT.init_tree_t(env, to_torch_states(pos), 8, 3)
    TT.expand_root_t(env, tt)
    tt.leaf.copy_(torch.from_numpy(leaf))
    TT.install_prior_t(tt, torch.from_numpy(pi), T.SearchSpec(**spec_kw),
                       True, slot, torch.from_numpy(valids),
                       gammas=torch.from_numpy(gammas),
                       tie=torch.from_numpy(tie))

    # JAX keeps connect4's prior rows game-minor [N*A, B], the port
    # batch-major [B, N, A].
    rows = slice(slot * A, (slot + 1) * A)
    np.testing.assert_allclose(tt.prior[:, slot].T.numpy(),
                               np.asarray(jt.prior)[rows], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(tt.nba[slot].numpy(),
                                  np.asarray(jt.nba)[slot])
    np.testing.assert_allclose(tt.nbp[slot].numpy(), np.asarray(jt.nbp)[slot],
                               rtol=1e-6, atol=1e-7)
    # The draws mattered: root rows differ from the plain masked policy.
    assert (valids.sum(-1) < A).any()
    root = leaf == 0
    masked = np.where(valids, pi, 0)
    masked /= masked.sum(-1, keepdims=True)
    assert not np.allclose(tt.prior[:, slot].numpy()[root], masked[root],
                           atol=1e-3)


def test_install_prior_draws_from_generator_when_not_given():
    env = get_env("connect4")
    B = 4
    tt = TT.init_tree_t(env, env.init(B, device="cpu"), 4, 3)
    _obs, _e, valids = TT.expand_root_t(env, tt)
    pi = torch.full((B, 7), 1 / 7)
    with pytest.raises(ValueError):
        TT.install_prior_t(tt, pi, T.SearchSpec(), True, 0, valids)
    TT.install_prior_t(tt, pi, T.SearchSpec(), True, 0, valids,
                       generator=torch.Generator().manual_seed(0))
    prior = tt.prior[:, 0]
    assert torch.allclose(prior.sum(-1), torch.ones(B), atol=1e-4)
    assert not torch.allclose(prior[0], prior[1])  # each game drew its own


def test_probs_and_next_best_match_jax():
    """Visit-count policies at temperatures 0, 0.3 and 1 (with unvisited
    actions and an all-zero row), and rank-walk pointer advances over rows
    with exact prior ties and invalid actions."""
    rng = np.random.default_rng(3)
    visits = rng.integers(0, 6, (16, 7)).astype(np.int32)
    visits[rng.random((16, 7)) < 0.3] = 0
    visits[0] = 0
    temps = np.array([0.0, 0.3, 1.0, 2.0] * 4, np.float32)
    want = jax.vmap(lambda c, t: _j_probs(c, t))(jnp.asarray(visits),
                                                  jnp.asarray(temps))
    got = T.probs(torch.from_numpy(visits), torch.from_numpy(temps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)

    prior = rng.choice([0.1, 0.2, 0.3, -1.0], (16, 7)).astype(np.float32)
    p_star = prior[np.arange(16), rng.integers(0, 7, 16)]
    a_star = rng.integers(0, 7, 16).astype(np.int32)
    for args in ((), (p_star, a_star)):
        ja, jp = JT._next_best(jnp.asarray(prior),
                               *(jnp.asarray(x) for x in args))
        ta, tp = T.next_best(torch.from_numpy(prior),
                             *(torch.from_numpy(x) for x in args))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def _j_probs(c, temp):
    """JAX ``probs`` of a one-level tree whose root children (rows 1..7,
    one per action; row 8 is the sink) hold the visit counts ``c``."""
    A = c.shape[0]
    tree = types.SimpleNamespace(
        parent=jnp.concatenate([jnp.array([-1]), jnp.zeros(A, jnp.int32),
                                jnp.array([-1])]),
        parent_action=jnp.concatenate([jnp.array([-1]),
                                       jnp.arange(A, dtype=jnp.int32),
                                       jnp.array([-1])]),
        n=jnp.concatenate([jnp.array([1]), c, jnp.array([0])]),
        q=jnp.zeros(A + 2, jnp.float32), num_actions=A)
    return JT.probs(tree, temp)
