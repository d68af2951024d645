"""The port's players, root readers and fresh batch-major search against the
JAX package's on the CPU.

Each player of each package plays from the same states with the same seed.
Where a search draws random numbers (the root's Dirichlet noise, the tie
noise of every prior install), the JAX player's draws are recomputed from
its own keys and passed to the port's ``play``. The networks are small
ResNets whose weights the JAX wrapper made, carried across by
utils/convert.py (float32). Visit counts, policies and actions must be
equal; the root value (``last_value``) agrees within 1e-5, since the two
frameworks' float32 convolutions round otherwise (rtol 1e-4, atol 1e-5 on
the log-probabilities, tests/test_torch_model.py) and the value is a mean
of backed-up network values. The table-driven searches (bit-identical
priors on both sides) hold q within 1e-6, as tests/test_torch_search.py
does.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphazero_general_tpu.mcts.search as JS
import alphazero_general_tpu.mcts.tree as JT
import alphazero_general_tpu.players.players as JP
from alphazero_general_tpu.envs import get_env as j_get_env
from alphazero_general_tpu.mcts.tree import NOISE_ALPHA_RATIO
from alphazero_general_tpu.utils.config import get_args as j_get_args
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.mcts import search as S
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts.search import SearchDraws
from alphazero_general_tpu_torch.players import players as P
from alphazero_general_tpu_torch.utils import get_args
from test_torch_envs import random_items, table_eval_fns, to_jax, to_torch
from test_torch_model import jax_and_port
from test_torch_reuse import port_tree as c4_port_tree

torch.set_num_threads(1)

#: last_value against JAX's with converted float32 networks (docstring).
VALUE_TOL = 1e-5
#: q of table-driven searches (docstring).
TOL_FLOAT = 1e-6


def one(items, b):
    """Game ``b`` of numpy state fields, as a batch of one."""
    return {k: v[b:b + 1] for k, v in items.items()}


def states(name, count, seed, max_plies):
    """``count`` positions of ``name`` as (port state, JAX state) pairs."""
    env, jenv = get_env(name), j_get_env(name)
    items = random_items(env, count, seed, max_plies)
    return [(to_torch(env, one(items, b)),
             to_jax(jenv, {k: v[b] for k, v in items.items()}))
            for b in range(count)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _gamma_tie(key, alpha, A):
    """The (Dirichlet gamma, tie) draws of one prior install from its key
    (JAX mcts/tree.py:768)."""
    g_key, t_key = jax.random.split(key)
    return (np.asarray(jax.random.gamma(g_key, alpha, (A,))),
            np.asarray(jax.random.uniform(t_key, (A,))))


def _alpha(jenv, js):
    return np.float32(NOISE_ALPHA_RATIO) / np.float32(
        max(int(np.asarray(jenv.valid_moves(js)).sum()), 1))


def mcts_player_draws(key, jenv, js, sims):
    """The draws the JAX MCTSPlayer's next move makes from its key (its
    host loop, players.py:186-195): per simulation ``key, k, k2 =
    split(key, 3)`` and the install key ``split(k2, 1)[0]``."""
    A, alpha = jenv.ACTION_SIZE, _alpha(jenv, js)
    ties, gammas = [], None
    for k in range(sims):
        key, _, k2 = jax.random.split(key, 3)
        g, t = _gamma_tie(jax.random.split(k2, 1)[0], alpha, A)
        gammas = g if k == 0 else gammas
        ties.append(t)
    return SearchDraws(tie=_t(np.stack(ties)[:, None]),
                       gammas=_t(gammas[None]))


def nets(name, seed=3):
    """(JAX shim with ``process``, port wrapper) over one converted small
    ResNet of ``name``, float32."""
    jnet, variables, net = jax_and_port("float32", seed=seed, env_name=name)
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    apply = jax.jit(lambda obs: jnet.model.apply(variables, obs,
                                                 train=False))

    def process(obs):
        logp, logv = apply(obs)
        return jnp.exp(logp), jnp.exp(logv)

    shim = types.SimpleNamespace(process=process, env=jnet.env,
                                 args=jnet.args)
    return shim, net


# --------------------------------------------------------------------------
# Root readers and the fresh batch-major search
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def searched_c4():
    """A JAX connect4 search on fresh batched trees (xla walk, table
    evaluation, root noise off) and the same trees in the port's layout."""
    from test_torch_search import random_positions, to_jax_states

    j_eval, _ = table_eval_fns(get_env("connect4"))
    pos = random_positions(8, seed=5, max_plies=10)
    spec = JT.SearchSpec(add_root_noise=False)
    jt = JS.init_batched_trees(j_get_env("connect4"), to_jax_states(pos), 26,
                               3)
    jt = JS.search(j_get_env("connect4"), jt, spec, j_eval, 24,
                   jax.random.PRNGKey(1), walk_impl="xla")
    return jt, c4_port_tree(jt)


@pytest.mark.parametrize("reader", ["counts", "root_child_stats",
                                    "best_action", "root_value",
                                    "root_value_average", "probs"])
def test_root_readers_match_jax(searched_c4, reader):
    """Each root reader of the port on the same searched trees as JAX's:
    counts and best actions equal, q and the policies within 1e-6."""
    jt, tree = searched_c4
    if reader == "probs":
        for temp in (0.0, 0.25, 1.0, 3.0):
            want = jax.vmap(JT.probs)(jt, jnp.full((8,), temp))
            np.testing.assert_allclose(T.probs(tree, temp).numpy(),
                                       np.asarray(want), rtol=TOL_FLOAT,
                                       atol=TOL_FLOAT)
        np.testing.assert_array_equal(T.probs(tree, 1.0).numpy(),
                                      T.probs(T.counts(tree), 1.0).numpy())
        return
    average = reader.endswith("average")
    fn = {"counts": T.counts, "root_child_stats": T.root_child_stats,
          "best_action": T.best_action,
          "root_value": lambda t: T.root_value(t, average)}[
              reader.removesuffix("_average")]
    jfn = {"counts": JT.counts, "root_child_stats": JT.root_child_stats,
           "best_action": JT.best_action,
           "root_value": lambda t: JT.root_value(t, average)}[
               reader.removesuffix("_average")]
    got, want = fn(tree), jax.vmap(jfn)(jt)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=TOL_FLOAT, atol=TOL_FLOAT)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # The readers take a TreeT alike (a fresh game-minor search).
    if reader in ("counts", "root_child_stats"):
        assert (T.counts(tree).sum(-1) == 23).all()


@pytest.mark.parametrize("name,sims,root_noise", [
    ("connect4", 24, False), ("connect4", 24, True), ("nim3", 20, True)])
def test_search_on_fresh_tree_matches_jax(name, sims, root_noise):
    """search(Tree, fresh_tree=True) against JAX's ``S.search`` on fresh
    batched trees (xla walk; root temperature, Dirichlet and tie noise on
    where ``root_noise``, JAX's draws injected): root visit counts, the
    root children's q and the deepest walk equal (q within 1e-6); on
    games whose every simulation after the first allocated a row, the
    visit counts and links of every row."""
    env, jenv = get_env(name), j_get_env(name)
    B, V = 6, env.NUM_PLAYERS + int(env.HAS_DRAW)
    kw = dict(add_root_noise=root_noise, add_root_temp=root_noise,
              tie_noise=1e-6 if root_noise else 0.0,
              num_players=env.NUM_PLAYERS, has_draw=env.HAS_DRAW)
    j_eval, t_eval = table_eval_fns(env)
    items = random_items(env, B, seed=7, max_plies=6)
    rng = jax.random.PRNGKey(4)
    jt = JS.init_batched_trees(jenv, to_jax(jenv, items), sims + 2, V)
    jt = JS.search(jenv, jt, JT.SearchSpec(**kw), j_eval, sims, rng,
                   walk_impl="xla")
    draws = (_batched_search_draws(rng, jenv, to_jax(jenv, items), sims)
             if root_noise else None)
    tree = S.init_batched_trees(env, to_torch(env, items), sims + 2, V)
    S.search(env, tree, T.SearchSpec(**kw), t_eval, sims, draws=draws)

    j_counts, j_q = (np.asarray(x) for x in jax.vmap(JT.root_child_stats)(jt))
    counts, q = T.root_child_stats(tree)
    np.testing.assert_array_equal(counts.numpy(), j_counts)
    np.testing.assert_allclose(q.numpy(), j_q, rtol=TOL_FLOAT,
                               atol=TOL_FLOAT)
    np.testing.assert_array_equal(tree.max_depth.numpy(),
                                  np.asarray(jt.max_depth))
    full = (tree.next_free == sims).numpy()
    assert full.sum() >= B // 2
    for f in ("n", "parent", "parent_action"):
        np.testing.assert_array_equal(
            getattr(tree, f).numpy()[full, :-1],
            np.asarray(getattr(jt, f))[full, :-1], err_msg=f)
    assert (counts.sum(-1) == sims - 1).all()


def _batched_search_draws(rng, jenv, js, sims):
    """The draws of a JAX ``S.search`` over a batch of B games: the game
    keys of each simulation are ``split(noise, B)``."""
    valids = jax.vmap(jenv.valid_moves)(js)
    B, A = valids.shape
    first, rest = jax.random.split(rng)
    keys = [first] + list(jax.random.split(rest, sims - 1))
    alpha = (np.float32(NOISE_ALPHA_RATIO)
             / np.maximum(np.asarray(valids).sum(-1), 1).astype(np.float32))
    ties, gammas = [], None
    for k, key in enumerate(keys):
        game_keys = jax.random.split(jax.random.split(key)[1], B)
        pairs = [_gamma_tie(game_keys[b], alpha[b], A) for b in range(B)]
        ties.append(np.stack([t for _, t in pairs]))
        if k == 0:
            gammas = np.stack([g for g, _ in pairs])
    return SearchDraws(tie=_t(np.stack(ties)), gammas=_t(gammas))


def test_search_rejects_a_searched_tree_as_fresh():
    env = get_env("connect4")
    _, t_eval = table_eval_fns(env)
    spec = T.SearchSpec(add_root_noise=False, tie_noise=0.0)
    tree = S.init_batched_trees(env, env.init(2, "cpu"), 10, 3)
    with pytest.raises(ValueError, match=r"\[1, 10\]"):
        S.search(env, tree, spec, t_eval, 11)
    S.search(env, tree, spec, t_eval, 10)  # every row used
    assert (tree.next_free == 10).all() and (tree.n[:, 0] == 10).all()
    with pytest.raises(ValueError, match="never searched"):
        S.search(env, tree, spec, t_eval, 2)


def test_raw_search_matches_jax():
    """``raw_search`` (uniform policy, zero values; every score ties)
    against JAX's with its draws injected: root counts equal."""
    env, jenv = get_env("tictactoe"), j_get_env("tictactoe")
    items = random_items(env, 4, seed=2, max_plies=3)
    spec_kw = dict(num_players=2, has_draw=True)
    rng = jax.random.PRNGKey(9)
    jt = JS.raw_search(jenv, to_jax(jenv, items), JT.SearchSpec(**spec_kw),
                       30, rng)
    tree = S.raw_search(env, to_torch(env, items), T.SearchSpec(**spec_kw),
                        30, draws=_batched_search_draws(
                            rng, jenv, to_jax(jenv, items), 30))
    np.testing.assert_array_equal(T.counts(tree).numpy(),
                                  np.asarray(jax.vmap(JT.counts)(jt)))
    assert tree.parent.shape == (4, 33)


# --------------------------------------------------------------------------
# Players
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,plies", [("connect4", 8), ("nim3", 4),
                                        ("brandubh", 6)])
def test_mcts_player_matches_jax(name, plies):
    """MCTSPlayer over a converted ResNet (connect4; nim3 with 3 players;
    brandubh with A = 588): three moves from random positions, JAX's root
    noise, root temperature and tie noise injected; the action, the visit
    policy (the JAX player's, recomputed from its visit counts), the
    deepest walk and the root value."""
    shim, net = nets(name)
    sims = 12
    args = dict(numMCTSSims=sims, startTemp=1.0)
    jp = JP.MCTSPlayer(shim, j_get_env(name), j_get_args(**args), seed=5)
    p = P.MCTSPlayer(net, get_env(name), get_args(**args), seed=5)
    assert p.device == torch.device("cpu")
    jenv = j_get_env(name)
    for state, js in states(name, 3, seed=11, max_plies=plies):
        draws = mcts_player_draws(jp._key, jenv, js, sims)
        want = jp.play(js)
        got = p.play(state, draws=draws)
        assert got == want
        assert p.last_depth == jp.last_depth
        assert abs(p.last_value - jp.last_value) <= VALUE_TOL
        assert p.temp == jp.temp
        assert int(T.counts(p.last_tree).sum()) == sims - 1
        assert p.last_policy.sum() == pytest.approx(1.0, abs=1e-6)


def test_mcts_player_policy_matches_jax():
    """The visit policy of one MCTSPlayer move, from start temperatures 1
    and 0 (one-hot), against the JAX player's searched tree."""
    shim, net = nets("connect4")
    sims = 16
    for temp in (1.0, 0.0):
        args = dict(numMCTSSims=sims, startTemp=temp)
        jp = JP.MCTSPlayer(shim, j_get_env("connect4"), j_get_args(**args),
                           seed=2)
        p = P.MCTSPlayer(net, get_env("connect4"), get_args(**args), seed=2)
        (state, js), = states("connect4", 1, seed=3, max_plies=6)
        draws = mcts_player_draws(jp._key, j_get_env("connect4"), js, sims)
        key = jp._key
        j_trees = jp._run_search(js, sims)
        jp._key = key  # play() searches again from the same key
        assert p.play(state, draws=draws) == jp.play(js)
        # play() scales the temperature first (args.temp_scaling_fn).
        want_pi = np.asarray(jax.vmap(JT.probs)(j_trees,
                                                jnp.full((1,), jp.temp)))[0]
        np.testing.assert_allclose(p.last_policy, want_pi, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(
            T.counts(p.last_tree).numpy()[0],
            np.asarray(jax.vmap(JT.counts)(j_trees))[0])


@pytest.mark.parametrize("name", ["connect4", "tictactoe"])
def test_raw_mcts_player_matches_jax(name):
    """RawMCTSPlayer (one whole raw search a move) against JAX's over a
    game's worth of positions, JAX's draws injected: the actions, the
    deepest walks and the root values (exact: zero values)."""
    jenv = j_get_env(name)
    args = dict(numMCTSSims=20, startTemp=1.0)
    jp = JP.RawMCTSPlayer(jenv, j_get_args(**args), seed=4)
    p = P.RawMCTSPlayer(get_env(name), get_args(**args), seed=4,
                        device="cpu")
    for state, js in states(name, 4, seed=8, max_plies=4):
        _, sub = jax.random.split(jp._key)
        draws = _batched_search_draws(
            sub, jenv, jax.tree_util.tree_map(lambda x: x[None], js), 20)
        assert p.play(state, draws=draws) == jp.play(js)
        assert (p.last_depth, p.last_value) == (jp.last_depth,
                                                jp.last_value)


@pytest.mark.parametrize("name", ["connect4", "tictactoe", "nim3"])
def test_random_player_matches_jax(name):
    """RandomPlayer: the same choices from the same seed over a whole
    game."""
    env, jenv = get_env(name), j_get_env(name)
    p, jp = P.RandomPlayer(env, seed=6), JP.RandomPlayer(jenv, seed=6)
    s, js = env.init(1, "cpu"), jenv.init()
    while not bool(env.terminated(s)[0]):
        a = p.play(s)
        assert a == jp.play(js)
        s = env.step(s, torch.tensor([a], dtype=torch.int32))
        js = jenv.step(js, a)


@pytest.mark.parametrize("temp", [1.0, 0.0])
def test_nn_player_matches_jax(temp):
    """NNPlayer over a converted ResNet, sampling at temperature 1 and
    taking the argmax at 0: the same actions from the same seed."""
    shim, net = nets("connect4")
    jnet = types.SimpleNamespace(
        predict=lambda obs: tuple(np.asarray(x[0]) for x in
                                  shim.process(jnp.asarray(obs)[None])),
        env=shim.env, args=shim.args)
    jp = JP.NNPlayer(jnet, temp=temp, seed=9)
    p = P.NNPlayer(net, temp=temp, seed=9)
    for state, js in states("connect4", 6, seed=12, max_plies=10):
        assert p.play(state) == jp.play(js)


@pytest.mark.parametrize("name,plies", [("connect4", 14), ("tictactoe", 4),
                                        ("othello", 20)])
def test_one_step_lookahead_matches_jax(name, plies):
    """OneStepLookaheadPlayer, every valid action (and every reply) stepped
    as one batch, against the JAX player's loop: the same actions from the
    same seed, from positions with wins and threats to find."""
    env, jenv = get_env(name), j_get_env(name)
    p = P.OneStepLookaheadPlayer(env, seed=1)
    jp = JP.OneStepLookaheadPlayer(jenv, seed=1)
    for state, js in states(name, 8, seed=13, max_plies=plies):
        assert p.play(state) == jp.play(js)


@pytest.mark.parametrize("name,plies", [("connect4", 10), ("othello", 12),
                                        ("tictactoe", 3)])
def test_greedy_value_player_matches_jax(name, plies):
    """GreedyValuePlayer (one ply on the crude value, the first best
    kept): the same actions."""
    env, jenv = get_env(name), j_get_env(name)
    p, jp = P.GreedyValuePlayer(env), JP.GreedyValuePlayer(jenv)
    for state, js in states(name, 5, seed=14, max_plies=plies):
        assert p.play(state) == jp.play(js)


def test_human_console_player(monkeypatch, capsys):
    """The human player prints the board and asks until it gets a valid
    action, as the JAX player does."""
    env = get_env("connect4")
    s = env.init(1, "cpu")
    for m in [0] * 6:
        s = env.step(s, torch.tensor([m], dtype=torch.int32))
    answers = iter(["x", "0", "9", "3"])
    monkeypatch.setattr("builtins.input", lambda prompt: next(answers))
    assert P.HumanConsolePlayer(env).play(s) == 3
    out = capsys.readouterr().out
    assert "not a number" in out and out.count("invalid move") == 2
    assert env.display(s) in out


def test_players_take_one_game_on_their_device():
    """A player takes a batch of one game and moves it to its device; a
    larger batch raises."""
    env = get_env("tictactoe")
    with pytest.raises(ValueError, match="batch of 2"):
        P.RandomPlayer(env).play(env.init(2, "cpu"))
    p = P.RawMCTSPlayer(env, get_args(numMCTSSims=4), device="cpu")
    assert 0 <= p.play(env.init(1, "cpu")) < 9
    assert p.last_tree.parent.device.type == "cpu"
