"""Parity of the PyTorch port's tictactoe, nim3, othello, gobang and stacked
envs with the JAX envs on the CPU, and the rule fixtures of
tests/test_envs.py:169-197, tests/test_nim.py:26-51,
tests/test_envs_othello_gobang.py and tests/test_stacked.py:15-83 through
the port.

``rollout`` (shared with tests/test_torch_chess.py and
tests/test_torch_stratego.py) plays seeded random legal moves until every
game has ended and compares, at every ply, every state field, the valid
moves, the win vector (and the fused ``win_and_valids``), the
observation, the symmetries of obs and a random pi, and the crude value,
against the JAX env jitted and vmapped. All of it must be equal, with one
stated exception: othello's crude value ``0.5 + 0.5 * tanh(diff / 16)``
within 2.4e-7 (two float32 ulps at 1), since XLA's tanh is its own
rational approximation and torch's is the C library's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_general_tpu.envs import get_env as j_get_env
from alphazero_general_tpu.envs.stacked import (
    make_stacked_env as j_make_stacked, maybe_stack as j_maybe_stack)
from alphazero_general_tpu.utils.config import get_args as j_get_args
from alphazero_general_tpu_torch.envs import get_env, list_envs
from alphazero_general_tpu_torch.envs.core import state_items
from alphazero_general_tpu_torch.envs.stacked import (
    make_stacked_env, maybe_stack)
from alphazero_general_tpu_torch.utils import get_args

torch.set_num_threads(1)

#: Crude-value tolerance per env (module docstring); 0 means equal.
CRUDE_ATOL = {"othello": 2.4e-7}

_JAX_FNS = {}


def jax_fns(jenv):
    """The JAX env's functions, jitted and vmapped (once per env class)."""
    if jenv not in _JAX_FNS:
        def leaf(s):
            out = dict(valid=jenv.valid_moves(s), win=jenv.win_state(s),
                       obs=jenv.observation(s))
            try:
                out["crude"] = jenv.crude_value(s)
            except NotImplementedError:
                pass
            return out

        _JAX_FNS[jenv] = dict(step=jax.jit(jax.vmap(jenv.step)),
                              leaf=jax.jit(jax.vmap(leaf)),
                              sym=jax.jit(jax.vmap(jenv.symmetries)))
    return _JAX_FNS[jenv]


def _jax_value(name, x):
    """A port field as the JAX env holds it (chess hashes are uint32)."""
    x = np.asarray(x)
    return x.view(np.uint32) if name == "hist" else x


def to_jax(jenv, items):
    """The JAX state of the port's state fields ``items`` (numpy)."""
    base = getattr(jenv, "BASE", None)
    if base is None:
        return jenv.State(**{k: jnp.asarray(_jax_value(k, v))
                             for k, v in items.items()})
    names = [f.name for f in dataclasses.fields(base.State)]
    inner = base.State(**{k: jnp.asarray(_jax_value(k, items[k]))
                          for k in names})
    return jenv.State(inner=inner, past_obs=jnp.asarray(items["past_obs"]),
                      player=inner.player, turns=inner.turns,
                      last_action=inner.last_action)


def jax_items(jenv, js, names):
    """The JAX state's fields under the port's (flat) names, numpy."""
    base = getattr(jenv, "BASE", None)
    out = {}
    for k in names:
        src = js if base is None or k == "past_obs" else js.inner
        out[k] = np.asarray(getattr(src, k))
    return out


def to_torch(env, items):
    return env.State(**{k: torch.from_numpy(np.array(v))
                        for k, v in items.items()})


def port_items(state):
    """Numpy fields of a port state, chess hashes viewed as uint32."""
    return {k: _jax_value(k, v.numpy()) for k, v in state_items(state).items()}


def assert_same(env, jenv, ts, js, rng, with_sym=True):
    """Every function of both envs equal on the batch; returns (valid,
    win) as numpy."""
    t = port_items(ts)
    j = jax_items(jenv, js, t)
    for k in t:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    want = jax_fns(jenv)["leaf"](js)
    valid = env.valid_moves(ts).numpy()
    win = env.win_state(ts).numpy()
    np.testing.assert_array_equal(valid, np.asarray(want["valid"]))
    np.testing.assert_array_equal(win, np.asarray(want["win"]))
    w2, v2 = env.win_and_valids(ts)
    np.testing.assert_array_equal(w2.numpy(), win)
    np.testing.assert_array_equal(v2.numpy(), valid)
    obs = env.observation(ts)
    assert obs.shape[1:] == env.OBS_SHAPE
    np.testing.assert_array_equal(obs.numpy(), np.asarray(want["obs"]))
    if "crude" in want:
        atol = CRUDE_ATOL.get(getattr(env, "BASE", env).NAME, 0.0)
        np.testing.assert_allclose(env.crude_value(ts).numpy(),
                                   np.asarray(want["crude"]), rtol=0,
                                   atol=atol)
    if with_sym:
        pi = rng.random((valid.shape[0], env.ACTION_SIZE)).astype(np.float32)
        t_o, t_p = env.symmetries(obs, torch.from_numpy(pi))
        j_o, j_p = jax_fns(jenv)["sym"](jnp.asarray(obs.numpy()),
                                        jnp.asarray(pi))
        assert t_o.shape[1] == t_p.shape[1] == env.NUM_SYMMETRIES
        np.testing.assert_array_equal(t_o.numpy(), np.asarray(j_o))
        np.testing.assert_array_equal(t_p.numpy(), np.asarray(j_p))
    return valid, win


def rollout(env, jenv, items, seed, max_plies=None, sym_every=1):
    """Random legal moves from the states ``items`` (numpy fields) until
    every game has ended (or for ``max_plies``), both envs compared at
    every ply; finished games stay frozen. Returns the set of outcomes
    (the argmax of each final win vector) and the plies played."""
    rng = np.random.default_rng(seed)
    ts, js = to_torch(env, items), to_jax(jenv, items)
    B = len(items["player"])
    ended = np.zeros(B, bool)
    outcomes = set()
    limit = env.MAX_TURNS + 1 if max_plies is None else max_plies
    for ply in range(limit):
        valid, win = assert_same(env, jenv, ts, js, rng,
                                 with_sym=ply % sym_every == 0)
        done = (win > 0).any(axis=1)
        outcomes |= {int(w.argmax()) for w in win[done & ~ended]}
        ended |= done
        active = ~done
        if not active.any():
            return outcomes, ply
        action = np.array([rng.choice(np.flatnonzero(v)) if a else 0
                           for v, a in zip(valid, active)], np.int32)
        t_raw = {k: v.numpy() for k, v in state_items(
            env.step(ts, torch.from_numpy(action))).items()}
        t_new = {k: _jax_value(k, v) for k, v in t_raw.items()}
        j_new = jax_items(jenv, jax_fns(jenv)["step"](
            js, jnp.asarray(action)), t_new)
        for k in t_new:  # stepped states equal, finished games included
            np.testing.assert_array_equal(t_new[k], j_new[k], err_msg=k)
        old = {k: v.numpy() for k, v in state_items(ts).items()}
        keep = {k: np.where(active.reshape((-1,) + (1,) * (old[k].ndim - 1)),
                            t_raw[k], old[k]) for k in t_raw}
        ts, js = to_torch(env, keep), to_jax(jenv, keep)
    assert max_plies is not None, "rollouts did not end within MAX_TURNS"
    return outcomes, limit


def init_items(env, batch):
    return {k: v.numpy() for k, v in state_items(env.init(batch, "cpu"))
            .items()}


@pytest.mark.parametrize("name,batch", [("tictactoe", 32), ("nim3", 32),
                                        ("othello", 8), ("gobang", 6)])
def test_rollouts_match_jax(name, batch):
    env, jenv = get_env(name), j_get_env(name)
    assert env.ALTERNATES and env.NUM_PLAYERS == jenv.NUM_PLAYERS
    assert (env.ACTION_SIZE, env.OBS_SHAPE, env.MAX_TURNS, env.HAS_DRAW,
            env.NUM_SYMMETRIES) == (jenv.ACTION_SIZE, jenv.OBS_SHAPE,
                                    jenv.MAX_TURNS, jenv.HAS_DRAW,
                                    jenv.NUM_SYMMETRIES)
    outcomes, _ = rollout(env, jenv, init_items(env, batch), seed=1,
                          sym_every=4)
    if name == "nim3":
        assert outcomes == {0, 1, 2}  # every seat wins somewhere, no draw
    else:
        assert outcomes & {0, 1}


@pytest.mark.parametrize("name,k,batch", [("othello", 4, 6),
                                          ("connect4", 3, 16)])
def test_stacked_rollouts_match_jax(name, k, batch):
    env = make_stacked_env(get_env(name), k)
    jenv = j_make_stacked(j_get_env(name), k)
    assert env.NAME == jenv.NAME and env.OBS_SHAPE == jenv.OBS_SHAPE
    names = [f.name for f in dataclasses.fields(env.State)]
    assert names[-1] == "past_obs" and "inner" not in names
    rollout(env, jenv, init_items(env, batch), seed=2, sym_every=3)


# --- rule fixtures through the port -------------------------------------

def play(env, moves):
    s = env.init(1, "cpu")
    for m in moves:
        s = env.step(s, torch.tensor([m]))
    return s


def win_of(env, s):
    return env.win_state(s)[0].tolist()


def test_tictactoe_fixtures():
    env = get_env("tictactoe")
    assert win_of(env, play(env, [0, 3, 1, 4, 2])) == [1, 0, 0]
    assert win_of(env, play(env, [0, 1, 2, 4, 3, 5, 7, 6, 8])) == [0, 0, 1]
    assert win_of(env, play(env, [1, 0, 2, 4, 5, 8])) == [0, 1, 0]
    s = play(env, [0, 1])
    obs_k, pi_k = env.symmetries(env.observation(s),
                                 torch.arange(9, dtype=torch.float32)[None])
    assert obs_k.shape == (1, 8, 1, 3, 3) and pi_k.shape == (1, 8, 9)
    assert len({o.numpy().tobytes() for o in obs_k[0]}) == 8


def test_nim_fixtures():
    env = get_env("nim3")
    s = env.init(1, "cpu")
    assert int(s.pile) == 15 and int(s.player) == 0
    s = env.step(s, torch.tensor([2]))
    assert int(s.pile) == 12 and int(s.player) == 1
    assert not (env.win_state(s) > 0).any()
    s = env.init(1, "cpu")
    for _ in range(6):
        s = env.step(s, torch.tensor([1]))
    assert int(s.pile) == 3
    s = env.step(s, torch.tensor([1]))
    assert env.valid_moves(s)[0].tolist() == [True, False, False]
    s = env.init(1, "cpu")
    for _ in range(5):
        s = env.step(s, torch.tensor([2]))
    assert win_of(env, s) == [0.0, 1.0, 0.0, 0.0]
    assert "nim3" in list_envs() and get_env("nim3") is env


def test_othello_fixtures():
    env = get_env("othello")
    s = env.init(1, "cpu")
    b = s.board[0].numpy()
    assert b[3, 4] == 1 and b[4, 3] == 1 and b[3, 3] == -1 and b[4, 4] == -1
    valid = env.valid_moves(s)[0].reshape(8, 8).numpy()
    assert {(r, c) for r, c in zip(*np.nonzero(valid))} == {
        (2, 3), (3, 2), (4, 5), (5, 4)}
    b = env.step(s, torch.tensor([2 * 8 + 3])).board[0].numpy()
    assert b[2, 3] == 1 and b[3, 3] == 1
    assert (b == 1).sum() == 4 and (b == -1).sum() == 1
    assert not (env.win_state(s) > 0).any()
    board = np.zeros((1, 8, 8), np.int8)
    board[0, 0, :4] = 1  # only +1 pieces: -1, to move, has no move
    s.board = torch.from_numpy(board)
    s.player = torch.tensor([1], dtype=torch.int32)
    assert win_of(env, s) == [1, 0, 0]


def test_gobang_fixtures():
    env = get_env("gobang")
    moves = []
    for i in range(4):
        moves += [i, 15 * 14 + i]
    assert not (env.win_state(play(env, moves)) > 0).any()
    assert win_of(env, play(env, moves + [4])) == [1, 0, 0]
    moves = []
    for i in range(4):
        moves += [15 * 7 + i, i * 15 + i]
    assert win_of(env, play(env, moves + [15 * 7 + 10, 4 * 15 + 4])) == [
        0, 1, 0]
    s = play(env, [0, 224])
    obs = env.observation(s)[0].numpy()
    assert obs.shape == (4, 15, 15) and obs[0, 0, 0] == 1
    assert obs[1, 14, 14] == 1
    obs_k, pi_k = env.symmetries(env.observation(s), torch.arange(
        225, dtype=torch.float32)[None])
    assert obs_k.shape == (1, 8, 4, 15, 15) and pi_k.shape == (1, 8, 225)


def test_stacked_fixtures():
    c4 = get_env("connect4")
    env = make_stacked_env(c4, 3)
    assert env.OBS_SHAPE == (12, 6, 7)
    s0 = env.init(1, "cpu")
    assert (env.observation(s0)[0, 4:] == 0).all()
    s1 = env.step(s0, torch.tensor([3]))
    s2 = env.step(s1, torch.tensor([4]))
    obs2 = env.observation(s2)[0]
    assert torch.equal(obs2[4:8], c4.observation(env.inner(s1))[0])
    assert torch.equal(obs2[8:12], c4.observation(env.inner(s0))[0])
    s = env.init(1, "cpu")
    for m in [2, 0, 3, 0, 4, 0, 5]:
        s = env.step(s, torch.tensor([m]))
    assert win_of(env, s) == [1, 0, 0] and int(s.turns) == 7
    s = env.step(env.init(1, "cpu"), torch.tensor([1]))
    obs = env.observation(s)
    obs_k, pi_k = env.symmetries(obs, torch.arange(
        7, dtype=torch.float32)[None])
    assert obs_k.shape == (1, 2, 12, 6, 7)
    assert torch.equal(obs_k[0, 1], obs[0].flip(-1))
    assert pi_k[0, 1].tolist() == list(range(7))[::-1]
    states = env.step(env.init(8, "cpu"), torch.arange(8) % 7)
    assert states.past_obs.shape == (8, 2, 4, 6, 7)


def test_maybe_stack_matches_jax():
    c4, jc4 = get_env("connect4"), j_get_env("connect4")
    assert maybe_stack(c4, get_args()) is c4
    assert j_maybe_stack(jc4, j_get_args()) is jc4
    for k in (2, 4):
        got = maybe_stack(c4, get_args(num_stacked_observations=k))
        want = j_maybe_stack(jc4, j_get_args(num_stacked_observations=k))
        assert (got.NAME, got.OBS_SHAPE, got.STACK) == (
            want.NAME, want.OBS_SHAPE, want.STACK)


# --- searches and move runners against JAX's (shared with the chess, ------
# --- stratego and nim tests) -----------------------------------------------

def table_eval_fns(env, seed=0, rows=509):
    """(jax_eval_fn, torch_eval_fn) over one shared float32 table of policy
    and value rows, indexed by an integer hash of the observation's
    positive cells, so that both searches get bit-identical priors."""
    rng = np.random.default_rng(seed)
    A, cells = env.ACTION_SIZE, int(np.prod(env.OBS_SHAPE))
    V = env.NUM_PLAYERS + int(env.HAS_DRAW)
    pi_tab = rng.dirichlet(np.ones(A), rows).astype(np.float32)
    v_tab = rng.dirichlet(np.ones(V), rows).astype(np.float32)
    w = rng.integers(1, rows, size=(cells,)).astype(np.int32)

    def j_eval(obs):
        on = (obs > 0.5).reshape(obs.shape[0], cells)
        h = jnp.sum(on.astype(jnp.int32) * jnp.asarray(w), axis=1) % rows
        return jnp.asarray(pi_tab)[h], jnp.asarray(v_tab)[h]

    def t_eval(obs):
        on = (obs > 0.5).reshape(obs.shape[0], cells)
        h = (on.to(torch.int32) * torch.from_numpy(w)).sum(dim=1) % rows
        return (torch.from_numpy(pi_tab)[h.long()],
                torch.from_numpy(v_tab)[h.long()])

    return j_eval, t_eval


def random_items(env, batch, seed, max_plies):
    """Numpy state fields of games advanced by random legal moves, never
    into a finished position."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(batch):
        s = env.init(1, device="cpu")
        for _ in range(int(rng.integers(0, max_plies + 1))):
            valid = np.flatnonzero(env.valid_moves(s)[0].numpy())
            nxt = env.step(s, torch.tensor([rng.choice(valid)]))
            if env.terminated(nxt)[0]:
                break
            s = nxt
        rows.append({k: v[0].numpy() for k, v in state_items(s).items()})
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def assert_search_matches_jax(name, batch, sims, items, walk_impls=("xla",),
                              **kw):
    """A fresh-tree search of the port (plain versions, the CPU) against
    the JAX search of each walk in ``walk_impls``, one table evaluation:
    visit counts and tree links equal; q, v and the prior rows within
    1e-6."""
    import alphazero_general_tpu.mcts.search as JS
    import alphazero_general_tpu.mcts.tree as JT
    from alphazero_general_tpu_torch.mcts import search as S
    from alphazero_general_tpu_torch.mcts import tree as T
    from alphazero_general_tpu_torch.mcts import tree_t as TT

    env, jenv = get_env(name), j_get_env(name)
    V = env.NUM_PLAYERS + int(env.HAS_DRAW)
    kw = dict(tie_noise=0.0, add_root_noise=False, num_players=env.NUM_PLAYERS,
              has_draw=env.HAS_DRAW, **kw)
    j_eval, t_eval = table_eval_fns(env)
    tt = TT.init_tree_t(env, to_torch(env, items), sims + 2, V)
    S.search(env, tt, T.SearchSpec(**kw), t_eval, sims)
    for walk in walk_impls:
        jt = JS.init_batched_trees(jenv, to_jax(jenv, items), sims + 2, V)
        jt = JS.search(jenv, jt, JT.SearchSpec(**kw), j_eval, sims,
                       jax.random.PRNGKey(0), walk_impl=walk)
        for f in ("n", "parent", "parent_action"):  # sink row excluded
            np.testing.assert_array_equal(
                getattr(tt, f).T.numpy()[:, :-1],
                np.asarray(getattr(jt, f))[:, :-1], err_msg=f"{walk} {f}")
        for f in ("q", "v"):
            np.testing.assert_allclose(
                getattr(tt, f).T.numpy()[:, :-1],
                np.asarray(getattr(jt, f))[:, :-1], rtol=1e-6, atol=1e-6,
                err_msg=f"{walk} {f}")
        np.testing.assert_array_equal(T.counts(tt).numpy(),
                                      np.asarray(jax.vmap(JT.counts)(jt)))
    assert (tt.n[0] == sims).all() and int(tt.max_depth.max()) >= 2
    return tt


def assert_move_runners_match_jax(name, batch, sims=(4, 3, 6), seed=4,
                                  kinds=("warmup", "full", "fast", "full")):
    """The moves ``kinds`` (warmup, full or fast) through a converted small
    ResNet in float32 with JAX's draws injected (root noise and tie noise
    on):
    actions, win states, states and obs equal; the policy records equal
    once densified (sparse top-(sims + 1) records where A >= 512)."""
    import alphazero_general_tpu.selfplay.selfplay as JSP
    from alphazero_general_tpu_torch.selfplay import selfplay as SP
    from test_torch_arena import move_draws
    from test_torch_model import jax_and_port

    env, jenv = get_env(name), j_get_env(name)
    jnet, variables, net = jax_and_port("float32", seed=seed, env_name=name)
    warm, fast, full = sims
    knobs = dict(numMCTSSims=full, numFastSims=fast, numWarmupSims=warm)
    P, D = env.NUM_PLAYERS, env.HAS_DRAW
    cfg = SP.SelfPlayConfig.from_args(get_args(**knobs), P, D)
    j_cfg = JSP.SelfPlayConfig.from_args(j_get_args(**knobs), P,
                                         D)._replace(walk_impl="xla")
    j_fns = JSP.make_move_fns(
        jenv, j_cfg, lambda v, obs: jnet.model.apply(v, obs, train=False))
    fns = SP.make_move_fns(env, cfg, net.model)
    j_carry = JSP.init_selfplay(jenv, batch, 1.0)
    carry = SP.init_selfplay(env, batch, device="cpu")
    n_sims = {"warmup": warm, "fast": fast, "full": full}
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    sparse = env.ACTION_SIZE >= SP.SPARSE_PI_MIN_ACTIONS
    for k, kind in enumerate(kinds):
        rng = jax.random.PRNGKey(300 + k)
        j_carry, j_rec = j_fns[kind](variables, j_carry, rng)
        _, r_search, r_action, _ = jax.random.split(rng, 4)
        d = move_draws(r_search, r_action,
                       env.valid_moves(carry.env_state), n_sims[kind], True)
        carry, rec = fns[kind](carry, gumbel=d.gumbel, search_draws=d.search)
        np.testing.assert_array_equal(rec.action.numpy(),
                                      np.asarray(j_rec.action))
        np.testing.assert_array_equal(rec.win_state.numpy(),
                                      np.asarray(j_rec.win_state))
        assert (rec.root_visits == n_sims[kind]).all()
        if kind == "fast":
            assert rec.obs is None and rec.pi is None
            continue
        np.testing.assert_array_equal(rec.obs.numpy(), np.asarray(j_rec.obs))
        if sparse:
            assert rec.pi.shape == rec.pi_idx.shape == (
                batch, n_sims[kind] + 1)
            got = SP.densify_pi(rec.pi.numpy(), rec.pi_idx.numpy(),
                                env.ACTION_SIZE)
            want = SP.densify_pi(np.asarray(j_rec.pi),
                                 np.asarray(j_rec.pi_idx), env.ACTION_SIZE)
        else:
            got, want = rec.pi.numpy(), np.asarray(j_rec.pi)
        np.testing.assert_array_equal(got, want)
        assert np.allclose(got.astype(np.float32).sum(-1), 1.0, atol=2**-11)
    t = port_items(carry.env_state)
    j = jax_items(jenv, j_carry.env_state, t)
    for f in t:
        np.testing.assert_array_equal(t[f], j[f], err_msg=f)


def test_registry_and_presets_match_jax():
    from alphazero_general_tpu.envs import list_envs as j_list_envs
    from alphazero_general_tpu.envs.presets import PRESETS as J_PRESETS
    from alphazero_general_tpu_torch.envs.presets import PRESETS

    assert list_envs() == j_list_envs() and len(list_envs()) == 9
    assert PRESETS == J_PRESETS and "nim3" not in PRESETS
    for name in list_envs():
        env, jenv = get_env(name), j_get_env(name)
        assert (env.NAME, env.NUM_PLAYERS, env.ACTION_SIZE, env.OBS_SHAPE,
                env.MAX_TURNS, env.HAS_DRAW, env.NUM_SYMMETRIES,
                env.ALTERNATES) == (
            jenv.NAME, jenv.NUM_PLAYERS, jenv.ACTION_SIZE, jenv.OBS_SHAPE,
            jenv.MAX_TURNS, jenv.HAS_DRAW, jenv.NUM_SYMMETRIES,
            jenv.ALTERNATES), name


#: One tiny CPU iteration of ``cli.train`` (a warmup iteration and both
#: arenas). nim3 runs without arenas: a two-model arena of a three-player
#: env raises, in the JAX package too.
CLI_TINY = dict(numIters=1, process_batch_size=4, gamesPerIteration=4,
                numMCTSSims=3, numFastSims=2, numWarmupSims=2,
                train_batch_size=16, arenaCompare=4, arenaCompareBaseline=4,
                num_channels=8, depth=1, value_head_channels=2,
                policy_head_channels=2, value_dense_layers=[8],
                policy_dense_layers=[8], deviceWindowRows=16384)


@pytest.mark.parametrize("name", ["tictactoe", "nim3", "othello", "gobang",
                                  "stratego", "chess", "othello_x2"])
def test_cli_train_runs_each_env(name, tmp_path):
    """``python -m alphazero_general_tpu_torch.cli.train <env> --device
    cpu`` with tiny ``--set`` overrides: checkpoints, samples of the env's
    shapes and metrics (``othello_x2``: othello with
    ``num_stacked_observations=2``)."""
    from alphazero_general_tpu_torch.cli import train as cli_train
    from alphazero_general_tpu_torch.selfplay.replay import ReplayStore

    env_name = name.split("_x")[0]
    sets = dict(CLI_TINY, run_name="cli", checkpoint=str(tmp_path / "ckpt"),
                data=str(tmp_path / "data"), log_dir=str(tmp_path / "runs"))
    if name in ("nim3", "chess", "stratego"):
        # nim3: see CLI_TINY; chess and stratego: their arenas (up to 512
        # rounds) would take most of the test's time on the CPU
        sets.update(arenaCompare=0, arenaCompareBaseline=0,
                    compareWithBaseline=False, compareWithPast=False)
    if name.endswith("_x2"):
        sets["num_stacked_observations"] = 2
    argv = [env_name, "--device", "cpu"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v!r}"]
    assert cli_train.main(argv) == 0
    assert (tmp_path / "ckpt" / "cli" / "iteration-0001.ckpt").is_file()
    obs, pi, value = ReplayStore(str(tmp_path / "data"), "cli").load(1)
    env = maybe_stack(get_env(env_name),
                      get_args(num_stacked_observations=sets.get(
                          "num_stacked_observations", 1)))
    assert len(obs) > 0 and obs.shape[1:] == env.OBS_SHAPE
    assert pi.shape[1] == env.ACTION_SIZE
    assert value.shape[1] == env.NUM_PLAYERS + 1


@pytest.mark.parametrize("name", ["tictactoe", "nim3", "othello", "gobang",
                                  "stratego", "chess"])
def test_converted_resnet_matches_jax(name):
    """utils/convert.py carries the JAX ResNet of every new env's shapes
    (chess's policy dense [.., 1024] → 4672, stratego's → 1280, nim3's
    1 x 16 board) with no change: the eval forward of the converted
    weights within the float32 tolerance of tests/test_torch_model.py
    (rtol 1e-4, atol 1e-5)."""
    from test_torch_model import jax_and_port

    jnet, variables, net = jax_and_port("float32", seed=1, env_name=name)
    items = random_items(get_env(name), 8, seed=4, max_plies=4)
    obs = get_env(name).observation(to_torch(get_env(name), items))
    j_logp, j_logv = jnet.model.apply(variables, jnp.asarray(obs.numpy()),
                                      train=False)
    with torch.no_grad():
        t_logp, t_logv = net.model(obs)
    np.testing.assert_allclose(t_logp.numpy(), np.asarray(j_logp),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_logv.numpy(), np.asarray(j_logv),
                               rtol=1e-4, atol=1e-5)
