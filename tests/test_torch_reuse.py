"""Self-play with tree reuse: the port's batch-major Tree, its general walk
writes, ``reroot``, the batch-major descend and backup, the search on
carried trees and whole reuse moves, each against the JAX package on the
CPU, and the self-play config's knobs against the JAX config.

Both sides are driven by the same table evaluation
(test_torch_search.table_eval_fns) and, where a step draws random numbers,
by JAX's own draws recomputed from its keys and passed to the port.
Integers and tree links must be equal; floats agree within 1e-6 (the
prior within rtol 1e-6, atol 1e-7, as test_torch_search.py states).
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
from alphazero_general_tpu.envs.connect4 import Connect4 as JConnect4
from alphazero_general_tpu.ops.backup import backup_batched as j_backup
from alphazero_general_tpu.ops.descend import descend_batched as j_descend
from alphazero_general_tpu.utils.config import get_args as j_get_args
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.mcts import search as S
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts import tree_t as TT
from alphazero_general_tpu_torch.ops import backup as OB
from alphazero_general_tpu_torch.ops import descend as OD
from alphazero_general_tpu_torch.selfplay import selfplay as SP
from alphazero_general_tpu_torch.utils import get_args
from test_torch_search import (random_positions, table_eval_fns,
                               to_jax_states, to_torch_states)

A, V = 7, 3
B = 16
SIMS = 12
CAPACITY = 2 * SIMS + 2  # a reuse tree's rows: N = 27 with the sink
SPEC_KW = dict(tie_noise=0.0, add_root_noise=False)
STATE_FIELDS = ("player", "turns", "last_action", "board")
ENV = get_env("connect4")


def port_tree(jt) -> T.Tree:
    """A batched JAX Tree as the port's batch-major Tree: the flat row
    arrays unflattened, the packed expanded bits unpacked."""
    Bj, N = np.asarray(jt.n).shape
    template = JConnect4.init()

    def t(x, *shape):
        return torch.from_numpy(np.array(x).reshape((Bj, N) + shape))

    words = np.asarray(jt.expanded).reshape(Bj, N, -1)
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return T.Tree(
        node_state={k: t(getattr(jt.node_state, k), -1)
                    for k in STATE_FIELDS},
        state_shapes={k: tuple(np.shape(getattr(template, k)))
                      for k in STATE_FIELDS},
        parent=t(jt.parent), parent_action=t(jt.parent_action),
        valids=t(jt.valids, A), prior=t(jt.prior, A), n=t(jt.n),
        q=t(jt.q), v=t(jt.v), e=t(jt.e, V), player=t(jt.player),
        edge_prior=t(jt.edge_prior),
        expanded=torch.from_numpy(bits.reshape(Bj, N, -1)[..., :A] > 0),
        nba=t(jt.nba), nbp=t(jt.nbp),
        **{k: torch.from_numpy(np.array(getattr(jt, k)))
           for k in ("next_free", "depth", "max_depth", "leaf")},
        num_actions=A, value_size=V)


def _arrays(tree: T.Tree) -> dict:
    out = {k: getattr(tree, k).numpy() for k in T.TREE_TENSORS}
    out.update({f"node_state.{k}": x.numpy()
                for k, x in tree.node_state.items()})
    return out


def assert_trees_equal(got: T.Tree, want: T.Tree, rows, float_tol=0.0):
    """Every field of two batch-major trees equal on the rows r < rows[b]
    of each game b, and every per-game scalar equal; floats within
    ``float_tol`` (rtol and atol) where it is set."""
    g, w = _arrays(got), _arrays(want)
    N = got.parent.shape[1]
    mask = np.arange(N)[None, :] < np.asarray(rows)[:, None]
    for name, a in g.items():
        b = w[name]
        assert a.shape == b.shape, name
        if a.ndim >= 2:
            a, b = a[mask], b[mask]
        if float_tol and a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=float_tol, atol=float_tol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _j_search(spec, fresh: bool):
    j_eval, _ = table_eval_fns()

    @functools.partial(jax.jit, static_argnames=("sims",))
    def run(trees, rng, sims):
        return JS.search(JConnect4, trees, spec, j_eval, sims, rng,
                         walk_impl="pallas_interpret", fresh_tree=fresh)

    return run


@pytest.fixture(scope="module")
def searched():
    """JAX trees (capacity 2 * SIMS + 2) after a search of SIMS simulations
    from random positions, through the general path and the interpreted
    Pallas kernels."""
    pos = random_positions(B, seed=31, max_plies=12)
    spec = JT.SearchSpec(**SPEC_KW)
    trees = JS.init_batched_trees(JConnect4, to_jax_states(pos), CAPACITY, V)
    return _j_search(spec, fresh=False)(trees, jax.random.PRNGKey(0),
                                        sims=SIMS)


def _j_reroot(trees, action):
    return jax.vmap(lambda t, a: JT.reroot(JConnect4, t, a))(
        trees, jnp.asarray(action, jnp.int32))


def _actions(jt, kind: str) -> np.ndarray:
    """Per game, the most visited root action ("expanded"), or a valid root
    action never expanded where there is one ("never")."""
    counts = np.asarray(jax.vmap(JT.counts)(jt))
    if kind == "expanded":
        return counts.argmax(-1).astype(np.int32)
    valid = np.asarray(jt.valids).reshape(B, -1, A)[:, 0]
    score = np.where(valid & (counts == 0), 1, 0) * 10 - counts
    return score.argmax(-1).astype(np.int32)


def _mixed_actions(jt) -> np.ndarray:
    """Even games keep their most visited subtree, odd games step along an
    edge never expanded (a fresh tree)."""
    return np.where(np.arange(B) % 2 == 0, _actions(jt, "expanded"),
                    _actions(jt, "never")).astype(np.int32)


@pytest.fixture(scope="module")
def carried(searched):
    """The searched trees re-rooted at a mix of expanded and never-expanded
    root edges: carried subtrees with allocation fronts that differ across
    games, and fresh trees."""
    return _j_reroot(searched, _mixed_actions(searched))


@pytest.mark.parametrize("kind", ["expanded", "never"])
def test_reroot_matches_jax(searched, kind):
    """Every field equal on each game's rows below ``next_free``. The sink
    row N-1 lies above every ``next_free`` and is excluded: it holds the
    junk of masked writes (games that allocated nothing that simulation),
    which no walk reads. The rows between are pristine on both sides."""
    action = _actions(searched, kind)
    want = port_tree(_j_reroot(searched, action))
    before = port_tree(searched)
    got = T.reroot(ENV, before, torch.from_numpy(action))
    np.testing.assert_array_equal(got.next_free.numpy(),
                                  want.next_free.numpy())
    assert_trees_equal(got, want, got.next_free.numpy())
    N = got.parent.shape[1]
    free = torch.arange(N)[None, :] >= got.next_free[:, None].long()
    free[:, -1] = False
    assert (got.parent[free] == -1).all() and (got.n[free] == 0).all()
    assert (got.nbp[free] == T.NBP_PRISTINE).all()
    fresh = got.next_free == 1
    if kind == "expanded":
        # The kept subtree carries the visits of the child it was rooted at.
        child = T.child_row(*T._game_minor_links(before),
                            torch.zeros(B, dtype=torch.int32), A)[0]
        old_n = before.n[torch.arange(B), child[torch.arange(B),
                                                torch.from_numpy(action)]]
        np.testing.assert_array_equal(got.n[:, 0].numpy(), old_n.numpy())
        assert (got.next_free > 1).sum() >= B // 2
    else:
        assert fresh.sum() >= B // 2 and (got.n[fresh, 0] == 0).all()


def _install_draws(keys, valids):
    """The Gamma and uniform draws JAX's install_prior makes from each
    game's key (key → (noise key, tie key))."""
    split = jax.vmap(jax.random.split)(keys)
    alpha = (np.float32(JT.NOISE_ALPHA_RATIO)
             / np.maximum(valids.sum(-1), 1).astype(np.float32))
    gammas = np.stack([np.asarray(jax.random.gamma(split[b, 0], alpha[b],
                                                   (A,)))
                       for b in range(valids.shape[0])])
    tie = np.array(jax.vmap(lambda k: jax.random.uniform(k, (A,)))(
        split[:, 1]))
    return torch.from_numpy(gammas), torch.from_numpy(tie)


def test_general_apply_walk_and_install_prior_match_jax(carried):
    """One simulation's writes on carried trees, each game at its own
    allocation front: the walk, the leaf's allocation and expansion, its
    observation and resolved value, and the prior install with root
    temperature, Dirichlet noise and tie noise (JAX's draws injected)."""
    spec_kw = dict(tie_noise=1e-6)
    j_eval, t_eval = table_eval_fns()
    jspec = JT.SearchSpec(**spec_kw)
    walk = j_descend(carried, jspec, interpret=True)
    jt = jax.vmap(lambda t, *w: JT.apply_walk(JConnect4, t, *w))(
        carried, *walk)
    j_obs = jax.vmap(lambda t: JT.leaf_observation(JConnect4, t))(jt)
    pi, value = j_eval(j_obs)
    j_values = jax.vmap(JT.resolve_value)(jt, value)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    jt = jax.vmap(lambda t, p, r: JT.install_prior(t, p, jspec, r))(
        jt, pi, keys)

    tree = port_tree(carried)
    spec = T.SearchSpec(**spec_kw)
    T.apply_walk(ENV, tree, *OD.descend_batched(tree, spec))
    obs = T.leaf_observation(ENV, tree)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(j_obs))
    t_pi, t_value = t_eval(obs)
    values = T.resolve_value(tree, t_value)
    np.testing.assert_array_equal(values.numpy(), np.asarray(j_values))
    leaf_valids = tree.valids[torch.arange(B), tree.leaf.long()].numpy()
    gammas, tie = _install_draws(keys, leaf_valids)
    T.install_prior(tree, t_pi, spec, True, gammas=gammas, tie=tie)

    want = port_tree(jt)
    # All rows but the sink (the junk of masked writes; see above).
    assert_trees_equal(tree, want, np.full(B, CAPACITY), float_tol=1e-6)
    np.testing.assert_allclose(tree.prior.numpy(), want.prior.numpy(),
                               rtol=1e-6, atol=1e-7)
    # Both kinds of leaf occur: fresh roots (noised) and new rows.
    assert (tree.leaf == 0).any() and (tree.leaf > 0).any()
    assert (tree.next_free > 2).any()


@pytest.mark.parametrize("sims_done", [3, 9])
def test_batch_major_kernels_plain_match_jax_on_reused_snapshots(carried,
                                                                 sims_done):
    """descend_batched and backup_batched (plain versions) against JAX's
    batch-major kernels in interpret mode, on carried trees part-way
    through a search, with a discount below 1."""
    kw = dict(SPEC_KW, min_discount=0.8)
    jspec, spec = JT.SearchSpec(**kw), T.SearchSpec(**kw)
    jt = _j_search(jspec, fresh=False)(carried, jax.random.PRNGKey(1),
                                       sims=sims_done)
    want = j_descend(jt, jspec, interpret=True)
    got = OD.descend_batched(port_tree(jt), spec)
    for name, g, w in zip(("node", "action", "child", "depth", "skip_walk"),
                          got[:5], want[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]),
                               rtol=1e-6, atol=1e-7)
    assert (got[3] > 1).any()

    jt2 = jax.vmap(lambda t, *w: JT.apply_walk(JConnect4, t, *w))(jt, *want)
    rng = np.random.default_rng(sims_done)
    value = rng.dirichlet(np.ones(V), B).astype(np.float32)
    value[:2] = [[0.5, 0.5, 0.0], [0.25, 0.25, 0.5]]  # exact draw values
    j_new = j_backup(jt2, jnp.asarray(value), jspec, interpret=True)
    tree = port_tree(jt2)
    OB.backup_batched(tree, torch.from_numpy(value), spec)
    np.testing.assert_array_equal(tree.n.numpy(), np.asarray(j_new.n))
    for name in ("q", "v"):
        np.testing.assert_allclose(getattr(tree, name).numpy(),
                                   np.asarray(getattr(j_new, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_search_on_carried_trees_matches_jax(carried):
    """search(fresh_tree=False) against JAX's with the interpreted Pallas
    kernels: visits and links equal, q within 1e-6."""
    sims = 10
    _, t_eval = table_eval_fns()
    want = port_tree(_j_search(JT.SearchSpec(**SPEC_KW), fresh=False)(
        carried, jax.random.PRNGKey(2), sims=sims))
    got = S.search(ENV, port_tree(carried), T.SearchSpec(**SPEC_KW), t_eval,
                   sims, fresh_tree=False)
    every = np.full(B, CAPACITY)  # all rows but the sink
    for name in ("n", "parent", "parent_action", "next_free"):
        a, b = getattr(got, name).numpy(), getattr(want, name).numpy()
        if a.ndim == 2:
            a, b = a[:, :-1], b[:, :-1]
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert_trees_equal(got, want, every, float_tol=1e-6)
    np.testing.assert_array_equal(T.counts(got).numpy(),
                                  T.counts(want).numpy())
    before = port_tree(carried)
    assert (got.n[:, 0] == before.n[:, 0] + sims).all()


def test_search_rejects_mixed_trees_and_overfull_trees(carried):
    tree = port_tree(carried)
    _, t_eval = table_eval_fns()
    spec = T.SearchSpec(**SPEC_KW)
    # fresh_tree=True takes trees never searched (a TreeT, or a fresh Tree);
    # a TreeT is never carried.
    with pytest.raises(ValueError, match="never searched"):
        S.search(ENV, tree, spec, t_eval, 4)
    fresh_t = TT.init_tree_t(ENV, T.gather_states(ENV, tree, tree.leaf * 0),
                             CAPACITY, V)
    with pytest.raises(TypeError):
        S.search(ENV, fresh_t, spec, t_eval, 4, fresh_tree=False)
    room = CAPACITY - int(tree.next_free.max())
    with pytest.raises(ValueError, match="free rows"):
        S.search(ENV, tree, spec, t_eval, room + 1, fresh_tree=False)


#: The reuse-move configs: connect4 (the eight-move run with every kind of
#: tree restart, from positions near their end), and tictactoe, nim3 (3
#: players), othello, gobang, othello with 2 stacked observations and
#: tictactoe with 3: (games, max plies of the random openings, moves).
REUSE_MOVE_ENVS = {"connect4": (B, 40, 8), "tictactoe": (8, 4, 12),
                   "nim3": (8, 4, 12), "othello": (8, 40, 12),
                   "gobang": (8, 60, 12), "othello_x2": (8, 40, 12),
                   "tictactoe_x3": (8, 4, 12)}


def _reuse_env(name):
    """(port env, JAX env) of ``name``, ``<env>_x<k>`` with k stacked
    observations."""
    from alphazero_general_tpu.envs import get_env as j_get_env
    from alphazero_general_tpu.envs.stacked import make_stacked_env as j_stack
    from alphazero_general_tpu_torch.envs.stacked import make_stacked_env

    base, _, k = name.partition("_x")
    env, jenv = get_env(base), j_get_env(base)
    if k:
        return make_stacked_env(env, int(k)), j_stack(jenv, int(k))
    return env, jenv


@pytest.mark.parametrize("name", list(REUSE_MOVE_ENVS))
def test_reuse_move_steps_match_jax(name):
    """Reuse moves (fast, fast, fast, full, ...) on trees small enough that
    trees restart: connect4 from positions near their end, where every
    restart happens (a finished game, a kept subtree that leaves no room
    for a full search (overflow), one past the reset threshold); the other
    envs from random openings, carrying trees. Policies within 1e-6;
    actions, states, next_free, and the parent links and visits of the
    carried trees equal."""
    from test_torch_envs import (jax_items, port_items, random_items,
                                 table_eval_fns as env_table_eval_fns,
                                 to_jax, to_torch)

    env, jenv = _reuse_env(name)
    games, max_plies, moves = REUSE_MOVE_ENVS[name]
    A_, V_ = env.ACTION_SIZE, env.NUM_PLAYERS + int(env.HAS_DRAW)
    sims_full, sims_fast, capacity, threshold = SIMS, 4, 18, 3
    if name == "connect4":
        j_eval, t_eval = table_eval_fns(seed=2)
        pos = random_positions(games, seed=21, max_plies=max_plies)
        j_states, t_states = to_jax_states(pos), to_torch_states(pos)
    else:
        j_eval, t_eval = env_table_eval_fns(env, seed=2)
        items = random_items(env, games, seed=21, max_plies=max_plies)
        j_states, t_states = to_jax(jenv, items), to_torch(env, items)
    spec_kw = dict(SPEC_KW, num_players=env.NUM_PLAYERS,
                   has_draw=env.HAS_DRAW)
    kw = dict(sims_full=sims_full, sims_fast=sims_fast, reuse_tree=True,
              tree_capacity=capacity, reset_threshold=threshold)
    j_cfg = JSP.SelfPlayConfig(**kw, walk_impl="pallas_interpret",
                               spec=JT.SearchSpec(**spec_kw))
    t_cfg = SP.SelfPlayConfig(**kw, spec=T.SearchSpec(**spec_kw))

    @functools.partial(jax.jit, static_argnames=("sims", "fast"))
    def j_move(carry, rng, sims, fast):
        return JSP.move_step(jenv, j_cfg, j_eval, carry, rng,
                             sims_override=sims, fast_flag=fast)

    temps = np.where(np.arange(games) % 2 == 0, 1.0, 0.5).astype(np.float32)
    j_carry = JSP.SelfPlayState(
        env_state=j_states, temps=jnp.asarray(temps),
        games_played=jnp.int32(0), move_count=jnp.int32(0),
        trees=JS.init_batched_trees(jenv, j_states, capacity, V_))
    t_carry = SP.SelfPlayState(
        env_state=t_states, temps=torch.from_numpy(temps.copy()),
        games_played=torch.zeros((), dtype=torch.int32),
        move_count=torch.zeros((), dtype=torch.int32),
        trees=T.init_tree(env, t_states, capacity, V_))
    causes = {"done": 0, "overflow": 0, "threshold": 0, "carried": 0}
    for k, kind in enumerate((("fast", "fast", "fast", "full") * 3)[:moves]):
        sims = sims_fast if kind == "fast" else sims_full
        rng = jax.random.PRNGKey(200 + k)
        j_carry, j_rec = j_move(j_carry, rng, sims, kind == "fast")
        r_action = jax.random.split(rng, 4)[2]
        gumbel = np.array(jax.random.gumbel(r_action, (games, A_),
                                            jnp.float32))
        searched = t_carry.trees  # move_step searches the carried trees
        t_carry, t_rec = SP.move_step(env, t_cfg, t_eval, t_carry, sims,
                                      fast=kind == "fast",
                                      gumbel=torch.from_numpy(gumbel))

        np.testing.assert_allclose(t_rec.pi.numpy(), np.asarray(j_rec.pi),
                                   rtol=1e-6, atol=1e-6)
        for f in ("action", "done", "win_state", "player"):
            np.testing.assert_array_equal(
                getattr(t_rec, f).numpy(), np.asarray(getattr(j_rec, f)),
                err_msg=f)
        t_items = port_items(t_carry.env_state)
        j_items = jax_items(jenv, j_carry.env_state, t_items)
        for f in t_items:
            np.testing.assert_array_equal(t_items[f], j_items[f], err_msg=f)
        got = t_carry.trees
        np.testing.assert_array_equal(got.next_free.numpy(),
                                      np.asarray(j_carry.trees.next_free))
        for f in ("parent", "n"):
            np.testing.assert_array_equal(
                getattr(got, f)[:, :-1].numpy(),
                np.asarray(getattr(j_carry.trees, f))[:, :-1], err_msg=f)
        assert (t_rec.root_visits >= sims).all()

        # Why each game's next tree is what it is.
        kept = T.reroot(env, searched, t_rec.action).next_free
        reset = t_rec.tree_reset
        overflow = kept + sims_full + 1 > capacity
        assert torch.equal(reset, t_rec.done | overflow | (kept > threshold))
        causes["done"] += int(t_rec.done.sum())
        causes["overflow"] += int((overflow & ~t_rec.done).sum())
        causes["threshold"] += int(((kept > threshold) & ~overflow
                                    & ~t_rec.done).sum())
        causes["carried"] += int((~reset & (got.next_free > 1)).sum())
    if name == "connect4":
        assert min(causes.values()) > 0, causes
    else:
        assert causes["carried"] > 0 and causes["threshold"] > 0, causes


def _custom_temp(cur_temp, turns, max_turns):
    return cur_temp


@pytest.mark.parametrize("overrides,raises", [
    ({}, False),
    ({"reuse_tree": True}, False),
    ({"max_tree_nodes": 64}, False),
    ({"numWarmupSims": 250}, False),
    ({"numWarmupSims": 250, "reuse_tree": True, "mctsResetThreshold": 90},
     False),
    ({"leaf_batch": 4}, False),
    ({"temp_scaling_fn": _custom_temp}, True),
], ids=["defaults", "reuse", "max_tree_nodes", "warmup_sims",
        "warmup_reuse_threshold", "leaf_batch", "temp_scaling_fn"])
def test_from_args_matches_jax_config_or_raises(overrides, raises):
    """For the same args the port's config sizes trees as the JAX package's
    does (capacity, reuse, reset threshold, warmup sims) and takes its
    leaf_batch, or raises on a knob it cannot run."""
    base = dict(numMCTSSims=120, numFastSims=30)
    args = get_args(**base, **overrides)
    if raises:
        with pytest.raises(ValueError, match="not ported"):
            SP.SelfPlayConfig.from_args(args, 2, True)
        return
    got = SP.SelfPlayConfig.from_args(args, 2, True)
    want = JSP.SelfPlayConfig.from_args(j_get_args(**base, **overrides), 2,
                                        True)
    assert got.capacity == want.capacity
    for name in ("sims_full", "sims_fast", "sims_warmup", "start_temp",
                 "tree_capacity", "reuse_tree", "reset_threshold",
                 "leaf_batch"):
        assert getattr(got, name) == getattr(want, name), name
    assert tuple(got.spec) == tuple(want.spec)
