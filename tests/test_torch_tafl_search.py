"""The port's search, self-play move runners and Coach on tafl against the
JAX package's, on the CPU at small width.

* A fresh-tree hnefatafl search (A = 2420) against JAX's ``xla`` walk,
  both driven by one table evaluation (policy and value rows of a float32
  table indexed by an integer hash of the piece planes, so that both sides
  get bit-identical priors): visit counts and tree links equal, q and v
  within 1e-6.
* The hnefatafl move runners (warmup, fast, full) through a converted
  small ResNet in float32 with JAX's draws injected: actions, states and
  the sparse top-(sims + 1) policy records equal once densified, exactly
  in float16. ``torch.topk`` and ``jax.lax.top_k`` may give the zeros of a
  row at other ids, so the densified rows are the criterion, not the raw
  pair.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphazero_general_tpu.mcts.search as JS
import alphazero_general_tpu.mcts.tree as JT
import alphazero_general_tpu.selfplay.selfplay as JSP
from alphazero_general_tpu.envs import get_env as j_get_env
from alphazero_general_tpu.utils.config import get_args as j_get_args
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs.core import state_items
from alphazero_general_tpu_torch.mcts import search as S
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts import tree_t as TT
from alphazero_general_tpu_torch.selfplay import selfplay as SP
from alphazero_general_tpu_torch.utils import get_args
from test_torch_arena import move_draws
from test_torch_model import jax_and_port

torch.set_num_threads(1)

FIELDS = ("board", "player", "turns", "last_action", "king_captured")


def table_eval_fns(env, seed=0, rows=509):
    """(jax_eval_fn, torch_eval_fn) over one shared float32 table, indexed
    by an integer hash of the black, white and king planes."""
    rng = np.random.default_rng(seed)
    A, cells = env.ACTION_SIZE, 3 * env.OBS_SHAPE[1] * env.OBS_SHAPE[2]
    pi_tab = rng.dirichlet(np.ones(A), rows).astype(np.float32)
    v_tab = rng.dirichlet(np.ones(3), rows).astype(np.float32)
    w = rng.integers(1, rows, size=(cells,)).astype(np.int32)

    def j_eval(obs):
        pieces = (obs[:, :3] > 0.5).reshape(obs.shape[0], cells)
        h = jnp.sum(pieces.astype(jnp.int32) * jnp.asarray(w), axis=1) % rows
        return jnp.asarray(pi_tab)[h], jnp.asarray(v_tab)[h]

    def t_eval(obs):
        pieces = (obs[:, :3] > 0.5).reshape(obs.shape[0], cells)
        h = (pieces.to(torch.int32) * torch.from_numpy(w)).sum(dim=1) % rows
        return (torch.from_numpy(pi_tab)[h.long()],
                torch.from_numpy(v_tab)[h.long()])

    return j_eval, t_eval


def random_positions(env, batch, seed, max_plies):
    """Numpy state fields of games advanced by random legal moves, never
    into a finished position."""
    rng = np.random.default_rng(seed)
    out = {k: [] for k in FIELDS}
    for _ in range(batch):
        s = env.init(1, device="cpu")
        for _ in range(int(rng.integers(0, max_plies + 1))):
            valid = np.flatnonzero(env.valid_moves(s)[0].numpy())
            nxt = env.step(s, torch.tensor([rng.choice(valid)]))
            if env.terminated(nxt)[0]:
                break
            s = nxt
        for k in out:
            out[k].append(getattr(s, k)[0].numpy())
    return {k: np.stack(v) for k, v in out.items()}


def to_jax(jenv, pos):
    return jenv.State(**{k: jnp.asarray(v) for k, v in pos.items()})


def to_torch(env, pos):
    return env.State(**{k: torch.from_numpy(v.copy()) for k, v in pos.items()})


@pytest.mark.parametrize("min_discount", [1.0, 0.8])
def test_hnefatafl_search_matches_jax(min_discount):
    B, sims = 6, 12
    env, jenv = get_env("hnefatafl"), j_get_env("hnefatafl")
    kw = dict(tie_noise=0.0, add_root_noise=False, min_discount=min_discount)
    j_eval, t_eval = table_eval_fns(env)
    pos = random_positions(env, B, seed=11, max_plies=30)

    jt = JS.init_batched_trees(jenv, to_jax(jenv, pos), sims + 2, 3)
    jt = JS.search(jenv, jt, JT.SearchSpec(**kw), j_eval, sims,
                   jax.random.PRNGKey(0), walk_impl="xla")
    tt = TT.init_tree_t(env, to_torch(env, pos), sims + 2, 3)
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
    # Batch-major prior rows, JAX's layout at A >= 128 (big_rows).
    rows = np.asarray(jt.prior).reshape(B, -1, env.ACTION_SIZE)
    np.testing.assert_allclose(tt.prior.numpy()[:, :sims], rows[:, :sims],
                               rtol=1e-6, atol=1e-7)
    assert (tt.n[0] == sims).all() and int(tt.max_depth.max()) >= 3


def test_hnefatafl_move_runners_match_jax():
    """Warmup, full and fast moves through the converted small ResNet with
    JAX's draws (root noise and tie noise on): actions, win states and
    states equal; obs equal in float16; the sparse policy records equal
    once densified."""
    B = 4
    env, jenv = get_env("hnefatafl"), j_get_env("hnefatafl")
    jnet, variables, net = jax_and_port("float32", seed=4,
                                        env_name="hnefatafl")
    knobs = dict(numMCTSSims=6, numFastSims=3, numWarmupSims=4)
    cfg = SP.SelfPlayConfig.from_args(get_args(**knobs), 2, True)
    j_cfg = JSP.SelfPlayConfig.from_args(j_get_args(**knobs), 2,
                                         True)._replace(walk_impl="xla")
    j_fns = JSP.make_move_fns(
        jenv, j_cfg, lambda v, obs: jnet.model.apply(v, obs, train=False))
    fns = SP.make_move_fns(env, cfg, net.model)
    j_carry = JSP.init_selfplay(jenv, B, 1.0)
    carry = SP.init_selfplay(env, B, device="cpu")
    sims = {"warmup": 4, "fast": 3, "full": 6}
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    for k, kind in enumerate(("warmup", "full", "fast", "full")):
        rng = jax.random.PRNGKey(300 + k)
        j_carry, j_rec = j_fns[kind](variables, j_carry, rng)
        _, r_search, r_action, _ = jax.random.split(rng, 4)
        d = move_draws(r_search, r_action,
                       env.valid_moves(carry.env_state), sims[kind], True)
        carry, rec = fns[kind](carry, gumbel=d.gumbel,
                               search_draws=d.search)
        np.testing.assert_array_equal(rec.action.numpy(),
                                      np.asarray(j_rec.action))
        np.testing.assert_array_equal(rec.win_state.numpy(),
                                      np.asarray(j_rec.win_state))
        assert (rec.root_visits == sims[kind]).all()
        if kind == "fast":
            assert rec.obs is None and rec.pi is None and rec.pi_idx is None
            continue
        kk = sims[kind] + 1
        assert rec.pi.shape == rec.pi_idx.shape == (B, kk)
        assert rec.pi.dtype == torch.float16
        assert rec.pi_idx.dtype == torch.int32
        np.testing.assert_array_equal(rec.obs.numpy(), np.asarray(j_rec.obs))
        got = SP.densify_pi(rec.pi.numpy(), rec.pi_idx.numpy(),
                            env.ACTION_SIZE)
        want = SP.densify_pi(np.asarray(j_rec.pi), np.asarray(j_rec.pi_idx),
                             env.ACTION_SIZE)
        np.testing.assert_array_equal(got, want)
        assert np.allclose(got.astype(np.float32).sum(-1), 1.0, atol=2**-11)
    for name, x in state_items(carry.env_state).items():
        np.testing.assert_array_equal(
            x.numpy(), np.asarray(getattr(j_carry.env_state, name)),
            err_msg=name)
    np.testing.assert_array_equal(carry.temps.numpy(),
                                  np.asarray(j_carry.temps))


def test_sparse_records_with_tree_reuse_raise():
    """Top-(sims + 1) records are exact only on fresh trees."""
    env = get_env("brandubh")
    cfg = SP.SelfPlayConfig(reuse_tree=True)
    with pytest.raises(ValueError, match="reuse_tree"):
        SP.make_move_fns(env, cfg, lambda obs: None)
