"""The port's arena against the JAX package's, with JAX's draws injected.

``JaxDraws`` recomputes, from the JAX package's own keys, every random draw
a JAX self-play move or arena round makes (the Gumbel noise of the action
sample, the tie noise of each simulation's prior install, the root's
Dirichlet gamma draws) and hands them to the port as ``MoveDraws``. The
arena results must then be equal: wins per model, draws and the average
game length.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import alphazero_general_tpu.selfplay.arena as JA
from alphazero_general_tpu.envs.connect4 import Connect4 as JConnect4
from alphazero_general_tpu.mcts.tree import NOISE_ALPHA_RATIO
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts.search import SearchDraws
from alphazero_general_tpu_torch.selfplay import MoveDraws
from alphazero_general_tpu_torch.selfplay import arena as A
from test_torch_model import jax_and_port

# Small tensors: one intra-op thread. Several test processes share the
# host's cores, and idle OpenMP threads that spin while waiting slow every
# process down many times over.
torch.set_num_threads(1)


@functools.partial(jax.jit, static_argnames=("sims", "root_noise"))
def _jax_move_draws(r_search, r_action, valids, sims, root_noise):
    """The draws of one JAX move: Gumbel noise from the action key; per
    simulation k, the search key chain of mcts/search.py (first key, then
    ``sims - 1`` split from the rest; ``_, noise = split(key)``; one key per
    game; each game's key split into (gamma key, tie key),
    mcts/tree.py:768)."""
    B, A_ = valids.shape
    gumbel = jax.random.gumbel(r_action, (B, A_), jnp.float32)
    first, rest = jax.random.split(r_search)
    keys = jnp.concatenate([first[None], jax.random.split(rest, sims - 1)])

    def per_sim(k):
        _, noise = jax.random.split(k)
        return jax.vmap(jax.random.split)(jax.random.split(noise, B))

    game_keys = jax.vmap(per_sim)(keys)  # [sims, B, 2, 2]
    tie = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, (A_,))))(
        game_keys[:, :, 1])
    gammas = None
    if root_noise:
        alpha = NOISE_ALPHA_RATIO / jnp.maximum(
            valids.sum(-1), 1).astype(jnp.float32)
        gammas = jax.vmap(lambda k, a: jax.random.gamma(k, a, (A_,)))(
            game_keys[0, :, 0], alpha)
    return gumbel, tie, gammas


def move_draws(r_search, r_action, valids, sims, root_noise):
    gumbel, tie, gammas = _jax_move_draws(
        r_search, r_action, jnp.asarray(valids.cpu().numpy()), sims=sims,
        root_noise=root_noise)
    dev = valids.device
    t = lambda x: None if x is None else torch.from_numpy(  # noqa: E731
        np.array(x)).to(dev)
    return MoveDraws(gumbel=t(gumbel),
                     search=SearchDraws(tie=t(tie), gammas=t(gammas)))


_CALIBRATION_FNS = {}


def jax_calibration(env_name, rng, batch=256, moves=24):
    """The JAX package's cold-start calibration playouts
    (``calibration_observations``, models/quant.py:255) with their
    actions: (obs [moves * batch, C, H, W], actions [moves, batch]) as
    numpy, from the same key and the same ops."""
    from alphazero_general_tpu.envs import get_env as j_get_env

    env = j_get_env(env_name)
    states = jax.vmap(lambda _: env.init())(jnp.arange(batch))

    def body(st, r):
        obs = jax.vmap(env.observation)(st)
        valids = jax.vmap(env.valid_moves)(st)
        logits = jnp.where(valids, 0.0, -jnp.inf)
        act = jax.random.categorical(r, logits, axis=-1).astype(jnp.int32)
        nxt = jax.vmap(env.step)(st, act)
        done = jnp.any(jax.vmap(env.win_state)(nxt) > 0, axis=-1)
        fresh = jax.vmap(lambda _: env.init())(jnp.arange(batch))

        def sel(n, f):
            return jnp.where(done.reshape((batch,) + (1,) * (n.ndim - 1)),
                             f, n)

        return jax.tree_util.tree_map(sel, nxt, fresh), (obs, act)

    key = (env_name, batch, moves)
    if key not in _CALIBRATION_FNS:
        _CALIBRATION_FNS[key] = jax.jit(lambda s, r: jax.lax.scan(
            body, s, jax.random.split(r, moves)))
    _, (obs, act) = _CALIBRATION_FNS[key](states, rng)
    return (np.asarray(obs).reshape((-1,) + obs.shape[2:]),
            np.array(act))


class JaxDraws:
    """The JAX Coach's key stream (train/coach.py:147, ``_next_rng``): one
    key per self-play move (split into fast, search, action keys,
    selfplay.py:184), one per arena (split per round into search and
    action keys, arena.py:269) and one per int8 re-quantization (the
    calibration playouts' key, used where no replay calibrates)."""

    def __init__(self, seed: int, root_noise: bool = True,
                 env_name: str = "connect4"):
        self.rng = jax.random.PRNGKey(seed + 1)
        self.root_noise = root_noise
        self.env_name = env_name
        self.calibrations = 0

    def calibration(self):
        key = self.next_key()
        self.calibrations += 1
        return lambda: jax_calibration(self.env_name, key)[1]

    def next_key(self):
        self.rng, sub = jax.random.split(self.rng)
        return sub

    def selfplay(self, kind, sims, valids):
        _, r_search, r_action, _ = jax.random.split(self.next_key(), 4)
        return move_draws(r_search, r_action, valids, sims, self.root_noise)

    def arena(self):
        return arena_draws(self.next_key())


def arena_draws(rng):
    """Per-round draws of one JAX arena from its key ``rng``."""
    state = [rng]

    def round_draws(t, sims, valids):
        state[0], r_search, r_action = jax.random.split(state[0], 3)
        return move_draws(r_search, r_action, valids, sims, False)

    return round_draws


def test_arena_matches_jax_with_injected_draws():
    """B = 8 games, 16 simulations: two small models against each other,
    then one against the RawMCTS baseline, float32; wins, draws and the
    average game length equal to JAX's."""
    B, sims = 8, 16
    jnet_a, vars_a, net_a = jax_and_port("float32", seed=1)
    jnet_b, vars_b, net_b = jax_and_port("float32", seed=2)
    env = get_env("connect4")
    j_cfg = JA.ArenaConfig(sims=sims, arena_temp=1.0)
    t_cfg = A.ArenaConfig(sims=sims, arena_temp=1.0)
    assert tuple(t_cfg.spec) == tuple(j_cfg.spec)

    def j_apply(model):
        return lambda v, obs: model.apply(v, obs, train=False)

    raw_j = JA.raw_mcts_apply(7, 3)
    raw_t = A.raw_mcts_apply(7, 3)
    cases = [
        ([j_apply(jnet_a.model), j_apply(jnet_b.model)], [vars_a, vars_b],
         [net_a.model, net_b.model]),
        ([j_apply(jnet_a.model), raw_j], [vars_a, {}], [net_a.model, raw_t]),
    ]
    for k, (j_fns, j_vars, t_fns) in enumerate(cases):
        rng = jax.random.PRNGKey(70 + k)
        want = jax.jit(lambda vl, r: JA.play_games_multi(
            JConnect4, j_cfg, j_fns, vl, B, r))(j_vars, rng)
        got = A.play_games_multi(env, t_cfg, t_fns, B,
                                 draws=arena_draws(rng), device="cpu")
        np.testing.assert_array_equal(got.model_wins.numpy(),
                                      np.asarray(want.model_wins))
        assert got.draws == float(want.draws)
        assert got.avg_game_length == float(want.avg_game_length)
        assert got.num_games == int(want.num_games) == B
        assert 0 < got.rounds <= env.MAX_TURNS
        np.testing.assert_allclose(A.winrates(got).numpy(),
                                   np.asarray(JA.winrates(want)), rtol=1e-6)


def test_arena_routes_each_group_to_its_owner():
    """Owner routing: at round t model m evaluates only group (t - m) % N,
    so each model forwards B / N observations once per simulation."""
    env = get_env("connect4")
    B = 8
    calls = {0: [], 1: []}

    def recorder(m):
        def apply(obs):
            calls[m].append(obs.shape[0])
            return A.raw_mcts_apply(7, 3)(obs)
        return apply

    cfg = A.ArenaConfig(sims=4)
    gen = torch.Generator().manual_seed(0)
    routed = A.play_games_multi(env, cfg, [recorder(0), recorder(1)], B,
                                generator=gen, device="cpu")
    assert set(calls[0]) == set(calls[1]) == {B // 2}
    assert len(calls[0]) == len(calls[1]) == routed.rounds * cfg.sims
    assert float(routed.model_wins.sum()) + routed.draws == B
    # RawMCTS log values are -100 (GenericPlayers.py:198-200).
    logp, logv = A.raw_mcts_apply(7, 3)(torch.zeros(2, 4, 6, 7))
    assert torch.allclose(logp.exp().sum(-1), torch.ones(2))
    assert (logv == -100.0).all()
    assert T.SearchSpec(add_root_noise=False, add_root_temp=False) == cfg.spec
