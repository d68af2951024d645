"""The port's self-play move step against the JAX move step.

Four moves (fast, fast, fast, full) from random positions, both sides
driven by the same table evaluation (test_torch_search.table_eval_fns) and
the same Gumbel noise, recomputed from JAX's own keys and passed to the
port. The policy must agree within 1e-6; actions, next states, done flags
and temperatures must be equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import alphazero_general_tpu.mcts.tree as JT
import alphazero_general_tpu.selfplay.selfplay as JSP
from alphazero_general_tpu.envs.connect4 import Connect4 as JConnect4
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs.core import state_items
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.selfplay import selfplay as SP
from alphazero_general_tpu_torch.utils import get_args
from alphazero_general_tpu.utils.config import get_args as j_get_args
from test_torch_arena import move_draws
from test_torch_model import SMALL, jax_and_port
from test_torch_search import (random_positions, table_eval_fns,
                               to_jax_states, to_torch_states)

B = 8
SIMS_FULL, SIMS_FAST = 12, 4
SPEC_KW = dict(tie_noise=0.0, add_root_noise=False)


def test_move_steps_match_jax():
    j_eval, t_eval = table_eval_fns(seed=2)
    # Random games stopped one move short of their end: several of them
    # end within the four moves, which exercises the auto-reset.
    pos = random_positions(B, seed=21, max_plies=40)

    j_cfg = JSP.SelfPlayConfig(sims_full=SIMS_FULL, sims_fast=SIMS_FAST,
                               walk_impl="xla",
                               spec=JT.SearchSpec(**SPEC_KW))
    t_cfg = SP.SelfPlayConfig(sims_full=SIMS_FULL, sims_fast=SIMS_FAST,
                              spec=T.SearchSpec(**SPEC_KW))

    @functools.partial(jax.jit, static_argnames=("sims", "fast"))
    def j_move(carry, rng, sims, fast):
        return JSP.move_step(JConnect4, j_cfg, j_eval, carry, rng,
                             sims_override=sims, fast_flag=fast)

    temps = np.where(np.arange(B) % 2 == 0, 1.0, 0.5).astype(np.float32)
    j_carry = JSP.SelfPlayState(env_state=to_jax_states(pos),
                                temps=jnp.asarray(temps),
                                games_played=jnp.int32(0),
                                move_count=jnp.int32(0))
    t_carry = SP.SelfPlayState(env_state=to_torch_states(pos),
                               temps=torch.from_numpy(temps.copy()),
                               games_played=torch.zeros((), dtype=torch.int32),
                               move_count=torch.zeros((), dtype=torch.int32))
    env = get_env("connect4")
    done_any = False
    for k, kind in enumerate(("fast", "fast", "fast", "full")):
        sims = SIMS_FAST if kind == "fast" else SIMS_FULL
        rng = jax.random.PRNGKey(100 + k)
        j_carry, j_rec = j_move(j_carry, rng, sims, kind == "fast")
        # move_step splits its key into (fast, search, action, spare); the
        # action is the argmax of the logits plus Gumbel noise of the
        # action key (jax.random.categorical).
        r_action = jax.random.split(rng, 4)[2]
        gumbel = np.array(jax.random.gumbel(r_action, (B, 7), jnp.float32))
        t_carry, t_rec = SP.move_step(env, t_cfg, t_eval, t_carry, sims,
                                      fast=kind == "fast",
                                      gumbel=torch.from_numpy(gumbel))

        np.testing.assert_allclose(t_rec.pi.numpy(), np.asarray(j_rec.pi),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(t_rec.action.numpy(),
                                      np.asarray(j_rec.action))
        np.testing.assert_array_equal(t_rec.done.numpy(),
                                      np.asarray(j_rec.done))
        np.testing.assert_array_equal(t_rec.win_state.numpy(),
                                      np.asarray(j_rec.win_state))
        np.testing.assert_array_equal(t_rec.obs.numpy(),
                                      np.asarray(j_rec.obs))
        np.testing.assert_array_equal(t_rec.player.numpy(),
                                      np.asarray(j_rec.player))
        for name, x in state_items(t_carry.env_state).items():
            np.testing.assert_array_equal(
                x.numpy(), np.asarray(getattr(j_carry.env_state, name)),
                err_msg=name)
        np.testing.assert_array_equal(t_carry.temps.numpy(),
                                      np.asarray(j_carry.temps))
        assert int(t_carry.games_played) == int(j_carry.games_played)
        assert (t_rec.root_visits == sims).all()
        done_any |= bool(t_rec.done.any())
    assert done_any  # auto-reset was exercised
    assert int(t_carry.move_count) == 4


def test_move_step_through_converted_resnet():
    """One full move through the converted small ResNet in float32: the
    record's shapes and invariants hold, and the network's outputs on the
    move's observations agree with the JAX network's. The runner's records
    are float16 (slimmed as the JAX package's are): each policy entry is a
    root child's visits over the SIMS_FULL - 1 simulations past the root's
    expansion, rounded to float16 (relative error at most 2^-11)."""
    jnet, variables, net = jax_and_port("float32", seed=5)
    env = get_env("connect4")
    cfg = SP.SelfPlayConfig.from_args(
        get_args(numMCTSSims=SIMS_FULL, numFastSims=SIMS_FAST),
        env.NUM_PLAYERS, env.HAS_DRAW)
    assert cfg.spec == T.SearchSpec() and cfg.sims_full == SIMS_FULL
    fns = SP.make_move_fns(env, cfg, net.model)
    carry = SP.init_selfplay(env, B, device="cpu")
    gen = torch.Generator().manual_seed(0)
    carry, rec = fns["fast"](carry, generator=gen)
    before = carry.env_state
    carry, rec = fns["full"](carry, generator=gen)

    assert rec.obs.shape == (B, 4, 6, 7) and rec.pi.shape == (B, 7)
    assert rec.obs.dtype == rec.pi.dtype == torch.float16
    pi16 = rec.pi.to(torch.float32)
    visits = pi16 * (SIMS_FULL - 1)
    assert torch.allclose(visits, visits.round(), rtol=0,
                          atol=(SIMS_FULL - 1) * 2**-11)
    assert torch.allclose(pi16.sum(-1), torch.ones(B), rtol=0, atol=2**-11)
    assert (rec.root_visits == SIMS_FULL).all()
    legal = env.valid_moves(before)[torch.arange(B), rec.action.long()]
    assert legal.all()
    assert (rec.pi[torch.arange(B), rec.action.long()] > 0).all()
    assert int(carry.move_count) == 2 and not rec.fast

    pi, v = net.process(rec.obs)
    j_logp, j_logv = jnet.model.apply(variables, jnp.asarray(rec.obs.numpy()),
                                      train=False)
    np.testing.assert_allclose(pi.numpy(), np.exp(np.asarray(j_logp)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.exp(np.asarray(j_logv)),
                               rtol=1e-4, atol=1e-5)
    assert SMALL["depth"] == len(net.model.blocks)


def test_warmup_and_slimmed_records_match_jax():
    """The warmup runner (uniform policy and values, numWarmupSims) and the
    slimmed records of the three runners against JAX's runners, through
    the converted small ResNet in float32, with JAX's draws (root noise
    and tie noise on, as the defaults have them): fast records carry no
    obs or pi, the others float16 ones equal to JAX's."""
    jnet, variables, net = jax_and_port("float32", seed=4)
    env = get_env("connect4")
    knobs = dict(numMCTSSims=6, numFastSims=3, numWarmupSims=4,
                 probFastSim=0.5)
    cfg = SP.SelfPlayConfig.from_args(get_args(**knobs), 2, True)
    j_cfg = JSP.SelfPlayConfig.from_args(j_get_args(**knobs), 2,
                                         True)._replace(walk_impl="xla")
    assert cfg.prob_fast == j_cfg.prob_fast == 0.5 and not cfg.const_temp
    assert tuple(cfg.spec) == tuple(j_cfg.spec)
    j_fns = JSP.make_move_fns(
        JConnect4, j_cfg,
        lambda v, obs: jnet.model.apply(v, obs, train=False))
    fns = SP.make_move_fns(env, cfg, net.model)
    j_carry = JSP.init_selfplay(JConnect4, B, 1.0)
    carry = SP.init_selfplay(env, B, device="cpu")
    sims = {"warmup": 4, "fast": 3, "full": 6}
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    for k, kind in enumerate(("warmup", "warmup", "full", "fast", "full")):
        rng = jax.random.PRNGKey(200 + k)
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
            assert rec.obs is None and rec.pi is None
            assert j_rec.obs is None and j_rec.pi is None
        else:
            assert rec.obs.dtype == rec.pi.dtype == torch.float16
            np.testing.assert_array_equal(rec.obs.numpy(),
                                          np.asarray(j_rec.obs))
            np.testing.assert_array_equal(rec.pi.numpy(),
                                          np.asarray(j_rec.pi))
    np.testing.assert_array_equal(carry.temps.numpy(),
                                  np.asarray(j_carry.temps))
    for name, x in state_items(carry.env_state).items():
        np.testing.assert_array_equal(
            x.numpy(), np.asarray(getattr(j_carry.env_state, name)))
