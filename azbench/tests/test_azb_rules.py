"""The reference rules (NumPy, one game at a time) against the port's
batched envs over random playouts on the CPU: every state, valid-move set
and result alike, and the benchmark's own random playouts against the
reference."""

import numpy as np
import pytest
import torch

from azbench import program as P, registry
from azbench.common import game_state, same_state
from azbench.reference import connect4, make_env

torch.set_num_threads(1)


@pytest.mark.parametrize("name,games,moves", [("connect4", 48, 100)])
def test_reference_rules_follow_the_port(name, games, moves):
    cfg = registry.config(name)
    env, ref = P.env(cfg), make_env(cfg)
    assert (ref.action_size, ref.obs_shape) == (env.ACTION_SIZE,
                                                tuple(env.OBS_SHAPE))
    gen = torch.Generator().manual_seed(7)
    st = env.init(games, "cpu")
    refs = [ref.init() for _ in range(games)]
    ended = 0
    for _ in range(moves):
        win, valid = env.win_and_valids(st)
        obs = env.observation(st)
        items = P.state_items(st)
        for b in range(games):
            assert same_state(refs[b], game_state(items, b))
            assert np.array_equal(ref.valid(refs[b]), valid[b].numpy())
            assert np.array_equal(ref.win(refs[b]), win[b].numpy())
            assert np.array_equal(ref.obs(refs[b]), obs[b].numpy())
        done = (win > 0).any(-1)
        ended += int(done.sum())
        a = torch.multinomial(valid.float() + done[:, None].float(), 1,
                              generator=gen)[:, 0].int()
        nxt = env.step(st, a)
        fresh = env.init(games, "cpu")
        st = type(nxt)(**{
            k: torch.where(done.reshape((-1,) + (1,) * (x.dim() - 1)),
                           getattr(fresh, k), x)
            for k, x in P.state_items(nxt).items()})
        for b in range(games):
            if done[b]:
                refs[b] = ref.init()
                continue
            refs[b] = ref.step(refs[b], int(a[b]))
    assert ended > 0


def test_playouts_match_the_reference():
    gen = torch.Generator().manual_seed(3)
    out = connect4.playouts(16, 30, gen, "cpu")
    ref = connect4.Connect4
    obs = out["obs"].reshape(30, 16, 4, 6, 7).numpy()
    valid = out["valid"].reshape(30, 16, 7).numpy()
    for g in range(16):
        s = ref.init()
        for m in range(30):
            assert np.array_equal(obs[m, g], ref.obs(s))
            assert np.array_equal(valid[m, g], ref.valid(s))
            if m + 1 == 30:
                break
            nxt_obs = obs[m + 1, g]
            # Find the action the playout took: the one whose step gives
            # the next observation (or a restart after an ended game).
            cands = [a for a in np.flatnonzero(ref.valid(s))
                     if np.array_equal(ref.obs(ref.step(s, a)), nxt_obs)]
            if cands:
                s = ref.step(s, cands[0])
            else:
                ends = [a for a in np.flatnonzero(ref.valid(s))
                        if (ref.win(ref.step(s, a)) > 0).any()]
                assert ends and np.array_equal(nxt_obs, ref.obs(ref.init()))
                s = ref.init()
