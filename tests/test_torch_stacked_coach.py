"""The port's Coach cycle on a stacked env against the JAX package's: a
2-iteration othello Coach with ``num_stacked_observations=2`` (the env
wrapped by ``maybe_stack`` in both packages: observations of 2 x 1 planes,
8 symmetries applied frame by frame, the past frame carried in the flat
state) at the tiny size of tests/test_torch_coach.py, with the train
batch of tests/test_torch_tafl_coach.py (64 samples, for the 8
symmetries). The port takes the JAX Coach's draws and shares its numpy
stream.

Held equal: every stored sample (obs, pi, value) of both iterations and
every metric but the timers and the losses (arena wins and draws,
winrates, the gating decision and ``self_play_iter``). Within tolerance:
the losses (rtol 1e-5).
"""

import jax
import numpy as np
import pytest
import torch

from alphazero_general_tpu.envs import get_env as j_get_env
from alphazero_general_tpu.envs.stacked import maybe_stack as j_maybe_stack
from alphazero_general_tpu.models.wrapper import NNetWrapper as JWrapper
from alphazero_general_tpu.utils import config as JC
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs.stacked import maybe_stack
from alphazero_general_tpu_torch.models import NNetWrapper
from alphazero_general_tpu_torch.utils import config as C
from test_torch_arena import JaxDraws
from test_torch_coach import (LOSS_RTOL, TINY, _dirs, _metrics,
                              _RecordingJCoach, _ReplayingCoach)

torch.set_num_threads(1)

B = TINY["process_batch_size"]
KNOBS = dict(TINY, train_batch_size=64, num_stacked_observations=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stacked_coach"))
    j_args = JC.get_args(mesh_batch_axis=1, **KNOBS, **_dirs(root, "jax"))
    j_env = j_maybe_stack(j_get_env("othello"), j_args)
    jc = _RecordingJCoach(j_env, JWrapper(j_env, j_args), j_args)
    jc.np_states, jc.calib_seen = [], []
    jc.learn()

    args = C.get_args(**KNOBS, **_dirs(root, "port"))
    env = maybe_stack(get_env("othello"), args)
    net = NNetWrapper(env, args, device="cpu")
    net.load_jax_variables(jax.device_get(
        JWrapper(j_env, j_args).state.variables))
    tc = _ReplayingCoach(env, net, args, draws=JaxDraws(TINY["seed"]))
    tc.np_states, tc.calib_seen = list(jc.np_states), []
    tc.learn()
    return root, jc, tc, env


def test_two_iteration_stacked_othello_coach_matches_jax(runs):
    root, jc, tc, env = runs
    assert env.NAME == "othello_x2" and env.OBS_SHAPE == (2, 8, 8)
    for it in (1, 2):
        want, got = jc.store.load(it), tc.store.load(it)
        assert len(got[0]) > 0 and got[0].shape[1:] == env.OBS_SHAPE
        for x, y, name in zip(got, want, ("obs", "pi", "value")):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=f"iter {it} {name}")
        # the stacked frame holds the previous position past the first move
        assert (got[0][:, 1] != 0).any()
    assert tc.self_play_iter == jc.self_play_iter
    assert tc.gating_counter == jc.gating_counter
    assert tc.model_iter == jc.model_iter == 3
    jm, tm = _metrics(root, "jax"), _metrics(root, "port")
    for key, want in jm.items():
        tag = key[0]
        if tag.startswith(("time/", "loss/sample_time")):
            continue
        if tag in ("loss/policy", "loss/value", "loss/total"):
            np.testing.assert_allclose(tm[key], want, rtol=LOSS_RTOL,
                                       err_msg=str(key))
        else:
            assert tm[key] == want, key
    for it in (1, 2):
        for kind in ("baseline", "past"):
            assert tm[(f"arena_{kind}/wins_new", it)] + \
                tm[(f"arena_{kind}/wins_other", it)] + \
                tm[(f"arena_{kind}/draws", it)] == B
