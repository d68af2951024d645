"""The port's Coach cycle on brandubh against the JAX package's.

A 2-iteration brandubh Coach (A = 588: the sparse top-k policy records of
both packages, densified on the host before the finalizer; 8 symmetries;
draws at the 100-move cap) at a tiny size: 4 games, 6 full / 3 fast /
4 warmup simulations, an 8-channel ResNet of one block, float32. As in
tests/test_torch_coach.py, the port takes the JAX Coach's draws and shares
its numpy stream, whose state after each training is taken from the JAX
run.

The train batch is 64 samples where the connect4 test takes 4: brandubh's
8 symmetries would make autoTrainSteps take about 300 steps of 4 samples
an iteration, and over that many steps of training-mode BatchNorm on 4
samples the float32 rounding differences of the two frameworks grow from
the last bit to the fourth decimal of the weights, enough to reorder
near-equal priors in the next iteration's searches (with batches of 4,
iteration 2's games part ways). At 64 samples an iteration trains about
20 steps.

Held equal: every stored sample (obs, pi, value) of both iterations, every
metric but the timers and the losses (arena wins and draws, winrates, the
gating decision and ``self_play_iter``). Within tolerance: the losses
(rtol 1e-5) and the trained weights and batch statistics (atol 1e-5),
where float32 sums in another order compound over the train steps.
"""

import os

import jax
import numpy as np
import pytest
import torch

from alphazero_general_tpu.envs import get_env as j_get_env
from alphazero_general_tpu.models.wrapper import NNetWrapper as JWrapper
from alphazero_general_tpu.utils import config as JC
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.models import NNetWrapper
from alphazero_general_tpu_torch.utils import config as C
from alphazero_general_tpu_torch.utils.convert import resnet_state_dict
from test_torch_arena import JaxDraws
from test_torch_coach import (LOSS_RTOL, TINY, WEIGHT_ATOL, _dirs, _metrics,
                              _RecordingJCoach, _ReplayingCoach)

torch.set_num_threads(1)

B = TINY["process_batch_size"]
KNOBS = dict(TINY, train_batch_size=64)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tafl_coach"))
    j_args = JC.get_args(mesh_batch_axis=1, **KNOBS, **_dirs(root, "jax"))
    j_env = j_get_env("brandubh")
    jc = _RecordingJCoach(j_env, JWrapper(j_env, j_args), j_args)
    jc.np_states = []
    jc.learn()

    args = C.get_args(**KNOBS, **_dirs(root, "port"))
    env = get_env("brandubh")
    net = NNetWrapper(env, args, device="cpu")
    net.load_jax_variables(jax.device_get(
        JWrapper(j_env, j_args).state.variables))
    tc = _ReplayingCoach(env, net, args, draws=JaxDraws(TINY["seed"]))
    tc.np_states = list(jc.np_states)
    tc.learn()
    return root, jc, tc


def test_two_iteration_brandubh_coach_matches_jax(runs):
    root, jc, tc = runs
    env = get_env("brandubh")
    for it in (1, 2):
        want = jc.store.load(it)
        got = tc.store.load(it)
        assert len(got[0]) > 0
        assert got[1].shape[1] == env.ACTION_SIZE == 588  # dense pi rows
        for x, y, name in zip(got, want, ("obs", "pi", "value")):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=f"iter {it} {name}")
        np.testing.assert_allclose(got[1].astype(np.float32).sum(-1), 1.0,
                                   rtol=0, atol=2**-11)
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
    # Iteration 1 searched warmup moves of 4 simulations; iteration 2 the
    # promoted network's fast moves of 3 and full moves of 6.
    moves, sims = tm[("self_play/moves", 1)], tm[("self_play/simulations", 1)]
    assert sims == 4 * moves
    moves, sims = tm[("self_play/moves", 2)], tm[("self_play/simulations", 2)]
    assert 3 * moves < sims < 6 * moves
    for it in (1, 2):
        for kind in ("baseline", "past"):
            assert tm[(f"arena_{kind}/wins_new", it)] + \
                tm[(f"arena_{kind}/wins_other", it)] + \
                tm[(f"arena_{kind}/draws", it)] == B

    # Trained weights of the last checkpoint, through utils/convert.py.
    jnet = JWrapper(j_get_env("brandubh"), jc.args)
    jnet.load_checkpoint(jc.ckpt_folder, "iteration-0002")
    want = resnet_state_dict(jax.device_get(jnet.state))
    got = tc.train_net.model.state_dict()
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   atol=WEIGHT_ATOL, rtol=0, err_msg=name)


def test_brandubh_samples_load_in_both_packages(runs):
    """Each package's replay store loads the other's npz files."""
    from alphazero_general_tpu.selfplay.replay import ReplayStore as JStore
    from alphazero_general_tpu_torch.selfplay.replay import ReplayStore

    root = runs[0]
    for it in (1, 2):
        a = JStore(os.path.join(root, "data"), "port").load(it)
        b = ReplayStore(os.path.join(root, "data"), "jax").load(it)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
