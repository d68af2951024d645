"""The port's Coach cycle against the JAX package's.

A 2-iteration connect4 Coach at a tiny size (the single-device leg of
``__graft_entry__.dryrun_multichip``: 4 games, 6 full / 3 fast / 4 warmup
simulations, an 8-channel ResNet of one block, float32) runs in both
packages, from the same initial weights. The port takes the JAX Coach's
draws (``JaxDraws``, recomputed
from its key stream) and shares its numpy stream, whose draws both Coaches
make in the same order. One exception: the JAX train loop's batch producer
thread draws a few batches ahead of the steps and is stopped at a point
that depends on thread timing, so the numpy stream's state after each
training is taken from the JAX run.

Held equal: every stored sample (obs, pi, value) of both iterations, the
arena winrates, the gating decisions and ``self_play_iter``. The same
Coach at the JAX default ``quant_selfplay=True`` plays the int8 tower in
both arenas of both iterations (calibrated on random playouts, then on
iteration 1's replay) and in iteration 2's self-play, and is held to the
same equalities. Within
tolerance: the losses (rtol 1e-5) and the trained weights and batch
statistics (atol 1e-5), where float32 sums in another order compound over
the train steps. Iteration 1 is a warmup iteration; the trained model is
promoted, so iteration 2 plays it, in fast and full moves.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from alphazero_general_tpu.envs import get_env as j_get_env
from alphazero_general_tpu.models.wrapper import NNetWrapper as JWrapper
from alphazero_general_tpu.train import Coach as JCoach
from alphazero_general_tpu.utils import config as JC
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.models import NNetWrapper
from alphazero_general_tpu_torch.selfplay.replay import ReplayStore
from alphazero_general_tpu_torch.train import Coach
from alphazero_general_tpu_torch.utils import config as C
from alphazero_general_tpu_torch.utils.convert import resnet_state_dict
from test_torch_arena import JaxDraws

# Small tensors: one intra-op thread. Several test processes share the
# host's cores, and idle OpenMP threads that spin while waiting slow every
# process down many times over.
torch.set_num_threads(1)

B = 4
TINY = dict(
    seed=3, numIters=2, numWarmupIters=1,
    process_batch_size=B, gamesPerIteration=B,
    numMCTSSims=6, numFastSims=3, numWarmupSims=4, probFastSim=0.5,
    train_batch_size=B, arenaCompare=B, arenaCompareBaseline=B,
    num_channels=8, depth=1, value_head_channels=2, policy_head_channels=2,
    value_dense_layers=[8], policy_dense_layers=[8],
    compute_dtype="float32", quant_selfplay=False, deviceWindowRows=16384,
    # Promote at an even past arena, so that iteration 2 plays the trained
    # network (fast and full moves) rather than warmup moves again.
    min_next_model_winrate=0.5,
)
#: Losses: float32 sums of another order over a few dozen steps (seen:
#: 3.2e-7 relative).
LOSS_RTOL = 1e-5
#: Trained weights and batch statistics after two iterations of SGD (about
#: 70 steps; seen: 1.3e-6).
WEIGHT_ATOL = 1e-5


def _dirs(root, tag):
    return dict(run_name=tag, checkpoint=os.path.join(root, "checkpoint"),
                data=os.path.join(root, "data"),
                log_dir=os.path.join(root, "runs"))


def _metrics(root, tag):
    out = {}
    with open(os.path.join(root, "runs", tag, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            out[(r["tag"], r["step"])] = r["value"]
    return out


class _RecordingJCoach(JCoach):
    def train(self, iteration):
        super().train(iteration)
        self.np_states.append(copy.deepcopy(self._np_rng.bit_generator.state))

    def _quant_calib_obs(self, iteration, max_obs=8192):
        out = super()._quant_calib_obs(iteration, max_obs)
        self.calib_seen.append(None if out is None else np.asarray(out))
        return out


class _ReplayingCoach(Coach):
    def train(self, iteration):
        super().train(iteration)
        self._np_rng.bit_generator.state = self.np_states.pop(0)

    def _quant_calib_obs(self, iteration, max_obs=8192):
        out = super()._quant_calib_obs(iteration, max_obs)
        self.calib_seen.append(None if out is None else out.cpu().numpy())
        return out


def _run_both(root, knobs, tag):
    """The JAX Coach and the port's (JAX's initial weights and draws) of
    ``knobs``, each run to its end in ``root``."""
    j_args = JC.get_args(mesh_batch_axis=1, **knobs, **_dirs(root, "j" + tag))
    j_env = j_get_env("connect4")
    jc = _RecordingJCoach(j_env, JWrapper(j_env, j_args), j_args)
    jc.np_states, jc.calib_seen = [], []
    jc.learn()

    args = C.get_args(**knobs, **_dirs(root, "t" + tag))
    env = get_env("connect4")
    net = NNetWrapper(env, args, device="cpu")
    net.load_jax_variables(jax.device_get(
        JWrapper(j_env, j_args).state.variables))
    tc = _ReplayingCoach(env, net, args, draws=JaxDraws(knobs["seed"]))
    tc.np_states, tc.calib_seen = list(jc.np_states), []
    tc.learn()
    return jc, tc


def _assert_same_run(root, jc, tc, tag, iters):
    """Every sample, the gating state and every JAX metric equal (losses
    within LOSS_RTOL)."""
    for it in range(1, iters + 1):
        want, got = jc.store.load(it), tc.store.load(it)
        assert len(got[0]) > 0
        for x, y, name in zip(got, want, ("obs", "pi", "value")):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=f"iter {it} {name}")
    assert tc.self_play_iter == jc.self_play_iter
    assert tc.gating_counter == jc.gating_counter
    jm, tm = _metrics(root, "j" + tag), _metrics(root, "t" + tag)
    for key, want in jm.items():
        if key[0].startswith(("time/", "loss/sample_time")):
            continue
        if key[0] in ("loss/policy", "loss/value", "loss/total"):
            np.testing.assert_allclose(tm[key], want, rtol=LOSS_RTOL,
                                       err_msg=str(key))
        else:
            assert tm[key] == want, key
    return tm


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coach"))
    j_args = JC.get_args(mesh_batch_axis=1, **TINY, **_dirs(root, "jax"))
    j_env = j_get_env("connect4")
    jc = _RecordingJCoach(j_env, JWrapper(j_env, j_args), j_args)
    jc.np_states = []
    jc.learn()

    args = C.get_args(**TINY, **_dirs(root, "port"))
    env = get_env("connect4")
    # The JAX Coach's initial weights (its wrapper initialises them from
    # the seed), converted.
    net = NNetWrapper(env, args, device="cpu")
    net.load_jax_variables(jax.device_get(
        JWrapper(j_env, j_args).state.variables))
    tc = _ReplayingCoach(env, net, args, draws=JaxDraws(TINY["seed"]))
    tc.np_states = list(jc.np_states)
    tc.learn()
    return root, jc, tc


def test_two_iteration_coach_matches_jax(runs):
    root, jc, tc = runs
    for it in (1, 2):
        want = jc.store.load(it)
        got = tc.store.load(it)
        assert len(got[0]) > 0
        for x, y, name in zip(got, want, ("obs", "pi", "value")):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=f"iter {it} {name}")
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
    assert tm[("train/steps", 1)] * B == tm[("train/samples_seen", 1)]

    # Trained weights of the last checkpoint, through utils/convert.py.
    jnet = JWrapper(j_get_env("connect4"), jc.args)
    jnet.load_checkpoint(jc.ckpt_folder, "iteration-0002")
    want = resnet_state_dict(jax.device_get(jnet.state))
    got = tc.train_net.model.state_dict()
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   atol=WEIGHT_ATOL, rtol=0, err_msg=name)
    # Iteration 1 searched warmup moves of 4 simulations; iteration 2 fast
    # moves of 3 and at least one full move of 6.
    moves, sims = tm[("self_play/moves", 1)], tm[("self_play/simulations", 1)]
    assert sims == 4 * moves
    moves, sims = tm[("self_play/moves", 2)], tm[("self_play/simulations", 2)]
    assert 3 * moves < sims < 6 * moves
    for it in (1, 2):
        assert tm[("self_play/samples", it)] == len(tc.store.load(it)[0])
        for kind in ("baseline", "past"):
            assert tm[(f"arena_{kind}/wins_new", it)] + \
                tm[(f"arena_{kind}/wins_other", it)] + \
                tm[(f"arena_{kind}/draws", it)] == B

@pytest.fixture(scope="module")
def quant_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coach_int8"))
    from alphazero_general_tpu_torch.models.quant import QuantResNet

    before = QuantResNet.forwards
    jc, tc = _run_both(root, dict(TINY, quant_selfplay=True), "q")
    return root, jc, tc, QuantResNet.forwards - before


def test_int8_coach_matches_jax(quant_runs):
    """The 2-iteration Coach at ``quant_selfplay=True``: the same samples
    (iteration 2 from int8 self-play), arena results and gating as the JAX
    Coach; both packages quantized for both arenas of both iterations and
    for iteration 2's self-play, calibrated on the same rows."""
    root, jc, tc, forwards = quant_runs
    tm = _assert_same_run(root, jc, tc, "q", 2)
    assert jc._quant_ok is True and tc._quant_ok is True
    assert "fns_quant" in jc._chunk_fns
    assert "q" in jc._arena_fn and "q" in jc._baseline_fn
    assert [tm[("self_play/int8", it)] for it in (1, 2)] == [0.0, 1.0]
    for it in (1, 2):
        for kind in ("baseline", "past"):
            assert tm[(f"arena_{kind}/int8", it)] == 1.0
    # One forward per simulation in self-play; per arena round and
    # simulation, one for the baseline arena and two (both seats) for the
    # past arena.
    sims = int(TINY["numMCTSSims"])
    assert forwards == tm[("self_play/simulations", 2)] + sum(
        tm[(f"arena_{kind}/rounds", it)] * sims * seats
        for it in (1, 2) for kind, seats in (("baseline", 1), ("past", 2)))
    # Calibrations: the three of iteration 1's arenas on random playouts,
    # then iteration 2's self-play and arenas on iteration 1's replay.
    assert len(tc.calib_seen) == len(jc.calib_seen) == 7
    assert tc.draws.calibrations == 7
    for got, want in zip(tc.calib_seen, jc.calib_seen):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    # A window larger than max_obs: the same rows drawn from the same
    # numpy state.
    for c in (jc, tc):
        c._np_rng = np.random.default_rng(11)
    np.testing.assert_array_equal(
        tc._quant_calib_obs(3, max_obs=16).cpu().numpy(),
        np.asarray(jc._quant_calib_obs(3, max_obs=16)))


def test_groupnorm_coach_plays_the_float_tower(tmp_path):
    """GroupNorm has no int8 path: at ``quant_selfplay=True`` both
    packages' Coaches find that at the first arena and play the float
    tower, with the same results."""
    jc, tc = _run_both(str(tmp_path), dict(
        TINY, quant_selfplay=True, norm="groupnorm", numIters=1), "g")
    tm = _assert_same_run(str(tmp_path), jc, tc, "g", 1)
    assert jc._quant_ok is False and tc._quant_ok is False
    assert tm[("arena_baseline/int8", 1)] == tm[("arena_past/int8", 1)] == 0


def test_coach_resumes_in_a_fresh_coach(runs):
    root, _, tc = runs
    args = C.get_args(**TINY, **_dirs(root, "port"))
    env = get_env("connect4")
    fresh = Coach(env, NNetWrapper(env, args, device="cpu"), args)
    assert fresh.model_iter == 3 and fresh.args.startIter == 3
    assert fresh.self_play_iter == tc.self_play_iter
    for (k, x), y in zip(fresh.train_net.model.state_dict().items(),
                         tc.train_net.model.state_dict().values()):
        assert torch.equal(x, y), k
    assert fresh.train_net.step == tc.train_net.step > 0
    obs = torch.rand(3, 4, 6, 7)
    for a, b in zip(fresh.self_play_net.process(obs),
                    tc.self_play_net.process(obs)):
        assert torch.equal(a, b)


def test_samples_load_in_both_packages(runs):
    """Each package's replay store loads the other's npz files."""
    root, jc, tc = runs
    from alphazero_general_tpu.selfplay.replay import ReplayStore as JStore

    for it in (1, 2):
        a = JStore(os.path.join(root, "data"), "port").load(it)
        b = ReplayStore(os.path.join(root, "data"), "jax").load(it)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_train_on_past_data_matches_jax(runs):
    """``train_on_past_data``: a new run's first iteration skips self-play
    and trains on a previous run's sample files (here both iterations in
    one chunk, symmetries expanded on the host); from the same initial
    weights and the same numpy seed, the losses and the trained weights
    agree with the JAX Coach's."""
    root = runs[0]
    knobs = dict(TINY, numIters=1, train_on_past_data=True,
                 past_data_run_name="jax",
                 compareWithBaseline=False, compareWithPast=False)
    j_args = JC.get_args(mesh_batch_axis=1, **knobs, **_dirs(root, "jpast"))
    j_env = j_get_env("connect4")
    jc = JCoach(j_env, JWrapper(j_env, j_args), j_args)
    jc.learn()
    args = C.get_args(**knobs, **_dirs(root, "tpast"))
    env = get_env("connect4")
    net = NNetWrapper(env, args, device="cpu")
    net.load_jax_variables(jax.device_get(
        JWrapper(j_env, j_args).state.variables))
    tc = Coach(env, net, args)
    tc.learn()
    assert tc.store.load(1) is None  # no self-play ran
    np.testing.assert_allclose((tc.loss_pi, tc.loss_v),
                               (jc.loss_pi, jc.loss_v), rtol=LOSS_RTOL)
    want = resnet_state_dict(jax.device_get(jc.train_net.state))
    got = tc.train_net.model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   atol=WEIGHT_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("rule,wins,draws,cap,counter", [
    ("reference", (70, 50), 8, None, 0),    # 0.578: promote
    ("reference", (60, 60), 8, None, 2),    # 0.5: keep, count on
    ("reference", (60, 60), 8, 2, 2),       # cap reached: promote anyway
    ("decided", (20, 10), 98, None, 0),     # 0.667 of 30 decided: promote
    ("decided", (10, 4), 114, None, 0),     # 14 < gateMinDecided: keep
    ("off", (100, 20), 8, None, 0),         # model_gating=False
], ids=["ref_pass", "ref_keep", "ref_cap", "decided_pass",
        "decided_too_few", "gating_off"])
def test_gating_decisions_match_jax(tmp_path, rule, wins, draws, cap,
                                    counter):
    """The gate after a past arena (gatingRule "reference" and "decided",
    max_gating_iters, model_gating off), given the same arena result:
    self_play_iter, gating_counter and the logged winrates equal JAX's."""
    from alphazero_general_tpu.selfplay.arena import ArenaResult as JResult
    from alphazero_general_tpu_torch.selfplay.arena import ArenaResult

    knobs = dict(TINY, max_gating_iters=cap, min_next_model_winrate=0.52,
                 gatingRule="decided" if rule == "decided" else "reference",
                 model_gating=rule != "off")
    n = sum(wins) + draws
    j_args = JC.get_args(mesh_batch_axis=1, **knobs,
                         **_dirs(str(tmp_path), "jax"))
    j_env = j_get_env("connect4")
    jc = JCoach(j_env, JWrapper(j_env, j_args), j_args)
    jc._save_model(jc.train_net, 1)
    jc._arena_fn = {"f": lambda a, b, rng: JResult(
        model_wins=jax.numpy.asarray(wins, jax.numpy.float32),
        draws=jax.numpy.float32(draws),
        avg_game_length=jax.numpy.float32(20), num_games=jax.numpy.int32(n))}
    args = C.get_args(**knobs, **_dirs(str(tmp_path), "port"))
    env = get_env("connect4")
    tc = Coach(env, NNetWrapper(env, args, device="cpu"), args)
    tc._save_model(tc.train_net, 1)
    tc._arena = lambda kind, quant=False: ArenaResult(
        model_wins=torch.tensor(wins, dtype=torch.float32), draws=draws,
        avg_game_length=20.0, num_games=n, rounds=1)
    for c in (jc, tc):
        c.gating_counter = counter
        c.compare_to_past(1)
        c.writer.close()
    assert tc.self_play_iter == jc.self_play_iter
    assert tc.gating_counter == jc.gating_counter
    jm, tm = _metrics(str(tmp_path), "jax"), _metrics(str(tmp_path), "port")
    for tag in ("win_rate/past", "win_rate/past_decided"):
        assert tm[(tag, 1)] == jm[(tag, 1)]
