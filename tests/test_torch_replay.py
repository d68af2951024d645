"""The port's replay path against the JAX package's, on the same move
records: the finalizers, game statistics, the replay store and its window,
batch order from the same numpy seed, npz files written by one package and
read by the other, and the device window (on the CPU). Every array must be
equal."""

import numpy as np
import pytest
import torch

import alphazero_general_tpu.selfplay.replay as JR
from alphazero_general_tpu.envs.connect4 import Connect4 as JConnect4
from alphazero_general_tpu.selfplay.device_window import DeviceWindow as JDW
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.selfplay import replay as R
from alphazero_general_tpu_torch.selfplay.device_window import DeviceWindow

# Small tensors: one intra-op thread. Several test processes share the
# host's cores, and idle OpenMP threads that spin while waiting slow every
# process down many times over.
torch.set_num_threads(1)

ENV = get_env("connect4")
K, B, V = 150, 6, 3


def move_records(seed=0, fast_p=0.5):
    """Records of K lockstep rounds of B games: games end at random rounds
    with a win for either player or a draw; fast rounds carry no obs/pi."""
    rng = np.random.default_rng(seed)
    done = rng.random((K, B)) < 0.08
    outcome = np.eye(V, dtype=np.float32)[rng.integers(0, V, (K, B))]
    win = np.where(done[..., None], outcome, 0).astype(np.float32)
    fast = rng.random(K) < fast_p
    full_idx = np.flatnonzero(~fast)
    obs = rng.integers(0, 2, (len(full_idx), B, 4, 6, 7)).astype(np.float16)
    pi = rng.dirichlet(np.ones(7), (len(full_idx), B)).astype(np.float16)
    return win, done, fast, full_idx, obs, pi


def _stream(module, env, symmetric, expand, rec):
    win, done, fast, full_idx, obs, pi = rec
    out = []
    fin = module.StreamingFinalizer(env, symmetric, lambda *a: out.append(a),
                                    expand_at_collect=expand)
    j = 0
    for t in range(K):
        if fast[t]:
            fin.add_round(win[t], done[t], True)
        else:
            fin.add_round(win[t], done[t], False, obs=obs[j], pi=pi[j])
            j += 1
    n = fin.finish()
    arrays = [np.concatenate([o[i] for o in out]) for i in range(3)]
    assert n == len(arrays[0])
    return arrays


@pytest.mark.parametrize("symmetric,expand", [(False, False), (True, True),
                                              (True, False)])
def test_streaming_finalizer_matches_jax(symmetric, expand):
    rec = move_records(seed=1)
    got = _stream(R, ENV, symmetric, expand, rec)
    want = _stream(JR, JConnect4, symmetric, expand, rec)
    assert len(got[0]) > 0
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    # Values are one-hot or a draw; each row of pi sums to 1 (float16).
    assert np.array_equal(got[2].sum(-1), np.ones(len(got[2])))
    np.testing.assert_allclose(got[1].sum(-1), 1, atol=2**-10)


def test_finalize_sparse_and_trajectories_match_jax():
    win, done, fast, full_idx, obs, pi = move_records(seed=2)
    for symmetric in (False, True):
        got = R.finalize_sparse(win, done, fast, obs, pi, full_idx,
                                symmetric, ENV)
        want = JR.finalize_sparse(win, done, fast, obs, pi, full_idx,
                                  symmetric, JConnect4)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
        # The streaming finalizer emits the same samples, in its own order.
        streamed = _stream(R, ENV, symmetric, True, (win, done, fast,
                                                     full_idx, obs, pi))
        assert sorted(map(bytes, got[0])) == sorted(map(bytes, streamed[0]))

    class Records:
        pass

    dense = Records()
    rng = np.random.default_rng(3)
    dense.win_state, dense.done = win, done
    dense.fast = np.zeros(K, bool)
    dense.obs = rng.integers(0, 2, (K, B, 4, 6, 7)).astype(np.float32)
    dense.pi = rng.dirichlet(np.ones(7), (K, B)).astype(np.float32)
    for x, y in zip(R.finalize_trajectories(dense, True, ENV),
                    JR.finalize_trajectories(dense, True, JConnect4)):
        np.testing.assert_array_equal(x, y)


def test_game_stats_and_history_window_match_jax():
    win, done, *_ = move_records(seed=4)
    got = R.game_stats_arrays(win, done)
    want = JR.game_stats_arrays(win, done)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    for it in range(1, 60):
        assert R.history_window(it, 4, 20, 2) == \
            JR.history_window(it, 4, 20, 2)


def _write_iterations(store, seed):
    rng = np.random.default_rng(seed)
    for it, sizes in ((1, [30, 11]), (2, []), (3, [25])):
        w = store.writer(it, (4, 6, 7), 7, V, raw=True)
        for n in sizes:
            w.append(rng.integers(0, 2, (n, 4, 6, 7)).astype(np.float32),
                     rng.dirichlet(np.ones(7), n).astype(np.float32),
                     np.eye(V, dtype=np.float32)[rng.integers(0, V, n)])
        assert w.close() == sum(sizes)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_replay_store_cross_loads_and_windows_match(tmp_path, writer):
    """Files written by either package (a base file, a part file, an empty
    iteration) load equal in both; sample counts, windows (capped, symmetric
    expanded or raw) and batch order match from the same numpy seed."""
    port = R.ReplayStore(str(tmp_path), "run")
    jax_ = JR.ReplayStore(str(tmp_path), "run")
    _write_iterations(port if writer == "port" else jax_, seed=5)
    assert port.num_iterations() == jax_.num_iterations() == 3
    for it in (1, 2, 3, 4):
        a, b = port.load(it), jax_.load(it)
        assert (a is None) == (b is None)
        if a is not None:
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        for env_p, env_j in ((None, None), (ENV, JConnect4)):
            assert port.sample_meta(it, env_p) == jax_.sample_meta(it, env_j)
    for kw in (dict(), dict(max_samples=40), dict(expand=False),
               dict(max_samples=50, expand=False)):
        got = port.load_window(1, 3, rng=np.random.default_rng(9),
                               symmetric_env=ENV, **kw)
        want = jax_.load_window(1, 3, rng=np.random.default_rng(9),
                                symmetric_env=JConnect4, **kw)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    data = port.load(1)
    got = list(R.batch_iterator(data, 8, np.random.default_rng(1)))
    want = list(JR.batch_iterator(data, 8, np.random.default_rng(1)))
    assert len(got) == len(want) == len(data[0]) // 8
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)


def test_device_window_matches_jax_on_cpu(tmp_path):
    """The same uploads (with padding, a wrap that evicts the oldest
    iteration, and a sync from the store) leave the same resident rows,
    indices and buffer contents in both rings."""
    jw = JDW((4, 6, 7), 7, V, rows=80, chunk=16)
    tw = DeviceWindow((4, 6, 7), 7, V, rows=80, chunk=16, device="cpu")
    assert tw.rows == jw.rows == 80 and tw.nbytes == jw.nbytes
    rng = np.random.default_rng(6)
    for it, n in ((1, 20), (2, 30), (3, 7), (4, 25)):
        rows = (rng.integers(0, 2, (n, 4, 6, 7)).astype(np.float16),
                rng.dirichlet(np.ones(7), n).astype(np.float16),
                np.eye(V, dtype=np.float32)[rng.integers(0, V, n)])
        assert tw.add_iteration(it, *rows) == jw.add_iteration(it, *rows)
        assert tw.segments == jw.segments and tw.cursor == jw.cursor
    assert not tw.has_iteration(1)  # the wrap evicted it
    for first in (1, 2, 3):
        np.testing.assert_array_equal(tw.indices_for(first, 4),
                                      jw.indices_for(first, 4))
    idx = tw.indices_for(1, 4)
    for t, j in zip(tw.buffers, jw.buffers):
        assert t.dtype == torch.float16 or t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy()[idx], np.asarray(j)[idx])

    store = R.ReplayStore(str(tmp_path), "run")
    _write_iterations(store, seed=7)
    jw2 = JDW((4, 6, 7), 7, V, rows=64, chunk=16)
    tw2 = DeviceWindow((4, 6, 7), 7, V, rows=64, chunk=16, device="cpu")
    tw2.sync(store, 1, 3)
    jw2.sync(JR.ReplayStore(str(tmp_path), "run"), 1, 3)
    tw2.drop_before(2)
    jw2.drop_before(2)
    assert tw2.segments == jw2.segments
    idx = tw2.indices_for(1, 3)
    np.testing.assert_array_equal(idx, jw2.indices_for(1, 3))
    for t, j in zip(tw2.buffers, jw2.buffers):
        np.testing.assert_array_equal(t.numpy()[idx], np.asarray(j)[idx])
