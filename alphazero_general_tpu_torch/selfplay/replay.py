"""Trajectory post-processing and the replay store — the port of
alphazero_general_tpu/selfplay/replay.py (reference:
alphazero/SelfPlayAgent.pyx:176-196, Coach.py:363-386). Host numpy code,
copied so that the port never imports the JAX package.

Self-play emits fixed-shape per-move records; a reverse pass attaches each
game's final win vector to every move of that game, samples of fast moves
and of games that never finished are dropped, and each iteration's samples
are stored as ``data/<run>/iteration-NNNN.npz`` (plus ``.partKKK`` files),
the same layout as the JAX package's, so that each package loads the
other's files. Symmetry expansion runs the port's env ``symmetries`` on CPU
tensors.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from alphazero_general_tpu_torch.parallel import mesh as M
from alphazero_general_tpu_torch.utils.misc import get_iter_file


def finalize_sparse(win, done, fast, obs_f, pi_f, full_idx, symmetric: bool,
                    env) -> Tuple[np.ndarray, ...]:
    """Attach episode results to samples and expand symmetries.

    Sparse-sample form: the self-play loop only materializes observations and
    policies for non-fast move rounds (fast-sim samples are discarded anyway,
    SelfPlayAgent.pyx:84-86, 161-165), so ``obs_f [Kf, B, ...]`` /
    ``pi_f [Kf, B, A]`` cover just the ``Kf`` rounds listed in ``full_idx``
    while ``win [K, B, V]`` / ``done [K, B]`` / ``fast [K]`` cover every
    round. Returns (obs [N, C, H, W], pi [N, A], value [N, V]) float32 numpy
    arrays; samples from unfinished games are dropped.
    """
    win = np.asarray(win)
    done = np.asarray(done)
    fast = np.asarray(fast)
    K, B = done.shape
    V = win.shape[-1]

    # Reverse fill: value target of move t = win vector of the episode end at
    # or after t (episodes delimited by done flags); vectorized over B.
    values = np.zeros((K, B, V), np.float32)
    valid = np.zeros((K, B), dtype=bool)
    pending = np.zeros((B, V), np.float32)
    have = np.zeros((B,), dtype=bool)
    for t in range(K - 1, -1, -1):
        ended = done[t]
        pending[ended] = win[t][ended]
        have |= ended
        values[t] = pending
        valid[t] = have & ~fast[t]

    full_idx = np.asarray(full_idx)
    Kf = len(full_idx)
    if Kf == 0:
        A = np.asarray(pi_f).shape[-1] if np.asarray(pi_f).ndim else 0
        return (np.zeros((0,) + np.asarray(obs_f).shape[2:], np.float32),
                np.zeros((0, A), np.float32), np.zeros((0, V), np.float32))
    mask = valid[full_idx].reshape(-1)  # [Kf*B]
    obs = np.asarray(obs_f, np.float32).reshape(
        (Kf * B,) + obs_f.shape[2:])[mask]
    pi = np.asarray(pi_f, np.float32).reshape(Kf * B, -1)[mask]
    values = values[full_idx].reshape(Kf * B, V)[mask]

    if symmetric and env.NUM_SYMMETRIES > 1 and len(obs):
        obs, pi = _expand_symmetries(env, obs, pi)
        values = np.repeat(values, env.NUM_SYMMETRIES, axis=0)

    return obs.astype(np.float32), pi.astype(np.float32), values.astype(np.float32)


#: Samples per round of symmetry expansion: bounds the expansion's
#: temporary memory whatever the iteration's size.
_SYM_CHUNK = 8192


def _expand_symmetries(env, obs: np.ndarray, pi: np.ndarray,
                       out_dtype=np.float32):
    """Every sample's symmetric copies, sample-major (sample i's copies at
    rows i*S .. i*S+S-1, the identity first), through the env's
    ``symmetries`` on CPU tensors, in chunks of ``_SYM_CHUNK`` samples."""
    S = env.NUM_SYMMETRIES
    n = len(obs)
    out_o = np.empty((n * S,) + obs.shape[1:], out_dtype)
    out_p = np.empty((n * S, pi.shape[1]), out_dtype)
    for i in range(0, n, _SYM_CHUNK):
        o = torch.from_numpy(np.ascontiguousarray(obs[i:i + _SYM_CHUNK]))
        p = torch.from_numpy(np.ascontiguousarray(pi[i:i + _SYM_CHUNK]))
        ok, pk = env.symmetries(o, p)
        m = len(o)
        out_o[i * S:(i + m) * S] = ok.reshape((m * S,) + obs.shape[1:]) \
            .numpy()
        out_p[i * S:(i + m) * S] = pk.reshape(m * S, -1).numpy()
    return out_o, out_p


class StreamingFinalizer:
    """Incremental, bounded-memory finalize (SURVEY §7 stage 4's host half).

    ``finalize_sparse`` needs every round of an iteration in host RAM at
    once, so host RSS scales with rounds x batch x obs — fine at one chip,
    a pod-scale liability (VERDICT r2). This class consumes rounds as they
    stream off the device and emits finished-game samples in bounded
    flushes: memory is O(flush window + samples of still-open games), not
    O(iteration). Semantics match finalize_sparse exactly — samples from
    games that never finish are dropped, fast-round samples are never
    stored (reference: the file_queue drain + per-game history,
    SelfPlayAgent.pyx:161-196, Coach.py:363-386).

    Usage::

        fin = StreamingFinalizer(env, symmetric, sink)
        for each round: fin.add_round(win, done, fast, obs=?, pi=?)
        fin.finish()        # flushes the tail; open-game samples dropped

    ``sink(obs, pi, value)`` receives float32 batches (already
    symmetry-expanded when ``symmetric``).
    """

    #: Rounds buffered between flushes. Each flush closes every sample whose
    #: episode ends inside the window and carries the rest forward.
    WINDOW = 64

    def __init__(self, env, symmetric: bool, sink,
                 expand_at_collect: bool = True):
        """``expand_at_collect=False`` emits RAW samples and leaves the
        symmetry expansion to training time (ReplayStore.load_window with
        ``symmetric_env``): 8x less host compression/IO inline with the
        collection loop, 8x smaller sample files, identical training
        distribution (the expansion is a deterministic map applied after
        the window subsample instead of before storage)."""
        self.env = env
        self.symmetric = symmetric
        self.expand_at_collect = expand_at_collect
        self.sink = sink
        self._win = []    # per-round [B, V]
        self._done = []   # per-round [B] bool
        self._fast = []   # per-round scalar bool
        self._obs = []    # (local_round_idx, obs [B, ...]) non-fast only
        self._pi = []
        # Carried open-game samples as a LIST of (obs, pi, col) blocks (one
        # per flush window). Blocks are only copied when one of their
        # columns closes; a single concatenated carry would re-copy every
        # open sample each flush — quadratic over long-game warmups.
        self._open = []
        self.emitted = 0

    def add_round(self, win, done, fast: bool, obs=None, pi=None) -> None:
        self._win.append(np.asarray(win))
        self._done.append(np.asarray(done))
        self._fast.append(bool(fast))
        if obs is not None:
            self._obs.append((len(self._fast) - 1, np.asarray(obs)))
            self._pi.append(np.asarray(pi))
        if len(self._fast) >= self.WINDOW:
            self._flush()

    def _flush(self) -> None:
        if not self._fast:
            return
        win = np.stack(self._win)        # [K, B, V]
        done = np.stack(self._done)      # [K, B]
        fast = np.asarray(self._fast)
        K, B = done.shape
        V = win.shape[-1]
        self._win, self._done, self._fast = [], [], []

        # Reverse fill within the window (same recurrence as
        # finalize_sparse); ``have`` marks samples whose episode END lies in
        # this window — only those close now.
        values = np.zeros((K, B, V), np.float32)
        have = np.zeros((K, B), dtype=bool)
        pending = np.zeros((B, V), np.float32)
        got = np.zeros((B,), dtype=bool)
        for t in range(K - 1, -1, -1):
            ended = done[t]
            pending[ended] = win[t][ended]
            got |= ended
            values[t] = pending
            have[t] = got & ~fast[t]

        out_obs, out_pi, out_val = [], [], []

        # Carried samples from previous windows close at their column's
        # FIRST episode end in this window. Blocks with no closing column
        # pass through untouched (no copy).
        any_end = done.any(axis=0)            # [B]
        first_t = done.argmax(axis=0)         # first done time per col
        kept_blocks = []
        for o_obs, o_pi, o_col in self._open:
            closes = any_end[o_col]
            if closes.any():
                cols = o_col[closes]
                out_obs.append(o_obs[closes])
                out_pi.append(o_pi[closes])
                out_val.append(win[first_t[cols], cols].astype(np.float32))
                keep = ~closes
                if keep.any():
                    kept_blocks.append((o_obs[keep], o_pi[keep],
                                        o_col[keep]))
            else:
                kept_blocks.append((o_obs, o_pi, o_col))
        self._open = kept_blocks

        # Window samples: closed ones emit; open ones join the carry.
        if self._obs:
            full_idx = np.array([i for i, _ in self._obs])
            obs_f = np.stack([o for _, o in self._obs])   # [Kf, B, ...]
            pi_f = np.stack(self._pi)
            self._obs, self._pi = [], []
            closed = have[full_idx]                        # [Kf, B]
            flat = closed.reshape(-1)
            if flat.any():
                out_obs.append(obs_f.reshape((-1,) + obs_f.shape[2:])[flat]
                               .astype(np.float32))
                out_pi.append(pi_f.reshape(-1, pi_f.shape[-1])[flat]
                              .astype(np.float32))
                out_val.append(values[full_idx].reshape(-1, V)[flat])
            # Samples after the column's last done stay open. They are open
            # iff NO done at-or-after their round in this window.
            still = ~closed
            if still.any():
                kf, cols = np.nonzero(still)
                n_obs = obs_f.reshape((-1,) + obs_f.shape[2:])[
                    still.reshape(-1)]
                n_pi = pi_f.reshape(-1, pi_f.shape[-1])[still.reshape(-1)]
                # Fast-round samples were never materialized, so every row
                # here is a real keepable sample.
                self._open.append((n_obs, n_pi, cols))

        if out_obs:
            obs = np.concatenate(out_obs)
            pi = np.concatenate(out_pi)
            val = np.concatenate(out_val)
            if (self.symmetric and self.expand_at_collect
                    and self.env.NUM_SYMMETRIES > 1 and len(obs)):
                obs, pi = _expand_symmetries(self.env, obs, pi)
                val = np.repeat(val, self.env.NUM_SYMMETRIES, axis=0)
            self.emitted += len(obs)
            self.sink(obs.astype(np.float32), pi.astype(np.float32),
                      val.astype(np.float32))

    def finish(self) -> int:
        """Flush the tail window; drop open-game samples (identical to the
        one-shot finalize, which keeps only finished games). Returns total
        samples emitted."""
        self._flush()
        self._open = []
        return self.emitted


def finalize_trajectories(records, symmetric: bool, env) -> Tuple[np.ndarray, ...]:
    """Dense-record form of :func:`finalize_sparse`: records is a stacked
    MoveRecord pytree [K, B, ...] (time-major) carrying obs/pi for every
    round, e.g. the records of every move stacked along a new first axis."""
    done = np.asarray(records.done)
    K = done.shape[0]
    return finalize_sparse(
        records.win_state, done, np.asarray(records.fast),
        np.asarray(records.obs), np.asarray(records.pi), np.arange(K),
        symmetric, env,
    )


def game_stats_arrays(win, done) -> Tuple[np.ndarray, int, float]:
    """Wins-per-player / draws / average game length
    (reference: utils.py:34-54 get_game_results). Vectorized: episode length
    at each done flag = distance to the previous done flag in its column."""
    win = np.asarray(win)  # [K, B, V]
    done = np.asarray(done)
    V = win.shape[-1]
    finished = win[done]  # [G, V]
    wins = finished[:, : V - 1].sum(axis=0)
    draws = int(finished[:, V - 1].sum())
    b_idx, t_idx = np.nonzero(done.T)  # sorted by column, then time
    if len(t_idx):
        first = np.empty(len(b_idx), dtype=bool)
        first[0] = True
        first[1:] = b_idx[1:] != b_idx[:-1]
        prev = np.empty_like(t_idx)
        prev[0] = -1
        prev[1:] = t_idx[:-1]
        prev[first] = -1
        avg_len = float(np.mean(t_idx - prev))
    else:
        avg_len = 0.0
    return wins, draws, avg_len


def game_stats(records) -> Tuple[np.ndarray, int, float]:
    """Dense-record form of :func:`game_stats_arrays`."""
    return game_stats_arrays(records.win_state, records.done)


class ReplayStore:
    """Per-iteration sample files + growing-window loading
    (reference: Coach.py:363-386 save, 437-519 window math)."""

    def __init__(self, data_dir: str, run_name: str):
        self.folder = os.path.join(data_dir, run_name)
        os.makedirs(self.folder, exist_ok=True)
        # Under a process group of more than one rank each rank writes and
        # reads its own files, suffixed -p<rank> as the JAX package's
        # hosts do (replay.py:347-354): together they partition the
        # iteration's samples.
        self._suffix = f"-p{M.rank()}" if M.world_size() > 1 else ""

    def path(self, iteration: int) -> str:
        return os.path.join(
            self.folder, get_iter_file(iteration) + self._suffix + ".npz")

    def save(self, iteration: int, obs, pi, value) -> str:
        p = self.path(iteration)
        np.savez_compressed(p, obs=obs, pi=pi, value=value)
        return p

    def writer(self, iteration: int, obs_shape, action_size: int,
               value_size: int, raw: bool = False) -> "IterationWriter":
        """Streaming writer: appended sample batches land in part files
        (``<base>.npz.partKKK``) so collection-side host memory stays
        O(flush chunk); :meth:`load` reassembles base + parts. The shape
        args size the empty base file when nothing is appended. ``raw``
        marks the files as symmetry-UNexpanded (expansion deferred to
        :meth:`load_window` with ``symmetric_env``)."""
        return IterationWriter(self.path(iteration), obs_shape, action_size,
                               value_size, raw=raw)

    def sample_meta(self, iteration: int, symmetric_env=None):
        """(sample_count, raw_flag) for an iteration, where the count is in
        TRAINING units (raw files count x NUM_SYMMETRIES when
        ``symmetric_env`` is given) — the autoTrainSteps accounting the
        reference does by sample-tensor length (Coach.py:475-477)."""
        p = self.path(iteration)
        files = ([p] if os.path.exists(p) else []) + sorted(
            glob(p + ".part*"))
        if not files:
            return None
        n = 0
        raw = False
        for f in files:
            with np.load(f) as z:
                n += len(z["value"])
                if "raw" in z:
                    raw = raw or bool(z["raw"])
        if raw and symmetric_env is not None:
            n *= symmetric_env.NUM_SYMMETRIES
        return n, raw

    def load(self, iteration: int) -> Optional[Tuple[np.ndarray, ...]]:
        p = self.path(iteration)
        files = ([p] if os.path.exists(p) else []) + sorted(
            glob(p + ".part*"))
        if not files:
            return None
        parts = []
        for f in files:
            with np.load(f) as z:
                parts.append((z["obs"], z["pi"], z["value"]))
        if len(parts) == 1:
            return parts[0]
        return tuple(np.concatenate([pt[i] for pt in parts])
                     for i in range(3))

    def num_iterations(self) -> int:
        # Streaming part files are named <base>.npz.partKKK.npz (np.savez
        # forces the trailing .npz) — exclude them from the iteration count.
        return len([f for f in glob(os.path.join(
            self.folder, "iteration-*" + self._suffix + ".npz"))
            if ".part" not in os.path.basename(f)])

    def load_window(self, first_iter: int, last_iter: int,
                    max_samples: int = 0,
                    rng: "np.random.Generator | None" = None,
                    symmetric_env=None, expand: bool = True):
        """Concatenate samples of iterations [first_iter, last_iter].

        ``max_samples`` > 0 caps the window by UNIFORM per-iteration
        subsampling (each iteration keeps the same fraction), counted in
        TRAINING units (post-expansion). Long-game symmetric envs can emit
        millions of samples per iteration; loading several such iterations
        dense is a host-OOM (observed: 130 GB RSS → oom-kill), and the
        standard AlphaZero remedy is to train on a window SAMPLE anyway.
        0 = unlimited (the reference loads its whole window too,
        Coach.py:466-469).

        ``symmetric_env``: expand RAW (symmetry-deferred) iteration files
        by the env's symmetry group here — AFTER the subsample — so
        collection never pays the 8x expansion/compression inline (see
        StreamingFinalizer.expand_at_collect).

        ``expand=False``: count/cap in training units exactly as above but
        KEEP the rows raw — the train step applies a random symmetry per
        drawn sample on device instead (NNetWrapper.set_device_symmetries),
        so the resident window is S times smaller for the same cap and the
        host never runs the expansion gathers at all."""
        def factor(raw):
            return (symmetric_env.NUM_SYMMETRIES
                    if raw and symmetric_env is not None else 1)

        # Pass 1: counts from file metadata only — loading every iteration
        # dense before subsampling held multiple 30+ GB legacy files in RAM
        # at once (observed 85+ GB while "loading the window").
        metas = {}
        total = 0
        for i in range(first_iter, last_iter + 1):
            m = self.sample_meta(i)
            if m is not None:
                metas[i] = m
                total += m[0] * factor(m[1])
        if not metas:
            return None
        frac = (max_samples / total
                if max_samples and total > max_samples else 1.0)
        rng = rng or np.random.default_rng(0)

        # Pass 2: load → subsample → expand one iteration at a time, freeing
        # each full file before the next loads.
        expanded = []
        for i, (n_i, raw) in metas.items():
            p = self.load(i)
            if p is None:
                continue
            obs, pi, val = p
            if frac < 1.0:
                idx = rng.permutation(len(obs))[: max(1, int(len(obs) * frac))]
                idx.sort()
                obs, pi, val = obs[idx], pi[idx], val[idx]
            if factor(raw) > 1 and len(obs) and expand:
                # f16 in/out: the expanded window is the dominant train-time
                # host allocation; batches are cast to f32 at feed time.
                obs, pi = _expand_symmetries(
                    symmetric_env, obs, pi, out_dtype=np.float16)
                val = np.repeat(val, symmetric_env.NUM_SYMMETRIES, axis=0)
            expanded.append((obs, pi, val))
        obs = np.concatenate([p[0] for p in expanded])
        pi = np.concatenate([p[1] for p in expanded])
        val = np.concatenate([p[2] for p in expanded])
        return obs, pi, val


class IterationWriter:
    """Append-only sample sink for one iteration (see ReplayStore.writer).

    The first appended batch becomes the base ``.npz`` (so ordinary runs
    with one flush produce exactly the old single-file layout); subsequent
    flushes become ``.npz.partKKK`` files. ``close()`` writes an empty base
    when nothing was appended, keeping load()/num_iterations() invariants.
    """

    def __init__(self, base_path: str, obs_shape, action_size: int,
                 value_size: int, raw: bool = False):
        self.base = base_path
        self.raw = bool(raw)
        self.obs_shape = tuple(obs_shape)
        self.action_size = int(action_size)
        self.value_size = int(value_size)
        self.count = 0
        self.samples = 0
        # Stale parts from a crashed prior attempt would silently join
        # load()'s reassembly — clear them.
        for f in glob(self.base + ".part*"):
            os.remove(f)

    def append(self, obs, pi, value) -> None:
        if not len(obs):
            return
        path = (self.base if self.count == 0
                else f"{self.base}.part{self.count:03d}")
        # Stored f16: halves disk AND the training-time window RAM; board
        # planes are exactly representable and π rounds at ~0.05% (the same
        # precision the records already had on the wire).
        np.savez_compressed(path, obs=np.asarray(obs, np.float16),
                            pi=np.asarray(pi, np.float16),
                            value=np.asarray(value, np.float32),
                            raw=np.bool_(self.raw))
        self.count += 1
        self.samples += len(obs)

    def close(self) -> int:
        if self.count == 0:  # keep the one-file-per-iteration invariant
            np.savez_compressed(
                self.base,
                obs=np.zeros((0,) + self.obs_shape, np.float32),
                pi=np.zeros((0, self.action_size), np.float32),
                value=np.zeros((0, self.value_size), np.float32),
                raw=np.bool_(self.raw))
        return self.samples


def history_window(iteration: int, min_window: int, max_window: int,
                   increment_iters: int) -> int:
    """Growing history window (reference: Coach.py:510-516)."""
    return min(
        max(min_window, (iteration + min_window) // increment_iters),
        max_window,
    )


def batch_iterator(data: Tuple[np.ndarray, ...], batch_size: int,
                   rng: np.random.Generator, drop_last: bool = True
                   ) -> Iterator[Tuple[np.ndarray, ...]]:
    """Shuffled minibatches over host arrays (replaces DataLoader,
    Coach.py:466-469)."""
    obs, pi, value = data
    n = len(obs)
    order = rng.permutation(n)
    end = n - (n % batch_size) if drop_last and n >= batch_size else n
    for start in range(0, end, batch_size):
        idx = order[start : start + batch_size]
        yield obs[idx], pi[idx], value[idx]
