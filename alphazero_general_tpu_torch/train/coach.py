"""Coach — the training loop, the port of alphazero_general_tpu/train/
coach.py (reference: alphazero/Coach.py:153-591), on one device or
data-parallel over the ranks of a process group.

One iteration: self-play until ``gamesPerIteration`` games have finished
(warmup iterations search with the uniform evaluation instead of the
network), the samples streamed into the iteration's npz files; training
over the growing history window; an arena against the RawMCTS baseline; an
arena against the gated self-play model and the gating decision; then the
run state. Iteration structure, gating rules, window, resume and metric
tags are the JAX package's.

With ``quant_selfplay`` (the default) self-play after the warmup and both
arenas (unless ``quant_arena`` is False) play the int8 tower
(models/quant.py), re-quantized from the current weights each time and
calibrated on the newest earlier iteration's replay observations (random
playouts before there is one); the past arena puts it on both seats. An
architecture without an int8 path (the FC net, GroupNorm) plays the float
tower, as in the JAX package (its tri-state ``_quant_ok``); the Coach says
so once. The metrics ``self_play/int8`` and ``arena_<kind>/int8`` record
which tower played.

Random streams: ``_np_rng`` is the JAX Coach's numpy stream, drawn in the
same order (the fast/full coin of each move, the window permutations and
the symmetry indices of the train batches). The JAX Coach's key stream
becomes ``generator``, a ``torch.Generator`` on the device seeded with
``seed + 1``. A ``draws`` hook, for tests, supplies the draws of self-play
and arena moves instead: ``draws.selfplay(kind, sims, valids)`` returns a
``MoveDraws`` for one self-play move and ``draws.arena()`` a per-round
function ``(t, sims, valids) -> MoveDraws`` for one arena;
``draws.calibration()`` takes the draw of one re-quantization (the JAX
Coach draws a key for each) and returns a function that gives the random
playouts' actions [moves, batch], called only where no replay calibrates.

Data parallelism (parallel/mesh.py; JAX coach.py:81-99): under a process
group of W ranks (one a device), ``process_batch_size``,
``train_batch_size`` and both arenas' games are global and each rank
holds 1/W of them: its games, whose draws are the global batch's cut to
them (``parallel.GameShard``, so the games are those of one rank), its own
sample files (``-p<rank>``), and its share of each train batch drawn from
them. The weights stay equal on every rank (broadcast at start and after
every load, gradients averaged, BatchNorm over the global batch), and every
rank takes the same decisions: the fast/full coins from the numpy stream,
seeded alike; the exit from self-play on the global finished-game count;
the train step count (the min over the ranks); and the gating decision
from the summed arena results. What depends on a rank's own files (the
window and calibration subsamples, the batch order and the symmetry
indices) draws from a stream of its own, ``np.random.default_rng([seed,
rank])``, which keeps the shared stream in step. Rank 0 writes the
checkpoints (the others wait at a barrier), the run state and the metrics.
There is no device window under W > 1 (JAX coach.py:520-526).

Status and control (JAX coach.py:57-70, 131-134), for the GUI's train
panel: ``state`` is the phase the Coach is in (``TrainState``), set where
the JAX Coach sets it. ``stop_train`` ends ``learn`` after the phase it is
in, and self-play before its next move (the moves enqueued are read and
the games that have ended keep their samples); while ``pause_train`` is
set, self-play makes no move. Under W ranks rank 0 decides for all: its
stop rides in the finished-game count that every rank reads a move
(``_progress``, no collective more), and between phases in one max
all-reduce; its pause holds it before its next move, and the other ranks
wait in that move's all-reduce. Every rank leaves on the same move and
after the same phase.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from enum import Enum
from glob import glob
from math import ceil

import numpy as np
import torch

from alphazero_general_tpu_torch.models.wrapper import NNetWrapper
from alphazero_general_tpu_torch.parallel import mesh as M
from alphazero_general_tpu_torch.selfplay.arena import (
    ArenaConfig, make_arena_fn, raw_mcts_apply, winrates,
)
from alphazero_general_tpu_torch.selfplay.device_window import DeviceWindow
from alphazero_general_tpu_torch.selfplay.replay import (
    ReplayStore, StreamingFinalizer, batch_iterator, game_stats_arrays,
    history_window,
)
from alphazero_general_tpu_torch.selfplay.selfplay import (
    SelfPlayConfig, densify_pi, init_selfplay, make_move_fns,
)
from alphazero_general_tpu_torch.utils.config import Args, check_ported
from alphazero_general_tpu_torch.utils.metrics import make_writer
from alphazero_general_tpu_torch.utils.misc import Bar, get_iter_file
from alphazero_general_tpu_torch.utils.trace import PhaseTracer

#: Self-play moves enqueued ahead of the oldest one the host reads back.
PIPE = 8


class TrainState(Enum):
    """Status surface polled by UIs (reference: Coach.py:129-139)."""

    STANDBY = 0
    INIT = 1
    INIT_AGENTS = 2
    SELF_PLAY = 3
    SAVE_SAMPLES = 4
    PROCESS_RESULTS = 5
    KILL_AGENTS = 6
    TRAIN = 7
    COMPARE_BASELINE = 8
    COMPARE_PAST = 9


class Coach:
    def __init__(self, env, nnet: NNetWrapper, args: Args, draws=None):
        check_ported(args)
        self.state = TrainState.INIT
        self.env = env
        self.args = args
        self.args._num_players = env.NUM_PLAYERS + int(env.HAS_DRAW)
        self.device = nnet.device
        self.train_net = nnet
        self.self_play_net = NNetWrapper(env, args, device=self.device)
        self.draws = draws

        # The ranks that share games and batches (JAX coach.py:81-99); a
        # batch size they do not divide raises.
        self.ranks = M.usable_devices(
            int(args.get("mesh_batch_axis", -1)),
            int(args.process_batch_size), int(args.train_batch_size),
            int(args.arenaCompare), int(args.arenaCompareBaseline))
        if M.is_distributed():
            if M.rank() == 0:
                print(f"[mesh] data-parallel over {self.ranks} ranks")
            self.train_net.attach_mesh()
            self.self_play_net.attach_mesh()

        self.ckpt_folder = os.path.join(args.checkpoint, args.run_name)
        os.makedirs(self.ckpt_folder, exist_ok=True)

        # Resume discovery (Coach.py:165-181), on what every rank sees.
        M.barrier()
        train_iter = args.startIter
        if args.load_model:
            networks = sorted(glob(os.path.join(self.ckpt_folder, "*.ckpt")))
            # Every rank has counted before rank 0 writes iteration 0.
            self.args.startIter = int(M.all_reduce_min(len(networks))) \
                if self.ranks > 1 else len(networks)
            if self.args.startIter == 0:
                self._save_model(self.train_net, 0)
                self.args.startIter = 1
            train_iter = self.args.startIter - 1
            self._load_model(self.train_net, train_iter)

        if args.selfPlayModelIter == 0:
            self.self_play_iter = 0
        else:
            self.self_play_iter = args.selfPlayModelIter or \
                self._load_run_state().get("self_play_iter", train_iter)
            self.self_play_iter = min(self.self_play_iter, train_iter)
        if args.model_gating:
            self._load_model(self.self_play_net, self.self_play_iter)

        self.gating_counter = 0
        self.warmup = False
        self.model_iter = self.args.startIter
        self.loss_pi = 0.0
        self.loss_v = 0.0
        self.sample_time = 0.0
        self.games_played_iter = 0
        self.stop_train = threading.Event()
        self.pause_train = threading.Event()
        self.train_net.stop_train = self.stop_train
        self.train_net.pause_train = self.pause_train

        self.store = ReplayStore(args.data, args.run_name)
        self.writer = make_writer(
            str(args.get("log_dir", "runs")) if M.rank() == 0 else None,
            args.run_name)
        self.tracer = PhaseTracer(self.writer,
                                  str(args.get("profile_dir", "") or ""))
        self._np_rng = np.random.default_rng(int(args.get("seed", 0)))
        self._rank_rng = None if self.ranks == 1 else \
            np.random.default_rng([int(args.get("seed", 0)), M.rank()])
        self.generator = torch.Generator(self.device).manual_seed(
            int(args.get("seed", 0)) + 1)
        self._cfg = SelfPlayConfig.from_args(args, env.NUM_PLAYERS,
                                             env.HAS_DRAW)
        self._move_fns = {}
        self._arena_fns = {}
        self._dev_window = None
        self._quant_ok = None  # tri-state: unknown / usable / unsupported

    # ------------------------------------------------------------- utilities
    @property
    def _local_rng(self) -> np.random.Generator:
        """The stream of draws whose count depends on the rank's own files:
        the rank's stream under W > 1, else the shared one."""
        return self._np_rng if self._rank_rng is None else self._rank_rng

    def _save_model(self, net: NNetWrapper, iteration: int) -> None:
        # The weights are equal on every rank: rank 0 writes, the others
        # wait for it before they read the folder.
        if M.rank() == 0:
            net.save_checkpoint(self.ckpt_folder, get_iter_file(iteration))
        M.barrier()

    def _load_model(self, net: NNetWrapper, iteration: int) -> None:
        net.load_checkpoint(self.ckpt_folder, get_iter_file(iteration))

    def _run_state_path(self) -> str:
        return os.path.join(self.ckpt_folder, "run_state.json")

    def _load_run_state(self) -> dict:
        """Gating state kept across restarts (the reference keeps only
        selfPlayModelIter, through its GUI, main.py:383-387)."""
        try:
            with open(self._run_state_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _save_run_state(self) -> None:
        if M.rank() != 0:
            return
        with open(self._run_state_path(), "w") as f:
            json.dump({"self_play_iter": self.self_play_iter,
                       "model_iter": self.model_iter,
                       "gating_counter": self.gating_counter}, f)

    def _get_move_fns(self, model):
        """The fast/full/warmup runners over ``model`` (a network's model
        or its int8 tower; weights are loaded and re-quantized in place, so
        the runners follow every load)."""
        if id(model) not in self._move_fns:
            self._move_fns[id(model)] = make_move_fns(self.env, self._cfg,
                                                      model)
        return self._move_fns[id(model)]

    def _quant_calib_obs(self, iteration: int, max_obs: int = 8192):
        """Calibration observations for re-quantization: the newest earlier
        iteration's replay observations, at most ``max_obs`` of them drawn
        without replacement by the numpy stream (coach.py:210-223); None
        before there is any replay."""
        for it in range(iteration - 1, 0, -1):
            data = self.store.load(it)
            if data is not None and len(data[0]):
                obs = data[0]
                if len(obs) > max_obs:
                    idx = self._local_rng.choice(len(obs), max_obs,
                                                 replace=False)
                    obs = obs[idx]
                return torch.from_numpy(
                    np.asarray(obs, np.float32)).to(self.device)
        return None

    def _quantized(self, net: NNetWrapper, iteration: int):
        """``net``'s int8 tower re-quantized from its current weights, or
        None where its architecture has none (then ``_quant_ok`` is False
        and the float tower plays from here on, as in the JAX Coach)."""
        calib = self._quant_calib_obs(iteration)
        if self.ranks > 1 and not bool(M.all_reduce_min(
                int(calib is not None))):
            calib = None  # a rank without samples: all take the playouts
        draw = self.draws.calibration() if self.draws is not None else None
        try:
            model = net.quantized_inference(
                calib_obs=calib, generator=self.generator,
                actions=draw() if draw is not None and calib is None
                else None)
        except ValueError as e:
            if self._quant_ok is None:
                print(f"int8 tower: {e}; the float tower plays")
            self._quant_ok = False
            return None
        self._quant_ok = True
        return model

    def _try_quant(self, net: NNetWrapper, iteration: int):
        """The int8 tower for an arena (coach.py:727-742), or None."""
        if not bool(self.args.get("quant_arena", True)) \
                or not bool(self.args.get("quant_selfplay", False)) \
                or self._quant_ok is False:
            return None
        return self._quantized(net, iteration)

    # ------------------------------------------------------------ main loop
    def learn(self) -> None:
        """Iteration loop (Coach.py:225-288)."""
        while self.model_iter <= self.args.numIters:
            print(f"------ITER {self.model_iter}------")
            skip = (
                self.args.skipSelfPlayIters
                and self.model_iter <= self.args.skipSelfPlayIters
            ) or (
                self.args.train_on_past_data
                and self.model_iter == self.args.startIter
            )
            if not skip:
                if self.model_iter <= self.args.numWarmupIters:
                    print("Warmup: random policy and value")
                    self.warmup = True
                else:
                    self.warmup = self.self_play_iter == 0
                with self.tracer.phase("self_play", self.model_iter):
                    self.generate_self_play_data(self.model_iter)
                if self._stop_requested():
                    break

            with self.tracer.phase("train", self.model_iter):
                self.train(self.model_iter)
            if self._stop_requested():
                break

            if self.args.compareWithBaseline and \
                    int(self.args.arenaCompareBaseline) > 0 and \
                    (self.model_iter - 1) % self.args.baselineCompareFreq == 0:
                with self.tracer.phase("arena_baseline", self.model_iter):
                    self.compare_to_baseline(self.model_iter)
                if self._stop_requested():
                    break

            if self.args.compareWithPast and \
                    int(self.args.arenaCompare) > 0 and \
                    (self.model_iter - 1) % self.args.pastCompareFreq == 0:
                with self.tracer.phase("arena_past", self.model_iter):
                    self.compare_to_past(self.model_iter)
                if self._stop_requested():
                    break

            self.writer.add_scalar("win_rate/self_play_model",
                                   self.self_play_iter, self.model_iter)
            self.model_iter += 1
            self._save_run_state()
        self.state = TrainState.STANDBY

    def _stop_requested(self) -> bool:
        """Whether to leave ``learn`` after a phase: rank 0's
        ``stop_train``, the same on every rank (a max all-reduce under
        W > 1)."""
        stop = int(M.rank() == 0 and self.stop_train.is_set())
        return bool(M.all_reduce_max(stop)) if self.ranks > 1 else bool(stop)

    # ------------------------------------------------------------- self-play
    def generate_self_play_data(self, iteration: int) -> None:
        """Self-play moves until ``gamesPerIteration`` games have finished
        (Coach.py:290-435). The host reads the finished-game count and the
        move records ``PIPE`` moves behind the newest move, so the device
        is never left waiting for it; the records stream into the
        finalizer, and the samples of games still running at the end are
        dropped. Under W ranks each plays its ``batch / W`` games, and the
        count read is the sum over the ranks, so all leave on the same
        move. ``stop_train`` and ``pause_train`` are honoured before each
        move (rank 0's, under W ranks; see the module's docstring)."""
        self.state = TrainState.SELF_PLAY
        batch = int(self.args.process_batch_size)
        target = int(self.args.gamesPerIteration)
        # Self-play uses the gated model (Coach.py:337-338).
        net = self.self_play_net if self.args.model_gating else \
            self.train_net
        model = net.model
        if (bool(self.args.get("quant_selfplay", False)) and not self.warmup
                and self._quant_ok is not False):
            # Re-quantized each iteration: weights and scales follow
            # training (coach.py:312-329).
            quantized = self._quantized(net, iteration)
            if quantized is not None:
                model = quantized
        cfg, fns = self._cfg, self._get_move_fns(model)
        carry = init_selfplay(self.env, batch // self.ranks, cfg.start_temp,
                              device=self.device, cfg=cfg)
        generator = M.shard_generator(self.generator, batch)

        symmetric = bool(self.args.symmetricSamples) and \
            self.env.NUM_SYMMETRIES > 1
        writer = self.store.writer(
            iteration, self.env.OBS_SHAPE, self.env.ACTION_SIZE,
            int(self.args._num_players), raw=symmetric)
        # Symmetry expansion is left to training time (raw files).
        fin = StreamingFinalizer(self.env, symmetric, writer.append,
                                 expand_at_collect=False)
        stats_win, stats_done = [], []
        raw, pending = deque(), deque()
        start = time.time()
        games_done = moves = simulations = 0
        sims_of = {"warmup": cfg.sims_warmup, "fast": cfg.sims_fast,
                   "full": cfg.sims_full}

        def drain_round():
            w, d, f, o, p, pidx = raw.popleft()
            w = w.cpu().numpy().astype(np.float32)
            d = d.cpu().numpy()
            stats_win.append(w)
            stats_done.append(d)
            if p is not None:
                p = p.cpu().numpy()
                if pidx is not None:
                    # Sparse top-k record (MoveRecord.pi_idx): densified
                    # on the host, exactly (coach.py:389-399).
                    p = densify_pi(p, pidx.cpu().numpy(),
                                   self.env.ACTION_SIZE)
            fin.add_round(w, d, f,
                          obs=None if o is None else o.cpu().numpy(), pi=p)

        bar = Bar(f"Self-play iter {iteration}", max=target)
        stopped = False  # rank 0's stop, as every rank read it
        while games_done < target and not stopped:
            if self.ranks == 1 and self.stop_train.is_set():
                break
            if M.rank() == 0:
                while self.pause_train.is_set():
                    time.sleep(0.1)
            if self.warmup:
                kind = "warmup"
            else:
                # Batch-global fast/full draw (SelfPlayAgent.pyx:84-86).
                kind = "fast" if (
                    self._np_rng.random() < cfg.prob_fast) else "full"
            d = None
            if self.draws is not None:
                d = self.draws.selfplay(
                    kind, sims_of[kind],
                    self.env.valid_moves(carry.env_state))
            carry, rec = fns[kind](
                carry, generator=generator,
                gumbel=None if d is None else d.gumbel,
                search_draws=None if d is None else d.search)
            moves += 1
            simulations += sims_of[kind]
            raw.append((rec.win_state, rec.done, kind == "fast", rec.obs,
                        rec.pi, rec.pi_idx))
            pending.append(carry.games_played)
            while len(pending) > PIPE:
                games_done, stopped = self._progress(pending.popleft())
                self.games_played_iter = games_done
                drain_round()
                bar.suffix = f"moves {moves}"
                bar.goto(min(games_done, target))
            if moves % 64 == 0:
                open_rows = sum(len(b[0]) for b in fin._open)
                print(f"[collect] moves={moves} games={games_done} "
                      f"open_blocks={len(fin._open)} open_rows={open_rows} "
                      f"elapsed={time.time() - start:.0f}s", flush=True)
        games_done = int(self._global_sum(carry.games_played))
        self.games_played_iter = games_done
        bar.goto(min(games_done, target))
        bar.finish()

        elapsed = time.time() - start
        self.sample_time = elapsed / max(games_done, 1)

        self.state = TrainState.SAVE_SAMPLES
        while raw:
            drain_round()
        fin.finish()
        n_local = writer.close()
        n_samples = int(self._global_sum(n_local))
        print(f"Saving {n_samples} samples ({games_done} games, "
              f"{elapsed:.1f}s, {self.sample_time * 1000:.1f} ms/game)"
              + (f"; {n_local} in rank {M.rank()}'s file"
                 if self.ranks > 1 else ""))

        self.state = TrainState.PROCESS_RESULTS
        # A stop before the first move leaves no round to count (the JAX
        # Coach raises there).
        if moves:
            wins, draws, avg_len = self._game_stats(np.stack(stats_win),
                                                    np.stack(stats_done))
            total = max(int(wins.sum()) + draws, 1)
            for i, w in enumerate(wins):
                credit = 0.5 * draws if self.args.use_draws_for_winrate \
                    else 0.0
                self.writer.add_scalar(f"win_rate/player{i}",
                                       (w + credit) / total, iteration)
            self.writer.add_scalar("win_rate/draws", draws / total,
                                   iteration)
            self.writer.add_scalar("win_rate/avg_game_length", avg_len,
                                   iteration)
        self.writer.add_scalar("loss/sample_time", self.sample_time,
                               iteration)
        # What the iteration ran and kept: the finalizer's sample count,
        # the games finished, and the moves and simulations searched (each
        # over the whole batch of games).
        self.writer.add_scalar("self_play/samples", n_samples, iteration)
        self.writer.add_scalar("self_play/games", games_done, iteration)
        self.writer.add_scalar("self_play/moves", moves, iteration)
        self.writer.add_scalar("self_play/simulations", simulations,
                               iteration)
        self.writer.add_scalar("self_play/int8",
                               float(model is net.quant_model), iteration)
        self.state = TrainState.STANDBY

    def _global_sum(self, x):
        """``x`` summed over the ranks (itself on one rank)."""
        return M.all_reduce_sum(x) if self.ranks > 1 else x

    def _progress(self, games_played):
        """(games finished over the ranks, whether rank 0 asks to stop) at
        a move the host reads: under W ranks one all-reduce of [games,
        stop], the count's own; on one rank the count alone (the loop
        tests ``stop_train`` before every move, as the JAX Coach does)."""
        if self.ranks == 1:
            return int(games_played), False
        stop = int(M.rank() == 0 and self.stop_train.is_set())
        both = torch.cat([games_played.reshape(1), torch.full(
            (1,), stop, dtype=games_played.dtype,
            device=games_played.device)])
        total = M.all_reduce_sum(both).tolist()
        return int(total[0]), bool(total[1])

    def _game_stats(self, win, done):
        """``game_stats_arrays`` of the global batch: wins and draws summed
        over the ranks, the mean game length weighted by their finished
        games."""
        wins, draws, avg_len = game_stats_arrays(win, done)
        if self.ranks == 1:
            return wins, draws, avg_len
        n = float(np.asarray(done).sum())
        tot = M.all_reduce_sum(torch.tensor(
            [*wins, draws, avg_len * n, n], dtype=torch.float64)).numpy()
        V = len(wins)
        return tot[:V], int(tot[V]), float(tot[V + 1] / max(tot[V + 2], 1))

    # -------------------------------------------------------------- training
    def train(self, iteration: int) -> None:
        """Train over the growing history window (Coach.py:437-525)."""
        self.state = TrainState.TRAIN
        if self.args.train_on_past_data and iteration == self.args.startIter:
            self._train_on_past_data(iteration)
            self.state = TrainState.STANDBY
            return
        window = history_window(
            iteration, int(self.args.minTrainHistoryWindow),
            int(self.args.maxTrainHistoryWindow),
            int(self.args.trainHistoryIncrementIters))
        first = max(1, iteration - window)
        sym_env = (self.env if bool(self.args.symmetricSamples)
                   and self.env.NUM_SYMMETRIES > 1 else None)
        # Device symmetries (default on): the window stays raw and each
        # train step applies one random symmetry per sample on the device.
        device_sym = sym_env is not None and bool(
            self.args.get("deviceSymmetries", True))
        # Device-resident window (default on, one rank only): iterations
        # are uploaded to a ring on the device once; each step ships only
        # row indices.
        use_window = (bool(self.args.get("deviceWindow", True))
                      and self.ranks == 1
                      and (sym_env is None or device_sym))
        data = None
        if use_window:
            if self._dev_window is None:
                n_sym_f = sym_env.NUM_SYMMETRIES if device_sym else 1
                rows = int(self.args.get("deviceWindowRows", 0)) or max(
                    int(self.args.get("maxWindowSamples", 4_000_000))
                    // n_sym_f, 65536)
                self._dev_window = DeviceWindow(
                    self.env.OBS_SHAPE, self.env.ACTION_SIZE,
                    int(self.args._num_players), rows, device=self.device)
                print(f"[device-window] ring {self._dev_window.rows} rows, "
                      f"{self._dev_window.nbytes / 2**20:.0f} MB on "
                      f"{self.device}")
            self._dev_window.sync(self.store, first, iteration)
            phys = self._dev_window.indices_for(first, iteration)
            if not len(phys):
                print("Warning: no training data found; skipping train step")
                self.state = TrainState.STANDBY
                return
        else:
            data = self.store.load_window(
                first, iteration,
                max_samples=int(self.args.get("maxWindowSamples",
                                              4_000_000)),
                rng=self._local_rng, symmetric_env=sym_env,
                expand=not device_sym)
            # Every rank skips, or none (each reads its own files).
            if bool(M.all_reduce_max(int(data is None))):
                print("Warning: no training data found; skipping train step")
                self.state = TrainState.STANDBY
                return
        self.train_net.set_device_symmetries(sym_env if device_sym else None)
        self.train_net.set_device_window(use_window)

        # Each rank's share of the global train batch.
        batch_size = int(self.args.train_batch_size) // self.ranks
        # Sample counts in training units (raw files count times the
        # symmetry group), from file metadata.
        counts = [m[0] for i in range(first, iteration + 1)
                  if (m := self.store.sample_meta(i, sym_env)) is not None]
        window_units = int(sum(counts))
        if self.args.autoTrainSteps:
            if self.args.averageTrainSteps:
                latest = int(np.mean(counts)) if counts else 0
            else:
                meta = self.store.sample_meta(iteration, sym_env)
                latest = meta[0] if meta else 0
            train_steps = max(latest // batch_size, 1)
        else:
            train_steps = int(self.args.train_steps_per_iteration)
        if self.ranks > 1:
            # The same step count on every rank (JAX coach.py:581-586):
            # the ranks' files differ in size.
            train_steps = int(M.all_reduce_min(train_steps))
            window_units = int(M.all_reduce_sum(window_units))
        n_sym = sym_env.NUM_SYMMETRIES if device_sym else 1

        if use_window:
            expected_rows = window_units // n_sym
            if len(phys) < expected_rows:
                print(f"[device-window] window degraded: {len(phys)} of "
                      f"{expected_rows} rows resident (ring capacity "
                      f"{self._dev_window.rows}); raise deviceWindowRows "
                      "to keep the full window")
            bufs = self._dev_window.buffers
            resident_rows = len(phys)

            def batches():
                # The host feed's shuffled epochs without replacement, drawn
                # by the same Generator; only the gather is on the device.
                while True:
                    order = self._np_rng.permutation(len(phys))
                    end = len(phys) - (len(phys) % batch_size)
                    if end == 0:
                        end = len(phys)  # tiny window: one short batch
                    for s0 in range(0, end, batch_size):
                        idx = phys[order[s0:s0 + batch_size]]
                        b = bufs + (idx,)
                        if device_sym:
                            b = b + (self._np_rng.integers(
                                0, n_sym, size=len(idx), dtype=np.int32),)
                        yield b
        else:
            resident_rows = len(data[0])

            def batches():
                while True:
                    for b in batch_iterator(data, batch_size,
                                            self._local_rng):
                        if device_sym:
                            b = b + (self._local_rng.integers(
                                0, n_sym, size=len(b[0]), dtype=np.int32),)
                        yield b

        bar = Bar(f"Train iter {iteration}", max=train_steps)

        def progress(step, total, lpi, lv):
            bar.suffix = f"lpi {lpi:.3f} lv {lv:.3f}"
            bar.goto(step)

        self.loss_pi, self.loss_v = self.train_net.train(
            batches(), train_steps, iteration=iteration, callback=progress)
        bar.finish()
        seen = train_steps * batch_size * self.ranks
        self.writer.add_scalar("train/window_samples", window_units,
                               iteration)
        self.writer.add_scalar("train/samples_seen", seen, iteration)
        self.writer.add_scalar("train/effective_epochs",
                               seen / max(window_units, 1), iteration)
        self.writer.add_scalar("train/window_rows_resident", resident_rows,
                               iteration)
        self.writer.add_scalar("train/steps", train_steps, iteration)
        self.writer.add_scalar("loss/policy", self.loss_pi, iteration)
        self.writer.add_scalar("loss/value", self.loss_v, iteration)
        self.writer.add_scalar("loss/total", self.loss_pi + self.loss_v,
                               iteration)
        self._save_model(self.train_net, iteration)
        self.state = TrainState.STANDBY

    def _train_on_past_data(self, iteration: int) -> None:
        """One-shot chunked pre-training from a previous run's sample files
        (Coach.py:486-505)."""
        past = ReplayStore(self.args.data, self.args.past_data_run_name)
        total_iters = past.num_iterations()
        chunk = int(self.args.past_data_chunk_size)
        num_chunks = ceil(total_iters / chunk) if total_iters else 0
        print(f'Training on past data from run '
              f'"{self.args.past_data_run_name}" in {num_chunks} chunks of '
              f'{chunk} iterations ({total_iters} iterations in total).')
        self.train_net.set_device_window(False)
        self.train_net.set_device_symmetries(None)
        batch_size = int(self.args.train_batch_size) // self.ranks
        start = 1
        for _ in range(num_chunks):
            end = min(start + chunk - 1, total_iters)
            data = past.load_window(
                start, end,
                max_samples=int(self.args.get("maxWindowSamples",
                                              4_000_000)),
                rng=self._local_rng,
                symmetric_env=(self.env if bool(self.args.symmetricSamples)
                               and self.env.NUM_SYMMETRIES > 1 else None))
            start = end + 1
            train_steps = 0 if data is None else max(
                len(data[0]) // batch_size, 1)
            if self.ranks > 1:
                train_steps = int(M.all_reduce_min(train_steps))
            if train_steps == 0:
                continue

            def batches(data=data):
                while True:
                    yield from batch_iterator(data, batch_size,
                                              self._local_rng)

            self.loss_pi, self.loss_v = self.train_net.train(
                batches(), train_steps, iteration=iteration)
        self.writer.add_scalar("loss/policy", self.loss_pi, iteration)
        self.writer.add_scalar("loss/value", self.loss_v, iteration)
        self.writer.add_scalar("loss/total", self.loss_pi + self.loss_v,
                               iteration)
        self._save_model(self.train_net, iteration)

    # ------------------------------------------------------------ evaluation
    def _arena(self, kind: str, quant: bool = False):
        """The arena against the past model ("past") or the RawMCTS
        baseline ("baseline"), over the float towers or (``quant``) the int8
        ones, built once: each reads the current weights of the two
        networks, which loads and re-quantizations replace in place."""
        if (kind, quant) not in self._arena_fns:
            cfg = ArenaConfig.from_args(self.args, self.env.NUM_PLAYERS,
                                        self.env.HAS_DRAW)
            tower = "quant_model" if quant else "model"
            if kind == "baseline":
                num_games = int(self.args.arenaCompareBaseline)
                apply_b = raw_mcts_apply(
                    self.env.ACTION_SIZE,
                    self.env.NUM_PLAYERS + int(self.env.HAS_DRAW))
            else:
                num_games = int(self.args.arenaCompare)
                apply_b = getattr(self.self_play_net, tower)
            self._arena_fns[kind, quant] = make_arena_fn(
                self.env, cfg, getattr(self.train_net, tower), num_games,
                apply_fn_b=apply_b, device=self.device,
                sharded=self.ranks > 1)
        run = self._arena_fns[kind, quant]
        result = run(generator=self.generator,
                     draws=None if self.draws is None else self.draws.arena())
        step = self.model_iter
        wins = result.model_wins.tolist()
        for tag, value in (("rounds", result.rounds),
                           ("games", result.num_games),
                           ("wins_new", wins[0]), ("wins_other", wins[1]),
                           ("draws", result.draws), ("int8", float(quant))):
            self.writer.add_scalar(f"arena_{kind}/{tag}", value, step)
        return result

    def compare_to_past(self, model_iter: int) -> None:
        """Arena against the gated self-play model, and the gating decision
        (Coach.py:527-572)."""
        self.state = TrainState.COMPARE_PAST
        self._load_model(self.self_play_net, self.self_play_iter)
        print(f"PITTING AGAINST ITERATION {self.self_play_iter}")
        # The int8 tower on both seats where it is available.
        quant = self._try_quant(self.train_net, model_iter) is not None \
            and self._try_quant(self.self_play_net, model_iter) is not None
        result = self._arena("past", quant)
        winrate = float(winrates(result, self.args.use_draws_for_winrate)[0])
        wins = result.model_wins.numpy()
        draws = float(result.draws)
        print(f"NEW/PAST WINS : {wins[0]:.0f} / {wins[1]:.0f} ; "
              f"DRAWS : {draws:.0f}")
        print(f"NEW MODEL WINRATE : {round(winrate, 3)}")
        self.writer.add_scalar("win_rate/past", winrate, model_iter)
        decided = float(wins[0]) + float(wins[1])
        wr_decided = float(wins[0]) / max(decided, 1.0)
        self.writer.add_scalar("win_rate/past_decided", wr_decided,
                               model_iter)

        # Gating (Coach.py:558-572); rule "decided" scores decided games.
        if str(self.args.get("gatingRule", "reference")) == "decided":
            gate_pass = (
                decided >= int(self.args.get("gateMinDecided", 16))
                and wr_decided >= self.args.min_next_model_winrate)
            print(f"GATE (decided rule): {wr_decided:.3f} over "
                  f"{decided:.0f} decided games -> "
                  f"{'PROMOTE' if gate_pass else 'keep'}")
        else:
            gate_pass = winrate >= self.args.min_next_model_winrate
        if (self.args.model_gating and not gate_pass
                and (self.args.max_gating_iters is None
                     or self.gating_counter < self.args.max_gating_iters)):
            self.gating_counter += 1
        elif self.args.model_gating:
            self.self_play_iter = model_iter
            self._load_model(self.self_play_net, self.self_play_iter)
            self.gating_counter = 0
        if self.args.model_gating:
            print(f"Using model version {self.self_play_iter} for self play.")
        self.state = TrainState.STANDBY

    def compare_to_baseline(self, iteration: int) -> None:
        """Arena against the model-free RawMCTS baseline
        (Coach.py:574-590)."""
        self.state = TrainState.COMPARE_BASELINE
        print("PITTING AGAINST BASELINE: RawMCTS")
        quant = self._try_quant(self.train_net, iteration) is not None
        result = self._arena("baseline", quant)
        winrate = float(winrates(result, self.args.use_draws_for_winrate)[0])
        wins = result.model_wins.numpy()
        print(f"NEW/BASELINE WINS : {wins[0]:.0f} / {wins[1]:.0f} ; "
              f"DRAWS : {float(result.draws):.0f}")
        print(f"NEW MODEL WINRATE : {round(winrate, 3)}")
        self.writer.add_scalar("win_rate/baseline", winrate, iteration)
        self.state = TrainState.STANDBY
