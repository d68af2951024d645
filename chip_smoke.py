#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (alphazero_general_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed with its seconds; the first failure exits non-zero:

1. device: require CUDA; print the card's name, the device count and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build: compile the CUDA kernels with nvcc (ops/build.py) and print the
   ``-Xptxas -v`` resource summary.
3. kernels: during a full-width 200-simulation search and a 40-simulation
   one (connect4, 2048 games, random 128x8 ResNet; N = 203 and 43 tree
   rows), hold each game-minor kernel against its plain PyTorch version
   on the same tree snapshot, bit for bit, and time both: the kernel's
   device time from torch.profiler (with L2 flushed before each launch,
   and back to back with the inputs left in L2; the backup also at each
   block size of ``BACKUP_THREADS``), each wrapper call and the plain
   version with CUDA events, and the host's time per wrapper call by the
   host clock alone. Then, on seeded random trees of every size in
   ``RANDOM_NODES`` and batch in ``RANDOM_BATCHES`` (ragged, and a tree
   large enough to force fewer games a descend block), all four kernels,
   bit for bit: the game-minor ones on the trees, the batch-major ones on
   the trees transposed to [B, N]. Last, the game-minor kernels bit for
   bit at the snapshots of the two searches that only the Coach runs: an
   arena round (128 games, 200 simulations, no root noise) and a warmup
   move (2048 games, 5 simulations of the uniform evaluation).
4. reference: a small whole search, and two reuse moves, on the card
   against the same on the CPU (plain versions): visit counts and tree
   links equal, q within ``TOL_FLOAT``.
5. self-play: 4 moves (fast, fast, fast, full) of the production config
   through ``make_move_fns``, with launch counters proving that every
   simulation went through both game-minor kernels, on trees of the rows
   that the segments of ``search._segment_plan`` give (each wrapper
   counts its launches by tree rows too).
   int8: the int8 tower (models/quant.py) of the same random network,
   calibrated on random playouts on the card: each tower conv's int32
   output equal to the CPU's for the same int8 input, the forward within
   ``INT8_CARD_ATOL`` of the CPU's, the accuracy bounds of
   tests/test_quant.py:42-60 against the bf16 ResNet; both forwards'
   device times and kernel launches, one tower conv int8 against bf16
   beside its bound; both fused tower conv kernels (csrc/conv_int8.cu)
   equal to their plain versions at the main path's shape, timed cold,
   warm and on the host beside their bounds and the plain chain; then the
   4 self-play moves again over the int8 tower, with the same launch
   checks, beside the bf16 moves' sims/s.
6. reuse: 8 moves (the same cycle twice) of the production config with
   tree reuse (N = 403 rows) from random openings, with launch counters
   proving that every simulation went through both batch-major kernels;
   then, on the carried trees it leaves, a 200-simulation search with both
   batch-major kernels held against their plain versions at snapshots
   and timed at the last one as in phase 3, beside the JAX package's
   route on the card (the columns transposed to [N, B], then the
   game-minor kernel); and one more fast move under torch.profiler, for
   the kernels' device times in place.
7. breakdown: where the time of a 40-simulation search goes,
   per stage (CUDA events and host clock) and per kernel (torch.profiler:
   the kernels' device times in place, between the network's passes).
8. coach: one Coach cycle of the connect4 preset through
   ``python -m alphazero_general_tpu_torch.cli.train``'s ``main``, cut as
   ``COACH_CUTS`` says (two iterations, the first a warmup one; 2048 games
   an iteration; arenas of 128 games after iteration 1 only; a gate that
   always promotes; the JAX default ``quant_selfplay=True``): warmup
   self-play, train, both arenas over the int8 tower and gating, then the
   int8 tower's self-play and train. Checks
   its checkpoints, npz samples (counts, pi rows, values), metrics (finite
   losses, autoTrainSteps' step count, arena wins and draws, the gating
   decision), and launch counters proving that every self-play and arena
   simulation went through both game-minor kernels and no plain version
   ran; and the gate the preset's winrate (0.52) would have decided.
   Then one float32 train step at full width on the card against the
   same step on the CPU, a checkpoint round trip, and train steps timed at
   batch 1024: fed as the Coach feeds them (row indices into the device
   window, one random symmetry a sample), with the device's busy share
   from torch.profiler, and fed from host arrays. The int8 tower's
   forward counter must equal what the int8 searches of the cycle need,
   and its per-phase flags must say that it played.
   FC and GroupNorm: a float32 forward and train step of the FC net and of
   a GroupNorm ResNet (small widths) on the card against the CPU's.

9. tafl kernels: the two game-minor kernels bit for bit against their
   plain versions at the tafl shapes, with a random 128x10 ResNet of the
   presets' heads: a hnefatafl 250-simulation search (512 games from the
   start and from random openings, A = 2420, N = 253; held after 50 and
   249 simulations) and a 50-simulation one (N = 53), each timed at its
   last snapshot as in phase 3; brandubh's self-play searches (1024
   games, 150 and 30 simulations, N = 153 and 33) untimed; and a
   round's search of the brandubh Coach phase's arena (64 games, 50
   simulations, no root noise), timed. Then the prior rows' read and
   write per simulation, timed in the TreeT's batch-major layout and in a
   game-minor one.
10. hnefatafl self-play: 4 moves (fast, fast, fast, full) of the preset
   through ``make_move_fns``, with launch counters proving that every
   simulation went through both game-minor kernels and no plain version
   ran, and the sparse top-k policy records densified on the card to rows
   that sum to 1 over valid actions; then where a fast search's time
   goes, as in phase 7; then the int8 phase at hnefatafl's width (512
   games, 128 x 10, 16-channel heads), without self-play moves.
11. tafl reference: a hnefatafl search (64 games) on the card against the
   same search on the CPU through the plain versions.
12. brandubh coach: one Coach cycle of the brandubh preset through
   ``cli.train``'s ``main``, cut as ``BRANDUBH_COACH_CUTS`` says (a past
   arena of 64 games at 50 simulations), with the checks of phase 8 (the
   npz rows are dense pi rows of width 588; the float tower,
   ``quant_selfplay=False``, keeps that Coach path driven).

13. env rollouts: random playouts of tictactoe, nim3, othello, gobang,
   stratego, chess (from the six perft positions and random openings) and
   othello with 4 stacked observations on the card and on the CPU, with
   the same actions: every state field, valid mask, win vector and
   observation equal at every ply (``ROLLOUT_ENVS``).
14. chess kernels: the two game-minor kernels bit for bit against their
   plain versions at the chess preset's shapes (a random 128 x 10 ResNet
   with [2048, 256] / [2048, 1024] heads, 256 games from random openings,
   A = 4672): a 200-simulation search (N = 203) and a 40-simulation one
   (N = 43), held after 40 and 199 (20 and 39) simulations and timed at
   the last snapshot as in phase 3.
15. nim3 kernels: the same at nim3's (three players, ``value_size`` 4,
   the default args' 100-simulation search at 256 games, N = 103). Then
   the batch-major kernels at three players: two nim3 reuse moves, and a
   100-simulation search on the carried trees they leave, held at
   ``NIM_REUSE_SNAPSHOTS`` and timed at the last. Then the game-minor
   kernels at stratego's shapes (512 games, A = 1280, a random 64 x 8
   ResNet; the preset's 100- and 20-simulation searches, N = 103 and 23),
   held at ``STRATEGO_SNAPSHOTS``, untimed.
16. chess self-play: 4 moves (fast, fast, fast, full) of the preset through
   ``make_move_fns``, with the launch checks of phase 5 and the full
   move's sparse pi records densified to 4672-wide rows.
17. chess breakdown: where the time of a 40-simulation search goes, as in
   phase 7.
18. chess reference: a search (32 games) on the card against the same
   search on the CPU.
19. other envs' self-play: one fast and one full move of othello,
   gobang, tictactoe, stratego (sparse records), nim3 and othello with 4
   stacked observations at their presets' widths, with the launch checks.
20. nim3 arena: three random networks through ``make_multi_arena_fn``
   (48 games): every game decided, every simulation through both kernels.
21. othello coach: one Coach cycle of the othello preset through
   ``cli.train``'s ``main``, cut as ``OTHELLO_COACH_CUTS`` says, at the
   JAX default ``quant_selfplay=True``, with the checks of phase 8.

22. player kernels: both batch-major kernels bit for bit against their
   plain versions at one game (B = 1, as the players and the evaluator
   search): on random trees of ``PLAYER_NODES`` rows with two and three
   players; at snapshots of a connect4 MCTSPlayer search (a random
   preset-width 128 x 8 ResNet, 200 simulations, N = 203) and of a chess
   analysis (128 x 10, A = 4672, 100 simulations, N = 103), and after the
   last simulation of connect4 analyses of 400 simulations over the
   network (N = 403) and 2000 with the uniform evaluation (N = 2003),
   each timed at its last snapshot as in phase 3 (cold, warm, host).
23. pit: ``cli.pit.main`` with ``mcts:`` over a random preset-width
   connect4 checkpoint against ``rawmcts``, then ``nativemcts`` (the C++
   runtime, built with g++ into ``_build/``) against ``greedy``,
   ``PIT_GAMES`` games each at ``PIT_SIMS`` simulations: every move legal,
   the tallies adding up, every simulation through both batch-major
   kernels and none through a game-minor kernel or a plain version; ms a
   move and sims/s per player.
24. analyze: ``cli.analyze.main`` over random preset-width checkpoints of
   connect4 (400 simulations, N = 403) and chess (100 simulations), with
   their launch counts; a background MCTSEvaluator on connect4 at
   ``EVALUATOR_SIMS`` simulations (N = 2003) stopped by its time limit:
   the published simulations rise tick by tick, the thread stops.
25. tournaments: ``cli.roundrobin.main`` over two random connect4
   checkpoints and the baseline, ``cli.pitmulti.main`` over their folder
   against the baseline, then ``cli.clean.main`` on the run: the win
   matrix adds up, the ratings are finite, the winrates lie in [0, 1] and
   reach the metrics file, and every arena simulation ran through both
   game-minor kernels.

26. multi-leaf reference: a connect4 fresh search at ``LEAF_BATCH`` (256
   games, 64 simulations: 7 rounds and 7 single; a table evaluation, root
   and tie noise from fixed draws) on the card against the same on the
   CPU: visit counts, n and links equal, q and v within ``TOL_FLOAT``.
27. multi-leaf self-play: the 4 moves of phase 5 at ``LEAF_BATCH`` and at
   leaf_batch 1 through ``make_move_fns``, in turns (8, 1, 1, 8), each
   with phase 5's checks, the network calls of every search (one a round,
   one a single simulation: 12 at 40 simulations, 32 at 200) and the root
   children's visits (sims - 1); sims/s of each run, kernel launches a
   simulation over one more fast move of each (torch.profiler), peak
   memory.
28. kernels under rounds: both game-minor kernels bit for bit against
   their plain versions mid-round in a 200-simulation ``LEAF_BATCH``
   search at 2048 games (descend before a round's last walk, backup at
   its first backup, each snapshot holding pending children), timed at
   the last round as in phase 3.
29. segments: a 200-simulation search at 2048 games (a table evaluation)
   segmented, with both game-minor kernels bit for bit at the last
   simulation of every segment and timed at N = 32, 64 and 128, then
   segmented and flat under torch.profiler: every TreeT field bit-equal,
   descend's and backup's device ms a simulation each way; each slice's
   kernel records carry the phase-8 Coach's launches on trees of its
   rows. Then an MCTSPlayer move over the pit's kind of checkpoint and a
   rawmcts move at 200 simulations, segmented (both rows kernels bit for
   bit at each slice) and flat: every field but the sink row equal, the
   same move; then ``PLAYER_TIMED_MOVES`` moves of each layout in turns,
   and the host's time of a move's slice copies and merges.
30. multi-leaf coach: the connect4 preset through ``cli.train.main`` at
   ``LEAF_BATCH``, cut as ``LEAF_COACH_CUTS`` says (a warmup iteration,
   then a resumed call for a network iteration over the int8 tower, 2048
   games each, no arenas), with the checks of phase 8 (the int8 forwards
   counted a network call each).

31. NCCL at world size 1: ``parallel.init_distributed`` under torchrun's
   variables (``WORLD_SIZE=1``) forms an NCCL group; 4 fresh-tree moves
   (fast, fast, fast, full) of 2048 games through the mesh code (the
   global batch's draws cut to the rank's games, the finished-game count
   summed over the ranks) with both game-minor kernels launched; 20
   float32 train steps at batch 1024 with the gradient all-reduce through
   NCCL, equal to the same steps without a group within ``TRAIN_RTOL`` /
   ``TRAIN_ATOL``; the NCCL kernels in one step's trace and the time of a
   gradient all-reduce. Then the group is left.
32. two ranks sharing the card over Gloo: two processes of this script
   (``--rank R 2 DIR``; any rank that fails, or a run past its deadline,
   fails the phase), each in one Gloo group (``file://`` store) on device
   0, at the connect4 preset's width (2048 global games, 1024 a rank,
   200 / 40 simulations, ResNet 128 x 8): both build the kernels at once
   into one fresh folder; 4 moves over a table evaluation whose records
   equal this process's 1-rank run's rows for each rank's games; a
   float32 train step on each rank's half of a fixed global batch of 256,
   the ranks bit-identical and within ``TRAIN_RTOL`` / ``TRAIN_ATOL`` of
   the 1-rank step, and the time of a gradient all-reduce over Gloo on
   CUDA tensors; self-play sims/s of both ranks at once (this process's
   1-rank sims/s before and after); in each rank in turn, both game-minor
   kernels held bit for bit mid-search (and timed) and, after two reuse
   moves, both batch-major ones on the carried trees; then the Coach
   through ``cli.train.main`` as ``MULTI_COACH_CUTS`` and
   ``MULTI_RESUME_CUTS`` say (a warmup iteration, both arenas at 128
   games, a resumed network iteration over the int8 tower). Checks: the
   weights bit-identical on both ranks, checkpoints written by rank 0
   alone, two sample files an iteration (``-p0``, ``-p1``) whose rows add
   up to the samples counted, the same gating decision and fast/full
   coins on both ranks, and each rank's kernels launched by its Coach.

33. GUI: the port's GUI server (``gui.server``, its handler on the card)
   in this process, driven over HTTP as the page drives it: the page,
   ``/api/envs`` and ``/api/args``; a connect4 game against ``mcts:``
   over a random preset-width checkpoint (128 x 8) at the preset's 200
   simulations (every agent reply legal, the board equal to a replay of
   the same actions on the CPU, the evaluator's analysis published, undo
   back to the human's move), chess (A = 4672, the flipped board) and
   stratego's placement against rawmcts, tictactoe hot-seat and
   networked; the launch counters equal to the agents' and the
   evaluator's simulations through both batch-major kernels, with no
   plain version run. Then the train panel: a connect4 session cut as
   ``GUI_TRAIN_CUTS`` says, paused in self-play (no game finished and no
   kernel launched for ``GUI_PAUSE_S``), resumed and run through
   SELF_PLAY, TRAIN and COMPARE_BASELINE to iteration-0001.ckpt with both
   game-minor kernels; a second session stopped in self-play, in STANDBY
   within ``GUI_STOP_S``. Last, both batch-major kernels bit for bit at
   the GUI evaluator's tree (B = 1, N = 403), timed as in phase 22.

Before the card's line come the int8 phases' numbers
``{"int8_tower": {...}}``, the search layer's ``{"search_layer":
{...}}``, the multi-device phases' ``{"multi_device": {...}}`` and the
GUI's ``{"gui": {...}}``; the last two lines are the kernels line
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``. The script
imports nothing of JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch
import torch.distributed as dist

from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs.core import state_items
from alphazero_general_tpu_torch.envs.presets import preset_args
from alphazero_general_tpu_torch.mcts import search as S
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts.tree_t import init_tree_t
from alphazero_general_tpu_torch.models import NNetWrapper
from alphazero_general_tpu_torch.models import quant as Q
from alphazero_general_tpu_torch.ops import backup as OB
from alphazero_general_tpu_torch.ops import descend as OD
from alphazero_general_tpu_torch.parallel import mesh as M
from alphazero_general_tpu_torch.selfplay import (
    SelfPlayConfig, SelfPlayState, init_selfplay, make_move_fns, move_step,
)
from alphazero_general_tpu_torch.selfplay.arena import ArenaConfig
from alphazero_general_tpu_torch.selfplay.device_window import DeviceWindow
from alphazero_general_tpu_torch.selfplay.replay import ReplayStore
from alphazero_general_tpu_torch.utils import get_args
from alphazero_general_tpu_torch.utils.misc import get_iter_file
from alphazero_general_tpu_torch.utils.random_tree import (
    DESCEND_COLUMNS, random_tree,
)

# The production connect4 config of bench.py:38-51 (the reference's
# envs/connect4/train.py): 2048 games, 200 full / 40 fast simulations at a
# 3 fast : 1 full cycle, ResNet 128 channels x 8 blocks, 32-channel heads,
# dense [1024, 256] (value) and [1024] (policy), bfloat16 compute.
GAMES = 2048
SIMS_FULL = 200
SIMS_FAST = 40
CYCLE = ("fast", "fast", "fast", "full")
#: Moves of the reuse phase: the cycle twice, so that trees are carried
#: into fast and full searches alike.
REUSE_CYCLE = CYCLE * 2
MODEL = dict(num_channels=128, depth=8, value_head_channels=32,
             policy_head_channels=32, value_dense_layers=[1024, 256],
             policy_dense_layers=[1024], compute_dtype="bfloat16")
SEED = 0
#: Simulations of the phase-3 searches (full, fast) after which both
#: kernels are checked; the last snapshot of each is timed.
SNAPSHOTS = {SIMS_FULL: (50, 120, 199), SIMS_FAST: (20, 39)}
#: Simulations of the reuse phase's search on carried trees after which the
#: batch-major kernels are checked; the last snapshot is timed.
REUSE_SNAPSHOTS = (0, 50, 120, 199)
#: Snapshots of the tafl kernel phase, by variant and simulations (the
#: presets' full and fast searches; envs/presets.py): the last one of each
#: timed search is timed.
TAFL_SNAPSHOTS = {("hnefatafl", 250): (50, 249), ("hnefatafl", 50): (20, 49),
                  ("brandubh", 150): (37, 149), ("brandubh", 30): (15, 29)}
#: Games of the brandubh Coach phase's past arena, whose round the tafl
#: kernel phase holds (the preset's arenaCompare: 128).
BRANDUBH_ARENA_GAMES = 64
#: Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
#: float32 (non-tensor-core) operations/s, for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: Bytes written between timed launches to evict the kernel's inputs from
#: the 50 MB L2, as the network's passes do between launches in a search.
L2_FLUSH_BYTES = 256 * 2**20

#: A float16 policy row's sum is 1 within this: each entry rounds by at
#: most 2^-11 of its value.
PI16_ATOL = 2**-11
#: Tolerance of the reference phase (a search on the card against the same
#: search on the CPU: the CPU's float arithmetic may round otherwise).
TOL_FLOAT = 1e-6
#: Random trees on which the kernels are held against their plain versions
#: (utils/random_tree.py): every tree size from the smallest to one that
#: forces fewer than 8 games a descend block (N = 7300: 4), among them the
#: production reuse tree (N = 403, whose batch-major rows are not 16-byte
#: aligned), and batches that are a multiple of the block, ragged (1000 is
#: not a multiple of 64), too small for the 16-byte staging loads (7) or
#: one game, as the players search (1: seven empty lanes of a block).
RANDOM_NODES = (2, 43, 403, 2048, 7300)
RANDOM_BATCHES = (2048, 1000, 7, 1)
#: Block sizes of the backup timed in the kernel phase.
BACKUP_THREADS = (32, 64, 128)
#: Wrapper calls timed by the host clock alone, with no sync among them.
HOST_CALLS = 1000
#: Traces ``_trace`` takes at most for one that holds every launch. Late
#: in a whole run the card's traces lose records often (0, 25 or 40 of
#: 50 launches in a trace): three tries once kept no trace of half.
PROFILE_TRIES = 6
#: What torch.profiler traces: the device's kernels only. Every number
#: taken from a trace is a kernel's; host ops would only lengthen the
#: processing of a trace (a 200-simulation search launches about 97,000
#: kernels).
PROFILED = [torch.profiler.ProfilerActivity.CUDA]
#: Every kernel wrapper, by the name of its kernel record; each counts its
#: launches in ``.launches``.
COUNTED = {"descend": OD.descend_columns, "backup": OB.backup_columns_,
           "descend_rows": OD.descend_rows, "backup_rows": OB.backup_rows_}


#: The int8 tower against the bf16 ResNet on the card, the accuracy bounds
#: of tests/test_quant.py:42-60: mean KL(bf16 || int8) of the policies,
#: max |dv| of the value probabilities, argmax agreement of the policies.
INT8_KL, INT8_DV, INT8_AGREE = 5e-3, 0.05, 0.97
#: The int8 forward on the card against the same module on the CPU, on the
#: first ``INT8_CHECK_GAMES`` games of the batch: the int8 codes come from
#: float32 sums taken in another order (the stem's convolution, the
#: affines), so a code at a rounding boundary may move by one step, which
#: moves a log-probability by far less than this.
INT8_CARD_ATOL = 0.05
INT8_CHECK_GAMES = 64
#: Forwards timed per measurement of the int8 phase.
INT8_REPS = 20
#: The fused tower conv kernel's name in a profiler trace.
FUSED_CONV = "conv3x3_int8_gemm"
#: Dense tensor-core peaks of one H100 SXM (NVIDIA data sheet), for the
#: tower conv's bound.
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, reps: int, device) -> float:
    """Mean milliseconds of ``fn()``: CUDA events on the card (after one
    warm-up call), the host clock on the CPU."""
    fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def host_ms(fn, calls: int, device) -> float:
    """Host milliseconds per call of ``fn``, by the host clock over
    ``calls`` calls with no sync among them: what a wrapper costs the host
    to check its inputs and enqueue its kernel, without the device."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    sync(device)
    return dt * 1e3 / calls


def _device_kernels(prof):
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _trace(fn, reps: int, device, kernel: str, flush_l2: bool):
    """(device kernels, launches of ``kernel``) of a torch.profiler trace
    of ``reps`` calls of ``fn``; with ``flush_l2``, a fill of
    ``L2_FLUSH_BYTES`` runs before each call and its kernels are left out.

    Traces on the card have lost records now and then (the kernel's and
    the fills' alike: 32 of 50 once, 47 or 48 of 50 in every trace of one
    phase of another run), and the same traces held all 50 when run
    alone. So a trace short of launches is taken again, up to
    ``PROFILE_TRIES`` times, and then the fullest one serves if it holds
    at least half of them: its times average the launches it holds."""
    scrub = (torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                         device=device) if flush_l2 else None)
    fn()
    torch.cuda.synchronize(device)
    best = ([], -1)
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=PROFILED) as prof:
            for i in range(reps):
                if scrub is not None:
                    scrub.fill_(i)
                fn()
            torch.cuda.synchronize(device)
        events = _device_kernels(prof)
        count = sum(e.count for e in events if kernel in e.key)
        if count > best[1]:
            best = ([e for e in events
                     if scrub is None or "FillFunctor" not in e.key], count)
        if count == reps:
            break
        log(f"  (the profiler's trace holds {count} of {reps} launches of "
            f"{kernel})")
    check(best[1] >= reps // 2,
          f"profiler traces held at most {best[1]} of {reps} launches of "
          f"{kernel}")
    return best


def kernel_ms(fn, reps: int, device, kernel: str,
              flush_l2: bool = False) -> float:
    """Device milliseconds of one launch of the CUDA kernel whose name
    contains ``kernel``, from a torch.profiler trace of ``reps`` calls of
    ``fn`` — the kernel alone, without the wrapper's host time. With
    ``flush_l2``, a fill of ``L2_FLUSH_BYTES`` runs before each call, so
    the kernel reads its inputs from HBM; without it the calls run back to
    back and find their inputs in L2. On the CPU, where no kernel runs, the
    host time of one call."""
    if torch.device(device).type != "cuda":
        return time_ms(fn, reps, device)
    events, count = _trace(fn, reps, device, kernel, flush_l2)
    return sum(e.self_device_time_total for e in events
               if kernel in e.key) / count / 1e3


def device_ms(fn, reps: int, device, kernel: str,
              flush_l2: bool = False) -> float:
    """Device milliseconds of all the kernels one call of ``fn`` launches,
    from a trace as ``kernel_ms`` takes it, per launch of the kernel named
    ``kernel`` that the trace holds. On the CPU, the host time of one
    call."""
    if torch.device(device).type != "cuda":
        return time_ms(fn, reps, device)
    events, count = _trace(fn, reps, device, kernel, flush_l2)
    return sum(e.self_device_time_total for e in events) / count / 1e3


def reset_counts() -> None:
    for wrapper in COUNTED.values():
        wrapper.launches = 0
        wrapper.launches_by_rows.clear()


def read_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in COUNTED.items()}


def read_counts_by_rows() -> dict:
    """{kernel: {tree rows N: launches}} since the last reset."""
    return {name: dict(wrapper.launches_by_rows)
            for name, wrapper in COUNTED.items()}


def fresh_launches_by_rows(cfg, moves) -> dict:
    """The game-minor kernels' launches by tree rows N that fresh searches
    of ``moves`` [(kind, sims, ...)] under ``cfg`` make: the root's
    expansion backs up on the whole tree (N = its capacity + 1 rows), and
    simulations [lo, hi) of each segment of ``search._segment_plan`` walk
    and back up on n rows; rounds (``leaf_batch`` > 1) run on the whole
    tree."""
    out = {"descend": {}, "backup": {}}

    def add(kernel, n, count):
        out[kernel][n] = out[kernel].get(n, 0) + count

    for _, sims, *_ in moves:
        rows = min(cfg.capacity, sims + 2) + 1
        add("backup", rows, 1)
        plan = (S._segment_plan(sims, rows) if cfg.leaf_batch == 1
                else [(rows, 1, sims)])
        for n, lo, hi in plan:
            if hi > lo:
                add("descend", n, hi - lo)
                add("backup", n, hi - lo)
    return out


def launch_floor_ms(device, reps: int = 50) -> float:
    """Device milliseconds of about the smallest kernel there is, a fill of
    one int32 (torch.profiler): no kernel launched on this card takes less,
    whatever its bound."""
    one = torch.zeros(1, dtype=torch.int32, device=device)
    return kernel_ms(lambda: one.fill_(1), reps, device, "FillFunctor")


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------

def random_openings(env, batch: int, max_plies: int, generator, device):
    """Games advanced by 0..max_plies random legal moves each."""
    states = env.init(batch, device)
    plies = torch.randint(0, max_plies + 1, (batch,), generator=generator,
                          device=device)
    for ply in range(max_plies):
        valid = env.valid_moves(states).to(torch.float32)
        action = torch.multinomial(valid, 1, generator=generator)[:, 0]
        stepped = env.step(states, action)
        move = plies > ply
        states = env.State(**{
            name: torch.where(move.reshape((-1,) + (1,) * (x.dim() - 1)),
                              getattr(stepped, name), x)
            for name, x in state_items(states).items()})
    return states


def table_eval_fn(env, value_size: int, seed: int = 0, rows: int = 4093):
    """Evaluation by table lookup on an integer hash of the piece planes
    (every observation plane but the last two, colour and turn, in both
    connect4 and tafl): the same numbers on any device, so a search gives
    equal visit counts on the card and on the CPU."""
    rng = np.random.default_rng(seed)
    planes, height, width = env.OBS_SHAPE
    planes -= 2
    pi_tab = rng.dirichlet(np.ones(env.ACTION_SIZE), rows).astype(np.float32)
    v_tab = rng.dirichlet(np.ones(value_size), rows).astype(np.float32)
    weights = rng.integers(1, rows, size=(planes, height * width))
    cache = {}

    def eval_fn(obs):
        dev = obs.device
        if dev not in cache:
            cache[dev] = tuple(torch.from_numpy(x).to(dev)
                               for x in (pi_tab, v_tab, weights))
        pi_t, v_t, w = cache[dev]
        stones = (obs[:, :planes] > 0.5).reshape(obs.shape[0], planes,
                                                 -1).long()
        h = (stones * w).sum(dim=(1, 2)) % rows
        return pi_t[h], v_t[h]

    return eval_fn


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def device_phase():
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: torch.cuda.is_available() is "
                           "false; this smoke run needs one GPU")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"device: {name} (count {count}); nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    return name, count, smi


def build_phase():
    from alphazero_general_tpu_torch.ops.build import build_library, \
        load_library

    result = build_library()
    load_library()
    for line in result.log.splitlines():
        if line.startswith("---") or "ptxas info" in line \
                or "error" in line.lower() or "warning" in line.lower():
            log(f"  {line.strip()}")
    log(f"build: {result.path.name} in {result.seconds:.1f} s")
    return result


def _descend_inputs(tt):
    return (tt.parent, tt.parent_action, tt.n, tt.q, tt.v, tt.edge_prior,
            tt.eany, tt.nba, tt.nbp)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (float32 compared as its int32 bits, so -0.0 and
    0.0 differ and equal NaNs agree)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def compare_descend(cols, spec, where: str, rows: bool = False) -> float:
    """Kernel against plain on one set of columns, game-minor [N, B] or
    with ``rows`` batch-major [B, N]: every output equal bit for bit (the
    kernels are exact by construction). Returns the max abs p_sel error,
    0.0."""
    wrapper = OD.descend_rows if rows else OD.descend_columns
    got = wrapper(*cols, spec)
    sync(cols[0].device)
    want = OD.descend_plain(*(c.t() if rows else c for c in cols),
                            spec.cpuct, spec.fpu_reduction)
    for name, g, w in zip(("node", "action", "child", "depth", "p_sel"),
                          got, want):
        bad = (g.view(torch.int32) != w.view(torch.int32)).nonzero()
        if len(bad):
            game = int(bad[0, 0])
            raise SmokeFailure(
                f"{wrapper.__name__} {name} disagrees on {len(bad)} games "
                f"{where}; game {game}: kernel {[float(x[game]) for x in got]}"
                f" plain {[float(x[game]) for x in want]}")
    return (got[4] - want[4]).abs().max().item()


def compare_backup(args, nqv, spec, where: str, rows: bool = False) -> float:
    """Kernel against plain from the same n, q, v (game-minor, or with
    ``rows`` batch-major): visit counts equal and q, v equal bit for bit.
    Returns the max abs q/v error, 0.0."""
    k_cols = [x.clone() for x in nqv]
    p_cols = [x.clone() for x in nqv]
    wrapper = OB.backup_rows_ if rows else OB.backup_columns_
    wrapper(*args, *k_cols, spec)
    sync(nqv[0].device)
    if rows:
        OB.backup_plain_(args[0].t(), args[1].t(), *args[2:],
                         *(x.t() for x in p_cols), spec)
    else:
        OB.backup_plain_(*args, *p_cols, spec)
    for name, g, w in zip("nqv", k_cols, p_cols):
        check(bits_equal(g, w), f"{wrapper.__name__} {name} disagrees {where}")
    return max((k_cols[1] - p_cols[1]).abs().max().item(),
               (k_cols[2] - p_cols[2]).abs().max().item())


def _path_lengths(parent, leaf) -> np.ndarray:
    """Edges from each game's pending leaf to its root (host walk) over
    ``[N, B]`` parent links."""
    parent = parent.cpu().numpy()
    leaf = leaf.cpu().numpy()
    out = np.zeros(leaf.shape[0], np.int64)
    for b, node in enumerate(leaf):
        while node != 0:
            node = parent[node, b]
            out[b] += 1
    return out


def _descend_bytes(cols, walk) -> int:
    """Bytes the walk of this snapshot must move, counted by element (4 B
    each; 32-byte sectors would count more). Per game: the root's n and
    eany; where the walk starts, the parent column (rows 0..N-2) once, and
    per node it scores, that node's v and nbp and the q, n and edge_prior
    of its children; per child it steps to, its parent_action and eany;
    nba where it ends on a new edge; and the five [B] outputs."""
    parent = cols[0].cpu().numpy()
    node, _, child, depth = (x.cpu().numpy().astype(np.int64)
                             for x in walk[:4])
    N, B = parent.shape
    games = np.arange(B)
    kids = np.zeros((N, B), np.int64)
    r, b = np.nonzero(parent[:N - 1] >= 0)
    np.add.at(kids, (parent[r, b], b), 1)
    walked = depth > 0
    new_edge = walked & (child < 0)
    elems = B * (2 + 5) + int(walked.sum()) * (N - 1)
    elems += 2 * int((depth - new_edge).sum()) + int(new_edge.sum())
    # The scored nodes are the final node (if the walk ended on a new
    # edge) or its parent, and their ancestors up to the root.
    cur = np.where(child < 0, node, parent[node, games])
    live = walked.copy()
    scored = np.zeros(B, np.int64)
    while live.any():
        elems += int((2 + 3 * kids[cur, games])[live].sum())
        scored += live
        live &= cur != 0
        cur = np.where(live, parent[cur, games], 0)
    check(np.array_equal(scored, depth),
          "descend byte count: the host path disagrees with the depths")
    return elems * 4


def time_descend(cols, spec, device, reps: int) -> dict:
    """The game-minor descend kernel's times on the columns ``cols`` (cold
    with L2 flushed, warm, per wrapper call, host, plain) and what its
    bound needs (the walks' steps and bytes)."""
    host_calls = HOST_CALLS if torch.device(device).type == "cuda" else reps
    walk = OD.descend_columns(*cols, spec)
    launch = lambda: OD.descend_columns(*cols, spec)  # noqa: E731
    N, B = cols[0].shape
    return dict(
        ms=kernel_ms(launch, reps, device, "descend_kernel", flush_l2=True),
        ms_l2_warm=kernel_ms(launch, reps, device, "descend_kernel"),
        call_ms=time_ms(launch, reps, device),
        host_ms=host_ms(launch, host_calls, device),
        plain_ms=time_ms(lambda: OD.descend_plain(
            *cols, spec.cpuct, spec.fpu_reduction), 3, device),
        N=N, B=B, depth_sum=int(walk[3].sum().item()),
        depth_max=int(walk[3].max().item()), bytes=_descend_bytes(cols, walk))


def time_backup(args, nqv, spec, device, reps: int,
                by_threads: bool = False) -> dict:
    """The game-minor backup kernel's times from the state ``args``
    (parent, player, leaf, values, max_depth) and ``nqv``, on copies of
    n, q, v (cold, warm, per wrapper call, host, plain; with
    ``by_threads``, cold at each block size of ``BACKUP_THREADS``) and the
    path lengths its bound needs."""
    host_calls = HOST_CALLS if torch.device(device).type == "cuda" else reps
    scratch = [x.clone() for x in nqv]
    paths = _path_lengths(args[0], args[2])

    def launch(threads=OB.THREADS):
        OB.backup_columns_(*args, *scratch, spec, threads=threads)

    out = dict(
        ms=kernel_ms(launch, reps, device, "backup_kernel", flush_l2=True),
        ms_l2_warm=kernel_ms(launch, reps, device, "backup_kernel"),
        call_ms=time_ms(launch, reps, device),
        host_ms=host_ms(launch, host_calls, device),
        plain_ms=time_ms(lambda: OB.backup_plain_(*args, *scratch, spec), 3,
                         device),
        N=args[0].shape[0], B=args[0].shape[1], path_sum=int(paths.sum()),
        path_max=int(paths.max()))
    if by_threads:
        out["ms_by_threads"] = {t: kernel_ms(
            lambda: launch(t), reps, device, "backup_kernel", flush_l2=True)
            for t in BACKUP_THREADS}
    return out


def kernel_phase(env, eval_fn, spec, batch: int, sims: int, snapshots,
                 device, reps: int = 50, timed: bool = True,
                 opening_plies: int = 6):
    """Both kernels against their plain versions at each snapshot of one
    fresh-tree search from random openings of up to ``opening_plies``
    plies, and, with ``timed``, their times and the bytes their work needs
    at the last snapshot."""
    last = snapshots[-1] if timed else None
    gen = torch.Generator(device).manual_seed(SEED)
    roots = random_openings(env, batch, opening_plies, gen, device)
    tt = init_tree_t(env, roots, sims + 2, spec.value_size)
    S._simulate_step_t(env, tt, spec, eval_fn, root_adjust=True, slot=0,
                       expand_root_only=True, generator=gen)
    errs = {"descend": 0.0, "backup": 0.0}
    timing = {}
    for slot in range(1, sims):
        if slot not in snapshots:
            S._simulate_step_t(env, tt, spec, eval_fn, root_adjust=False,
                               slot=slot, generator=gen)
            continue
        cols = _descend_inputs(tt)
        where = f"at N={tt.parent.shape[0]}, B={batch}, after {slot} sims"
        errs["descend"] = max(errs["descend"],
                              compare_descend(cols, spec, where))
        if slot == last:
            timing["descend"] = time_descend(cols, spec, device, reps)
        values = S._leaf_step_t(env, tt, spec, eval_fn, False, slot, False,
                                gen)
        args = (tt.parent, tt.player, tt.leaf, values, tt.max_depth)
        errs["backup"] = max(errs["backup"], compare_backup(
            args, (tt.n, tt.q, tt.v), spec, where))
        if slot == last:
            timing["backup"] = time_backup(args, (tt.n, tt.q, tt.v), spec,
                                           device, reps, by_threads=True)
        OB.backup_batched_t(tt, values, spec)
        log(f"  snapshot after {slot} sims: descend and backup agree "
            f"(max errors {errs['descend']:.3g}, {errs['backup']:.3g})")
    check(torch.equal(tt.n[0], torch.full_like(tt.n[0], sims)),
          "root visits after the kernel-phase search != sims")
    return errs, timing


def random_tree_phase(spec, device, nodes=RANDOM_NODES,
                      batches=RANDOM_BATCHES):
    """All four kernels against their plain versions, bit for bit, on
    seeded random trees (utils/random_tree.py) of every size in ``nodes``
    and every game count in ``batches``: the game-minor kernels on the
    trees as made, the batch-major ones on the same trees transposed to
    [B, N]. A discount below 1 exercises the backup's exp. Returns the max
    abs errors."""
    spec = spec._replace(min_discount=0.8)
    errs = dict.fromkeys(COUNTED, 0.0)
    rows_of = {name for name, _ in DESCEND_COLUMNS} | {"player"}
    for N in nodes:
        for B in batches:
            made = random_tree(N, B, seed=SEED + N * 7 + B,
                               num_players=spec.num_players,
                               has_draw=spec.has_draw)
            for rows in (False, True):
                tree = {k: torch.from_numpy(
                    np.ascontiguousarray(x.T) if rows and k in rows_of
                    else x).to(device) for k, x in made.items()}
                where = (f"on a random tree, N={N}, B={B}"
                         + (", batch-major" if rows else ""))
                suffix = "_rows" if rows else ""
                cols = [tree[name] for name, _ in DESCEND_COLUMNS]
                errs["descend" + suffix] = max(
                    errs["descend" + suffix],
                    compare_descend(cols, spec, where, rows))
                args = [tree[k] for k in ("parent", "player", "leaf",
                                          "value", "max_depth")]
                errs["backup" + suffix] = max(
                    errs["backup" + suffix],
                    compare_backup(args, [tree[k] for k in "nqv"], spec,
                                   where, rows))
            log(f"  random trees N={N} (games per descend block "
                f"{OD.games_per_block(N)}), B={B}: the four kernels equal "
                "bit for bit")
    return errs


def reference_phase(env, device, batch: int = 256, sims: int = 64,
                    rows: int = 4093):
    """A whole search through the kernels on ``device`` against the same
    search through the plain versions on the CPU (a table evaluation of
    ``rows`` rows)."""
    spec = T.SearchSpec(add_root_noise=False, tie_noise=0.0)
    eval_fn = table_eval_fn(env, spec.value_size, rows=rows)
    gen = torch.Generator("cpu").manual_seed(SEED + 1)
    roots = random_openings(env, batch, 8, gen, "cpu")
    trees = []
    for dev in (device, "cpu"):
        on_dev = env.State(**{k: x.to(dev)
                              for k, x in state_items(roots).items()})
        tt = init_tree_t(env, on_dev, sims + 2, spec.value_size)
        trees.append(S.search(env, tt, spec, eval_fn, sims))
    got, want = trees
    for name in ("n", "parent", "parent_action"):
        check(torch.equal(getattr(got, name)[:-1].cpu(),
                          getattr(want, name)[:-1]),
              f"reference search: {name} differs between {device} and cpu")
    err = (got.q.cpu() - want.q).abs().max().item()
    check(err <= TOL_FLOAT, f"reference search: q error {err}")
    log(f"  {env.NAME}: {batch} games x {sims} sims on {device} == cpu "
        f"(n, parent, parent_action equal; q max error {err:.3g}; deepest "
        f"walk {int(want.max_depth.max())})")


def reference_reuse_phase(env, device, batch: int = 256, sims=(16, 64)):
    """Reuse moves (a fast one, then a full one on the carried trees)
    through the batch-major kernels on ``device`` against the same moves
    through the plain versions on the CPU, with the same Gumbel noise."""
    spec = T.SearchSpec(add_root_noise=False, tie_noise=0.0)
    cfg = SelfPlayConfig(sims_full=sims[1], sims_fast=sims[0],
                         reuse_tree=True, spec=spec)
    eval_fn = table_eval_fn(env, spec.value_size)
    gen = torch.Generator("cpu").manual_seed(SEED + 5)
    roots = random_openings(env, batch, 8, gen, "cpu")
    rng = np.random.default_rng(SEED + 5)
    gumbels = [torch.from_numpy(rng.gumbel(size=(batch, env.ACTION_SIZE))
                                .astype(np.float32)) for _ in sims]
    runs = []
    for dev in (device, "cpu"):
        states = env.State(**{k: x.to(dev)
                              for k, x in state_items(roots).items()})
        carry = SelfPlayState(
            env_state=states,
            temps=torch.ones(batch, device=dev),
            games_played=torch.zeros((), dtype=torch.int32, device=dev),
            move_count=torch.zeros((), dtype=torch.int32, device=dev),
            trees=T.init_tree(env, states, cfg.capacity, spec.value_size))
        actions = []
        for k, n_sims in enumerate(sims):
            carry, rec = move_step(env, cfg, eval_fn, carry, n_sims,
                                   fast=k == 0, gumbel=gumbels[k].to(dev))
            actions.append(rec.action.cpu())
        runs.append((carry.trees, actions))
    (got, got_a), (want, want_a) = runs
    for k, (a, b) in enumerate(zip(got_a, want_a)):
        check(torch.equal(a, b), f"reuse reference: move {k} actions differ")
    for name in ("n", "parent", "parent_action", "nba"):
        check(torch.equal(getattr(got, name)[:, :-1].cpu(),
                          getattr(want, name)[:, :-1]),
              f"reuse reference: {name} differs between {device} and cpu")
    check(torch.equal(got.next_free.cpu(), want.next_free),
          "reuse reference: next_free differs")
    err = (got.q[:, :-1].cpu() - want.q[:, :-1]).abs().max().item()
    check(err <= TOL_FLOAT, f"reuse reference: q error {err}")
    carried = int((want.next_free > 1).sum())
    check(carried > 0, "reuse reference: no tree was carried")
    log(f"  {batch} games x reuse moves of {sims} sims on {device} == cpu "
        f"(actions, n, links equal; q max error {err:.3g}; "
        f"{carried} trees carried)")


def _dense_pi(env, rec, kind: str) -> torch.Tensor:
    """The float32 policy rows [B, A] of a non-fast move record: as they
    are, or, where the record is sparse (A >= 512), its top-(sims + 1)
    values scattered to their action ids on the card."""
    if rec.pi_idx is None:
        check(rec.pi.shape[1] == env.ACTION_SIZE,
              f"{kind} move: a dense policy of width {rec.pi.shape[1]}")
        return rec.pi.float()
    check(rec.pi.shape == rec.pi_idx.shape and rec.pi_idx.dtype ==
          torch.int32 and rec.pi.shape[1] < env.ACTION_SIZE,
          f"{kind} move: sparse policy record of shape {rec.pi.shape} / "
          f"{rec.pi_idx.shape}")
    dense = torch.zeros((rec.pi.shape[0], env.ACTION_SIZE),
                        dtype=torch.float32, device=rec.pi.device)
    return dense.scatter_(1, rec.pi_idx.long(), rec.pi.float())


def selfplay_phase(env, model, cfg, batch: int, cycle, device,
                   openings=None):
    """Moves of the config ``cfg`` through make_move_fns, from the start
    position or from ``openings``. Resets every kernel's launch counter
    just before and reads them just after: on fresh trees each simulation
    runs the game-minor backup, and the game-minor descent but on the
    first (which expands the root without a walk); with tree reuse each
    simulation runs both batch-major kernels; no other kernel and no plain
    version runs. Each non-fast move's policy rows (densified where the
    record is sparse) must be float16, sum to 1 and lie on valid
    actions."""
    fns = make_move_fns(env, cfg, model)
    carry = init_selfplay(env, batch, device=device, cfg=cfg)
    if openings is not None:
        carry.env_state = openings
        if cfg.reuse_tree:
            carry.trees = T.init_tree(env, openings, cfg.capacity,
                                      cfg.spec.value_size)
    gen = torch.Generator(device).manual_seed(SEED + 2)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    sync(device)
    reset_counts()
    moves = []
    restarts = {"done": 0, "overflow": 0}
    games = torch.arange(batch, device=device)
    with _PlainCounter(OD, "descend_plain") as pd, \
            _PlainCounter(OB, "backup_plain_") as pb:
        for kind in cycle:
            sims = cfg.sims_fast if kind == "fast" else cfg.sims_full
            before = carry.env_state
            t0 = time.perf_counter()
            carry, rec = fns[kind](carry, generator=gen)
            sync(device)
            dt = time.perf_counter() - t0
            moves.append((kind, sims, dt))
            if cfg.reuse_tree:  # carried roots hold earlier visits too
                check(bool((rec.root_visits >= sims).all()),
                      f"{kind} move: root visits < {sims}")
                restarts["done"] += int((rec.tree_reset & rec.done).sum())
                restarts["overflow"] += int((rec.tree_reset
                                             & ~rec.done).sum())
            else:
                check(bool((rec.root_visits == sims).all()),
                      f"{kind} move: root visits != {sims}")
            valid = env.valid_moves(before)
            if kind == "fast":  # slimmed: fast samples are never stored
                check(rec.pi is None and rec.obs is None,
                      "fast move: the record still carries obs or pi")
            else:
                check(rec.pi.dtype == torch.float16
                      and bool(torch.isfinite(rec.pi).all()),
                      f"{kind} move: policy dtype or values wrong")
                pi = _dense_pi(env, rec, kind)
                check(bool(torch.allclose(pi.sum(-1), torch.ones_like(
                    pi[:, 0]), rtol=0, atol=PI16_ATOL)),
                      f"{kind} move: a policy row does not sum to 1")
                check(not bool(((pi > 0) & ~valid).any()),
                      f"{kind} move: policy mass on an invalid action")
            check(bool(valid[games, rec.action.long()].all()),
                  f"{kind} move: illegal action")
            log(f"  {kind} move: {sims} sims x {batch} games in {dt:.3f} s "
                f"= {batch * sims / dt:,.0f} sims/s")
    launches = read_counts()
    by_rows = read_counts_by_rows()
    total = sum(s for _, s, _ in moves)
    expect = dict.fromkeys(COUNTED, 0)
    if cuda:  # the plain versions run on the CPU and launch nothing
        if cfg.reuse_tree:
            expect.update(descend_rows=total, backup_rows=total)
        else:
            expect.update(descend=total - len(moves), backup=total)
            want = fresh_launches_by_rows(cfg, moves)
            got = {k: by_rows[k] for k in want}
            check(got == want, f"kernel launches by tree rows {got} != "
                  f"the segments' {want}")
        check(pd.calls == 0 and pb.calls == 0,
              f"plain versions ran on the card ({pd.calls} descend, "
              f"{pb.calls} backup)")
    check(launches == expect,
          f"kernel launches {launches} != expected {expect}")
    carried = 0
    if cfg.reuse_tree:
        carried = int((carry.trees.next_free > 1).sum())
        check(carried > 0, "no tree was carried into the next move")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    total_s = sum(dt for _, _, dt in moves)
    return dict(moves=moves, launches=launches, launches_by_rows=by_rows,
                sims_per_s=batch * total / total_s,
                wall_ms_per_sim=total_s * 1e3 / total, peak_bytes=peak,
                restarts=restarts, carried=carried, carry=carry, fns=fns,
                generator=gen)


def _clone_tree(tree):
    return dataclasses.replace(
        tree, node_state={k: x.clone() for k, x in tree.node_state.items()},
        **{k: getattr(tree, k).clone() for k in T.TREE_TENSORS})


def rows_kernel_phase(env, eval_fn, spec, tree, sims: int, snapshots,
                      device, reps: int = 50):
    """The batch-major kernels against their plain versions at each
    snapshot of a ``sims``-simulation search on (a copy of) the carried
    trees ``tree``, and at the last snapshot their times, the bytes their
    work needs, and the JAX package's route on the card: the columns
    transposed to [N, B], the game-minor kernel, and (backup) the results
    transposed back."""
    gen = torch.Generator(device).manual_seed(SEED + 4)
    host_calls = HOST_CALLS if torch.device(device).type == "cuda" else reps
    tree = _clone_tree(tree)
    errs = {"descend_rows": 0.0, "backup_rows": 0.0}
    timing = {}
    N, B = tree.parent.shape[1], tree.parent.shape[0]
    carried = int((tree.next_free > 1).sum())
    for k in range(sims):
        if k not in snapshots:
            S.simulate_step(env, tree, spec, eval_fn, root_adjust=k == 0,
                            generator=gen)
            continue
        where = f"at N={N}, B={B}, after {k} sims on carried trees"
        eany = (tree.e > 0).any(dim=-1).to(torch.float32)
        cols = (tree.parent, tree.parent_action, tree.n, tree.q, tree.v,
                tree.edge_prior, eany, tree.nba, tree.nbp)
        errs["descend_rows"] = max(errs["descend_rows"], compare_descend(
            cols, spec, where, rows=True))
        last = k == snapshots[-1]
        if last:
            walk = OD.descend_rows(*cols, spec)
            launch = lambda: OD.descend_rows(*cols, spec)  # noqa: E731

            def jax_route():
                return OD.descend_columns(*(c.t().contiguous()
                                            for c in cols), spec)

            timing["descend_rows"] = dict(
                ms=kernel_ms(launch, reps, device, "descend_rows_kernel",
                             flush_l2=True),
                ms_l2_warm=kernel_ms(launch, reps, device,
                                     "descend_rows_kernel"),
                call_ms=time_ms(launch, reps, device),
                host_ms=host_ms(launch, host_calls, device),
                plain_ms=time_ms(lambda: OD.descend_plain(
                    *(c.t() for c in cols), spec.cpuct, spec.fpu_reduction),
                    3, device),
                jax_route_ms=device_ms(jax_route, reps, device,
                                       "descend_kernel", flush_l2=True),
                jax_route_call_ms=time_ms(jax_route, reps, device),
                N=N, B=B, depth_sum=int(walk[3].sum().item()),
                depth_max=int(walk[3].max().item()),
                bytes=_descend_bytes([c.t() for c in cols], walk))
        values = S._leaf_step(env, tree, spec, eval_fn, k == 0, gen)
        args = (tree.parent, tree.player, tree.leaf, values, tree.max_depth)
        errs["backup_rows"] = max(errs["backup_rows"], compare_backup(
            args, (tree.n, tree.q, tree.v), spec, where, rows=True))
        if last:
            scratch = [tree.n.clone(), tree.q.clone(), tree.v.clone()]
            paths = _path_lengths(tree.parent.t(), tree.leaf)

            def launch():
                OB.backup_rows_(*args, *scratch, spec)

            def jax_route():
                nqv = [x.t().contiguous() for x in scratch]
                OB.backup_columns_(args[0].t().contiguous(),
                                   args[1].t().contiguous(), *args[2:],
                                   *nqv, spec)
                for x, y in zip(scratch, nqv):
                    x.copy_(y.t())

            timing["backup_rows"] = dict(
                ms=kernel_ms(launch, reps, device, "backup_rows_kernel",
                             flush_l2=True),
                ms_l2_warm=kernel_ms(launch, reps, device,
                                     "backup_rows_kernel"),
                call_ms=time_ms(launch, reps, device),
                host_ms=host_ms(launch, host_calls, device),
                plain_ms=time_ms(lambda: OB.backup_plain_(
                    args[0].t(), args[1].t(), *args[2:],
                    *(x.t() for x in scratch), spec), 3, device),
                jax_route_ms=device_ms(jax_route, reps, device,
                                       "backup_kernel", flush_l2=True),
                jax_route_call_ms=time_ms(jax_route, reps, device),
                N=N, B=B, path_sum=int(paths.sum()), path_max=int(paths.max()))
        OB.backup_batched(tree, values, spec)
        log(f"  snapshot after {k} sims on carried trees: descend_rows and "
            f"backup_rows agree (max errors {errs['descend_rows']:.3g}, "
            f"{errs['backup_rows']:.3g})")
    check(bool((tree.n[:, 0] >= sims).all()),
          "root visits after the search on carried trees < sims")
    timing["carried"] = carried
    return errs, timing


def in_place_phase(fn, device, names=("descend_rows_kernel",
                                      "backup_rows_kernel")) -> dict:
    """Device milliseconds per launch of each kernel in ``names`` over one
    call of ``fn`` under torch.profiler (on the card; empty on the CPU)."""
    if torch.device(device).type != "cuda":
        fn()
        return {}
    with torch.profiler.profile(activities=PROFILED) as prof:
        fn()
        sync(device)
    out = {}
    for name in names:
        hits = [e for e in _device_kernels(prof) if name in e.key]
        count = sum(e.count for e in hits)
        check(count > 0, f"profiler saw no launch of {name}")
        out[name] = (sum(e.self_device_time_total for e in hits) / 1e3
                     / count, count)
    return out


STAGES = ("descend", "expand", "network", "install", "backup")


def breakdown_phase(env, eval_fn, spec, batch: int, sims: int, device):
    """Where the time of one fresh-tree search goes (the search of a fast
    move at full width).

    First run: per stage of a simulation, the device time between CUDA
    events recorded at the stage boundaries and the host time spent
    enqueueing the stage; the host never waits inside the loop. Where the
    device time of a stage is close to its host time, the device was
    waiting for the host. Second run, on the card only: a torch.profiler
    trace, for the device's busy share and the kernels that take its time.
    """
    from alphazero_general_tpu_torch.mcts import tree_t as TT

    cuda = torch.device(device).type == "cuda"
    gen = torch.Generator(device).manual_seed(SEED + 3)
    roots = random_openings(env, batch, 6, gen, device)

    def search(mark):
        tt = init_tree_t(env, roots, sims + 2, spec.value_size)
        S._simulate_step_t(env, tt, spec, eval_fn, root_adjust=True,
                           slot=0, expand_root_only=True, generator=gen)
        for slot in range(1, sims):
            mark(0)
            walk = OD.descend_batched_t(tt, spec)
            mark(1)
            obs, leaf_e, valid = TT.apply_walk_observe_t(env, tt, *walk,
                                                         slot)
            mark(2)
            pi, value = eval_fn(obs)
            mark(3)
            values = torch.where((leaf_e > 0).any(-1, keepdim=True), leaf_e,
                                 value)
            TT.install_prior_t(tt, pi, spec, False, slot, valid,
                               generator=gen)
            mark(4)
            OB.backup_batched_t(tt, values, spec)
            mark(5)

    marks = []

    def mark(i):
        ev = None
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        marks.append((i, time.perf_counter(), ev))

    search(lambda i: None)  # warm-up: allocator, cuDNN algorithm choice
    sync(device)
    t0 = time.perf_counter()
    search(mark)
    sync(device)
    wall = time.perf_counter() - t0
    host = dict.fromkeys(STAGES, 0.0)
    dev = dict.fromkeys(STAGES, 0.0)
    for (i, h0, e0), (_, h1, e1) in zip(marks[:-1], marks[1:]):
        if i == 5:
            continue  # between simulations
        host[STAGES[i]] += (h1 - h0) * 1e3
        if cuda:
            dev[STAGES[i]] += e0.elapsed_time(e1)
    n = sims - 1
    log(f"  one {sims}-sim search at B={batch}: {wall * 1e3 / sims:.3f} ms "
        "per simulation (host clock)")
    for st in STAGES:
        log(f"    {st:8s} device {dev[st] / n:.4f} ms/sim, host enqueue "
            f"{host[st] / n:.4f} ms/sim")
    out = dict(wall_ms_per_sim=wall * 1e3 / sims,
               device_ms={k: v / n for k, v in dev.items()},
               host_ms={k: v / n for k, v in host.items()})
    if not cuda:
        return out

    with torch.profiler.profile(activities=PROFILED) as prof:
        t0 = time.perf_counter()
        search(lambda i: None)
        sync(device)
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"  profiler: device busy {busy_us / 1e3:.1f} ms of a "
        f"{window_us / 1e3:.1f} ms window ({100 * busy_us / window_us:.1f}%"
        f"), {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    for name in ("descend_kernel", "backup_kernel"):
        hits = [e for e in kernels if name in e.key]
        t = sum(e.self_device_time_total for e in hits) / 1e3
        c = sum(e.count for e in hits)
        log(f"    {name}: {t:.3f} ms over {c} launches "
            f"({t / max(c, 1):.4f} ms each)")
    out.update(busy_share=busy_us / window_us,
               launches_per_sim=sum(e.count for e in kernels) / sims)
    return out


#: The Coach phase: the connect4 preset (envs/presets.py: 2048 games in
#: lockstep, 200 full / 40 fast simulations at probFastSim 0.75, ResNet
#: 128 x 8 with [1024, 256] / [1024] heads, train batch 1024) through
#: ``cli.train.main``, cut to two iterations (the first a warmup one), one
#: lockstep batch of games a self-play iteration (preset: 8192 games),
#: arenas of 128 games (preset: 512) after iteration 1 only (preset: both
#: arenas every iteration; the cut leaves room for the brandubh Coach in
#: the script's time), at the JAX default ``quant_selfplay=True``: both
#: arenas play the int8 tower calibrated on random playouts, iteration 2's
#: self-play the int8 tower calibrated on iteration 1's replay.
#: The gate promotes whatever wins at least 0 (preset: 0.52), so that
#: iteration 2 always plays the trained network: a model trained
#: on one warmup iteration may lose the past arena, and self-play would
#: stay on the warmup runner.
COACH_CUTS = dict(numIters=2, numWarmupIters=1, gamesPerIteration=2048,
                  arenaCompare=128, arenaCompareBaseline=128,
                  baselineCompareFreq=2, pastCompareFreq=2,
                  min_next_model_winrate=0.0)
#: A float32 train step on the card against the same step on the CPU:
#: params and batch statistics agree within these (cuDNN's and the CPU's
#: float32 sums differ in order; TF32 is off).
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5
#: Batch of that step (full width; the CPU's step sets its size).
TRAIN_CHECK_BATCH = 256
#: Train steps timed at the preset's batch and compute dtype.
TRAIN_TIMED_STEPS = 20


def coach_shapes_phase(env, net, device, args) -> dict:
    """Both game-minor kernels against their plain versions at the shapes
    that only the Coach cycle gives them, as ``args`` (the Coach's) set
    them: an arena round's search (``arenaCompare`` games, ``numMCTSSims``
    simulations, no root noise), held after a quarter and after all but
    one of its simulations, and a warmup move's (``process_batch_size``
    games, ``numWarmupSims`` simulations of the uniform evaluation), held
    after each simulation. Returns the max errors."""
    errs = {"descend": 0.0, "backup": 0.0}
    arena = ArenaConfig.from_args(args, env.NUM_PLAYERS, env.HAS_DRAW)
    warm = SelfPlayConfig.from_args(args, env.NUM_PLAYERS, env.HAS_DRAW)
    uniform = S.uniform_eval_fn(env.ACTION_SIZE, warm.spec.value_size,
                                uniform_value=True)
    for what, eval_fn, spec, batch, sims, snapshots in (
            ("arena round", net.make_eval_fn(), arena.spec,
             int(args.arenaCompare), arena.sims,
             (arena.sims // 4, arena.sims - 1)),
            ("warmup move", uniform, warm.spec, int(args.process_batch_size),
             warm.sims_warmup, tuple(range(1, warm.sims_warmup)))):
        log(f"  the search of a {what}: B={batch}, {sims} simulations")
        e, _ = kernel_phase(env, eval_fn, spec, batch, sims, snapshots,
                            device, timed=False)
        errs = {k: max(errs[k], e[k]) for k in errs}
    return errs


def _read_metrics(path) -> dict:
    """tag -> {step: value} from a metrics.jsonl."""
    out = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            out.setdefault(r["tag"], {})[r["step"]] = r["value"]
    return out


class _Patched:
    """Installs ``fn`` as ``module.name`` while entered."""

    def __init__(self, module, name, fn):
        self.module, self.name, self.fn = module, name, fn
        self.orig = getattr(module, name)

    def __enter__(self):
        setattr(self.module, self.name, self.fn)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class _PlainCounter(_Patched):
    """Counts calls of a kernel's plain version while installed in its
    module (the wrappers look it up there)."""

    def __init__(self, module, name):
        super().__init__(module, name, self._count)
        self.calls = 0

    def _count(self, *a, **k):
        self.calls += 1
        return self.orig(*a, **k)


def selfplay_net_calls(args, moves: int, sims: int) -> int:
    """Network calls of a non-warmup self-play iteration of ``moves`` fast
    and full moves that searched ``sims`` simulations in all, at the
    args' ``leaf_batch`` (``net_calls``): the full moves' count follows
    from the two totals."""
    fast, full = int(args.numFastSims), int(args.numMCTSSims)
    k = int(args.get("leaf_batch", 1))
    if k == 1:
        return sims
    if fast == full:
        return moves * len(net_calls(full, k))
    n_full, rest = divmod(sims - fast * moves, full - fast)
    check(rest == 0 and 0 <= n_full <= moves,
          f"{moves} moves of {fast} or {full} simulations cannot make "
          f"{sims}")
    return ((moves - n_full) * len(net_calls(fast, k))
            + n_full * len(net_calls(full, k)))


def coach_phase(device, root: str, sets: dict,
                env_name: str = "connect4", resume: dict = None) -> dict:
    """One Coach cycle of ``env_name``'s preset through ``cli.train.main``,
    cut by ``sets``, in ``root``; with ``resume``, a second call with
    those sets resumes the run (``load_model``, the default) where the
    first ended. Then every check of the cycle from its files and metrics
    (the arenas its schedule ran, and no others), and the launch counters
    against the searches it ran."""
    from alphazero_general_tpu_torch.cli import train as cli_train

    env = get_env(env_name)
    args = preset_args(env_name, **(resume or sets))
    dirs = dict(run_name="smoke", checkpoint=f"{root}/checkpoint",
                data=f"{root}/data", log_dir=f"{root}/runs")
    argvs = []
    for cut in [sets] + ([resume] if resume else []):
        argv = [env_name, "--device", str(torch.device(device).type)]
        for k, v in {**cut, **dirs}.items():
            argv += ["--set", f"{k}={v!r}"]
        argvs.append(argv)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    sync(device)
    reset_counts()
    Q.QuantResNet.forwards = 0
    with _PlainCounter(OD, "descend_plain") as pd, \
            _PlainCounter(OB, "backup_plain_") as pb:
        t0 = time.perf_counter()
        for argv in argvs:
            check(cli_train.main(argv) == 0,
                  f"cli.train.main {argv} did not return 0")
        sync(device)
        wall = time.perf_counter() - t0
    launches = read_counts()
    by_rows = read_counts_by_rows()
    int8_forwards = Q.QuantResNet.forwards
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    ckpt = os.path.join(dirs["checkpoint"], "smoke")
    iters = int(args.numIters)
    for it in range(iters + 1):
        for ext in (".ckpt", ".json"):
            check(os.path.isfile(f"{ckpt}/iteration-{it:04d}{ext}"),
                  f"coach: no checkpoint iteration-{it:04d}{ext}")
    m = _read_metrics(f"{dirs['log_dir']}/smoke/metrics.jsonl")
    for prefix in ("loss/", "win_rate/", "time/"):
        check(any(t.startswith(prefix) for t in m),
              f"coach: no {prefix}* metric")
    store = ReplayStore(dirs["data"], "smoke")
    batch = int(args.train_batch_size)
    searches = simulations = 0
    out = dict(wall=wall, launches=launches, launches_by_rows=by_rows,
               peak_bytes=peak, iters={},
               games_per_batch=int(args.process_batch_size), env=env_name,
               cuts=dict(sets, resumed_to=resume["numIters"]) if resume
               else sets)
    sims = int(args.numMCTSSims)
    # The arena schedule of Coach.learn: (kind, games knob, runs or not,
    # every how many iterations).
    arenas = (("baseline", "arenaCompareBaseline",
               bool(args.compareWithBaseline), int(args.baselineCompareFreq)),
              ("past", "arenaCompare", bool(args.compareWithPast),
               int(args.pastCompareFreq)))
    prev_gate = 0
    # The int8 tower plays self-play after the warmup and every arena under
    # quant_selfplay (the ResNet has an int8 path): one forward a
    # simulation in self-play, one a seat and simulation in an arena.
    quant = bool(args.quant_selfplay)
    expect_forwards = 0
    # The gate the cut replaces: the preset's winrate, whose "keep" branch
    # the CPU parity tests hold to the JAX Coach.
    preset_gate = float(preset_args(env_name).min_next_model_winrate)
    for it in range(1, iters + 1):
        if resume and it == int(sets["numIters"]) + 1 \
                and resume.get("selfPlayModelIter"):
            # The resumed Coach's self-play model (coach.py:91-95).
            prev_gate = min(int(resume["selfPlayModelIter"]), it - 1)
        obs, pi, value = store.load(it)
        n = int(m["self_play/samples"][it])
        check(len(obs) == len(pi) == len(value) == n and n > 0,
              f"coach: iteration {it} stored {len(obs)} samples, the "
              f"finalizer counted {n}")
        check(obs.shape[1:] == env.OBS_SHAPE
              and pi.shape[1] == env.ACTION_SIZE,
              f"coach: iteration {it} rows of shapes {obs.shape[1:]} / "
              f"{pi.shape[1:]}")
        check(bool(np.isfinite(obs).all()), f"coach: iteration {it} obs")
        check(np.allclose(pi.astype(np.float32).sum(-1), 1, rtol=0,
                          atol=PI16_ATOL),
              f"coach: iteration {it}: a pi row does not sum to 1")
        check(bool((value.sum(-1) == 1).all() and (value.max(-1) == 1)
                   .all()), f"coach: iteration {it}: a value is not one-hot")
        for tag in ("loss/policy", "loss/value"):
            check(np.isfinite(m[tag][it]), f"coach: {tag} not finite")
        units = n * env.NUM_SYMMETRIES  # raw files: trained symmetrised
        check(m["train/steps"][it] == max(units // batch, 1),
              f"coach: iteration {it} ran {m['train/steps'][it]} train "
              f"steps, autoTrainSteps gives {max(units // batch, 1)}")
        rec = dict(samples=n, games=m["self_play/games"][it],
                   moves=m["self_play/moves"][it],
                   self_play_sims=m["self_play/simulations"][it],
                   train_steps=m["train/steps"][it],
                   loss=(m["loss/policy"][it], m["loss/value"][it]))
        searches += int(rec["moves"])
        simulations += int(rec["self_play_sims"])
        warmup = it <= int(args.numWarmupIters) or prev_gate == 0
        rec["int8"] = {"self_play": m["self_play/int8"][it]}
        check(rec["int8"]["self_play"] == float(quant and not warmup),
              f"coach: iteration {it} self-play int8 flag "
              f"{rec['int8']['self_play']}, quant_selfplay={quant}")
        if rec["int8"]["self_play"]:
            expect_forwards += selfplay_net_calls(
                args, int(rec["moves"]), int(rec["self_play_sims"]))
        want_gate = prev_gate
        for kind, knob, on, freq in arenas:
            ran = on and int(args[knob]) > 0 and (it - 1) % freq == 0
            check(ran == (it in m.get(f"arena_{kind}/games", {})),
                  f"coach: the {kind} arena of iteration {it} "
                  f"{'did not run' if ran else 'ran'} against the schedule")
            if not ran:
                continue
            a = {t: m[f"arena_{kind}/{t}"][it] for t in
                 ("rounds", "games", "wins_new", "wins_other", "draws")}
            check(a["wins_new"] + a["wins_other"] + a["draws"] == a["games"]
                  == int(args[knob]),
                  f"coach: {kind} arena wins and draws != games: {a}")
            wr = (a["wins_new"] + 0.5 * a["draws"]) / a["games"]
            check(abs(wr - m[f"win_rate/{kind}"][it]) < 1e-6,
                  f"coach: {kind} winrate {m[f'win_rate/{kind}'][it]} != "
                  f"{wr} from its wins and draws")
            searches += int(a["rounds"])
            simulations += int(a["rounds"]) * sims
            rec[kind] = a
            rec["int8"][kind] = m[f"arena_{kind}/int8"][it]
            check(rec["int8"][kind] == float(quant),
                  f"coach: the {kind} arena of iteration {it} int8 flag "
                  f"{rec['int8'][kind]}, quant_selfplay={quant}")
            expect_forwards += int(rec["int8"][kind]) * int(a["rounds"]) \
                * sims * (2 if kind == "past" else 1)
            if kind == "past":
                # Gating under the preset's rule ("reference", no cap).
                want_gate = it if wr >= float(
                    args.min_next_model_winrate) else prev_gate
                rec["preset_gate"] = (preset_gate, "promote it" if wr >=
                                      preset_gate else "keep the past model")
        check(m["win_rate/self_play_model"][it] == want_gate,
              f"coach: iteration {it} self_play_iter "
              f"{m['win_rate/self_play_model'][it]}, the rule gives "
              f"{want_gate}")
        prev_gate = want_gate
        rec["times"] = {t[5:]: m[t][it] for t in m
                        if t.startswith("time/") and it in m[t]}
        out["iters"][it] = rec
    expect = dict.fromkeys(COUNTED, 0)
    if cuda:  # on the CPU the plain versions run and launch nothing
        expect.update(descend=simulations - searches, backup=simulations)
        check(pd.calls == 0 and pb.calls == 0,
              f"coach: plain versions ran on the card ({pd.calls} descend,"
              f" {pb.calls} backup)")
    check(launches == expect,
          f"coach: kernel launches {launches} != expected {expect} "
          f"({searches} searches, {simulations} simulations)")
    check(int8_forwards == expect_forwards,
          f"coach: {int8_forwards} forwards of the int8 tower, the int8 "
          f"searches need {expect_forwards}")
    out.update(searches=searches, simulations=simulations, ckpt=ckpt,
               store=store, int8_forwards=int8_forwards)
    return out


def train_check_phase(device, model: dict, batch_rows, reps=TRAIN_TIMED_STEPS,
                      timed_batch: int = 1024) -> dict:
    """One float32 train step at full width on ``device`` and on the CPU,
    from the same weights and batch (with device symmetries): params and
    batch statistics within TRAIN_RTOL / TRAIN_ATOL. Then a checkpoint of
    the trained net on ``device``, loaded into a fresh wrapper, must give
    bit-equal outputs; and ``reps`` train steps at ``timed_batch`` in the
    model's own compute dtype are timed, fed two ways (below)."""
    env = get_env("connect4")
    f32 = get_args(seed=SEED, **dict(model, compute_dtype="float32"))
    nets = {d: NNetWrapper(env, f32, device=d) for d in (device, "cpu")}
    nets[device].model.load_state_dict(nets["cpu"].model.state_dict())
    obs, pi, value = (x[:TRAIN_CHECK_BATCH] for x in batch_rows)
    sym = np.random.default_rng(SEED).integers(
        0, env.NUM_SYMMETRIES, len(obs), dtype=np.int32)
    for net in nets.values():
        net.set_device_symmetries(env)
        net.train([(obs, pi, value, sym)], 1)
    sync(device)
    err = 0.0
    want = nets["cpu"].model.state_dict()
    for k, x in nets[device].model.state_dict().items():
        x = x.cpu()
        bad = (x - want[k]).abs() > TRAIN_ATOL + TRAIN_RTOL * want[k].abs()
        check(not bool(bad.any()), f"train step on {device} != cpu at {k}: "
              f"max error {(x - want[k]).abs().max().item():.3g}")
        err = max(err, (x - want[k]).abs().max().item())

    with tempfile.TemporaryDirectory() as tmp:
        nets[device].save_checkpoint(tmp, "check")
        back = NNetWrapper.from_checkpoint(env, tmp, "check", device=device)
    probe = torch.from_numpy(obs.astype(np.float32)).to(device)
    for a, b in zip(nets[device].process(probe), back.process(probe)):
        check(bits_equal(a, b), "checkpoint round trip: outputs differ")

    # Timed steps in the model's own compute dtype. "window": as the Coach
    # feeds them, row indices into the iteration's DeviceWindow and one
    # random symmetry a sample; "host": the same rows as host arrays.
    rng = np.random.default_rng(SEED + 7)
    window = DeviceWindow(env.OBS_SHAPE, env.ACTION_SIZE,
                          env.NUM_PLAYERS + int(env.HAS_DRAW),
                          len(batch_rows[0]), device=device)
    window.add_iteration(1, *batch_rows)
    phys = window.indices_for(1, 1)
    take = [rng.integers(0, len(phys), timed_batch) for _ in range(reps + 1)]
    syms = [rng.integers(0, env.NUM_SYMMETRIES, timed_batch, dtype=np.int32)
            for _ in take]
    feeds = {
        "window": (env, True, [window.buffers + (phys[i], s)
                               for i, s in zip(take, syms)]),
        "host": (None, False, [tuple(x[i] for x in batch_rows)
                               for i in take]),
    }
    out = dict(max_err=err)
    for feed, (sym_env, in_window, batches) in feeds.items():
        timed = NNetWrapper(env, get_args(seed=SEED, **model), device=device)
        timed.set_device_symmetries(sym_env)
        timed.set_device_window(in_window)
        timed.train(batches[:1], 1)  # warm-up: cuDNN's algorithm choice
        sync(device)
        t0 = time.perf_counter()
        timed.train(batches[1:], reps)
        sync(device)
        dt = time.perf_counter() - t0
        out[feed] = dict(steps_per_s=reps / dt,
                         samples_per_s=reps * timed_batch / dt)
        if feed == "window" and torch.device(device).type == "cuda":
            with torch.profiler.profile(activities=PROFILED) as prof:
                t0 = time.perf_counter()
                timed.train(batches[1:], reps)
                sync(device)
                window_us = (time.perf_counter() - t0) * 1e6
            busy_us = sum(e.self_device_time_total
                          for e in _device_kernels(prof))
            out[feed].update(busy_ms_per_step=busy_us / 1e3 / reps,
                             wall_ms_per_step=window_us / 1e3 / reps)
    return out


def launches_per_call(fn, device, reps: int = 3) -> float:
    """Device kernels that one call of ``fn`` launches, from a
    torch.profiler trace of ``reps`` calls (a trace that lost records
    undercounts); on the CPU, 0."""
    if torch.device(device).type != "cuda":
        return 0.0
    fn()
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=PROFILED) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
    return sum(e.count for e in _device_kernels(prof)) / reps


def int8_conv_bound(rows: int, channels: int) -> dict:
    """Least time of one 3x3 tower conv of ``rows`` NHWC rows: operations
    2·rows·9C·C at the int8 (and bf16) tensor-core peak; bytes of the int8
    route with each input read once and the int32 output written once,
    without and with the patch matrix [rows, 9C] written and read again;
    the bf16 conv's bytes. Returns ms and what bounds each."""
    k = 9 * channels
    ops = 2 * rows * k * channels
    int8_bytes = rows * channels + k * channels + rows * channels * 4
    patch_bytes = int8_bytes + 2 * rows * k
    bf16_bytes = 2 * (rows * channels + k * channels + rows * channels)

    def bound(ops_per_s, nbytes):
        t_ops = ops / ops_per_s * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    return dict(ops=ops, int8=bound(INT8_OPS_PER_S, int8_bytes),
                int8_patches=bound(INT8_OPS_PER_S, patch_bytes),
                bf16=bound(BF16_OPS_PER_S, bf16_bytes),
                bytes=(int8_bytes, patch_bytes, bf16_bytes))


def fused_conv_bound(rows: int, channels: int) -> dict:
    """Least time of each fused tower conv kernel (csrc/conv_int8.cu) on
    ``rows`` NHWC rows: the operations of one 3x3 conv at the int8 peak,
    or the bytes it must move at HBM's rate, each input read once and each
    output written once. ``quantize``: int8 rows in, the weight, int8 codes
    out; ``residual``: int8 rows, the weight and the bf16 stream in, the
    bf16 stream and int8 codes out (``residual_last`` without the codes).
    Returns (ms, what bounds it, bytes) for each."""
    ops = 2 * rows * 9 * channels * channels
    rc, w = rows * channels, 9 * channels * channels
    moved = dict(quantize=2 * rc + w, residual=rc + w + 4 * rc + rc,
                 residual_last=rc + w + 4 * rc)
    out = {}
    for k, nbytes in moved.items():
        t_ops = ops / INT8_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[k] = (max(t_ops, t_bytes),
                  "operations" if t_ops >= t_bytes else "bytes", nbytes)
    return out


def fused_conv_phase(q, operands, batch: int, device) -> dict:
    """Both fused tower conv kernels at the main path's shape (block 0's
    convs, a random bf16 stream): bit-equal to their plain versions on the
    card, then each kernel's device time cold (L2 flushed) and warm (back
    to back), its wrapper's host time, and the plain chain's time, beside
    the bound."""
    c = q.channels
    blk, nxt = q._block(0, c), q._block(min(1, q.depth - 1), c)
    (a1, w1), (a2, w2) = operands[0], operands[1]
    x = torch.randn(a2.shape, generator=torch.Generator(device).manual_seed(
        SEED + 18), device=device).to(torch.bfloat16)
    calls = dict(
        quantize=(lambda: Q.conv_quantize(a1, w1, blk["s2"], blk["b2"]),
                  lambda: Q.conv_quantize_plain(a1, w1, blk["s2"],
                                                blk["b2"])),
        residual=(lambda: Q.conv_residual(a2, w2, x, blk["d2"], nxt["s1"],
                                          nxt["b1"]),
                  lambda: Q.conv_residual_plain(a2, w2, x, blk["d2"],
                                                nxt["s1"], nxt["b1"])),
        residual_last=(lambda: Q.conv_residual(a2, w2, x, blk["d2"]),
                       lambda: Q.conv_residual_plain(a2, w2, x, blk["d2"])))
    out = {}
    for name, (fused, plain) in calls.items():
        got, want = fused(), plain()
        got, want = (got, want) if name == "quantize" else (got[0], want[0])
        check(torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16
                          else got, want.view(torch.int16)
                          if want.dtype == torch.bfloat16 else want),
              f"fused conv ({name}) differs from its plain version")
        out[name] = dict(
            cold_ms=kernel_ms(fused, INT8_REPS, device, FUSED_CONV, True),
            warm_ms=kernel_ms(fused, INT8_REPS, device, FUSED_CONV),
            host_ms=host_ms(fused, 200, device),
            plain_ms=time_ms(plain, INT8_REPS, device))
    out["bound"] = fused_conv_bound(a1.numel() // a1.shape[-1], c)
    return out


def int8_phase(env, net, batch: int, device, gate_agreement: bool = True
               ) -> dict:
    """The int8 tower of ``net`` (random weights) at ``batch`` games:
    quantized from the calibration playouts on the device (seed SEED);
    each tower conv's int32 output on the device equal to the CPU's for
    the same int8 input (the first INT8_CHECK_GAMES games); the forward
    within INT8_CARD_ATOL of the same module's on the CPU; the accuracy
    bounds against the bf16 ResNet over the batch (argmax agreement gated
    with ``gate_agreement``); then device times (CUDA events) and kernel
    launches of both forwards, and one tower conv, int8 and bf16, beside
    its bound."""
    gen = torch.Generator(device).manual_seed(SEED)
    t0 = time.perf_counter()
    calib = Q.calibration_observations(env, generator=gen, device=device)
    q = net.quantized_inference(calib_obs=calib)
    sync(device)
    quantize_s = time.perf_counter() - t0
    obs = env.observation(random_openings(
        env, batch, 12, torch.Generator(device).manual_seed(SEED + 9),
        device))
    cpu_q = copy.deepcopy(q).to("cpu")
    n = min(INT8_CHECK_GAMES, batch)
    with torch.inference_mode():
        operands = q.conv_operands(obs)
        for k, (a, w) in enumerate(operands):
            got = Q.conv3x3_int8(a, w, q.channels)[:n].cpu()
            want = Q.conv3x3_int8(a[:n].cpu(), w.cpu(), q.channels)
            check(torch.equal(got, want),
                  f"int8 tower conv {k}: the card's int32 output differs "
                  "from the CPU's on the same int8 input")
        lq, vq = q(obs)
        lc, vc = cpu_q(obs[:n].cpu())
        card_err = max((lq[:n].cpu() - lc).abs().max().item(),
                       (vq[:n].cpu() - vc).abs().max().item())
        check(card_err <= INT8_CARD_ATOL,
              f"int8 forward on the card vs the CPU: {card_err:.3g} > "
              f"{INT8_CARD_ATOL}")
        check(bool(torch.isfinite(lq).all() and torch.isfinite(vq).all()),
              "int8 forward: non-finite outputs")
        lf, vf = net.model(obs)
        pf = torch.exp(lf)
        kl = float((pf * (lf - lq)).sum(-1).mean())
        dv = float((torch.exp(vq) - torch.exp(vf)).abs().max())
        agree = float((lq.argmax(-1) == lf.argmax(-1)).float().mean())
        top2 = lf.topk(2, dim=-1).values
        gap = float((top2[:, 0] - top2[:, 1]).median())
        check(kl < INT8_KL and dv < INT8_DV,
              f"int8 vs bf16: mean KL {kl:.3g} (bound {INT8_KL}), max |dv| "
              f"{dv:.3g} (bound {INT8_DV})")
        check(agree > INT8_AGREE or not gate_agreement,
              f"int8 vs bf16: argmax agreement {agree:.4f} <= {INT8_AGREE}")

        h, w_ = env.OBS_SHAPE[1:]
        rows, c = batch * h * w_, q.channels
        a, wt = operands[0]
        # The patch matrix built from byte-wide slices, and from int32
        # words of 4 channels (as conv3x3_int8 builds it): the same bytes.
        padded = {t: torch.nn.functional.pad(a.view(t), (0, 0, 1, 1, 1, 1))
                  for t in (torch.int8, torch.int32)}

        def patches_of(t):
            return torch.cat([padded[t][:, i:i + h, j:j + w_]
                              for i in range(3) for j in range(3)], dim=-1)

        patches = patches_of(torch.int8).reshape(rows, 9 * c)
        check(torch.equal(patches, patches_of(torch.int32).view(
            torch.int8).reshape(rows, 9 * c)), "int8 patch matrices differ")
        x16 = torch.randn((batch, c, h, w_), dtype=torch.bfloat16,
                          generator=torch.Generator(device).manual_seed(1),
                          device=device)
        conv16 = net.model.blocks[0].conv1
        out = dict(
            batch=batch, rows=rows, channels=c, quantize_s=quantize_s,
            card_err=card_err, kl=kl, dv=dv, agree=agree, top2_gap=gap,
            agreement_gated=gate_agreement,
            int8_ms=time_ms(lambda: q(obs), INT8_REPS, device),
            bf16_ms=time_ms(lambda: net.model(obs), INT8_REPS, device),
            int8_launches=launches_per_call(lambda: q(obs), device),
            bf16_launches=launches_per_call(lambda: net.model(obs), device),
            conv_int8_ms=time_ms(lambda: Q.conv3x3_int8(a, wt, c),
                                 INT8_REPS, device),
            int_mm_ms=time_ms(lambda: torch._int_mm(patches, wt.t()),
                              INT8_REPS, device),
            patches_bytes_ms=time_ms(lambda: patches_of(torch.int8),
                                     INT8_REPS, device),
            patches_words_ms=time_ms(lambda: patches_of(torch.int32),
                                     INT8_REPS, device),
            conv_bf16_ms=time_ms(lambda: conv16(x16), INT8_REPS, device),
            bound=int8_conv_bound(rows, c),
            fused=fused_conv_phase(q, operands, batch, device))
    return out


def log_int8(name: str, r: dict, smi: str) -> None:
    b = r["bound"]
    log(f"  {name} int8 tower at B={r['batch']} ({r['rows']:,} rows, "
        f"C={r['channels']}): quantized in {r['quantize_s']:.2f} s; every "
        f"tower conv's int32 output equal to the CPU's; forward within "
        f"{r['card_err']:.3g} of the CPU's; against bf16: mean KL "
        f"{r['kl']:.3g}, max |dv| {r['dv']:.3g}, argmax agreement "
        f"{r['agree']:.4f} (bf16 top-two logit gap, median "
        f"{r['top2_gap']:.4g}; gated: {r['agreement_gated']})")
    log(f"  {name} forward: int8 {r['int8_ms']:.3f} ms, bf16 "
        f"{r['bf16_ms']:.3f} ms of device time (CUDA events); kernel "
        f"launches a forward: int8 {r['int8_launches']:.0f}, bf16 "
        f"{r['bf16_launches']:.0f}; card: {smi}")
    log(f"  {name} one 3x3 tower conv: int8 {r['conv_int8_ms']:.4f} ms "
        f"(pad, patches, torch._int_mm; the product alone "
        f"{r['int_mm_ms']:.4f} ms), bf16 {r['conv_bf16_ms']:.4f} ms; "
        f"{b['ops'] / 1e9:.1f} G operations; bound int8 "
        f"{b['int8'][0]:.4f} ms ({b['int8'][1]}, {b['bytes'][0]:,} bytes), "
        f"with the patch matrix {b['int8_patches'][0]:.4f} ms "
        f"({b['bytes'][1]:,} bytes), bf16 {b['bf16'][0]:.4f} ms "
        f"({b['bf16'][1]})")
    log(f"  {name} the patch matrix from the padded input: "
        f"{r['patches_words_ms']:.4f} ms copied as int32 words, "
        f"{r['patches_bytes_ms']:.4f} ms as bytes")
    for k, f in r["fused"].items():
        if k == "bound":
            continue
        ms, what, nbytes = r["fused"]["bound"][k]
        log(f"  {name} fused conv {k} ({FUSED_CONV}, equal to its plain "
            f"version): cold {f['cold_ms']:.4f} ms, warm "
            f"{f['warm_ms']:.4f}, host {f['host_ms']:.4f}; bound "
            f"{ms:.4f} ms ({what}, {nbytes:,} bytes); the plain chain "
            f"{f['plain_ms']:.4f} ms; torch._int_mm alone "
            f"{r['int_mm_ms']:.4f} ms")


#: The FC net and a GroupNorm tower on the card at small widths.
OTHER_NETS = {
    "fc": dict(nnet_type="fc", input_fc_layers=[256, 256],
               value_dense_layers=[64], policy_dense_layers=[64]),
    "groupnorm": dict(norm="groupnorm", num_channels=32, depth=2,
                      value_head_channels=16, policy_head_channels=16,
                      value_dense_layers=[64], policy_dense_layers=[64]),
}


def other_nets_phase(device, batch: int = 64) -> dict:
    """A float32 forward and train step of the FC net and of a GroupNorm
    ResNet on ``device`` against the same on the CPU, from the same
    weights and batch: outputs and trained parameters within TRAIN_RTOL /
    TRAIN_ATOL. Returns the max errors."""
    env = get_env("connect4")
    gen = torch.Generator("cpu").manual_seed(SEED + 10)
    obs = env.observation(random_openings(env, batch, 12, gen, "cpu"))
    rng = np.random.default_rng(SEED + 10)
    pi = rng.dirichlet(np.ones(env.ACTION_SIZE), batch).astype(np.float32)
    value = np.eye(3, dtype=np.float32)[rng.integers(0, 3, batch)]
    errs = {}
    for kind, knobs in OTHER_NETS.items():
        args = get_args(seed=SEED, compute_dtype="float32", **knobs)
        nets = {d: NNetWrapper(env, args, device=d) for d in (device, "cpu")}
        nets[device].model.load_state_dict(nets["cpu"].model.state_dict())
        outs = {d: net.process(obs.to(d)) for d, net in nets.items()}
        err = 0.0
        for a, b in zip(outs[device], outs["cpu"]):
            a = a.cpu()
            bad = (a - b).abs() > TRAIN_ATOL + TRAIN_RTOL * b.abs()
            check(not bool(bad.any()), f"{kind} forward on {device} != cpu")
            err = max(err, (a - b).abs().max().item())
        for net in nets.values():
            net.train([(obs.numpy(), pi, value)], 1)
        want = nets["cpu"].model.state_dict()
        for k, x in nets[device].model.state_dict().items():
            x = x.cpu()
            bad = (x - want[k]).abs() > TRAIN_ATOL + TRAIN_RTOL * \
                want[k].abs()
            check(not bool(bad.any()),
                  f"{kind} train step on {device} != cpu at {k}")
            err = max(err, (x - want[k]).abs().max().item())
        errs[kind] = err
    return errs


def kernel_bound(kind: str, t: dict, batch: int) -> tuple:
    """A kernel's bound (ms, "bytes" or "operations") from the data of the
    snapshot it was timed on (see PERF.md); ``kind`` is "descend" or
    "backup", in either layout."""
    if kind == "descend":
        # The bytes its walks need (_descend_bytes); operations: one
        # compare per row per walk step.
        nbytes, ops = t["bytes"], t["depth_sum"] * (t["N"] - 1)
    else:
        # Per path edge, parent, player, n, q, v read and n, q, v written
        # (32 bytes) and about 12 float operations; per game leaf, value,
        # max_depth read and the root's n, v, player touched (36 bytes).
        nbytes, ops = t["path_sum"] * 32 + batch * 36, t["path_sum"] * 12
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


#: Each kernel behind the kernels line's records: its source, the TPU
#: kernel's function that it replaces, and its kind for ``kernel_bound``
#: (which counts a walk's or a path's work alike in both layouts).
KERNELS = {
    "descend": ("alphazero_general_tpu_torch/csrc/descend.cu",
                "alphazero_general_tpu/ops/descend.py:44", "descend"),
    "backup": ("alphazero_general_tpu_torch/csrc/backup.cu",
               "alphazero_general_tpu/ops/backup.py:26", "backup"),
    "descend_rows": ("alphazero_general_tpu_torch/csrc/descend.cu",
                     "alphazero_general_tpu/ops/descend.py:198", "descend"),
    "backup_rows": ("alphazero_general_tpu_torch/csrc/backup.cu",
                    "alphazero_general_tpu/ops/backup.py:101", "backup"),
}


def kernel_record(name: str, kernel: str, t: dict, launches: int,
                  err: float, by_rows: dict = None) -> dict:
    """One JSON record of ``kernel`` (a key of KERNELS) timed on the
    snapshot ``t``. ``ms`` is the device time of one launch with L2
    flushed before it, on the snapshot the bound is computed from;
    ``ms_l2_warm`` the same launch back to back with its inputs in L2;
    ``host_ms`` the host's time per wrapper call. With ``by_rows`` (the
    kernel's launches by tree rows in the run ``launches`` counts),
    ``launches_at_N`` is those of them on trees of the snapshot's rows."""
    src, replaces, kind = KERNELS[kernel]
    bound = kernel_bound(kind, t, t["B"])
    at_n = {} if by_rows is None else {"launches_at_N":
                                       by_rows.get(t["N"], 0)}
    return {
        "name": name, "route": "cuda", "source": src,
        "replaces": replaces, "launches": launches,
        "max_abs_err": err, "max_err": err,
        "ms": t["ms"], "ms_l2_warm": t["ms_l2_warm"],
        "call_ms": t["call_ms"], "host_ms": t["host_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": None, "N": t["N"], "B": t["B"], **at_n,
    }


def log_coach(co: dict, smi: str) -> None:
    """The Coach phase's numbers, per iteration."""
    by_rows = {k: co["launches_by_rows"][k] for k in ("descend", "backup")}
    log(f"  {co['env']} coach cycle through cli.train.main: "
        f"{co['wall']:.1f} s; cuts {co['cuts']}; {co['searches']} searches, "
        f"{co['simulations']} simulations; launches {co['launches']}, by "
        f"tree rows {by_rows}; int8 tower forwards {co['int8_forwards']}; "
        f"peak memory {co['peak_bytes'] / 2**30:.2f} GiB; card: {smi}")
    for it, r in co["iters"].items():
        t = r["times"]
        log(f"  iteration {it}: " + ", ".join(
            f"time/{k} {v:.2f} s" for k, v in sorted(t.items())))
        log(f"    int8 tower (1 = played): {r['int8']}")
        log(f"    self-play: {r['moves']:.0f} moves, {r['games']:.0f} games,"
            f" {r['samples']:.0f} samples, "
            f"{co['games_per_batch'] * r['self_play_sims'] / t['self_play']:,.0f}"
            " sims/s")
        log(f"    train: {r['train_steps']:.0f} steps, "
            f"{r['train_steps'] / t['train']:.2f} steps/s over the phase; "
            f"losses {r['loss'][0]:.4f} / {r['loss'][1]:.4f}")
        for kind in ("baseline", "past"):
            if kind not in r:
                continue
            a = r[kind]
            log(f"    arena {kind}: {a['wins_new']:.0f} / "
                f"{a['wins_other']:.0f} / {a['draws']:.0f} (new / other / "
                f"draws) in {a['rounds']:.0f} rounds, "
                f"{a['games'] / t['arena_' + kind]:.2f} games/s, "
                f"{t['arena_' + kind] * 1e3 / a['rounds']:.1f} ms a round")
        if "preset_gate" in r:
            log(f"    gate: the cut gate decided for iteration {it}; the "
                f"preset's gate of {r['preset_gate'][0]} would "
                f"{r['preset_gate'][1]}")


def log_timing(name: str, t: dict) -> None:
    bound = kernel_bound(name.split("_")[0], t, t["B"])
    log(f"  {name} at B={t['B']}, N={t['N']}: {t['ms']:.4f} ms of device time "
        f"per launch with L2 flushed, {t['ms_l2_warm']:.4f} ms back to back, "
        f"{t['call_ms']:.4f} ms per wrapper call, {t['host_ms']:.4f} ms of "
        f"host time per call, plain {t['plain_ms']:.2f} ms; bound "
        f"{bound[0]:.6f} ms ({bound[1]})")


def connect4_phases(device, smi: str) -> tuple:
    """Phases 3-8 (connect4) with the int8 and FC / GroupNorm phases;
    returns their kernel records and the int8 phase's numbers."""
    env = get_env("connect4")
    args = get_args(seed=SEED, numMCTSSims=SIMS_FULL, numFastSims=SIMS_FAST,
                    **MODEL)
    cfg = SelfPlayConfig.from_args(args, env.NUM_PLAYERS, env.HAS_DRAW)
    spec = cfg.spec
    net = NNetWrapper(env, args, device=device)

    t0 = time.perf_counter()
    errs = dict.fromkeys(COUNTED, 0.0)
    timings = {}
    for sims in (SIMS_FULL, SIMS_FAST):
        e, timings[sims] = kernel_phase(env, net.make_eval_fn(), spec, GAMES,
                                        sims, SNAPSHOTS[sims], device)
        errs.update({k: max(errs[k], e[k]) for k in e})
        t = timings[sims]
        for k in ("descend", "backup"):
            log_timing(k, t[k])
        log("  backup with L2 flushed by threads a block: " + ", ".join(
            f"{th}: {ms:.4f} ms"
            for th, ms in t["backup"]["ms_by_threads"].items()))
        log(f"  descend needs {t['descend']['bytes']:,} bytes (by element) "
            f"over {t['descend']['depth_sum']:,} walk steps (deepest walk "
            f"{t['descend']['depth_max']}); backup walks "
            f"{t['backup']['path_sum']:,} path edges (longest path "
            f"{t['backup']['path_max']})")
    timing = dict(timings[SIMS_FULL])
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    e = random_tree_phase(spec, device)
    errs = {k: max(errs[k], e[k]) for k in errs}
    log(f"phase random trees: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    e = coach_shapes_phase(env, net, device,
                           preset_args("connect4", **COACH_CUTS))
    errs.update({k: max(errs[k], e[k]) for k in e})
    log(f"phase kernels at the Coach's shapes: "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    reference_phase(env, device)
    reference_reuse_phase(env, device)
    log(f"phase reference: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sp = selfplay_phase(env, net.model, cfg, GAMES, CYCLE, device)
    launches = {k: sp["launches"][k] for k in ("descend", "backup")}
    log(f"  self-play: {sp['sims_per_s']:,.0f} sims/s over "
        f"{len(sp['moves'])} moves; launches {sp['launches']}; peak memory "
        f"{sp['peak_bytes'] / 2**30:.2f} GiB; card: {smi}")
    log(f"phase self-play: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    i8 = int8_phase(env, net, GAMES, device)
    log_int8("connect4", i8, smi)
    qp = selfplay_phase(env, net.quant_model, cfg, GAMES, CYCLE, device)
    i8.update(sims_per_s=qp["sims_per_s"], bf16_sims_per_s=sp["sims_per_s"],
              selfplay_launches=qp["launches"])
    log(f"  int8 self-play: {qp['sims_per_s']:,.0f} sims/s over "
        f"{len(qp['moves'])} moves (bf16, same run: "
        f"{sp['sims_per_s']:,.0f}); launches {qp['launches']}; peak memory "
        f"{qp['peak_bytes'] / 2**30:.2f} GiB; card: {smi}")
    log(f"phase int8: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    reuse_cfg = SelfPlayConfig.from_args(
        get_args(args, reuse_tree=True), env.NUM_PLAYERS, env.HAS_DRAW)
    openings = random_openings(env, GAMES, 6,
                               torch.Generator(device).manual_seed(SEED + 6),
                               device)
    rp = selfplay_phase(env, net.model, reuse_cfg, GAMES, REUSE_CYCLE, device,
                        openings=openings)
    launches.update({k: rp["launches"][k]
                     for k in ("descend_rows", "backup_rows")})
    log(f"  reuse self-play (N = {reuse_cfg.capacity + 1}): "
        f"{rp['sims_per_s']:,.0f} sims/s over {len(rp['moves'])} moves "
        f"(fresh trees, same run: {sp['sims_per_s']:,.0f}); launches "
        f"{rp['launches']}; restarts: {rp['restarts']['done']} done, "
        f"{rp['restarts']['overflow']} overflow; trees carried into the "
        f"next move: {rp['carried']} of {GAMES}; peak memory "
        f"{rp['peak_bytes'] / 2**30:.2f} GiB; card: {smi}")
    e, rows_timing = rows_kernel_phase(env, net.make_eval_fn(), spec,
                                       rp["carry"].trees, SIMS_FULL,
                                       REUSE_SNAPSHOTS, device)
    errs.update({k: max(errs[k], e[k]) for k in e})
    log(f"  the search on carried trees started with {rows_timing['carried']}"
        f" of {GAMES} trees carried")
    for k in ("descend_rows", "backup_rows"):
        t = rows_timing[k]
        timing[k] = t
        log_timing(k, t)
        log(f"  yardstick, the JAX package's route for {k} on the card "
            f"(columns transposed to [N, B], the game-minor kernel"
            f"{', results transposed back' if k == 'backup_rows' else ''}):"
            f" {t['jax_route_ms']:.4f} ms of device time with L2 flushed, "
            f"{t['jax_route_call_ms']:.4f} ms per call")
    log(f"  descend_rows needs {timing['descend_rows']['bytes']:,} bytes over "
        f"{timing['descend_rows']['depth_sum']:,} walk steps (deepest walk "
        f"{timing['descend_rows']['depth_max']}); backup_rows walks "
        f"{timing['backup_rows']['path_sum']:,} path edges (longest path "
        f"{timing['backup_rows']['path_max']})")
    placed = in_place_phase(
        lambda: rp["fns"]["fast"](rp["carry"], generator=rp["generator"]),
        device)
    for k, (ms, seen) in placed.items():
        log(f"  in place over one fast reuse move: {k} {ms:.4f} ms per "
            f"launch over {seen} launches")
    log(f"phase reuse: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    breakdown_phase(env, net.make_eval_fn(), spec, GAMES, SIMS_FAST, device)
    log(f"phase breakdown: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        co = coach_phase(device, root, COACH_CUTS)
        log_coach(co, smi)
        tc = train_check_phase(device, MODEL, co["store"].load(1))
    launches.update({k: co["launches"][k] for k in ("descend", "backup")})
    log(f"  float32 train step, {TRAIN_CHECK_BATCH} samples at full width: "
        f"card == cpu within rtol {TRAIN_RTOL}, atol {TRAIN_ATOL} (max "
        f"error {tc['max_err']:.3g}); checkpoint round trip bit-equal")
    w, h = tc["window"], tc["host"]
    log(f"  train steps at batch 1024, bfloat16, fed as the Coach feeds "
        f"them (device window, device symmetries): {w['steps_per_s']:.2f} "
        f"steps/s = {w['samples_per_s']:,.0f} samples/s; under the "
        f"profiler, device busy {w['busy_ms_per_step']:.3f} ms of "
        f"{w['wall_ms_per_step']:.3f} ms a step "
        f"({100 * w['busy_ms_per_step'] / w['wall_ms_per_step']:.1f}%); "
        f"fed from host arrays: {h['steps_per_s']:.2f} steps/s = "
        f"{h['samples_per_s']:,.0f} samples/s; card: {smi}")
    log(f"phase coach: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    other = other_nets_phase(device)
    log(f"  float32 forward and train step on {device} == cpu within rtol "
        f"{TRAIN_RTOL}, atol {TRAIN_ATOL}: " + ", ".join(
            f"{k} (max error {e:.3g})" for k, e in other.items()))
    log(f"phase FC and GroupNorm: {time.perf_counter() - t0:.1f} s")
    # The Coach's launches by tree rows: its fresh searches run in
    # segments, so the records' N = 203 covers the last segment only.
    by_rows = co["launches_by_rows"]
    return ([kernel_record(k, k, timing[k], launches[k], errs[k],
                           by_rows[k] if k in ("descend", "backup")
                           else None)
             for k in KERNELS], i8, by_rows)


#: The brandubh Coach phase: the brandubh preset (envs/presets.py: 1024
#: games in lockstep, 150 full / 30 fast simulations at probFastSim 0.75,
#: ResNet 128 x 10 with [2048, 256] / [2048, 512] heads, train batch 1024)
#: through ``cli.train.main``, cut to two iterations (the first a warmup
#: one), one lockstep batch of games an iteration (preset: 4096), no
#: baseline arena (preset: 128 games each iteration), one past arena of
#: ``BRANDUBH_ARENA_GAMES`` games after iteration 1 (preset: 128 games
#: each iteration), 50 full simulations (preset: 150; the arena searches
#: full searches, and its rounds are host-bound, so its time follows the
#: simulations and not the games: 178-245 s of the script at 150), a gate
#: of 0 (preset: 0.52) so that iteration 2 plays the trained network, and
#: the float tower (``quant_selfplay=False``: the connect4 Coach drives
#: the int8 one).
BRANDUBH_COACH_CUTS = dict(numIters=2, numWarmupIters=1,
                           gamesPerIteration=1024, compareWithBaseline=False,
                           pastCompareFreq=2,
                           arenaCompare=BRANDUBH_ARENA_GAMES,
                           numMCTSSims=50, min_next_model_winrate=0.0,
                           quant_selfplay=False)
#: Games and simulations of the tafl reference phase (a hnefatafl search on
#: the card against the CPU's), and the rows of its table evaluation.
TAFL_REFERENCE = dict(batch=64, sims=32, rows=1021)


def tafl_kernel_phase(device, nets: dict):
    """Both game-minor kernels against their plain versions at every
    snapshot of ``TAFL_SNAPSHOTS`` (the presets' self-play searches, the
    hnefatafl ones timed at their last snapshot) and of a brandubh arena
    round's search (timed). Returns (max errors, timings)."""
    errs = {"descend": 0.0, "backup": 0.0}
    timing = {}
    runs = [(name, sims, snaps) for (name, sims), snaps
            in TAFL_SNAPSHOTS.items()] + [("brandubh", "arena", None)]
    for name, key, snaps in runs:
        env = get_env(name)
        args = preset_args(name, seed=SEED)
        spec = SelfPlayConfig.from_args(args, env.NUM_PLAYERS,
                                        env.HAS_DRAW).spec
        batch, sims = int(args.process_batch_size), key
        timed = name == "hnefatafl"
        what = f"{sims} simulations"
        if key == "arena":  # the Coach phase's arena
            args = preset_args(
                name, seed=SEED,
                numMCTSSims=BRANDUBH_COACH_CUTS["numMCTSSims"])
            arena = ArenaConfig.from_args(args, env.NUM_PLAYERS, env.HAS_DRAW)
            spec, batch, timed = arena.spec, BRANDUBH_ARENA_GAMES, True
            sims, snaps = arena.sims, (arena.sims // 4, arena.sims - 1)
            what = f"an arena round's {sims} simulations"
        log(f"  {name}: B={batch}, {what}")
        e, t = kernel_phase(env, nets[name].make_eval_fn(), spec, batch,
                            sims, snaps, device, timed=timed)
        errs = {k: max(errs[k], e[k]) for k in errs}
        if timed:
            timing[(name, key)] = t
            for k in ("descend", "backup"):
                log_timing(k, t[k])
            log(f"  descend needs {t['descend']['bytes']:,} bytes over "
                f"{t['descend']['depth_sum']:,} walk steps (deepest walk "
                f"{t['descend']['depth_max']}); backup walks "
                f"{t['backup']['path_sum']:,} path edges (longest path "
                f"{t['backup']['path_max']}); games per descend block "
                f"{OD.games_per_block(t['descend']['N'])}")
    return errs, timing


def prior_layout_phase(device, batch: int, nodes: int, actions: int,
                       reps: int = 50) -> dict:
    """Device milliseconds of what a simulation does with the prior rows,
    in the TreeT's batch-major layout [B, N, A] and in the game-minor one
    [N*A, B] the connect4 kernels' columns have: the rank-walk pointer
    advance reads one A-wide row per game at a random node per game, the
    install writes every game's row at one slot (CUDA events over
    ``reps`` calls, random rows; on the CPU, the host clock)."""
    gen = torch.Generator(device).manual_seed(SEED + 8)
    bm = torch.rand((batch, nodes, actions), generator=gen, device=device)
    gm = bm.permute(1, 2, 0).reshape(nodes * actions, batch).contiguous()
    games = torch.arange(batch, device=device)
    rows = torch.randint(0, nodes, (batch,), generator=gen, device=device)
    new = torch.rand((batch, actions), generator=gen, device=device)
    slot = nodes // 2
    check(torch.equal(bm[games, rows],
                      gm.view(nodes, actions, batch)[rows, :, games]),
          "the two prior layouts disagree")

    def gm_write():
        gm[slot * actions:(slot + 1) * actions] = new.T

    out = dict(
        read_batch_major=time_ms(lambda: bm[games, rows], reps, device),
        read_game_minor=time_ms(
            lambda: gm.view(nodes, actions, batch)[rows, :, games], reps,
            device),
        write_batch_major=time_ms(lambda: bm[:, slot].copy_(new), reps,
                                  device),
        write_game_minor=time_ms(gm_write, reps, device))
    log(f"  prior rows at B={batch}, N={nodes}, A={actions}: a row per game "
        f"read {out['read_batch_major']:.4f} ms batch-major, "
        f"{out['read_game_minor']:.4f} ms game-minor; a slot written "
        f"{out['write_batch_major']:.4f} / {out['write_game_minor']:.4f} ms")
    del bm, gm
    return out


def tafl_phases(device, smi: str) -> tuple:
    """Phases 9-12 (tafl) with the hnefatafl int8 phase; returns their
    kernel records and the int8 phase's numbers."""
    nets = {}
    for name in ("hnefatafl", "brandubh"):
        nets[name] = NNetWrapper(get_env(name), preset_args(name, seed=SEED),
                                 device=device)

    t0 = time.perf_counter()
    errs, timing = tafl_kernel_phase(device, nets)
    env = get_env("hnefatafl")
    args = preset_args("hnefatafl", seed=SEED)
    cfg = SelfPlayConfig.from_args(args, env.NUM_PLAYERS, env.HAS_DRAW)
    batch = int(args.process_batch_size)
    prior_layout_phase(device, batch, cfg.sims_full + 3, env.ACTION_SIZE)
    log(f"phase tafl kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sp = selfplay_phase(env, nets["hnefatafl"].model, cfg, batch, CYCLE,
                        device)
    log(f"  hnefatafl self-play: {sp['sims_per_s']:,.0f} sims/s over "
        f"{len(sp['moves'])} moves ({sp['wall_ms_per_sim']:.3f} ms a "
        f"simulation of {batch} games); launches {sp['launches']}; peak "
        f"memory {sp['peak_bytes'] / 2**30:.2f} GiB; card: {smi}")
    b = breakdown_phase(env, nets["hnefatafl"].make_eval_fn(), cfg.spec,
                        batch, cfg.sims_fast, device)
    log(f"  hnefatafl {cfg.sims_fast}-sim search: the env step and "
        f"expansion (stage expand) {b['device_ms']['expand']:.4f} ms of "
        f"device time and {b['host_ms']['expand']:.4f} ms of host time a "
        f"simulation, of {b['wall_ms_per_sim']:.3f} ms wall")
    log(f"phase hnefatafl self-play: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    # Argmax agreement is printed, not gated, here: the random hnefatafl
    # net's policy is near uniform over 2420 actions (its top-two logit gap
    # is far below the int8 tower's logit error), so the top action is a
    # near tie that either tower may break; KL and |dv| are gated.
    i8 = int8_phase(env, nets["hnefatafl"], batch, device,
                    gate_agreement=False)
    log_int8("hnefatafl", i8, smi)
    log(f"phase hnefatafl int8: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    reference_phase(env, device, **TAFL_REFERENCE)
    log(f"phase tafl reference: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    del nets
    with tempfile.TemporaryDirectory() as root:
        co = coach_phase(device, root, BRANDUBH_COACH_CUTS, "brandubh")
        log_coach(co, smi)
    log(f"phase brandubh coach: {time.perf_counter() - t0:.1f} s")
    return ([kernel_record(f"{k}@{name}", k, timing[key][k],
                           launches[k], errs[k])
             for name, key, launches in (
                 ("hnefatafl", ("hnefatafl", cfg.sims_full),
                  sp["launches"]),
                 ("brandubh", ("brandubh", "arena"), co["launches"]))
             for k in ("descend", "backup")], i8)


# --------------------------------------------------------------------------
# The other envs (phases 13-21)
# --------------------------------------------------------------------------

#: The rollout phase's envs (card against CPU): games, and the plies to play
#: (None: every game to its end). ``othello_x4`` is othello with
#: ``num_stacked_observations=4``.
ROLLOUT_ENVS = {"tictactoe": (256, None), "nim3": (256, None),
                "othello": (256, None), "gobang": (128, None),
                "stratego": (128, 200), "chess": (128, 200),
                "othello_x4": (128, None)}
#: The six perft positions of tests/test_chess.py (None: the start), first
#: in the chess rollouts' batch; random openings fill the rest.
PERFT_FENS = (
    None,
    "r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1",
    "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1",
    "r3k2r/Pppp1ppp/1b3nbN/nP6/BBP1P3/q4N2/Pp1P2PP/R2Q1RK1 w kq - 0 1",
    "rnbq1k1r/pp1Pbppp/2p5/8/2B5/8/PPP1NnPP/RNBQK2R w KQ - 1 8",
    "r4rk1/1pp1qppp/p1np1n2/2b1p1B1/2B1P1b1/P1NP1N2/1PP1QPPP/R4RK1 w - - 0 10",
)
#: Snapshots of the chess kernel phase by simulations (the preset's full
#: and fast searches, N = 203 and 43); the last one of each is timed.
CHESS_SNAPSHOTS = {200: (40, 199), 40: (20, 39)}
#: Games of the nim3 kernel phase (the default args' 100-simulation
#: search; N = 103) and its snapshots, the last one timed.
NIM_GAMES = 256
NIM_SNAPSHOTS = (50, 99)
#: Snapshots of the search on nim3's carried reuse trees at which the
#: batch-major kernels are held at three players; the last one is timed.
NIM_REUSE_SNAPSHOTS = (0, 50, 99)
#: Snapshots of the stratego kernel holds by simulations (the preset's
#: full and fast searches at 512 games, A = 1280; N = 103 and 23).
STRATEGO_SNAPSHOTS = {100: (25, 50, 99), 20: (10, 19)}
#: Games and simulations of the chess reference phase (a search on the
#: card against the same search on the CPU), and its table's rows.
CHESS_REFERENCE = dict(batch=32, sims=32, rows=1021)
#: The envs whose self-play runs one fast and one full move at the
#: preset's width (nim3, which has no preset: the default args).
SELFPLAY_ENVS = ("othello", "gobang", "tictactoe", "stratego", "nim3",
                 "othello_x4")
#: Games of the three-model nim3 arena (make_multi_arena_fn).
NIM_ARENA_GAMES = 48
#: The othello Coach phase: the othello preset (envs/presets.py: 1024 games
#: in lockstep, 100 full / 20 fast simulations, ResNet 64 x 6, 8
#: symmetries) through ``cli.train.main``, cut to two iterations (the first
#: a warmup one), one lockstep batch of games an iteration (preset: 4096),
#: no baseline arena (preset: 128 games every iteration), one past arena of
#: 128 games after iteration 1 (preset: 128 every iteration) and a gate of
#: 0 (preset: 0.52), at the JAX default ``quant_selfplay=True``.
OTHELLO_COACH_CUTS = dict(numIters=2, numWarmupIters=1,
                          gamesPerIteration=1024, compareWithBaseline=False,
                          pastCompareFreq=2, arenaCompare=128,
                          min_next_model_winrate=0.0)


def make_env(name: str):
    """A registered env, or ``<env>_x<k>``: the env with ``k`` stacked
    observations."""
    from alphazero_general_tpu_torch.envs.stacked import make_stacked_env

    base, _, k = name.partition("_x")
    return make_stacked_env(get_env(base), int(k)) if k else get_env(base)


def env_args(name: str, **overrides):
    """The preset of ``name``'s base env (nim3: the default args), with
    its stacked observations."""
    base, _, k = name.partition("_x")
    if k:
        overrides.setdefault("num_stacked_observations", int(k))
    return preset_args(base, **{"seed": SEED, **overrides})


def _to(state, device):
    return type(state)(**{k: x.to(device) for k, x in
                          state_items(state).items()})


def _freeze(done, new, old):
    """Per game, ``old`` where ``done`` else ``new``."""
    return type(new)(**{
        k: torch.where(done.reshape((-1,) + (1,) * (x.dim() - 1)),
                       getattr(old, k), x)
        for k, x in state_items(new).items()})


def rollout_phase(name: str, batch: int, plies, device) -> dict:
    """Random playouts of ``name`` on the card and on the CPU from the same
    states, with the same actions (drawn by a seeded numpy generator among
    the valid moves the CPU reports): every state field, valid mask, win
    vector and observation equal at every ply, until every game has ended
    or for ``plies`` plies; finished games stay frozen."""
    env = make_env(name)
    gen = torch.Generator("cpu").manual_seed(SEED + 9)
    if name == "chess":
        from alphazero_general_tpu_torch.envs import chess as TC

        first = [env.init(1, "cpu") if f is None else TC.from_fen(f)
                 for f in PERFT_FENS]
        rest = random_openings(env, batch - len(first), 12, gen, "cpu")
        start = env.State(**{k: torch.cat([getattr(s, k) for s in first]
                                          + [x])
                             for k, x in state_items(rest).items()})
    else:
        start = env.init(batch, "cpu")
    states = {"cpu": start, device: _to(start, device)}
    rng = np.random.default_rng(SEED + 9)
    limit = plies or env.MAX_TURNS + 1
    done = torch.zeros(batch, dtype=torch.bool)
    for ply in range(limit):
        out = {}
        for dev, s in states.items():
            win, valid = env.win_and_valids(s)
            out[dev] = (state_items(s), valid, win, env.observation(s))
        (items, valid, win, obs), (d_items, d_valid, d_win, d_obs) = (
            out["cpu"], out[device])
        for k, x in items.items():
            check(torch.equal(d_items[k].cpu(), x),
                  f"{name} rollout ply {ply}: state field {k} differs")
        for what, a, b in (("valid moves", d_valid, valid),
                           ("win vector", d_win, win),
                           ("observation", d_obs, obs)):
            check(bits_equal(a.cpu(), b),
                  f"{name} rollout ply {ply}: {what} differs")
        done = (win > 0).any(dim=1)
        if bool(done.all()):
            break
        v = valid.numpy()
        action = torch.from_numpy(np.array(
            [rng.choice(np.flatnonzero(row)) if not d else 0
             for row, d in zip(v, done.numpy())], np.int32))
        for dev, s in states.items():
            dd = done.to(dev)
            states[dev] = _freeze(dd, env.step(s, action.to(dev)), s)
    return dict(plies=ply + 1, ended=int(done.sum()), games=batch)


def nim_arena_phase(device) -> dict:
    """A three-model nim3 arena (make_multi_arena_fn, three random nets of
    the default args): every game decided, the wins and draws summing to
    the games, and every simulation through both game-minor kernels."""
    from alphazero_general_tpu_torch.selfplay.arena import (
        make_multi_arena_fn)

    env = get_env("nim3")
    nets = [NNetWrapper(env, env_args("nim3", seed=SEED + m), device=device)
            for m in range(3)]
    cfg = ArenaConfig.from_args(nets[0].args, env.NUM_PLAYERS, env.HAS_DRAW)
    run = make_multi_arena_fn(env, cfg, [n.model for n in nets],
                              NIM_ARENA_GAMES, device=device)
    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    result = run(generator=torch.Generator(device).manual_seed(SEED + 10))
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_counts()
    wins = result.model_wins.tolist()
    check(sum(wins) + result.draws == NIM_ARENA_GAMES,
          f"nim3 arena: wins {wins} and draws {result.draws} do not sum to "
          f"{NIM_ARENA_GAMES}: a game was left undecided")
    expect = dict.fromkeys(COUNTED, 0)
    if torch.device(device).type == "cuda":
        expect.update(descend=result.rounds * (cfg.sims - 1),
                      backup=result.rounds * cfg.sims)
    check(launches == expect,
          f"nim3 arena: kernel launches {launches} != expected {expect}")
    return dict(wins=wins, draws=result.draws, rounds=result.rounds,
                wall=wall, length=result.avg_game_length)


def env_phases(device, smi: str) -> list:
    """Phases 13-21; returns the kernel records at the chess and nim3
    shapes."""
    t0 = time.perf_counter()
    for name, (batch, plies) in ROLLOUT_ENVS.items():
        t1 = time.perf_counter()
        r = rollout_phase(name, batch, plies, device)
        log(f"  {name}: {r['games']} games x {r['plies']} plies on {device} "
            f"== cpu (every state field, valid mask, win vector and "
            f"observation); {r['ended']} games ended; "
            f"{time.perf_counter() - t1:.1f} s")
    log(f"phase env rollouts: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    env = get_env("chess")
    args = env_args("chess")
    cfg = SelfPlayConfig.from_args(args, env.NUM_PLAYERS, env.HAS_DRAW)
    batch = int(args.process_batch_size)
    net = NNetWrapper(env, args, device=device)
    errs = {"descend": 0.0, "backup": 0.0}
    timing = {}
    for sims in (cfg.sims_full, cfg.sims_fast):
        log(f"  chess: B={batch}, {sims} simulations")
        e, timing[sims] = kernel_phase(env, net.make_eval_fn(), cfg.spec,
                                       batch, sims, CHESS_SNAPSHOTS[sims],
                                       device)
        errs = {k: max(errs[k], e[k]) for k in errs}
        t = timing[sims]
        for k in ("descend", "backup"):
            log_timing(k, t[k])
        log(f"  descend needs {t['descend']['bytes']:,} bytes over "
            f"{t['descend']['depth_sum']:,} walk steps (deepest walk "
            f"{t['descend']['depth_max']}); backup walks "
            f"{t['backup']['path_sum']:,} path edges (longest path "
            f"{t['backup']['path_max']}); card: {smi}")
    log(f"phase chess kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    nim = get_env("nim3")
    nim_args = env_args("nim3")
    nim_cfg = SelfPlayConfig.from_args(nim_args, nim.NUM_PLAYERS,
                                       nim.HAS_DRAW)
    nim_net = NNetWrapper(nim, nim_args, device=device)
    log(f"  nim3: B={NIM_GAMES}, {nim_cfg.sims_full} simulations, "
        f"{nim.NUM_PLAYERS} players, value_size {nim_cfg.spec.value_size}")
    # Openings of at most 2 plies: a pile of 15 keeps 9 tokens or more.
    e, nim_timing = kernel_phase(nim, nim_net.make_eval_fn(), nim_cfg.spec,
                                 NIM_GAMES, nim_cfg.sims_full, NIM_SNAPSHOTS,
                                 device, opening_plies=2)
    nim_errs = e
    for k in ("descend", "backup"):
        log_timing(k, nim_timing[k])
    log(f"phase nim3 kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    reuse_cfg = SelfPlayConfig.from_args(
        env_args("nim3", reuse_tree=True), nim.NUM_PLAYERS, nim.HAS_DRAW)
    openings = random_openings(nim, NIM_GAMES, 2, torch.Generator(
        device).manual_seed(SEED + 12), device)
    rp = selfplay_phase(nim, nim_net.model, reuse_cfg, NIM_GAMES,
                        ("fast", "full"), device, openings=openings)
    log(f"  nim3 reuse self-play (N = {reuse_cfg.capacity + 1}): launches "
        f"{rp['launches']}; trees carried: {rp['carried']} of {NIM_GAMES}")
    nim_rows_errs, nim_rows_timing = rows_kernel_phase(
        nim, nim_net.make_eval_fn(), nim_cfg.spec, rp["carry"].trees,
        nim_cfg.sims_full, NIM_REUSE_SNAPSHOTS, device)
    for k in ("descend_rows", "backup_rows"):
        log_timing(k, nim_rows_timing[k])
    nim_rows_launches = rp["launches"]
    log(f"phase nim3 reuse kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    strat = get_env("stratego")
    s_args = env_args("stratego")
    s_cfg = SelfPlayConfig.from_args(s_args, strat.NUM_PLAYERS,
                                     strat.HAS_DRAW)
    s_net = NNetWrapper(strat, s_args, device=device)
    for sims in (s_cfg.sims_full, s_cfg.sims_fast):
        log(f"  stratego: B={s_args.process_batch_size}, {sims} "
            f"simulations, A = {strat.ACTION_SIZE}")
        kernel_phase(strat, s_net.make_eval_fn(), s_cfg.spec,
                     int(s_args.process_batch_size), sims,
                     STRATEGO_SNAPSHOTS[sims], device, timed=False)
    del s_net
    log(f"phase stratego kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sp = selfplay_phase(env, net.model, cfg, batch, CYCLE, device)
    log(f"  chess self-play: {sp['sims_per_s']:,.0f} sims/s over "
        f"{len(sp['moves'])} moves ({sp['wall_ms_per_sim']:.3f} ms a "
        f"simulation of {batch} games); launches {sp['launches']}; peak "
        f"memory {sp['peak_bytes'] / 2**30:.2f} GiB; the full move's pi "
        f"rows densified to {env.ACTION_SIZE} wide, summing to 1 over valid "
        f"moves; card: {smi}")
    log(f"phase chess self-play: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    b = breakdown_phase(env, net.make_eval_fn(), cfg.spec, batch,
                        cfg.sims_fast, device)
    log(f"  chess {cfg.sims_fast}-sim search: the env step and expansion "
        f"(stage expand) {b['device_ms']['expand']:.4f} ms of device time "
        f"and {b['host_ms']['expand']:.4f} ms of host time a simulation, of "
        f"{b['wall_ms_per_sim']:.3f} ms wall; card: {smi}")
    log(f"phase chess breakdown: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    reference_phase(env, device, **CHESS_REFERENCE)
    log(f"phase chess reference: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    del net
    nim_launches = None
    for name in SELFPLAY_ENVS:
        e_env = make_env(name)
        e_args = env_args(name)
        e_cfg = SelfPlayConfig.from_args(e_args, e_env.NUM_PLAYERS,
                                         e_env.HAS_DRAW)
        e_batch = int(e_args.process_batch_size)
        model = NNetWrapper(e_env, e_args, device=device).model
        r = selfplay_phase(e_env, model, e_cfg, e_batch, ("fast", "full"),
                           device)
        if name == "nim3":
            nim_launches = r["launches"]
        log(f"  {name} self-play: {e_batch} games, {e_cfg.sims_fast} / "
            f"{e_cfg.sims_full} sims, {e_args.num_channels} x "
            f"{e_args.depth}: {r['sims_per_s']:,.0f} sims/s over "
            f"{len(r['moves'])} moves; launches {r['launches']}; peak "
            f"memory {r['peak_bytes'] / 2**30:.2f} GiB")
    log(f"phase other envs' self-play: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    a = nim_arena_phase(device)
    log(f"  nim3 three-model arena: {NIM_ARENA_GAMES} games, wins "
        f"{a['wins']}, draws {a['draws']}, {a['rounds']} rounds, mean "
        f"length {a['length']:.2f}, {a['wall']:.2f} s")
    log(f"phase nim3 arena: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        co = coach_phase(device, root, OTHELLO_COACH_CUTS, "othello")
        log_coach(co, smi)
    log(f"phase othello coach: {time.perf_counter() - t0:.1f} s")
    return ([kernel_record(f"{k}@chess", k, timing[cfg.sims_full][k],
                           sp["launches"][k], errs[k])
             for k in ("descend", "backup")]
            + [kernel_record(f"{k}@nim3", k, nim_timing[k], nim_launches[k],
                             nim_errs[k]) for k in ("descend", "backup")]
            + [kernel_record(f"{k}@nim3_reuse", k, nim_rows_timing[k],
                             nim_rows_launches[k], nim_rows_errs[k])
               for k in ("descend_rows", "backup_rows")])


# --------------------------------------------------------------------------
# Players and tools (phases 22-25)
# --------------------------------------------------------------------------

#: Tree sizes of the random trees of one game (B = 1) held in phase 22:
#: about the trees of the players' searches (an MCTSPlayer move at the
#: connect4 preset's 200 simulations, the analyze tool's 400, the
#: evaluator's default 2000: sims + 3 rows each).
PLAYER_NODES = (202, 402, 2002)
#: Snapshots of phase 22's connect4 MCTSPlayer search (200 simulations,
#: N = 203) and of its chess analysis (ANALYSIS_SIMS, N = 103); the last
#: one of each is timed.
PLAYER_SNAPSHOTS = (50, 199)
ANALYSIS_SIMS = 100
ANALYSIS_SNAPSHOTS = (50, 99)
#: Phase 22's connect4 analyses, held and timed after their last
#: simulation: the analyze tool's default 400 simulations over the network
#: (N = 403) and the evaluator's default 2000 without one (N = 2003).
ANALYSIS_C4_SIMS = (400, 2000)
#: The pit phase: games a pairing, and the players' simulations (the
#: connect4 preset's 200 cut to 50 for the script's time).
PIT_GAMES = 2
PIT_SIMS = 50
#: The background evaluator of the analyze phase: connect4 at the
#: evaluator's default max_sims (N = 2003), stopped by its time limit.
EVALUATOR_SIMS = 2000
EVALUATOR_SECONDS = 8.0
#: The tournament phase: games a pairing and simulations a move.
TOURNAMENT_GAMES = 16
TOURNAMENT_SIMS = 16


def player_kernel_phase(device, smi: str) -> tuple:
    """Phase 22: both batch-major kernels bit for bit against their plain
    versions at one game (B = 1): on random trees of ``PLAYER_NODES`` rows
    (two and three players), at snapshots of a connect4 MCTSPlayer search
    (a random preset-width ResNet, 200 simulations, N = 203) and of a chess
    analysis (128 x 10, A = 4672, ``ANALYSIS_SIMS`` simulations, no root
    noise), and after the last simulation of connect4 analyses of
    ``ANALYSIS_C4_SIMS`` (N = 403 over the network, N = 2003 uniform);
    each timed at its last snapshot (cold, warm, host). Each search runs
    with the spec and evaluation of the MCTSPlayer or MCTSEvaluator that
    the preset's args make. Returns {key: (timing, errors)}."""
    for players in (2, 3):
        spec = T.SearchSpec(num_players=players)
        e = random_tree_phase(spec, device, nodes=PLAYER_NODES, batches=(1,))
        check(max(e.values()) == 0.0, f"random trees at B=1: errors {e}")
    from alphazero_general_tpu_torch.players.evaluator import MCTSEvaluator
    from alphazero_general_tpu_torch.players.players import MCTSPlayer

    # Each search has the spec and the evaluation of what grows its tree:
    # the MCTSPlayer's (root noise and temperature from the preset's args)
    # or the evaluator's (none; uniform without a network).
    out = {}
    for key, sims, snaps, player, with_net in (
            [("connect4", SIMS_FULL, PLAYER_SNAPSHOTS, True, True)]
            + [(f"connect4_n{sims + 3}", sims, (sims - 1,), False,
                sims <= 400) for sims in ANALYSIS_C4_SIMS]
            + [("chess", ANALYSIS_SIMS, ANALYSIS_SNAPSHOTS, False, True)]):
        name = key.split("_")[0]
        env = get_env(name)
        args = preset_args(name, seed=SEED)
        net = NNetWrapper(env, args, device=device) if with_net else None
        if player:
            searcher = MCTSPlayer(net, env, args, device=device)
        else:
            searcher = MCTSEvaluator(env, args, nn=net, max_sims=sims,
                                     device=device)
        spec, eval_fn = searcher.spec, searcher.eval_fn
        roots = random_openings(env, 1, 6, torch.Generator(
            device).manual_seed(SEED + 11), device)
        tree = S.init_batched_trees(env, roots, sims + 2, spec.value_size)
        log(f"  {name}: one game, {sims} simulations, N = {sims + 3}, "
            f"A = {env.ACTION_SIZE}, "
            f"{'the network' if with_net else 'uniform evaluation'}")
        errs, timing = rows_kernel_phase(env, eval_fn, spec, tree, sims,
                                         snaps, device)
        for k in ("descend_rows", "backup_rows"):
            log_timing(k, timing[k])
        out[key] = (timing, errs)
        del net, searcher, eval_fn
    log(f"  card: {smi}")
    return out


def _pit(argv) -> tuple:
    """``cli.pit.main(argv)`` with its output captured: (lines, the
    per-player move clocks {spec: (moves, ms a move)}, the final tally)."""
    import contextlib
    import io

    from alphazero_general_tpu_torch.cli import pit as cli_pit

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(cli_pit.main(argv) == 0, f"cli.pit {argv} failed")
    lines = buf.getvalue().splitlines()
    clocks, final = {}, None
    for line in lines:
        if line.startswith(("p1 ", "p2 ")) and "ms a move" in line:
            tag, spec, rest = line.split(" ", 2)
            moves, _, ms = rest.split(" ", 2)
            clocks[tag] = (spec.rstrip(":"), int(moves), float(ms.split()[0]))
        if line.startswith("final:"):
            words = line.replace(",", "").split()
            final = (int(words[2]), int(words[5]), int(words[7]))
    games = [line for line in lines if line.startswith("game ")]
    return games, clocks, final


def pit_phase(device, root: str, smi: str) -> dict:
    """Phase 23: ``cli.pit.main`` with an MCTSPlayer over a random
    preset-width connect4 checkpoint (saved by ``save_checkpoint``)
    against rawmcts, then nativemcts against greedy, ``PIT_GAMES`` games
    each: every game ends (pit checks each move against the valid moves),
    the tallies add up, and the launch counters show every simulation of
    every search through both batch-major kernels, no game-minor kernel
    and no plain version."""
    env = get_env("connect4")
    net = NNetWrapper(env, preset_args("connect4", seed=SEED), device=device)
    ckpt = os.path.join(root, "iteration-0001")
    net.save_checkpoint(root, "iteration-0001")
    del net
    dev = str(torch.device(device).type)
    out = {}
    for p1, p2 in ((f"mcts:{ckpt}", "rawmcts"), ("nativemcts", "greedy")):
        argv = ["connect4", "--p1", p1, "--p2", p2, "--games",
                str(PIT_GAMES), "--device", dev, "--set",
                f"numMCTSSims={PIT_SIMS}"]
        sync(device)
        reset_counts()
        t0 = time.perf_counter()
        with _PlainCounter(OD, "descend_plain") as pd, \
                _PlainCounter(OB, "backup_plain_") as pb:
            games, clocks, final = _pit(argv)
        wall = time.perf_counter() - t0
        launches = read_counts()
        check(final is not None and sum(final) == PIT_GAMES
              and len(games) == PIT_GAMES,
              f"pit {p1} vs {p2}: the tally {final} does not add up to "
              f"{PIT_GAMES} games")
        searched = sum(m for spec, m, _ in clocks.values()
                       if spec.startswith(("mcts", "rawmcts")))
        expect = dict.fromkeys(COUNTED, 0)
        if dev == "cuda":
            expect.update(descend_rows=searched * PIT_SIMS,
                          backup_rows=searched * PIT_SIMS)
            check(pd.calls == 0 and pb.calls == 0,
                  f"pit: plain versions ran ({pd.calls}, {pb.calls})")
        check(launches == expect,
              f"pit {p1} vs {p2}: launches {launches} != expected {expect}")
        for tag, (spec, moves, ms) in clocks.items():
            sims = f", {PIT_SIMS * 1e3 / ms:,.0f} sims/s" if spec.startswith(
                ("mcts", "rawmcts")) else ""
            log(f"  {tag} {spec.split(':')[0]}: {moves} moves, {ms:.3f} ms "
                f"a move{sims}")
            out[spec.split(":")[0]] = dict(moves=moves, ms=ms)
        out.setdefault("launches", launches)
        log(f"  {p1.split(':')[0]} vs {p2}: final {final}; {'; '.join(games)}"
            f"; launches {launches}; {wall:.1f} s; card: {smi}")
    return out


def analyze_phase(device, root: str, smi: str) -> dict:
    """Phase 24: ``cli.analyze.main`` over random preset-width checkpoints
    of connect4 (its default 400 simulations, N = 403) and chess
    (``ANALYSIS_SIMS``), each with its launch counts; then a background
    MCTSEvaluator on connect4 at ``EVALUATOR_SIMS`` simulations (N =
    2003) stopped by its time limit: the published simulations rise tick
    by tick, the last analysis is not running and the thread has
    stopped."""
    import contextlib
    import io

    from alphazero_general_tpu_torch.cli import analyze as cli_analyze
    from alphazero_general_tpu_torch.players.evaluator import MCTSEvaluator

    dev = str(torch.device(device).type)
    out = {}
    for name, sims, moves in (("connect4", None, "3,3,4"),
                              ("chess", ANALYSIS_SIMS, "")):
        env = get_env(name)
        folder = os.path.join(root, name)
        NNetWrapper(env, preset_args(name, seed=SEED),
                    device=device).save_checkpoint(folder, "iteration-0001")
        argv = [name, "--ckpt", os.path.join(folder, "iteration-0001"),
                "--moves", moves, "--device", dev]
        if sims:
            argv += ["--sims", str(sims)]
        sims = sims or 400
        buf = io.StringIO()
        sync(device)
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            check(cli_analyze.main(argv) == 0, f"cli.analyze {argv} failed")
        wall = time.perf_counter() - t0
        launches = read_counts()
        text = buf.getvalue()
        check(f"sims: {sims}" in text and "1. action" in text,
              f"analyze {name}: unexpected output {text[-300:]!r}")
        expect = dict.fromkeys(COUNTED, 0)
        if dev == "cuda":
            expect.update(descend_rows=sims, backup_rows=sims)
        check(launches == expect,
              f"analyze {name}: launches {launches} != expected {expect}")
        summary = [line.strip() for line in text.splitlines()
                   if line.startswith(("value", "  1."))]
        log(f"  analyze {name} ({sims} simulations, N = {sims + 3}): "
            f"{' / '.join(summary)}; {wall:.2f} s with the checkpoint's "
            f"load, {sims / wall:,.0f} sims/s; launches {launches}")
        out[name] = dict(sims=sims, wall=wall, launches=launches)

    env = get_env("connect4")
    net = NNetWrapper(env, preset_args("connect4", seed=SEED), device=device)
    state = env.init(1, device)
    # Warm-up (the allocator, cuDNN) on an evaluator of its own, so that
    # the timed one publishes from its first tick on.
    MCTSEvaluator(env, net.args, nn=net, max_sims=16,
                  device=device).analyze_blocking(state)
    ev = MCTSEvaluator(env, net.args, nn=net, max_sims=EVALUATOR_SIMS,
                       max_search_time=EVALUATOR_SECONDS, device=device)
    sync(device)
    reset_counts()
    seen = []
    t0 = time.perf_counter()
    ev.start(state)
    while ev.running:
        a = ev.analysis
        if not seen or a.sims != seen[-1]:
            seen.append(a.sims)
        time.sleep(0.05)
    wall = time.perf_counter() - t0
    final = ev.analysis
    ev.stop()
    launches = read_counts()
    check(not final.running and not ev.running and ev._thread is None,
          "the evaluator's thread did not stop")
    check(final.sims > 0 and seen == sorted(set(seen)) and len(seen) >= 3,
          f"the published simulations did not rise tick by tick: {seen}")
    check(final.elapsed <= EVALUATOR_SECONDS + 5.0
          or final.sims == EVALUATOR_SIMS,
          f"the evaluator ran {final.elapsed:.1f} s")
    if dev == "cuda":
        check(launches["descend_rows"] == launches["backup_rows"]
              == final.sims, f"evaluator: launches {launches} != "
              f"{final.sims} simulations")
    rate = final.sims / final.elapsed
    log(f"  background evaluator, connect4, max_sims {EVALUATOR_SIMS} "
        f"(N = {EVALUATOR_SIMS + 3}), {ev.sims_per_tick} a tick: "
        f"{final.sims} simulations in {final.elapsed:.2f} s = {rate:,.0f} "
        f"sims/s; {len(seen)} distinct publications; best "
        f"{final.best_actions}, value {final.value:.3f}, depth "
        f"{final.depth}; launches {launches}; card: {smi}")
    out["evaluator"] = dict(sims=final.sims, seconds=final.elapsed,
                            sims_per_s=rate, launches=launches)
    return out


def tournament_phase(device, root: str, smi: str) -> dict:
    """Phase 25: ``cli.roundrobin.main`` over two random preset-width
    connect4 checkpoints with the baseline, ``cli.pitmulti.main`` over the
    folder of both against the baseline, then ``cli.clean.main`` on the
    run: the win matrix adds up, the ratings are finite, the winrates lie
    in [0, 1] and reach the metrics file, and the game-minor launch
    counters equal the arenas' simulations."""
    import contextlib
    import io

    from alphazero_general_tpu_torch.cli import clean as cli_clean
    from alphazero_general_tpu_torch.cli import pitmulti as cli_pitmulti
    from alphazero_general_tpu_torch.cli import roundrobin as cli_rr

    env = get_env("connect4")
    dev = str(torch.device(device).type)
    folder = os.path.join(root, "checkpoint", "rr")
    for i in (1, 2):
        NNetWrapper(env, preset_args("connect4", seed=SEED + i),
                    device=device).save_checkpoint(folder,
                                                   f"iteration-000{i}")
    sets = ["--set", f"numMCTSSims={TOURNAMENT_SIMS}"]
    games = str(TOURNAMENT_GAMES)
    result = os.path.join(root, "rr.json")
    out = {}

    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            _PlainCounter(OD, "descend_plain") as pd, \
            _PlainCounter(OB, "backup_plain_") as pb:
        check(cli_rr.main(["connect4", "--checkpoints",
                           os.path.join(folder, "*.ckpt"),
                           "--include-baseline", "--games", games,
                           "--device", dev, "--out", result] + sets) == 0,
              "cli.roundrobin failed")
    out["roundrobin_s"] = time.perf_counter() - t0
    launches = read_counts()
    with open(result) as f:
        rr = json.load(f)
    wins = np.asarray(rr["wins"])
    n = len(rr["names"])
    check(n == 3 and rr["names"][-1] == "baseline",
          f"roundrobin contestants {rr['names']}")
    pair_sums = wins + wins.T
    check(bool(np.allclose(pair_sums[~np.eye(n, dtype=bool)],
                           TOURNAMENT_GAMES)),
          f"roundrobin: a pairing's wins do not add up to {games}: {wins}")
    check(bool(np.isfinite(rr["ratings"]).all()),
          f"roundrobin: ratings {rr['ratings']}")
    expect = dict.fromkeys(COUNTED, 0)
    if dev == "cuda":
        expect.update(descend=rr["rounds"] * (TOURNAMENT_SIMS - 1),
                      backup=rr["rounds"] * TOURNAMENT_SIMS)
        check(pd.calls == 0 and pb.calls == 0, "roundrobin: plain ran")
    check(launches == expect,
          f"roundrobin: launches {launches} != expected {expect}")
    log(f"  roundrobin, {n} contestants, {games} games a pairing, "
        f"{TOURNAMENT_SIMS} sims: wins {wins.tolist()}, ratings "
        f"{[round(r, 1) for r in rr['ratings']]}, {rr['rounds']} rounds, "
        f"{out['roundrobin_s']:.1f} s; launches {launches}")

    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    runs = os.path.join(root, "runs")
    with contextlib.redirect_stdout(buf):
        check(cli_pitmulti.main(["connect4", "--run", "rr", "--checkpoint",
                                 os.path.join(root, "checkpoint"), "--runs",
                                 runs, "--every", "1", "--games", games,
                                 "--device", dev] + sets) == 0,
              "cli.pitmulti failed")
    out["pitmulti_s"] = time.perf_counter() - t0
    launches = read_counts()
    rounds = [int(line.split(" in ")[1].split()[0])
              for line in buf.getvalue().splitlines() if " rounds" in line]
    metrics = _read_metrics(os.path.join(runs, "rr-pitmulti",
                                         "metrics.jsonl"))
    rates = metrics.get("win_rate/pit_multi", {})
    check(len(rounds) == 2 and sorted(rates) == [1, 2]
          and all(0.0 <= r <= 1.0 for r in rates.values()),
          f"pitmulti: rounds {rounds}, winrates {rates}")
    expect = dict.fromkeys(COUNTED, 0)
    if dev == "cuda":
        expect.update(descend=sum(rounds) * (TOURNAMENT_SIMS - 1),
                      backup=sum(rounds) * TOURNAMENT_SIMS)
    check(launches == expect,
          f"pitmulti: launches {launches} != expected {expect}")
    log(f"  pitmulti, 2 checkpoints vs the baseline, {games} games each: "
        f"winrates {rates}, rounds {rounds}, {out['pitmulti_s']:.1f} s; "
        f"launches {launches}; card: {smi}")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(cli_clean.main(["rr", "--checkpoint",
                              os.path.join(root, "checkpoint"), "--data",
                              os.path.join(root, "data"), "--runs", runs,
                              "--yes"]) == 0, "cli.clean failed")
    check(not os.path.exists(folder), "cli.clean left the checkpoints")
    log(f"  clean: {' / '.join(buf.getvalue().split(chr(10))[-3:-1])}")
    return out


def player_phases(device, smi: str) -> list:
    """Phases 22-25; returns the batch-major kernels' records at the
    players' shapes (B = 1)."""
    t0 = time.perf_counter()
    held = player_kernel_phase(device, smi)
    log(f"phase player kernels: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        pit = pit_phase(device, os.path.join(root, "pit"), smi)
        log(f"phase pit: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        analyze = analyze_phase(device, os.path.join(root, "analyze"), smi)
        log(f"phase analyze: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        tournament_phase(device, os.path.join(root, "tournament"), smi)
        log(f"phase tournaments: {time.perf_counter() - t0:.1f} s")
    # Each record's launches are its kernel's count over the run of the
    # entry point whose search it holds: the pit (MCTSPlayer against
    # rawmcts, at PIT_SIMS a move), the connect4 and chess analyses, and
    # the background evaluator.
    runs = {"connect4": pit["launches"],
            f"connect4_n{ANALYSIS_C4_SIMS[0] + 3}":
                analyze["connect4"]["launches"],
            f"connect4_n{ANALYSIS_C4_SIMS[1] + 3}":
                analyze["evaluator"]["launches"],
            "chess": analyze["chess"]["launches"]}
    check(sorted(runs) == sorted(held),
          f"kernel records {sorted(held)} without a run {sorted(runs)}")
    return [kernel_record(f"{k}@{name}_b1", k, timing[k], runs[name][k],
                          errs[k])
            for name, (timing, errs) in held.items()
            for k in ("descend_rows", "backup_rows")]


# --------------------------------------------------------------------------
# The search layer: multi-leaf rounds and growing-arena segments (26-30)
# --------------------------------------------------------------------------

#: Leaves a network call of the multi-leaf phases: the JAX package's gated
#: connect4 A/B ran leaf_batch=8 (results/r2/c4_elo_leaf8_config.py:33).
LEAF_BATCH = 8
#: Rounds (0-based) of phase 28's 200-simulation search at which both
#: game-minor kernels are held mid-round; the last is timed.
ROUND_SNAPSHOTS = (5, 23)
#: Games and simulations of the multi-leaf reference (phase 26).
LEAF_REFERENCE = dict(batch=256, sims=64)
#: The multi-leaf Coach phase (30): the connect4 preset through
#: ``cli.train.main`` at leaf_batch=8 and the JAX default
#: ``quant_selfplay=True``, cut to one warmup iteration and one network
#: iteration of 2048 games (preset: 8192) and no arenas (preset: both every
#: iteration). Without a past arena nothing promotes a model, so the
#: second iteration resumes the run (``load_model``, the default) in a
#: second call with ``selfPlayModelIter=1``: its self-play plays the
#: iteration-1 network, over the int8 tower.
LEAF_COACH_CUTS = dict(numWarmupIters=1, gamesPerIteration=2048,
                       compareWithBaseline=False, compareWithPast=False,
                       selfPlayModelIter=1, leaf_batch=LEAF_BATCH)


#: Moves of each layout (segmented, flat) timed in turns in the players'
#: segment phase.
PLAYER_TIMED_MOVES = 6


def net_calls(sims: int, leaf_batch: int) -> list:
    """The batch of each network call of a fresh search of ``sims``
    simulations at ``leaf_batch`` K, in units of the game batch: the
    root's expansion, then K for each of the (sims - 1) // K rounds and 1
    for each of the (sims - 1) % K simulations left over (K = 1: one call
    a simulation)."""
    if leaf_batch == 1:
        return [1] * sims
    rounds, rest = divmod(sims - 1, leaf_batch)
    return [1] + [leaf_batch] * rounds + [1] * rest


def pending_children(tt, skip_leaf: bool = False) -> int:
    """Allocated children not yet backed up (n == 0) over every game of a
    TreeT, the sink aside; with ``skip_leaf``, not counting each game's
    pending leaf, which the next backup visits."""
    pend = (tt.parent[:-1] >= 0) & (tt.n[:-1] == 0)
    if skip_leaf:
        pend[tt.leaf.long(), torch.arange(pend.shape[1],
                                          device=pend.device)] = False
    return int(pend.sum())


def _same_fields(a, b, what: str, skip_sink: bool = False) -> None:
    """Every tensor of two Trees or TreeTs equal; with ``skip_sink`` (two
    batch-major trees), all but the last row of each [B, N, ...] one."""
    names = [f.name for f in dataclasses.fields(a)
             if isinstance(getattr(a, f.name), torch.Tensor)]
    pairs = [(f"node_state.{k}", x, b.node_state[k])
             for k, x in a.node_state.items()]
    pairs += [(k, getattr(a, k), getattr(b, k)) for k in names]
    for name, x, y in pairs:
        if skip_sink and x.dim() > 1:
            x, y = x[:, :-1], y[:, :-1]
        check(bits_equal(x, y), f"{what}: {name} differs")


def multileaf_reference_phase(env, device, batch: int, sims: int) -> None:
    """Phase 26: a fresh search at ``LEAF_BATCH`` through the kernels on
    the card against the same search through the plain versions on the
    CPU: a table evaluation, root and tie noise on with the same draws
    made on the CPU. Visit counts, n and links equal, q and v within
    ``TOL_FLOAT``."""
    spec = T.SearchSpec()
    eval_fn = table_eval_fn(env, spec.value_size)
    gen = torch.Generator("cpu").manual_seed(SEED + 21)
    roots = random_openings(env, batch, 8, gen, "cpu")
    tie = torch.rand((sims, batch, env.ACTION_SIZE), generator=gen)
    nvalid = env.valid_moves(roots).sum(-1, keepdim=True).clamp(min=1)
    gammas = torch._standard_gamma(
        (T.NOISE_ALPHA_RATIO / nvalid.float()).expand(
            batch, env.ACTION_SIZE).contiguous(), generator=gen)
    trees = []
    for dev in (device, "cpu"):
        tt = init_tree_t(env, _to(roots, dev), sims + 2, spec.value_size)
        draws = S.SearchDraws(tie=tie.to(dev), gammas=gammas.to(dev))
        trees.append(S.search(env, tt, spec, eval_fn, sims, draws=draws,
                              leaf_batch=LEAF_BATCH))
    got, want = trees
    check(torch.equal(T.counts(got).cpu(), T.counts(want)),
          f"multi-leaf reference: visit counts differ between {device} and "
          "cpu")
    for name in ("n", "parent", "parent_action"):
        check(torch.equal(getattr(got, name)[:-1].cpu(),
                          getattr(want, name)[:-1]),
              f"multi-leaf reference: {name} differs between {device} and "
              "cpu")
    err = max((getattr(got, k)[:-1].cpu() - getattr(want, k)[:-1])
              .abs().max().item() for k in ("q", "v"))
    check(err <= TOL_FLOAT, f"multi-leaf reference: q, v error {err}")
    check(bool((want.n[0] == sims).all()),
          "multi-leaf reference: root visits != sims")
    rounds, rest = divmod(sims - 1, LEAF_BATCH)
    log(f"  {env.NAME}: {batch} games x {sims} sims at leaf_batch "
        f"{LEAF_BATCH} ({rounds} rounds, {rest} single) on {device} == cpu "
        f"(counts, n, links equal; q, v max error {err:.3g})")


def launches_per_sim(fn, sims: int, device) -> float:
    """Kernel launches of every kind per simulation over one call of
    ``fn`` (one move of ``sims`` simulations) under torch.profiler; on
    the CPU, 0."""
    if torch.device(device).type != "cuda":
        fn()
        return 0.0
    with torch.profiler.profile(activities=PROFILED) as prof:
        fn()
        sync(device)
    return sum(e.count for e in _device_kernels(prof)) / sims


def multileaf_selfplay_phase(env, model, cfg, batch: int, device) -> dict:
    """Phase 27: the moves of ``CYCLE`` at ``LEAF_BATCH`` and at leaf_batch
    1 through make_move_fns, in turns (``LEAF_BATCH``, 1, 1,
    ``LEAF_BATCH``), each with selfplay_phase's checks (root visits, legal
    float16 policies, both game-minor kernels once a simulation, no plain
    version); each search's network calls are its rounds' and single
    simulations' (``net_calls``), and its root children's visits sum to
    sims - 1. After an untimed fast move at each leaf batch (the first
    forward at a batch picks cuDNN's algorithms): sims/s of every run,
    kernel launches a simulation over one more fast move (torch.profiler)
    and peak memory. Returns {leaf_batch: the first run's numbers, with
    ``sims_per_s`` the list of both runs'}."""
    for k in (LEAF_BATCH, 1):  # warm-up: cuDNN's choice at each batch
        make_move_fns(env, cfg._replace(leaf_batch=k), model)["fast"](
            init_selfplay(env, batch, device=device),
            generator=torch.Generator(device).manual_seed(SEED))
    out = {}
    sims_of = [cfg.sims_fast if kind == "fast" else cfg.sims_full
               for kind in CYCLE]
    for k in (LEAF_BATCH, 1, 1, LEAF_BATCH):
        batches, visits = [], []

        def counted(obs):
            batches.append(obs.shape[0])
            return model(obs)

        def counts(tree, fn=T.counts):
            c = fn(tree)
            visits.append(c.sum(-1))
            return c

        with _Patched(T, "counts", counts):
            r = selfplay_phase(env, counted, cfg._replace(leaf_batch=k),
                               batch, CYCLE, device)
        want = [batch * m for s in sims_of for m in net_calls(s, k)]
        check(batches == want,
              f"leaf_batch {k}: network calls of {len(batches)} batches "
              f"{sorted(set(batches))}, the searches need {len(want)}")
        for s, v in zip(sims_of, visits):
            check(bool((v == s - 1).all()),
                  f"leaf_batch {k}: root children's visits != {s - 1}")
        if k in out:
            out[k]["sims_per_s"].append(r["sims_per_s"])
            out[k]["peak_bytes"] = max(out[k]["peak_bytes"],
                                       r["peak_bytes"])
        else:
            r["launches_per_sim"] = launches_per_sim(
                lambda: r["fns"]["fast"](r["carry"],
                                         generator=r["generator"]),
                cfg.sims_fast, device)
            r["net_calls"] = {s: len(net_calls(s, k)) for s in set(sims_of)}
            out[k] = dict(r, sims_per_s=[r["sims_per_s"]])
        log(f"  leaf_batch {k}: {r['sims_per_s']:,.0f} sims/s over "
            f"{len(r['moves'])} moves; network calls a search "
            f"{out[k]['net_calls']}; kernel launches a simulation "
            f"{out[k]['launches_per_sim']:.1f} (a fast move); launches "
            f"{r['launches']}; peak memory {r['peak_bytes'] / 2**30:.2f} GiB")
    return out


def rounds_kernel_phase(env, eval_fn, spec, batch: int, sims: int, device,
                        reps: int = 50) -> tuple:
    """Phase 28: both game-minor kernels against their plain versions in
    the middle of rounds of a ``LEAF_BATCH`` search: descend before the
    last walk of each round of ``ROUND_SNAPSHOTS`` (the round's earlier
    walks' children pending), backup at the round's first backup (the
    later walks' children pending), each snapshot asserted to hold pending
    children; timed at the last round. Returns (max errors, timings)."""
    gen = torch.Generator(device).manual_seed(SEED + 22)
    roots = random_openings(env, batch, 6, gen, device)
    tt = init_tree_t(env, roots, sims + 2, spec.value_size)
    errs = {"descend": 0.0, "backup": 0.0}
    timing, seen = {}, {"walk": 0, "backup": 0, "pending": []}
    walk, backup = S.descend_batched_t, S.backup_batched_t

    def held_walk(t, sp):
        seen["walk"] += 1
        rnd, i = divmod(seen["walk"] - 1, LEAF_BATCH)  # slot = seen["walk"]
        if i == LEAF_BATCH - 1 and rnd in ROUND_SNAPSHOTS:
            pend = pending_children(t)
            check(pend > 0, f"round {rnd}: no pending child before its last "
                  "walk")
            seen["pending"].append(("descend", rnd, pend))
            cols = _descend_inputs(t)
            where = (f"at N={t.parent.shape[0]}, B={batch}, mid-round {rnd} "
                     f"({pend} pending children)")
            errs["descend"] = max(errs["descend"],
                                  compare_descend(cols, sp, where))
            if rnd == ROUND_SNAPSHOTS[-1]:
                timing["descend"] = time_descend(cols, sp, device, reps)
        return walk(t, sp)

    def held_backup(t, values, sp):
        slot = seen["backup"]
        seen["backup"] += 1
        rnd, i = divmod(slot - 1, LEAF_BATCH)
        if slot > 0 and i == 0 and rnd in ROUND_SNAPSHOTS:
            pend = pending_children(t, skip_leaf=True)
            check(pend > 0, f"round {rnd}: no pending child at its first "
                  "backup")
            seen["pending"].append(("backup", rnd, pend))
            args = (t.parent, t.player, t.leaf, values, t.max_depth)
            where = (f"at N={t.parent.shape[0]}, B={batch}, mid-round {rnd} "
                     f"({pend} other pending children)")
            errs["backup"] = max(errs["backup"], compare_backup(
                args, (t.n, t.q, t.v), sp, where))
            if rnd == ROUND_SNAPSHOTS[-1]:
                timing["backup"] = time_backup(args, (t.n, t.q, t.v), sp,
                                               device, reps)
        return backup(t, values, sp)

    with _Patched(S, "descend_batched_t", held_walk), \
            _Patched(S, "backup_batched_t", held_backup):
        S.search(env, tt, spec, eval_fn, sims, gen, leaf_batch=LEAF_BATCH)
    check(seen["walk"] == sims - 1 and seen["backup"] == sims
          and len(seen["pending"]) == 2 * len(ROUND_SNAPSHOTS),
          f"rounds: {seen['walk']} walks, {seen['backup']} backups, "
          f"snapshots {seen['pending']}")
    check(bool((tt.n[0] == sims).all()), "rounds: root visits != sims")
    log(f"  {batch} games x {sims} sims at leaf_batch {LEAF_BATCH}: both "
        f"kernels bit-equal mid-round, pending children {seen['pending']}")
    return errs, timing


def _flat_plan(sims, rows, min_nodes=32):
    return [(rows, 1, sims)]


def segment_phase(env, spec, batch: int, sims: int, device,
                  reps: int = 50) -> tuple:
    """Phase 29, game-minor: a fresh search of ``sims`` simulations on
    ``batch`` games (a table evaluation: the same numbers in every run)
    run three times: segmented with both kernels held against their plain
    versions at the last simulation of every segment and timed at each
    slice (N < sims + 3); segmented under torch.profiler; flat (one
    segment) under torch.profiler. Every TreeT field bit-equal among the
    three; the segmented search's launches by tree rows those of the plan;
    each kernel's device ms a simulation segmented and flat. Returns (max
    errors, {N: timings}, device ms)."""
    eval_fn = table_eval_fn(env, spec.value_size)
    roots = random_openings(env, batch, 6, torch.Generator(
        device).manual_seed(SEED + 23), device)
    rows = sims + 3
    plan = S._segment_plan(sims, rows)
    last_of = {hi - 1: n for n, _, hi in plan}
    errs = {"descend": 0.0, "backup": 0.0}
    timing = {}

    def search(gen_seed):
        tt = init_tree_t(env, roots, sims + 2, spec.value_size)
        S.search(env, tt, spec, eval_fn, sims,
                 torch.Generator(device).manual_seed(gen_seed))
        return tt

    walk, backup = S.descend_batched_t, S.backup_batched_t
    seen = {"walk": 0, "backup": 0}

    def held_walk(t, sp):
        seen["walk"] += 1
        n = last_of.get(seen["walk"])
        if n is not None:
            check(t.parent.shape[0] == n, f"slot {seen['walk']}: a tree of "
                  f"{t.parent.shape[0]} rows, the plan gives {n}")
            cols = _descend_inputs(t)
            errs["descend"] = max(errs["descend"], compare_descend(
                cols, sp, f"in the segment of N={n}, B={batch}"))
            if n < rows:
                timing.setdefault(n, {})["descend"] = time_descend(
                    cols, sp, device, reps)
        return walk(t, sp)

    def held_backup(t, values, sp):
        n = last_of.get(seen["backup"])
        seen["backup"] += 1
        if n is not None:
            args = (t.parent, t.player, t.leaf, values, t.max_depth)
            errs["backup"] = max(errs["backup"], compare_backup(
                args, (t.n, t.q, t.v), sp, f"in the segment of N={n}"))
            if n < rows:
                timing.setdefault(n, {})["backup"] = time_backup(
                    args, (t.n, t.q, t.v), sp, device, reps)
        return backup(t, values, sp)

    with _Patched(S, "descend_batched_t", held_walk), \
            _Patched(S, "backup_batched_t", held_backup):
        held = search(SEED + 24)
    check(seen["walk"] == sims - 1, "segments: walks != sims - 1")
    cuda = torch.device(device).type == "cuda"
    ms, trees, launches = {}, {}, {}
    for name, plan_fn in (("segmented", S._segment_plan),
                          ("flat", _flat_plan)):
        with _Patched(S, "_segment_plan", plan_fn):
            sync(device)
            reset_counts()
            ms[name] = {}
            if cuda:
                with torch.profiler.profile(activities=PROFILED) as prof:
                    trees[name] = search(SEED + 24)
                    sync(device)
                ms[name] = {k: sum(e.self_device_time_total for e in
                                   _device_kernels(prof) if k in e.key)
                            / 1e3 / sims
                            for k in ("descend_kernel", "backup_kernel")}
            else:
                trees[name] = search(SEED + 24)
            launches[name] = read_counts_by_rows()
    _same_fields(trees["segmented"], trees["flat"],
                 "segmented search against flat")
    _same_fields(held, trees["flat"], "held segmented search against flat")
    if cuda:
        got = {k: launches["segmented"][k] for k in ("descend", "backup")}
        want = fresh_launches_by_rows(SelfPlayConfig(sims_full=sims),
                                      [("full", sims)])
        check(got == want, f"segmented search: launches by tree rows {got}"
              f" != the plan's {want}")
    log(f"  {batch} games x {sims} sims, plan {plan}: every TreeT field "
        "bit-equal to the flat loop's; both kernels bit-equal at N = "
        f"{sorted(last_of.values())}")
    for k in ("descend_kernel", "backup_kernel"):
        if ms["flat"]:
            log(f"  {k}: {ms['segmented'][k]:.5f} ms of device time a "
                f"simulation segmented, {ms['flat'][k]:.5f} flat "
                f"({ms['segmented'][k] / ms['flat'][k]:.3f}x)")
    return errs, timing, ms


def player_segment_phase(device, sims: int,
                         timed: int = PLAYER_TIMED_MOVES) -> dict:
    """Phase 29, batch-major: an MCTSPlayer move over a random preset-width
    connect4 checkpoint (the pit's) and a rawmcts move, each at ``sims``
    simulations (N = sims + 3), segmented (both rows kernels held against
    their plain versions at the last simulation of every segment) and
    flat: every tree field but the sink row equal, and the same move.
    cuDNN is held deterministic, so that both moves' networks give the
    same numbers. Then ``timed`` moves of each layout, none held, in turns
    (segmented, flat, flat, segmented, ...), and the host's time of the
    slices' copies and merges of one move. Returns {player: {"segmented"
    / "flat": ms of each timed move, "slices_host": ms}}."""
    from alphazero_general_tpu_torch.players.players import MCTSPlayer, \
        RawMCTSPlayer

    env = get_env("connect4")
    args = preset_args("connect4", seed=SEED, numMCTSSims=sims)
    net = NNetWrapper(env, args, device=device)
    with tempfile.TemporaryDirectory() as root:
        net.save_checkpoint(root, "iteration-0001")
        net = NNetWrapper.from_checkpoint(env, root, "iteration-0001",
                                          device=device)
    state = random_openings(env, 1, 6, torch.Generator(
        device).manual_seed(SEED + 25), device)
    plan = S._segment_plan(sims, sims + 3)
    last_of = {hi - 1: n for n, _, hi in plan}
    plans = {"segmented": S._segment_plan, "flat": _flat_plan}
    walk, backup = S.descend_batched, S.backup_batched
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for kind in ("mcts", "rawmcts"):
            def make():
                if kind == "mcts":
                    return MCTSPlayer(net, env, args, device=device)
                return RawMCTSPlayer(env, args, device=device)

            seen = {"walk": 0, "backup": 0, "held": []}

            def held_walk(tree, sp):
                n = last_of.get(seen["walk"])
                seen["walk"] += 1
                if n is not None:
                    check(tree.parent.shape[1] == n, "a slice of "
                          f"{tree.parent.shape[1]} rows, the plan gives {n}")
                    eany = (tree.e > 0).any(dim=-1).to(torch.float32)
                    compare_descend(
                        (tree.parent, tree.parent_action, tree.n, tree.q,
                         tree.v, tree.edge_prior, eany, tree.nba, tree.nbp),
                        sp, f"{kind}, a slice of N={n}", rows=True)
                    seen["held"].append(n)
                return walk(tree, sp)

            def held_backup(tree, values, sp):
                n = last_of.get(seen["backup"])
                seen["backup"] += 1
                if n is not None:
                    compare_backup(
                        (tree.parent, tree.player, tree.leaf, values,
                         tree.max_depth), (tree.n, tree.q, tree.v), sp,
                        f"{kind}, a slice of N={n}", rows=True)
                return backup(tree, values, sp)

            make().play(state)  # warm-up: the allocator, cuDNN
            seg, flat = make(), make()
            with _Patched(S, "descend_batched", held_walk), \
                    _Patched(S, "backup_batched", held_backup):
                move = seg.play(state)
            with _Patched(S, "_segment_plan", _flat_plan):
                check(flat.play(state) == move, f"{kind}: the segmented "
                      "move differs from the flat move")
            _same_fields(seg.last_tree, flat.last_tree,
                         f"{kind} move segmented against flat",
                         skip_sink=True)
            check(sorted(set(seen["held"])) == sorted(set(last_of.values())),
                  f"{kind}: rows kernels held at {seen['held']}")
            ms = {"segmented": [], "flat": []}
            for name in ("segmented", "flat", "flat", "segmented") * (
                    timed // 2):
                player = make()
                with _Patched(S, "_segment_plan", plans[name]):
                    sync(device)
                    t0 = time.perf_counter()
                    player.play(state)
                    sync(device)
                ms[name].append((time.perf_counter() - t0) * 1e3)
            tree = seg.last_tree

            def slices():  # what the segments add to a move
                for n, _, _ in plan[:-1]:
                    T.merge_batched_rows(tree, T.slice_batched_rows(tree, n))

            ms["slices_host"] = host_ms(slices, 20, device)
            out[kind] = ms
            log(f"  {kind} move, {sims} simulations, plan {plan}: equal to "
                f"the flat move but the sink row (action {move}); rows "
                f"kernels bit-equal at N = {sorted(set(seen['held']))}; ms "
                "a move in turns: " + "; ".join(
                    f"{name} mean {np.mean(v):.1f} (min {min(v):.1f}, max "
                    f"{max(v):.1f}; " + ", ".join(f"{x:.1f}" for x in v)
                    + ")" for name, v in ms.items() if name != "slices_host")
                + f"; the slices' copies and merges {ms['slices_host']:.3f} "
                "ms of host time a move")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def search_layer_phases(device, smi: str, by_rows: dict = None) -> list:
    """Phases 26-30; returns the game-minor kernels' records under rounds
    and at the segment slices. A slice's record takes its launches from
    ``by_rows``, the connect4 Coach phase's launches by tree rows (on the
    CPU, where nothing launches, none)."""
    env = get_env("connect4")
    args = get_args(seed=SEED, numMCTSSims=SIMS_FULL, numFastSims=SIMS_FAST,
                    **MODEL)
    cfg = SelfPlayConfig.from_args(args, env.NUM_PLAYERS, env.HAS_DRAW)
    net = NNetWrapper(env, args, device=device)

    t0 = time.perf_counter()
    multileaf_reference_phase(env, device, **LEAF_REFERENCE)
    log(f"phase multi-leaf reference: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lp = multileaf_selfplay_phase(env, net.model, cfg, GAMES, device)
    many, one = lp[LEAF_BATCH], lp[1]
    rate = {k: sum(v["sims_per_s"]) / len(v["sims_per_s"])
            for k, v in lp.items()}
    log(f"  multi-leaf self-play at the preset, runs in turns: "
        f"{rate[LEAF_BATCH]:,.0f} sims/s at leaf_batch {LEAF_BATCH} "
        f"({', '.join(f'{x:,.0f}' for x in many['sims_per_s'])}), "
        f"{rate[1]:,.0f} at 1 "
        f"({', '.join(f'{x:,.0f}' for x in one['sims_per_s'])}): "
        f"{rate[LEAF_BATCH] / rate[1]:.3f}x; kernel launches "
        f"a simulation {many['launches_per_sim']:.1f} and "
        f"{one['launches_per_sim']:.1f}; peak memory "
        f"{many['peak_bytes'] / 2**30:.2f} and "
        f"{one['peak_bytes'] / 2**30:.2f} GiB; card: {smi}")
    log(f"phase multi-leaf self-play: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    errs, rounds_t = rounds_kernel_phase(env, net.make_eval_fn(), cfg.spec,
                                         GAMES, SIMS_FULL, device)
    for k in ("descend", "backup"):
        log_timing(k, rounds_t[k])
    log(f"phase kernels under rounds: {time.perf_counter() - t0:.1f} s")
    records = [kernel_record(f"{k}@connect4_rounds", k, rounds_t[k],
                             lp[LEAF_BATCH]["launches"][k], errs[k])
               for k in ("descend", "backup")]

    t0 = time.perf_counter()
    errs, seg_t, seg_ms = segment_phase(env, cfg.spec, GAMES, SIMS_FULL,
                                        device)
    cuda = torch.device(device).type == "cuda"
    for n, t in sorted(seg_t.items()):
        for k in ("descend", "backup"):
            log_timing(k, t[k])
            rows = (by_rows or {}).get(k, {})
            check(rows.get(n, 0) > 0 or not cuda,
                  f"{k} ran on no tree of {n} rows in the Coach phase: "
                  f"{rows}")
            records.append(kernel_record(f"{k}@connect4_seg_n{n}", k, t[k],
                                         rows.get(n, 0), errs[k], rows))
    pl = player_segment_phase(device, SIMS_FULL)
    log(f"  card: {smi}")
    log(f"phase segments: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        co = coach_phase(device, root, dict(LEAF_COACH_CUTS, numIters=1),
                         resume=dict(LEAF_COACH_CUTS, numIters=2))
    log_coach(co, smi)
    check(co["iters"][2]["int8"]["self_play"] == 1.0,
          "multi-leaf coach: iteration 2 did not play the int8 network")
    log(f"phase multi-leaf coach: {time.perf_counter() - t0:.1f} s")
    return records, dict(leaf_batch=LEAF_BATCH, sims_per_s={
        k: v["sims_per_s"] for k, v in lp.items()},
        launches_per_sim={k: v["launches_per_sim"] for k, v in lp.items()},
        peak_bytes={k: v["peak_bytes"] for k, v in lp.items()},
        segment_ms=seg_ms, player_ms=pl, coach_wall=co["wall"])


# --------------------------------------------------------------------------
# Multi-device (phases 31-32)
# --------------------------------------------------------------------------

#: The 2-rank Coach (phase 32): the connect4 preset through
#: ``cli.train.main`` in each rank, two calls. The first runs the warmup
#: iteration (2048 global games, 1024 a rank), then both arenas of 128
#: games (64 a rank) at ``MULTI_ARENA_SIMS`` simulations (preset: 512
#: games at 200; an arena's searches take ``numMCTSSims``, so the cut
#: also sets the call's full searches, which a warmup iteration does not
#: run) and a gate that always promotes; the second resumes the run for a
#: network iteration at the preset's 200 / 40 simulations over the int8
#: tower, without arenas.
MULTI_ARENA_SIMS = 50
MULTI_COACH_CUTS = dict(numIters=1, numWarmupIters=1, gamesPerIteration=2048,
                        arenaCompare=128, arenaCompareBaseline=128,
                        numMCTSSims=MULTI_ARENA_SIMS,
                        min_next_model_winrate=0.0)
MULTI_RESUME_CUTS = dict(numIters=2, numWarmupIters=1,
                         gamesPerIteration=2048, compareWithBaseline=False,
                         compareWithPast=False)
#: Sizes of the multi-device phases: the connect4 preset's width (the
#: CPU rehearsal in tests/test_torch_isolation.py shrinks them).
MULTI = dict(
    world=2, games=GAMES, sims_full=SIMS_FULL, sims_fast=SIMS_FAST,
    model=MODEL, cycle=CYCLE,
    # phase 31: train steps through NCCL at world size 1
    nccl_steps=TRAIN_TIMED_STEPS, nccl_batch=1024,
    # phase 32: the fixed global batch of the 2-rank train-step check
    train_batch=TRAIN_CHECK_BATCH,
    # the game-minor kernels held mid-search in each rank (timed there)
    snapshots=(100,),
    # reuse moves in each rank, then the batch-major kernels held on the
    # carried trees after 20 simulations of a 40-simulation search
    reuse_cycle=("fast", "fast"), reuse_sims=SIMS_FAST, reuse_snapshots=(20,),
    reps=50, coach=MULTI_COACH_CUTS, resume=MULTI_RESUME_CUTS,
    # seconds the ranks of phase 32 may take before they are killed
    deadline=600)
#: Gradient all-reduces timed per backend.
ALLREDUCE_REPS = 10


def wall_ms(fn, reps: int, device) -> float:
    """Host milliseconds per call of ``fn``, each followed by a device
    sync (a Gloo collective blocks the host anyway)."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        sync(device)
    return (time.perf_counter() - t0) * 1e3 / reps


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _train_rows(env, batch: int, seed: int, device):
    """A global train batch made from ``seed`` on the CPU (the same in
    every process): observations of random openings, Dirichlet policies,
    one-hot values; on ``device``."""
    rng = np.random.default_rng(seed)
    states = random_openings(env, batch, 12,
                             torch.Generator().manual_seed(seed), "cpu")
    obs = env.observation(states).to(torch.float32)
    pi = torch.from_numpy(rng.dirichlet(np.ones(env.ACTION_SIZE), batch)
                          .astype(np.float32))
    value = torch.from_numpy(np.eye(3, dtype=np.float32)[
        rng.integers(0, 3, batch)])
    return tuple(x.to(device) for x in (obs, pi, value))


def _log_apply(eval_fn):
    """An apply fn (log-probabilities) over an evaluation by probabilities,
    for ``make_move_fns``."""
    return lambda obs: tuple(torch.log(x) for x in eval_fn(obs))


def mesh_moves(env, apply_fn, cfg, games: int, cycle, device, seed: int):
    """Fresh-tree moves of this rank's share of ``games`` through the mesh
    code, as the Coach plays them: the global batch's draws cut to the
    rank's games (``GameShard``) and the finished-game count summed over
    the ranks after each move. Returns the records' integer fields and
    the global count."""
    fns = make_move_fns(env, cfg, apply_fn)
    carry = init_selfplay(env, games // M.world_size(), device=device,
                          cfg=cfg)
    gen = M.shard_generator(torch.Generator(device).manual_seed(seed),
                            games)
    recs, done = [], 0
    for kind in cycle:
        carry, rec = fns[kind](carry, generator=gen)
        done = int(M.all_reduce_sum(carry.games_played))
        recs.append({f: getattr(rec, f).cpu() for f in
                     ("action", "player", "done", "win_state")})
    return recs, done


def nccl_phase(device, sizes=MULTI) -> dict:
    """Phase 31: ``init_distributed`` under torchrun's variables at
    WORLD_SIZE=1 (NCCL on the card, Gloo on the CPU), fresh-tree moves and
    train steps through the mesh code, then the group is left. The train
    steps (float32, deterministic cuDNN) must equal the same steps without
    a group within TRAIN_RTOL / TRAIN_ATOL."""
    env = get_env("connect4")
    cuda = torch.device(device).type == "cuda"
    check(not M.is_distributed(), "a process group exists before phase 31")
    saved = {k: os.environ.get(k) for k in
             ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT")}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    out = {}
    try:
        check(M.init_distributed("cuda" if cuda else "cpu"),
              "init_distributed formed no group under WORLD_SIZE=1")
        backend = dist.get_backend()
        check(backend == ("nccl" if cuda else "gloo"),
              f"init_distributed chose {backend}")
        check(M.world_size() == 1 and M.usable_devices(
            -1, sizes["games"], sizes["nccl_batch"]) == 1,
            "the world of one rank")
        args = get_args(seed=SEED, numMCTSSims=sizes["sims_full"],
                        numFastSims=sizes["sims_fast"], **sizes["model"])
        cfg = SelfPlayConfig.from_args(args, env.NUM_PLAYERS, env.HAS_DRAW)
        net = NNetWrapper(env, args, device=device)
        reset_counts()
        _, games_done = mesh_moves(env, net.model, cfg, sizes["games"],
                                   sizes["cycle"], device, SEED + 5)
        sync(device)
        launches = read_counts()
        if cuda:
            check(launches["descend"] > 0 and launches["backup"] > 0,
                  f"phase 31: the moves launched {launches}")

        f32 = get_args(seed=SEED, **dict(sizes["model"],
                                         compute_dtype="float32"))
        rows = _train_rows(env, sizes["nccl_steps"] * sizes["nccl_batch"],
                           SEED + 11, device)
        n = sizes["nccl_batch"]
        batches = [tuple(x[k * n:(k + 1) * n] for x in rows)
                   for k in range(sizes["nccl_steps"])]
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            nets = {}
            for mesh in (False, True):
                nets[mesh] = NNetWrapper(env, f32, device=device)
                if mesh:
                    nets[mesh].attach_mesh()
                    check(nets[mesh].mesh, "attach_mesh under a group")
                nets[mesh].train(batches, len(batches))
            sync(device)
        finally:
            torch.backends.cudnn.deterministic = det
        err = 0.0
        want = nets[False].model.state_dict()
        for k, x in nets[True].model.state_dict().items():
            d = (x - want[k]).abs()
            check(not bool((d > TRAIN_ATOL + TRAIN_RTOL * want[k].abs())
                           .any()),
                  f"phase 31: {k} after the mesh steps != without a group "
                  f"(max error {d.max().item():.3g})")
            err = max(err, d.max().item())
        mesh_net = nets[True]
        nccl_kernels = {}
        if cuda:
            with torch.profiler.profile(activities=PROFILED) as prof:
                mesh_net.train(batches[:1], 1)
                sync(device)
            nccl_kernels = {e.key: e.count for e in _device_kernels(prof)
                            if "nccl" in e.key.lower()}
        params = sum(p.numel() for p in mesh_net.model.parameters())
        out = dict(backend=backend, games_done=games_done,
                   launches=launches, max_err=err, params=params,
                   nccl_kernels=nccl_kernels,
                   allreduce_ms=wall_ms(lambda: M.all_reduce_mean_(
                       mesh_net.model), ALLREDUCE_REPS, device))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


class _Coins:
    """A numpy stream that records each ``random()`` draw (the Coach's
    fast/full coins) in ``coins``."""

    def __init__(self, rng, coins):
        self.rng, self.coins = rng, coins

    def random(self, *a, **k):
        x = self.rng.random(*a, **k)
        self.coins.append(float(x))
        return x

    def __getattr__(self, name):
        return getattr(self.rng, name)


def state_digest(module) -> str:
    """sha256 of a module's parameters and statistics, bit for bit."""
    h = hashlib.sha256()
    for k, v in sorted(module.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_coach(device, root: str, sizes) -> dict:
    """This rank's part of the 2-rank Coach: ``cli.train.main`` twice in
    the group the caller made, with the Coach recording its coins and
    checkpoint writes; the kernels' launches over both calls."""
    import alphazero_general_tpu_torch.train as train_pkg
    from alphazero_general_tpu_torch.cli import train as cli_train

    coins, saves, coaches = [], [], []

    class Recording(train_pkg.Coach):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self._np_rng = _Coins(self._np_rng, coins)
            coaches.append(self)

    def save(self, folder, filename):
        saves.append(filename)
        return orig_save(self, folder, filename)

    orig_save = NNetWrapper.save_checkpoint
    dirs = dict(run_name="smoke", checkpoint=f"{root}/checkpoint",
                data=f"{root}/data", log_dir=f"{root}/runs")
    reset_counts()
    sync(device)
    t0 = time.perf_counter()
    with _Patched(train_pkg, "Coach", Recording), \
            _Patched(NNetWrapper, "save_checkpoint", save):
        for cut in (sizes["coach"], sizes["resume"]):
            argv = ["connect4", "--device", torch.device(device).type]
            for k, v in {**cut, **dirs}.items():
                argv += ["--set", f"{k}={v!r}"]
            check(cli_train.main(argv) == 0, f"cli.train.main {argv}")
    sync(device)
    last = coaches[-1]
    return dict(wall=time.perf_counter() - t0, launches=read_counts(),
                coins=coins, saves=saves, ranks=last.ranks,
                digest=state_digest(last.train_net.model),
                sp_digest=state_digest(last.self_play_net.model),
                self_play_iter=last.self_play_iter,
                gating_counter=last.gating_counter)


def _in_rank_order(fn):
    """``fn()`` in each rank in turn (the others wait), so that timings
    are not shared with another process on the card; returns this rank's
    result."""
    out = None
    for r in range(M.world_size()):
        if M.rank() == r:
            out = fn()
        M.barrier()
    return out


def rank_child(rank: int, world: int, work: str) -> None:
    """One rank of phase 32 (``chip_smoke.py --rank R W DIR``): joins the
    Gloo group of ``DIR/store`` on the card (all ranks share device 0),
    runs the rank's tasks on the sizes in ``DIR/sizes.pt`` and writes its
    results to ``DIR/rank<R>.pt``."""
    from alphazero_general_tpu_torch.ops import build as OBuild

    sizes = torch.load(os.path.join(work, "sizes.pt"), weights_only=False)
    device = sizes["device"]
    # The ranks share the host's cores as they share the caller's.
    torch.set_num_threads(sizes["threads"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=world)
    out = dict(rank=rank)
    try:
        env = get_env("connect4")
        games = sizes["games"]
        M.rank_slice(games)  # raises where the games do not split
        if cuda:
            # Every rank builds the kernels at once into one fresh folder
            # (ops/build.py installs with os.replace), then launches them.
            OBuild.BUILD_DIR = OBuild.Path(work) / "build"
            t0 = time.perf_counter()
            res = OBuild.build_library()
            out["build"] = dict(seconds=time.perf_counter() - t0,
                                built=res.seconds > 0, lib=res.path.name)
            M.barrier()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)

        # Moves over a table evaluation (the same numbers at any batch):
        # the 1-rank run's rows for this rank's games.
        args = get_args(seed=SEED, numMCTSSims=sizes["sims_full"],
                        numFastSims=sizes["sims_fast"], **sizes["model"])
        cfg = SelfPlayConfig.from_args(args, env.NUM_PLAYERS, env.HAS_DRAW)
        table = _log_apply(table_eval_fn(env, cfg.spec.value_size))
        reset_counts()
        out["table"], _ = mesh_moves(env, table, cfg, games, sizes["cycle"],
                                     device, SEED + 6)
        out["table_launches"] = read_counts()

        # A float32 train step on this rank's rows of a fixed global batch.
        f32 = get_args(seed=SEED, **dict(sizes["model"],
                                         compute_dtype="float32"))
        rows = _train_rows(env, sizes["train_batch"], SEED + 9, device)
        tnet = NNetWrapper(env, f32, device=device)
        tnet.attach_mesh()
        part = M.rank_slice(sizes["train_batch"])
        tnet.train([tuple(x[part] for x in rows)], 1)
        out["train_state"] = {k: v.cpu() for k, v in
                              tnet.model.state_dict().items()}
        out["train_digest"] = state_digest(tnet.model)
        out["allreduce_ms"] = wall_ms(lambda: M.all_reduce_mean_(
            tnet.model), ALLREDUCE_REPS, device)
        out["params"] = sum(p.numel() for p in tnet.model.parameters())
        del tnet

        # Self-play sims/s, the ranks at once over the random network.
        net = NNetWrapper(env, args, device=device)
        local = games // world
        selfplay_phase(env, net.model, cfg, local, sizes["cycle"][:1],
                       device)  # warm-up
        M.barrier()
        sp = selfplay_phase(env, net.model, cfg, local, sizes["cycle"],
                            device)
        out["selfplay"] = dict(wall=sum(dt for _, _, dt in sp["moves"]),
                               sims=sum(s for _, s, _ in sp["moves"]),
                               games=local)
        M.barrier()

        # Each rank's kernels against their plain versions: the game-minor
        # ones mid-search at its self-play shape, the batch-major ones on
        # the trees of its reuse moves; timed in turns.
        def kernels():
            errs, timing = kernel_phase(
                env, net.make_eval_fn(), cfg.spec, local,
                sizes["sims_full"], sizes["snapshots"], device,
                reps=sizes["reps"])
            rcfg = cfg._replace(reuse_tree=True)
            rp = selfplay_phase(env, net.model, rcfg, local,
                                sizes["reuse_cycle"], device)
            rerrs, rtiming = rows_kernel_phase(
                env, net.make_eval_fn(), cfg.spec, rp["carry"].trees,
                sizes["reuse_sims"], sizes["reuse_snapshots"], device,
                reps=sizes["reps"])
            return dict(errs={**errs, **rerrs},
                        timing={**timing, **rtiming},
                        reuse_launches=rp["launches"])

        out["kernels"] = _in_rank_order(kernels)
        del net

        out["coach"] = rank_coach(device, work, sizes)
        out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                             if cuda else 0)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        M.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(work: str, sizes: dict) -> list:
    """Phase 32's ranks, each ``chip_smoke.py --rank R W DIR`` in its own
    process with its output in ``DIR/rank<R>.log``; fails (killing every
    rank) as soon as one exits non-zero, or at ``sizes["deadline"]``."""
    world = sizes["world"]
    torch.save(sizes, os.path.join(work, "sizes.pt"))
    env = dict(os.environ, WORLD_SIZE=str(world), LOCAL_RANK="0",
               PYTHONUNBUFFERED="1")
    logs, procs = [], []
    for r in range(world):
        logs.append(open(os.path.join(work, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             str(world), work], stdout=logs[-1], stderr=subprocess.STDOUT,
            env=dict(env, RANK=str(r))))
    deadline = time.perf_counter() + sizes["deadline"]
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.perf_counter() > deadline:
                failed = f"the ranks passed {sizes['deadline']} s"
                break
            time.sleep(0.5)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if failed is not None:
        tails = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r}:\n" + f.read()[-3000:])
        raise SmokeFailure(f"phase 32: {failed}\n" + "\n".join(tails))
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def two_rank_phase(device, work: str, sizes=MULTI) -> dict:
    """Phase 32: the ranks of ``run_ranks`` against this process as one
    rank on the same inputs, and the 2-rank Coach's files and metrics;
    self-play sims/s of one rank before and after the ranks' run."""
    env = get_env("connect4")
    cuda = torch.device(device).type == "cuda"
    world, games = sizes["world"], sizes["games"]
    args = get_args(seed=SEED, numMCTSSims=sizes["sims_full"],
                    numFastSims=sizes["sims_fast"], **sizes["model"])
    cfg = SelfPlayConfig.from_args(args, env.NUM_PLAYERS, env.HAS_DRAW)
    net = NNetWrapper(env, args, device=device)
    one_rate = [selfplay_phase(env, net.model, cfg, games, sizes["cycle"],
                               device)["sims_per_s"]]
    table = _log_apply(table_eval_fn(env, cfg.spec.value_size))
    want_table, _ = mesh_moves(env, table, cfg, games, sizes["cycle"],
                               device, SEED + 6)
    f32 = get_args(seed=SEED, **dict(sizes["model"],
                                     compute_dtype="float32"))
    one = NNetWrapper(env, f32, device=device)
    one.train([_train_rows(env, sizes["train_batch"], SEED + 9, device)], 1)
    want_state = {k: v.cpu() for k, v in one.model.state_dict().items()}
    del one

    t0 = time.perf_counter()
    ranks = run_ranks(work, dict(
        sizes, device=device,
        threads=max(1, torch.get_num_threads() // world)))
    ranks_wall = time.perf_counter() - t0
    one_rate.append(selfplay_phase(env, net.model, cfg, games,
                                   sizes["cycle"], device)["sims_per_s"])

    local = games // world
    # 7. the table moves: each rank's records are the 1-rank run's rows of
    # its games.
    for r, out in enumerate(ranks):
        rows = slice(r * local, (r + 1) * local)
        for k, (got, want) in enumerate(zip(out["table"], want_table)):
            for f in want:
                check(torch.equal(got[f], want[f][rows]),
                      f"phase 32: rank {r}'s move {k} {f} != the 1-rank "
                      "run's")
        if cuda:
            n = out["table_launches"]
            check(n["descend"] > 0 and n["backup"] > 0,
                  f"phase 32: rank {r}'s moves launched {n}")
    # 6. the train step: both ranks bit-identical, the 1-rank step within
    # the train tolerance.
    check(ranks[0]["train_digest"] == ranks[1]["train_digest"],
          "phase 32: the ranks' weights differ after the train step")
    err = 0.0
    for k, x in ranks[0]["train_state"].items():
        d = (x - want_state[k]).abs()
        check(not bool((d > TRAIN_ATOL + TRAIN_RTOL * want_state[k].abs())
                       .any()),
              f"phase 32: the 2-rank step's {k} != the 1-rank step's (max "
              f"error {d.max().item():.3g})")
        err = max(err, d.max().item())
    # 5. each rank's kernels: bit-equal to their plain versions, launched
    # by its Coach.
    for r, out in enumerate(ranks):
        for k, e in out["kernels"]["errs"].items():
            check(e == 0.0, f"phase 32: rank {r}'s {k} error {e}")
        n = out["coach"]["launches"]
        if cuda:
            check(n["descend"] > 0 and n["backup"] > 0,
                  f"phase 32: rank {r}'s Coach launched {n}")
            rl = out["kernels"]["reuse_launches"]
            check(rl["descend_rows"] > 0 and rl["backup_rows"] > 0,
                  f"phase 32: rank {r}'s reuse moves launched {rl}")
    # 1, 4. weights, gating and coins the same on both ranks.
    co = [out["coach"] for out in ranks]
    for key in ("digest", "sp_digest", "self_play_iter", "gating_counter",
                "coins", "ranks"):
        check(co[0][key] == co[1][key],
              f"phase 32: the ranks' Coaches differ in {key}")
    check(co[0]["ranks"] == world and len(co[0]["coins"]) > 0
          and co[0]["self_play_iter"] == 1,
          f"phase 32: ranks {co[0]['ranks']}, {len(co[0]['coins'])} coins, "
          f"self-play model {co[0]['self_play_iter']}")
    # 2. rank 0 alone wrote the checkpoints.
    check(co[1]["saves"] == [] and co[0]["saves"] == [
        get_iter_file(i) for i in range(3)],
        f"phase 32: checkpoint writes {co[0]['saves']} / {co[1]['saves']}")
    ckpt = os.path.join(work, "checkpoint", "smoke")
    for i in range(3):
        check(os.path.isfile(os.path.join(ckpt, get_iter_file(i) + ".ckpt")),
              f"phase 32: no checkpoint {i}")
    # 3. two sample files an iteration whose rows add up to the samples
    # the finalizers counted (rank 0's metric: the sum over the ranks).
    m = _read_metrics(os.path.join(work, "runs", "smoke", "metrics.jsonl"))
    files = sorted(os.listdir(os.path.join(work, "data", "smoke")))
    check(files == [f"{get_iter_file(i)}-p{r}.npz" for i in (1, 2)
                    for r in range(world)],
          f"phase 32: sample files {files}")
    samples = {}
    for i in (1, 2):
        n = []
        for r in range(world):
            store = ReplayStore(os.path.join(work, "data"), "smoke")
            store._suffix = f"-p{r}"
            n.append(len(store.load(i)[0]))
        samples[i] = n
        check(sum(n) == m["self_play/samples"][i] and min(n) > 0,
              f"phase 32: iteration {i} files hold {n} samples, the "
              f"finalizers counted {m['self_play/samples'][i]}")
    check(m["self_play/int8"][2] == 1.0,
          "phase 32: iteration 2 did not play the int8 tower")
    for kind in ("baseline", "past"):
        a = {t: m[f"arena_{kind}/{t}"][1] for t in
             ("games", "wins_new", "wins_other", "draws")}
        check(a["wins_new"] + a["wins_other"] + a["draws"] == a["games"]
              == sizes["coach"]["arenaCompare"],
              f"phase 32: the {kind} arena's results {a}")
    sp = [out["selfplay"] for out in ranks]
    return dict(
        ranks=ranks, wall=ranks_wall, train_max_err=err, samples=samples,
        sims_per_s_1rank=one_rate,
        sims_per_s_2rank=games * sp[0]["sims"] / max(s["wall"] for s in sp),
        times={t[5:]: m[t] for t in m if t.startswith("time/")},
        arenas={kind: {t: m[f"arena_{kind}/{t}"][1] for t in
                       ("games", "rounds", "wins_new", "wins_other",
                        "draws")} for kind in ("baseline", "past")})


def multi_device_phases(device, smi: str, sizes=MULTI) -> tuple:
    """Phases 31-32; returns the ranks' kernel records and the numbers."""
    t0 = time.perf_counter()
    nc = nccl_phase(device, sizes)
    log(f"  NCCL at world size 1: {nc['games_done']} games done over the "
        f"mesh moves, launches {nc['launches']}; {sizes['nccl_steps']} "
        f"train steps at batch {sizes['nccl_batch']} with the group within "
        f"{nc['max_err']:.3g} of the steps without; NCCL kernels in a "
        f"step's trace: {nc['nccl_kernels'] or 'none'}; a gradient "
        f"all-reduce ({nc['params']:,} floats) {nc['allreduce_ms']:.3f} ms; "
        f"card: {smi}")
    log(f"phase NCCL: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        tr = two_rank_phase(device, work, sizes)
    records = []
    for r, out in enumerate(tr["ranks"]):
        t = out["kernels"]["timing"]
        errs = out["kernels"]["errs"]
        for k in ("descend", "backup"):
            log_timing(k, t[k])
            records.append(kernel_record(
                f"{k}@connect4_rank{r}_of_2", k, t[k],
                out["coach"]["launches"][k], errs[k]))
        for k in ("descend_rows", "backup_rows"):
            log_timing(k, t[k])
            records.append(kernel_record(
                f"{k}@connect4_reuse_rank{r}_of_2", k, t[k],
                out["kernels"]["reuse_launches"][k], errs[k]))
    r0 = tr["ranks"]
    one = ", ".join(f"{x:,.0f}" for x in tr["sims_per_s_1rank"])
    ar = ", ".join(f"{o['allreduce_ms']:.2f}" for o in r0)
    peak = ", ".join(f"{o['peak_bytes'] / 2**30:.2f}" for o in r0)
    log(f"  two ranks on one card over Gloo: self-play "
        f"{tr['sims_per_s_2rank']:,.0f} sims/s of {sizes['games']} games, "
        f"one rank {one} (before, after); a gradient all-reduce {ar} ms; "
        f"peak memory {peak} GiB; "
        f"train step within {tr['train_max_err']:.3g} of one rank's; "
        f"samples {tr['samples']}; the Coach's phases "
        f"{json.dumps(tr['times'])}; arenas {json.dumps(tr['arenas'])}; "
        f"the ranks' run {tr['wall']:.1f} s; card: {smi}")
    log(f"phase two ranks: {time.perf_counter() - t0:.1f} s")
    numbers = dict(
        nccl=dict((k, nc[k]) for k in ("backend", "max_err", "allreduce_ms",
                                       "nccl_kernels", "params")),
        gloo_allreduce_ms=[o["allreduce_ms"] for o in r0],
        sims_per_s=dict(two_ranks=tr["sims_per_s_2rank"],
                        one_rank=tr["sims_per_s_1rank"]),
        peak_bytes=[o["peak_bytes"] for o in r0],
        build=[o.get("build") for o in r0],
        coach_launches=[o["coach"]["launches"] for o in r0],
        coach_times=tr["times"], coach_wall=[o["coach"]["wall"] for o in r0],
        ranks_wall=tr["wall"])
    return records, numbers


# --------------------------------------------------------------------------
# The GUI (33)
# --------------------------------------------------------------------------

#: The GUI's connect4 game: the opponent's simulations a move (the
#: preset's), and the human's columns.
GUI_SIMS = 200
GUI_HUMAN_COLUMNS = (3, 3, 2)
#: Simulations of the GUI evaluator's search (its max_sims: N = 403 rows)
#: at whose snapshots both batch-major kernels are held; the last is timed.
GUI_EVAL_SIMS = 400
GUI_EVAL_SNAPSHOTS = (50, 399)
#: The train panel's session: the connect4 preset (its network, the int8
#: default) cut in depth only: one iteration (a warmup one), 768 games
#: 256 at a time, arenas of 32 games at 25 simulations.
GUI_TRAIN_CUTS = dict(numIters=1, process_batch_size=256,
                      gamesPerIteration=768, arenaCompareBaseline=32,
                      arenaCompare=32, numMCTSSims=25)
#: Seconds a paused session is watched; seconds a stopped one may take to
#: leave ``learn``; seconds the whole session may take.
GUI_PAUSE_S = 2.0
GUI_STOP_S = 30.0
GUI_TRAIN_S = 300.0


def _gui_api(base: str, path: str, body=None):
    """(JSON reply, HTTP status) of one request to the GUI server."""
    req = urllib.request.Request(
        base + path,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read()), r.status
    except urllib.error.HTTPError as e:
        return json.loads(e.read()), e.code


def _gui_post(base: str, path: str, body: dict) -> dict:
    out, status = _gui_api(base, path, body)
    check(status == 200 and "error" not in out,
          f"GUI {path} {body}: {status} {out}")
    return out


class _AgentClock:
    """Wraps a session's opponent: its moves, simulations and seconds."""

    def __init__(self, sess, sims: int):
        self.play, self.sims = sess.opponent.play, sims
        self.moves, self.seconds = 0, 0.0
        sess.opponent.play = self

    def __call__(self, state):
        t0 = time.perf_counter()
        action = self.play(state)
        self.seconds += time.perf_counter() - t0
        self.moves += 1
        return action


def _gui_agent_legal(env, sess) -> None:
    """Every agent reply in the session's history was a valid move."""
    hist = sess.history
    for before, after in zip(hist, hist[1:]):
        a = int(after.last_action[0])
        check(bool(env.valid_moves(before)[0, a]),
              f"{sess.env_name}: the agent played the illegal action {a}")


def gui_play_phase(device, G, base: str, root: str) -> dict:
    """The GUI's play and analysis over HTTP: the page and lookups; a
    connect4 game against ``mcts:`` over a random preset-width checkpoint
    at ``GUI_SIMS``, with the evaluator; chess against rawmcts; stratego's
    placement; tictactoe hot-seat and networked. Returns the numbers, the
    sessions' agent clocks and evaluator simulations."""
    from alphazero_general_tpu_torch.players.evaluator import MCTSEvaluator

    with urllib.request.urlopen(base + "/", timeout=120) as r:
        page = r.read().decode()
    check('canvas id="board"' in page, "GUI page without its canvas")
    envs, _ = _gui_api(base, "/api/envs")
    check("connect4" in envs["envs"] and "chess" in envs["envs"],
          f"GUI envs {envs}")
    args, _ = _gui_api(base, "/api/args?env=connect4")
    check(args["args"]["numMCTSSims"] == 200
          and args["args"]["num_channels"] == 128,
          f"GUI args of connect4: {args}")

    env = get_env("connect4")
    NNetWrapper(env, preset_args("connect4", seed=SEED),
                device=device).save_checkpoint(root, "iteration-0001")
    ticks, clocks = [], []
    tick = MCTSEvaluator._tick

    def counted_tick(self, tree, first, sims, draws):
        tick(self, tree, first, sims, draws)
        ticks.append(sims)

    sync(device)
    reset_counts()
    with _Patched(MCTSEvaluator, "_tick", counted_tick), \
            _PlainCounter(OD, "descend_plain") as pd, \
            _PlainCounter(OB, "backup_plain_") as pb:
        out = _gui_post(base, "/api/new", {
            "env": "connect4", "human_seat": 0, "sims": GUI_SIMS,
            "opponent": "mcts:" + os.path.join(root, "iteration-0001")})
        gid = out["game"]
        sess = G._SESSIONS[gid]
        check(sess.state.board.device == torch.device(device)
              and sess.evaluator.device == torch.device(device),
              f"the GUI session is on {sess.state.board.device}")
        clock = _AgentClock(sess, GUI_SIMS)
        clocks.append(clock)
        for col in GUI_HUMAN_COLUMNS:
            out = _gui_post(base, "/api/move", {"game": gid,
                                                "to": [0, col]})
            check(out["player"] == 0 and not out["terminal"],
                  f"connect4 after column {col}: {out['message']}")
        _gui_agent_legal(env, sess)
        deadline = time.perf_counter() + 30
        view = out
        while view["analysis_sims"] == 0 and time.perf_counter() < deadline:
            time.sleep(0.05)
            view, _ = _gui_api(base, f"/api/state?game={gid}")
        check(view["analysis_sims"] > 0
              and 0.0 <= view["eval_for_human"] <= 1.0,
              f"the evaluator published {view['analysis_sims']} sims, "
              f"eval {view['eval_for_human']}")
        while sess.evaluator.running and time.perf_counter() < deadline:
            time.sleep(0.05)
        final = sess.evaluator.analysis
        check(not final.running and final.sims > 0,
              f"the evaluator did not finish: {final}")
        actions = [int(s.last_action[0]) for s in sess.history[1:]]
        replay = env.init(1, "cpu")
        for a in actions:
            replay = env.step(replay, torch.tensor([a], dtype=torch.int32))
        for name, x in state_items(sess.state).items():
            check(torch.equal(x.cpu(), getattr(replay, name)),
                  f"connect4 {name} != the CPU replay of {actions}")
        shadow = G.GameSession("connect4", "hotseat", 0, device="cpu")
        for a in actions:
            shadow._step(a)
        check(shadow.view()["board"] == view["board"],
              "the GUI's connect4 board != the CPU session's")
        out = _gui_post(base, "/api/undo", {"game": gid})
        check(out["player"] == 0 and out["turns"] == len(actions) - 2
              and not out["terminal"],
              f"undo: player {out['player']}, turns {out['turns']}")

        out = _gui_post(base, "/api/new", {"env": "chess", "human_seat": 0,
                                           "opponent": "rawmcts",
                                           "sims": 4})
        cid = out["game"]
        clocks.append(_AgentClock(G._SESSIONS[cid], 4))
        check(out["needs_two_clicks"] and out["board"][6][4] == "♙"
              and out["board"][0][4] == "♚", "chess: not the flipped start")
        out = _gui_post(base, "/api/move", {"game": cid, "from": [6, 4],
                                            "to": [4, 4]})
        check(out["board"][4][4] == "♙" and out["turns"] == 2
              and out["player"] == 0, f"chess e2e4: {out['message']}")
        _gui_agent_legal(get_env("chess"), G._SESSIONS[cid])

        out = _gui_post(base, "/api/new", {"env": "stratego",
                                           "human_seat": 0,
                                           "opponent": "rawmcts",
                                           "sims": 4})
        sid = out["game"]
        clocks.append(_AgentClock(G._SESSIONS[sid], 4))
        counts = dict(out["place_counts"])
        check(counts["F"] == 1 and counts["B"] == 5,
              f"stratego counts {counts}")
        out = _gui_post(base, "/api/move", {"game": sid, "to": [0, 0],
                                            "piece": "F"})
        censored = [c for row in out["board"] for c in row
                    if c and c[0] == "?"]
        check(out["board"][0][0] == "F" and dict(out["place_counts"])["F"]
              == 0 and out["turns"] == 2 and len(censored) == 1,
              f"stratego placement: {out['message']}, censored {censored}")

        out = _gui_post(base, "/api/new", {"env": "tictactoe",
                                           "opponent": "hotseat"})
        tid = out["game"]
        out = _gui_post(base, "/api/move", {"game": tid, "to": [0, 0]})
        check(out["player"] == 1 and out["turns"] == 1, "hot-seat move 1")
        out = _gui_post(base, "/api/move", {"game": tid, "to": [1, 1]})
        check(out["player"] == 0 and out["last_move"] == [1, 1],
              "hot-seat move 2")
        out = _gui_post(base, "/api/new", {"env": "tictactoe",
                                           "opponent": "human"})
        nid, tok0 = out["game"], out["token"]
        joined = _gui_post(base, "/api/join", {"game": nid})
        tok1 = joined["token"]
        out = _gui_post(base, "/api/move", {"game": nid, "to": [0, 0],
                                            "token": tok1})
        check(out["turns"] == 0 and "not your turn" in out["message"],
              "networked: seat 1 moved first")
        _gui_post(base, "/api/move", {"game": nid, "to": [0, 0],
                                      "token": tok0})
        out = _gui_post(base, "/api/move", {"game": nid, "to": [1, 1],
                                            "token": tok1})
        check(out["turns"] == 2, "networked: the seats' moves")
        for s in G._SESSIONS.values():
            s.evaluator.stop(timeout=60.0)
        sync(device)
        launches = read_counts()
    searched = sum(c.moves * c.sims for c in clocks)
    expect = dict.fromkeys(COUNTED, 0)
    if torch.device(device).type == "cuda":
        expect.update(descend_rows=searched + sum(ticks),
                      backup_rows=searched + sum(ticks))
        check(pd.calls == 0 and pb.calls == 0,
              f"GUI play: plain versions ran ({pd.calls}, {pb.calls})")
    check(launches == expect,
          f"GUI play: launches {launches} != expected {expect} "
          f"(agents {searched}, evaluator {sum(ticks)} simulations)")
    return dict(sess=sess, launches=launches, agent_sims=searched,
                evaluator_sims=sum(ticks),
                agent_ms=clock.seconds * 1e3 / clock.moves,
                agent_moves=clock.moves,
                evaluator=(final.sims, final.elapsed))


def gui_train_phase(device, G, base: str, root: str) -> dict:
    """The train panel over HTTP: a session of the connect4 preset cut as
    ``GUI_TRAIN_CUTS`` says, paused in self-play for ``GUI_PAUSE_S``
    (no finished game and no kernel launch meanwhile), resumed and run to
    its end through SELF_PLAY, TRAIN and COMPARE_BASELINE; then a second
    session stopped in self-play, which must leave ``learn`` within
    ``GUI_STOP_S``. Checks the game-minor launch counters and that no
    plain version ran."""
    dirs = dict(checkpoint=os.path.join(root, "checkpoint"),
                data=os.path.join(root, "data"),
                log_dir=os.path.join(root, "runs"))
    cuda = torch.device(device).type == "cuda"

    def status():
        return _gui_api(base, "/api/train/status")[0]

    def wait_for(cond, seconds, seen):
        deadline = time.perf_counter() + seconds
        while True:
            st = status()
            seen.append(st["state"])
            if cond(st) or time.perf_counter() > deadline:
                return st
            time.sleep(0.02)

    def moving(st):
        return st["state"] == "SELF_PLAY" and (
            read_counts()["descend"] > 0 if cuda else st["games_played"] > 0)

    out = {}
    sync(device)
    reset_counts()
    seen = []
    with _PlainCounter(OD, "descend_plain") as pd, \
            _PlainCounter(OB, "backup_plain_") as pb:
        t0 = time.perf_counter()
        _gui_post(base, "/api/train/start", {
            "env": "connect4", "overrides": dict(
                GUI_TRAIN_CUTS, run_name="gui", **dirs)})
        coach = G._TRAIN.coach
        check(coach.train_net.device == torch.device(device)
              and bool(coach.args.quant_selfplay),
              f"the panel's Coach runs on {coach.train_net.device}, "
              f"quant_selfplay={coach.args.quant_selfplay}")
        out["net"] = (coach.args.num_channels, coach.args.depth)
        st = wait_for(moving, 120, seen)
        check(moving(st), f"the panel's session did not reach self-play: "
              f"{st}")
        paused = _gui_post(base, "/api/train/pause", {})
        check(paused == {"paused": True}, f"pause: {paused}")
        time.sleep(0.5)  # the move in flight ends
        held, counts = status(), read_counts()
        time.sleep(GUI_PAUSE_S)
        st, after = status(), read_counts()
        check(st["paused"] and st["state"] == "SELF_PLAY"
              and st["games_played"] == held["games_played"]
              and after == counts,
              f"paused for {GUI_PAUSE_S} s: games {held['games_played']} -> "
              f"{st['games_played']}, launches {counts} -> {after}, state "
              f"{st['state']}")
        out["paused_at"] = dict(games=held["games_played"], launches=counts)
        check(_gui_post(base, "/api/train/pause", {}) == {"paused": False},
              "resume")
        st = wait_for(lambda s: not s["running"], GUI_TRAIN_S, seen)
        out["wall"] = time.perf_counter() - t0
        sync(device)
        launches = read_counts()
    check(not st["running"] and st["error"] is None and st["model_iter"] == 2
          and st["state"] == "STANDBY",
          f"the panel's session ended as {st}")
    check({"SELF_PLAY", "TRAIN", "COMPARE_BASELINE"} <= set(seen),
          f"the panel's states {sorted(set(seen))}")
    check(os.path.exists(os.path.join(dirs["checkpoint"], "gui",
                                      "iteration-0001.ckpt")),
          "no iteration-0001.ckpt from the panel's session")
    if cuda:
        check(launches["descend"] > 0 and launches["backup"] > 0
              and pd.calls == 0 and pb.calls == 0,
              f"the panel's launches {launches}, plain runs "
              f"({pd.calls}, {pb.calls})")
    m = _read_metrics(os.path.join(dirs["log_dir"], "gui", "metrics.jsonl"))
    out.update(launches=launches, states=sorted(set(seen)),
               times={t[5:]: m[t][1] for t in m if t.startswith("time/")},
               games=st["games_played"])

    reset_counts()
    seen = []
    _gui_post(base, "/api/train/start", {
        "env": "connect4", "overrides": dict(GUI_TRAIN_CUTS,
                                             run_name="gui_stop", **dirs)})
    st = wait_for(moving, 120, seen)
    check(moving(st), f"the second session did not reach self-play: {st}")
    t0 = time.perf_counter()
    check(_gui_post(base, "/api/train/stop", {}) == {"ok": True}, "stop")
    st = wait_for(lambda s: not s["running"], GUI_STOP_S, seen)
    out["stop_s"] = time.perf_counter() - t0
    check(not st["running"] and st["state"] == "STANDBY"
          and st["error"] is None and st["model_iter"] == 1,
          f"stopped for {GUI_STOP_S} s, the session is {st}")
    out["stop_games"] = st["games_played"]
    return out


def gui_phases(device, smi: str) -> tuple:
    """Phase 33: the port's GUI server (``gui.server.Handler``, on
    ``device``) in this process, driven over HTTP as a browser would:
    play and analysis (both batch-major kernels, from the opponents' and
    the evaluator's searches) and the train panel (both game-minor
    kernels); then both batch-major kernels bit for bit at the GUI
    evaluator's tree (B = 1, N = ``GUI_EVAL_SIMS`` + 3), timed. Returns
    their kernel records and the phase's numbers."""
    from alphazero_general_tpu_torch.gui import server as G

    t_phase = time.perf_counter()
    check(G.Handler.device == "cuda", "the GUI's default device is not cuda")
    server = ThreadingHTTPServer(("127.0.0.1", 0), G.handler_for(device))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        with tempfile.TemporaryDirectory() as root:
            t0 = time.perf_counter()
            play = gui_play_phase(device, G, base, os.path.join(root, "c4"))
            play_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            train = gui_train_phase(device, G, base,
                                    os.path.join(root, "train"))
            train_s = time.perf_counter() - t0
    finally:
        G._stop_train_at_exit()
        for s in G._SESSIONS.values():
            s.evaluator.stop(timeout=60.0)
        server.shutdown()
        server.server_close()
    sims, secs = play["evaluator"]
    log(f"  GUI play: connect4 against mcts: at {GUI_SIMS} simulations, "
        f"{play['agent_moves']} agent moves, {play['agent_ms']:.1f} ms an "
        f"agent move; the evaluator {sims} simulations in {secs:.2f} s = "
        f"{sims / secs:,.0f} sims/s; simulations through the batch-major "
        f"kernels: agents {play['agent_sims']}, evaluator "
        f"{play['evaluator_sims']}; launches {play['launches']}; "
        f"{play_s:.1f} s; card: {smi}")
    log(f"  GUI train panel: connect4 preset (ResNet {train['net'][0]} x "
        f"{train['net'][1]}) cut to {GUI_TRAIN_CUTS}: "
        f"{train['wall']:.1f} s to STANDBY, states {train['states']}, "
        f"{train['games']} games; phase timers "
        + ", ".join(f"{k} {v:.2f} s" for k, v in sorted(
            train["times"].items()))
        + f"; paused {GUI_PAUSE_S} s at {train['paused_at']['games']} "
        f"games with the launches held at {train['paused_at']['launches']}"
        f"; launches {train['launches']}; card: {smi}")
    log(f"  GUI stop: the second session left learn {train['stop_s']:.2f} s "
        f"after the stop, at {train['stop_games']} games; {train_s:.1f} s "
        f"for both sessions; card: {smi}")

    sess = play["sess"]
    ev = sess.evaluator
    t0 = time.perf_counter()
    tree = S.init_batched_trees(sess.env, sess.state, GUI_EVAL_SIMS + 2,
                                ev.spec.value_size)
    errs, timing = rows_kernel_phase(sess.env, ev.eval_fn, ev.spec, tree,
                                     GUI_EVAL_SIMS, GUI_EVAL_SNAPSHOTS,
                                     device)
    for k in ("descend_rows", "backup_rows"):
        log_timing(k, timing[k])
    log(f"  GUI evaluator's tree (B = 1, N = {GUI_EVAL_SIMS + 3}): both "
        f"batch-major kernels bit for bit, {time.perf_counter() - t0:.1f} s;"
        f" card: {smi}")
    log(f"phase GUI: {time.perf_counter() - t_phase:.1f} s")
    records = [kernel_record(f"{k}@gui_connect4_b1", k, timing[k],
                             play["launches"][k], errs[k])
               for k in ("descend_rows", "backup_rows")]
    numbers = dict(
        agent_ms=play["agent_ms"], agent_sims=GUI_SIMS,
        evaluator_sims_per_s=sims / secs, play_launches=play["launches"],
        train_wall=train["wall"], train_times=train["times"],
        train_launches=train["launches"], paused_at=train["paused_at"],
        stop_s=train["stop_s"], play_s=play_s, train_s=train_s)
    return records, numbers


def main() -> int:
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    name, device_count, smi = device_phase()
    device = "cuda:0"
    log(f"phase device: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    build_phase()
    log(f"phase build: {time.perf_counter() - t0:.1f} s")
    log(f"  a one-element fill: {launch_floor_ms(device):.4f} ms of device "
        "time per launch (the least a kernel takes)")

    records, c4_int8, c4_by_rows = connect4_phases(device, smi)
    tafl_records, tafl_int8 = tafl_phases(device, smi)
    env_records = env_phases(device, smi)
    player_records = player_phases(device, smi)
    search_records, search_layer = search_layer_phases(device, smi,
                                                       c4_by_rows)
    multi_records, multi_device = multi_device_phases(device, smi)
    gui_records, gui = gui_phases(device, smi)
    log(f"total: {time.perf_counter() - t_all:.1f} s")

    log(json.dumps({"int8_tower": {"connect4": c4_int8,
                                   "hnefatafl": tafl_int8, "card": smi}}))
    log(json.dumps({"search_layer": dict(search_layer, card=smi)}))
    log(json.dumps({"multi_device": dict(multi_device, card=smi)}))
    log(json.dumps({"gui": dict(gui, card=smi)}))
    log(smi)
    log(json.dumps({"kernels": records + tafl_records + env_records
                    + player_records + search_records + multi_records
                    + gui_records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": device_count}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--rank"]:
            rank_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
            sys.exit(0)
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
