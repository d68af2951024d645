"""Live position analysis — the port of alphazero_general_tpu/players/
evaluator.py (reference: alphazero/Evaluator.py:225-440).

A daemon thread searches the current position in ticks of
``sims_per_tick`` simulations and publishes (value, best and worst
actions, depth, simulations) under a lock after each tick. It stops at
``max_search_time`` seconds, at ``max_search_depth`` or at ``max_sims``
simulations. Without a network it evaluates uniformly (a uniform policy,
zero values; Evaluator.py:366-372). ``greedy_value`` is the crude-value
helper (Evaluator.py:405-410).

The tree is one fresh batch-major ``Tree`` of ``max_sims + 2`` rows (plus
the sink) on the evaluator's device: the network's, else ``device``
(default ``cuda``). A tick enqueues its simulations with no host sync; the
host reads the tree once a tick, in ``_publish``. On the card the CUDA
descend takes trees of at most ``ops.descend.MAX_NODES`` rows, so
``max_sims`` is at most ``MAX_NODES - 3`` there; a larger one raises
ValueError at construction.
"""

from __future__ import annotations

import atexit
import logging
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from alphazero_general_tpu_torch.mcts import search as S
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.ops.descend import MAX_NODES
from alphazero_general_tpu_torch.players.players import one_game

#: Evaluators with a live thread: stopped at exit, so that no daemon
#: thread dies inside a CUDA call while the interpreter tears down.
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _stop_live_evaluators() -> None:
    for ev in list(_LIVE):
        try:
            ev.stop(timeout=120.0)
        except Exception:
            pass


@dataclass
class Analysis:
    value: float = 0.5
    best_actions: List[int] = field(default_factory=list)
    #: visited root actions with the lowest q — the GUI's worst-move hints
    #: (reference: CustomGUI.py:463-507 best/worst move display)
    worst_actions: List[int] = field(default_factory=list)
    policy: Optional[np.ndarray] = None
    depth: int = 0
    sims: int = 0
    elapsed: float = 0.0
    running: bool = False


class MCTSEvaluator:
    """Incremental analysis on a background thread (Evaluator.py:326-402).

    No root noise, no root temperature; the tie noise of each prior
    install is drawn from a ``torch.Generator`` seeded with ``seed``, or
    taken from ``draws`` (``analyze_blocking``)."""

    def __init__(self, env, args, nn=None, max_search_time: float = 10.0,
                 max_search_depth: Optional[int] = None,
                 max_sims: int = 2000, sims_per_tick: int = 8,
                 num_best: int = 3, seed: int = 0, device=None):
        self.env = env
        self.args = args
        self.nn = nn
        self.max_search_time = max_search_time
        self.max_search_depth = max_search_depth
        self.max_sims = max_sims
        self.sims_per_tick = sims_per_tick
        self.num_best = num_best
        self.device = torch.device(
            device if device is not None else nn.device if nn else "cuda")
        self._check_rows(max_sims)
        self.spec = T.SearchSpec(
            cpuct=float(args.cpuct),
            fpu_reduction=float(args.fpu_reduction),
            min_discount=float(args.min_discount),
            add_root_noise=False,
            add_root_temp=False,
            num_players=env.NUM_PLAYERS,
            has_draw=env.HAS_DRAW,
        )
        self._value_size = env.NUM_PLAYERS + int(env.HAS_DRAW)
        self._generator = torch.Generator(self.device).manual_seed(seed)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._analysis = Analysis()
        self.eval_fn = (nn.process if nn is not None else
                        S.uniform_eval_fn(env.ACTION_SIZE, self._value_size))

    def _check_rows(self, sims: int) -> None:
        rows = sims + 3  # max_sims + 2 node rows and the sink
        if self.device.type == "cuda" and rows > MAX_NODES:
            raise ValueError(
                f"{sims} simulations need a tree of {rows} rows; the CUDA "
                f"descend takes at most {MAX_NODES} (at most "
                f"{MAX_NODES - 3} simulations)")

    # ------------------------------------------------------------------ api
    @property
    def analysis(self) -> Analysis:
        with self._lock:
            return Analysis(**vars(self._analysis))

    @property
    def running(self) -> bool:
        """Whether the background thread is alive."""
        return self._thread is not None and self._thread.is_alive()

    def start(self, state) -> None:
        """(Re)start the analysis of ``state``; stops a running one."""
        self.stop()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, args=(state,),
                                        daemon=True)
        _LIVE.add(self)
        self._thread.start()

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def analyze_blocking(self, state, sims: Optional[int] = None,
                         draws: Optional[S.SearchDraws] = None) -> Analysis:
        """Synchronous analysis (the CLI's): up to ``sims`` simulations
        (default ``max_sims``). ``draws.tie`` [sims, 1, A] replaces the
        generator's tie-noise draws."""
        saved = self.max_sims
        if sims is not None:
            self._check_rows(sims)
            self.max_sims = sims
        try:
            self._run(state, draws)
        finally:
            self.max_sims = saved
        return self.analysis

    # ------------------------------------------------------------- internals
    def _publish(self, tree, sims_done: int, elapsed: float,
                 running: bool) -> int:
        """Read the tree once and publish it; returns the deepest walk."""
        counts_t, q_t = T.root_child_stats(tree)
        A = counts_t.shape[1]
        flat = torch.cat([counts_t[0].double(), q_t[0].double(),
                          T.root_value(tree).double(),
                          tree.max_depth.double()]).cpu().numpy()
        counts = flat[:A].astype(np.int32)
        q = flat[A:2 * A].astype(np.float32)
        value, depth = float(np.float32(flat[2 * A])), int(flat[2 * A + 1])
        order = np.argsort(-counts)
        best = [int(a) for a in order[: self.num_best] if counts[a] > 0]
        visited = counts > 0
        worst_order = np.argsort(np.where(visited, q, np.inf))
        worst = [int(a) for a in worst_order[: self.num_best]
                 if visited[a] and int(a) not in best]
        policy = counts / counts.sum() if counts.sum() else None
        with self._lock:
            self._analysis = Analysis(
                value=value, best_actions=best, worst_actions=worst,
                policy=policy, depth=depth, sims=sims_done, elapsed=elapsed,
                running=running)
        return depth

    def _run(self, state, draws: Optional[S.SearchDraws] = None) -> None:
        try:
            self._run_inner(state, draws or S.SearchDraws())
        except Exception:
            # A stop() may interrupt a tick at teardown; a failure with no
            # stop asked for is raised.
            if not self._stop.is_set():
                raise
            logging.getLogger(__name__).debug(
                "evaluator tick failed after stop()", exc_info=True)

    def _tick(self, tree, first: int, sims: int, draws) -> None:
        """``sims`` simulations, the first of the whole search (``first``
        == 0) with the root adjustment; no host sync."""
        for k in range(first, first + sims):
            _, tie = draws.at(k)
            S.simulate_step(self.env, tree, self.spec, self.eval_fn,
                            root_adjust=k == 0, generator=self._generator,
                            tie=tie)

    def _run_inner(self, state, draws: S.SearchDraws) -> None:
        env = self.env
        state = one_game(state, self.device)
        if bool(env.terminated(state)[0]):
            with self._lock:
                self._analysis = Analysis(running=False)
            return
        tree = S.init_batched_trees(env, state, self.max_sims + 2,
                                    self._value_size)
        start = time.time()
        sims_done = 0
        while (not self._stop.is_set() and sims_done < self.max_sims
               and time.time() - start < self.max_search_time):
            # The last tick stops at max_sims: the tree has no row for more.
            sims = min(self.sims_per_tick, self.max_sims - sims_done)
            self._tick(tree, sims_done, sims, draws)
            sims_done += sims
            depth = self._publish(tree, sims_done, time.time() - start,
                                  running=True)
            if (self.max_search_depth is not None
                    and depth >= self.max_search_depth):
                break
        self._publish(tree, sims_done, time.time() - start, running=False)


def greedy_value(env, state) -> float:
    """Heuristic evaluation via ``env.crude_value`` of the one game of
    ``state`` (Evaluator.py:405-410)."""
    return float(env.crude_value(one_game(state))[0])
