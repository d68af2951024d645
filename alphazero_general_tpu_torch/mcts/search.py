"""Batched search loops — the port of alphazero_general_tpu/mcts/search.py
(``init_batched_trees`` :26, ``search`` :347, its fresh-tree game-minor
path ``_search_t`` :288 with ``_simulate_step_t`` :209, the multi-leaf
rounds of ``_round_step_t`` :243 and the growing arena of
``_segment_plan`` :167, its general path ``simulate_step`` :83-164,
``uniform_eval_fn`` :428 and ``raw_search`` :447).

One simulation for every game is: the descent kernel, the leaf's allocation
and expansion, ONE batched network call, the prior install, and the backup
kernel. Two paths, as in the JAX package:

* fresh trees (a ``TreeT``): simulation k writes row k of every game;
* carried trees (a batch-major ``Tree``, self-play with tree reuse): each
  game allocates at its own ``next_free``. A fresh batch-major ``Tree``
  (the players' and the evaluator's, one game) runs the same path.

A fresh search runs its simulations in segments on growing leading-row
slices of the tree (``_segment_plan``), which changes no row below a
slice's sink; a fresh ``TreeT`` search may instead run multi-leaf rounds
(``leaf_batch`` > 1): several walks to one network call.

The loop over simulations runs on the host and never waits for the device:
nothing in it reads a tensor back. Each call and each stage of a
simulation runs in a span of ``utils.trace`` (``search``,
``search.descend``, ``search.expand``, ``search.network``,
``search.install``, ``search.backup``), which does nothing unless tracing
is on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts import tree_t as TT
from alphazero_general_tpu_torch.mcts.tree import SearchSpec
from alphazero_general_tpu_torch.ops.backup import backup_batched, \
    backup_batched_t
from alphazero_general_tpu_torch.ops.descend import descend_batched, \
    descend_batched_t
from alphazero_general_tpu_torch.utils import trace

#: Maps observations [B, C, H, W] to (policy [B, A], value [B, V]), both as
#: probabilities (NNetWrapper.py:225-232).
EvalFn = Callable[[torch.Tensor], tuple]


@dataclasses.dataclass
class SearchDraws:
    """The random draws of one search, given instead of drawn from a
    generator (tests pass the JAX package's): ``tie`` [sims, B, A], the
    uniform draws behind simulation k's tie noise; ``gammas`` [B, A], the
    Gamma draws behind the root's Dirichlet noise (first simulation). A
    field left None is drawn from the generator where it is needed."""

    tie: Optional[torch.Tensor] = None
    gammas: Optional[torch.Tensor] = None

    def at(self, k: int):
        """(gammas, tie) of simulation ``k``."""
        return (self.gammas if k == 0 else None,
                None if self.tie is None else self.tie[k])


def _leaf_step_t(env, tt, spec, eval_fn, root_adjust: bool, slot: int,
                 expand_root_only: bool, generator, gammas=None, tie=None):
    """Everything of one simulation before the backup: walk, expand,
    evaluate, install the prior. Returns the terminal-resolved values."""
    if expand_root_only:
        with trace.span("search.expand"):
            obs, leaf_e, leaf_valids = TT.expand_root_t(env, tt)
    else:
        with trace.span("search.descend"):
            walk = descend_batched_t(tt, spec)
        with trace.span("search.expand"):
            obs, leaf_e, leaf_valids = TT.apply_walk_observe_t(
                env, tt, *walk, slot)
    with trace.span("search.network"):
        pi, value = eval_fn(obs)
    with trace.span("search.install"):
        # Terminal leaves back up their stored result (MCTS.pyx:234-235).
        is_term = (leaf_e > 0).any(dim=-1, keepdim=True)
        values = torch.where(is_term, leaf_e, value.to(torch.float32))
        TT.install_prior_t(tt, pi.to(torch.float32), spec, root_adjust,
                           slot, leaf_valids, gammas=gammas, tie=tie,
                           generator=generator)
    return values


def _simulate_step_t(env, tt, spec, eval_fn, root_adjust: bool, slot: int,
                     expand_root_only: bool = False, generator=None,
                     gammas=None, tie=None) -> None:
    """One simulation for every game of ``tt``, in place."""
    values = _leaf_step_t(env, tt, spec, eval_fn, root_adjust, slot,
                          expand_root_only, generator, gammas, tie)
    with trace.span("search.backup"):
        backup_batched_t(tt, values, spec)


def _segment_plan(sims: int, rows: int, min_nodes: int = 32):
    """The growing arena of a fresh search of ``sims`` simulations on trees
    of ``rows`` rows (search.py:167-193): [(n, lo, hi)], simulations k in
    [lo, hi) run on the first n rows, n doubling from ``min_nodes``.
    Simulation k writes row k and walks the rows below it, and hi <= n - 1
    keeps every write below the slice's sink (row n - 1), so the segments
    give the result of one flat loop while each walk and backup reads O(n)
    rows instead of O(rows). One segment, [(rows, 1, sims)], is the flat
    loop. Simulation 0, the root's expansion, runs before the plan."""
    segs = []
    lo = 1
    n = min(min_nodes, rows)
    while lo < sims:
        if n >= rows:
            segs.append((rows, lo, sims))
            break
        hi = min(sims, n - 1)
        if hi > lo:
            segs.append((n, lo, hi))
            lo = hi
        n *= 2
    return segs


def _round_step_t(env, tt, spec, eval_fn, slots, generator, draws):
    """One multi-leaf round on a fresh ``tt`` (search.py:243-285): a walk
    for each row of ``slots`` (K of them), each allocating that row; ONE
    network call over the K·B stacked leaf observations; then, in walk
    order, each walk's prior install (at its row, no root adjustment) and
    backup.

    Round-mates do not see each other's values. A walk stops at a pending
    child (allocated by an earlier walk of the round, n == 0, q == 0), and
    its leaf's observation is evaluated again: the statistics backed up
    are those of two sequential simulations that reach the same node. Each
    walk overwrites the tree's ``leaf`` and ``depth``, so each walk's are
    kept and restored before its install and backup; ``max_depth``
    accumulates over the round's walks, as in the JAX package."""
    B = tt.leaf.shape[0]
    walks = []
    for slot in slots:
        with trace.span("search.descend"):
            walk = descend_batched_t(tt, spec)
        with trace.span("search.expand"):
            obs, leaf_e, valid = TT.apply_walk_observe_t(
                env, tt, *walk, slot, multi_leaf=True)
        walks.append((obs, leaf_e, valid, tt.leaf.clone(), tt.depth.clone()))
    with trace.span("search.network"):
        pi, value = eval_fn(torch.cat([w[0] for w in walks]))
    with trace.span("search.install"):
        pi, value = pi.to(torch.float32), value.to(torch.float32)
    for i, (slot, (_, leaf_e, valid, leaf, depth)) in enumerate(
            zip(slots, walks)):
        games = slice(i * B, (i + 1) * B)
        with trace.span("search.install"):
            is_term = (leaf_e > 0).any(dim=-1, keepdim=True)
            values = torch.where(is_term, leaf_e, value[games])
            tt.leaf.copy_(leaf)
            tt.depth.copy_(depth)
            TT.install_prior_t(tt, pi[games], spec, False, slot, valid,
                               tie=draws.at(slot)[1], generator=generator)
        with trace.span("search.backup"):
            backup_batched_t(tt, values, spec)


def _search_t(env, tt, spec, eval_fn, sims: int, generator, draws,
              leaf_batch: int = 1):
    """Fresh-tree search: simulation k writes row k of every game. With
    ``leaf_batch`` K > 1, simulations 1.. run in rounds of K
    (``_round_step_t``) and the (sims - 1) % K left over run singly, all on
    the whole tree (search.py:318-334); else in the segments of
    ``_segment_plan``, each on views of the tree's leading rows (search.py
    :336-344). Either way simulation k keeps row k and the draws
    ``draws.at(k)``."""
    gammas, tie = draws.at(0)
    _simulate_step_t(env, tt, spec, eval_fn, root_adjust=True, slot=0,
                     expand_root_only=True, generator=generator,
                     gammas=gammas, tie=tie)
    if leaf_batch > 1:
        rounds = (sims - 1) // leaf_batch
        for r in range(rounds):
            first = 1 + r * leaf_batch
            _round_step_t(env, tt, spec, eval_fn,
                          range(first, first + leaf_batch), generator, draws)
        segments = [(tt.parent.shape[0], 1 + rounds * leaf_batch, sims)]
    else:
        segments = _segment_plan(sims, tt.parent.shape[0])
    for n, lo, hi in segments:
        part = TT.slice_rows_t(tt, n) if n < tt.parent.shape[0] else tt
        for slot in range(lo, hi):
            _simulate_step_t(env, part, spec, eval_fn, root_adjust=False,
                             slot=slot, generator=generator,
                             tie=draws.at(slot)[1])
    return tt


def _leaf_step(env, tree, spec, eval_fn, root_adjust: bool, generator,
               gammas=None, tie=None):
    """Everything of one simulation on a batch-major ``tree`` before the
    backup: walk, allocate and expand, evaluate, install the prior. Returns
    the terminal-resolved values."""
    with trace.span("search.descend"):
        walk = descend_batched(tree, spec)
    with trace.span("search.expand"):
        T.apply_walk(env, tree, *walk)
        obs = T.leaf_observation(env, tree)
    with trace.span("search.network"):
        pi, value = eval_fn(obs)
    with trace.span("search.install"):
        values = T.resolve_value(tree, value.to(torch.float32))
        T.install_prior(tree, pi.to(torch.float32), spec, root_adjust,
                        gammas=gammas, tie=tie, generator=generator)
    return values


def simulate_step(env, tree, spec, eval_fn, root_adjust: bool,
                  generator=None, gammas=None, tie=None) -> None:
    """One simulation for every game of a batch-major ``tree``, in place,
    each game writing at its own ``next_free`` (search.py:83-164 with
    ``uniform_slot=None``, ``expand_root_only=False``)."""
    values = _leaf_step(env, tree, spec, eval_fn, root_adjust, generator,
                        gammas, tie)
    with trace.span("search.backup"):
        backup_batched(tree, values, spec)


def _count_work(sims: int, games: int) -> None:
    """Count a search's work at its entry: its batch simulations and the
    rows they forward (a round of K walks forwards K·B rows for K
    simulations)."""
    trace.count("search.simulations", sims)
    trace.count("network.rows", sims * games)


def search(env, tree, spec: SearchSpec, eval_fn: EvalFn, sims: int,
           generator=None, fresh_tree: bool = True,
           draws: Optional[SearchDraws] = None, leaf_batch: int = 1):
    """Run ``sims`` simulations (MCTS.pyx:165-173) and return the trees,
    updated in place.

    ``fresh_tree=True`` takes trees never searched: a game-minor ``TreeT``,
    whose simulation k writes row k of every game, or a batch-major
    ``Tree`` (the players' trees), whose games each allocate at their own
    ``next_free`` as the JAX package's batch-major fresh search does
    (search.py:389-415). Both run in the segments of ``_segment_plan``,
    with the result of one flat loop (the batch-major tree's sink row
    aside). ``fresh_tree=False`` takes a batch-major ``Tree`` carried
    across moves, as self-play with tree reuse does (search.py:417-425),
    in one flat loop. A ``TreeT`` with ``fresh_tree=False`` raises.

    ``leaf_batch`` K > 1 runs multi-leaf rounds, K walks to one network
    call of K·B observations (``_round_step_t``), a departure from the
    reference's one leaf a step, on a fresh ``TreeT`` (self-play's fresh
    searches), with no segments; a ``Tree`` with K > 1 raises. The JAX
    package runs rounds on its game-minor kernel path only, which on a TPU
    takes B % 128 == 0 and N <= 2048 trees (search.py:51-57, every preset
    meets it) and on the CPU only ``walk_impl="pallas_interpret"``; its
    other paths run one leaf whatever K is. Carried trees, the arenas and
    the players run one leaf, as there.

    Only the first simulation can have the root as its leaf, so only it
    takes the root temperature and noise (MCTS.pyx:247-256). Random draws
    (root Dirichlet noise, tie noise) come from ``draws`` where given, else
    from ``generator``; a spec with ``add_root_noise=False`` and
    ``tie_noise=0`` draws nothing. Simulation k takes ``draws.at(k)``,
    whether it runs alone, in a segment or in a round.
    """
    with trace.span("search"):
        return _search(env, tree, spec, eval_fn, sims, generator,
                       fresh_tree, draws or SearchDraws(), leaf_batch)


def _search(env, tree, spec, eval_fn, sims, generator, fresh_tree, draws,
            leaf_batch):
    """``search`` inside its span, with its draws."""
    if leaf_batch < 1:
        raise ValueError(f"leaf_batch must be >= 1, got {leaf_batch}")
    if isinstance(tree, TT.TreeT):
        if not fresh_tree:
            raise TypeError("a search on carried trees takes a batch-major "
                            "Tree, got TreeT")
        if not 1 <= sims <= tree.capacity:
            raise ValueError(f"sims must be in [1, {tree.capacity}] (the "
                             f"tree's node rows), got {sims}")
        _count_work(sims, tree.next_free.shape[0])
        return _search_t(env, tree, spec, eval_fn, sims, generator, draws,
                         leaf_batch)
    if not isinstance(tree, T.Tree):
        raise TypeError(f"search takes a TreeT or a Tree, got "
                        f"{type(tree).__name__}")
    if leaf_batch != 1:
        raise ValueError(f"leaf_batch {leaf_batch}: multi-leaf rounds run "
                         "on a fresh TreeT; a batch-major Tree runs one leaf")
    # One read of the allocation fronts per search: every simulation
    # allocates at most one row per game, which must not reach the sink.
    front = int(tree.next_free.max())
    if fresh_tree:
        if front != 1:
            raise ValueError("fresh_tree=True takes trees never searched; "
                             "pass fresh_tree=False for carried trees")
        room = tree.capacity  # the first simulation allocates no row
    else:
        room = tree.capacity - front
    if not 1 <= sims <= room:
        raise ValueError(f"sims must be in [1, {room}] (the free rows of the "
                         f"fullest tree), got {sims}")
    _count_work(sims, tree.next_free.shape[0])
    rows = tree.parent.shape[1]
    segments = (_segment_plan(sims, rows) if fresh_tree
                else [(rows, 1, sims)])
    gammas, tie = draws.at(0)
    simulate_step(env, tree, spec, eval_fn, root_adjust=True,
                  generator=generator, gammas=gammas, tie=tie)
    for n, lo, hi in segments:
        part = T.slice_batched_rows(tree, n) if n < rows else tree
        for k in range(lo, hi):
            simulate_step(env, part, spec, eval_fn, root_adjust=False,
                          generator=generator, tie=draws.at(k)[1])
        if part is not tree:
            T.merge_batched_rows(tree, part)
    return tree


def uniform_eval_fn(action_size: int, value_size: int,
                    uniform_value: bool = False) -> EvalFn:
    """Model-free evaluation (search.py:428-444): a uniform policy, and
    zero values (``uniform_value=False``, raw search, MCTS.pyx:175-183) or
    values of 1/value_size (``True``, the warmup agent,
    SelfPlayAgent.pyx:48-52)."""
    fill = 1.0 / value_size if uniform_value else 0.0

    def eval_fn(obs):
        B = obs.shape[0]
        pi = torch.ones((B, action_size), dtype=torch.float32,
                        device=obs.device)
        value = torch.full((B, value_size), fill, dtype=torch.float32,
                           device=obs.device)
        return pi, value

    return eval_fn


def init_batched_trees(env, root_states, capacity: int,
                       value_size: int) -> T.Tree:
    """Fresh batch-major trees (search.py:26): the port's ``init_tree``."""
    return T.init_tree(env, root_states, capacity, value_size)


def raw_search(env, root_states, spec: SearchSpec, sims: int,
               generator=None, capacity: Optional[int] = None,
               draws: Optional[SearchDraws] = None) -> T.Tree:
    """Model-free search from scratch on fresh batch-major trees of
    ``capacity`` rows (default ``sims + 2``): a uniform policy and zero
    values (search.py:447, MCTS.pyx:175-183)."""
    tree = init_batched_trees(env, root_states, capacity or sims + 2,
                              spec.value_size)
    eval_fn = uniform_eval_fn(env.ACTION_SIZE, spec.value_size)
    return search(env, tree, spec, eval_fn, sims, generator, draws=draws)
