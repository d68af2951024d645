"""Lockstep self-play moves — the port of
alphazero_general_tpu/selfplay/selfplay.py (``SelfPlayConfig``,
``init_selfplay``, ``_update_temps``, ``move_step``, ``make_move_fns``;
reference: alphazero/SelfPlayAgent.pyx:13-203).

One move for a batch of B games is: a search tree per game, ``sims``
simulations, the visit-count policy at temperature 1 (the training target)
and at each game's temperature (the sampling policy), a Gumbel-max sample,
the env step, and auto-reset of finished games. The host chooses fast or
full search per move (``make_move_fns``), as the JAX package's production
runners do; the warmup runner searches ``sims_warmup`` simulations with a
uniform policy and uniform values instead of the network.

The search tree is fresh every move (a game-minor ``TreeT``), or, with
``reuse_tree``, carried across moves in a batch-major ``Tree``: re-rooted
at the action played (the reference's update_root, MCTS.pyx:185-195) and
restarted where the game ended, where the kept subtree leaves no room for
another full search, or where it passed ``reset_threshold`` rows. With
``leaf_batch`` > 1 the fresh searches run multi-leaf rounds
(``mcts.search``); searches on carried trees run one leaf, as in the JAX
package.

``play_chunk`` runs several moves with the fast/full coin drawn on the
device per move, the JAX package's scanned chunk as a loop on the host.

Under a process group each rank plays its own games: a carry of
``B / W`` games and a ``parallel.GameShard`` over the global batch as the
generator, whose draws are the global batch's, cut to the rank's games.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from alphazero_general_tpu_torch.envs.core import state_items
from alphazero_general_tpu_torch.mcts import search as S
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts.tree_t import init_tree_t
from alphazero_general_tpu_torch.parallel.mesh import GameShard, draw_uniform
from alphazero_general_tpu_torch.utils.misc import (
    TEMP_MIN, TEMP_SCALE_FACTOR, const_temp_scaling, default_temp_scaling,
)

#: Action-space size from which move records ship the policy as exact
#: top-k values and ids (selfplay.py:40; see MoveRecord.pi).
SPARSE_PI_MIN_ACTIONS = 512


class SelfPlayConfig(NamedTuple):
    """Self-play hyperparameters (the ported subset of the JAX config)."""

    sims_full: int = 100  # numMCTSSims
    sims_fast: int = 20  # numFastSims
    sims_warmup: int = 5  # numWarmupSims
    prob_fast: float = 0.75  # probFastSim (the Coach draws the coin)
    start_temp: float = 1.0  # startTemp
    const_temp: bool = False  # temp_scaling_fn is const_temp_scaling
    tree_capacity: int = 0  # max_tree_nodes; 0 → sized from the sims
    # Carry each game's search tree across moves, re-rooted at the action
    # played (reuse_tree; the reference's update_root, MCTS.pyx:185-195).
    reuse_tree: bool = False
    # With tree reuse: restart a game's tree once it holds more than this
    # many nodes (mctsResetThreshold, SelfPlayAgent.pyx:172-174); 0 = only
    # the restart when a full search would not fit.
    reset_threshold: int = 0
    # Leaves evaluated per network call in a fresh search (multi-leaf
    # rounds, mcts.search); carried trees run one.
    leaf_batch: int = 1
    spec: T.SearchSpec = T.SearchSpec()

    @property
    def capacity(self) -> int:
        """Node rows of a tree: one per simulation of the largest search,
        plus one spare as in the JAX package (selfplay.py:76-81); with
        reuse, room for a carried subtree as large as a full search too."""
        if self.tree_capacity:
            return self.tree_capacity
        base = max(self.sims_full, self.sims_warmup)
        return 2 * base + 2 if self.reuse_tree else base + 2

    @classmethod
    def from_args(cls, args, num_players: int,
                  has_draw: bool) -> "SelfPlayConfig":
        """The config the reference's knobs describe (utils/config.py), as
        the JAX package's ``from_args`` reads them (selfplay.py:84-113).
        Raises ValueError on a knob whose value the port cannot run: a
        ``temp_scaling_fn`` other than the default schedule and the
        constant one."""
        temp_fn = args.get("temp_scaling_fn", default_temp_scaling)
        if temp_fn not in (default_temp_scaling, const_temp_scaling):
            raise ValueError(f"temp_scaling_fn {temp_fn!r} is not ported "
                             "yet (only utils.misc.default_temp_scaling and "
                             "const_temp_scaling)")
        spec = T.SearchSpec(
            cpuct=float(args.cpuct),
            fpu_reduction=float(args.fpu_reduction),
            root_policy_temp=float(args.root_policy_temp),
            root_noise_frac=float(args.root_noise_frac),
            min_discount=float(args.min_discount),
            add_root_noise=bool(args.add_root_noise),
            add_root_temp=bool(args.add_root_temp),
            num_players=num_players,
            has_draw=has_draw,
        )
        return cls(
            sims_full=int(args.numMCTSSims),
            sims_fast=int(args.numFastSims),
            sims_warmup=int(args.numWarmupSims),
            prob_fast=float(args.probFastSim),
            start_temp=float(args.startTemp),
            const_temp=temp_fn is const_temp_scaling,
            tree_capacity=int(args.get("max_tree_nodes", 0)),
            reuse_tree=bool(args.get("reuse_tree", False)),
            reset_threshold=int(args.get("mctsResetThreshold") or 0),
            leaf_batch=int(args.get("leaf_batch", 1)),
            spec=spec,
        )


@dataclasses.dataclass
class SelfPlayState:
    """Device-resident carry of a batch of lockstep games."""

    env_state: object  # batched env state [B, ...]
    temps: torch.Tensor  # f32[B]
    games_played: torch.Tensor  # i32 scalar: completed games so far
    move_count: torch.Tensor  # i32 scalar: move rounds so far
    #: With tree reuse, each game's search tree rooted at ``env_state``
    #: (a batch-major Tree, searched in place by the next move); else None.
    trees: object = None


@dataclasses.dataclass
class MoveRecord:
    """What one move step emits, per game [B, ...]. The runners of
    ``make_move_fns`` slim it: obs and pi are None after a fast move and
    float16 otherwise."""

    obs: torch.Tensor  # f32[B, C, H, W] observation before the move
    #: f32[B, A] visit-count policy at temperature 1 — or, in the runners'
    #: records of action spaces of SPARSE_PI_MIN_ACTIONS and more, its
    #: top-k values [B, k] with ``pi_idx`` set: a search of ``sims``
    #: simulations visits at most sims - 1 root children, so k = sims + 1
    #: keeps every nonzero and the densified row is exact.
    pi: torch.Tensor
    player: torch.Tensor  # i32[B] player who moved
    action: torch.Tensor  # i32[B]
    win_state: torch.Tensor  # f32[B, V] result after the move (0s if running)
    done: torch.Tensor  # bool[B] the game ended on this move
    fast: bool  # batch-global fast-search flag (the sample is discarded)
    root_visits: torch.Tensor  # i32[B] visits of the search root
    #: With tree reuse, bool[B]: the game's next tree is a fresh one (the
    #: game ended, a full search would not fit, or the reset threshold was
    #: passed) instead of its re-rooted subtree; None without reuse.
    tree_reset: torch.Tensor = None
    pi_idx: torch.Tensor = None  # i32[B, k] action ids of sparse ``pi``


def init_selfplay(env, batch_size: int, start_temp: float = 1.0,
                  device="cuda", cfg: SelfPlayConfig = None) -> SelfPlayState:
    """Fresh games; with ``cfg.reuse_tree``, their fresh search trees too
    (selfplay.py:147-160)."""
    states = env.init(batch_size, device)
    trees = None
    if cfg is not None and cfg.reuse_tree:
        trees = T.init_tree(env, states, cfg.capacity, cfg.spec.value_size)
    return SelfPlayState(
        env_state=states,
        temps=torch.full((batch_size,), start_temp, dtype=torch.float32,
                         device=device),
        games_played=torch.zeros((), dtype=torch.int32, device=device),
        move_count=torch.zeros((), dtype=torch.int32, device=device),
        trees=trees,
    )


class MoveDraws(NamedTuple):
    """The random draws of one move, given instead of drawn from a
    generator (tests pass the JAX package's): ``gumbel`` [B, A], the noise
    added to the sampling logits, and the search's draws."""

    gumbel: torch.Tensor
    search: Optional[S.SearchDraws] = None


def _update_temps(cfg: SelfPlayConfig, temps, turns, max_turns: int):
    """default_temp_scaling (utils.py:19-27): halve the temperature, down to
    TEMP_MIN, every ``TEMP_SCALE_FACTOR * max_turns`` turns; with
    ``cfg.const_temp``, leave it."""
    if cfg.const_temp:
        return temps
    period = max(int(TEMP_SCALE_FACTOR * max_turns), 1)
    hit = (turns + 1) % period == 0
    return torch.where(hit, torch.clamp(temps / 2.0, min=TEMP_MIN), temps)


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u uniform in [tiny, 1) — the
    noise ``jax.random.categorical`` adds to the logits before its argmax.
    ``generator`` may be a ``parallel.GameShard``."""
    u = draw_uniform(shape, generator, device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def move_step(env, cfg: SelfPlayConfig, eval_fn, carry: SelfPlayState,
              sims: int, fast: bool = False, generator=None, gumbel=None,
              search_draws: Optional[S.SearchDraws] = None,
              warmup: bool = False):
    """One move for every game of the batch; returns (carry, MoveRecord).

    ``sims`` simulations run on a fresh tree sized to them (at most
    ``cfg.capacity`` rows), or with ``cfg.reuse_tree`` on the carried trees
    ``carry.trees``, which the search updates in place. With ``warmup`` the
    search runs ``cfg.sims_warmup`` simulations of the uniform evaluation
    with uniform values instead of ``eval_fn`` (SelfPlayAgent.pyx:48-52).
    A fresh tree's search, fast, full or warmup, runs ``cfg.leaf_batch``
    leaves a network call (selfplay.py:205-227). Random draws: ``gumbel``
    [B, A] is the noise added to the sampling logits, ``search_draws`` the
    search's; both come from ``generator`` where not given.
    """
    if warmup:
        eval_fn = S.uniform_eval_fn(env.ACTION_SIZE, cfg.spec.value_size,
                                    uniform_value=True)
        sims = cfg.sims_warmup
    states = carry.env_state
    B = carry.temps.shape[0]
    dev = carry.temps.device
    if cfg.reuse_tree:
        if carry.trees is None:
            raise ValueError("reuse_tree carries trees across moves: start "
                             "from init_selfplay(..., cfg=cfg)")
        tree = S.search(env, carry.trees, cfg.spec, eval_fn, sims,
                        generator=generator, fresh_tree=False,
                        draws=search_draws)
        root_visits = tree.n[:, 0].clone()
    else:
        cap = min(cfg.capacity, sims + 2)
        tree = init_tree_t(env, states, cap, cfg.spec.value_size)
        S.search(env, tree, cfg.spec, eval_fn, sims, generator=generator,
                 draws=search_draws, leaf_batch=cfg.leaf_batch)
        root_visits = tree.n[0].clone()

    # Temperature update before sampling (SelfPlayAgent.pyx:156-158).
    temps = _update_temps(cfg, carry.temps, states.turns, env.MAX_TURNS)
    visits = T.counts(tree)
    pi_full = T.probs(visits, 1.0)
    pi_temp = T.probs(visits, temps)
    logits = torch.log(torch.clamp(pi_temp, min=1e-30))
    if gumbel is None:
        if generator is None:
            raise ValueError("move_step needs gumbel draws or a generator")
        gumbel = gumbel_noise(logits.shape, generator, dev)
    action = (gumbel + logits).argmax(dim=-1).to(torch.int32)

    obs = env.observation(states)
    new_states = env.step(states, action)
    win = env.win_state(new_states)
    done = (win > 0).any(dim=-1)

    # Auto-reset finished games (SelfPlayAgent.pyx:197-200).
    fresh = state_items(env.init(B, dev))

    def select(name, x):
        d = done.reshape((B,) + (1,) * (x.dim() - 1))
        return torch.where(d, fresh[name], x)

    next_states = env.State(**{
        name: select(name, x) for name, x in state_items(new_states).items()})
    temps = torch.where(done, cfg.start_temp, temps)

    next_trees = restart = None
    if cfg.reuse_tree:
        # Re-root at the action played (selfplay.py:255-275); a game whose
        # game ended, or whose subtree leaves no room for a full search,
        # restarts from a fresh tree.
        rerooted = T.reroot(env, tree, action)
        restart = done | (rerooted.next_free
                          + max(cfg.sims_full, cfg.sims_warmup) + 1
                          > cfg.capacity)
        if cfg.reset_threshold > 0:
            restart = restart | (rerooted.next_free > cfg.reset_threshold)
        fresh_trees = T.init_tree(env, next_states, cfg.capacity,
                                  cfg.spec.value_size)
        next_trees = T.select_games(restart, fresh_trees, rerooted)

    carry = SelfPlayState(
        env_state=next_states,
        temps=temps,
        games_played=carry.games_played + done.sum().to(torch.int32),
        move_count=carry.move_count + 1,
        trees=next_trees,
    )
    record = MoveRecord(obs=obs, pi=pi_full, player=states.player,
                        action=action, win_state=win, done=done, fast=fast,
                        root_visits=root_visits, tree_reset=restart)
    return carry, record


def play_chunk(env, cfg: SelfPlayConfig, eval_fn, carry: SelfPlayState,
               num_moves: int, generator=None, warmup: bool = False,
               draws=None):
    """``num_moves`` moves (JAX selfplay.py:291-299, whose scan becomes a
    loop on the host); returns (carry, records) with every MoveRecord
    field stacked [K, B, ...] and ``fast`` a bool[K].

    Each non-warmup move searches ``cfg.sims_fast`` simulations where its
    coin falls under ``cfg.prob_fast``, else ``cfg.sims_full``
    (selfplay.py:208-220); the coin is a uniform draw of ``generator``,
    read by the host (one wait a move). ``draws(k, valids) -> (fast,
    MoveDraws)``, where given, supplies move k's coin and draws instead
    (tests pass the JAX package's). The records are the unslimmed ones of
    ``move_step``: obs and pi of every move, in float32."""
    recs = []
    for k in range(num_moves):
        d = None
        if draws is not None:
            fast, d = draws(k, env.valid_moves(carry.env_state))
        elif warmup:
            fast = False
        else:
            gen = generator.generator if isinstance(generator, GameShard) \
                else generator
            coin = torch.rand((), generator=gen, device=carry.temps.device)
            fast = bool(coin < cfg.prob_fast)
        sims = cfg.sims_warmup if warmup else (
            cfg.sims_fast if fast else cfg.sims_full)
        carry, rec = move_step(
            env, cfg, eval_fn, carry, sims, fast=fast, generator=generator,
            gumbel=None if d is None else d.gumbel,
            search_draws=None if d is None else d.search, warmup=warmup)
        recs.append(rec)
    fields = {}
    for f in dataclasses.fields(MoveRecord):
        xs = [getattr(r, f.name) for r in recs]
        if f.name == "fast":
            fields[f.name] = torch.tensor(xs, dtype=torch.bool)
        elif xs[0] is None:
            fields[f.name] = None
        else:
            fields[f.name] = torch.stack(xs)
    return carry, MoveRecord(**fields)


def make_play_chunk_fn(env, cfg: SelfPlayConfig, apply_fn, num_moves: int,
                       warmup: bool = False):
    """A chunk runner over a model (JAX selfplay.py:360-377):
    ``apply_fn(obs) -> (log_pi, log_v)``; returns ``run(carry,
    generator=None, draws=None) -> (carry, records)`` of
    :func:`play_chunk`. The runner reads ``apply_fn``'s weights at each
    call, so loads and gating swaps need no new runner."""

    def net_eval(obs):
        logp, logv = apply_fn(obs)
        return torch.exp(logp), torch.exp(logv)

    @torch.inference_mode()
    def run(carry, generator=None, draws=None):
        return play_chunk(env, cfg, net_eval, carry, num_moves,
                          generator=generator, warmup=warmup, draws=draws)

    return run


def make_move_fns(env, cfg: SelfPlayConfig, apply_fn):
    """Production move runners with the fast/full choice made by the caller
    (the JAX package's ``make_move_fns``, selfplay.py:301-357).

    ``apply_fn(obs) -> (log_pi, log_v)``, e.g. the ResNet module. Returns
    ``{"fast", "full", "warmup"}`` → ``fn(carry, generator=None,
    gumbel=None, search_draws=None) -> (carry, MoveRecord)``; with
    ``cfg.reuse_tree`` the carry holds the trees (``init_selfplay(...,
    cfg=cfg)``).

    The records are slimmed as the JAX package's are: the fast runner
    returns obs and pi as None (finalize drops fast samples), the others
    float16 obs and pi (board planes are exact in float16; policy entries
    round by at most 2^-11 of their value). From ``SPARSE_PI_MIN_ACTIONS``
    actions on, pi is the top-(sims + 1) values in float16 and ``pi_idx``
    their int32 action ids (selfplay.py:329-340): :func:`densify_pi`
    rebuilds the dense row exactly. Which ids carry the zeros among the k
    may differ from JAX's ``top_k`` where values tie; the dense rows do
    not.
    """
    sparse = env.ACTION_SIZE >= SPARSE_PI_MIN_ACTIONS
    if sparse and cfg.reuse_tree:
        # A carried root holds more visits than one search's, and so may
        # have more than sims + 1 children with visits.
        raise ValueError(
            f"reuse_tree with an action space of {env.ACTION_SIZE} >= "
            f"{SPARSE_PI_MIN_ACTIONS}: the top-(sims + 1) policy records "
            "are exact only on fresh trees; not ported yet")

    def net_eval(obs):
        logp, logv = apply_fn(obs)
        return torch.exp(logp), torch.exp(logv)

    def build(sims, fast, warmup):
        @torch.inference_mode()
        def run(carry, generator=None, gumbel=None, search_draws=None):
            carry, rec = move_step(env, cfg, net_eval, carry, sims,
                                   fast=fast, generator=generator,
                                   gumbel=gumbel, search_draws=search_draws,
                                   warmup=warmup)
            if fast:
                rec.obs = rec.pi = None
                return carry, rec
            rec.obs = rec.obs.to(torch.float16)
            if sparse:
                k = min(env.ACTION_SIZE, sims + 1)
                vals, idx = torch.topk(rec.pi, k, dim=-1)
                rec.pi, rec.pi_idx = vals.to(torch.float16), \
                    idx.to(torch.int32)
            else:
                rec.pi = rec.pi.to(torch.float16)
            return carry, rec

        return run

    return {"fast": build(cfg.sims_fast, True, False),
            "full": build(cfg.sims_full, False, False),
            "warmup": build(cfg.sims_warmup, False, True)}


def densify_pi(vals: np.ndarray, idx: np.ndarray,
               action_size: int) -> np.ndarray:
    """Dense float16 policy rows [B, A] of a sparse record: ``vals`` at
    ``idx`` (both [B, k]), zeros elsewhere (the JAX Coach's densify,
    coach.py:389-399)."""
    dense = np.zeros((vals.shape[0], action_size), np.float16)
    np.put_along_axis(dense, idx.astype(np.int64), vals, axis=1)
    return dense
