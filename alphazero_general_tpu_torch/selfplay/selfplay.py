"""Lockstep self-play moves — the port of the fresh-tree path of
alphazero_general_tpu/selfplay/selfplay.py (``SelfPlayConfig``,
``init_selfplay``, ``_update_temps``, ``move_step``, ``make_move_fns``;
reference: alphazero/SelfPlayAgent.pyx:13-203).

One move for a batch of B games is: a fresh search tree per game, ``sims``
simulations, the visit-count policy at temperature 1 (the training target)
and at each game's temperature (the sampling policy), a Gumbel-max sample,
the env step, and auto-reset of finished games. The host chooses fast or
full search per move (``make_move_fns``), as the JAX package's production
runners do.

Not ported yet: tree reuse across moves (``reuse_tree``/``reroot``),
``leaf_batch`` > 1, the scanned ``play_chunk``, and the float16 slimming of
move records.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from alphazero_general_tpu_torch.envs.core import state_items
from alphazero_general_tpu_torch.mcts import search as S
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts.tree_t import init_tree_t


# default_temp_scaling (utils.py:19-27): the temperature halves every
# TEMP_SCALE_FACTOR * max_turns turns, down to TEMP_MIN.
TEMP_SCALE_FACTOR = 0.15
TEMP_MIN = 0.2


class SelfPlayConfig(NamedTuple):
    """Self-play hyperparameters (the fresh-tree subset of the JAX config)."""

    sims_full: int = 100  # numMCTSSims
    sims_fast: int = 20  # numFastSims
    start_temp: float = 1.0  # startTemp
    spec: T.SearchSpec = T.SearchSpec()

    @property
    def capacity(self) -> int:
        """Node rows of a fresh tree: one per simulation, plus one spare as
        in the JAX package (its uniform-slot searches need sims <= rows - 1)."""
        return self.sims_full + 2

    @classmethod
    def from_args(cls, args, num_players: int,
                  has_draw: bool) -> "SelfPlayConfig":
        """The config the reference's knobs describe (utils/config.py)."""
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
            start_temp=float(args.startTemp),
            spec=spec,
        )


@dataclasses.dataclass
class SelfPlayState:
    """Device-resident carry of a batch of lockstep games."""

    env_state: object  # batched env state [B, ...]
    temps: torch.Tensor  # f32[B]
    games_played: torch.Tensor  # i32 scalar: completed games so far
    move_count: torch.Tensor  # i32 scalar: move rounds so far


@dataclasses.dataclass
class MoveRecord:
    """What one move step emits, per game [B, ...]."""

    obs: torch.Tensor  # f32[B, C, H, W] observation before the move
    pi: torch.Tensor  # f32[B, A] visit-count policy at temperature 1
    player: torch.Tensor  # i32[B] player who moved
    action: torch.Tensor  # i32[B]
    win_state: torch.Tensor  # f32[B, V] result after the move (0s if running)
    done: torch.Tensor  # bool[B] the game ended on this move
    fast: bool  # batch-global fast-search flag (the sample is discarded)
    root_visits: torch.Tensor  # i32[B] visits of the search root


def init_selfplay(env, batch_size: int, start_temp: float = 1.0,
                  device="cuda") -> SelfPlayState:
    return SelfPlayState(
        env_state=env.init(batch_size, device),
        temps=torch.full((batch_size,), start_temp, dtype=torch.float32,
                         device=device),
        games_played=torch.zeros((), dtype=torch.int32, device=device),
        move_count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _update_temps(temps, turns, max_turns: int):
    """default_temp_scaling (utils.py:19-27): halve the temperature, down to
    TEMP_MIN, every ``TEMP_SCALE_FACTOR * max_turns`` turns."""
    period = max(int(TEMP_SCALE_FACTOR * max_turns), 1)
    hit = (turns + 1) % period == 0
    return torch.where(hit, torch.clamp(temps / 2.0, min=TEMP_MIN), temps)


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u uniform in [tiny, 1) — the
    noise ``jax.random.categorical`` adds to the logits before its argmax."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def move_step(env, cfg: SelfPlayConfig, eval_fn, carry: SelfPlayState,
              sims: int, fast: bool = False, generator=None, gumbel=None):
    """One move for every game of the batch; returns (carry, MoveRecord).

    ``sims`` simulations run on a fresh tree sized to them (at most
    ``cfg.capacity`` rows). Random draws:
    ``gumbel`` [B, A] is the noise added to the sampling logits; it and the
    search's draws come from ``generator`` where not given.
    """
    states = carry.env_state
    B = carry.temps.shape[0]
    dev = carry.temps.device
    cap = min(cfg.capacity, sims + 2)
    tt = init_tree_t(env, states, cap, cfg.spec.value_size)
    S.search(env, tt, cfg.spec, eval_fn, sims, generator=generator)

    # Temperature update before sampling (SelfPlayAgent.pyx:156-158).
    temps = _update_temps(carry.temps, states.turns, env.MAX_TURNS)
    visits = T.counts(tt)
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

    carry = SelfPlayState(
        env_state=next_states,
        temps=temps,
        games_played=carry.games_played + done.sum().to(torch.int32),
        move_count=carry.move_count + 1,
    )
    record = MoveRecord(obs=obs, pi=pi_full, player=states.player,
                        action=action, win_state=win, done=done, fast=fast,
                        root_visits=tt.n[0].clone())
    return carry, record


def make_move_fns(env, cfg: SelfPlayConfig, apply_fn):
    """Production move runners with the fast/full choice made by the caller
    (the JAX package's ``make_move_fns``).

    ``apply_fn(obs) -> (log_pi, log_v)``, e.g. the ResNet module. Returns
    ``{"fast", "full"}`` → ``fn(carry, generator=None, gumbel=None) ->
    (carry, MoveRecord)``. The JAX package's ``warmup`` runner is not ported
    yet.
    """

    def net_eval(obs):
        logp, logv = apply_fn(obs)
        return torch.exp(logp), torch.exp(logv)

    def build(sims, fast):
        @torch.inference_mode()
        def run(carry, generator=None, gumbel=None):
            return move_step(env, cfg, net_eval, carry, sims, fast=fast,
                             generator=generator, gumbel=gumbel)

        return run

    return {"fast": build(cfg.sims_fast, True),
            "full": build(cfg.sims_full, False)}
