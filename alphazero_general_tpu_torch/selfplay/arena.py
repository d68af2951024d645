"""Batched N-model arena — the port of alphazero_general_tpu/selfplay/
arena.py, stepped by the host one move round at a time (reference:
alphazero/Arena.pyx:58-376).

All models are resident on the device and each move round searches the
whole game batch: a fresh game-minor tree per game and move, ``sims``
simulations, no root noise and no root temperature (SelfPlayAgent.pyx:
148-151), then an action sampled at ``arenaTemp`` (SelfPlayAgent.pyx:
156-158). The model of the player to move at the root evaluates that game's
whole search (SelfPlayAgent.pyx:117-121).

Seats and owner routing (Arena.pyx:264-281): the batch is split into
NUM_PLAYERS contiguous seat-rotation groups; in group k, model m plays
player (m + k) % N. Every built-in env advances ``player = (player + 1) %
N`` each step (``Env.ALTERNATES``), so at round t the player to move in
every running game is t % N and each model evaluates exactly one group
(B/N observations) per simulation. For an env with ``ALTERNATES = False``,
or with ``ArenaConfig.route_owner=False``, every model evaluates every
game and each game keeps the evaluation of model ``(player - group) % N``
(JAX arena.py:125, 177-182): N forwards of the whole batch a simulation,
the same games.

Finished games stay frozen (their searches are discarded), and the host
checks every 4 rounds whether all games are done. Nothing is compiled, so
there is no cache of per-move programs to bound.

Sharded (``sharded=True`` under a process group; JAX arena.py:225-266,
328-370): each rank plays its ``rank_slice`` of the games, each game in the
seat group its global index gives it, with the global batch's draws cut to
its games (``parallel.GameShard``). The check that every game is done is
the min over the ranks, so all ranks play the same rounds and leave their
generators in step; wins, draws and game lengths are summed over the
ranks into the ``ArenaResult``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import torch

from alphazero_general_tpu_torch.envs.core import state_items
from alphazero_general_tpu_torch.mcts import search as S
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts.tree_t import init_tree_t
from alphazero_general_tpu_torch.parallel import mesh as M
from alphazero_general_tpu_torch.selfplay.selfplay import gumbel_noise

#: Rounds between the host's checks that every game is done.
EXIT_CHECK_ROUNDS = 4


class ArenaConfig(NamedTuple):
    sims: int = 100  # numMCTSSims (arena searches are full searches)
    arena_temp: float = 0.25  # arenaTemp
    tree_capacity: int = 0  # max_tree_nodes; 0 → sims + 2
    # Owner routing: each model forwards only the games whose seat it owns
    # this round; False evaluates every game with every model.
    route_owner: bool = True
    spec: T.SearchSpec = T.SearchSpec(add_root_noise=False,
                                      add_root_temp=False)

    @property
    def capacity(self) -> int:
        return self.tree_capacity or self.sims + 2

    @classmethod
    def from_args(cls, args, num_players: int,
                  has_draw: bool) -> "ArenaConfig":
        spec = T.SearchSpec(
            cpuct=float(args.cpuct),
            fpu_reduction=float(args.fpu_reduction),
            min_discount=float(args.min_discount),
            add_root_noise=False,
            add_root_temp=False,
            num_players=num_players,
            has_draw=has_draw,
        )
        return cls(sims=int(args.numMCTSSims),
                   arena_temp=float(args.arenaTemp),
                   tree_capacity=int(args.get("max_tree_nodes", 0)),
                   spec=spec)


@dataclasses.dataclass
class ArenaResult:
    """Per-game outcome, seat-remapped to model indices."""

    model_wins: torch.Tensor  # f32[M] on the host
    draws: float
    avg_game_length: float
    num_games: int
    rounds: int  # move rounds played (each one search over every game)


def _select_games(mask, new, old):
    """Per game, ``old`` where ``mask`` else ``new`` (env states)."""
    B = mask.shape[0]

    def sel(name, x):
        m = mask.reshape((B,) + (1,) * (x.dim() - 1))
        return torch.where(m, getattr(old, name), x)

    return type(new)(**{k: sel(k, x) for k, x in state_items(new).items()})


@torch.inference_mode()
def play_games_multi(env, cfg: ArenaConfig, apply_fns: Sequence[Callable],
                     num_games: int, generator=None, draws=None,
                     device="cuda", sharded: bool = False) -> ArenaResult:
    """Play ``num_games`` games between ``N = env.NUM_PLAYERS`` models;
    ``model_wins[m]`` counts the wins of ``apply_fns[m]`` (``obs -> (log_pi,
    log_v)``). ``num_games`` must be divisible by N. With ``sharded``, this
    rank plays its share of the ``num_games`` and the result is the
    global one.

    Random draws come from ``generator``, or from ``draws(t, sims,
    valids) -> MoveDraws`` for round t where given (tests pass the JAX
    package's; ``valids`` are this rank's games').
    """
    N = env.NUM_PLAYERS
    if len(apply_fns) != N:
        raise ValueError(f"need {N} apply fns, got {len(apply_fns)}")
    total = int(num_games)
    if total % N:
        raise ValueError(f"num_games={total} must be divisible by "
                         f"NUM_PLAYERS={N}")
    G = total // N
    rows = M.rank_slice(total) if sharded else slice(0, total)
    if sharded:
        generator = M.shard_generator(generator, total)
    B = rows.stop - rows.start
    A = env.ACTION_SIZE
    V = cfg.spec.value_size
    states = env.init(B, device)
    # Each game's seat-rotation group, from its global index.
    group = torch.arange(rows.start, rows.stop, device=device) // G

    def eval_grouped(obs, t):
        """Model m evaluates group (t - m) % N, whose running games have
        its player to move: the rows of that group this rank holds."""
        pi = torch.zeros((B, A), dtype=torch.float32, device=obs.device)
        v = torch.zeros((B, V), dtype=torch.float32, device=obs.device)
        for m in range(N):
            gm = (t - m) % N
            lo = max(gm * G, rows.start) - rows.start
            hi = min((gm + 1) * G, rows.stop) - rows.start
            if lo >= hi:
                continue
            pm, vm = apply_fns[m](obs[lo:hi])
            pi[lo:hi] = torch.exp(pm).to(torch.float32)
            v[lo:hi] = torch.exp(vm).to(torch.float32)
        return pi, v

    def eval_all(obs, model_idx):
        """Every model evaluates the whole batch; each game keeps its own
        model's evaluation."""
        pi = torch.zeros((B, A), dtype=torch.float32, device=obs.device)
        v = torch.zeros((B, V), dtype=torch.float32, device=obs.device)
        for m in range(N):
            pm, vm = apply_fns[m](obs)
            sel = (model_idx == m)[:, None]
            pi = torch.where(sel, torch.exp(pm).to(torch.float32), pi)
            v = torch.where(sel, torch.exp(vm).to(torch.float32), v)
        return pi, v

    def all_done(done) -> bool:
        every = done.all().to(torch.int32)
        return bool(M.all_reduce_min(every) if sharded else every)

    grouped = bool(getattr(env, "ALTERNATES", True)) and cfg.route_owner
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    result = torch.zeros((B, V), dtype=torch.float32, device=device)
    length = torch.zeros((B,), dtype=torch.int32, device=device)
    t = 0
    while t < int(env.MAX_TURNS):
        if grouped:
            eval_fn = lambda obs, t=t: eval_grouped(obs, t)  # noqa: E731
        else:
            # model m plays game g where (m + group[g]) % N == player[g]
            model_idx = (states.player - group) % N
            eval_fn = lambda obs, m=model_idx: eval_all(obs, m)  # noqa: E731
        d = draws(t, cfg.sims, env.valid_moves(states)) if draws else None
        tt = init_tree_t(env, states, cfg.capacity, V)
        S.search(env, tt, cfg.spec, eval_fn, cfg.sims, generator=generator,
                 draws=d.search if d is not None else None)
        pi = T.probs(T.counts(tt), cfg.arena_temp)
        logits = torch.log(torch.clamp(pi, min=1e-30))
        gumbel = d.gumbel if d is not None else gumbel_noise(
            logits.shape, generator, logits.device)
        action = (gumbel + logits).argmax(dim=-1).to(torch.int32)

        new_states = _select_games(done, env.step(states, action), states)
        win = env.win_state(new_states)
        now_done = (win > 0).any(dim=-1) & ~done
        result = torch.where(now_done[:, None], win, result)
        length = torch.where(now_done, t + 1, length)
        done = done | now_done
        states = new_states
        t += 1
        if t % EXIT_CHECK_ROUNDS == 0 and all_done(done):
            break

    # Seat remap: model m of group k played player (m + k) % N
    # (Arena.pyx:291-299).
    totals = torch.stack(
        [result.gather(1, ((m + group) % N)[:, None]).sum()
         for m in range(N)]
        + [result[:, N].sum() if V > N else result.new_zeros(()),
           length.to(torch.float32).sum()])
    if sharded:
        totals = M.all_reduce_sum(totals)
    totals = totals.cpu()
    # The jitted JAX mean multiplies the sum by the float32 reciprocal of
    # the game count; the same product keeps the average bit-identical.
    mean_length = totals[N + 1] * (1.0 / total)
    return ArenaResult(model_wins=totals[:N].clone(),
                       draws=float(totals[N]) if V > N else 0.0,
                       avg_game_length=float(mean_length),
                       num_games=total, rounds=t)


def play_games(env, cfg: ArenaConfig, apply_fn, num_games: int,
               apply_fn_b=None, generator=None, draws=None,
               device="cuda", sharded: bool = False) -> ArenaResult:
    """Two-model wrapper over :func:`play_games_multi` (the gating and
    baseline arenas, Coach.py:527-590); ``apply_fn_b`` lets model B use
    another evaluation, e.g. the RawMCTS baseline. An env of other than two
    players raises, as in the JAX package."""
    return play_games_multi(env, cfg, [apply_fn, apply_fn_b or apply_fn],
                            num_games, generator=generator, draws=draws,
                            device=device, sharded=sharded)


def make_arena_fn(env, cfg: ArenaConfig, apply_fn, num_games: int,
                  apply_fn_b=None, device="cuda", sharded: bool = False):
    """Two-model arena: ``run(generator=None, draws=None) ->
    ArenaResult``; with ``sharded``, over the ranks of the process group
    (JAX ``make_arena_fn(mesh=)``)."""

    def run(generator=None, draws=None):
        return play_games(env, cfg, apply_fn, num_games, apply_fn_b,
                          generator=generator, draws=draws, device=device,
                          sharded=sharded)

    return run


def make_multi_arena_fn(env, cfg: ArenaConfig, apply_fns: Sequence[Callable],
                        num_games: int, device="cuda"):
    """N-model arena (reference: the Arena's players list, Arena.pyx:58-76;
    JAX arena.py:350): ``run(generator=None, draws=None) -> ArenaResult``
    with ``model_wins[m]`` the wins of ``apply_fns[m]``."""

    def run(generator=None, draws=None):
        return play_games_multi(env, cfg, apply_fns, num_games,
                                generator=generator, draws=draws,
                                device=device)

    return run


def raw_mcts_apply(action_size: int, value_size: int):
    """Apply fn of the RawMCTS baseline: uniform log priors and log values
    of -100 (GenericPlayers.py:198-200)."""
    log_p = -torch.log(torch.tensor(float(action_size)))

    def apply(obs):
        B = obs.shape[0]
        logp = torch.full((B, action_size), float(log_p), dtype=torch.float32,
                          device=obs.device)
        logv = torch.full((B, value_size), -100.0, dtype=torch.float32,
                          device=obs.device)
        return logp, logv

    return apply


def winrates(result: ArenaResult, use_draws: bool = True) -> torch.Tensor:
    """Per-model winrate with half-credit draws (Arena.pyx:19-36,
    Coach.py:393-396)."""
    n = max(float(result.num_games), 1.0)
    credit = 0.5 * result.draws if use_draws else 0.0
    return (result.model_wins + credit) / n
