"""The comparisons that decide ``correct``: what the timed path produced,
held to the plain reference (``reference/``). Each returns numbers that
``limits/<cell>.json`` bounds."""

from __future__ import annotations

import numpy as np
import torch

from azbench import registry
from azbench.common import same_state
from azbench.reference import make_env, mcts, rules_module

#: Dirichlet alpha of the root noise over the number of valid moves
#: (the upstream project's MCTS.pyx).
NOISE_ALPHA_RATIO = 10.83

#: Quantized-tower levels of each precision the reference runs.
LEVELS = {"int8": 127, "int4": 7}

#: The control of each precision a configuration states: the nearest
#: precision below it.
CONTROL_OF = {"int8": "int4", "bfloat16": "fp8", "float32": "bfloat16"}


def calibration_obs(ctx) -> torch.Tensor:
    """The int8 tower's calibration set: the observations of random
    playouts (256 games, 24 moves), made by the benchmark from the seed."""
    return rules_module(ctx.cfg).playouts(
        256, 24, ctx.generator("calibration"), ctx.device)["obs"]


def reference_eval(ctx, W: dict, precision: str, calib=None):
    """``eval(obs tensor [n, ...]) -> (pi, v)`` numpy of the reference
    network of the configuration (``registry.network``) in ``precision``:
    "float32", "int8" or "int4" (the quantized tower, calibrated on
    ``calib``) or "fp8" (every conv and dense operand rounded to float8
    e4m3)."""
    net = registry.network(ctx.cfg)
    kw = {}
    if precision in LEVELS:
        kw = {"tower_levels": LEVELS[precision],
              "maxima": net.calibration_maxima(W, calib, ctx.cfg)}
    elif precision == "fp8":
        kw = {"low": True}
    elif precision not in ("float32", "bfloat16"):
        raise ValueError(f"no reference precision {precision!r}")

    def run(obs):
        obs = torch.as_tensor(obs).to(ctx.device)
        pi, v = net.evaluate(W, obs, ctx.cfg, **kw)
        return pi.cpu().numpy(), v.cpu().numpy()

    return run


def search_draws(env, states, sims: int, gen: torch.Generator):
    """(gumbel [B, A], tie [sims, B, A], gammas [B, A]): one move's
    random draws, made by the benchmark. The Gamma draws' alpha is 10.83
    over each game's number of valid moves (read from the program's
    env)."""
    valid = env.valid_moves(states)
    B, A = valid.shape
    dev = valid.device
    nvalid = valid.sum(-1, keepdim=True).clamp(min=1).float()
    alpha = (NOISE_ALPHA_RATIO / nvalid).expand(B, A).contiguous()
    gammas = torch._standard_gamma(alpha, generator=gen)
    tie = torch.rand((sims, B, A), generator=gen, device=dev)
    u = torch.rand((B, A), generator=gen, device=dev).clamp(
        min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u)), tie, gammas


def stack_games(states: list, games) -> dict:
    """Field -> numpy [len(states), len(games), ...] of the given games of
    a list of batched states (each a field -> tensor dict)."""
    idx = torch.as_tensor(games, device=next(iter(states[0].values())).device)
    return {k: torch.stack([s[k] for s in states])[:, idx].cpu().numpy()
            for k in states[0]}


def transitions(cfg: dict, states: dict, actions: np.ndarray,
                wins: np.ndarray, dones: np.ndarray,
                auto_reset: bool = True) -> dict:
    """Each move of each game held to the reference rules: the action
    legal, the result and the next state (the fresh game where a game
    ended and ``auto_reset``) equal to the reference's. ``states`` field
    -> [M + 1, G, ...]; ``actions``, ``dones`` [M, G], ``wins`` [M, G, V].
    Returns the counts of illegal actions and of transitions that
    differ."""
    ref = make_env(cfg)
    init = ref.init()
    M, G = actions.shape
    illegal = mismatch = 0
    for g in range(G):
        for m in range(M):
            s = {k: v[m, g] for k, v in states.items()}
            nxt = {k: v[m + 1, g] for k, v in states.items()}
            a = int(actions[m, g])
            if not (0 <= a < ref.action_size) or not ref.valid(s)[a]:
                illegal += 1
                mismatch += 1
                continue
            s2 = ref.step(s, a)
            w = ref.win(s2)
            done = bool((w > 0).any())
            want = init if (done and auto_reset) else s2
            if not (np.array_equal(w, wins[m, g]) and done == bool(dones[m, g])
                    and same_state(want, nxt)):
                mismatch += 1
    return {"illegal_actions": illegal, "env_mismatch": mismatch}


def dense_pi(pi: torch.Tensor, pi_idx, action_size: int) -> torch.Tensor:
    """A move record's policy rows as dense float32 [B, A]."""
    if pi_idx is None:
        return pi.float()
    out = torch.zeros((pi.shape[0], action_size), dtype=torch.float32,
                      device=pi.device)
    return out.scatter_(1, pi_idx.long(), pi.float())


def policy_records(cfg: dict, states: dict, pis: list, actions: np.ndarray,
                   root_visits: np.ndarray, sims: list) -> int:
    """Records that are wrong: a root not visited ``sims`` times; a full
    move's policy row (``pis[m]`` numpy [G, A], None for a fast move) that
    does not sum to 1 within float16 rounding, puts mass on an invalid
    action, or none on the action played."""
    ref = make_env(cfg)
    bad = 0
    for m, pi in enumerate(pis):
        for g in range(actions.shape[1]):
            if int(root_visits[m, g]) != sims[m]:
                bad += 1
                continue
            if pi is None:
                continue
            s = {k: v[m, g] for k, v in states.items()}
            valid = ref.valid(s)
            row = pi[g]
            if (abs(float(row.sum()) - 1.0) > 2 ** -6
                    or bool((row[~valid] != 0).any())
                    or row[int(actions[m, g])] <= 0):
                bad += 1
    return bad


def replay_search(cfg: dict, spec: dict, roots: list, sims: int,
                  tie: np.ndarray, gammas: np.ndarray, obs: np.ndarray,
                  pi: np.ndarray, v: np.ndarray, counts: np.ndarray,
                  ref_eval) -> dict:
    """The reference's searches of one move of games ``roots``, with the
    same draws (``tie`` [G, sims, A], ``gammas`` [G, A]), taking the
    program's network outputs (``pi``, ``v`` [sims, G, ...]) where its new
    leaf's observation equals the program's (``obs`` [sims, G, ...]).
    ``counts`` [G, A] are the program's root visit counts. Returns the leaf
    mismatches, the share of a search's visits placed differently (the
    worst game's) and the reference's visit counts."""
    ref = make_env(cfg)
    out = mcts.replay(ref, roots, spec, sims, tie, gammas,
                      lambda k, g: obs[k, g],
                      lambda k, g: (pi[k, g], v[k, g]), ref_eval)
    moved = np.abs(out["visits"] - counts).sum(axis=1)
    return {"leaf_mismatch": int(out["leaf_mismatch"]),
            "visit_mismatch": float(moved.max() / max(sims - 1, 1)),
            "visits": out["visits"], "followed": out["followed"],
            "missed": out["missed"]}


def tie_notes(followed: list, missed: list) -> dict:
    """What a run notes of the replays' near ties (not compared): how many
    were followed and the widest gap followed, and the closest flip of a
    leaf mismatch (in float32 ulps; ``mcts.TIE_ULPS`` is the rule)."""
    return {"near_ties_followed": len(followed),
            "widest_tie_followed_ulps": max(followed, default=0.0),
            "closest_flip_missed_ulps": min(missed, default=None),
            "tie_rule_ulps": mcts.TIE_ULPS}


def network_gaps(pi: np.ndarray, v: np.ndarray, obs: np.ndarray,
                 ref_eval) -> dict:
    """The widest total-variation distance (half the summed absolute
    difference) between a row of the program's policy, or value,
    probabilities and the reference network's on the same observations
    (rows of any leading shape)."""
    shape = obs.shape
    flat = obs.reshape((-1,) + shape[-3:])
    rp, rv = ref_eval(torch.from_numpy(np.ascontiguousarray(flat)))

    def tv(a, b):
        return float(0.5 * np.abs(a.reshape(b.shape) - b).sum(-1).max())

    return {"policy_gap": tv(pi, rp), "value_gap": tv(v, rv)}


def temperature_policy(counts: np.ndarray, temp: float) -> np.ndarray:
    """The visit-count policy at temperature ``temp`` (float32, in log
    space; the most visited action's one-hot at temperature 0)."""
    c = counts.astype(np.float32)
    total = max(c.sum(dtype=np.float32), np.float32(1))
    if temp <= 1e-6:
        out = np.zeros_like(c)
        out[int(np.argmax(c))] = 1
        return out
    with np.errstate(divide="ignore"):
        logf = np.where(c > 0, np.log(np.maximum(c / total, 1e-30)),
                        -np.inf).astype(np.float32)
    scaled = logf / np.float32(max(temp, 1e-6))
    if not np.isfinite(scaled).any():
        return np.zeros_like(c)  # no visit: no policy
    scaled = scaled - scaled[np.isfinite(scaled)].max()
    p = np.where(np.isfinite(scaled), np.exp(scaled), 0).astype(np.float32)
    return p / max(p.sum(dtype=np.float32), np.float32(1e-30))


def next_temperature(cfg: dict, temp: float, turns: int) -> float:
    """The temperature schedule (the upstream project's utils.py): halve
    every ``factor`` · max turns turns, down to ``min``."""
    t = cfg["search_constants"]["temperature"]
    period = int(t["factor"] * cfg["max_turns"])
    if period and (turns + 1) % period == 0:
        return max(t["min"], temp / 2)
    return temp


def search_spec(cfg: dict) -> dict:
    """The search's constants from a configuration's args."""
    a = cfg["args"]
    spec = {k: a[k] for k in ("cpuct", "fpu_reduction", "root_policy_temp",
                              "root_noise_frac", "add_root_noise",
                              "add_root_temp", "min_discount")}
    spec["tie_noise"] = cfg["search_constants"]["tie_noise"]
    return spec


def root_counts_from_pi(pi: np.ndarray, root_visits: np.ndarray) -> np.ndarray:
    """Visit counts of the root's children from a policy record at
    temperature 1 (counts over their sum, the root's visits less one)."""
    return np.rint(pi.astype(np.float64)
                   * (root_visits[:, None].astype(np.float64) - 1)
                   ).astype(np.int64)


def states_of(games_states: dict, m: int) -> list:
    """The games' states of move ``m`` as reference dicts."""
    G = next(iter(games_states.values())).shape[1]
    return [{k: v[m, g] for k, v in games_states.items()} for g in range(G)]

