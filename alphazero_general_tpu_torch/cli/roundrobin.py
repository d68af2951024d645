"""All-pairs tournament over checkpoints with Elo-style ratings:
``python -m alphazero_general_tpu_torch.cli.roundrobin <env> --checkpoints a
b c [--games 32] [--include-baseline] [--out FILE] [--device cuda|cpu]`` —
the port of alphazero_general_tpu/cli/roundrobin.py (reference:
alphazero/roundrobin.py:14-89).

Each pairing plays the port's batched arena (selfplay/arena.py) and the
ratings come from the I-LSR estimator (utils/elo.py). ``--out`` writes the
names, the win matrix, the ratings and the move rounds played as JSON. It
runs on ``cuda`` unless ``--device cpu`` is given (the JAX tool defaults
to the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob

import numpy as np
import torch

from alphazero_general_tpu_torch.cli.common import (
    add_args_overrides, add_device_arg, add_env_arg, resolve_args,
)
from alphazero_general_tpu_torch.envs import get_env


def run_tournament(env, cfg, apply_fns, names, games: int, generator=None,
                   baseline_apply=None, verbose: bool = True,
                   device="cuda"):
    """All-pairs tournament (reference: roundrobin.py:44-77) of the models
    ``apply_fns`` (``obs -> (log_pi, log_v)``), with ``baseline_apply`` as
    the last contestant, "baseline", where given. Returns (names, wins[n,
    n] with half-credit draws, move rounds played)."""
    from alphazero_general_tpu_torch.selfplay.arena import make_arena_fn

    names = list(names)
    apply_fns = list(apply_fns)
    if baseline_apply is not None:
        names.append("baseline")
        apply_fns.append(baseline_apply)
    n = len(names)
    wins = np.zeros((n, n))
    rounds = 0
    for i in range(n):
        for j in range(i + 1, n):
            arena = make_arena_fn(env, cfg, apply_fns[i], games,
                                  apply_fn_b=apply_fns[j], device=device)
            res = arena(generator=generator)
            mw = res.model_wins.numpy()
            d = float(res.draws)
            wins[i, j] += mw[0] + 0.5 * d
            wins[j, i] += mw[1] + 0.5 * d
            rounds += res.rounds
            if verbose:
                print(f"{names[i]} vs {names[j]}: {mw[0]:.0f}-{mw[1]:.0f} "
                      f"({d:.0f} draws)")
    return names, wins, rounds


def checkpoint_paths(patterns):
    """Checkpoint paths, each pattern with a wildcard expanded in order."""
    paths = []
    for c in patterns:
        paths.extend(sorted(glob(c)) if any(ch in c for ch in "*?[")
                     else [c])
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    add_env_arg(p)
    p.add_argument("--checkpoints", nargs="+", required=True,
                   help="checkpoint paths (or a glob like "
                        "'checkpoint/run/*.ckpt')")
    p.add_argument("--games", type=int, default=32,
                   help="games per pairing (even)")
    p.add_argument("--include-baseline", action="store_true",
                   help="add the model-free RawMCTS baseline as a contestant")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", help="write the results to this JSON file")
    add_device_arg(p)
    add_args_overrides(p)
    ns = p.parse_args(argv)

    env = get_env(ns.env)
    args = resolve_args(ns)
    from alphazero_general_tpu_torch.cli.pit import load_net
    from alphazero_general_tpu_torch.selfplay.arena import (
        ArenaConfig, raw_mcts_apply,
    )
    from alphazero_general_tpu_torch.utils.elo import (
        ilsr_pairwise_dense, to_elo,
    )

    names, apply_fns = [], []
    for path in checkpoint_paths(ns.checkpoints):
        names.append(os.path.basename(path).removesuffix(".ckpt"))
        apply_fns.append(load_net(env, path.removesuffix(".ckpt"),
                                  ns.device).model)
    if len(names) + int(ns.include_baseline) < 2:
        raise SystemExit("need at least two contestants")
    cfg = ArenaConfig.from_args(args, env.NUM_PLAYERS, env.HAS_DRAW)
    baseline = None
    if ns.include_baseline:
        baseline = raw_mcts_apply(env.ACTION_SIZE,
                                  env.NUM_PLAYERS + int(env.HAS_DRAW))
    generator = torch.Generator(ns.device).manual_seed(ns.seed)
    names, wins, rounds = run_tournament(
        env, cfg, apply_fns, names, ns.games, generator,
        baseline_apply=baseline, device=ns.device)

    ratings = to_elo(ilsr_pairwise_dense(wins))
    order = np.argsort(-ratings)
    print("\n=== ratings ===")
    for rank, idx in enumerate(order, 1):
        print(f"{rank:2d}. {names[idx]:<30s} {ratings[idx]:7.1f}")
    if ns.out:
        with open(ns.out, "w") as f:
            json.dump({"names": names, "wins": wins.tolist(),
                       "ratings": ratings.tolist(), "rounds": rounds,
                       "games": ns.games, "sims": cfg.sims}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
