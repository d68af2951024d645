"""Analyze a position:
``python -m alphazero_general_tpu_torch.cli.analyze <env> [--moves 3,3,4]
[--ckpt folder/iteration-NNNN] [--sims 400] [--device cuda|cpu]`` — the
port of alphazero_general_tpu/cli/analyze.py, the CLI surface of the live
evaluator (players/evaluator.py; reference: Evaluator.py:413-440). Plays
through a move list, then reports the value, the best moves and the search
depth, with or without a network.

It runs on ``cuda`` unless ``--device cpu`` is given (the JAX tool
defaults to the CPU). On the card a search of ``--sims`` simulations needs
a tree of ``sims + 3`` rows, at most the CUDA descend's
``ops.descend.MAX_NODES``; more raises with a message.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from alphazero_general_tpu_torch.cli.common import (
    add_args_overrides, add_device_arg, add_env_arg, resolve_args,
)
from alphazero_general_tpu_torch.envs import get_env


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    add_env_arg(p)
    p.add_argument("--moves", default="",
                   help="comma-separated action list to reach the position")
    p.add_argument("--ckpt", help="checkpoint path (folder/iteration-NNNN)")
    p.add_argument("--sims", type=int, default=400)
    add_device_arg(p)
    add_args_overrides(p)
    ns = p.parse_args(argv)

    env = get_env(ns.env)
    args = resolve_args(ns)
    nn = None
    if ns.ckpt:
        from alphazero_general_tpu_torch.cli.pit import load_net

        nn = load_net(env, ns.ckpt, ns.device)

    from alphazero_general_tpu_torch.players.evaluator import MCTSEvaluator

    try:  # the row cap is checked here, before any search
        ev = MCTSEvaluator(env, args, nn=nn, max_search_time=600.0,
                           max_sims=ns.sims, sims_per_tick=min(50, ns.sims),
                           device=ns.device)
    except ValueError as e:
        raise SystemExit(f"--sims {ns.sims}: {e}") from e

    state = env.init(1, ns.device)
    if ns.moves:
        for m in ns.moves.split(","):
            a = int(m)
            if not bool(env.valid_moves(state)[0, a]):
                raise SystemExit(f"move {a} is illegal at turn "
                                 f"{int(state.turns[0])}")
            state = env.step(state, torch.tensor([a], dtype=torch.int32,
                                                 device=ns.device))

    print(env.display(state))
    print(f"player {int(state.player[0])} to move, "
          f"turn {int(state.turns[0])}")
    win = env.win_state(state)[0].cpu().numpy()
    if win.any():
        print(f"terminal: win_state={win}")
        return 0

    a = ev.analyze_blocking(state)
    print(f"value (mover): {a.value:.3f}   depth: {a.depth}   "
          f"sims: {a.sims}   {a.elapsed:.1f}s")
    if a.policy is not None:
        order = np.argsort(-a.policy)[:5]
        for rank, act in enumerate(order, 1):
            if a.policy[act] <= 0:
                break
            print(f"  {rank}. action {int(act)}  visits {a.policy[act]:.1%}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
