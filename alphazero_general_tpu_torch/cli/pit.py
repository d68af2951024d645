"""Pit two players:
``python -m alphazero_general_tpu_torch.cli.pit <env> --p1 SPEC --p2 SPEC
[--games N] [--device cuda|cpu]`` — the port of
alphazero_general_tpu/cli/pit.py (reference: alphazero/pit.py:14-45).
Player specs:

  ``mcts:<ckpt-path>``    MCTS + network checkpoint (MCTSPlayer)
  ``nn:<ckpt-path>``      raw network policy (NNPlayer)
  ``rawmcts``             model-free MCTS baseline (on the device)
  ``nativemcts``          model-free MCTS on the C++ host runtime
  ``random``              uniform random
  ``greedy``              one-ply crude_value lookahead
  ``human``               console input

A checkpoint path is ``folder/iteration-NNNN`` (``.ckpt`` optional), of
this package or of the JAX package. Games and searches run on ``cuda``
unless ``--device cpu`` is given (the JAX tool defaults to the CPU).
Every move is checked against the valid moves; a player's illegal move
raises.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from alphazero_general_tpu_torch.cli.common import (
    add_args_overrides, add_device_arg, add_env_arg, resolve_args,
)
from alphazero_general_tpu_torch.envs import get_env


def load_net(env, path: str, device):
    """The network of checkpoint ``path`` (``folder/name[.ckpt]``)."""
    from alphazero_general_tpu_torch.models import NNetWrapper

    folder, filename = os.path.split(path)
    return NNetWrapper.from_checkpoint(env, folder,
                                       filename.removesuffix(".ckpt"),
                                       device=device)


def build_player(spec: str, env, args, seed: int, device="cuda"):
    from alphazero_general_tpu_torch.players import players as P

    kind, _, path = spec.partition(":")
    if kind in ("mcts", "nn"):
        if not path:
            raise SystemExit(f"{kind}: needs a checkpoint path, e.g. "
                             f"{kind}:checkpoint/run/iteration-0010")
        nn = load_net(env, path, device)
        cls = P.MCTSPlayer if kind == "mcts" else P.NNPlayer
        return cls(nn, env, args, seed=seed, verbose=True)
    if kind == "rawmcts":
        return P.RawMCTSPlayer(env, args, seed=seed, device=device)
    if kind == "nativemcts":
        return P.NativeRawMCTSPlayer(env, args, seed=seed)
    if kind == "random":
        return P.RandomPlayer(env, args, seed=seed)
    if kind == "greedy":
        return P.GreedyValuePlayer(env, args)
    if kind == "human":
        return P.HumanConsolePlayer(env, args)
    raise SystemExit(f"unknown player spec {spec!r}")


def play_game(env, players, verbose: bool, max_turns: int, device="cuda",
              clock=None):
    """One game, the players taking their seats in order (reference:
    Arena.pyx:138-186); returns (win vector, turns). ``clock``, a dict,
    gathers each player's moves and seconds by ``id``."""
    state = env.init(1, device)
    for p in players:
        p.reset()
    while True:
        win = env.win_state(state)[0].cpu().numpy()
        turns = int(state.turns[0])
        if win.any() or turns >= max_turns:
            return win, turns
        mover = players[int(state.player[0])]
        t0 = time.perf_counter()
        action = mover.play(state)
        if clock is not None:
            moves, secs = clock.get(id(mover), (0, 0.0))
            clock[id(mover)] = (moves + 1,
                                secs + time.perf_counter() - t0)
        if not bool(env.valid_moves(state)[0, action]):
            raise ValueError(f"{type(mover).__name__} played the illegal "
                             f"action {action} at turn {turns}")
        for p in players:
            p.update(state, action)
        if verbose:
            print(f"turn {turns}, player {int(state.player[0])} "
                  f"-> action {action}")
        state = env.step(state, torch.tensor([action], dtype=torch.int32,
                                             device=state.player.device))
        if verbose:
            print(env.display(state))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_env_arg(p)
    p.add_argument("--p1", required=True, help="player 1 spec")
    p.add_argument("--p2", required=True, help="player 2 spec")
    p.add_argument("--games", type=int, default=2)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    add_args_overrides(p)
    ns = p.parse_args(argv)

    env = get_env(ns.env)
    args = resolve_args(ns)
    p1 = build_player(ns.p1, env, args, ns.seed, ns.device)
    p2 = build_player(ns.p2, env, args, ns.seed + 1, ns.device)

    wins = [0, 0]
    draws = 0
    clock = {}
    for g in range(ns.games):
        # Alternate seats each game (Arena.pyx:332-337).
        seat_players = [p1, p2] if g % 2 == 0 else [p2, p1]
        win, turns = play_game(env, seat_players, ns.verbose, env.MAX_TURNS,
                               ns.device, clock)
        if win[-1] or not win.any():
            draws += 1
            outcome = "draw"
        else:
            seat_winner = int(np.argmax(win[:-1]))
            model_winner = seat_winner if g % 2 == 0 else 1 - seat_winner
            wins[model_winner] += 1
            outcome = f"p{model_winner + 1} wins"
        print(f"game {g + 1}: {outcome} in {turns} moves "
              f"(p1 {wins[0]} / p2 {wins[1]} / draws {draws})")
    print(f"final: p1 {wins[0]} wins, p2 {wins[1]} wins, {draws} draws")
    for tag, spec, player in (("p1", ns.p1, p1), ("p2", ns.p2, p2)):
        moves, secs = clock.get(id(player), (0, 0.0))
        if moves:
            print(f"{tag} {spec}: {moves} moves, "
                  f"{secs * 1e3 / moves:.3f} ms a move")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
