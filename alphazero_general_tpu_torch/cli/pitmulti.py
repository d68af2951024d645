"""Benchmark every k-th checkpoint of a run against a fixed opponent:
``python -m alphazero_general_tpu_torch.cli.pitmulti <env> --run <run_name>``
— the port of alphazero_general_tpu/cli/pitmulti.py (reference:
alphazero/pit-multi.py:22-104).

Each selected checkpoint plays ``--games`` batched arena games against the
RawMCTS baseline or a fixed checkpoint; the winrates go to the metrics
stream (``<runs>/<run>-pitmulti/metrics.jsonl``, tag
``win_rate/pit_multi``) and are printed. It runs on ``cuda`` unless
``--device cpu`` is given (the JAX tool picks its platform itself).
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import torch

from alphazero_general_tpu_torch.cli.common import (
    add_args_overrides, add_device_arg, add_env_arg, resolve_args,
)
from alphazero_general_tpu_torch.envs import get_env


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    add_env_arg(p)
    p.add_argument("--run", required=True, help="run name under --checkpoint")
    p.add_argument("--checkpoint", default="checkpoint")
    p.add_argument("--runs", default="runs", help="metrics root")
    p.add_argument("--every", type=int, default=5,
                   help="test every k-th checkpoint")
    p.add_argument("--games", type=int, default=64)
    p.add_argument("--vs", default="baseline",
                   help="'baseline' (RawMCTS) or a fixed checkpoint path")
    add_device_arg(p)
    add_args_overrides(p)
    ns = p.parse_args(argv)

    env = get_env(ns.env)
    args = resolve_args(ns)
    from alphazero_general_tpu_torch.cli.pit import load_net
    from alphazero_general_tpu_torch.selfplay.arena import (
        ArenaConfig, make_arena_fn, raw_mcts_apply, winrates,
    )
    from alphazero_general_tpu_torch.utils.metrics import make_writer

    folder = os.path.join(ns.checkpoint, ns.run)
    ckpts = sorted(glob(os.path.join(folder, "iteration-*.ckpt")))
    selected = ckpts[:: max(ns.every, 1)]
    if ckpts and ckpts[-1] not in selected:
        selected.append(ckpts[-1])
    if not selected:
        raise SystemExit(f"no checkpoints under {folder}")

    cfg = ArenaConfig.from_args(args, env.NUM_PLAYERS, env.HAS_DRAW)
    if ns.vs == "baseline":
        opponent = raw_mcts_apply(env.ACTION_SIZE,
                                  env.NUM_PLAYERS + int(env.HAS_DRAW))
        opp_name = "RawMCTS baseline"
    else:
        opponent = load_net(env, ns.vs, ns.device).model
        opp_name = ns.vs
    writer = make_writer(ns.runs, ns.run + "-pitmulti")
    generator = torch.Generator(ns.device).manual_seed(0)
    print(f"pitting {len(selected)} checkpoints vs {opp_name}")
    for path in selected:
        name = os.path.basename(path).removesuffix(".ckpt")
        it = int(name.split("-")[-1])
        model = load_net(env, path, ns.device).model
        arena = make_arena_fn(env, cfg, model, ns.games,
                              apply_fn_b=opponent, device=ns.device)
        res = arena(generator=generator)
        wr = float(winrates(res)[0])
        writer.add_scalar("win_rate/pit_multi", wr, it)
        wins = res.model_wins.numpy()
        print(f"{name}: winrate {wr:.3f} ({wins[0]:.0f}-{wins[1]:.0f}, "
              f"{float(res.draws):.0f} draws) in {res.rounds} rounds")
    writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
