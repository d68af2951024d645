"""Train an AlphaZero model:
``python -m alphazero_general_tpu_torch.cli.train <env> [--set KEY=VALUE]
[--args-file FILE] [--device cuda|cpu]`` — the port of
alphazero_general_tpu/cli/train.py (reference: alphazero/envs/*/train.py).

On W cards: ``torchrun --nproc_per_node=W -m
alphazero_general_tpu_torch.cli.train <env>``. Each rank joins the process
group (NCCL; Gloo with ``--device cpu``) and runs the Coach on its own
card, data-parallel (train/coach.py): the games, train batches and arena
games are global and split over the ranks, so each must be a multiple of
W. A process group that exists already (made by the caller) is used as it
is.

The defaults are the JAX package's: self-play after the warmup and both
arenas run the int8 tower (``quant_selfplay=True``; ``--set
quant_selfplay=False`` keeps the float one).
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from alphazero_general_tpu_torch.cli.common import (
    add_args_overrides, add_device_arg, add_env_arg, resolve_args,
)
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs.stacked import maybe_stack
from alphazero_general_tpu_torch.parallel import mesh as M


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    add_env_arg(p)
    add_args_overrides(p)
    add_device_arg(p)
    ns = p.parse_args(argv)

    args = resolve_args(ns)
    # num_stacked_observations > 1 wraps the env (JAX cli/train.py:51-55)
    env = maybe_stack(get_env(ns.env), args)

    from alphazero_general_tpu_torch.models import NNetWrapper
    from alphazero_general_tpu_torch.train import Coach

    # One rank a device under torchrun (NCCL on the card, Gloo on the
    # CPU); a group the caller made is used as it is, and left to it.
    owns_group = not dist.is_initialized()
    M.init_distributed(ns.device)
    device = M.local_device(ns.device)
    try:
        nnet = NNetWrapper(env, args, device=device)
        coach = Coach(env, nnet, args)
        try:
            coach.learn()
        except KeyboardInterrupt:
            print("\nInterrupted; checkpoints are saved per-iteration.")
        finally:
            coach.writer.close()
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
