"""Train an AlphaZero model on one device:
``python -m alphazero_general_tpu_torch.cli.train <env> [--set KEY=VALUE]
[--args-file FILE] [--device cuda|cpu]`` — the port of
alphazero_general_tpu/cli/train.py (reference: alphazero/envs/*/train.py).

The defaults are the JAX package's: self-play after the warmup and both
arenas run the int8 tower (``quant_selfplay=True``; ``--set
quant_selfplay=False`` keeps the float one).
"""

from __future__ import annotations

import argparse

from alphazero_general_tpu_torch.cli.common import (
    add_args_overrides, add_device_arg, add_env_arg, resolve_args,
)
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs.stacked import maybe_stack


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

    nnet = NNetWrapper(env, args, device=ns.device)
    coach = Coach(env, nnet, args)
    try:
        coach.learn()
    except KeyboardInterrupt:
        print("\nInterrupted; checkpoints are saved per-iteration.")
    finally:
        coach.writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
