"""alphazero_general_tpu_torch: the PyTorch/CUDA port of alphazero_general_tpu.

The JAX package beside this one is the reference; each module here mirrors
its counterpart's path (``envs/``, ``mcts/``, ``ops/``, ``models/``,
``selfplay/``, ``train/``, ``players/``, ``cli/``, ``utils/``). State is batched torch tensors, every stochastic
step takes its random draws as an optional argument or an explicit
``torch.Generator``, and the two Pallas kernels of the JAX package (the PUCT
descent and the backup) are hand-written CUDA kernels under ``csrc/``, built
with ``nvcc`` on first use (``ops/build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU each kernel wrapper runs its plain PyTorch version instead.

This package imports torch, numpy and the standard library only — never
JAX, flax or the JAX package.
"""

__version__ = "0.1.0"
