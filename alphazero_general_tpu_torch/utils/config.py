"""The defaults this port reads, copied from the JAX package's config
(alphazero_general_tpu/utils/config.py: search knobs at :107-154, network
knobs at :167-179), so that the port never imports the JAX package.

Only the keys the ported slice reads are here; the rest of the reference's
schema (training, arena, Coach) arrives with the slices that read it.
"""

from __future__ import annotations

from typing import Any


class Args(dict):
    """Attribute-access dict (same surface as the JAX package's ``Args``)."""

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__"):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value


def _default_args() -> Args:
    return Args(
        seed=0,
        # Search (MCTS.pyx constructor knobs).
        numMCTSSims=100,
        numFastSims=20,
        startTemp=1.0,
        cpuct=1.25,
        fpu_reduction=0.2,
        root_policy_temp=1.1,
        root_noise_frac=0.1,
        min_discount=1.0,
        add_root_noise=True,
        add_root_temp=True,
        # Network (reference: alphazero/Coach.py:107-116).
        nnet_type="resnet",
        num_channels=32,
        depth=4,
        value_head_channels=16,
        policy_head_channels=16,
        value_dense_layers=[512, 64],
        policy_dense_layers=[512, 256],
        # Compute dtype of the network forward (parameters stay float32).
        compute_dtype="bfloat16",
        norm="batchnorm",
    )


def get_args(args: Args | dict | None = None, **kwargs) -> Args:
    """A fresh copy of the defaults with ``args`` and ``kwargs`` merged in."""
    new_args = _default_args()
    if args:
        new_args.update(args)
    new_args.update(kwargs)
    return new_args
