"""The defaults this port reads, copied from the JAX package's config
(alphazero_general_tpu/utils/config.py: search and self-play knobs at
:107-154 and :185-197, network knobs at :167-179), so that the port never
imports the JAX package.

Only the keys the ported slice reads are here; the rest of the reference's
schema (training, arena, Coach) arrives with the slices that read it.
"""

from __future__ import annotations

from typing import Any


#: default_temp_scaling (reference: alphazero/utils.py:19-27): the
#: temperature halves every TEMP_SCALE_FACTOR * max_turns turns, down to
#: TEMP_MIN.
TEMP_SCALE_FACTOR = 0.15
TEMP_MIN = 0.2


def default_temp_scaling(cur_temp: float, turns: int,
                         max_turns: int) -> float:
    """The reference's temperature schedule (TEMP_SCALE_FACTOR, TEMP_MIN).
    Self-play computes it on tensors (selfplay._update_temps);
    ``temp_scaling_fn`` must be this function, as other schedules are not
    ported."""
    period = int(TEMP_SCALE_FACTOR * max_turns) if max_turns else 0
    if period and (turns + 1) % period == 0:
        return max(TEMP_MIN, cur_temp / 2)
    return cur_temp


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
        numWarmupSims=5,
        mctsResetThreshold=None,
        startTemp=1.0,
        temp_scaling_fn=default_temp_scaling,
        cpuct=1.25,
        fpu_reduction=0.2,
        root_policy_temp=1.1,
        root_noise_frac=0.1,
        min_discount=1.0,
        add_root_noise=True,
        add_root_temp=True,
        # Node rows of a search tree (0 = numMCTSSims + 2, doubled under
        # reuse_tree).
        max_tree_nodes=0,
        # Carry search trees across moves, re-rooted at the played action
        # (the reference's update_root reuse); off by default, as in the
        # JAX package.
        reuse_tree=False,
        # Leaves evaluated per network call; only 1 is ported.
        leaf_batch=1,
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
