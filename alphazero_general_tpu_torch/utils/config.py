"""Configuration — the port of alphazero_general_tpu/utils/config.py
(reference: alphazero/Coach.py:25-117 ``DEFAULT_ARGS``, alphazero/utils.py:
1-12 ``dotdict``, alphazero/__init__.py:18-52 JSON round-trip).

The same schema and defaults as the JAX package, so that an args file of
either package loads in the other. Callables are written to JSON as
``"__CALLABLE__<name>"`` and revived through an explicit registry, never
``eval``.

Some knobs name a path the port does not run yet; :func:`check_ported`
raises on them (it never falls back quietly).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict

from alphazero_general_tpu_torch.parallel import mesh as M
from alphazero_general_tpu_torch.utils.misc import (
    const_temp_scaling, default_temp_scaling, scale_temp,
)

_CALLABLE_PREFIX = "__CALLABLE__"
_REGISTRY: Dict[str, Any] = {
    fn.__name__: fn
    for fn in (default_temp_scaling, const_temp_scaling, scale_temp)
}


def register_callable(obj: Callable, name: str | None = None) -> Callable:
    """Register a callable so that it can round-trip through args files."""
    _REGISTRY[name or obj.__name__] = obj
    return obj


def resolve_callable(name: str) -> Any:
    if name not in _REGISTRY:
        raise KeyError(
            f"Unknown callable {name!r} in args file. Register it with "
            "alphazero_general_tpu_torch.utils.config.register_callable "
            "first.")
    return _REGISTRY[name]


class Args(dict):
    """Attribute-access dict (the reference's ``dotdict``)."""

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__"):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def copy(self) -> "Args":
        return self.__class__(super().copy())


def _default_args() -> Args:
    """The JAX package's defaults (utils/config.py:90-220), key for key."""
    return Args(
        run_name="boardgame",
        startIter=0,
        numIters=1000,
        # Games played in lockstep on the device.
        process_batch_size=256,
        train_batch_size=1024,
        arena_batch_size=64,
        train_steps_per_iteration=64,
        train_sample_ratio=1,
        averageTrainSteps=False,
        autoTrainSteps=True,
        train_on_past_data=False,
        past_data_chunk_size=25,
        past_data_run_name="boardgame",
        gamesPerIteration=1024,
        minTrainHistoryWindow=4,
        maxTrainHistoryWindow=20,
        trainHistoryIncrementIters=2,
        _num_players=None,  # set by the Coach: num_players + has_draw
        min_discount=1.0,
        fpu_reduction=0.2,
        num_stacked_observations=1,
        numWarmupIters=1,
        skipSelfPlayIters=None,
        selfPlayModelIter=None,
        symmetricSamples=True,
        numMCTSSims=100,
        numFastSims=20,
        numWarmupSims=5,
        probFastSim=0.75,
        mctsResetThreshold=None,
        startTemp=1.0,
        temp_scaling_fn=default_temp_scaling,
        root_policy_temp=1.1,
        root_noise_frac=0.1,
        add_root_noise=True,
        add_root_temp=True,
        compareWithBaseline=True,
        baselineTester="rawmcts",
        arenaCompareBaseline=128,
        arenaCompare=128,
        arenaTemp=0.25,
        arenaMCTS=True,
        arenaBatched=True,
        baselineCompareFreq=1,
        compareWithPast=True,
        pastCompareFreq=1,
        model_gating=True,
        max_gating_iters=None,
        min_next_model_winrate=0.52,
        use_draws_for_winrate=True,
        # Gate rule: "reference" (winrate with half-credit draws) or
        # "decided" (wins over decided games, at least gateMinDecided).
        gatingRule="reference",
        gateMinDecided=16,
        load_model=True,
        cpuct=1.25,
        value_loss_weight=1.5,
        checkpoint="checkpoint",
        data="data",
        # SGD, momentum 0.9, weight decay 1e-4, lr 1e-2, MultiStepLR
        # milestones [75, 125] gamma 0.1 (reference: Coach.py:89-105).
        optimizer="sgd",
        optimizer_args=Args(momentum=0.9, weight_decay=1e-4, nesterov=False),
        scheduler="multistep",
        scheduler_args=Args(milestones=[75, 125], gamma=0.1),
        lr=1e-2,
        # Network (reference: Coach.py:107-116).
        nnet_type="resnet",
        num_channels=32,
        depth=4,
        value_head_channels=16,
        policy_head_channels=16,
        input_fc_layers=[1024] * 4,
        value_dense_layers=[512, 64],
        policy_dense_layers=[512, 256],
        # Devices on the game/batch axis: -1 = all. The port runs one.
        mesh_batch_axis=-1,
        # Compute dtype of the network forward and backward (parameters
        # stay float32).
        compute_dtype="bfloat16",
        norm="batchnorm",
        seed=0,
        selfplay_chunk_moves=16,
        # Node rows of a search tree (0 = numMCTSSims + 2, doubled under
        # reuse_tree).
        max_tree_nodes=0,
        # Carry search trees across moves, re-rooted at the played action.
        reuse_tree=False,
        # Leaves evaluated per network call in self-play's fresh searches
        # (multi-leaf rounds, mcts/search.py); 1 is the reference's search.
        leaf_batch=1,
        # Int8-quantized network tower for self-play and arena inference
        # after the warmup (models/quant.py); architectures without an int8
        # path (the FC net, GroupNorm) play the float tower.
        quant_selfplay=True,
        # When set, each Coach phase also writes a torch.profiler trace
        # under <profile_dir>/<phase>-iterNNN (utils/trace.py), with the
        # search's stage spans turned on for the profiled phase.
        profile_dir="",
    )


def get_args(args: Args | dict | None = None, **kwargs) -> Args:
    """A fresh copy of the defaults with ``args`` and ``kwargs`` merged in."""
    new_args = _default_args()
    if args:
        new_args.update(args)
    new_args.update(kwargs)
    return new_args


def check_ported(args: Args) -> None:
    """Raise ValueError on a knob whose value selects a path the port does
    not run yet, instead of falling back to another path."""
    unported = []
    world = M.world_size()
    if int(args.get("mesh_batch_axis", -1)) not in (-1, 1, world):
        unported.append(f"mesh_batch_axis={args.mesh_batch_axis} (-1, 1 "
                        f"or the world size, {world}: the ranks of a "
                        "process group, one a device)")
    if unported:
        raise ValueError("not ported yet: " + "; ".join(unported))


# JSON round-trip (reference: alphazero/__init__.py:18-52, without eval).

def _encode(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _encode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    if callable(value):
        name = getattr(value, "__name__", None)
        if name is None:
            raise TypeError(f"Cannot serialize callable without __name__: "
                            f"{value!r}")
        _REGISTRY.setdefault(name, value)
        return _CALLABLE_PREFIX + name
    return value


def _decode(value: Any) -> Any:
    if isinstance(value, dict):
        return Args({k: _decode(v) for k, v in value.items()})
    if isinstance(value, list):
        return [_decode(v) for v in value]
    if isinstance(value, str) and value.startswith(_CALLABLE_PREFIX):
        return resolve_callable(value[len(_CALLABLE_PREFIX):])
    return value


def save_args_file(args: Args, filepath: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
    with open(filepath, "w") as f:
        json.dump(_encode(dict(args)), f, indent=2, sort_keys=True)


def load_args_file(filepath: str) -> Args:
    with open(filepath) as f:
        return _decode(json.load(f))
