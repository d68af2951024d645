"""Every call the benchmark makes into the system under test, the port
``alphazero_general_tpu_torch``, in one place: its env, its args, its
network wrapper and int8 tower, its move runners, its players and its
state. The benchmark takes nothing else from it."""

from __future__ import annotations

import importlib

from azbench import registry

PACKAGE = "alphazero_general_tpu_torch"


def _mod(name: str):
    return importlib.import_module(f"{PACKAGE}.{name}")


def env(cfg: dict):
    """The program's env class of a configuration."""
    return _mod("envs").get_env(cfg["env"])


def args(cfg: dict):
    """The program's args: its defaults with every key of the
    configuration's ``args`` set (nested dicts as its ``Args``)."""
    config = _mod("utils.config")
    merged = {k: config.Args(v) if isinstance(v, dict) else v
              for k, v in cfg["args"].items()}
    return config.get_args(**merged)


def wrapper(env_cls, args_, device, W: dict, cfg: dict):
    """The program's ``NNetWrapper`` with the benchmark's weights, loaded
    strictly under the names the configuration's network gives them
    (``registry.network(cfg).program_names``)."""
    wr = _mod("models.wrapper").NNetWrapper(env_cls, args_, device=device)
    names = registry.network(cfg).program_names(cfg)
    wr.model.load_state_dict({names[k]: x for k, x in W.items()})
    return wr


def selfplay(env_cls, args_):
    """(the self-play config of ``args_``, the selfplay module)."""
    sp = _mod("selfplay.selfplay")
    cfg = sp.SelfPlayConfig.from_args(args_, env_cls.NUM_PLAYERS,
                                      env_cls.HAS_DRAW)
    return cfg, sp


def search_module():
    return _mod("mcts.search")


def tree_t_module():
    return _mod("mcts.tree_t")


def mcts_player(net, env_cls, args_, seed: int):
    return _mod("players.players").MCTSPlayer(net, env_cls, args_,
                                              seed=seed)


def state_items(state) -> dict:
    return _mod("envs.core").state_items(state)
