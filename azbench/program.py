"""Every call the benchmark makes into the system under test, the port
``alphazero_general_tpu_torch``, in one place: its env, its args, its
network wrapper and int8 tower, its move runners, its players and its
state. The benchmark takes nothing else from it."""

from __future__ import annotations

import importlib

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


def program_state_dict(W: dict, cfg: dict) -> dict:
    """The benchmark's named weights under the program's ResNet names."""
    rename = {"conv": "weight"}
    bn = {"weight": "weight", "bias": "bias", "mean": "running_mean",
          "var": "running_var"}
    out = {}
    for name, x in W.items():
        parts = name.split(".")
        if parts[0] == "stem":
            key = "stem_conv.weight" if parts[1] == "conv" \
                else f"stem_norm.{bn[parts[2]]}"
        elif parts[0].startswith("block"):
            i = parts[0][5:]
            kind, j = parts[1][:-1], parts[1][-1]
            key = (f"blocks.{i}.conv{j}.weight" if kind == "conv"
                   else f"blocks.{i}.norm{j}.{bn[parts[2]]}")
        elif parts[0] in ("vhead", "phead"):
            head = "value" if parts[0] == "vhead" else "policy"
            key = f"{head}_conv.weight" if parts[1] == "conv" \
                else f"{head}_norm.{bn[parts[2]]}"
        else:
            head = "value" if parts[0].startswith("v") else "policy"
            key = f"{head}_mlp.layers.{parts[0][4:]}.{rename.get(parts[1], parts[1])}"
        out[key] = x
    return out


def benchmark_names(cfg: dict, W: dict) -> dict:
    """program name -> benchmark name, for the weights of ``W``."""
    return {p: b for b, p in zip(W, program_state_dict(W, cfg))}


def wrapper(env_cls, args_, device, W: dict, cfg: dict):
    """The program's ``NNetWrapper`` with the benchmark's weights."""
    wr = _mod("models.wrapper").NNetWrapper(env_cls, args_, device=device)
    wr.model.load_state_dict(program_state_dict(W, cfg))
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
