"""Environment registry (the port of alphazero_general_tpu/envs/__init__.py).

Only connect4 is ported so far; the other envs follow in later slices.
"""

from __future__ import annotations

from typing import Dict, Type

from alphazero_general_tpu_torch.envs.connect4 import Connect4
from alphazero_general_tpu_torch.envs.core import Env, EnvState  # noqa: F401

_ENVS: Dict[str, Type[Env]] = {Connect4.NAME: Connect4}


def list_envs():
    return sorted(_ENVS)


def get_env(name: str) -> Type[Env]:
    if name not in _ENVS:
        raise KeyError(f"Unknown env {name!r}. Available: {sorted(_ENVS)}")
    return _ENVS[name]

