"""Environment registry (the port of alphazero_general_tpu/envs/__init__.py).

Ported so far: connect4 and the tafl variants brandubh and hnefatafl; the
other envs follow in later slices.
"""

from __future__ import annotations

from typing import Dict, Type

from alphazero_general_tpu_torch.envs.connect4 import Connect4
from alphazero_general_tpu_torch.envs.core import Env, EnvState  # noqa: F401
from alphazero_general_tpu_torch.envs.tafl import Brandubh, Hnefatafl

_ENVS: Dict[str, Type[Env]] = {
    e.NAME: e for e in (Connect4, Brandubh, Hnefatafl)}


def list_envs():
    return sorted(_ENVS)


def get_env(name: str) -> Type[Env]:
    if name not in _ENVS:
        raise KeyError(f"Unknown env {name!r}. Available: {sorted(_ENVS)}")
    return _ENVS[name]

