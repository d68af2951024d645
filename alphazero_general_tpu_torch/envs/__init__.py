"""Environment registry (the port of alphazero_general_tpu/envs/__init__.py):
the same nine envs."""

from __future__ import annotations

from typing import Dict, Type

from alphazero_general_tpu_torch.envs.chess import Chess
from alphazero_general_tpu_torch.envs.connect4 import Connect4
from alphazero_general_tpu_torch.envs.core import Env, EnvState  # noqa: F401
from alphazero_general_tpu_torch.envs.gobang import Gobang
from alphazero_general_tpu_torch.envs.nim import Nim3
from alphazero_general_tpu_torch.envs.othello import Othello
from alphazero_general_tpu_torch.envs.stratego import Stratego
from alphazero_general_tpu_torch.envs.tafl import Brandubh, Hnefatafl
from alphazero_general_tpu_torch.envs.tictactoe import TicTacToe

_ENVS: Dict[str, Type[Env]] = {
    e.NAME: e for e in (Connect4, TicTacToe, Othello, Gobang, Brandubh,
                        Hnefatafl, Stratego, Chess, Nim3)}


def list_envs():
    return sorted(_ENVS)


def get_env(name: str) -> Type[Env]:
    if name not in _ENVS:
        raise KeyError(f"Unknown env {name!r}. Available: {sorted(_ENVS)}")
    return _ENVS[name]
