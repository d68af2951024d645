"""TicTacToe over batched tensors — the port of
alphazero_general_tpu/envs/tictactoe.py (reference:
alphazero/envs/tictactoe/tictactoe.py:15-102).

The board is int8 ``[B, 3, 3]``: +1 for player 0, -1 for player 1.
"""

from __future__ import annotations

import dataclasses

import torch

from alphazero_general_tpu_torch.envs.core import (
    Env, EnvState, decided_value, dihedral,
)

N = 3
NUM_PLAYERS = 2
ACTION_SIZE = N * N
MAX_TURNS = N * N


@dataclasses.dataclass
class TicTacToeState(EnvState):
    board: torch.Tensor = None  # int8[B, N, N]


class TicTacToe(Env):
    NAME = "tictactoe"
    NUM_PLAYERS = NUM_PLAYERS
    ACTION_SIZE = ACTION_SIZE
    OBS_SHAPE = (1, N, N)
    MAX_TURNS = MAX_TURNS
    HAS_DRAW = True
    NUM_SYMMETRIES = 8

    State = TicTacToeState

    @staticmethod
    def init(batch_size: int, device="cuda") -> TicTacToeState:
        z = torch.zeros((batch_size,), dtype=torch.int32, device=device)
        return TicTacToeState(
            player=z, turns=z.clone(), last_action=z - 1,
            board=torch.zeros((batch_size, N, N), dtype=torch.int8,
                              device=device))

    @staticmethod
    def step(state: TicTacToeState, action: torch.Tensor) -> TicTacToeState:
        action = action.to(torch.int32)
        B = action.shape[0]
        piece = torch.where(state.player == 0, 1, -1).to(torch.int8)
        flat = state.board.reshape(B, N * N).clone()
        flat[torch.arange(B, device=flat.device), action.long()] = piece
        return TicTacToeState(
            player=(state.player + 1) % NUM_PLAYERS,
            turns=state.turns + 1,
            last_action=action,
            board=flat.reshape(B, N, N))

    @staticmethod
    def valid_moves(state: TicTacToeState) -> torch.Tensor:
        return (state.board == 0).flatten(1)

    @staticmethod
    def win_state(state: TicTacToeState) -> torch.Tensor:
        def wins(piece):
            b = state.board == piece
            rows = b.all(dim=2).any(dim=1)
            cols = b.all(dim=1).any(dim=1)
            d1 = b.diagonal(dim1=1, dim2=2).all(dim=1)
            d2 = b.flip(-1).diagonal(dim1=1, dim2=2).all(dim=1)
            return rows | cols | d1 | d2

        p0 = wins(1)
        p1 = wins(-1) & ~p0
        draw = (state.board != 0).flatten(1).all(dim=1) & ~p0 & ~p1
        return torch.stack([p0, p1, draw], dim=1).to(torch.float32)

    @staticmethod
    def observation(state: TicTacToeState) -> torch.Tensor:
        return state.board.to(torch.float32)[:, None]

    @staticmethod
    def crude_value(state: TicTacToeState) -> torch.Tensor:
        return decided_value(TicTacToe.win_state(state), state.player)

    @classmethod
    def symmetries(cls, obs: torch.Tensor, pi: torch.Tensor):
        return dihedral(obs, pi, N)

    @classmethod
    def display(cls, state) -> str:
        """Game 0 of ``state`` as text, as the JAX env prints it
        (tictactoe.py:111)."""
        chars = {0: ".", 1: "O", -1: "X"}
        rows = [" ".join(chars[int(v)] for v in row)
                for row in state.board[0].tolist()]
        return "\n".join(rows)


Game = TicTacToe
