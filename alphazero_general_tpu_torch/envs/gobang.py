"""Gobang (Gomoku) 15x15, five in a row, over batched tensors — the port
of alphazero_general_tpu/envs/gobang.py (reference:
alphazero/envs/gobang/gobang.pyx:25-32, GobangLogic.pyx).

Free placement on empty cells, a win with five in a row in any direction,
a draw on a full board; four observation planes as connect4's; 8 dihedral
symmetries.
"""

from __future__ import annotations

import dataclasses

import torch

from alphazero_general_tpu_torch.envs.core import (
    Env, EnvState, decided_value, dihedral,
)

N = 15
N_IN_ROW = 5
NUM_PLAYERS = 2
ACTION_SIZE = N * N
MAX_TURNS = N * N
NUM_CHANNELS = 4


@dataclasses.dataclass
class GobangState(EnvState):
    board: torch.Tensor = None  # int8[B, N, N]; +1 = player 0


def _five_hits(b: torch.Tensor) -> torch.Tensor:
    """bool[B]: whether each bool board of ``b`` [B, N, N] holds five in a
    row (JAX gobang.py:33)."""
    k = N_IN_ROW
    horiz = b[:, :, : -(k - 1)]
    vert = b[:, : -(k - 1), :]
    diag1 = b[:, : -(k - 1), : -(k - 1)]
    diag2 = b[:, (k - 1):, : -(k - 1)]
    for i in range(1, k):
        horiz = horiz & b[:, :, i: N - k + 1 + i]
        vert = vert & b[:, i: N - k + 1 + i, :]
        diag1 = diag1 & b[:, i: N - k + 1 + i, i: N - k + 1 + i]
        diag2 = diag2 & b[:, k - 1 - i: N - i, i: N - k + 1 + i]
    return (horiz.flatten(1).any(1) | vert.flatten(1).any(1)
            | diag1.flatten(1).any(1) | diag2.flatten(1).any(1))


class Gobang(Env):
    NAME = "gobang"
    NUM_PLAYERS = NUM_PLAYERS
    ACTION_SIZE = ACTION_SIZE
    OBS_SHAPE = (NUM_CHANNELS, N, N)
    MAX_TURNS = MAX_TURNS
    HAS_DRAW = True
    NUM_SYMMETRIES = 8

    State = GobangState

    @staticmethod
    def init(batch_size: int, device="cuda") -> GobangState:
        z = torch.zeros((batch_size,), dtype=torch.int32, device=device)
        return GobangState(
            player=z, turns=z.clone(), last_action=z - 1,
            board=torch.zeros((batch_size, N, N), dtype=torch.int8,
                              device=device))

    @staticmethod
    def step(state: GobangState, action: torch.Tensor) -> GobangState:
        action = action.to(torch.int32)
        B = action.shape[0]
        piece = torch.where(state.player == 0, 1, -1).to(torch.int8)
        flat = state.board.reshape(B, N * N).clone()
        flat[torch.arange(B, device=flat.device), action.long()] = piece
        return GobangState(
            player=(state.player + 1) % NUM_PLAYERS,
            turns=state.turns + 1,
            last_action=action,
            board=flat.reshape(B, N, N))

    @staticmethod
    def valid_moves(state: GobangState) -> torch.Tensor:
        return (state.board == 0).flatten(1)

    @staticmethod
    def win_state(state: GobangState) -> torch.Tensor:
        p0 = _five_hits(state.board == 1)
        p1 = _five_hits(state.board == -1) & ~p0
        draw = (state.board != 0).flatten(1).all(dim=1) & ~p0 & ~p1
        return torch.stack([p0, p1, draw], dim=1).to(torch.float32)

    @staticmethod
    def observation(state: GobangState) -> torch.Tensor:
        b = state.board
        shape = b.shape
        p0 = (b == 1).to(torch.float32)
        p1 = (b == -1).to(torch.float32)
        colour = state.player.to(torch.float32)[:, None, None].expand(shape)
        # XLA compiles the JAX env's ``turns / MAX_TURNS`` into a product
        # with the float32 reciprocal; the same product here keeps the
        # observations bit-identical.
        turn = (state.turns.to(torch.float32) * (1.0 / MAX_TURNS))[
            :, None, None].expand(shape)
        return torch.stack([p0, p1, colour, turn], dim=1)

    @staticmethod
    def crude_value(state: GobangState) -> torch.Tensor:
        return decided_value(Gobang.win_state(state), state.player)

    @classmethod
    def symmetries(cls, obs: torch.Tensor, pi: torch.Tensor):
        return dihedral(obs, pi, N)

    @classmethod
    def display(cls, state) -> str:
        """Game 0 of ``state`` as text, as the JAX env prints it
        (gobang.py:125)."""
        chars = {0: ".", 1: "X", -1: "O"}
        rows = [" ".join(chars[int(v)] for v in row)
                for row in state.board[0].tolist()]
        return "\n".join(rows)


Game = Gobang
