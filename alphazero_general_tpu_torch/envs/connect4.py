"""Connect4 over batched tensors — the port of
alphazero_general_tpu/envs/connect4.py (reference:
alphazero/envs/connect4/connect4.pyx:11-108, Connect4Logic.pyx:14-110).

The board is int8 ``[B, 6, 7]``: +1 for player 0's stones, -1 for player
1's, 0 for empty; row 0 is the top, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from alphazero_general_tpu_torch.envs.core import (
    Env, EnvState, decided_value,
)

HEIGHT = 6
WIDTH = 7
WIN_LENGTH = 4
NUM_PLAYERS = 2
MAX_TURNS = HEIGHT * WIDTH  # 42
NUM_CHANNELS = 4


@dataclasses.dataclass
class Connect4State(EnvState):
    board: torch.Tensor = None  # int8[B, HEIGHT, WIDTH]


def _line_hits(b: torch.Tensor) -> torch.Tensor:
    """bool[B]: whether each bool board of ``b`` [B, H, W] holds
    WIN_LENGTH in a row (the shifted-slice conjunctions of the JAX env)."""
    k = WIN_LENGTH
    horiz = b[:, :, : -(k - 1)]
    vert = b[:, : -(k - 1), :]
    diag1 = b[:, : -(k - 1), : -(k - 1)]
    diag2 = b[:, (k - 1):, : -(k - 1)]
    for i in range(1, k):
        horiz = horiz & b[:, :, i: WIDTH - k + 1 + i]
        vert = vert & b[:, i: HEIGHT - k + 1 + i, :]
        diag1 = diag1 & b[:, i: HEIGHT - k + 1 + i, i: WIDTH - k + 1 + i]
        diag2 = diag2 & b[:, k - 1 - i: HEIGHT - i, i: WIDTH - k + 1 + i]
    return (horiz.flatten(1).any(1) | vert.flatten(1).any(1)
            | diag1.flatten(1).any(1) | diag2.flatten(1).any(1))


class Connect4(Env):
    NAME = "connect4"
    NUM_PLAYERS = NUM_PLAYERS
    ACTION_SIZE = WIDTH
    OBS_SHAPE = (NUM_CHANNELS, HEIGHT, WIDTH)
    MAX_TURNS = MAX_TURNS
    HAS_DRAW = True
    NUM_SYMMETRIES = 2  # identity + left/right mirror (connect4.pyx:96-99)

    State = Connect4State

    @staticmethod
    def init(batch_size: int, device="cuda") -> Connect4State:
        z = torch.zeros((batch_size,), dtype=torch.int32, device=device)
        return Connect4State(
            player=z, turns=z.clone(), last_action=z - 1,
            board=torch.zeros((batch_size, HEIGHT, WIDTH), dtype=torch.int8,
                              device=device),
        )

    @staticmethod
    def step(state: Connect4State, action: torch.Tensor) -> Connect4State:
        action = action.to(torch.int32)
        B = action.shape[0]
        games = torch.arange(B, device=action.device)
        col = state.board[games, :, action.long()]  # [B, H]
        filled = col.abs().sum(dim=1)
        # Landing row counted from the top. A full column gives row -1, which
        # wraps to the bottom row exactly as the JAX env's ``.at[-1]`` does
        # (only junk slots of the search ever step a full column).
        row = (HEIGHT - 1 - filled) % HEIGHT
        piece = torch.where(state.player == 0, 1, -1).to(torch.int8)
        board = state.board.clone()
        board[games, row, action.long()] = piece
        return Connect4State(
            player=(state.player + 1) % NUM_PLAYERS,
            turns=state.turns + 1,
            last_action=action,
            board=board,
        )

    @staticmethod
    def valid_moves(state: Connect4State) -> torch.Tensor:
        # Any empty cell in the top row (Connect4Logic.pyx:50-58).
        return state.board[:, 0, :] == 0

    @staticmethod
    def win_state(state: Connect4State) -> torch.Tensor:
        p0 = _line_hits(state.board == 1)
        p1 = _line_hits(state.board == -1)
        full = torch.all(state.board[:, 0, :] != 0, dim=1)
        draw = full & ~p0 & ~p1
        return torch.stack([p0, p1 & ~p0, draw], dim=1).to(torch.float32)

    @staticmethod
    def observation(state: Connect4State) -> torch.Tensor:
        # 4 planes: player-0 stones, player-1 stones, colour to move, turn
        # fraction (connect4.pyx:84-91).
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
    def crude_value(state: Connect4State) -> torch.Tensor:
        """1 / 0 on a decided game from the mover's view, else 0.5 (JAX
        connect4.py:125)."""
        return decided_value(Connect4.win_state(state), state.player)

    @classmethod
    def symmetries(cls, obs: torch.Tensor, pi: torch.Tensor):
        return (torch.stack([obs, obs.flip(-1)], dim=1),
                torch.stack([pi, pi.flip(-1)], dim=1))

    @classmethod
    def display(cls, state) -> str:
        """Game 0 of ``state`` as text, as the JAX env prints it
        (connect4.py:134)."""
        chars = {0: ".", 1: "X", -1: "O"}
        rows = [" ".join(chars[int(v)] for v in row)
                for row in state.board[0].tolist()]
        rows.append(" ".join(map(str, range(WIDTH))))
        return "\n".join(rows)


Game = Connect4
