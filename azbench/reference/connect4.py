"""Connect Four, one game at a time in NumPy, and random playouts of many
games at once in plain PyTorch (the benchmark's own generator of
observations).

A state is a dict of the fields the game is described by: ``board`` int8
[6, 7] (row 0 the top; +1 the first player's stones, -1 the second's),
``player`` (0 or 1, to move), ``turns`` and ``last_action`` (-1 before the
first move). The first player to line up four stones in a row, a column or
a diagonal wins; a full board without a line is a draw. The observation has
four planes: the first player's stones, the second's, the player to move,
and the turn count over 42 (as a float32 product with 1/42).
"""

from __future__ import annotations

import numpy as np
import torch

H, W, K = 6, 7, 4
F32 = np.float32


class Connect4:
    num_players = 2
    has_draw = True
    action_size = W
    obs_shape = (4, H, W)

    @staticmethod
    def init() -> dict:
        return {"player": np.int32(0), "turns": np.int32(0),
                "last_action": np.int32(-1),
                "board": np.zeros((H, W), np.int8)}

    @staticmethod
    def valid(s: dict) -> np.ndarray:
        return s["board"][0] == 0

    @staticmethod
    def step(s: dict, a: int) -> dict:
        board = s["board"].copy()
        col = board[:, a]
        empty = np.flatnonzero(col == 0)
        if len(empty) == 0:
            raise ValueError(f"column {a} is full")
        board[empty[-1], a] = 1 if s["player"] == 0 else -1
        return {"player": np.int32((s["player"] + 1) % 2),
                "turns": np.int32(s["turns"] + 1),
                "last_action": np.int32(a), "board": board}

    @staticmethod
    def _four(mask: np.ndarray) -> bool:
        for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
            for r in range(H):
                for c in range(W):
                    rr, cc = r + (K - 1) * dr, c + (K - 1) * dc
                    if not (0 <= rr < H and 0 <= cc < W):
                        continue
                    if all(mask[r + i * dr, c + i * dc] for i in range(K)):
                        return True
        return False

    @classmethod
    def win(cls, s: dict) -> np.ndarray:
        first = cls._four(s["board"] == 1)
        second = cls._four(s["board"] == -1) and not first
        draw = bool((s["board"][0] != 0).all()) and not first and not second
        return np.array([first, second, draw], F32)

    @staticmethod
    def obs(s: dict) -> np.ndarray:
        b = s["board"]
        turn = F32(s["turns"]) * F32(1.0 / (H * W))
        return np.stack([(b == 1).astype(F32), (b == -1).astype(F32),
                         np.full((H, W), F32(s["player"])),
                         np.full((H, W), turn, F32)])


def make(rules: dict):
    return Connect4


def _line_kernels(device) -> torch.Tensor:
    """[4, 1, 4, 4] 0/1 kernels of the row, column and both diagonals."""
    k = torch.zeros((4, 1, K, K), dtype=torch.float32)
    k[0, 0, 0, :] = 1
    k[1, 0, :, 0] = 1
    k[2, 0] = torch.eye(K)
    k[3, 0] = torch.eye(K).flip(-1)
    return k.to(device)


def _has_four(stones: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """bool[B]: whether each 0/1 board [B, H, W] holds four in a line."""
    x = torch.nn.functional.pad(stones[:, None].float(), (0, K - 1, 0, K - 1))
    hits = torch.nn.functional.conv2d(x, kernels)
    return (hits >= K - 0.5).flatten(1).any(1)


@torch.no_grad()
def playouts(games: int, moves: int, generator: torch.Generator,
             device) -> dict:
    """Random playouts of ``games`` games for ``moves`` moves on the
    device, a game that ends starting again from the empty board. Returns
    the observation of every position before a move, [moves · games, 4, H,
    W] float32 in move-major order, and the valid actions of each, bool
    [moves · games, W]."""
    kern = _line_kernels(device)
    board = torch.zeros((games, H, W), dtype=torch.int8, device=device)
    player = torch.zeros(games, dtype=torch.int32, device=device)
    turns = torch.zeros(games, dtype=torch.int32, device=device)
    rows = torch.arange(games, device=device)
    obs, valid = [], []
    for _ in range(moves):
        v = board[:, 0] == 0
        obs.append(torch.stack([
            (board == 1).float(), (board == -1).float(),
            player.float()[:, None, None].expand(games, H, W),
            (turns.float() * (1.0 / (H * W)))[:, None, None]
            .expand(games, H, W)], 1))
        valid.append(v)
        a = torch.multinomial(v.float(), 1, generator=generator)[:, 0]
        filled = (board[rows, :, a] != 0).sum(1)
        piece = torch.where(player == 0, 1, -1).to(torch.int8)
        board[rows, H - 1 - filled, a] = piece
        player = 1 - player
        turns = turns + 1
        won = _has_four(board == 1, kern) | _has_four(board == -1, kern)
        ended = won | (board[:, 0] != 0).all(1)
        board[ended] = 0
        player = torch.where(ended, 0, player)
        turns = torch.where(ended, 0, turns)
    return {"obs": torch.cat(obs), "valid": torch.cat(valid)}
