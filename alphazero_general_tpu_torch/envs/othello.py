"""Othello 8x8 over batched tensors — the port of
alphazero_general_tpu/envs/othello.py (reference:
alphazero/envs/othello/othello.pyx:17-120, OthelloLogic.pyx:28-198).

The rules are the JAX env's: the action space is the 64 squares with no
pass action, and the game ends the moment the player to move has no legal
move, scored by the piece difference. Player 0 plays +1.

Legal moves and flips are the JAX env's direction-shift propagation with
the 8 directions on a tensor axis: one gather shifts every direction's
board at once (``shift_each``), so a propagation step costs a few
launches for all 8 directions instead of a few for each.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from alphazero_general_tpu_torch.envs.core import Env, EnvState, dihedral

N = 8
NUM_PLAYERS = 2
ACTION_SIZE = N * N
MAX_TURNS = N * N

DIRECTIONS = [(1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1),
              (0, 1)]


@dataclasses.dataclass
class OthelloState(EnvState):
    board: torch.Tensor = None  # int8[B, N, N]; +1 = player 0


def shift_tables(H: int, W: int, deltas):
    """Gather tables of the zero-filled board shifts by ``deltas`` [(dr,
    dc), ...]: ``idx`` long [D, H·W] and ``onb`` bool [D, H·W] such that
    ``shift_each(x, idx, onb)[..., d, r*W + c]`` is ``x[..., r - dr, c - dc]``
    where that cell is on the board and False (0) elsewhere, i.e. the
    content moves by +(dr, dc). ``idx`` is clamped onto the board, so a
    gather never reads out of range."""
    idx = np.zeros((len(deltas), H * W), np.int64)
    onb = np.zeros((len(deltas), H * W), bool)
    for d, (dr, dc) in enumerate(deltas):
        for r in range(H):
            for c in range(W):
                sr, sc = r - dr, c - dc
                if 0 <= sr < H and 0 <= sc < W:
                    idx[d, r * W + c] = sr * W + sc
                    onb[d, r * W + c] = True
    return idx, onb


def shift_each(x: torch.Tensor, idx: torch.Tensor, onb: torch.Tensor):
    """Bool board d of ``x`` [..., D, H·W] shifted by delta d of
    ``shift_tables`` (two launches)."""
    return x.gather(-1, idx.expand(x.shape)) & onb


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    idx, onb = shift_tables(N, N, DIRECTIONS)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(onb).to(device))


def _propagate(seed, opp, tb):
    """The opponent chains that start next to ``seed`` [B, 8, 64] (one
    seed board per direction) and run along each direction: JAX
    ``_legal_mask``'s and ``_flips_for``'s inner loop."""
    chain = shift_each(seed, *tb) & opp
    for _ in range(N - 3):
        chain = chain | (shift_each(chain, *tb) & opp)
    return chain


def _legal_mask(flat, piece, tb):
    """bool[B, 64]: the legal placements for ``piece`` int8[B] on boards
    ``flat`` int8[B, 64]."""
    p = piece[:, None]
    own, opp, empty = flat == p, (flat == -p)[:, None], (flat == 0)[:, None]
    chain = _propagate(own[:, None].expand(-1, 8, -1), opp, tb)
    return (shift_each(chain, *tb) & empty).any(dim=1)


def _piece(player):
    return torch.where(player == 0, 1, -1).to(torch.int8)


class Othello(Env):
    NAME = "othello"
    NUM_PLAYERS = NUM_PLAYERS
    ACTION_SIZE = ACTION_SIZE
    OBS_SHAPE = (1, N, N)
    MAX_TURNS = MAX_TURNS
    HAS_DRAW = True
    NUM_SYMMETRIES = 8

    State = OthelloState

    @staticmethod
    def init(batch_size: int, device="cuda") -> OthelloState:
        z = torch.zeros((batch_size,), dtype=torch.int32, device=device)
        board = torch.zeros((batch_size, N, N), dtype=torch.int8,
                            device=device)
        h = N // 2
        board[:, h - 1, h] = 1
        board[:, h, h - 1] = 1
        board[:, h - 1, h - 1] = -1
        board[:, h, h] = -1
        return OthelloState(player=z, turns=z.clone(), last_action=z - 1,
                            board=board)

    @staticmethod
    def step(state: OthelloState, action: torch.Tensor) -> OthelloState:
        action = action.to(torch.int32)
        B = action.shape[0]
        tb = _tables(action.device)
        flat = state.board.reshape(B, N * N)
        piece = _piece(state.player)
        placed = torch.arange(N * N, device=flat.device)[None, :] \
            == action[:, None]
        p = piece[:, None]
        own, opp = (flat == p)[:, None], (flat == -p)[:, None]
        chain = _propagate(placed[:, None].expand(-1, 8, -1), opp, tb)
        # A chain captures iff the cell beyond its tip is our own piece.
        closed = (shift_each(chain, *tb) & own).any(dim=2, keepdim=True)
        flips = (chain & closed).any(dim=1)
        board = torch.where(flips | placed, p, flat)
        return OthelloState(
            player=(state.player + 1) % NUM_PLAYERS,
            turns=state.turns + 1,
            last_action=action,
            board=board.reshape(B, N, N))

    @staticmethod
    def valid_moves(state: OthelloState) -> torch.Tensor:
        B = state.board.shape[0]
        return _legal_mask(state.board.reshape(B, N * N),
                           _piece(state.player), _tables(state.board.device))

    @staticmethod
    def win_state(state: OthelloState) -> torch.Tensor:
        return Othello.win_and_valids(state)[0]

    @staticmethod
    def win_and_valids(state: OthelloState):
        """(win_state, valid_moves) from one legal-move mask: terminal iff
        the player to move has none (othello.pyx:85-97), won by the piece
        difference."""
        valid = Othello.valid_moves(state)
        no_moves = ~valid.any(dim=1)
        total = state.board.flatten(1).to(torch.int32).sum(dim=1)
        diff = total * torch.where(state.player == 0, 1, -1)
        me_won, opp_won = no_moves & (diff > 0), no_moves & (diff < 0)
        p0 = torch.where(state.player == 0, me_won, opp_won)
        p1 = torch.where(state.player == 0, opp_won, me_won)
        win = torch.stack([p0, p1, no_moves & (diff == 0)], dim=1)
        return win.to(torch.float32), valid

    @staticmethod
    def observation(state: OthelloState) -> torch.Tensor:
        return state.board.to(torch.float32)[:, None]

    @classmethod
    def symmetries(cls, obs: torch.Tensor, pi: torch.Tensor):
        return dihedral(obs, pi, N)

    @staticmethod
    def crude_value(state: OthelloState) -> torch.Tensor:
        """Piece-difference heuristic in [0, 1] from the mover's view."""
        piece = _piece(state.player).to(torch.int32)
        diff = state.board.flatten(1).to(torch.int32).sum(dim=1) * piece
        return 0.5 + 0.5 * torch.tanh(diff.to(torch.float32) / 16.0)

    @classmethod
    def display(cls, state) -> str:
        """Game 0 of ``state`` as text, as the JAX env prints it
        (othello.py:183)."""
        chars = {0: ".", 1: "W", -1: "b"}
        rows = [" ".join(chars[int(v)] for v in row)
                for row in state.board[0].tolist()]
        return "\n".join(rows)


Game = Othello
