"""Environment API over batched tensors — the port of the JAX package's
``envs/core.py`` contract (alphazero_general_tpu/envs/core.py:56-126).

The JAX env functions take ONE unbatched state and are batched with
``vmap``; here every function takes a batch of ``B`` games directly. A state
is a dataclass of tensors whose leading axis is the game batch, and each
function returns new tensors (it never writes into its inputs).

=====================  ======================================================
JAX (one game)         here (a batch of B games)
=====================  ======================================================
``init()``             ``init(batch_size, device)``
``step(s, a)``         ``step(state, action i32[B])``
``valid_moves(s)``     ``valid_moves(state) -> bool[B, A]``
``win_state(s)``       ``win_state(state) -> f32[B, NUM_PLAYERS + 1]``
``observation(s)``     ``observation(state) -> f32[B, C, H, W]``
``symmetries(o, p)``   ``symmetries(obs, pi) -> (obs[B, K, ...], pi[B, K, A])``
``crude_value(s)``     ``crude_value(state) -> f32[B]`` (optional)
``display(s)``         ``display(state) -> str`` (game 0 of the batch)
=====================  ======================================================

``win_and_valids(state)`` returns both results of ``win_state`` and
``valid_moves``; the search calls it once per simulation.

``win_state`` keeps the reference convention: one slot per player set to 1.0
on a win, the last slot 1.0 on a draw, all zeros while the game runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Type

import torch


@dataclasses.dataclass
class EnvState:
    """Fields every env state has, each with the game batch leading."""

    player: torch.Tensor  # int32[B], 0..NUM_PLAYERS-1
    turns: torch.Tensor  # int32[B]
    last_action: torch.Tensor  # int32[B], -1 before the first move


def state_items(state: EnvState) -> Dict[str, torch.Tensor]:
    """Name → tensor of every field of ``state``, in declaration order."""
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


class Env:
    """Static-function environment over batched states."""

    NAME: str = "env"
    NUM_PLAYERS: int = 2
    ACTION_SIZE: int = 0
    OBS_SHAPE: Tuple[int, int, int] = (1, 1, 1)  # (C, H, W)
    MAX_TURNS: int = 0
    HAS_DRAW: bool = True
    #: number of symmetric copies returned by ``symmetries``
    NUM_SYMMETRIES: int = 1
    #: True when ``step`` always advances ``player = (player + 1) % N`` (every
    #: built-in env). The arena's owner routing relies on it (JAX
    #: envs/core.py:66-72); an env that skips a player's turn sets False and
    #: gets the evaluate-every-game path.
    ALTERNATES: bool = True

    State: Type[EnvState] = EnvState

    @staticmethod
    def init(batch_size: int, device="cuda") -> EnvState:
        raise NotImplementedError

    @staticmethod
    def step(state: EnvState, action: torch.Tensor) -> EnvState:
        """Apply ``action`` (assumed legal) and advance player and turn."""
        raise NotImplementedError

    @staticmethod
    def valid_moves(state: EnvState) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def win_state(state: EnvState) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def observation(state: EnvState) -> torch.Tensor:
        raise NotImplementedError

    @classmethod
    def symmetries(cls, obs: torch.Tensor, pi: torch.Tensor):
        """Stacked symmetric copies on axis 1; index 0 is the identity."""
        return obs[:, None], pi[:, None]

    @classmethod
    def win_and_valids(cls, state: EnvState):
        """(win_state, valid_moves) together; an env whose two share work
        (tafl's move generator) computes it once (JAX tree._win_valids)."""
        return cls.win_state(state), cls.valid_moves(state)

    @staticmethod
    def crude_value(state: EnvState) -> torch.Tensor:
        """Cheap heuristic value f32[B] in [0, 1] for greedy baselines
        (reference: envs/brandubh/fastafl.pyx:258-268). Optional."""
        raise NotImplementedError

    @classmethod
    def display(cls, state: EnvState) -> str:
        """Game 0 of ``state`` as text (each env prints its board)."""
        return repr({k: x[0].tolist() for k, x in state_items(state).items()})

    @classmethod
    def terminated(cls, state: EnvState) -> torch.Tensor:
        return torch.any(cls.win_state(state) > 0, dim=-1)


def dihedral(obs: torch.Tensor, pi: torch.Tensor, n: int):
    """The 8 dihedral images of square boards ``obs`` [B, C, n, n] and
    policies ``pi`` [B, n*n], stacked on axis 1 in the JAX envs' order
    (rot = 0..3 quarter turns as np.rot90, each then without and with a
    left/right flip)."""
    B = pi.shape[0]
    pb = pi.reshape(B, n, n)
    obs_list, pi_list = [], []
    for rot in range(4):
        o = torch.rot90(obs, rot, dims=(2, 3))
        p = torch.rot90(pb, rot, dims=(1, 2))
        for flip in (False, True):
            obs_list.append(o.flip(-1) if flip else o)
            pi_list.append((p.flip(-1) if flip else p).reshape(B, n * n))
    return torch.stack(obs_list, dim=1), torch.stack(pi_list, dim=1)


def decided_value(win: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
    """Mover-perspective value of a two-player win vector: 1 if the player
    to move has won, 0 if the other has, else 0.5 (JAX tictactoe.py:84)."""
    games = torch.arange(win.shape[0], device=win.device)
    me = win[games, player.long()]
    opp = win[games, ((player + 1) % 2).long()]
    return torch.where(me > 0, 1.0, torch.where(opp > 0, 0.0, 0.5))
