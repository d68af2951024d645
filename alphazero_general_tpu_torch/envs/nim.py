"""Nim3 over batched tensors, the three-player counting game — the port of
alphazero_general_tpu/envs/nim.py.

A pile starts at ``PILE`` tokens; players move in fixed rotation, each
removing 1..3 tokens; whoever takes the last token wins. No draw can occur,
but the draw slot stays in the win vector (``value_size`` 4).
"""

from __future__ import annotations

import dataclasses

import torch

from alphazero_general_tpu_torch.envs.core import Env, EnvState

PILE = 15
NUM_PLAYERS = 3
MAX_TAKE = 3


@dataclasses.dataclass
class Nim3State(EnvState):
    pile: torch.Tensor = None  # int32[B], tokens remaining


class Nim3(Env):
    NAME = "nim3"
    NUM_PLAYERS = NUM_PLAYERS
    ACTION_SIZE = MAX_TAKE
    OBS_SHAPE = (1 + NUM_PLAYERS, 1, PILE + 1)
    MAX_TURNS = PILE
    HAS_DRAW = True  # never occurs; the slot is kept by convention
    NUM_SYMMETRIES = 1

    State = Nim3State

    @staticmethod
    def init(batch_size: int, device="cuda") -> Nim3State:
        z = torch.zeros((batch_size,), dtype=torch.int32, device=device)
        return Nim3State(player=z, turns=z.clone(), last_action=z - 1,
                         pile=z + PILE)

    @staticmethod
    def step(state: Nim3State, action: torch.Tensor) -> Nim3State:
        action = action.to(torch.int32)
        return Nim3State(
            player=(state.player + 1) % NUM_PLAYERS,
            turns=state.turns + 1,
            last_action=action,
            pile=torch.clamp(state.pile - (action + 1), min=0))

    @staticmethod
    def valid_moves(state: Nim3State) -> torch.Tensor:
        take = torch.arange(1, MAX_TAKE + 1, device=state.pile.device)
        return take[None, :] <= state.pile[:, None]

    @staticmethod
    def win_state(state: Nim3State) -> torch.Tensor:
        ended = state.pile == 0
        # Who just moved; ``%`` on tensors is a floor mod, like jnp's.
        winner = (state.player - 1) % NUM_PLAYERS
        seats = torch.arange(NUM_PLAYERS + 1, device=state.pile.device)
        return ((seats[None, :] == winner[:, None]) & ended[:, None]).to(
            torch.float32)

    @staticmethod
    def observation(state: Nim3State) -> torch.Tensor:
        dev = state.pile.device
        pile = (torch.arange(PILE + 1, device=dev)[None, :]
                == state.pile[:, None])
        seats = (torch.arange(NUM_PLAYERS, device=dev)[None, :, None]
                 == state.player[:, None, None]).expand(-1, -1, PILE + 1)
        return torch.cat([pile[:, None], seats], dim=1).to(
            torch.float32)[:, :, None, :]

    @classmethod
    def display(cls, state) -> str:
        """Game 0 of ``state`` as text, as the JAX env prints it
        (nim.py:93)."""
        return (f"pile={int(state.pile[0])} "
                f"to-move=P{int(state.player[0])}")


Game = Nim3
