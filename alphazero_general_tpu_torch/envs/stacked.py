"""Observation history stacking, a generic env wrapper — the port of
alphazero_general_tpu/envs/stacked.py (reference: Coach.py:53
``num_stacked_observations``; envs/brandubh/fastafl.pyx:106-121).

The state carries the last k-1 observations and the observation is their
channel concatenation [k*C, H, W], newest first, with zero planes before
the game has that much history.

The JAX ``StackedState`` nests the base state under ``inner``. Here the
state is FLAT: the base state's own fields plus ``past_obs`` [B, k-1, C, H,
W], one dataclass field each, because the search trees snapshot a state
one tensor per field (``state_items``, ``tree_t.init_tree_t``); the base
state is rebuilt from those fields inside the wrapper (``inner``). Each
tree node therefore stores (k-1)·C·H·W floats more than the base env's
nodes do: at chess (20 x 8 x 8 planes) with k = 8 that is 8,960 floats a
node, about 1.8 GB for a fresh tree of 256 games x 203 rows.
"""

from __future__ import annotations

import dataclasses

import torch

from alphazero_general_tpu_torch.envs.core import Env


def make_stacked_env(base: type, k: int) -> type:
    """Wrap ``base`` so that observations stack its last ``k`` frames."""
    assert k >= 2, "use the base env for k == 1"
    C, H, W = base.OBS_SHAPE
    base_fields = tuple(f.name for f in dataclasses.fields(base.State))

    State = dataclasses.make_dataclass(
        f"{base.State.__name__}X{k}",
        [("past_obs", torch.Tensor, dataclasses.field(default=None))],
        bases=(base.State,))

    def inner(state):
        """The base env's state held in ``state``'s fields."""
        return base.State(**{n: getattr(state, n) for n in base_fields})

    def wrap(inner_state, past_obs):
        return State(**{n: getattr(inner_state, n) for n in base_fields},
                     past_obs=past_obs)

    class Stacked(Env):
        NAME = f"{base.NAME}_x{k}"
        NUM_PLAYERS = base.NUM_PLAYERS
        ACTION_SIZE = base.ACTION_SIZE
        OBS_SHAPE = (C * k, H, W)
        MAX_TURNS = base.MAX_TURNS
        HAS_DRAW = base.HAS_DRAW
        NUM_SYMMETRIES = base.NUM_SYMMETRIES
        ALTERNATES = base.ALTERNATES
        BASE = base
        STACK = k

        @staticmethod
        def init(batch_size: int, device="cuda"):
            return wrap(base.init(batch_size, device),
                        torch.zeros((batch_size, k - 1, C, H, W),
                                    dtype=torch.float32, device=device))

        @staticmethod
        def step(state, action):
            s = inner(state)
            cur = base.observation(s)[:, None]
            past = cur if k == 2 else torch.cat(
                [cur, state.past_obs[:, : k - 2]], dim=1)
            return wrap(base.step(s, action), past)

        @staticmethod
        def valid_moves(state):
            return base.valid_moves(inner(state))

        @staticmethod
        def win_state(state):
            return base.win_state(inner(state))

        @classmethod
        def win_and_valids(cls, state):
            return base.win_and_valids(inner(state))

        @staticmethod
        def observation(state):
            cur = base.observation(inner(state))[:, None]
            return torch.cat([cur, state.past_obs], dim=1).reshape(
                (cur.shape[0], k * C, H, W))

        @classmethod
        def symmetries(cls, obs, pi):
            """The base env's (spatial) transforms applied frame by frame;
            the policies are those of the newest frame (JAX :90-107)."""
            frames = obs.reshape((obs.shape[0], k, C, H, W))
            syms = [base.symmetries(frames[:, f], pi) for f in range(k)]
            return torch.cat([o for o, _ in syms], dim=2), syms[0][1]

        @staticmethod
        def crude_value(state):
            return base.crude_value(inner(state))

        @classmethod
        def display(cls, state):
            return base.display(inner(state))

    Stacked.State = State
    Stacked.inner = staticmethod(inner)
    Stacked.__name__ = f"{base.__name__}X{k}"
    return Stacked


def maybe_stack(env: type, args) -> type:
    """Apply ``args.num_stacked_observations`` if > 1 (Coach.py:53)."""
    k = int(args.get("num_stacked_observations", 1) or 1)
    return make_stacked_env(env, k) if k > 1 else env
