"""Players for interactive play, pit scripts and tournaments — the port of
alphazero_general_tpu/players/players.py (reference:
alphazero/GenericPlayers.py:12-200).

A player takes the state of ONE game (a batch of one: every field's
leading axis is 1) and returns an action. Each player moves the state to
its own device first: the network's for ``NNPlayer`` and ``MCTSPlayer``,
``device`` (default ``cuda``) for the others that search. Action choices
come from numpy generators seeded as the JAX package seeds them, so the
same seed and the same search give the same moves. Every random draw of a
search (the root's Dirichlet noise, the tie noise of each prior install)
comes from a ``torch.Generator`` on the player's device, or from
``draws`` (an ``mcts.search.SearchDraws``) passed to ``play``.

Large-scale evaluation uses the batched arena instead (selfplay/arena.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from alphazero_general_tpu_torch.envs.core import state_items
from alphazero_general_tpu_torch.mcts import search as S
from alphazero_general_tpu_torch.mcts import tree as T


def one_game(state, device=None):
    """``state`` checked to hold one game, on ``device`` where given."""
    if int(state.player.shape[0]) != 1:
        raise ValueError("a player takes the state of one game (a batch of "
                         f"1), got a batch of {int(state.player.shape[0])}")
    if device is None:
        return state
    return type(state)(**{k: x.to(device)
                          for k, x in state_items(state).items()})


def repeat_game(state, k: int):
    """``k`` copies of the one game of ``state``, as one batch."""
    return type(state)(**{name: x.expand(k, *x.shape[1:]).contiguous()
                          for name, x in state_items(state).items()})


def valid_actions(env, state) -> np.ndarray:
    """The valid actions of the one game of ``state``, ascending."""
    return np.flatnonzero(env.valid_moves(state)[0].cpu().numpy())


class BasePlayer:
    """Contract (GenericPlayers.py:12-44)."""

    def __init__(self, game_cls=None, args=None, verbose: bool = False):
        self.game_cls = game_cls
        self.args = args
        self.verbose = verbose

    def __call__(self, state) -> int:
        return self.play(state)

    @staticmethod
    def supports_process() -> bool:
        return False

    @staticmethod
    def requires_model() -> bool:
        return False

    @staticmethod
    def is_human() -> bool:
        return False

    def play(self, state) -> int:
        raise NotImplementedError

    def update(self, state, action: int) -> None:
        """Observe a move by any player (tree reuse hook)."""

    def reset(self) -> None:
        pass


class RandomPlayer(BasePlayer):
    """Uniform random over valid moves (GenericPlayers.py:47-52)."""

    def __init__(self, game_cls=None, args=None, seed: int = 0, **kw):
        super().__init__(game_cls, args, **kw)
        self._rng = np.random.default_rng(seed)

    def play(self, state) -> int:
        return int(self._rng.choice(valid_actions(self.game_cls,
                                                  one_game(state))))


class NNPlayer(BasePlayer):
    """Raw policy sampling with temperature (GenericPlayers.py:55-97)."""

    def __init__(self, nn, game_cls=None, args=None,
                 temp: Optional[float] = None, seed: int = 0, **kw):
        super().__init__(game_cls or nn.env, args or nn.args, **kw)
        self.nn = nn
        self.temp = temp if temp is not None else float(self.args.startTemp)
        self._rng = np.random.default_rng(seed)

    @staticmethod
    def supports_process() -> bool:
        return True

    @staticmethod
    def requires_model() -> bool:
        return True

    def play(self, state) -> int:
        state = one_game(state, self.nn.device)
        pi, _ = self.nn.process(self.game_cls.observation(state))
        pi = pi[0].to(torch.float32).cpu().numpy()
        valids = self.game_cls.valid_moves(state)[0].cpu().numpy()
        pi = pi * valids
        pi = pi / pi.sum()
        if self.temp <= 1e-6:
            return int(np.argmax(pi))
        p = pi ** (1.0 / self.temp)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    def process(self, obs_batch):
        return self.nn.process(obs_batch)


class MCTSPlayer(BasePlayer):
    """A full search per move (GenericPlayers.py:100-163): a fresh
    batch-major tree of ``numMCTSSims + 2`` rows, searched by
    ``mcts.search.search``'s host loop of one simulation at a time, each
    with one network call (the JAX player's loop, players.py:179-195). ``update`` is a no-op: the tree is
    not reused across moves.

    After ``play``: ``last_value`` (the root value, the max or with
    ``average_value`` the mean of its children's q), ``last_depth`` (the
    deepest walk), ``last_policy`` and ``last_tree``.
    """

    def __init__(self, nn, game_cls=None, args=None, seed: int = 0,
                 verbose: bool = False, average_value: bool = False,
                 device=None, **kw):
        super().__init__(game_cls or (nn.env if nn else None),
                         args or (nn.args if nn else None), verbose=verbose)
        self.nn = nn
        self.average_value = average_value
        self.device = torch.device(
            device if device is not None else nn.device if nn else "cuda")
        self.temp = float(self.args.startTemp)
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self._generator = None
        env = self.game_cls
        self.spec = T.SearchSpec(
            cpuct=float(self.args.cpuct),
            fpu_reduction=float(self.args.fpu_reduction),
            root_policy_temp=float(self.args.root_policy_temp),
            root_noise_frac=float(self.args.root_noise_frac),
            min_discount=float(self.args.min_discount),
            add_root_noise=bool(self.args.add_root_noise),
            add_root_temp=bool(self.args.add_root_temp),
            num_players=env.NUM_PLAYERS,
            has_draw=env.HAS_DRAW,
        )
        self.eval_fn = nn.process if nn is not None else None
        self.last_value = None
        self.last_depth = 0
        self.last_policy = None
        self.last_tree = None

    @staticmethod
    def supports_process() -> bool:
        return True

    @staticmethod
    def requires_model() -> bool:
        return True

    @property
    def generator(self) -> torch.Generator:
        """The search's draws, on the player's device, seeded with the
        player's seed."""
        if self._generator is None:
            self._generator = torch.Generator(self.device).manual_seed(
                self._seed)
        return self._generator

    def play(self, state, draws: Optional[S.SearchDraws] = None) -> int:
        env = self.game_cls
        state = one_game(state, self.device)
        sims = int(self.args.numMCTSSims)
        tree = S.init_batched_trees(env, state, sims + 2,
                                    self.spec.value_size)
        S.search(env, tree, self.spec, self.eval_fn, sims, self.generator,
                 draws=draws)
        turns = int(state.turns[0])
        self.temp = self.args.temp_scaling_fn(self.temp, turns,
                                              self.game_cls.MAX_TURNS)
        policy = T.probs(tree, self.temp)[0].cpu().numpy()
        self.last_value = float(T.root_value(tree, self.average_value)[0])
        self.last_depth = int(tree.max_depth[0])
        self.last_policy = policy
        self.last_tree = tree
        action = int(self._rng.choice(len(policy), p=policy))
        if self.verbose:
            print(f"max tree depth: {self.last_depth}")
            print(f"value for player {int(state.player[0])}: "
                  f"{self.last_value}")
            print(f"policy: {policy}")
            print(f"confidence of action: {policy[action]}")
        return action

    def reset(self) -> None:
        self.temp = float(self.args.startTemp)

    def process(self, obs_batch):
        return self.nn.process(obs_batch)


class RawMCTSPlayer(MCTSPlayer):
    """Model-free MCTS: uniform priors and zero values
    (GenericPlayers.py:166-200), the search of ``raw_search`` a move
    (MCTS.pyx:175-183)."""

    def __init__(self, game_cls, args, device="cuda", **kw):
        super().__init__(None, game_cls, args, device=device, **kw)
        self.eval_fn = S.uniform_eval_fn(game_cls.ACTION_SIZE,
                                         self.spec.value_size)

    @staticmethod
    def requires_model() -> bool:
        return False


class NativeRawMCTSPlayer(BasePlayer):
    """Model-free MCTS on the C++ host runtime (ops/native.py), the
    low-latency twin of RawMCTSPlayer (the same search semantics,
    MCTS.pyx raw search). Raises ``NativeUnavailable`` at construction for
    an env the runtime has no rules for, or when the library does not
    build."""

    def __init__(self, game_cls, args, seed: int = 0, **kw):
        super().__init__(game_cls, args, **kw)
        from alphazero_general_tpu_torch.ops import native

        if game_cls.NAME not in native.GAME_IDS:
            raise native.NativeUnavailable(
                f"native engine has no rules for {game_cls.NAME!r}")
        native._load()  # build and bind now, so a failure shows at once
        self._native = native
        self.temp = float(args.startTemp)
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self.last_value = None
        self.last_depth = 0

    def play(self, state) -> int:
        state = one_game(state)
        self._seed += 1
        turns = int(state.turns[0])
        best, counts, value, depth = self._native.raw_mcts_solve(
            self.game_cls.NAME,
            state.board[0].cpu().numpy(),
            int(state.player[0]),
            turns,
            int(self.args.numMCTSSims),
            cpuct=float(self.args.cpuct),
            fpu_reduction=float(self.args.fpu_reduction),
            min_discount=float(self.args.min_discount),
            seed=self._seed,
        )
        self.last_value = value
        self.last_depth = depth
        self.temp = self.args.temp_scaling_fn(self.temp, turns,
                                              self.game_cls.MAX_TURNS)
        if self.temp <= 1e-6:
            return int(best)
        p = counts.astype(np.float64) ** (1.0 / self.temp)
        total = p.sum()
        if total <= 0:
            return int(self._rng.choice(valid_actions(self.game_cls, state)))
        return int(self._rng.choice(len(p), p=p / total))

    def reset(self) -> None:
        self.temp = float(self.args.startTemp)


class OneStepLookaheadPlayer(BasePlayer):
    """Env-generic one-step lookahead baseline (reference:
    envs/connect4/players.py:26-69, generalised through ``win_state`` as
    the JAX player is): play an immediate win where there is one, else
    avoid moves that hand the next player an immediate winning reply (a
    two-ply scan, skipped for action spaces larger than
    ``block_scan_limit``), else uniform random over the remaining moves.

    Each ply is stepped as one batch (every valid action, then every reply
    of every candidate) instead of one call per action; the pool of moves,
    and so the choice, is the JAX player's."""

    def __init__(self, game_cls=None, args=None, seed: int = 0,
                 block_scan_limit: int = 512, **kw):
        super().__init__(game_cls, args, **kw)
        self._rng = np.random.default_rng(seed)
        self.block_scan_limit = block_scan_limit

    def play(self, state) -> int:
        env = self.game_cls
        state = one_game(state)
        valids = valid_actions(env, state)
        me = int(state.player[0])
        dev = state.player.device
        nxt = env.step(repeat_game(state, len(valids)),
                       torch.from_numpy(valids.astype(np.int32)).to(dev))
        win = env.win_state(nxt).cpu().numpy()
        wins = np.flatnonzero(win[:, me] > 0)
        if len(wins):  # the first immediate win, as the JAX scan stops there
            return int(self._rng.choice([int(valids[wins[0]])]))
        cand = np.flatnonzero(~(win > 0).any(axis=1))
        if env.ACTION_SIZE <= self.block_scan_limit and len(cand):
            rows = torch.from_numpy(cand).to(dev)
            after = type(nxt)(**{k: x[rows] for k, x in
                                 state_items(nxt).items()})
            reply_ok = env.valid_moves(after).cpu().numpy()
            owner, reply = np.nonzero(reply_ok)
            danger = np.zeros(len(cand), bool)
            if len(owner):
                idx = torch.from_numpy(owner).to(dev)
                replies = env.step(
                    type(after)(**{k: x[idx] for k, x in
                                   state_items(after).items()}),
                    torch.from_numpy(reply.astype(np.int32)).to(dev))
                w2 = env.win_state(replies).cpu().numpy()
                opp = after.player.cpu().numpy()[owner]
                np.logical_or.at(danger, owner,
                                 w2[np.arange(len(owner)), opp] > 0)
            cand = cand[~danger]
        pool = [int(a) for a in valids[cand]] or list(map(int, valids))
        return int(self._rng.choice(pool))


class GreedyValuePlayer(BasePlayer):
    """One-ply lookahead on ``env.crude_value`` (reference per-env greedy
    players, e.g. envs/hnefatafl/players.py:36-71): every valid action
    stepped as one batch; the first best wins, as in the JAX loop."""

    def play(self, state) -> int:
        env = self.game_cls
        state = one_game(state)
        valids = valid_actions(env, state)
        nxt = env.step(repeat_game(state, len(valids)), torch.from_numpy(
            valids.astype(np.int32)).to(state.player.device))
        # crude_value is the view of the player to move in ``nxt``; the
        # mover's is its complement.
        v = 1.0 - env.crude_value(nxt).cpu().numpy().astype(np.float64)
        return int(valids[int(np.argmax(v))])


class HumanConsolePlayer(BasePlayer):
    """Console input (reference per-env human players)."""

    @staticmethod
    def is_human() -> bool:
        return True

    def play(self, state) -> int:
        env = self.game_cls
        state = one_game(state)
        valids = env.valid_moves(state)[0].cpu().numpy()
        print(env.display(state))
        while True:
            raw = input(f"enter action [0-{env.ACTION_SIZE - 1}]: ").strip()
            try:
                a = int(raw)
            except ValueError:
                print("not a number")
                continue
            if 0 <= a < env.ACTION_SIZE and valids[a]:
                return a
            print("invalid move")
