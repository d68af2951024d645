"""Stratego (8x10, two phases, imperfect information) over batched tensors —
the port of alphazero_general_tpu/envs/stratego.py (reference:
alphazero/envs/stratego/engine.pyx:28-295, stratego.pyx:25-257).

The rules and encodings are the JAX env's, with its documented deviations
from the reference kept: a miner attacking a bomb loses, and a revealed
piece that moves hides again (JAX stratego.py:16-24).

* cells: 0 empty, 13 lake, red pieces 1-12, blue +20, visible +100 (uint8);
* one 1280-action space for both phases: placement ``piece*80 + row*10 +
  col`` (piece 1..12) while pieces remain, then the tafl rook encoding of
  16 move types per cell (``tafl._build_tables``);
* moves: one orthogonal step, scouts ride through empty cells and may
  capture at the first enemy; bombs and flags stay;
* the win vector: blue wins if red's flag is taken or red is stuck
  (checked first), red on the mirror condition; a draw at 512 turns;
* observation: 30 planes; symmetries: identity and the left/right mirror,
  whose policy permutation depends on the phase (from the turn plane).

JAX chooses each phase with ``lax.cond``, which under ``vmap`` runs both
branches; here both branches run for the whole batch and ``torch.where``
selects per game. Every index that the untaken branch computes is clamped
into range: an out-of-range gather on the card is a device fault, not a
clamp.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from alphazero_general_tpu_torch.envs.core import Env, EnvState
from alphazero_general_tpu_torch.envs.tafl import _build_tables

H, W = 8, 10
NUM_PLAYERS = 2
NUM_PIECES = 12
TEAM_OFFSET = 20
VISIBLE_OFFSET = 100
LAKE = 13
SPY, SCOUT, MINER = 1, 2, 3
MARSHAL, BOMB, FLAG = 10, 11, 12
DRAW_MOVE_COUNT = 512
PLACEMENT_TURNS = 60

MT = W + H - 2  # 16
CELLS = H * W  # 80
ACTION_SIZE = max(W + H * W + NUM_PIECES * CELLS, CELLS * MT)  # 1280
NUM_CHANNELS = 30

# Piece counts per type 1..12 (engine.pyx:54-56); index 0 unused.
PIECE_COUNTS = np.zeros(NUM_PIECES + 1, np.int8)
for _p, _n in ((SPY, 1), (SCOUT, 5), (MINER, 4), (4, 2), (5, 2), (6, 3),
               (7, 3), (8, 2), (9, 1), (MARSHAL, 1), (FLAG, 1), (BOMB, 5)):
    PIECE_COUNTS[_p] = _n

_START = np.zeros((H, W), np.uint8)
for _r in (3, 4):
    for _c in (2, 3, 6, 7):
        _START[_r, _c] = LAKE

_, DEST_R, DEST_C, BETWEEN = _build_tables(H, W)
DIST = np.abs(DEST_R - np.arange(H)[:, None, None]) + \
    np.abs(DEST_C - np.arange(W)[None, :, None])  # [H, W, MT]
#: First placement action (piece 1 on cell 0); the 12 x 80 placements are
#: the contiguous actions PLACE_LO .. PLACE_LO + 959.
PLACE_LO = CELLS


def _build_mirror_perms():
    """Mirror (fliplr) permutations per phase, ``PERM[new] = old``
    (JAX stratego.py:87-114): row 0 placement, row 1 movement."""
    move_perm = np.arange(ACTION_SIZE, dtype=np.int64)
    for r in range(H):
        for c in range(W):
            for mt in range(MT):
                r2, c2 = int(DEST_R[r, c, mt]), int(DEST_C[r, c, mt])
                nc, nc2 = W - 1 - c, W - 1 - c2
                if nc == nc2:
                    nmt = r2 if r2 < r else r2 - 1
                else:
                    nmt = (H - 1) + (nc2 if nc2 < nc else nc2 - 1)
                move_perm[(nc + r * W) * MT + nmt] = (c + r * W) * MT + mt
    place_perm = np.arange(ACTION_SIZE, dtype=np.int64)
    for p in range(1, NUM_PIECES + 1):
        for r in range(H):
            for c in range(W):
                place_perm[p * CELLS + r * W + (W - 1 - c)] = \
                    p * CELLS + r * W + c
    return np.stack([place_perm, move_perm])


MIRROR_PERMS = _build_mirror_perms()


def _cell_tables():
    """Per cell value 0..255 (uint8): whether it holds a red piece, a blue
    piece, its rank (``_base % 20``) and its value without the visibility
    offset (``_base``)."""
    v = np.arange(256)
    base = v % VISIBLE_OFFSET
    red = (base >= 1) & (base <= NUM_PIECES)
    blue = (base >= TEAM_OFFSET + 1) & (base <= TEAM_OFFSET + NUM_PIECES)
    return red, blue, base % TEAM_OFFSET, base


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    red, blue, rank, base = _cell_tables()
    rows = np.arange(H)
    return dict(
        between_t=t(BETWEEN.T.astype(np.float32)),
        dest=t((DEST_R * W + DEST_C).reshape(-1)),
        dist1=t((DIST == 1).reshape(-1)),
        perms=t(MIRROR_PERMS),
        start=t(_START), counts=t(PIECE_COUNTS),
        red=t(red), blue=t(blue), rank=t(rank.astype(np.uint8)),
        base=t(base.astype(np.uint8)), kinds=t(np.arange(NUM_PIECES + 1)),
        red_zone=t(np.repeat(rows < 3, W)), blue_zone=t(np.repeat(rows > 4, W)),
    )


@dataclasses.dataclass
class StrategoState(EnvState):
    board: torch.Tensor = None  # uint8[B, H, W] incl. visibility
    red_to_place: torch.Tensor = None  # int8[B, 13] remaining counts
    blue_to_place: torch.Tensor = None
    red_bombs: torch.Tensor = None  # bool[B, H, W] exploded red bombs
    blue_bombs: torch.Tensor = None
    red_flag_captured: torch.Tensor = None  # bool[B]
    blue_flag_captured: torch.Tensor = None


def _play_phase(state) -> torch.Tensor:
    """bool[B]: every piece placed."""
    return (state.red_to_place.to(torch.int32).sum(dim=1)
            + state.blue_to_place.to(torch.int32).sum(dim=1)) == 0


def _dest_open(idx, enemy, tb):
    """bool[B, A]: each action's destination is empty or an enemy's."""
    return ((idx == 0) | enemy).gather(1, tb["dest"].expand(idx.shape[0], -1))


def _team_moves(idx, mine, enemy, tb):
    """bool[B, A]: the one-step moves of the movable pieces ``mine``."""
    rank = tb["rank"][idx]
    movable = mine & (rank != BOMB) & (rank != FLAG)
    return (movable.repeat_interleave(MT, dim=1) & tb["dist1"]
            & _dest_open(idx, enemy, tb))


class Stratego(Env):
    NAME = "stratego"
    NUM_PLAYERS = NUM_PLAYERS
    ACTION_SIZE = ACTION_SIZE
    OBS_SHAPE = (NUM_CHANNELS, H, W)
    MAX_TURNS = DRAW_MOVE_COUNT
    HAS_DRAW = True
    NUM_SYMMETRIES = 2
    BOARD_SHAPE = (H, W)

    State = StrategoState

    @staticmethod
    def init(batch_size: int, device="cuda") -> StrategoState:
        tb = _tables(torch.device(device))
        z = torch.zeros((batch_size,), dtype=torch.int32, device=device)
        f = torch.zeros((batch_size,), dtype=torch.bool, device=device)
        bombs = torch.zeros((batch_size, H, W), dtype=torch.bool,
                            device=device)
        counts = tb["counts"].expand(batch_size, -1)
        return StrategoState(
            player=z, turns=z.clone(), last_action=z - 1,
            board=tb["start"].expand(batch_size, H, W).clone(),
            red_to_place=counts.clone(), blue_to_place=counts.clone(),
            red_bombs=bombs, blue_bombs=bombs.clone(),
            red_flag_captured=f, blue_flag_captured=f.clone())

    @staticmethod
    def step(state: StrategoState, action: torch.Tensor) -> StrategoState:
        """Both phases' moves for every game, each game keeping its own
        phase's (JAX stratego.py:178-271)."""
        action = action.to(torch.int32)
        B = action.shape[0]
        dev = action.device
        tb = _tables(dev)
        games = torch.arange(B, device=dev)
        a = action.long()
        play = _play_phase(state)
        flat = state.board.reshape(B, CELLS)
        is_red = state.player == 0

        # -- placement: piece a // 80 (1..12) on cell a % 80 --------------
        piece = (a // CELLS).clamp(1, NUM_PIECES)
        cell = a % CELLS
        placed = flat.clone()
        placed[games, cell] = torch.where(is_red, piece,
                                          piece + TEAM_OFFSET).to(torch.uint8)
        one = (tb["kinds"] == piece[:, None]).to(torch.int8)  # [B, 13]
        red_tp = torch.where((is_red & ~play)[:, None],
                             state.red_to_place - one, state.red_to_place)
        blue_tp = torch.where((~is_red & ~play)[:, None],
                              state.blue_to_place - one, state.blue_to_place)

        # -- movement: rook move from a // 16 to dest[a] ------------------
        src_cell = (a // MT).clamp(max=CELLS - 1)
        dst_cell = tb["dest"][a.clamp(max=CELLS * MT - 1)]
        raw_src = flat[games, src_cell].long()
        raw_dst = flat[games, dst_cell].long()
        src, dst = tb["base"][raw_src], tb["base"][raw_dst]  # visibility off
        src_rank, dst_rank = tb["rank"][raw_src], tb["rank"][raw_dst]
        dst_is_red = tb["red"][raw_dst]
        empty_dest = dst == 0
        flag_hit = ~empty_dest & (dst_rank == FLAG)
        both_die = ~empty_dest & (((dst_rank == BOMB) & (src_rank != MINER))
                                  | (src_rank == dst_rank))
        spy_kill = (src_rank == SPY) & (dst_rank == MARSHAL)
        defender_wins = ~empty_dest & ~flag_hit & ~both_die & (
            (src_rank < dst_rank) & ~spy_kill)
        new_dest = torch.where(
            empty_dest, src, torch.where(
                both_die, 0, torch.where(defender_wins, dst + VISIBLE_OFFSET,
                                         src + VISIBLE_OFFSET)))
        # a flag capture: the attacker lands and becomes visible
        new_dest = torch.where(flag_hit, src + VISIBLE_OFFSET, new_dest)
        moved = flat.clone()
        # A tensor, not the number 0: a Python number written through tensor
        # indices goes to the card as a host copy, which waits for it.
        moved[games, src_cell] = torch.zeros_like(moved[:, 0])
        moved[games, dst_cell] = new_dest.to(torch.uint8)
        exploded = (both_die & (dst_rank == BOMB) & play)[:, None] & (
            torch.arange(CELLS, device=dev)[None] == dst_cell[:, None])
        red_bombs = state.red_bombs | (exploded & dst_is_red[:, None]).reshape(
            B, H, W)
        blue_bombs = state.blue_bombs | (
            exploded & ~dst_is_red[:, None]).reshape(B, H, W)
        hit = flag_hit & play

        board = torch.where(play[:, None], moved, placed)
        return StrategoState(
            player=(state.player + 1) % NUM_PLAYERS,
            turns=state.turns + 1,
            last_action=action,
            board=board.reshape(B, H, W),
            red_to_place=red_tp, blue_to_place=blue_tp,
            red_bombs=red_bombs, blue_bombs=blue_bombs,
            red_flag_captured=state.red_flag_captured | (hit & dst_is_red),
            blue_flag_captured=state.blue_flag_captured | (hit & ~dst_is_red))

    @staticmethod
    def valid_moves(state: StrategoState) -> torch.Tensor:
        """The placement phase's actions or the movement phase's, per game
        (JAX stratego.py:273-315)."""
        B = state.board.shape[0]
        tb = _tables(state.board.device)
        idx = state.board.reshape(B, CELLS).long()
        is_red = (state.player == 0)[:, None]

        # -- placement: any remaining piece on an empty cell of the zone --
        zone = torch.where(is_red, tb["red_zone"], tb["blue_zone"])
        empty = (idx == 0) & zone
        counts = torch.where(is_red, state.red_to_place, state.blue_to_place)
        grid = (counts[:, 1:] > 0)[:, :, None] & empty[:, None]  # [B, 12, 80]
        placement = torch.zeros((B, ACTION_SIZE), dtype=torch.bool,
                                device=idx.device)
        placement[:, PLACE_LO: PLACE_LO + NUM_PIECES * CELLS] = grid.reshape(
            B, -1)

        # -- movement: one step, or a scout's ride over empty cells -------
        red, blue = tb["red"][idx], tb["blue"][idx]
        mine = torch.where(is_red, red, blue)
        enemy = torch.where(is_red, blue, red)
        # Any piece or lake strictly between source and destination: a
        # product of 0/1 values, exact in float32.
        blocked = torch.matmul((idx != 0).to(torch.float32),
                               tb["between_t"]) > 0.5
        scout = (mine & (tb["rank"][idx] == SCOUT)).repeat_interleave(
            MT, dim=1)
        rides = scout & ~blocked & _dest_open(idx, enemy, tb)
        movement = _team_moves(idx, mine, enemy, tb) | rides
        return torch.where(_play_phase(state)[:, None], movement, placement)

    @staticmethod
    def win_state(state: StrategoState) -> torch.Tensor:
        B = state.board.shape[0]
        tb = _tables(state.board.device)
        idx = state.board.reshape(B, CELLS).long()
        red, blue = tb["red"][idx], tb["blue"][idx]
        draw = state.turns >= DRAW_MOVE_COUNT
        play = _play_phase(state)
        # having legal moves is vacuously true while placing
        # (engine.pyx:200-201)
        red_stuck = play & ~_team_moves(idx, red, blue, tb).any(dim=1)
        blue_stuck = play & ~_team_moves(idx, blue, red, tb).any(dim=1)
        blue_wins = state.red_flag_captured | red_stuck
        red_wins = (state.blue_flag_captured | blue_stuck) & ~blue_wins
        return torch.stack([red_wins & ~draw, blue_wins & ~draw, draw],
                           dim=1).to(torch.float32)

    @staticmethod
    def crude_value(state: StrategoState) -> torch.Tensor:
        """Mover-perspective heuristic: decided games 1 / 0, else 0.5 plus a
        rank-weighted material balance (JAX stratego.py:344)."""
        B = state.board.shape[0]
        tb = _tables(state.board.device)
        w = Stratego.win_state(state)
        games = torch.arange(B, device=w.device)
        me = w[games, state.player.long()]
        opp = w[games, ((state.player + 1) % NUM_PLAYERS).long()]
        idx = state.board.reshape(B, CELLS).long()
        ranks = tb["rank"][idx].to(torch.float32)
        red_mat = torch.where(tb["red"][idx], ranks, 0.0).sum(dim=1)
        blue_mat = torch.where(tb["blue"][idx], ranks, 0.0).sum(dim=1)
        total = red_mat + blue_mat + 1e-6
        diff = (red_mat - blue_mat) / total  # in [-1, 1]
        mine = torch.where(state.player == 0, diff, -diff)
        # XLA fuses ``0.5 + 0.45 * mine`` into one multiply-add (a single
        # rounding); in float64 the product of two float32 values and its
        # sum with 0.5 are exact, so one rounding to float32 follows it.
        running = (0.5 + np.float64(np.float32(0.45))
                   * mine.to(torch.float64)).to(torch.float32)
        return torch.where(me > 0, 1.0, torch.where(opp > 0, 0.0, running))

    @staticmethod
    def observation(state: StrategoState) -> torch.Tensor:
        """30 planes: red and blue presence, the visible pieces of each rank
        red and blue interleaved, the exploded bombs, the colour, the turn
        fraction (stratego.pyx:102-141)."""
        B = state.board.shape[0]
        tb = _tables(state.board.device)
        board = state.board.reshape(B, CELLS)
        idx = board.long()
        visible = torch.arange(1, NUM_PIECES + 1, device=board.device)
        codes = torch.stack([visible + VISIBLE_OFFSET,
                             visible + VISIBLE_OFFSET + TEAM_OFFSET],
                            dim=1).reshape(-1)  # [24], red/blue interleaved
        planes = torch.cat([
            tb["red"][idx][:, None], tb["blue"][idx][:, None],
            idx[:, None] == codes[:, None],
            state.red_bombs.reshape(B, 1, CELLS),
            state.blue_bombs.reshape(B, 1, CELLS)], dim=1).to(torch.float32)
        # turns / 512 is exact (a power of two) either way
        scalars = torch.stack([
            state.player.to(torch.float32),
            state.turns.to(torch.float32) * (1.0 / DRAW_MOVE_COUNT)], dim=1)
        planes = torch.cat([planes, scalars[..., None].expand(B, 2, CELLS)],
                           dim=1)
        return planes.reshape(B, NUM_CHANNELS, H, W)

    @classmethod
    def symmetries(cls, obs: torch.Tensor, pi: torch.Tensor):
        """Identity and the left/right mirror (stratego.pyx:238-257); the
        mirror's policy permutation is the phase's, inferred from the turn
        plane (placement is exactly the first PLACEMENT_TURNS turns)."""
        perms = _tables(pi.device)["perms"]
        turns = obs[:, NUM_CHANNELS - 1, 0, 0] * DRAW_MOVE_COUNT
        move_phase = (turns + 0.5) >= PLACEMENT_TURNS
        perm = torch.where(move_phase[:, None], perms[1], perms[0])
        return (torch.stack([obs, obs.flip(-1)], dim=1),
                torch.stack([pi, pi.gather(1, perm)], dim=1))

    @staticmethod
    def in_placement(state: StrategoState) -> torch.Tensor:
        """bool[B]: still placing pieces."""
        return ~_play_phase(state)

    @staticmethod
    def encode_place(piece: int, r: int, c: int) -> int:
        """Placement action for piece type 1..12 at (r, c)."""
        return piece * CELLS + r * W + c

    @staticmethod
    def encode_action(r: int, c: int, r2: int, c2: int) -> int:
        """Movement action (the tafl rook encoding)."""
        if c == c2:
            mt = r2 if r2 < r else r2 - 1
        else:
            mt = (H - 1) + (c2 if c2 < c else c2 - 1)
        return (r * W + c) * MT + mt

    @staticmethod
    def decode_action(action: int):
        """Movement action → ((r, c), (r2, c2))."""
        cell, mt = divmod(int(action), MT)
        r, c = divmod(cell, W)
        return (r, c), (int(DEST_R[r, c, mt]), int(DEST_C[r, c, mt]))

    @classmethod
    def display(cls, state) -> str:
        """Game 0 of ``state`` as text, as the JAX env prints it
        (stratego.py:428): ``~`` a lake, ``r``/``b`` and the rank in hex a
        piece, ``!`` a revealed one."""
        out = []
        for board_row in state.board[0].tolist():
            row = []
            for v in map(int, board_row):
                b = v % VISIBLE_OFFSET
                if v == 0:
                    row.append(" . ")
                elif b == LAKE:
                    row.append(" ~ ")
                else:
                    team = "r" if b <= NUM_PIECES else "b"
                    vis = "!" if v >= VISIBLE_OFFSET else " "
                    row.append(f"{team}{b % TEAM_OFFSET:x}{vis}")
            out.append("".join(row))
        return "\n".join(out)


Game = Stratego
