"""Tafl (Viking chess) over batched tensors: brandubh 7x7 and hnefatafl
11x11 — the port of alphazero_general_tpu/envs/tafl.py (reference:
fastafl/cengine.pyx:24-334, fastafl/variants.py:1-22,
alphazero/envs/brandubh/fastafl.pyx:31-268).

The rules, the cell encoding and the move encoding are the JAX env's, and
so is its one documented deviation from the reference engine: only black
movers capture the king custodially (cengine.pyx:189 lets a white move take
its own king). The team stuck-checks count the king's moves for team 1
(cengine.pyx:163-167, 277-284).

Cells: 0 empty, 1 white soldier, 2 black soldier, 3 king, 4 throne,
5 escape, 7 king on the throne, 8 king on an escape (cengine.pyx:24-32).
Player 0 is the black ('2') team and moves first; player 1 is white and
the king (fastafl.pyx:190-202).

How the batch computes what the JAX env computes per game:

* **Move legality**: a move is legal when no obstacle lies strictly between
  its source and destination and its destination is landable. The blocked
  counts of every action of every game are one matrix product, obstacles
  ``[B, 2, H·W]`` (non-king and king movers) by the "strictly between"
  table ``[H·W, A]``; the landability is a gather of the destination cell.
  The product runs in bfloat16 with float32 accumulation and is exact: the
  operands are 0 or 1 and a count is at most H-2 = 9, far below 256, the
  first integer bfloat16 cannot hold.
* **Surround capture** (cengine.pyx:207-247) needs the cells of the enemy
  team that a 4-connected walk inside the team reaches from given seeds,
  twice a step. The JAX env grows the seeds to a fixpoint in a while loop;
  a loop whose exit the host reads would stall every simulation of the
  search. Here both floods read one reachability matrix of the enemy
  region, ``R = (I + adjacency)`` restricted to the region and squared
  ``ceil(log2(H·W - 1))`` times (7 for hnefatafl, 6 for brandubh), each
  square clamped back to 0/1: after s squarings R holds every pair joined
  by a walk of at most 2^s steps, and no shortest walk inside a region of
  H·W cells is longer than H·W - 1 steps, so the fixed count reaches the
  fixpoint on any board with no data-dependent exit. The squares are
  bfloat16 products, exact for the same reason as above (entries are 0/1,
  a sum at most H·W = 121 < 256). The second flood grows inside the
  zero-liberty groups, which are whole components of the enemy region, so
  the same R serves it.
* **Custodial capture** checks the four neighbours of every game's
  destination at once: no capture of one direction changes the cells that
  another direction reads.
* **Per-cell tests** (whose team, a king, hostile, passable, landable, the
  observation planes) are lookups in small tables indexed by the cell
  value, so that one gather gives all of a board's masks: a search runs
  the env once per simulation, and each tensor operation costs the host
  a kernel launch.

Only ``movegen="dense"`` is ported; the JAX env's ``"scan"`` movegen (its
CPU/debug path) raises here.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Type

import numpy as np
import torch

from alphazero_general_tpu_torch.envs.core import Env, EnvState

EMPTY, WHITE, BLACK, KING, THRONE, ESCAPE = 0, 1, 2, 3, 4, 5
KING_ON_THRONE, KING_ON_ESCAPE = 7, 8

HNEFATAFL_BOARD = """50022222005
00000200000
00000000000
20000100002
20001110002
22011711022
20001110002
20000100002
00000000000
00000200000
50022222005"""

BRANDUBH_BOARD = """5002005
0002000
0001000
2217122
0001000
0002000
5002005"""

#: Dtype of the exact 0/1 matrix products (see the module docstring).
_MM_DTYPE = torch.bfloat16


@dataclasses.dataclass
class TaflState(EnvState):
    board: torch.Tensor = None  # int8[B, H, W], the reference's encoding
    king_captured: torch.Tensor = None  # bool[B], set by a king capture


def _parse_board(s: str) -> np.ndarray:
    rows = [list(map(int, line.strip())) for line in s.strip().splitlines()]
    return np.array(rows, dtype=np.int8)


def _build_tables(H: int, W: int):
    """Move-encoding tables (fastafl.pyx:47-80; JAX tafl.py:81).

    action = (W+H-2) * (c + r*W) + move_type; move_type < H-1 moves
    vertically to row mt (+1 if mt >= r), else horizontally to column
    mt-(H-1) (+1 if >= c). Returns (MT, dest_r [H, W, MT], dest_c,
    between [A, H·W]: the cells strictly between source and destination).
    """
    MT = W + H - 2
    dest_r = np.zeros((H, W, MT), np.int64)
    dest_c = np.zeros((H, W, MT), np.int64)
    between = np.zeros((H * W * MT, H * W), np.float32)
    for r in range(H):
        for c in range(W):
            for mt in range(MT):
                if mt < H - 1:
                    r2, c2 = mt + (1 if mt >= r else 0), c
                else:
                    c2 = (mt - (H - 1)) + (1 if (mt - (H - 1)) >= c else 0)
                    r2 = r
                dest_r[r, c, mt] = r2
                dest_c[r, c, mt] = c2
                a = (c + r * W) * MT + mt
                if r2 == r:
                    lo, hi = sorted((c, c2))
                    for cc in range(lo + 1, hi):
                        between[a, r * W + cc] = 1.0
                else:
                    lo, hi = sorted((r, r2))
                    for rr in range(lo + 1, hi):
                        between[a, rr * W + c] = 1.0
    return MT, dest_r, dest_c, between


def _encode(N: int, MT: int, r: int, c: int, r2: int, c2: int) -> int:
    if c == c2:
        mt = r2 if r2 < r else r2 - 1
    else:
        mt = (N - 1) + (c2 if c2 < c else c2 - 1)
    return (c + r * N) * MT + mt


def _build_symmetry_perms(H: int, W: int, MT: int) -> np.ndarray:
    """Action permutations of the 8 dihedral transforms (JAX tafl.py:116):
    ``PERM[k, new_action] = old_action``, so the transformed policy is
    ``pi[PERM[k]]``; k = rot*2 + flip, rot quarter-turns counter-clockwise
    (as np.rot90 turns the board planes), then flip = fliplr."""
    assert H == W, "dihedral symmetries require square boards"
    N = H

    def tf_cell(r, c, rot, flip):
        for _ in range(rot):
            r, c = N - 1 - c, r  # np.rot90: out[N-1-c, r] = in[r, c]
        if flip:
            c = N - 1 - c
        return r, c

    A = N * N * MT
    perms = np.zeros((8, A), np.int64)
    for rot in range(4):
        for flip in (False, True):
            k = rot * 2 + int(flip)
            for r in range(N):
                for c in range(N):
                    for mt in range(MT):
                        if mt < N - 1:
                            r2, c2 = mt + (1 if mt >= r else 0), c
                        else:
                            cc = mt - (N - 1)
                            r2, c2 = r, cc + (1 if cc >= c else 0)
                        old_a = (c + r * N) * MT + mt
                        nr, nc = tf_cell(r, c, rot, flip)
                        nr2, nc2 = tf_cell(r2, c2, rot, flip)
                        perms[k, _encode(N, MT, nr, nc, nr2, nc2)] = old_a
    return perms


#: The four directions of the custodial checks, in the JAX env's order.
_DIRECTIONS = ((0, 1), (1, 0), (0, -1), (-1, 0))


def _neighbour_tables(H: int, W: int):
    """Per cell: ``adj`` [H·W, H·W] 0/1 of its in-board 4-neighbours; and
    per destination cell and direction, the cells one and two steps away
    (``near``, ``far`` [H·W, 4], clamped onto the board as the JAX env
    clamps them) and whether both lie on the board (``inside``)."""
    HW = H * W
    adj = np.zeros((HW, HW), np.float32)
    near = np.zeros((HW, 4), np.int64)
    far = np.zeros((HW, 4), np.int64)
    inside = np.zeros((HW, 4), bool)
    for r in range(H):
        for c in range(W):
            for k, (dr, dc) in enumerate(_DIRECTIONS):
                if 0 <= r + dr < H and 0 <= c + dc < W:
                    adj[r * W + c, (r + dr) * W + c + dc] = 1.0
                near[r * W + c, k] = (min(max(r + dr, 0), H - 1) * W
                                      + min(max(c + dc, 0), W - 1))
                far[r * W + c, k] = (min(max(r + 2 * dr, 0), H - 1) * W
                                     + min(max(c + 2 * dc, 0), W - 1))
                inside[r * W + c, k] = (0 <= r + 2 * dr < H
                                        and 0 <= c + 2 * dc < W)
    return adj, near, far, inside


#: Columns of the per-cell mask table (``_cell_tables``).
(TEAM1, IS_BLACK, IS_WHITE, IS_KING, IS_EMPTY, ANVIL, KING_HOSTILE,
 KING_ESCAPED) = range(8)


def _cell_tables(move_over_throne: bool, king_can_enter_throne: bool):
    """Everything the rules read from a cell, as tables indexed by the cell
    value (0..8; 6 is unused), so that one gather per board gives all of
    it: ``masks`` [9, 8] bool (columns above: the white team (soldiers and
    king); black and white soldiers; the king; empty; throne or escape,
    hostile to a custodial neighbour of either team; black, throne or
    escape, hostile to the king; the king on an escape), ``obstacle``
    [2, 9] (a cell a non-king / king mover may not pass), ``land`` [2, 9]
    (a cell it may stop on), ``piece`` (the moving piece: any king value is
    KING), ``left`` (what a moving piece leaves behind), ``landed`` [9, 9]
    (piece, destination cell → the destination's new value) and
    ``planes`` [9, 3] (the black, white and king observation planes)."""
    v = np.arange(9)
    king = (v == KING) | (v == KING_ON_THRONE) | (v == KING_ON_ESCAPE)
    empty, throne, escape = v == EMPTY, v == THRONE, v == ESCAPE
    masks = np.stack([(v == WHITE) | king, v == BLACK, v == WHITE, king,
                      empty, throne | escape, (v == BLACK) | throne | escape,
                      v == KING_ON_ESCAPE], axis=1)
    pass_nk = empty | (throne & move_over_throne)
    obstacle = np.stack([~pass_nk, ~(pass_nk | escape)])
    land = np.stack([empty, empty | escape | (throne
                                              & king_can_enter_throne)])
    piece = np.where(king, KING, v)
    left = np.where(v == KING_ON_THRONE, THRONE,
                    np.where(v == KING_ON_ESCAPE, ESCAPE, EMPTY))
    landed = np.repeat(v[:, None], 9, axis=1)  # [piece, destination]
    landed[KING, THRONE] = KING_ON_THRONE
    landed[KING, ESCAPE] = KING_ON_ESCAPE
    planes = np.stack([v == BLACK, v == WHITE, king], axis=1)
    return dict(masks=masks, obstacle=obstacle, land=land,
                piece=piece.astype(np.int8), left=left.astype(np.int8),
                landed=landed.astype(np.int8),
                planes=planes.astype(np.float32))


def make_tafl_env(name: str, board_str: str, king_two_sided_capture: bool,
                  draw_move_count: int, move_over_throne: bool = True,
                  king_can_enter_throne: bool = False,
                  movegen: str = "dense") -> Type[Env]:
    """A tafl Env class for one variant (cengine.pyx:54-57 rule flags,
    variants.py board strings; JAX tafl.py:179)."""
    if movegen != "dense":
        raise ValueError(f"movegen={movegen!r} is not ported (only "
                         "'dense'); the JAX env's 'scan' movegen is its "
                         "CPU/debug path")
    INIT = _parse_board(board_str)
    H, W = INIT.shape
    HW = H * W
    MT, DEST_R, DEST_C, BETWEEN = _build_tables(H, W)
    PERMS = _build_symmetry_perms(H, W, MT)
    A = HW * MT
    NUM_BLACK = int((INIT == BLACK).sum())
    NUM_WHITE = int((INIT == WHITE).sum())
    SQUARINGS = max(1, math.ceil(math.log2(HW - 1)))
    ADJ, NEAR, FAR, INSIDE = _neighbour_tables(H, W)
    CELLS = _cell_tables(move_over_throne, king_can_enter_throne)

    @functools.lru_cache(maxsize=None)
    def tables(device: torch.device):
        """The constant tables on ``device``, made once per device."""
        return dict(
            between_t=torch.from_numpy(np.ascontiguousarray(BETWEEN.T))
            .to(device, _MM_DTYPE),
            dest=torch.from_numpy((DEST_R * W + DEST_C).reshape(-1))
            .to(device),
            adj=torch.from_numpy(ADJ).to(device, _MM_DTYPE),
            adj_self=torch.from_numpy(ADJ + np.eye(HW, dtype=np.float32))
            .to(device, _MM_DTYPE),
            degree=torch.from_numpy(ADJ.sum(1)).to(device, _MM_DTYPE),
            near=torch.from_numpy(NEAR).to(device),
            far=torch.from_numpy(FAR).to(device),
            inside=torch.from_numpy(INSIDE).to(device),
            perms=torch.from_numpy(PERMS).to(device),
            init=torch.from_numpy(INIT).to(device),
            **{k: torch.from_numpy(x).to(device, _MM_DTYPE)
               if k == "obstacle" else torch.from_numpy(x).to(device)
               for k, x in CELLS.items()},
        )

    def _cells(board, tb):
        """(cell values as long [B, HW], their masks [B, HW, 8])."""
        idx = board.reshape(board.shape[0], HW).long()
        return idx, tb["masks"][idx]

    def _legal(idx, m, tb):
        """(black's, white's) legal actions, each bool[B, A] (JAX
        ``_ok_pair`` and ``_select_movers``). A move is legal when no
        obstacle lies strictly between its source and destination (one
        product with the "strictly between" table, for the non-king and
        the king mover at once) and its destination is landable; the
        source's piece then says whose move it is."""
        blocked = torch.matmul(tb["obstacle"][:, idx], tb["between_t"])
        ok = (blocked == 0) & tb["land"][:, idx][:, :, tb["dest"]]
        src = m.repeat_interleave(MT, dim=1)  # [B, A, 8]: the source cell
        black = src[..., IS_BLACK] & ok[0]
        white = (src[..., IS_WHITE] & ok[0]) | (src[..., IS_KING] & ok[1])
        return black, white

    def _neighbours(m, tb):
        """f[B, HW] (in _MM_DTYPE): how many of each cell's in-board
        4-neighbours are set in m (bool[B, HW]); exact, at most 4."""
        return torch.matmul(m.to(_MM_DTYPE), tb["adj"])

    def _win_from(state, m, vm_black, vm_white, tb):
        """The win vector (cengine.pyx:146-169) from the cell masks and
        both teams' legal actions, with the draw cap first
        (fastafl.pyx:193-197)."""
        draw = state.turns >= draw_move_count
        white_wins = m[..., KING_ESCAPED].any(dim=1) | ~vm_black.any(dim=1)
        king_taken = state.king_captured
        if not king_two_sided_capture:
            # The king with every in-board neighbour hostile
            # (cengine.pyx:154-161).
            boxed = _neighbours(m[..., KING_HOSTILE], tb) == tb["degree"]
            king_taken = king_taken | (m[..., IS_KING] & boxed).any(dim=1)
        black_wins = (king_taken | ~vm_white.any(dim=1)) & ~white_wins
        return torch.stack([black_wins & ~draw, white_wins & ~draw, draw],
                           dim=1).to(torch.float32)

    def _surround_capture(flat, mover_team1, dst, tb):
        """Zero-liberty capture of the enemy groups touching the moved piece
        (cengine.pyx:207-247, JAX ``_surround_capture``) on flat boards
        [B, HW]. Liberties are empty normal cells; thrones, escapes and the
        edge block. Returns (flat, king_taken)."""
        _, m = _cells(flat, tb)
        enemy = torch.where(mover_team1[:, None], m[..., IS_BLACK],
                            m[..., TEAM1])
        e_mm = enemy.to(_MM_DTYPE)
        reach = tb["adj_self"] * e_mm[:, :, None] * e_mm[:, None, :]
        for _ in range(SQUARINGS):
            reach = torch.matmul(reach, reach).clamp_(max=1)

        def flood(seed):  # region cells joined to a seed cell
            grown = torch.matmul(reach, seed[:, :, None].to(_MM_DTYPE))
            return grown[:, :, 0] > 0

        zero_liberty = enemy & ~flood(
            enemy & (_neighbours(m[..., IS_EMPTY], tb) > 0))
        # The cells next to the destination (its dilation).
        touching = tb["adj"][dst] > 0
        captured = zero_liberty & flood(zero_liberty & touching)
        king = m[..., IS_KING]
        king_taken = (captured & king).any(dim=1)
        return torch.where(captured & ~king, EMPTY, flat), king_taken

    class Tafl(Env):
        NAME = name
        NUM_PLAYERS = 2
        ACTION_SIZE = A
        OBS_SHAPE = (5, H, W)
        MAX_TURNS = draw_move_count
        HAS_DRAW = True
        NUM_SYMMETRIES = 8
        BOARD_SHAPE = (H, W)
        MOVE_TYPES = MT

        State = TaflState

        @staticmethod
        def init(batch_size: int, device="cuda") -> TaflState:
            z = torch.zeros((batch_size,), dtype=torch.int32, device=device)
            board = tables(torch.device(device))["init"]
            return TaflState(
                player=z, turns=z.clone(), last_action=z - 1,
                board=board.expand(batch_size, H, W).clone(),
                king_captured=torch.zeros((batch_size,), dtype=torch.bool,
                                          device=device))

        @staticmethod
        def step(state: TaflState, action: torch.Tensor) -> TaflState:
            """Move, custodial captures, surround capture (JAX tafl.py:389,
            cengine.pyx:174-247)."""
            action = action.to(torch.int32)
            board = state.board
            B = board.shape[0]
            dev = board.device
            tb = tables(dev)
            games = torch.arange(B, device=dev)
            a = action.long()
            src = a // MT
            dst = tb["dest"][a]
            flat = board.reshape(B, HW).clone()

            src_val = flat[games, src].long()
            piece = tb["piece"][src_val]
            flat[games, src] = tb["left"][src_val]
            flat[games, dst] = tb["landed"][piece.long(),
                                            flat[games, dst].long()]

            # Custodial capture of the four neighbours (cengine.pyx:174-199).
            is_king_piece = piece == KING
            mover_team1 = (piece == WHITE) | is_king_piece
            enemy_soldier = torch.where(mover_team1, BLACK, WHITE)
            e_idx = tb["near"][dst]  # [B, 4]
            ev = flat.gather(1, e_idx)
            fm = tb["masks"][flat.gather(1, tb["far"][dst]).long()]
            friendly = torch.where(mover_team1[:, None], fm[..., TEAM1],
                                   fm[..., IS_BLACK]) | fm[..., ANVIL]
            plain = ev == enemy_soldier[:, None]
            do = tb["inside"][dst] & friendly
            taken = do & plain
            # Two-sided king capture: only by black movers (the deviation
            # from cengine.pyx:189 in the module docstring).
            king_captured = state.king_captured
            if king_two_sided_capture:
                king_captured = king_captured | (
                    do & ~mover_team1[:, None] & (ev == KING)).any(dim=1)
            # Each direction's neighbour is its own cell: one scatter.
            flat.scatter_(1, e_idx, torch.where(taken, EMPTY, ev))

            # Surround capture (cengine.pyx:228-247).
            flat, king_surr = _surround_capture(flat, mover_team1, dst, tb)
            return TaflState(
                player=(state.player + 1) % 2,
                turns=state.turns + 1,
                last_action=action,
                board=flat.reshape(B, H, W),
                king_captured=king_captured | king_surr,
            )

        @staticmethod
        def valid_moves(state: TaflState) -> torch.Tensor:
            return Tafl.win_and_valids(state)[1]

        @staticmethod
        def win_state(state: TaflState) -> torch.Tensor:
            return Tafl.win_and_valids(state)[0]

        @staticmethod
        def win_and_valids(state: TaflState):
            """(win_state, valid_moves) from one evaluation of the
            board-only legality (JAX tafl.py:493): both teams' moves serve
            the valid moves and the stuck-team checks."""
            tb = tables(state.board.device)
            idx, m = _cells(state.board, tb)
            vm_black, vm_white = _legal(idx, m, tb)
            valids = torch.where((state.player == 0)[:, None], vm_black,
                                 vm_white)
            return _win_from(state, m, vm_black, vm_white, tb), valids

        @staticmethod
        def observation(state: TaflState) -> torch.Tensor:
            """5 planes: black and white soldiers, the king, the colour to
            move, the turn fraction (fastafl.pyx:84-99)."""
            board = state.board
            B = board.shape[0]
            idx = board.reshape(B, HW).long()
            pieces = tables(board.device)["planes"][idx].transpose(1, 2)
            colour = state.player.to(torch.float32)[:, None, None] \
                .expand(B, 1, HW)
            # XLA compiles the JAX env's ``turns / draw_move_count`` into a
            # product with the float32 reciprocal; the same product here
            # keeps the observations bit-identical.
            turn = (state.turns.to(torch.float32) * (1.0 / draw_move_count))[
                :, None, None].expand(B, 1, HW)
            return torch.cat([pieces, colour, turn], dim=1).reshape(
                (B,) + Tafl.OBS_SHAPE)

        @classmethod
        def symmetries(cls, obs: torch.Tensor, pi: torch.Tensor):
            """The 8 dihedral images of obs [B, 5, H, W] and pi [B, A],
            stacked on axis 1 in the order of ``_build_symmetry_perms``."""
            perms = tables(pi.device)["perms"]
            obs_list, pi_list = [], []
            for rot in range(4):
                o = torch.rot90(obs, rot, dims=(2, 3))
                for flip in (False, True):
                    obs_list.append(o.flip(-1) if flip else o)
                    pi_list.append(pi[:, perms[rot * 2 + int(flip)]])
            return torch.stack(obs_list, dim=1), torch.stack(pi_list, dim=1)

        @staticmethod
        def crude_value(state: TaflState) -> torch.Tensor:
            """Heuristic value f32[B], 1 good for black (fastafl.pyx:
            258-268)."""
            result = Tafl.win_state(state)
            B = state.board.shape[0]
            flat = state.board.reshape(B, HW)
            white = (flat == WHITE).sum(dim=1).to(torch.float32)
            black = (flat == BLACK).sum(dim=1).to(torch.float32)
            is_black = state.player == 0
            sign = torch.where(is_black, 1.0, -1.0)
            denom = 100.0 + torch.where(is_black, float(NUM_BLACK),
                                        float(NUM_WHITE))
            turns = state.turns.to(torch.float32) / draw_move_count
            return 0.5 + (
                sign * (-result[:, 2] * 10.0 - turns) + black - white
                + 100.0 * (result[:, 0] - result[:, 1])) / denom

        @staticmethod
        def decode_action(action: int):
            """action → ((r, c), (r2, c2))."""
            cell, mt = divmod(int(action), MT)
            r, c = divmod(cell, W)
            return (r, c), (int(DEST_R[r, c, mt]), int(DEST_C[r, c, mt]))

        @staticmethod
        def encode_action(r: int, c: int, r2: int, c2: int) -> int:
            if c == c2:
                mt = r2 if r2 < r else r2 - 1
            else:
                mt = (H - 1) + (c2 if c2 < c else c2 - 1)
            return (c + r * W) * MT + mt

        @classmethod
        def display(cls, state) -> str:
            """Game 0 of ``state`` as text, as the JAX env prints it
            (tafl.py:567)."""
            chars = {0: ".", 1: "w", 2: "b", 3: "K", 4: "+", 5: "x",
                     7: "K", 8: "K"}
            return "\n".join(" ".join(chars[int(v)] for v in row)
                             for row in state.board[0].tolist())

    Tafl.__name__ = name.capitalize()
    return Tafl


Brandubh = make_tafl_env("brandubh", BRANDUBH_BOARD,
                         king_two_sided_capture=True, draw_move_count=100)
Hnefatafl = make_tafl_env("hnefatafl", HNEFATAFL_BOARD,
                          king_two_sided_capture=False, draw_move_count=512)
