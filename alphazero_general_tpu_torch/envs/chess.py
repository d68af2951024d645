"""Chess over batched tensors — the port of alphazero_general_tpu/envs/chess.py
(full rules: legal move generation with pins, checks, castling, en passant
including the discovered-check case, promotions and underpromotions;
checkmate, stalemate, the 50-move rule, insufficient material, threefold
repetition and the 512-ply cap; the 8x8x73 AlphaZero action encoding).

Rules, encodings, observations and the Zobrist keys are the JAX env's; its
design is kept too: every rule is a branch-free mask computation, sliding
attacks are occluded fills, pins and check evasions come from king-ray
analysis, and only the (at most two) en-passant captures are validated by
simulating the board after them.

How the batch computes it. Boards are flattened to 64 cells (``rank*8 +
file``, rank 0 = White's back rank; White positive, Black negative), and
the directions are a tensor axis:

* every shift is a gather through a table of source cells with an
  on-board mask (``_tables``), so one launch moves a board (or one board per
  direction) along all 8 queen directions, or all 8 knight jumps, at once;
* an occluded fill along the 8 directions (``_fill``) reads, per target
  cell, the cells 1..7 steps back along each direction (one gather of
  [.., 8, 7, 64]) and keeps a source whose cells in between are all empty
  (a prefix minimum along the 7 steps): about 8 launches for all 8
  directions where JAX's dumb7fill takes 7 shifts per direction;
* the 56 queen-like planes are one [B, 8, 7, 64] block: for plane (d, k)
  and from-cell c, the target cell c + k·d of the table ``QIDX``.

The Zobrist keys are those of the JAX env, drawn by the same numpy
generator in the same order. Torch's ``uint32`` is only partly supported
on CUDA, so the 32 hash bits are held in ``int32`` (the same bits: the
keys' uint32 values viewed as int32, and XOR acts on bits); compare a
hash with JAX's as ``hash.numpy().view(np.uint32)``. Torch has no XOR
reduction: the 64 squares' keys are folded 64 → 32 → … → 1 with
``bitwise_xor`` (6 launches).

Two float roundings follow the jitted JAX program: the clock plane
``min(halfmove, 100) / 100`` and the crude value's ``0.5 + mine / 40`` are
looked up in tables of what XLA computes for each integer input (it turns
the divisions by constants into products with reciprocals, the second one
fused into a multiply-add), so CPU and card give the same bits.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from alphazero_general_tpu_torch.envs.core import Env, EnvState

# Piece codes (White positive, Black negative).
PAWN, KNIGHT, BISHOP, ROOK, QUEEN, KING = 1, 2, 3, 4, 5, 6

NUM_PLAYERS = 2
BOARD = 8
NUM_PLANES = 73
ACTION_SIZE = BOARD * BOARD * NUM_PLANES  # 4672
MAX_TURNS = 512  # ply cap
NUM_CHANNELS = 20

# Queen-move directions, N = +rank (JAX chess.py:51).
DIRS = ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1))
ORTHO = {(1, 0), (-1, 0), (0, 1), (0, -1)}
# Line type for pin matching: N-S=0, E-W=1, NE-SW=2, NW-SE=3.
LINE_TYPE = {(1, 0): 0, (-1, 0): 0, (0, 1): 1, (0, -1): 1,
             (1, 1): 2, (-1, -1): 2, (-1, 1): 3, (1, -1): 3}
KNIGHT_DELTAS = ((2, 1), (1, 2), (-1, 2), (-2, 1),
                 (-2, -1), (-1, -2), (1, -2), (2, -1))
UNDER_DF = (0, -1, 1)  # push, capture toward file-1, capture toward file+1
UNDER_PROMO = (KNIGHT, BISHOP, ROOK)

# --- plane decode tables (used by step; JAX chess.py:64-77) ------------------
_tdr = np.zeros(NUM_PLANES, np.int64)
_tdf = np.zeros(NUM_PLANES, np.int64)
_tpromo = np.zeros(NUM_PLANES, np.int64)  # piece code on promotion
_tunder = np.zeros(NUM_PLANES, np.int64)  # 1 = dr is relative to mover
for _di, (_dr, _df) in enumerate(DIRS):
    for _k in range(1, 8):
        _p = _di * 7 + _k - 1
        _tdr[_p], _tdf[_p], _tpromo[_p] = _dr * _k, _df * _k, QUEEN
for _i, (_dr, _df) in enumerate(KNIGHT_DELTAS):
    _tdr[56 + _i], _tdf[56 + _i] = _dr, _df
for _u, _dfu in enumerate(UNDER_DF):
    for _pi, _pc in enumerate(UNDER_PROMO):
        _p = 64 + _u * 3 + _pi
        _tdr[_p], _tdf[_p], _tpromo[_p], _tunder[_p] = 1, _dfu, _pc, 1

# Castling-rights mask per square touched: moving from/to these squares
# clears rights [WK, WQ, BK, BQ] (JAX chess.py:81-88).
_rmask = np.ones((64, 4), bool)
_rmask[0 * 8 + 4, 0:2] = False  # e1
_rmask[0 * 8 + 7, 0] = False    # h1
_rmask[0 * 8 + 0, 1] = False    # a1
_rmask[7 * 8 + 4, 2:4] = False  # e8
_rmask[7 * 8 + 7, 2] = False    # h8
_rmask[7 * 8 + 0, 3] = False    # a8

_START = np.zeros((8, 8), np.int8)
_START[0] = [ROOK, KNIGHT, BISHOP, QUEEN, KING, BISHOP, KNIGHT, ROOK]
_START[1] = PAWN
_START[6] = -PAWN
_START[7] = -np.asarray(_START[0])

# Zobrist keys, drawn as the JAX env draws them (chess.py:104-116). Piece
# codes -6..6 map to rows 0..12; empty (row 6) hashes to 0.
_zrng = np.random.default_rng(0xC4E55)
_ztab = _zrng.integers(0, 2**32, size=(13, 64), dtype=np.uint32)
_ztab[6] = 0
_zcastle = _zrng.integers(0, 2**32, size=(4,), dtype=np.uint32)
_zep = _zrng.integers(0, 2**32, size=(8,), dtype=np.uint32)
_zside = np.uint32(int(_zrng.integers(0, 2**32, dtype=np.uint32)))
#: repetition ring length: the 50-move rule's 100 plies plus the current
#: position.
HIST_LEN = 101

# Float roundings of the jitted JAX program on the CPU (module docstring):
# XLA turns ``min(halfmove, 100) / 100.0`` into a product with the float32
# reciprocal, and ``0.5 + mine / 40.0`` into one fused multiply-add with the
# float32 reciprocal (a single rounding, done here in float64, where the
# product of two float32 values is exact). Tables: the clock plane for
# halfmove 0..100, and the crude value before its clip for material
# balances -_MAT_MAX.._MAT_MAX.
_MAT_MAX = 160
_CLOCK = np.arange(101, dtype=np.float32) * np.float32(1 / 100)
_CRUDE = (0.5 + np.arange(-_MAT_MAX, _MAT_MAX + 1, dtype=np.float64)
          * np.float64(np.float32(1 / 40))).astype(np.float32)


def _queen_tables():
    """``QIDX`` [8, 7, 64]: the cell k+1 steps from each cell along each
    queen direction (clamped onto the board), ``QONB`` whether it is on
    the board; ``BIDX``/``BONB`` the same backwards (the cell the content
    came from), for the fills."""
    q = np.zeros((8, 7, 64), np.int64)
    qo = np.zeros((8, 7, 64), bool)
    b = np.zeros((8, 7, 64), np.int64)
    bo = np.zeros((8, 7, 64), bool)
    for d, (dr, df) in enumerate(DIRS):
        for k in range(1, 8):
            for c in range(64):
                r, f = divmod(c, 8)
                for sign, idx, onb in ((1, q, qo), (-1, b, bo)):
                    tr, tf = r + sign * k * dr, f + sign * k * df
                    if 0 <= tr < 8 and 0 <= tf < 8:
                        idx[d, k - 1, c] = tr * 8 + tf
                        onb[d, k - 1, c] = True
    return q, qo, b, bo


def _step_tables(deltas):
    """[D, 64] target cells of one step by each delta, and on-board."""
    idx = np.zeros((len(deltas), 64), np.int64)
    onb = np.zeros((len(deltas), 64), bool)
    for d, (dr, df) in enumerate(deltas):
        for c in range(64):
            r, f = divmod(c, 8)
            if 0 <= r + dr < 8 and 0 <= f + df < 8:
                idx[d, c] = (r + dr) * 8 + f + df
                onb[d, c] = True
    return idx, onb


def _castle_tables():
    """Per right [WK, WQ, BK, BQ] (JAX chess.py:280-295): the squares that
    must be empty, the squares that must not be attacked, the king's
    square (also the move's from-square)."""
    clear = np.zeros((4, 64), bool)
    safe = np.zeros((4, 64), bool)
    king = np.zeros(4, np.int64)
    for i, (rank, east) in enumerate(((0, True), (0, False), (7, True),
                                      (7, False))):
        files_clear = (5, 6) if east else (1, 2, 3)
        files_safe = (4, 5, 6) if east else (2, 3, 4)
        clear[i, [rank * 8 + f for f in files_clear]] = True
        safe[i, [rank * 8 + f for f in files_safe]] = True
        king[i] = rank * 8 + 4
    return clear, safe, king


_QIDX, _QONB, _BIDX, _BONB = _queen_tables()
_KIDX, _KONB = _step_tables(KNIGHT_DELTAS)
_CLEAR, _SAFE, _KSQ = _castle_tables()
#: 0 for the orthogonal directions (rooks), 1 for the diagonal (bishops).
_DIR_KIND = np.array([0 if d in ORTHO else 1 for d in DIRS], np.int64)
_DIR_LINE = np.array([LINE_TYPE[d] for d in DIRS], np.int64)
#: Pawn moves of one step along the queen directions: +1 pushes or
#: captures forward for White (dr = 1), -1 for Black, 0 none; and whether
#: the move is a push (onto an empty square) or a capture.
_PAWN_DIR = np.array([dr for dr, _ in DIRS], np.int64)
_PAWN_PUSH = np.array([df == 0 for _, df in DIRS], bool)
#: Double pushes: the start rank of each direction's pawns (N: rank 1, S:
#: rank 6), none for the others.
_DOUBLE = np.zeros((8, 64), bool)
_DOUBLE[0, 8:16] = True
_DOUBLE[4, 48:56] = True
#: The queen direction of an underpromotion (push, toward file-1, toward
#: file+1) for White and for Black (JAX chess.py:344-349).
_UNDER_WHITE = [DIRS.index((1, df)) for df in UNDER_DF]
_UNDER_BLACK = [DIRS.index((-1, df)) for df in UNDER_DF]


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """The constant tables on ``device``, made once per device."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    cells = np.arange(64)
    zp = _ztab.view(np.int32)
    return dict(
        qidx=t(_QIDX.reshape(8, 7 * 64)), qonb=t(_QONB),
        bidx=t(_BIDX.reshape(8, 7 * 64)), bonb=t(_BONB),
        q1idx=t(_QIDX[:, 0]), q1onb=t(_QONB[:, 0]),
        kidx=t(_KIDX), konb=t(_KONB),
        dir_kind=t(_DIR_KIND), dir_line=t(_DIR_LINE),
        pawn_dir=t(_PAWN_DIR), pawn_push=t(_PAWN_PUSH),
        double=t(_DOUBLE),
        clear=t(_CLEAR), safe=t(_SAFE), ksq=t(_KSQ),
        castle_sq=t(np.eye(64, dtype=bool)[_KSQ]),
        under_white=t(np.array(_UNDER_WHITE)),
        under_black=t(np.array(_UNDER_BLACK)),
        row=t(cells // 8), col=t(cells % 8), cells=t(cells),
        tdr=t(_tdr), tdf=t(_tdf), tpromo=t(_tpromo), tunder=t(_tunder),
        rights=t(_rmask), start=t(_START.reshape(64)),
        zpiece=t(zp.reshape(-1)), zcastle=t(_zcastle.view(np.int32)),
        zep=t(_zep.view(np.int32)),
        zside=t(np.array([_zside]).view(np.int32)),
        clock=t(_CLOCK), crude=t(_CRUDE),
        values=t(np.array([0, 1, 3, 3, 5, 9, 0], np.float32)),
        ring=t(np.arange(HIST_LEN)),
        sides=t(np.array([-1, 1])),  # the en-passant capturers' files
        codes=t(np.array([1, 2, 3, 4, 5, 6, -1, -2, -3, -4, -5, -6],
                         np.int8)),  # the observation's piece planes
    )


@dataclasses.dataclass
class ChessState(EnvState):
    board: torch.Tensor = None  # int8[B, 8, 8]
    castling: torch.Tensor = None  # bool[B, 4] = [WK, WQ, BK, BQ]
    ep: torch.Tensor = None  # int32[B] en-passant target square, -1 = none
    halfmove: torch.Tensor = None  # int32[B], 50-move-rule clock (plies)
    hist: torch.Tensor = None  # int32[B, HIST_LEN] Zobrist ring (see above)


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR of ``x`` [B, 2^n] along its last axis (n launches)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = torch.bitwise_xor(x[..., :h], x[..., h:])
    return x[..., 0]


def _position_hash(flat, castling, ep, player, tb) -> torch.Tensor:
    """int32[B] Zobrist hash (the bits of JAX ``_position_hash``): board
    ``flat`` [B, 64], side to move, castling rights, ep file."""
    rows = torch.clamp(flat.to(torch.int64) + 6, 0, 12)
    h = _xor_fold(tb["zpiece"][rows * 64 + tb["cells"]])
    h = h ^ _xor_fold(torch.where(castling, tb["zcastle"], 0))
    ep_key = tb["zep"][torch.clamp(ep, min=0).long() % 8]
    h = h ^ torch.where(ep >= 0, ep_key, 0)
    return h ^ torch.where(player == 1, tb["zside"], 0)


def _fill(seed, empty, tb):
    """Occluded fills along the 8 queen directions (JAX ``_fill``): cell c
    of direction d is set where a seed sits k = 1..7 steps back along d
    with every cell in between empty. ``seed`` [..., 8, 64] (one seed
    board per direction) and ``empty`` [..., 64] → bool [..., 8, 64]."""
    lead = seed.shape[:-2]
    bidx = tb["bidx"]
    src = seed.gather(-1, bidx.expand(lead + bidx.shape)).unflatten(-1, (7, 64))
    src = src & tb["bonb"]
    # Between-cells of a source k steps back are the cells 1..k-1 back.
    gap = empty[..., bidx].unflatten(-1, (7, 64))
    opened = torch.cummin(gap.to(torch.uint8), dim=-2).values.bool()
    between = torch.cat([torch.ones_like(opened[..., :1, :]),
                         opened[..., :-1, :]], dim=-2)
    return (src & between).any(dim=-2)


def _steps_all(x, idx, onb):
    """Cells one step from any set cell of ``x`` [..., 64] along every
    delta of ``idx``/``onb`` [D, 64] (a symmetric set of deltas)."""
    return (x[..., idx] & onb).any(dim=-2)


def _expand8(x):
    return x[..., None, :].expand(x.shape[:-1] + (8, 64))


def _sliders(rq, bq, tb):
    """[..., 8, 64]: the rook-or-queen board on the orthogonal directions,
    the bishop-or-queen board on the diagonal ones."""
    return torch.stack([rq, bq], dim=-2)[..., tb["dir_kind"], :]


def _attacked(king, occ, op_p, op_n, op_k, op_rq, op_bq, white, tb):
    """bool[...]: is the (single) square in ``king`` [..., 64] attacked?
    (JAX ``_attacked``; boards may carry extra leading axes)."""
    hit = (_steps_all(king, tb["kidx"], tb["konb"]) & op_n).any(dim=-1)
    # near[d, c]: the king sits one step from c along direction d
    near = king[..., tb["q1idx"]] & tb["q1onb"]  # [..., 8, 64]
    hit |= (near.any(dim=-2) & op_k).any(dim=-1)
    # An enemy pawn giving check sits one rank ahead of the king (the
    # mover's forward direction) and one file to the side: at c with the
    # king one step from c along a diagonal pointing backward.
    fwd = torch.where(white, 1, -1)
    back = (tb["pawn_dir"] == -fwd[..., None]) & ~tb["pawn_push"]  # [..., 8]
    hit |= ((near & back[..., None]).any(dim=-2) & op_p).any(dim=-1)
    ray = _fill(_expand8(king), ~occ, tb)
    hit |= (ray & _sliders(op_rq, op_bq, tb)).flatten(-2).any(dim=-1)
    return hit


def _movegen(state: ChessState):
    """Full legal move generation (JAX ``_movegen``) for a batch: returns
    (planes bool[B, 73, 64] indexed by [plane, from-cell], in_check
    bool[B])."""
    B = state.board.shape[0]
    tb = _tables(state.board.device)
    flat = state.board.reshape(B, 64)
    white = state.player == 0
    w1 = white[:, None]
    sign = torch.where(white, 1, -1).to(torch.int8)
    rel = flat * sign[:, None]  # positive = the mover's pieces
    own, enemy = rel > 0, rel < 0
    occ = flat != 0
    empty = ~occ

    my_p, my_n, my_b = rel == PAWN, rel == KNIGHT, rel == BISHOP
    my_r, my_q, my_k = rel == ROOK, rel == QUEEN, rel == KING
    op_p, op_n = rel == -PAWN, rel == -KNIGHT
    op_k, op_q = rel == -KING, rel == -QUEEN
    op_rq, op_bq = (rel == -ROOK) | op_q, (rel == -BISHOP) | op_q
    sliders = _sliders(op_rq, op_bq, tb)  # [B, 8, 64]

    # ---- enemy attack map, x-raying through our king (for king moves) ----
    enemy_att = _steps_all(op_n, tb["kidx"], tb["konb"])
    near_k = op_k[:, tb["q1idx"]] & tb["q1onb"]
    enemy_att |= near_k.any(dim=1)
    # Enemy pawns attack toward the enemy's forward direction: a cell is
    # attacked when an enemy pawn sits one step along a diagonal that
    # points forward for us.
    fwd = torch.where(white, 1, -1)
    diag_fwd = (tb["pawn_dir"][None] == fwd[:, None]) & ~tb["pawn_push"]
    near_p = op_p[:, tb["q1idx"]] & tb["q1onb"] & diag_fwd[..., None]
    enemy_att |= near_p.any(dim=1)
    enemy_att |= _fill(sliders, empty | my_k, tb).any(dim=1)

    # ---- checkers, check-evasion mask, pins (king-ray analysis) ----------
    near_my_k = my_k[:, tb["q1idx"]] & tb["q1onb"]  # [B, 8, 64]
    checkers = _steps_all(my_k, tb["kidx"], tb["konb"]) & op_n
    diag_back = (tb["pawn_dir"][None] == -fwd[:, None]) & ~tb["pawn_push"]
    checkers |= (near_my_k & diag_back[..., None]).any(dim=1) & op_p
    ray = _fill(_expand8(my_k), empty, tb)  # empties + first blocker
    blocker = ray & occ[:, None]
    gives_check = (blocker & sliders).any(dim=-1)  # [B, 8]
    checkmask = checkers | (ray & gives_check[..., None]).any(dim=1)
    check_count = checkers.sum(dim=1) + gives_check.sum(dim=1)
    # pin: first blocker is ours, the next piece beyond a matching slider
    cand = blocker & own[:, None]
    beyond = _fill(cand, empty, tb)
    is_pin = cand.any(dim=-1) & (beyond & occ[:, None] & sliders).any(dim=-1)
    # The 8 rays from the king are disjoint: a cell is on one at most.
    pin_line = torch.where(cand & is_pin[..., None],
                           tb["dir_line"][:, None], -1).amax(dim=1)
    in_check = check_count > 0
    checkmask = (checkmask | ~in_check[:, None]) & (check_count < 2)[:, None]
    unpinned = pin_line < 0
    pin_ok = unpinned[:, None] | (pin_line[:, None] == tb["dir_line"][:, None])

    # ---- queen-like planes [B, 8 dirs, 7 distances, 64] ------------------
    def ahead(x):  # x[c + k·d] for every (d, k): [B, 8, 7, 64]
        return x[:, tb["qidx"]].unflatten(-1, (7, 64)) & tb["qonb"]

    e_ahead = ahead(empty)
    opened = torch.cummin(e_ahead.to(torch.uint8), dim=2).values.bool()
    open_k = torch.cat([torch.ones_like(opened[:, :, :1]),
                        opened[:, :, :-1]], dim=2)
    tgt_ok = tb["qonb"] & ~ahead(own)
    chk = ahead(checkmask)
    slider = (my_q[:, None] | torch.stack([my_r, my_b], dim=1)[
        :, tb["dir_kind"]]) & pin_ok
    v = slider[:, :, None] & open_k & tgt_ok & chk
    # king steps: the attack map instead of the checkmask; no pins
    v[:, :, 0] |= my_k[:, None] & tgt_ok[:, :, 0] & ~ahead(enemy_att)[:, :, 0]
    # pawns: pushes on the vertical directions, captures on the diagonals
    gate = (tb["pawn_dir"][None] == fwd[:, None])  # [B, 8]
    tgt_p = torch.where(tb["pawn_push"][:, None], e_ahead[:, :, 0],
                        ahead(enemy)[:, :, 0])
    pawn = my_p[:, None] & gate[..., None] & pin_ok & tgt_p & chk[:, :, 0]
    v[:, :, 0] |= pawn
    v[:, :, 1] |= (my_p[:, None] & gate[..., None] & tb["double"] & pin_ok
                   & open_k[:, :, 1] & e_ahead[:, :, 1] & chk[:, :, 1])
    # castling: the king slides two files east (kingside) or west
    side_ok = torch.stack([white, white, ~white, ~white], dim=1)
    ok = (side_ok & state.castling
          & ~(occ[:, None] & tb["clear"]).any(dim=-1)
          & ~(enemy_att[:, None] & tb["safe"]).any(dim=-1)
          & my_k[:, tb["ksq"]])
    castle = ok[..., None] & tb["castle_sq"]  # [B, 4, 64]
    v[:, DIRS.index((0, 1)), 1] |= castle[:, 0] | castle[:, 2]
    v[:, DIRS.index((0, -1)), 1] |= castle[:, 1] | castle[:, 3]

    # ---- en passant, validated by simulating the board after it ----------
    has_ep = state.ep >= 0
    ep0 = torch.clamp(state.ep, min=0)
    ep_r, ep_f = ep0 // 8, ep0 % 8
    cap_r = ep_r - fwd  # the capturing pawn's rank == the captured pawn's
    cap_f = ep_f[:, None] + tb["sides"]  # [B, 2]
    inb = (cap_f >= 0) & (cap_f < BOARD)
    row, col = tb["row"], tb["col"]
    from_sq = ((row == cap_r[:, None, None])
               & (col == cap_f.clamp(0, BOARD - 1)[..., None]))  # [B, 2, 64]
    exists = has_ep[:, None] & inb & (from_sq & my_p[:, None]).any(dim=-1)
    captured = (row == cap_r[:, None]) & (col == ep_f[:, None])  # [B, 64]
    target = (row == ep_r[:, None]) & (col == ep_f[:, None])
    occ2 = (occ[:, None] & ~from_sq & ~captured[:, None]) | target[:, None]
    rep = lambda x: x[:, None].expand(B, 2, 64)  # noqa: E731
    legal = exists & ~_attacked(
        rep(my_k), occ2, rep(op_p & ~captured), rep(op_n), rep(op_k),
        rep(op_rq), rep(op_bq), w1.expand(B, 2), tb)
    add = from_sq & legal[..., None]  # [B, 2, 64]
    # the capture's direction is (fwd, -side)
    for s, side in enumerate((-1, 1)):
        for dr, g in ((1, white), (-1, ~white)):
            d = DIRS.index((dr, -side))
            a = add[:, s] & g[:, None]
            v[:, d, 0] |= a
            pawn[:, d] |= a

    # ---- knight planes ---------------------------------------------------
    kidx, konb = tb["kidx"], tb["konb"]
    knight = ((my_n & unpinned)[:, None] & konb & ~own[:, kidx]
              & checkmask[:, kidx])

    # ---- underpromotion planes ---------------------------------------------
    under = torch.where(w1[..., None], pawn[:, tb["under_white"]] & (row == 6),
                        pawn[:, tb["under_black"]] & (row == 1))
    planes = torch.cat([v.reshape(B, 56, 64), knight,
                        under.repeat_interleave(3, dim=1)], dim=1)
    return planes, in_check


def _insufficient_material(flat) -> torch.Tensor:
    a = flat.abs()
    heavy = ((a == PAWN) | (a == ROOK) | (a == QUEEN)).any(dim=1)
    minors = ((a == KNIGHT) | (a == BISHOP)).sum(dim=1)
    return ~heavy & (minors <= 1)


class Chess(Env):
    NAME = "chess"
    NUM_PLAYERS = NUM_PLAYERS
    ACTION_SIZE = ACTION_SIZE
    OBS_SHAPE = (NUM_CHANNELS, BOARD, BOARD)
    MAX_TURNS = MAX_TURNS
    HAS_DRAW = True
    NUM_SYMMETRIES = 1  # castling and pawn structure break the dihedral group

    State = ChessState

    @staticmethod
    def init(batch_size: int, device="cuda") -> ChessState:
        tb = _tables(torch.device(device))
        flat = tb["start"].expand(batch_size, 64)
        castling = torch.ones((batch_size, 4), dtype=torch.bool,
                              device=device)
        z = torch.zeros((batch_size,), dtype=torch.int32, device=device)
        hist = torch.zeros((batch_size, HIST_LEN), dtype=torch.int32,
                           device=device)
        hist[:, 0] = _position_hash(flat, castling, z - 1, z, tb)
        return ChessState(
            player=z, turns=z.clone(), last_action=z - 1,
            board=flat.reshape(batch_size, 8, 8).clone(), castling=castling,
            ep=z - 1, halfmove=z.clone(), hist=hist)

    @staticmethod
    def step(state: ChessState, action: torch.Tensor) -> ChessState:
        """Apply ``action`` (JAX chess.py:400). Every index is clamped onto
        the board: an illegal action (the search's junk steps) changes the
        board somehow but never reads or writes out of range."""
        action = action.to(torch.int32)
        B = action.shape[0]
        dev = action.device
        tb = _tables(dev)
        games = torch.arange(B, device=dev)
        flat = state.board.reshape(B, 64).clone()
        a = action.long()
        from_sq, plane = a // NUM_PLANES, a % NUM_PLANES
        fr, ff = from_sq // 8, from_sq % 8
        white = state.player == 0
        sgn = torch.where(white, 1, -1)
        dr = torch.where(tb["tunder"][plane] == 1, tb["tdr"][plane] * sgn,
                         tb["tdr"][plane])
        tr = (fr + dr).clamp(0, 7)
        tf = (ff + tb["tdf"][plane]).clamp(0, 7)
        to_sq = tr * 8 + tf

        piece = flat[games, from_sq]
        tgt = flat[games, to_sq]
        is_pawn = piece.abs() == PAWN
        # en passant: a diagonal pawn move onto an empty square
        is_ep = is_pawn & (tf != ff) & (tgt == 0)
        cap_sq = torch.where(is_ep, fr, tr) * 8 + tf
        is_capture = (tgt != 0) | is_ep
        is_promo = is_pawn & (tr == torch.where(white, 7, 0))
        new_piece = torch.where(is_promo, (tb["tpromo"][plane] * sgn).to(
            torch.int8), piece)

        # A tensor, not the number 0: a Python number written through tensor
        # indices goes to the card as a host copy, which waits for it.
        empty = torch.zeros_like(piece)
        flat[games, from_sq] = empty
        flat[games, cap_sq] = empty
        flat[games, to_sq] = new_piece
        # castling: move the rook too
        is_castle = (piece.abs() == KING) & ((tf - ff).abs() == 2)
        east = tf > ff
        rook_from = fr * 8 + torch.where(east, 7, 0)
        rook_to = fr * 8 + torch.where(east, 5, 3)
        rook = flat[games, rook_from]
        flat[games, rook_from] = torch.where(is_castle, 0, rook).to(
            torch.int8)
        flat[games, rook_to] = torch.where(is_castle, rook,
                                           flat[games, rook_to])

        castling = (state.castling & tb["rights"][from_sq]
                    & tb["rights"][to_sq])
        is_double = is_pawn & ((tr - fr).abs() == 2)
        ep = torch.where(is_double, ((fr + tr) // 2) * 8 + ff, -1).to(
            torch.int32)
        halfmove = torch.where(is_pawn | is_capture, 0,
                               state.halfmove + 1).to(torch.int32)
        player = (state.player + 1) % NUM_PLAYERS

        # Repetition ring: restarted by every zeroing move; the write index
        # is the clock itself (JAX chess.py:455-463).
        h = _position_hash(flat, castling, ep, player, tb)
        idx = torch.clamp(halfmove, max=HIST_LEN - 1).long()
        hist = torch.where((halfmove == 0)[:, None], 0, state.hist)
        hist[games, idx] = h
        return ChessState(
            player=player, turns=state.turns + 1, last_action=action,
            board=flat.reshape(B, 8, 8), castling=castling, ep=ep,
            halfmove=halfmove, hist=hist)

    @staticmethod
    def valid_moves(state: ChessState) -> torch.Tensor:
        return Chess.win_and_valids(state)[1]

    @staticmethod
    def win_state(state: ChessState) -> torch.Tensor:
        return Chess.win_and_valids(state)[0]

    @staticmethod
    def win_and_valids(state: ChessState):
        """(win_state, valid_moves) from one run of the move generator
        (JAX chess.py:464-486 runs it for each)."""
        planes, in_check = _movegen(state)
        B = planes.shape[0]
        tb = _tables(planes.device)
        valid = planes.transpose(1, 2).reshape(B, ACTION_SIZE)
        no_moves = ~planes.flatten(1).any(dim=1)
        mate = no_moves & in_check
        p0 = mate & (state.player == 1)
        p1 = mate & (state.player == 0)
        flat = state.board.reshape(B, 64)
        cur = _position_hash(flat, state.castling, state.ep, state.player, tb)
        in_ring = tb["ring"][None] <= torch.clamp(
            state.halfmove, max=HIST_LEN - 1)[:, None]
        repetitions = ((state.hist == cur[:, None]) & in_ring).sum(dim=1)
        draw = ((no_moves & ~in_check) | (state.halfmove >= 100)
                | (repetitions >= 3) | (state.turns >= MAX_TURNS)
                | _insufficient_material(flat)) & ~mate
        win = torch.stack([p0, p1, draw], dim=1).to(torch.float32)
        return win, valid

    @staticmethod
    def observation(state: ChessState) -> torch.Tensor:
        """20 planes: 6 White and 6 Black piece planes, the colour to move,
        the turn fraction, the 4 castling rights, the ep square, the
        50-move clock (JAX chess.py:488)."""
        B = state.board.shape[0]
        tb = _tables(state.board.device)
        flat = state.board.reshape(B, 64)
        pieces = (flat[:, None] == tb["codes"][:, None]).to(torch.float32)
        # turns / 512 is exact (a power of two) either way
        scalars = torch.cat([
            state.player.to(torch.float32)[:, None],
            state.turns.to(torch.float32)[:, None] * (1.0 / MAX_TURNS),
            state.castling.to(torch.float32)], dim=1)  # [B, 6]
        ep_plane = (tb["cells"][None] == state.ep[:, None]).to(torch.float32)
        clock = tb["clock"][torch.clamp(state.halfmove, 0, 100).long()]
        planes = torch.cat([
            pieces, scalars[..., None].expand(B, 6, 64), ep_plane[:, None],
            clock[:, None, None].expand(B, 1, 64)], dim=1)
        return planes.reshape(B, NUM_CHANNELS, BOARD, BOARD)

    @staticmethod
    def crude_value(state: ChessState) -> torch.Tensor:
        """Material balance mapped to [0, 1] from the mover's view."""
        B = state.board.shape[0]
        tb = _tables(state.board.device)
        flat = state.board.reshape(B, 64)
        vals = tb["values"][flat.abs().clamp(0, 6).long()]
        mat = (flat.sign().to(torch.float32) * vals).sum(dim=1)
        mine = torch.where(state.player == 0, mat, -mat).to(torch.int64)
        mine = torch.clamp(mine, -_MAT_MAX, _MAT_MAX)
        return torch.clamp(tb["crude"][mine + _MAT_MAX], 0.0, 1.0)

    @classmethod
    def display(cls, state) -> str:
        """Game 0 of ``state`` as text, as the JAX env prints it
        (chess.py:512)."""
        sym = {0: ".", PAWN: "P", KNIGHT: "N", BISHOP: "B", ROOK: "R",
               QUEEN: "Q", KING: "K", -PAWN: "p", -KNIGHT: "n", -BISHOP: "b",
               -ROOK: "r", -QUEEN: "q", -KING: "k"}
        b = state.board[0].tolist()
        rows = [f"{r + 1} " + " ".join(sym[int(v)] for v in b[r])
                for r in range(7, -1, -1)]
        rows.append("  a b c d e f g h")
        rows.append("White to move" if int(state.player[0]) == 0
                    else "Black to move")
        return "\n".join(rows)


Game = Chess


# --- host-side helpers (numpy; for tests, analysis and later players) ------

_FEN_PIECES = {"P": PAWN, "N": KNIGHT, "B": BISHOP, "R": ROOK, "Q": QUEEN,
               "K": KING}


def from_fen(fen: str, device="cpu") -> ChessState:
    """A batch of one ChessState from a FEN string (JAX chess.py:539)."""
    parts = fen.split()
    placement, side = parts[0], parts[1]
    castle = parts[2] if len(parts) > 2 else "-"
    ep_s = parts[3] if len(parts) > 3 else "-"
    half = int(parts[4]) if len(parts) > 4 else 0
    full = int(parts[5]) if len(parts) > 5 else 1
    board = np.zeros((8, 8), np.int8)
    for r, row in enumerate(placement.split("/")):
        f = 0
        for ch in row:
            if ch.isdigit():
                f += int(ch)
            else:
                code = _FEN_PIECES[ch.upper()]
                board[7 - r, f] = code if ch.isupper() else -code
                f += 1
    player = 0 if side == "w" else 1
    rights = np.array([c in castle for c in "KQkq"])
    ep = -1 if ep_s == "-" else (int(ep_s[1]) - 1) * 8 + (ord(ep_s[0]) - 97)
    turns = (full - 1) * 2 + player
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=device)  # noqa: E731
    flat = torch.from_numpy(board.reshape(1, 64)).to(device)
    castling = torch.from_numpy(rights[None]).to(device)
    hist = torch.zeros((1, HIST_LEN), dtype=torch.int32, device=device)
    hist[0, min(half, HIST_LEN - 1)] = _position_hash(
        flat, castling, i32(ep), i32(player), _tables(torch.device(device)))[0]
    return ChessState(
        player=i32(player), turns=i32(turns), last_action=i32(-1),
        board=flat.reshape(1, 8, 8), castling=castling, ep=i32(ep),
        halfmove=i32(half), hist=hist)


def to_fen(state: ChessState, game: int = 0) -> str:
    inv = {v: k for k, v in _FEN_PIECES.items()}
    b = state.board[game].cpu().numpy()
    rows = []
    for r in range(7, -1, -1):
        row, run = "", 0
        for f in range(8):
            v = int(b[r, f])
            if v == 0:
                run += 1
                continue
            if run:
                row, run = row + str(run), 0
            ch = inv[abs(v)]
            row += ch if v > 0 else ch.lower()
        if run:
            row += str(run)
        rows.append(row)
    side = "w" if int(state.player[game]) == 0 else "b"
    rights = "".join(c for c, on in zip(
        "KQkq", state.castling[game].cpu().numpy()) if on) or "-"
    ep = int(state.ep[game])
    ep_s = "-" if ep < 0 else chr(97 + ep % 8) + str(ep // 8 + 1)
    full = int(state.turns[game]) // 2 + 1
    return (f"{'/'.join(rows)} {side} {rights} {ep_s} "
            f"{int(state.halfmove[game])} {full}")


def action_to_uci(state: ChessState, action: int, game: int = 0) -> str:
    plane, from_sq = action % NUM_PLANES, action // NUM_PLANES
    fr, ff = from_sq // 8, from_sq % 8
    white = int(state.player[game]) == 0
    dr = int(_tdr[plane]) * (1 if white or not _tunder[plane] else -1)
    tr, tf = fr + dr, ff + int(_tdf[plane])
    s = chr(97 + ff) + str(fr + 1) + chr(97 + tf) + str(tr + 1)
    piece = int(state.board[game, fr, ff])
    if abs(piece) == PAWN and tr in (0, 7):
        s += {QUEEN: "q", KNIGHT: "n", BISHOP: "b", ROOK: "r"}[
            int(_tpromo[plane])]
    return s


def uci_to_action(state: ChessState, uci: str, game: int = 0) -> int:
    ff, fr = ord(uci[0]) - 97, int(uci[1]) - 1
    tf, tr = ord(uci[2]) - 97, int(uci[3]) - 1
    dr, df = tr - fr, tf - ff
    promo = uci[4] if len(uci) > 4 else ""
    if promo and promo != "q":
        code = {"n": KNIGHT, "b": BISHOP, "r": ROOK}[promo]
        u = UNDER_DF.index(df)
        plane = 64 + u * 3 + UNDER_PROMO.index(code)
    elif (dr, df) in KNIGHT_DELTAS and abs(
            int(state.board[game, fr, ff])) == KNIGHT:
        plane = 56 + KNIGHT_DELTAS.index((dr, df))
    else:
        k = max(abs(dr), abs(df))
        d = (dr // k, df // k)
        plane = DIRS.index(d) * 7 + k - 1
    return (fr * 8 + ff) * NUM_PLANES + plane
