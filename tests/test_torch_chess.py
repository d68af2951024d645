"""The port's chess env against the JAX env and the published perft counts,
on the CPU.

* Rollouts to the end (``test_torch_envs.rollout``): games from the start
  position and from the six perft positions of tests/test_chess.py, one
  of them a few plies before the 512-ply cap, with every state field (the
  Zobrist ring compared as uint32), valid mask, win vector, observation
  and crude value equal to JAX's at every ply.
* Perft: the node counts of the six standard positions at the depths of
  tests/test_chess.py:72-88 (chessprogramming.org), through the port's
  ``valid_moves`` and ``step`` alone.
* The rule fixtures of tests/test_chess.py:106-239 through the port.
* The clock plane of every halfmove 0..100 and the crude value of every
  material balance, bit for bit against the jitted JAX env.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_general_tpu.envs import chess as JC
from alphazero_general_tpu_torch.envs import chess as TC
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs.core import state_items
from test_torch_envs import rollout

torch.set_num_threads(1)

Chess = TC.Chess
PERFT_CASES = [
    ("startpos", None, [20, 400, 8902, 197281]),
    ("kiwipete",
     "r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1",
     [48, 2039, 97862]),
    ("pos3", "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1",
     [14, 191, 2812, 43238]),
    ("pos4",
     "r3k2r/Pppp1ppp/1b3nbN/nP6/BBP1P3/q4N2/Pp1P2PP/R2Q1RK1 w kq - 0 1",
     [6, 264, 9467]),
    ("pos5", "rnbq1k1r/pp1Pbppp/2p5/8/2B5/8/PPP1NnPP/RNBQK2R w KQ - 1 8",
     [44, 1486, 62379]),
    ("pos6",
     "r4rk1/1pp1qppp/p1np1n2/2b1p1B1/2B1P1b1/P1NP1N2/1PP1QPPP/R4RK1 w - - 0 10",
     [46, 2079, 89890]),
]
#: Positions a perft level expands at once (bounds the CPU's memory).
CHUNK = 4096


def _stack(states):
    return Chess.State(**{k: torch.cat([getattr(s, k) for s in states])
                          for k in state_items(states[0])})


def _start(fen):
    return Chess.init(1, "cpu") if fen is None else TC.from_fen(fen)


def perft_counts(state, depth):
    """[perft(1), ..., perft(depth)] in one expansion per level."""
    counts = []
    for d in range(depth):
        nxt = []
        n = 0
        for lo in range(0, state.player.shape[0], CHUNK):
            part = Chess.State(**{k: x[lo: lo + CHUNK] for k, x in
                                  state_items(state).items()})
            valid = Chess.valid_moves(part)
            n += int(valid.sum())
            if d < depth - 1:
                g, a = torch.nonzero(valid, as_tuple=True)
                sub = Chess.State(**{k: x[g] for k, x in
                                     state_items(part).items()})
                nxt.append(Chess.step(sub, a.to(torch.int32)))
        counts.append(n)
        if d < depth - 1:
            state = _stack(nxt)
    return counts


@pytest.mark.parametrize("name,fen,expected", PERFT_CASES,
                         ids=[c[0] for c in PERFT_CASES])
def test_perft(name, fen, expected):
    assert perft_counts(_start(fen), len(expected)) == expected, name


def test_rollouts_match_jax():
    starts = [_start(None), _start(None)] + [_start(f) for _, f, _ in
                                             PERFT_CASES[1:]]
    state = _stack(starts)
    items = {k: v.numpy().copy() for k, v in state_items(state).items()}
    items["turns"][1] = Chess.MAX_TURNS - 6  # the ply cap ends this one
    outcomes, plies = rollout(get_env("chess"), JC.Chess, items, seed=5)
    assert 2 in outcomes and plies > 6


def test_hash_and_roundings_match_jax():
    """The start position's Zobrist hash, the clock plane for every
    halfmove 0..100 and the crude value for material balances in reach,
    bit for bit against the jitted JAX env."""
    s = Chess.init(1, "cpu")
    j = JC.Chess.init()
    assert s.hist.numpy().view(np.uint32)[0, 0] == int(j.hist[0])
    B = 101
    base = {k: np.repeat(v.numpy(), B, axis=0)
            for k, v in state_items(s).items()}
    base["halfmove"] = np.arange(B, dtype=np.int32)
    ts = Chess.State(**{k: torch.from_numpy(v) for k, v in base.items()})
    js = jax.vmap(lambda h: j.replace(halfmove=h))(jnp.arange(B,
                                                             dtype=jnp.int32))
    want = np.asarray(jax.jit(jax.vmap(JC.Chess.observation))(js))
    np.testing.assert_array_equal(Chess.observation(ts).numpy(), want)
    # Material balances: remove black pieces one square at a time.
    rng = np.random.default_rng(0)
    boards = np.repeat(JC._START[None], 64, axis=0)
    for b in range(64):
        boards[b][rng.random((8, 8)) < b / 64] = 0
    boards[:, 0, 4], boards[:, 7, 4] = TC.KING, -TC.KING
    players = (np.arange(64) % 2).astype(np.int32)
    ts = Chess.State(**{**{k: torch.from_numpy(np.repeat(v.numpy(), 64, 0))
                           for k, v in state_items(s).items()},
                        "board": torch.from_numpy(boards),
                        "player": torch.from_numpy(players)})
    js = jax.vmap(lambda b, p: j.replace(board=b, player=p))(
        jnp.asarray(boards), jnp.asarray(players))
    np.testing.assert_array_equal(
        Chess.crude_value(ts).numpy(),
        np.asarray(jax.jit(jax.vmap(JC.Chess.crude_value))(js)))


def _play(state, *ucis):
    for u in ucis:
        a = TC.uci_to_action(state, u)
        assert bool(Chess.valid_moves(state)[0, a]), f"{u} not legal"
        state = Chess.step(state, torch.tensor([a]))
    return state


def _win(state):
    return Chess.win_state(state)[0].tolist()


def test_fen_round_trip_and_ruy_lopez():
    s = Chess.init(1, "cpu")
    assert TC.to_fen(s) == (
        "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1")
    s = _play(s, "e2e4", "e7e5", "g1f3", "b8c6", "f1b5")
    assert TC.to_fen(s) == (
        "r1bqkbnr/pppp1ppp/2n5/1B2p3/4P3/5N2/PPPP1PPP/RNBQK2R b KQkq - 3 3")
    for _, fen, _ in PERFT_CASES[1:]:
        assert TC.to_fen(TC.from_fen(fen)) == fen


def test_en_passant():
    s = _play(Chess.init(1, "cpu"), "e2e4", "a7a6", "e4e5", "d7d5")
    assert TC.to_fen(s).split()[3] == "d6"
    s2 = _play(s, "e5d6")
    b = s2.board[0].numpy()
    assert b[5, 3] == 1 and b[4, 3] == 0  # pawn on d6, d5 emptied
    # exd3 would leave the a4 king open to the h4 rook along rank 4.
    s = TC.from_fen("8/8/8/8/k2Pp2R/8/8/4K3 b - d3 0 1")
    v = Chess.valid_moves(s)[0]
    assert not bool(v[TC.uci_to_action(s, "e4d3")])
    assert bool(v[TC.uci_to_action(s, "e4e3")])


def test_castling_and_rights():
    s = _play(Chess.init(1, "cpu"), "e2e4", "e7e5", "g1f3", "b8c6", "f1c4",
              "g8f6", "e1g1")
    b = s.board[0].numpy()
    assert b[0, 6] == 6 and b[0, 5] == 4 and b[0, 4] == 0 and b[0, 7] == 0
    assert s.castling[0].tolist() == [False, False, True, True]
    s = _play(TC.from_fen("r3k2r/8/8/8/8/8/8/R3K2R w KQkq - 0 1"), "a1a8")
    assert s.castling[0].tolist() == [True, False, True, False]


def test_promotions():
    s = TC.from_fen("8/P6k/8/8/8/8/6K1/8 w - - 0 1")
    assert _play(s, "a7a8q").board[0, 7, 0] == 5
    assert _play(s, "a7a8n").board[0, 7, 0] == 2


def test_mate_stalemate_and_draw_rules():
    assert _win(_play(Chess.init(1, "cpu"), "f2f3", "e7e5", "g2g4",
                      "d8h4")) == [0.0, 1.0, 0.0]
    for fen, want in (("7k/5Q2/6K1/8/8/8/8/8 b - - 0 1", [0, 0, 1]),
                      ("4k3/8/8/8/8/8/8/4K2R w - - 100 80", [0, 0, 1]),
                      ("4k3/8/8/8/8/8/8/4KN2 w - - 0 1", [0, 0, 1]),
                      ("4k3/8/8/8/8/8/8/4K2R w - - 0 1", [0, 0, 0])):
        assert _win(TC.from_fen(fen)) == want, fen


def test_threefold_repetition_and_ring_reset():
    s = Chess.init(1, "cpu")
    for cycle in range(2):
        for u in ["g1f3", "g8f6", "f3g1", "f6g8"]:
            assert sum(_win(s)) == 0, (cycle, u)
            s = _play(s, u)
    assert _win(s) == [0.0, 0.0, 1.0]
    s = _play(Chess.init(1, "cpu"), "g1f3", "g8f6", "f3g1", "f6g8",
              "e2e4", "e7e5", "g1f3", "g8f6", "f3g1", "f6g8")
    assert sum(_win(s)) == 0


def test_uci_round_trip_all_legal_moves():
    for fen in (None, PERFT_CASES[1][1], PERFT_CASES[4][1]):
        s = _start(fen)
        for a in torch.nonzero(Chess.valid_moves(s)[0]).flatten().tolist():
            assert TC.uci_to_action(s, TC.action_to_uci(s, a)) == a


def test_registry_and_contract():
    env = get_env("chess")
    assert env is Chess
    s = env.init(2, "cpu")
    assert env.observation(s).shape == (2,) + env.OBS_SHAPE
    assert env.valid_moves(s).shape == (2, env.ACTION_SIZE)
    assert env.crude_value(s).tolist() == [0.5, 0.5]


def test_illegal_actions_stay_in_range():
    """The search steps junk actions for games whose walk found no new
    leaf; every action id must step without an out-of-range index."""
    s = Chess.init(1, "cpu")
    many = Chess.State(**{k: x.expand((TC.ACTION_SIZE,) + x.shape[1:])
                          for k, x in state_items(s).items()})
    out = Chess.step(many, torch.arange(TC.ACTION_SIZE, dtype=torch.int32))
    assert out.board.shape == (TC.ACTION_SIZE, 8, 8)
    Chess.win_and_valids(out)

