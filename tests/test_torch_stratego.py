"""The port's stratego env against the JAX env on the CPU: rollouts through
both phases to the end (``test_torch_envs.rollout``: every state field,
valid mask, win vector, observation, symmetry output and crude value equal
at every ply), and the rule fixtures of tests/test_stratego.py:59-247
through the port."""

import numpy as np
import pytest
import torch

from alphazero_general_tpu.envs import stratego as JS
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs import stratego as TS
from alphazero_general_tpu_torch.envs.core import state_items
from test_torch_envs import rollout

torch.set_num_threads(1)

Stratego = TS.Stratego
SPY, SCOUT, MINER = TS.SPY, TS.SCOUT, TS.MINER
MARSHAL, BOMB, FLAG = TS.MARSHAL, TS.BOMB, TS.FLAG
T_, V_ = TS.TEAM_OFFSET, TS.VISIBLE_OFFSET


def test_tables_match_jax():
    np.testing.assert_array_equal(TS.MIRROR_PERMS, np.asarray(JS.MIRROR_PERMS))
    np.testing.assert_array_equal(TS.DEST_R, JS.DEST_R)
    np.testing.assert_array_equal(TS.DEST_C, JS.DEST_C)
    assert (TS.ACTION_SIZE, TS.MT, TS.CELLS) == (JS.ACTION_SIZE, JS.MT,
                                                  JS.CELLS) == (1280, 16, 80)


def test_rollouts_match_jax():
    """Placement then movement until every game has ended; two games start
    with their turn counter near the 512-turn cap, so that it ends them."""
    env = get_env("stratego")
    B = 6
    items = {k: v.numpy().copy() for k, v in
             state_items(env.init(B, "cpu")).items()}
    items["turns"][:2] = [400, 420]
    outcomes, _ = rollout(env, JS.Stratego, items, seed=3, sym_every=4)
    assert 2 in outcomes and outcomes & {0, 1}


def place_action(piece, r, c):
    return Stratego.encode_place(piece, r, c)


def move_action(r, c, r2, c2):
    return Stratego.encode_action(r, c, r2, c2)


def movement_state(pieces, player=0, turns=TS.PLACEMENT_TURNS):
    """A movement-phase state of one game; pieces = {(r, c): value}."""
    board = TS._START.copy()
    for (r, c), v in pieces.items():
        board[r, c] = v
    s = Stratego.init(1, "cpu")
    s.board = torch.from_numpy(board[None])
    s.red_to_place = torch.zeros_like(s.red_to_place)
    s.blue_to_place = torch.zeros_like(s.blue_to_place)
    s.player = torch.tensor([player], dtype=torch.int32)
    s.turns = torch.tensor([turns], dtype=torch.int32)
    return s


def valid_set(s):
    return set(torch.nonzero(Stratego.valid_moves(s)[0]).flatten().tolist())


def step(s, a):
    return Stratego.step(s, torch.tensor([a]))


def test_placement():
    s = Stratego.init(1, "cpu")
    for a in valid_set(s):
        piece, cell = divmod(a, TS.CELLS)
        assert 1 <= piece <= 12 and cell // TS.W < 3
    s = step(s, place_action(SCOUT, 0, 0))
    assert all((a % TS.CELLS) // TS.W > 4 for a in valid_set(s))
    s = step(step(Stratego.init(1, "cpu"), place_action(SPY, 0, 0)),
             place_action(SPY, 7, 0))
    pieces = {a // TS.CELLS for a in valid_set(s)}
    assert SPY not in pieces and SCOUT in pieces
    assert bool(Stratego.in_placement(s)[0])


def test_movement():
    s = movement_state({(0, 0): MINER, (7, 9): MINER + T_})
    assert valid_set(s) == {move_action(0, 0, 1, 0), move_action(0, 0, 0, 1)}
    s = movement_state({(0, 0): SCOUT, (7, 9): MINER + T_})
    want = {move_action(0, 0, r, 0) for r in range(1, 8)}
    want |= {move_action(0, 0, 0, c) for c in range(1, 10)}
    assert valid_set(s) == want
    v = valid_set(movement_state({(3, 0): SCOUT, (3, 5): MINER,
                                  (7, 9): MINER + T_}))
    assert move_action(3, 0, 3, 1) in v
    assert not {move_action(3, 0, 3, 2), move_action(3, 0, 3, 4)} & v
    v = valid_set(movement_state({(0, 0): SCOUT, (0, 4): MINER + T_,
                                  (0, 6): MINER + T_, (7, 0): FLAG}))
    assert move_action(0, 0, 0, 4) in v
    assert not {move_action(0, 0, 0, 5), move_action(0, 0, 0, 6)} & v
    v = valid_set(movement_state({(0, 0): BOMB, (0, 5): FLAG, (2, 2): MINER,
                                  (7, 9): MINER + T_}))
    assert not {(a // TS.MT) for a in v} & {0, 5}


@pytest.mark.parametrize("attacker,defender,want", [
    (MARSHAL, MINER + T_, MARSHAL + V_),
    (MINER, MARSHAL + T_, MARSHAL + T_ + V_),
    (MINER, MINER + T_, 0),
    (SPY, MARSHAL + T_, SPY + V_),
    (MARSHAL, SPY + T_, MARSHAL + V_),
    (MARSHAL, BOMB + T_, 0),
    # the JAX env's (and the reference's) miner loses to a bomb
    (MINER, BOMB + T_, BOMB + T_ + V_),
])
def test_combat(attacker, defender, want):
    s = movement_state({(2, 0): attacker, (3, 0): defender,
                        (7, 9): FLAG + T_, (0, 9): FLAG})
    s2 = step(s, move_action(2, 0, 3, 0))
    assert int(s2.board[0, 3, 0]) == want
    exploded = defender == BOMB + T_ and attacker != MINER
    assert bool(s2.blue_bombs[0, 3, 0]) == exploded
    assert not bool(s2.red_bombs.any())
    if exploded:
        assert Stratego.observation(s2)[0, 27, 3, 0] == 1.0


def test_flag_capture_visibility_and_stuck():
    s = movement_state({(2, 0): MINER, (3, 0): FLAG + T_, (0, 9): FLAG,
                        (7, 9): MINER + T_})
    s2 = step(s, move_action(2, 0, 3, 0))
    assert bool(s2.blue_flag_captured[0])
    assert Stratego.win_state(s2)[0].tolist() == [1, 0, 0]
    s = movement_state({(2, 0): MINER + V_, (0, 9): FLAG, (7, 9): FLAG + T_})
    assert int(step(s, move_action(2, 0, 2, 1)).board[0, 2, 1]) == MINER
    s = movement_state({(0, 0): BOMB, (0, 1): FLAG, (7, 9): MINER + T_})
    assert Stratego.win_state(s)[0].tolist() == [0, 1, 0]
    s = movement_state({(0, 0): MINER, (7, 9): MINER + T_},
                       turns=TS.DRAW_MOVE_COUNT)
    assert Stratego.win_state(s)[0].tolist() == [0, 0, 1]


def test_symmetries():
    s = movement_state({(2, 1): MINER, (0, 9): FLAG, (7, 9): FLAG + T_})
    obs = Stratego.observation(s)
    pi = torch.zeros((1, TS.ACTION_SIZE))
    pi[0, move_action(2, 1, 2, 2)] = 1.0
    obs_k, pi_k = Stratego.symmetries(obs, pi)
    assert pi_k[0, 1, move_action(2, 8, 2, 7)] == 1.0
    assert torch.equal(obs_k[0, 1], obs[0].flip(-1))
    s = Stratego.init(1, "cpu")
    pi = torch.zeros((1, TS.ACTION_SIZE))
    pi[0, place_action(SCOUT, 0, 0)] = 1.0
    _, pi_k = Stratego.symmetries(Stratego.observation(s), pi)
    assert pi_k[0, 1, place_action(SCOUT, 0, TS.W - 1)] == 1.0


def test_illegal_actions_stay_in_range():
    """Every action id steps in either phase without an out-of-range
    index (the search's junk steps)."""
    for s in (Stratego.init(1, "cpu"),
              movement_state({(0, 0): MINER, (7, 9): MINER + T_})):
        many = Stratego.State(**{k: x.expand((TS.ACTION_SIZE,) + x.shape[1:])
                                 for k, x in state_items(s).items()})
        out = Stratego.step(many, torch.arange(TS.ACTION_SIZE,
                                               dtype=torch.int32))
        assert out.board.shape == (TS.ACTION_SIZE, TS.H, TS.W)
        Stratego.win_and_valids(out)


def test_stratego_search_matches_jax():
    """A fresh-tree search (A = 1280) of 6 games, some still placing and
    some in the movement phase, 12 simulations, against JAX's ``xla``
    walk, one table evaluation: visit counts and links equal, q, v within
    1e-6."""
    from test_torch_envs import assert_search_matches_jax, random_items

    items = random_items(get_env("stratego"), 6, seed=8, max_plies=90)
    assert {bool(x) for x in items["red_to_place"].sum(1) == 0} == {
        True, False}
    assert_search_matches_jax("stratego", 6, 12, items)


def test_stratego_move_runners_match_jax():
    """A full and a fast move with JAX's draws: the sparse top-(sims + 1)
    records equal once densified."""
    from test_torch_envs import assert_move_runners_match_jax

    assert_move_runners_match_jax("stratego", 3, kinds=("full", "fast"))
