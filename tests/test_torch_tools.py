"""The port's tools against the JAX package's on the CPU: the Elo estimator
(utils/elo.py), the tree renderings (utils/treeviz.py), every env's
``display``, and the five CLIs (pit, analyze, roundrobin, pitmulti, clean)
through their ``main`` with ``--device cpu`` on tiny networks, ``pit``
also over a flax checkpoint written by the JAX package.

Elo, treeviz and display are held exactly equal (the same numpy
arithmetic; the same tree; the same board codes). ``pit`` with random
players gives the same games as the JAX tool from the same seed.
"""

import json

import jax
import numpy as np
import pytest
import torch

import alphazero_general_tpu.mcts.search as JS
import alphazero_general_tpu.mcts.tree as JT
from alphazero_general_tpu.envs import get_env as j_get_env
from alphazero_general_tpu.envs.stacked import (
    make_stacked_env as j_make_stacked,
)
from alphazero_general_tpu.utils import elo as JE
from alphazero_general_tpu.utils import treeviz as JV
from alphazero_general_tpu_torch.envs import get_env, list_envs
from alphazero_general_tpu_torch.envs.stacked import make_stacked_env
from alphazero_general_tpu_torch.models import NNetWrapper
from alphazero_general_tpu_torch.utils import elo as E
from alphazero_general_tpu_torch.utils import get_args
from alphazero_general_tpu_torch.utils import treeviz as V
from test_torch_envs import port_items, to_jax
from test_torch_reuse import port_tree as c4_port_tree

torch.set_num_threads(1)

TINY = dict(num_channels=8, depth=1, value_head_channels=2,
            policy_head_channels=2, value_dense_layers=[8],
            policy_dense_layers=[8])


# --- Elo --------------------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(2, 0), (3, 1), (5, 2), (8, 3)])
def test_elo_matches_jax(n, seed):
    """I-LSR log-strengths, Elo and win probabilities of seeded win
    matrices (one undefeated player in some) equal to the JAX package's."""
    rng = np.random.default_rng(seed)
    wins = rng.integers(0, 40, size=(n, n)).astype(float)
    np.fill_diagonal(wins, 0)
    if seed % 2:
        wins[0, :] += 50
        wins[:, 0] = 0
    got, want = E.ilsr_pairwise_dense(wins), JE.ilsr_pairwise_dense(wins)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(E.to_elo(got), JE.to_elo(want))
    assert abs(got.mean()) < 1e-9
    for i in range(n):
        for j in range(n):
            assert E.win_probability(got, i, j) == JE.win_probability(
                want, i, j)


def test_elo_ordering_and_scale():
    """The JAX package's TestElo cases through the port."""
    wins = np.array([[0, 90, 99], [10, 0, 90], [1, 10, 0]], dtype=float)
    theta = E.ilsr_pairwise_dense(wins)
    assert theta[0] > theta[1] > theta[2]
    assert 0.8 < E.win_probability(theta, 0, 1) < 0.97
    np.testing.assert_allclose(
        E.ilsr_pairwise_dense(np.array([[0, 50], [50, 0]], dtype=float)),
        [0, 0], atol=1e-3)
    elo = E.to_elo(np.array([np.log(10), 0.0]))
    np.testing.assert_allclose(elo[0] - elo[1], 400.0, rtol=1e-6)


# --- treeviz ----------------------------------------------------------------

@pytest.mark.parametrize("render,kw", [
    ("tree_to_dot", dict(max_depth=2)), ("tree_to_dot", {}),
    ("tree_to_text", {}), ("tree_to_text", dict(max_depth=3,
                                                max_children=2))])
def test_treeviz_matches_jax(render, kw):
    """tree_to_dot and tree_to_text of the same searched connect4 trees
    (a JAX raw search of 40 simulations, converted to the port's
    batch-major layout) equal to the JAX package's, for each game."""
    env = j_get_env("connect4")
    states = jax.vmap(lambda _: env.init())(jax.numpy.arange(2))
    spec = JT.SearchSpec(add_root_noise=False, add_root_temp=False)
    trees = JS.raw_search(env, states, spec, 40, jax.random.PRNGKey(0))
    tree = c4_port_tree(trees)
    for game in (0, 1):
        got = getattr(V, render)(tree, game=game, **kw)
        assert got == getattr(JV, render)(trees, game=game, **kw)
    if render == "tree_to_text":
        assert "#0 n=40" in got
    else:
        assert got.startswith("digraph mcts {") and "->" in got


# --- display ----------------------------------------------------------------

@pytest.mark.parametrize("name", list_envs() + ["othello_x2"])
def test_display_matches_jax(name):
    """``display`` of every env (and of a stacked one) equal to the JAX
    env's at every ply of a seeded random game."""
    base, _, k = name.partition("_x")
    env, jenv = get_env(base), j_get_env(base)
    if k:
        env, jenv = make_stacked_env(env, int(k)), j_make_stacked(jenv,
                                                                  int(k))
    rng = np.random.default_rng(5)
    s = env.init(1, "cpu")
    for ply in range(12):
        items = port_items(s)
        js = to_jax(jenv, {f: v[0] for f, v in items.items()})
        assert env.display(s) == jenv.display(js), (name, ply)
        valid = np.flatnonzero(env.valid_moves(s)[0].numpy())
        if not len(valid) or bool(env.terminated(s)[0]):
            break
        s = env.step(s, torch.tensor([rng.choice(valid)], dtype=torch.int32))


def test_stratego_and_tafl_action_helpers_match_jax():
    """The action-to-squares helpers of stratego and tafl equal to the JAX
    envs' over every action that decodes."""
    for name in ("stratego", "brandubh"):
        env, jenv = get_env(name), j_get_env(name)
        for a in range(0, env.ACTION_SIZE, 7):
            try:
                want = jenv.decode_action(a)
            except IndexError:
                continue
            assert env.decode_action(a) == want
            (r, c), (r2, c2) = want
            if (r, c) != (r2, c2):
                assert env.encode_action(r, c, r2, c2) == \
                    jenv.encode_action(r, c, r2, c2)
    st, jst = get_env("stratego"), j_get_env("stratego")
    assert st.encode_place(3, 1, 2) == jst.encode_place(3, 1, 2)
    s = st.init(1, "cpu")
    assert bool(st.in_placement(s)[0]) == jst.in_placement(jst.init())


# --- CLIs -------------------------------------------------------------------

def _save(env, folder, name, seed=0):
    net = NNetWrapper(env, get_args(seed=seed, **TINY), device="cpu")
    net.save_checkpoint(str(folder), name)
    return str(folder / name)


def _game_lines(out):
    return [line for line in out.splitlines()
            if line.startswith(("game ", "final:"))]


def test_pit_random_players_match_jax(capsys):
    """``pit`` with random players (seeds 0 and 1): the same games as the
    JAX tool's, game by game."""
    from alphazero_general_tpu.cli.pit import main as j_main
    from alphazero_general_tpu_torch.cli.pit import main

    argv = ["tictactoe", "--p1", "random", "--p2", "random", "--games", "4",
            "--device", "cpu"]
    assert j_main(argv) == 0
    want = _game_lines(capsys.readouterr().out)
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert _game_lines(out) == want and len(want) == 5
    assert "p1 random:" in out and "ms a move" in out


@pytest.mark.parametrize("p1,p2", [("mcts", "rawmcts"), ("nn", "greedy"),
                                   ("nativemcts", "random")])
def test_pit_players(tmp_path, capsys, p1, p2):
    """``pit`` between each kind of player on connect4 on the CPU: the
    tallies add up and every move was legal (pit checks each)."""
    from alphazero_general_tpu_torch.cli.pit import main

    env = get_env("connect4")
    if p1 in ("mcts", "nn"):
        p1 = f"{p1}:{_save(env, tmp_path, 'iteration-0001')}.ckpt"
    assert main(["connect4", "--p1", p1, "--p2", p2, "--games", "2",
                 "--device", "cpu", "--set", "numMCTSSims=6"]) == 0
    final = _game_lines(capsys.readouterr().out)[-1].replace(",", "").split()
    assert int(final[2]) + int(final[5]) + int(final[7]) == 2


def test_pit_mcts_over_a_flax_checkpoint(tmp_path, capsys):
    """``mcts:`` over a checkpoint written by the JAX package (flax bytes
    and its args file) plays a whole game on the port."""
    from alphazero_general_tpu.models.wrapper import NNetWrapper as JWrapper
    from alphazero_general_tpu.utils.config import get_args as j_get_args
    from alphazero_general_tpu_torch.cli.pit import main

    jnet = JWrapper(j_get_env("connect4"),
                    j_get_args(compute_dtype="float32", **TINY))
    jnet.save_checkpoint(str(tmp_path), "iteration-0003")
    assert main(["connect4", "--p1", f"mcts:{tmp_path}/iteration-0003",
                 "--p2", "random", "--games", "1", "--device", "cpu",
                 "--set", "numMCTSSims=4"]) == 0
    out = capsys.readouterr().out
    assert "final:" in out and "max tree depth" in out


def test_pit_unknown_spec_and_missing_path_exit():
    from alphazero_general_tpu_torch.cli.pit import main

    with pytest.raises(SystemExit):
        main(["tictactoe", "--p1", "nope", "--p2", "random",
              "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs a checkpoint path"):
        main(["tictactoe", "--p1", "mcts", "--p2", "random",
              "--device", "cpu"])


def test_pit_rejects_an_illegal_move():
    """pit checks every move against the valid moves."""
    from alphazero_general_tpu_torch.cli.pit import play_game
    from alphazero_general_tpu_torch.players.players import BasePlayer

    class Stubborn(BasePlayer):
        def play(self, state):
            return 0

    env = get_env("connect4")
    with pytest.raises(ValueError, match="illegal action 0 at turn 6"):
        play_game(env, [Stubborn(env), Stubborn(env)], False, 42, "cpu")


def test_analyze_cli(tmp_path, capsys):
    """The JAX package's analyze cases through the port (the win at 2 on
    top; a terminal position), and with a checkpoint."""
    from alphazero_general_tpu_torch.cli.analyze import main

    assert main(["tictactoe", "--moves", "0,3,1,4", "--sims", "120",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "value (mover):" in out and "1. action 2" in out
    assert main(["tictactoe", "--moves", "0,3,1,4,2", "--device",
                 "cpu"]) == 0
    assert "terminal" in capsys.readouterr().out
    ckpt = _save(get_env("connect4"), tmp_path, "iteration-0002")
    assert main(["connect4", "--ckpt", ckpt, "--moves", "3,3", "--sims",
                 "30", "--device", "cpu"]) == 0
    assert "sims: 30" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="illegal"):
        main(["tictactoe", "--moves", "0,0", "--device", "cpu"])


def test_analyze_cli_row_cap_message():
    """On the card, --sims beyond the CUDA descend's row cap exits with a
    message before any search."""
    from alphazero_general_tpu_torch.cli.analyze import main
    from alphazero_general_tpu_torch.ops.descend import MAX_NODES

    with pytest.raises(SystemExit, match=f"--sims {MAX_NODES}: .*at most"):
        main(["tictactoe", "--sims", str(MAX_NODES), "--device", "cuda"])


def test_roundrobin_pitmulti_and_clean(tmp_path, capsys):
    """``roundrobin`` over two tiny checkpoints and the baseline (win
    matrix, ratings, the JSON file), ``pitmulti`` over the run's folder
    against the baseline (winrates in [0, 1] in the metrics stream), then
    ``clean`` of the run."""
    from alphazero_general_tpu_torch.cli import clean, pitmulti, roundrobin

    env = get_env("connect4")
    folder = tmp_path / "checkpoint" / "rr"
    for i in (1, 2):
        _save(env, folder, f"iteration-000{i}", seed=i)
    out = tmp_path / "rr.json"
    sets = ["--set", "numMCTSSims=3", "--device", "cpu"]
    assert roundrobin.main(["connect4", "--checkpoints",
                            str(folder / "*.ckpt"), "--include-baseline",
                            "--games", "4", "--out", str(out)] + sets) == 0
    assert "=== ratings ===" in capsys.readouterr().out
    rr = json.loads(out.read_text())
    wins = np.asarray(rr["wins"])
    assert rr["names"] == ["iteration-0001", "iteration-0002", "baseline"]
    assert np.allclose((wins + wins.T)[~np.eye(3, dtype=bool)], 4)
    assert np.isfinite(rr["ratings"]).all() and rr["rounds"] > 0

    runs = tmp_path / "runs"
    assert pitmulti.main(["connect4", "--run", "rr", "--checkpoint",
                          str(tmp_path / "checkpoint"), "--runs", str(runs),
                          "--every", "1", "--games", "4"] + sets) == 0
    text = capsys.readouterr().out
    assert "pitting 2 checkpoints vs RawMCTS baseline" in text
    rows = [json.loads(line) for line in
            (runs / "rr-pitmulti" / "metrics.jsonl").read_text().splitlines()]
    assert sorted(r["step"] for r in rows) == [1, 2]
    assert all(r["tag"] == "win_rate/pit_multi" and 0 <= r["value"] <= 1
               for r in rows)
    assert pitmulti.main(["connect4", "--run", "rr", "--checkpoint",
                          str(tmp_path / "checkpoint"), "--runs", str(runs),
                          "--vs", str(folder / "iteration-0001.ckpt"),
                          "--games", "2"] + sets) == 0

    assert clean.main(["rr", "--checkpoint", str(tmp_path / "checkpoint"),
                       "--data", str(tmp_path / "data"), "--runs",
                       str(tmp_path / "runs"), "--yes"]) == 0
    assert not folder.exists()
    assert clean.main(["rr", "--checkpoint", str(tmp_path / "checkpoint"),
                       "--yes"]) == 0
    assert "nothing to remove" in capsys.readouterr().out


def test_clean_matches_jax(tmp_path, capsys, monkeypatch):
    """The JAX package's clean case, and the prompt that aborts."""
    from alphazero_general_tpu_torch.cli.clean import main

    d = tmp_path / "checkpoint" / "foo"
    d.mkdir(parents=True)
    argv = ["foo", "--checkpoint", str(tmp_path / "checkpoint"), "--data",
            str(tmp_path / "data"), "--runs", str(tmp_path / "runs")]
    monkeypatch.setattr("builtins.input", lambda prompt: "n")
    assert main(argv) == 1 and d.exists()
    assert main(argv + ["--yes"]) == 0 and not d.exists()
