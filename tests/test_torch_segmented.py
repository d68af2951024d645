"""The growing-arena segmented search of the port: the cases of
tests/test_segmented.py on the port, and its segmented game-minor search
against the JAX package's on the CPU.

A fresh search runs simulations [lo, hi) on the first n rows of its trees
(``search._segment_plan``), with each simulation's row and draws as in one
flat loop. The game-minor TreeT runs on views of its leading rows and must
end bit-identical to the flat loop in every field; the batch-major Tree
runs on contiguous copies whose sink row (n - 1) collects the junk of
masked writes, so it must equal the flat loop in every field but the full
tree's sink row, where the flat loop parks the junk of every simulation.
"""

import dataclasses

import numpy as np
import pytest
import torch

import alphazero_general_tpu.mcts.search as JS
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.mcts import search as S
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts import tree_t as TT
from alphazero_general_tpu_torch.selfplay import selfplay as SP
from test_torch_multileaf import assert_matches_jax, port_and_jax_search
from test_torch_search import random_positions

torch.set_num_threads(1)

SPEC = T.SearchSpec(num_players=2, has_draw=True)
PLANS = [(200, 203), (40, 43), (10, 13), (2, 5), (100, 300), (31, 34)]


def _flat_plan(sims, rows, min_nodes=32):
    return [(rows, 1, sims)]


def _search(env, sims, layout, seed=7, B=128):
    """A fresh search of ``sims`` simulations from the start position, of
    the uniform evaluation with uniform values, root and tie noise drawn
    from a seeded generator."""
    states = env.init(B, "cpu")
    init = TT.init_tree_t if layout == "treet" else T.init_tree
    tree = init(env, states, sims + 2, 3)
    eval_fn = S.uniform_eval_fn(env.ACTION_SIZE, 3, uniform_value=True)
    return S.search(env, tree, SPEC, eval_fn, sims,
                    torch.Generator().manual_seed(seed))


def _fields(tree):
    """(name, tensor) of every tensor of a Tree or TreeT."""
    out = [(f"node_state.{k}", x) for k, x in tree.node_state.items()]
    for f in dataclasses.fields(tree):
        x = getattr(tree, f.name)
        if isinstance(x, torch.Tensor):
            out.append((f.name, x))
    return out


@pytest.mark.parametrize("sims,rows", PLANS)
def test_plan_covers_all_sims_in_order(sims, rows):
    """Each simulation 1..sims-1 once, in order; every segment's rows
    within the tree and its writes below its sink; JAX's plan."""
    plan = S._segment_plan(sims, rows)
    assert [k for _, lo, hi in plan for k in range(lo, hi)] == list(
        range(1, sims))
    for n, lo, hi in plan:
        assert hi <= n - 1 or n == rows
        assert n <= rows
    assert plan == JS._segment_plan(sims, rows)


def test_small_search_is_single_segment():
    assert S._segment_plan(10, 13) == [(13, 1, 10)]


def test_big_search_segments_double():
    assert S._segment_plan(200, 203) == [(32, 1, 31), (64, 31, 63),
                                         (128, 63, 127), (203, 127, 200)]


def test_treet_path_matches_flat_scan(monkeypatch):
    """connect4, 40 simulations (segments of 32 and 43 rows): every field
    of the TreeT bit-identical to the flat loop's."""
    env = get_env("connect4")
    seg = _search(env, 40, "treet")
    monkeypatch.setattr(S, "_segment_plan", _flat_plan)
    flat = _search(env, 40, "treet")
    for (name, a), (_, b) in zip(_fields(seg), _fields(flat)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("envname", ["connect4", "tictactoe"])
def test_batch_major_matches_flat_scan(envname, monkeypatch):
    """The batch-major fresh search (the players'), 40 simulations: every
    field equal to the flat loop's but the sink row."""
    env = get_env(envname)
    seg = _search(env, 40, "tree", B=16)
    monkeypatch.setattr(S, "_segment_plan", _flat_plan)
    flat = _search(env, 40, "tree", B=16)
    for (name, a), (_, b) in zip(_fields(seg), _fields(flat)):
        if a.dim() > 1:  # [B, N, ...]: the sink row is the last
            a, b = a[:, :-1], b[:, :-1]
        assert torch.equal(a, b), name


def test_treet_matches_batch_major_segmented():
    """Both layouts' segmented searches with the same draws: the same root
    visit counts and policies."""
    env = get_env("connect4")
    a, b = _search(env, 40, "treet", seed=11), _search(env, 40, "tree",
                                                       seed=11)
    assert torch.equal(T.counts(a), T.counts(b))
    torch.testing.assert_close(T.probs(a, 1.0), T.probs(b, 1.0), rtol=1e-6,
                               atol=0)


def test_treet_matches_jax_segmented():
    """The port's segmented TreeT search (40 simulations) against the JAX
    package's segmented pallas_interpret one, from random openings with
    noise on and JAX's draws injected."""
    assert len(S._segment_plan(40, 43)) == 2
    tt, jt = port_and_jax_search(random_positions(16, seed=33, max_plies=8),
                                 40, leaf_batch=1, rng_seed=3)
    assert_matches_jax(tt, jt)


def test_move_kinds_build_right_sized_arenas(monkeypatch):
    """Fast, full and warmup moves build fresh trees sized to their own
    simulations (a fast search never walks rows of a full one's size)."""
    env = get_env("tictactoe")
    cfg = SP.SelfPlayConfig(sims_full=24, sims_fast=6, sims_warmup=4,
                            spec=SPEC)
    seen = {}
    real_init = SP.init_tree_t

    def capture(env_, states, capacity, value_size):
        seen["capacity"] = capacity
        return real_init(env_, states, capacity, value_size)

    monkeypatch.setattr(SP, "init_tree_t", capture)

    def apply_fn(obs):
        zeros = torch.zeros((obs.shape[0], env.ACTION_SIZE))
        return torch.log_softmax(zeros, -1), torch.log_softmax(
            zeros[:, :3], -1)

    fns = SP.make_move_fns(env, cfg, apply_fn)
    gen = torch.Generator().manual_seed(0)
    carry = SP.init_selfplay(env, 8, 1.0, device="cpu")
    carry, rec = fns["fast"](carry, generator=gen)
    assert seen["capacity"] == cfg.sims_fast + 2
    # Fast moves ship no obs or pi: finalize discards their samples.
    assert rec.pi is None and rec.obs is None
    carry, rec = fns["full"](carry, generator=gen)
    assert seen["capacity"] == cfg.sims_full + 2
    assert np.allclose(rec.pi.float().sum(-1).numpy(), 1.0, atol=2**-11)
    carry, rec = fns["warmup"](carry, generator=gen)
    assert seen["capacity"] == cfg.sims_warmup + 2
