"""The port's descent and backup against the JAX Pallas kernels.

The plain PyTorch versions (what a CPU tensor runs) are held against the
JAX kernels in interpret mode on TreeT snapshots taken part-way through a
JAX search, on seeded random trees (utils/random_tree.py: tiny and ragged
shapes, long chains, junk in the sink row) in both layouts (the batch-major
entry points against JAX's batch-major ones on the trees transposed to
[B, N]), and on hand-built edge cases. Snapshots of reused trees in
batch-major layout are in test_torch_reuse.py. Integer outputs must be equal;
floats agree within rtol 1e-6, atol 1e-7 (the exp of the backup's discount
may round differently in the last place). The CUDA kernels themselves are
held against the plain versions by the ``gpu`` tests of test_torch_cuda.py,
on a card only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphazero_general_tpu.mcts.search as JS
import alphazero_general_tpu.mcts.tree_t as JTT
from alphazero_general_tpu.envs.connect4 import Connect4 as JConnect4
from alphazero_general_tpu.mcts.tree import SearchSpec as JSpec
from alphazero_general_tpu.ops.backup import (backup_batched_pallas,
                                              backup_batched_pallas_t)
from alphazero_general_tpu.ops.descend import descend_batched_pallas
from alphazero_general_tpu.ops.descend import descend_batched_t as j_descend_t
from alphazero_general_tpu_torch.mcts.tree import SearchSpec
from alphazero_general_tpu_torch.ops import backup as OB
from alphazero_general_tpu_torch.ops import descend as OD
from alphazero_general_tpu_torch.utils.random_tree import random_tree
from test_torch_cuda import COLUMNS, edge_case_tree

RTOL, ATOL = 1e-6, 1e-7
B = 128
SPEC_KW = dict(cpuct=1.25, fpu_reduction=0.2, min_discount=0.8,
               add_root_noise=False, add_root_temp=False, num_players=2,
               has_draw=True)


def pseudo_net(obs):
    """A fixed smooth function of the observation (as in
    tests/test_descend_pallas.py), so that trees differ across games."""
    obs = jnp.asarray(obs, jnp.float32)
    flat = obs.reshape(obs.shape[0], -1)
    w = jnp.sin(jnp.arange(flat.shape[1], dtype=jnp.float32)[:, None]
                * jnp.arange(1, 8)[None, :] * 0.37)
    vw = jnp.cos(jnp.arange(flat.shape[1], dtype=jnp.float32)[:, None]
                 * jnp.array([0.11, 0.23, 0.31])[None, :])
    return jax.nn.softmax(flat @ w, axis=-1), jax.nn.softmax(flat @ vw,
                                                             axis=-1)


def batch_states(batch, seed):
    rng = np.random.default_rng(seed)
    states = []
    for _ in range(batch):
        s = JConnect4.init()
        for _ in range(int(rng.integers(0, 5))):
            valids = np.flatnonzero(np.asarray(JConnect4.valid_moves(s)))
            s = JConnect4.step(s, int(rng.choice(valids)))
        states.append(s)
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


@pytest.fixture(scope="module")
def snapshots():
    """JAX TreeTs after 24 simulations (capacity 33, N = 34) from two sets
    of random openings."""
    spec = JSpec(**SPEC_KW)
    out = []
    sims = 24
    for seed in (3, 4):
        states = batch_states(B, seed=seed)
        trees = JS.init_batched_trees(JConnect4, states, 33, 3)
        trees = JS.search(JConnect4, trees, spec, pseudo_net, sims,
                          jax.random.PRNGKey(seed), walk_impl="xla")
        out.append((sims, JTT.tree_to_tree_t(trees)))
    return out


def _torch_cols(tt):
    return [torch.from_numpy(np.array(getattr(tt, c))) for c in COLUMNS]


def _assert_walks_equal(got, want):
    for name, g, w in zip(("node", "action", "child", "depth"), got[:4],
                          want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[-1]),
                               rtol=RTOL, atol=ATOL, err_msg="p_sel")


def test_descend_plain_matches_jax_kernel_on_snapshots(snapshots):
    spec = SearchSpec(**SPEC_KW)
    for _, jt in snapshots:
        want = j_descend_t(jt, JSpec(**SPEC_KW), interpret=True)
        got = OD.descend_columns(*_torch_cols(jt), spec)
        _assert_walks_equal(got, want)
        # The walks really go somewhere: most games descend below the root.
        assert (got[3] > 1).float().mean() > 0.5


def test_backup_plain_matches_jax_kernel_on_snapshots(snapshots):
    """The leaf of the next walk (freshly allocated, n == 0) and random
    existing nodes as leaves, with a discount below 1."""
    jspec = JSpec(**SPEC_KW)
    spec = SearchSpec(**SPEC_KW)
    rng = np.random.default_rng(7)
    for sims, jt in snapshots:
        walk = j_descend_t(jt, jspec, interpret=True)
        jt2, *_ = JTT.apply_walk_observe_t(JConnect4, jt, *walk, sims)
        parent = np.array(jt2.parent)
        live = [np.flatnonzero((parent[:-1, b] >= 0)) for b in range(B)]
        random_leaf = np.array([rng.choice(r) if len(r) else 0
                                for r in live], np.int32)
        for leaf in (np.array(jt2.leaf), random_leaf):
            value = rng.dirichlet(np.ones(3), B).astype(np.float32)
            value[:4] = [[0.5, 0.5, 0.0], [0.25, 0.25, 0.5], [0, 0, 1],
                         [1, 0, 0]]  # exact draw values and a certain win
            max_depth = np.maximum(np.array(jt2.max_depth), 1) \
                + rng.integers(0, 3, B).astype(np.int32)
            args = [np.array(jt2.parent), np.array(jt2.player), leaf, value,
                    max_depth.astype(np.int32)]
            nqv = [np.array(jt2.n), np.array(jt2.q), np.array(jt2.v)]
            want = backup_batched_pallas_t(
                *map(jnp.asarray, args + nqv), jspec, interpret=True)
            got = [torch.from_numpy(x.copy()) for x in nqv]
            OB.backup_columns_(*map(torch.from_numpy, args), *got, spec)
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=RTOL, atol=ATOL)


def test_descend_edge_cases_match_jax_kernel():
    kw = dict(SPEC_KW, fpu_reduction=0.5)
    cols = edge_case_tree()
    tt = JTT.TreeT(**{c: jnp.asarray(x) for c, x in zip(COLUMNS, cols)},
                   node_state=None, valids=None, prior=None, e=None,
                   player=None, expanded=None, next_free=None, depth=None,
                   max_depth=None, leaf=None)
    want = j_descend_t(tt, JSpec(**kw), interpret=True)
    got = OD.descend_columns(*map(torch.from_numpy, cols), SearchSpec(**kw))
    _assert_walks_equal(got, want)
    node, action, child, depth = (x.tolist() for x in got[:4])
    assert (node[:2], child[:2], depth[:2]) == ([0, 0], [-1, -1], [0, 0])
    assert (node[2], action[2], child[2], depth[2]) == (1, 6, -1, 2)
    assert (node[3], action[3], child[3]) == (0, 4, -1)
    assert (node[4], child[4]) == (2, 2) and (node[5], child[5]) == (2, 2)


def test_backup_edge_cases_match_jax_kernel():
    """Leaf at the root (no path), and values exactly at, below and above
    the draw value 0.5 under min_discount 0.8."""
    kw = dict(SPEC_KW, min_discount=0.8)
    cols = edge_case_tree()
    parent = cols[0].copy()
    player = np.tile(np.array([[0], [1], [1], [0], [0], [1]], np.int32),
                     (1, parent.shape[1]))
    leaf = np.array([0, 0, 1, 1, 2, 2], np.int32)
    value = np.array([[0.2, 0.3, 0.5], [1, 0, 0], [0.25, 0.25, 0.5],
                      [0.5, 0.5, 0], [0.1, 0.8, 0.1], [0.7, 0.2, 0.1]],
                     np.float32)
    max_depth = np.array([1, 1, 2, 3, 1, 5], np.int32)
    nqv = [cols[2].copy(), cols[3].copy(), cols[4].copy()]
    args = [parent, player, leaf, value, max_depth]
    want = backup_batched_pallas_t(*map(jnp.asarray, args + nqv),
                                   JSpec(**kw), interpret=True)
    got = [torch.from_numpy(x.copy()) for x in nqv]
    OB.backup_columns_(*map(torch.from_numpy, args), *got, SearchSpec(**kw))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_wrappers_reject_bad_inputs():
    cols = [torch.from_numpy(x) for x in edge_case_tree()]
    spec = SearchSpec()
    with pytest.raises(TypeError):
        OD.descend_columns(*cols[:3], cols[3].double(), *cols[4:], spec)
    with pytest.raises(ValueError):
        OD.descend_columns(cols[0][:-1], *cols[1:], spec)
    with pytest.raises(ValueError):
        OD.descend_columns(cols[0].t(), *(c.t() for c in cols[1:]), spec)
    n, q, v = cols[2].clone(), cols[3].clone(), cols[4].clone()
    leaf = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError):
        OB.backup_columns_(cols[0], cols[0], leaf, torch.zeros(6, 2),
                           leaf, n, q, v, spec)


#: (N, B) of the random trees: the smallest tree, N not a multiple of 32,
#: and B not a multiple of 8 (the descend kernel's games a block) or of 128
#: (the JAX kernels' lane tile, which they pad to).
RANDOM_SHAPES = ((2, 7), (43, 100), (70, 128), (100, 13))


def _jax_tree_t(cols):
    return JTT.TreeT(**{c: jnp.asarray(x) for c, x in zip(COLUMNS, cols)},
                     node_state=None, valids=None, prior=None, e=None,
                     player=None, expanded=None, next_free=None, depth=None,
                     max_depth=None, leaf=None)


@pytest.mark.parametrize("N,B", RANDOM_SHAPES)
def test_descend_plain_matches_jax_kernel_on_random_trees(N, B):
    tree = random_tree(N, B, seed=N * 1000 + B)
    cols = [tree[c] for c in COLUMNS]
    want = j_descend_t(_jax_tree_t(cols), JSpec(**SPEC_KW), interpret=True)
    got = OD.descend_columns(*map(torch.from_numpy, cols),
                             SearchSpec(**SPEC_KW))
    _assert_walks_equal(got, want)
    if N > 2:  # the chain games walk down their whole chain
        assert int(got[3].max()) >= min(N - 1, 40)


@pytest.mark.parametrize("N,B", RANDOM_SHAPES)
def test_backup_plain_matches_jax_kernel_on_random_trees(N, B):
    tree = random_tree(N, B, seed=N * 1000 + B + 1)
    args = [tree[k] for k in ("parent", "player", "leaf", "value",
                              "max_depth")]
    nqv = [tree[k] for k in ("n", "q", "v")]
    want = backup_batched_pallas_t(*map(jnp.asarray, args + nqv),
                                   JSpec(**SPEC_KW), interpret=True)
    got = [torch.from_numpy(x.copy()) for x in nqv]
    OB.backup_columns_(*map(torch.from_numpy, args), *got,
                       SearchSpec(**SPEC_KW))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    # Every root's n rises, and where there is room, paths below it.
    changed = int((got[0] != torch.from_numpy(nqv[0])).sum())
    assert changed > B or (N == 2 and changed == B)


@pytest.mark.parametrize("N,B", RANDOM_SHAPES)
def test_descend_rows_plain_matches_jax_batch_major_kernel(N, B):
    """The batch-major walk on random trees transposed to [B, N], against
    JAX's batch-major entry point (which transposes back to [N, B])."""
    tree = random_tree(N, B, seed=N * 1000 + B + 2)
    rows = [np.ascontiguousarray(tree[c].T) for c in COLUMNS]
    want = descend_batched_pallas(*map(jnp.asarray, rows), JSpec(**SPEC_KW),
                                  interpret=True)
    got = OD.descend_rows(*map(torch.from_numpy, rows), SearchSpec(**SPEC_KW))
    _assert_walks_equal(got, want)
    # The same walks as the game-minor entry point's on the same trees.
    cols = OD.descend_columns(*map(torch.from_numpy, (tree[c]
                                                       for c in COLUMNS)),
                              SearchSpec(**SPEC_KW))
    for g, c in zip(got, cols):
        assert torch.equal(g, c)


@pytest.mark.parametrize("N,B", RANDOM_SHAPES)
def test_backup_rows_plain_matches_jax_batch_major_kernel(N, B):
    tree = random_tree(N, B, seed=N * 1000 + B + 3)
    t = lambda x: np.ascontiguousarray(x.T)  # noqa: E731
    args = [t(tree["parent"]), t(tree["player"]), tree["leaf"],
            tree["value"], tree["max_depth"]]
    nqv = [t(tree[k]) for k in ("n", "q", "v")]
    want = backup_batched_pallas(*map(jnp.asarray, args + nqv),
                                 JSpec(**SPEC_KW), interpret=True)
    got = [torch.from_numpy(x.copy()) for x in nqv]
    OB.backup_rows_(*map(torch.from_numpy, args), *got,
                    SearchSpec(**SPEC_KW))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    changed = int((got[0] != torch.from_numpy(nqv[0])).sum())
    assert changed > B or (N == 2 and changed == B)


def test_rows_wrappers_reject_bad_inputs():
    """The batch-major wrappers check their inputs as the game-minor ones
    do, with the node axis second."""
    cols = [torch.from_numpy(x).t().contiguous() for x in edge_case_tree()]
    spec = SearchSpec()
    with pytest.raises(TypeError):
        OD.descend_rows(*cols[:3], cols[3].double(), *cols[4:], spec)
    with pytest.raises(ValueError):  # one node row: [B, 1]
        OD.descend_rows(*(c[:, :1] for c in cols), spec)
    with pytest.raises(ValueError):  # not contiguous
        OD.descend_rows(*(c.t() for c in cols), spec)
    n, q, v = cols[2].clone(), cols[3].clone(), cols[4].clone()
    leaf = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError):  # value of the wrong width
        OB.backup_rows_(cols[0], cols[0], leaf, torch.zeros(6, 2), leaf, n,
                        q, v, spec)
    with pytest.raises(ValueError):  # a leaf per row, not per game
        OB.backup_rows_(cols[0][:4], cols[0][:4], leaf, torch.zeros(4, 3),
                        leaf[:4], n[:4], q[:4], v[:4], spec)


@pytest.mark.parametrize("N,games", [
    (2, 8), (203, 8), (2048, 8), (7233, 8), (7234, 4), (14497, 4),
    (14498, 2), (29025, 2), (29026, 1), (OD.MAX_NODES, 1)])
def test_descend_games_per_block_fits_shared_memory(N, games):
    """The wrapper's choice of games a block: the most of 8, 4, 2, 1 whose
    staged parent rows fit in the 227 KB a block may use."""
    assert OD.games_per_block(N) == games
    assert OD.staged_bytes(N, games) <= OD.SMEM_PER_BLOCK
    if games < 8:
        assert OD.staged_bytes(N, 2 * games) > OD.SMEM_PER_BLOCK


def test_descend_rejects_trees_too_large_to_stage():
    with pytest.raises(ValueError, match="shared memory"):
        OD.games_per_block(OD.MAX_NODES + 1)
