"""The CUDA kernels on the card: each against its plain PyTorch version, in
both tree layouts and at the tafl, chess, nim3 and stratego search
shapes, the batch-major ones also at one game (the players' B = 1) and on
three-player reuse trees, whole searches (connect4, hnefatafl), a reuse
move, arenas (connect4, brandubh) and an MCTSPlayer move on the card
against the same on the CPU, searches and an evaluator tick that never
wait for the device, every env's rollouts on the card against the CPU's,
the wrappers' input checks, a GUI session's every batch-major launch
(its opponent's and its evaluator's) against the plain versions, a
Coach paused and stopped on the card, and the int8 tower's fused conv
kernels against their plain versions at every preset's shape.

Every test here is marked ``gpu`` and skips, by a decision taken inside
the test, where there is no CUDA device. This file imports neither JAX nor
the JAX package, because the machine with the card has neither; run it
there without tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda.py
"""

from collections import Counter

import numpy as np
import pytest
import torch

from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs.core import state_items
from alphazero_general_tpu_torch.mcts import search as S
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts.tree import NBP_NONE, SearchSpec
from alphazero_general_tpu_torch.mcts.tree_t import init_tree_t
from alphazero_general_tpu_torch.ops import backup as OB
from alphazero_general_tpu_torch.ops import descend as OD
from alphazero_general_tpu_torch.selfplay import selfplay as SP
from alphazero_general_tpu_torch.utils.random_tree import random_tree

COLUMNS = ("parent", "parent_action", "n", "q", "v", "edge_prior", "eany",
           "nba", "nbp")
SPEC_KW = dict(cpuct=1.25, fpu_reduction=0.2, min_discount=0.8,
               add_root_noise=False, add_root_temp=False, num_players=2,
               has_draw=True)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def edge_case_tree():
    """Six hand-built games on N = 6 rows (row 5 is the sink):

    0. an unvisited root (n == 0): the walk does not start;
    1. a terminal root: the walk does not start;
    2. two children with exactly equal scores and no unexpanded action left
       (NBP_NONE): the lower row wins, then that child expands;
    3. a child whose score exactly equals the unexpanded arm's: the
       unexpanded action wins the tie;
    4. the best child is terminal: the walk stops on it;
    5. the best child is pending (n == 0): the walk stops on it;
    plus junk in the sink row that must never count as a child.
    """
    N, G = 6, 6
    parent = np.full((N, G), -1, np.int32)
    pa = np.full((N, G), -1, np.int32)
    n = np.zeros((N, G), np.int32)
    q = np.zeros((N, G), np.float32)
    v = np.zeros((N, G), np.float32)
    ep = np.zeros((N, G), np.float32)
    eany = np.zeros((N, G), np.float32)
    nba = np.zeros((N, G), np.int32)
    nbp = np.full((N, G), 3.0e38, np.float32)
    n[0, 1:] = 4
    eany[0, 1] = 1.0
    # game 2: children rows 1 and 2 tie; the root has nothing unexpanded.
    parent[1:3, 2] = 0
    pa[1:3, 2] = [3, 5]
    n[1:3, 2] = 2
    q[1:3, 2] = 0.5
    ep[1:3, 2] = 0.25
    nbp[0, 2] = NBP_NONE
    nba[1, 2], nbp[1, 2] = 6, 0.375
    # game 3: child score 0.5 + 1.25*0.25*2/2 = 0.8125; unexpanded arm
    # (0.75 - 0.5*sqrt(0.25)) + 1.25*0.125*2 = 0.8125: an exact tie.
    parent[1, 3], pa[1, 3], n[1, 3] = 0, 2, 1
    q[1, 3], ep[1, 3], v[0, 3] = 0.5, 0.25, 0.75
    nba[0, 3], nbp[0, 3] = 4, 0.125
    # games 4 and 5: one strong child, terminal resp. pending.
    for g in (4, 5):
        parent[1:3, g] = 0
        pa[1:3, g] = [1, 0]
        n[1:3, g] = [3, 1]
        q[1:3, g] = [0.1, 0.9]
        ep[1:3, g] = 0.5
        nbp[0, g] = 0.01
    eany[2, 4] = 1.0
    n[2, 5] = 0
    # The sink row carries junk links to the root, which must be ignored.
    parent[N - 1], pa[N - 1], q[N - 1], n[N - 1] = 0, 6, 9.0, 1
    return [parent, pa, n, q, v, ep, eany, nba, nbp]


_RNG = np.random.default_rng(0)
_PI_TAB = _RNG.dirichlet(np.ones(7), 4093).astype(np.float32)
_V_TAB = _RNG.dirichlet(np.ones(3), 4093).astype(np.float32)
_HASH_W = _RNG.integers(1, 4093, size=(2, 42))


def _eval_fn(obs):
    """Table lookup on an integer hash of the stone planes: bit-identical
    policy and value rows on any device."""
    dev = obs.device
    stones = (obs[:, :2] > 0.5).reshape(obs.shape[0], 2, -1).long()
    h = (stones * torch.from_numpy(_HASH_W).to(dev)).sum(dim=(1, 2)) % 4093
    return (torch.from_numpy(_PI_TAB).to(dev)[h],
            torch.from_numpy(_V_TAB).to(dev)[h])


def _openings(batch, dev):
    """Games advanced by up to 6 random legal moves (none can be over)."""
    env = get_env("connect4")
    rng = np.random.default_rng(1)
    s = env.init(batch, "cpu")
    for _ in range(6):
        valid = env.valid_moves(s).numpy()
        a = np.array([rng.choice(np.flatnonzero(v)) for v in valid])
        nxt = env.step(s, torch.from_numpy(a))
        keep = torch.from_numpy(rng.random(batch) < 0.7)
        s = env.State(**{
            k: torch.where(keep.reshape((-1,) + (1,) * (x.dim() - 1)),
                           getattr(nxt, k), x)
            for k, x in state_items(s).items()})
    return env.State(**{k: x.to(dev) for k, x in state_items(s).items()})


def _grown_tree(dev, batch=256, sims=24):
    """A search without random draws (no root noise, no tie noise), so that
    it is the same search on every device."""
    env = get_env("connect4")
    tt = init_tree_t(env, _openings(batch, dev), sims + 16, 3)
    S.search(env, tt, SearchSpec(**dict(SPEC_KW, tie_noise=0.0)), _eval_fn,
             sims)
    return tt


@pytest.mark.gpu
def test_cuda_descend_matches_plain():
    dev = _cuda()
    tt = _grown_tree(dev)
    grown = [getattr(tt, c) for c in COLUMNS]
    edge = [torch.from_numpy(x).to(dev) for x in edge_case_tree()]
    for cols, kw in ((grown, SPEC_KW), (edge, dict(SPEC_KW,
                                                   fpu_reduction=0.5))):
        spec = SearchSpec(**kw)
        before = OD.descend_columns.launches
        got = OD.descend_columns(*cols, spec)
        torch.cuda.synchronize()
        assert OD.descend_columns.launches == before + 1
        want = OD.descend_plain(*cols, spec.cpuct, spec.fpu_reduction)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.gpu
def test_cuda_backup_matches_plain():
    dev = _cuda()
    tt = _grown_tree(dev)
    spec = SearchSpec(**SPEC_KW)
    gen = torch.Generator(dev).manual_seed(1)
    rows = torch.randint(0, 24, (tt.leaf.shape[0],), generator=gen,
                         device=dev)
    games = torch.arange(rows.shape[0], device=dev)
    rows = torch.where(tt.parent[rows, games] >= 0, rows, 0).to(torch.int32)
    for leaf in (tt.leaf, rows):
        value = torch.softmax(torch.randn(leaf.shape[0], 3, generator=gen,
                                          device=dev), -1)
        value[:3] = torch.tensor([[0.5, 0.5, 0.0], [0.25, 0.25, 0.5],
                                  [0.0, 0.0, 1.0]], device=dev)
        k_nqv = [tt.n.clone(), tt.q.clone(), tt.v.clone()]
        p_nqv = [tt.n.clone(), tt.q.clone(), tt.v.clone()]
        args = (tt.parent, tt.player, leaf, value, tt.max_depth + 2)
        OB.backup_columns_(*args, *k_nqv, spec)
        torch.cuda.synchronize()
        OB.backup_plain_(*args, *p_nqv, spec)
        assert torch.equal(k_nqv[0], p_nqv[0])
        for g, w in zip(k_nqv[1:], p_nqv[1:]):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


@pytest.mark.gpu
def test_cuda_search_matches_cpu_search():
    """The same search through the kernels and through the plain versions:
    visit counts and tree links equal, values within 1e-6."""
    dev = _cuda()
    got, want = _grown_tree(dev), _grown_tree("cpu")
    for name in ("n", "parent", "parent_action", "nba"):
        assert torch.equal(getattr(got, name)[:-1].cpu(),
                           getattr(want, name)[:-1]), name
    for name in ("q", "v", "nbp"):
        torch.testing.assert_close(getattr(got, name)[:-1].cpu(),
                                   getattr(want, name)[:-1], rtol=1e-6,
                                   atol=1e-6)
    assert torch.equal(T.counts(got).cpu(), T.counts(want))


@pytest.mark.gpu
def test_cuda_wrappers_reject_bad_inputs():
    dev = _cuda()
    cols = [torch.from_numpy(x).to(dev) for x in edge_case_tree()]
    spec = SearchSpec()
    with pytest.raises(ValueError):  # not contiguous
        OD.descend_columns(*(c.t().contiguous().t() for c in cols), spec)
    with pytest.raises(ValueError):  # mixed devices
        OD.descend_columns(cols[0].cpu(), *cols[1:], spec)


def _bits(x):
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16)
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.gpu
@pytest.mark.parametrize("N,B", [(2, 2048), (43, 1000), (43, 1004),
                                 (203, 7), (2048, 2048), (7300, 7)])
def test_cuda_kernels_match_plain_on_random_trees(N, B):
    """Both kernels bit for bit against their plain versions on random
    trees: ragged batches (the last descend block part empty, with 16-byte
    staging loads at B = 1004 and scalar ones at B = 7), a tree that needs
    more than 48 KB of shared memory (N = 2048) and one that forces 4 games
    a descend block (N = 7300)."""
    dev = _cuda()
    tree = {k: torch.from_numpy(x).to(dev)
            for k, x in random_tree(N, B, seed=N + B).items()}
    spec = SearchSpec(**SPEC_KW)
    cols = [tree[c] for c in COLUMNS]
    got = OD.descend_columns(*cols, spec)
    torch.cuda.synchronize()
    want = OD.descend_plain(*cols, spec.cpuct, spec.fpu_reduction)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    args = [tree[k] for k in ("parent", "player", "leaf", "value",
                              "max_depth")]
    k_nqv = [tree[k].clone() for k in "nqv"]
    p_nqv = [tree[k].clone() for k in "nqv"]
    OB.backup_columns_(*args, *k_nqv, spec)
    torch.cuda.synchronize()
    OB.backup_plain_(*args, *p_nqv, spec)
    for g, w in zip(k_nqv, p_nqv):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.gpu
def test_cuda_descend_raises_for_trees_too_large_to_stage():
    """A CUDA tree gets the kernel or an exception, never the plain
    version."""
    dev = _cuda()
    N = OD.MAX_NODES + 1
    cols = [torch.from_numpy(x).to(dev) for x in edge_case_tree()]
    big = [torch.zeros((N, 6), dtype=c.dtype, device=dev) for c in cols]
    before = OD.descend_columns.launches
    with pytest.raises(ValueError, match="shared memory"):
        OD.descend_columns(*big, SearchSpec())
    assert OD.descend_columns.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("B", [2048, 1000, 7])
@pytest.mark.parametrize("N", [2, 403, 2048, 7300])
def test_cuda_rows_kernels_match_plain_on_random_trees(N, B):
    """Both batch-major kernels bit for bit against their plain versions on
    random trees transposed to [B, N]: N = 403 (the production reuse tree,
    N % 4 != 0, so a game's row is not 16-byte aligned), N = 2048 (more
    than 48 KB of shared memory a block) and N = 7300 (4 games a block),
    with full, ragged and tiny batches."""
    dev = _cuda()
    columns = set(COLUMNS) | {"player"}
    tree = {k: torch.from_numpy(np.ascontiguousarray(x.T) if k in columns
                                else x).to(dev)
            for k, x in random_tree(N, B, seed=N + B + 1).items()}
    spec = SearchSpec(**SPEC_KW)
    cols = [tree[c] for c in COLUMNS]
    before = OD.descend_rows.launches
    got = OD.descend_rows(*cols, spec)
    torch.cuda.synchronize()
    assert OD.descend_rows.launches == before + 1
    want = OD.descend_plain(*(c.t() for c in cols), spec.cpuct,
                            spec.fpu_reduction)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    args = [tree[k] for k in ("parent", "player", "leaf", "value",
                              "max_depth")]
    k_nqv = [tree[k].clone() for k in "nqv"]
    p_nqv = [tree[k].clone() for k in "nqv"]
    before = OB.backup_rows_.launches
    OB.backup_rows_(*args, *k_nqv, spec)
    torch.cuda.synchronize()
    assert OB.backup_rows_.launches == before + 1
    OB.backup_plain_(args[0].t(), args[1].t(), *args[2:],
                     *(x.t() for x in p_nqv), spec)
    for g, w in zip(k_nqv, p_nqv):
        assert torch.equal(_bits(g), _bits(w))


def _reuse_moves(dev, batch=256, moves=3):
    """Reuse moves (fast, fast, full) without random draws in the search,
    with the same Gumbel noise on every device."""
    env = get_env("connect4")
    cfg = SP.SelfPlayConfig(sims_full=24, sims_fast=8, reuse_tree=True,
                            spec=SearchSpec(**dict(SPEC_KW, tie_noise=0.0)))
    states = _openings(batch, dev)
    carry = SP.SelfPlayState(
        env_state=states,
        temps=torch.ones(batch, device=dev),
        games_played=torch.zeros((), dtype=torch.int32, device=dev),
        move_count=torch.zeros((), dtype=torch.int32, device=dev),
        trees=T.init_tree(env, states, cfg.capacity, 3))
    rng = np.random.default_rng(5)
    records = []
    for k in range(moves):
        sims = cfg.sims_full if k == moves - 1 else cfg.sims_fast
        gumbel = torch.from_numpy(rng.gumbel(size=(batch, 7)).astype(
            np.float32)).to(dev)
        carry, rec = SP.move_step(env, cfg, _eval_fn, carry, sims,
                                  gumbel=gumbel)
        records.append(rec)
    return carry, records


@pytest.mark.gpu
def test_cuda_reuse_moves_match_cpu():
    """Reuse moves through the batch-major kernels on the card against the
    same moves through the plain versions on the CPU: actions equal, the
    carried trees' links and visits equal, values within 1e-6."""
    dev = _cuda()
    before = (OD.descend_rows.launches, OB.backup_rows_.launches,
              OD.descend_columns.launches, OB.backup_columns_.launches)
    got, got_recs = _reuse_moves(dev)
    torch.cuda.synchronize()
    sims = 8 + 8 + 24
    assert (OD.descend_rows.launches - before[0],
            OB.backup_rows_.launches - before[1],
            OD.descend_columns.launches - before[2],
            OB.backup_columns_.launches - before[3]) == (sims, sims, 0, 0)
    want, want_recs = _reuse_moves("cpu")
    for g, w in zip(got_recs, want_recs):
        assert torch.equal(g.action.cpu(), w.action)
        torch.testing.assert_close(g.pi.cpu(), w.pi, rtol=1e-6, atol=1e-6)
    gt, wt = got.trees, want.trees
    assert (gt.next_free > 1).any()
    for name in ("n", "parent", "parent_action", "nba", "next_free"):
        a, b = getattr(gt, name).cpu(), getattr(wt, name)
        if a.dim() == 2:
            a, b = a[:, :-1], b[:, :-1]
        assert torch.equal(a, b), name
    for name in ("q", "v", "nbp"):
        torch.testing.assert_close(getattr(gt, name)[:, :-1].cpu(),
                                   getattr(wt, name)[:, :-1], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.gpu
def test_cuda_rows_wrappers_reject_bad_inputs():
    """A CUDA tensor gets the kernel or an exception, never the plain
    version."""
    dev = _cuda()
    cols = [torch.from_numpy(x).t().contiguous().to(dev)
            for x in edge_case_tree()]
    spec = SearchSpec()
    before = (OD.descend_rows.launches, OB.backup_rows_.launches)
    with pytest.raises(ValueError):  # not contiguous
        OD.descend_rows(*(c.t().contiguous().t() for c in cols), spec)
    with pytest.raises(ValueError):  # mixed devices
        OD.descend_rows(cols[0].cpu(), *cols[1:], spec)
    big = [torch.zeros((6, OD.MAX_NODES + 1), dtype=c.dtype, device=dev)
           for c in cols]
    with pytest.raises(ValueError, match="shared memory"):
        OD.descend_rows(*big, spec)
    leaf = torch.zeros(6, dtype=torch.int32, device=dev)
    n, q, v = cols[2].clone(), cols[3].clone(), cols[4].clone()
    with pytest.raises(ValueError):  # mixed devices
        OB.backup_rows_(cols[0], cols[0], leaf.cpu(), torch.zeros(
            6, 3, device=dev), leaf, n, q, v, spec)
    with pytest.raises(ValueError):  # not contiguous
        OB.backup_rows_(cols[0], cols[0], leaf, torch.zeros(
            6, 3, device=dev), leaf, n.t().contiguous().t(), q, v, spec)
    assert (OD.descend_rows.launches, OB.backup_rows_.launches) == before


def _arena_draws(seed):
    """Per-round arena draws from numpy (Gumbel and tie noise), the same
    numbers on every device."""
    from alphazero_general_tpu_torch.mcts.search import SearchDraws

    def round_draws(t, sims, valids):
        rng = np.random.default_rng(seed * 1000 + t)
        B, A = valids.shape
        dev = valids.device
        gumbel = torch.from_numpy(rng.gumbel(size=(B, A)).astype(np.float32))
        tie = torch.from_numpy(rng.random((sims, B, A)).astype(np.float32))
        return SP.MoveDraws(gumbel=gumbel.to(dev),
                            search=SearchDraws(tie=tie.to(dev)))

    return round_draws


@pytest.mark.gpu
def test_cuda_arena_matches_cpu():
    """A short arena (64 games, 24 simulations, the table evaluation
    against the RawMCTS baseline) through the kernels on the card, equal to
    the same arena through the plain versions on the CPU, with the same
    draws; every simulation launched both game-minor kernels."""
    from alphazero_general_tpu_torch.selfplay import arena as A

    dev = _cuda()
    env = get_env("connect4")

    def table_apply(obs):
        pi, v = _eval_fn(obs)
        return torch.log(pi), torch.log(v)

    cfg = A.ArenaConfig(sims=24, arena_temp=1.0)
    fns = [table_apply, A.raw_mcts_apply(7, 3)]
    before = (OD.descend_columns.launches, OB.backup_columns_.launches)
    got = A.play_games_multi(env, cfg, fns, 64, draws=_arena_draws(3),
                             device=dev)
    launched = (OD.descend_columns.launches - before[0],
                OB.backup_columns_.launches - before[1])
    want = A.play_games_multi(env, cfg, fns, 64, draws=_arena_draws(3),
                              device="cpu")
    assert torch.equal(got.model_wins, want.model_wins)
    assert got.draws == want.draws and got.rounds == want.rounds
    assert got.avg_game_length == want.avg_game_length
    assert launched == (got.rounds * (cfg.sims - 1), got.rounds * cfg.sims)


@pytest.mark.gpu
def test_cuda_train_step_matches_cpu():
    """One float32 SGD step (device symmetries on) on the card and on the
    CPU from the same weights and batch: params and batch statistics
    within rtol 1e-4, atol 1e-5 (TF32 off; sums in another order)."""
    from alphazero_general_tpu_torch.models import NNetWrapper
    from alphazero_general_tpu_torch.utils import get_args

    dev = _cuda()
    env = get_env("connect4")
    args = get_args(num_channels=32, depth=2, value_head_channels=8,
                    policy_head_channels=8, value_dense_layers=[64],
                    policy_dense_layers=[64], compute_dtype="float32")
    nets = [NNetWrapper(env, args, device=d) for d in (dev, "cpu")]
    rng = np.random.default_rng(4)
    obs = env.observation(_openings(128, "cpu")).numpy().astype(np.float16)
    pi = rng.dirichlet(np.ones(7), 128).astype(np.float16)
    value = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 128)]
    sym = rng.integers(0, 2, 128, dtype=np.int32)
    losses = []
    for net in nets:
        net.set_device_symmetries(env)
        losses.append(net.train([(obs, pi, value, sym)], 1))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    want = nets[1].model.state_dict()
    for k, x in nets[0].model.state_dict().items():
        np.testing.assert_allclose(x.cpu().numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def _table_eval(env, rows=509, seed=0):
    """Table lookup on an integer hash of the piece planes (every plane but
    the last two: colour and turn in connect4 and tafl): bit-identical
    policy and value rows on any device."""
    rng = np.random.default_rng(seed)
    planes = max(env.OBS_SHAPE[0] - 2, 1)  # othello, tictactoe: 1 plane
    pi_tab = torch.from_numpy(
        rng.dirichlet(np.ones(env.ACTION_SIZE), rows).astype(np.float32))
    value_size = env.NUM_PLAYERS + int(env.HAS_DRAW)
    v_tab = torch.from_numpy(rng.dirichlet(np.ones(value_size), rows).astype(
        np.float32))
    w = torch.from_numpy(rng.integers(1, rows, size=(
        planes * env.OBS_SHAPE[1] * env.OBS_SHAPE[2],)))
    on = {}  # device -> the tables there, copied once

    def eval_fn(obs):
        dev = obs.device
        if dev not in on:
            on[dev] = [x.to(dev) for x in (pi_tab, v_tab, w)]
        pi_d, v_d, w_d = on[dev]
        pieces = (obs[:, :planes] > 0.5).reshape(obs.shape[0], -1).long()
        h = (pieces * w_d).sum(dim=1) % rows
        return pi_d[h], v_d[h]

    return eval_fn


def _tafl_openings(env, batch, dev, plies=8, seed=2):
    """Games advanced by 0..plies random legal moves, made on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    s = env.init(batch, "cpu")
    stop = torch.randint(0, plies + 1, (batch,), generator=gen)
    for ply in range(plies):
        a = torch.multinomial(env.valid_moves(s).float(), 1, generator=gen)
        nxt = env.step(s, a[:, 0])
        keep = (stop > ply) & ~env.terminated(nxt)
        s = env.State(**{
            k: torch.where(keep.reshape((-1,) + (1,) * (x.dim() - 1)),
                           getattr(nxt, k), x)
            for k, x in state_items(s).items()})
    return env.State(**{k: x.to(dev) for k, x in state_items(s).items()})


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,sims", [
    ("hnefatafl", 512, 250), ("hnefatafl", 512, 50), ("brandubh", 1024, 150),
    ("brandubh", 1024, 30), ("brandubh", 128, 150)])
def test_cuda_kernels_match_plain_on_tafl_searches(name, B, sims):
    """Both game-minor kernels bit for bit against their plain versions at
    the tafl presets' shapes (hnefatafl: N = 253 and 53 at B = 512;
    brandubh: N = 153 and 33 at B = 1024, and the arena's 128 games), at a
    quarter, half and all but one of the simulations of a search."""
    dev = _cuda()
    env = get_env(name)
    spec = SearchSpec(**SPEC_KW)
    eval_fn = _table_eval(env)
    tt = init_tree_t(env, _tafl_openings(env, B, dev), sims + 2, 3)
    gen = torch.Generator(dev).manual_seed(0)
    S._simulate_step_t(env, tt, spec, eval_fn, True, 0, True, generator=gen)
    checked = 0
    for slot in range(1, sims):
        if slot not in (sims // 4, sims // 2, sims - 1):
            S._simulate_step_t(env, tt, spec, eval_fn, False, slot,
                               generator=gen)
            continue
        cols = [getattr(tt, c) for c in COLUMNS]
        got = OD.descend_columns(*cols, spec)
        torch.cuda.synchronize()
        want = OD.descend_plain(*cols, spec.cpuct, spec.fpu_reduction)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))
        values = S._leaf_step_t(env, tt, spec, eval_fn, False, slot, False,
                                gen)
        args = (tt.parent, tt.player, tt.leaf, values, tt.max_depth)
        k_nqv = [tt.n.clone(), tt.q.clone(), tt.v.clone()]
        OB.backup_columns_(*args, *k_nqv, spec)
        torch.cuda.synchronize()
        OB.backup_plain_(*args, tt.n, tt.q, tt.v, spec)
        for g, w in zip(k_nqv, (tt.n, tt.q, tt.v)):
            assert torch.equal(_bits(g), _bits(w))
        checked += 1
    assert checked == 3 and (tt.n[0] == sims).all()


@pytest.mark.gpu
def test_cuda_hnefatafl_search_matches_cpu():
    """A hnefatafl search (64 games, 32 simulations, no random draws)
    through the kernels and the env on the card, equal to the same search
    through the plain versions on the CPU: visit counts and tree links
    equal, values within 1e-6."""
    dev = _cuda()
    env = get_env("hnefatafl")
    spec = SearchSpec(**dict(SPEC_KW, tie_noise=0.0))
    trees = []
    for d in (dev, "cpu"):
        tt = init_tree_t(env, _tafl_openings(env, 64, d), 34, 3)
        trees.append(S.search(env, tt, spec, _table_eval(env), 32))
    got, want = trees
    for name in ("n", "parent", "parent_action", "nba"):
        assert torch.equal(getattr(got, name)[:-1].cpu(),
                           getattr(want, name)[:-1]), name
    for name in ("q", "v", "nbp"):
        torch.testing.assert_close(getattr(got, name)[:-1].cpu(),
                                   getattr(want, name)[:-1], rtol=1e-6,
                                   atol=1e-6)
    assert torch.equal(T.counts(got).cpu(), T.counts(want))


@pytest.mark.gpu
def test_cuda_brandubh_arena_matches_cpu():
    """A brandubh arena (32 games, 16 simulations, the table evaluation
    against the RawMCTS baseline, draws at the 100-move cap) through the
    kernels and the env on the card, equal to the same arena on the CPU
    with the same draws; every simulation launched both kernels."""
    from alphazero_general_tpu_torch.selfplay import arena as A

    dev = _cuda()
    env = get_env("brandubh")
    table = _table_eval(env)

    def table_apply(obs):
        pi, v = table(obs)
        return torch.log(pi), torch.log(v)

    cfg = A.ArenaConfig(sims=16, arena_temp=1.0)
    fns = [table_apply, A.raw_mcts_apply(env.ACTION_SIZE, 3)]
    before = (OD.descend_columns.launches, OB.backup_columns_.launches)
    got = A.play_games_multi(env, cfg, fns, 32, draws=_arena_draws(5),
                             device=dev)
    launched = (OD.descend_columns.launches - before[0],
                OB.backup_columns_.launches - before[1])
    want = A.play_games_multi(env, cfg, fns, 32, draws=_arena_draws(5),
                              device="cpu")
    assert torch.equal(got.model_wins, want.model_wins)
    assert got.draws == want.draws and got.rounds == want.rounds
    assert got.avg_game_length == want.avg_game_length
    assert launched == (got.rounds * (cfg.sims - 1), got.rounds * cfg.sims)


def _search_without_sync(name):
    """A search of ``name`` on the card (env steps, kernels, prior
    installs, tie noise from a generator) under CUDA's sync debug mode,
    which turns any call that waits for the device into an error."""
    dev = _cuda()
    env = _env(name)
    roots = _tafl_openings(env, 64, dev)
    eval_fn = _table_eval(env)
    spec = _spec_of(env)
    gen = torch.Generator(dev).manual_seed(0)
    S.search(env, init_tree_t(env, roots, 10, spec.value_size), spec,
             eval_fn, 8, generator=gen)  # warm-up: tables, allocator
    tt = init_tree_t(env, roots, 34, spec.value_size)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        S.search(env, tt, spec, eval_fn, 32, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (tt.n[0] == 32).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["hnefatafl", "brandubh"])
def test_cuda_tafl_search_never_waits_for_the_device(name):
    """A tafl search on the card makes no call that waits for the
    device."""
    _search_without_sync(name)


@pytest.mark.gpu
def test_cuda_chess_search_never_waits_for_the_device():
    """A chess search on the card (the move generator, the Zobrist hashes,
    the repetition ring, prior rows of 4672 actions) makes no call that
    waits for the device."""
    _search_without_sync("chess")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stratego", "othello", "gobang",
                                  "tictactoe", "nim3", "othello_x4"])
def test_cuda_env_search_never_waits_for_the_device(name):
    """A search of every other new env on the card (``othello_x4``:
    othello with 4 stacked observations) makes no call that waits for the
    device."""
    _search_without_sync(name)


def _env(name):
    """A registered env, or ``<env>_x<k>``: it with ``k`` stacked
    observations."""
    from alphazero_general_tpu_torch.envs.stacked import make_stacked_env

    base, _, k = name.partition("_x")
    return make_stacked_env(get_env(base), int(k)) if k else get_env(base)


def _spec_of(env):
    return SearchSpec(**dict(SPEC_KW, num_players=env.NUM_PLAYERS,
                             has_draw=env.HAS_DRAW))


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,sims", [
    ("chess", 256, 200), ("chess", 256, 40), ("nim3", 256, 100),
    ("stratego", 512, 100), ("stratego", 512, 20)])
def test_cuda_kernels_match_plain_on_env_searches(name, B, sims):
    """Both game-minor kernels bit for bit against their plain versions at
    the chess preset's shapes (A = 4672, B = 256, N = 203 and 43), at
    nim3's (three players, value_size 4, N = 103) and at stratego's
    (A = 1280, B = 512, N = 103 and 23), at a quarter, half and all but
    one of the simulations of a search."""
    dev = _cuda()
    env = get_env(name)
    spec = _spec_of(env)
    eval_fn = _table_eval(env)
    tt = init_tree_t(env, _tafl_openings(env, B, dev, plies=2 if name ==
                                         "nim3" else 8),
                     sims + 2, spec.value_size)
    gen = torch.Generator(dev).manual_seed(0)
    S._simulate_step_t(env, tt, spec, eval_fn, True, 0, True, generator=gen)
    checked = 0
    for slot in range(1, sims):
        if slot not in (sims // 4, sims // 2, sims - 1):
            S._simulate_step_t(env, tt, spec, eval_fn, False, slot,
                               generator=gen)
            continue
        cols = [getattr(tt, c) for c in COLUMNS]
        got = OD.descend_columns(*cols, spec)
        torch.cuda.synchronize()
        want = OD.descend_plain(*cols, spec.cpuct, spec.fpu_reduction)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))
        values = S._leaf_step_t(env, tt, spec, eval_fn, False, slot, False,
                                gen)
        args = (tt.parent, tt.player, tt.leaf, values, tt.max_depth)
        k_nqv = [tt.n.clone(), tt.q.clone(), tt.v.clone()]
        OB.backup_columns_(*args, *k_nqv, spec)
        torch.cuda.synchronize()
        OB.backup_plain_(*args, tt.n, tt.q, tt.v, spec)
        for g, w in zip(k_nqv, (tt.n, tt.q, tt.v)):
            assert torch.equal(_bits(g), _bits(w))
        checked += 1
    assert checked == 3 and (tt.n[0] == sims).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tictactoe", "nim3", "othello", "gobang",
                                  "stratego", "chess", "othello_x4"])
def test_cuda_env_rollouts_match_cpu(name):
    """32 random playouts of 40 plies (or to their end) on the card and on
    the CPU with the same actions: every state field, valid mask, win
    vector and observation equal at every ply (``othello_x4``: othello
    with 4 stacked observations)."""
    dev = _cuda()
    env = _env(name)
    rng = np.random.default_rng(6)
    states = {"cpu": env.init(32, "cpu"), "cuda": env.init(32, dev)}
    for ply in range(40):
        out = {}
        for d, st in states.items():
            win, valid = env.win_and_valids(st)
            out[d] = (state_items(st), valid, win, env.observation(st))
        for a, b in zip(out["cuda"][1:], out["cpu"][1:]):
            assert torch.equal(_bits(a.cpu()), _bits(b)), ply
        for f, x in out["cpu"][0].items():
            assert torch.equal(out["cuda"][0][f].cpu(), x), (ply, f)
        win, valid = out["cpu"][2], out["cpu"][1]
        done = (win > 0).any(dim=1)
        if bool(done.all()):
            break
        action = torch.tensor([int(rng.choice(np.flatnonzero(v)))
                               if not d_ else 0 for v, d_ in
                               zip(valid.numpy(), done.numpy())],
                              dtype=torch.int32)
        for d, st in states.items():
            nxt = env.step(st, action.to(st.player.device))
            keep = done.to(st.player.device)
            states[d] = env.State(**{
                f: torch.where(keep.reshape((-1,) + (1,) * (x.dim() - 1)),
                               getattr(st, f), x)
                for f, x in state_items(nxt).items()})


@pytest.mark.gpu
@pytest.mark.parametrize("batch,hw,cin,cout", [
    (2048, (6, 7), 128, 128),    # connect4 production width
    (512, (11, 11), 128, 128),   # hnefatafl production width
    (3, (6, 7), 12, 20),         # channels padded to multiples of 8
    (1, (3, 3), 8, 8),           # 9 rows, padded past cuBLASLt's 16
    (1, (6, 7), 128, 128),       # connect4, one game
    (1024, (7, 7), 128, 128),    # brandubh
    (512, (8, 8), 64, 64),       # othello
    (256, (15, 15), 64, 64),     # gobang
    (1, (3, 3), 32, 32),         # tictactoe, one game: 9 rows
    (3, (6, 7), 40, 40),         # input channels not a multiple of 32
], ids=["connect4", "hnefatafl", "padded_channels", "padded_rows",
        "connect4_one_game", "brandubh", "othello", "gobang", "tictactoe",
        "cin_not_x32"])
def test_cuda_conv3x3_int8_matches_cpu(batch, hw, cin, cout):
    """The int8 tower conv (torch._int_mm on the card) gives the CPU's
    int32 accumulators exactly for the same int8 input, extremes of both
    ranges included. Where a tower has the shape (Cin = Cout, a multiple of
    8), both fused kernels (``conv_quantize``, ``conv_residual`` with and
    without the next quantizer) equal their plain versions run on the card,
    bit for bit, with scales that spread the codes over [0, 127]."""
    from alphazero_general_tpu_torch.models import quant as Q

    dev = _cuda()
    gen = torch.Generator().manual_seed(batch)
    q = torch.randint(0, 128, (batch, *hw, cin), generator=gen,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen,
                      dtype=torch.int8)
    q[0, 0, 0] = 127
    w[..., 0] = 127
    want = Q.conv3x3_int8(q, Q.int8_weight_matrix(w), cout)
    wt = Q.int8_weight_matrix(w.to(dev))
    got = Q.conv3x3_int8(q.to(dev), wt, cout)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (batch, *hw, cout)
    assert torch.equal(got.cpu(), want)
    if cin != cout or cin % Q.ALIGN:
        return
    spread = float(want.to(torch.float32).std()) + 1.0
    s, b, d, s1, b1 = (torch.rand(cout, generator=gen) * k + m for k, m in (
        (80 / spread, 0.0), (60, -18), (2 / spread, 0.0), (30, 0.0),
        (20, -6)))
    x = torch.randn((batch, *hw, cout), generator=gen).to(torch.bfloat16)
    q, s, b, d, s1, b1, x = (t.to(dev) for t in (q, s, b, d, s1, b1, x))
    launches = (Q.conv_quantize.launches, Q.conv_residual.launches)
    pairs = [(Q.conv_quantize(q, wt, s, b),
              Q.conv_quantize_plain(q, wt, s, b))]
    for nxt in ((s1, b1), (None, None)):
        pairs += zip(Q.conv_residual(q, wt, x, d, *nxt),
                     Q.conv_residual_plain(q, wt, x, d, *nxt))
    torch.cuda.synchronize()
    assert (Q.conv_quantize.launches, Q.conv_residual.launches) == (
        launches[0] + 1, launches[1] + 2)
    assert pairs[-1] == (None, None)
    for k, (a, p) in enumerate(pairs[:-1]):
        assert a.dtype == p.dtype and a.shape == p.shape, k
        assert torch.equal(_bits(a), _bits(p)), k
    assert pairs[0][1].unique().numel() > 8  # codes spread, not clipped


@pytest.mark.gpu
def test_cuda_int8_tower_matches_cpu():
    """A small int8 tower quantized on the card and on the CPU from the
    same weights and calibration batch: log-probabilities within 0.05 (an
    int8 code at a rounding boundary may move where float32 sums differ in
    order), and the card's tower conv products equal to the CPU's."""
    from alphazero_general_tpu_torch.models import NNetWrapper
    from alphazero_general_tpu_torch.models import quant as Q
    from alphazero_general_tpu_torch.utils import get_args

    dev = _cuda()
    env = get_env("connect4")
    args = get_args(num_channels=32, depth=2, value_head_channels=8,
                    policy_head_channels=8, value_dense_layers=[32],
                    policy_dense_layers=[32])
    nets = {d: NNetWrapper(env, args, device=d) for d in ("cpu", dev)}
    nets[dev].model.load_state_dict(nets["cpu"].model.state_dict())
    calib = Q.calibration_observations(
        env, batch=64, moves=12, device="cpu",
        generator=torch.Generator().manual_seed(0))
    qs = {d: n.quantized_inference(calib_obs=calib.to(d))
          for d, n in nets.items()}
    obs = Q.calibration_observations(
        env, batch=32, moves=4, device="cpu",
        generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        for a, b in zip(qs[dev](obs.to(dev)), qs["cpu"](obs)):
            assert torch.allclose(a.cpu(), b, rtol=0, atol=0.05)
        for a, w in qs[dev].conv_operands(obs.to(dev)):
            assert torch.equal(Q.conv3x3_int8(a, w, 32).cpu(),
                               Q.conv3x3_int8(a.cpu(), w.cpu(), 32))


@pytest.mark.gpu
def test_cuda_int8_forward_runs_the_fused_kernels(monkeypatch):
    """The int8 forward on the card goes through the fused kernels, two
    launches a block (the wrappers' counters and the ``network.conv_int8``
    trace counter), and equals the same forward through the plain
    versions on the card, bit for bit."""
    from alphazero_general_tpu_torch.models import NNetWrapper
    from alphazero_general_tpu_torch.models import quant as Q
    from alphazero_general_tpu_torch.utils import get_args, trace

    dev = _cuda()
    env = get_env("connect4")
    net = NNetWrapper(env, get_args(
        num_channels=64, depth=3, value_head_channels=8,
        policy_head_channels=8, value_dense_layers=[32],
        policy_dense_layers=[32]), device=dev)
    q = net.quantized_inference(calib_obs=Q.calibration_observations(
        env, batch=64, moves=12, device=dev,
        generator=torch.Generator(dev).manual_seed(0)))
    obs = Q.calibration_observations(
        env, batch=256, moves=2, device=dev,
        generator=torch.Generator(dev).manual_seed(1))
    before = Q.conv_quantize.launches + Q.conv_residual.launches
    trace.reset()
    with torch.inference_mode(), trace.tracing():
        fused = q(obs)
        torch.cuda.synchronize()
    assert (Q.conv_quantize.launches + Q.conv_residual.launches
            == before + 2 * q.depth)
    assert trace.snapshot()["counters"]["network.conv_int8"] == 2 * q.depth
    trace.reset()
    monkeypatch.setattr(Q, "conv_quantize", Q.conv_quantize_plain)
    monkeypatch.setattr(Q, "conv_residual", Q.conv_residual_plain)
    with torch.inference_mode():
        plain = q(obs)
    for a, p in zip(fused, plain):
        assert torch.equal(_bits(a), _bits(p))


def _hold_rows(tree, spec):
    """Both batch-major kernels bit for bit against their plain versions
    on the columns of the batch-major ``tree`` (dict or Tree) and the
    values in ``tree["value"]``."""
    cols = [tree[c] for c in COLUMNS]
    got = OD.descend_rows(*cols, spec)
    torch.cuda.synchronize()
    want = OD.descend_plain(*(c.t() for c in cols), spec.cpuct,
                            spec.fpu_reduction)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    args = [tree[k] for k in ("parent", "player", "leaf", "value",
                              "max_depth")]
    k_nqv = [tree[k].clone() for k in "nqv"]
    p_nqv = [tree[k].clone() for k in "nqv"]
    OB.backup_rows_(*args, *k_nqv, spec)
    torch.cuda.synchronize()
    OB.backup_plain_(args[0].t(), args[1].t(), *args[2:],
                     *(x.t() for x in p_nqv), spec)
    for g, w in zip(k_nqv, p_nqv):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.gpu
@pytest.mark.parametrize("players", [2, 3])
@pytest.mark.parametrize("N", [2, 202, 203, 402, 2002, 2003])
def test_cuda_rows_kernels_match_plain_at_one_game(N, players):
    """Both batch-major kernels bit for bit at B = 1, the players' and the
    evaluator's batch (seven lanes of a descend block empty), on random
    trees about their sizes (sims + 3 rows at 200, 400 and 2000
    simulations), with two and three players."""
    dev = _cuda()
    columns = set(COLUMNS) | {"player"}
    made = random_tree(N, 1, seed=N + 7 * players, num_players=players,
                       has_draw=True)
    tree = {k: torch.from_numpy(np.ascontiguousarray(x.T) if k in columns
                                else x).to(dev) for k, x in made.items()}
    _hold_rows(tree, SearchSpec(**dict(SPEC_KW, num_players=players)))


def _rows_dict(tree, values):
    eany = (tree.e > 0).any(dim=-1).to(torch.float32)
    return dict(parent=tree.parent, parent_action=tree.parent_action,
                n=tree.n, q=tree.q, v=tree.v, edge_prior=tree.edge_prior,
                eany=eany, nba=tree.nba, nbp=tree.nbp, player=tree.player,
                leaf=tree.leaf, value=values, max_depth=tree.max_depth)


@pytest.mark.gpu
def test_cuda_rows_kernels_match_plain_on_nim3_reuse_trees():
    """Both batch-major kernels bit for bit at three players (value_size
    4), at snapshots of a search on the carried trees of nim3 reuse moves
    (a table evaluation, root noise and tie noise from a generator)."""
    dev = _cuda()
    env = get_env("nim3")
    spec = SearchSpec(**dict(SPEC_KW, num_players=3))
    eval_fn = _table_eval(env)
    cfg = SP.SelfPlayConfig(sims_full=40, sims_fast=10, reuse_tree=True,
                            spec=spec)
    states = _tafl_openings(env, 256, dev, plies=2)
    carry = SP.SelfPlayState(
        env_state=states, temps=torch.ones(256, device=dev),
        games_played=torch.zeros((), dtype=torch.int32, device=dev),
        move_count=torch.zeros((), dtype=torch.int32, device=dev),
        trees=T.init_tree(env, states, cfg.capacity, 4))
    gen = torch.Generator(dev).manual_seed(3)
    for sims in (10, 40):
        carry, _ = SP.move_step(env, cfg, eval_fn, carry, sims,
                                generator=gen)
    tree = carry.trees
    assert (tree.next_free > 1).any()
    checked = 0
    for k in range(cfg.sims_full):
        if k in (0, 20, cfg.sims_full - 1):
            walk = OD.descend_batched(tree, spec)
            T.apply_walk(env, tree, *walk)
            pi, value = eval_fn(T.leaf_observation(env, tree))
            values = T.resolve_value(tree, value)
            T.install_prior(tree, pi, spec, k == 0, generator=gen)
            _hold_rows(_rows_dict(tree, values), spec)
            OB.backup_batched(tree, values, spec)
            checked += 1
        else:
            S.simulate_step(env, tree, spec, eval_fn, k == 0, generator=gen)
    assert checked == 3


class _TableNet:
    """A stand-in network for the players: ``process`` is a table lookup,
    so that the card and the CPU get bit-identical priors and values."""

    def __init__(self, env, args, device, process=_eval_fn):
        self.env, self.args = env, args
        self.device = torch.device(device)
        self.process = process


@pytest.mark.gpu
def test_cuda_mcts_player_move_matches_cpu():
    """An MCTSPlayer move on the card against the same move on the CPU
    (the same root noise and tie noise injected): action, visit counts and
    depth equal, the root value and the root children's q within 1e-6;
    every simulation through both batch-major kernels."""
    from alphazero_general_tpu_torch.players.players import MCTSPlayer
    from alphazero_general_tpu_torch.utils import get_args

    dev = _cuda()
    env = get_env("connect4")
    args = get_args(numMCTSSims=64, startTemp=1.0)
    state = _openings(1, "cpu")
    rng = np.random.default_rng(4)
    draws = S.SearchDraws(
        tie=torch.from_numpy(rng.random((64, 1, 7)).astype(np.float32)),
        gammas=torch.from_numpy(rng.gamma(1.5, size=(1, 7)).astype(
            np.float32)))
    want = MCTSPlayer(_TableNet(env, args, "cpu"), env, args, seed=2)
    a_cpu = want.play(state, draws=draws)
    got = MCTSPlayer(_TableNet(env, args, dev), env, args, seed=2)
    before = (OD.descend_rows.launches, OB.backup_rows_.launches)
    on_dev = S.SearchDraws(tie=draws.tie.to(dev), gammas=draws.gammas.to(dev))
    assert got.play(state, draws=on_dev) == a_cpu
    assert (OD.descend_rows.launches - before[0],
            OB.backup_rows_.launches - before[1]) == (64, 64)
    assert got.last_depth == want.last_depth
    assert abs(got.last_value - want.last_value) <= 1e-6
    c_got, q_got = T.root_child_stats(got.last_tree)
    c_want, q_want = T.root_child_stats(want.last_tree)
    assert torch.equal(c_got.cpu(), c_want)
    assert torch.allclose(q_got.cpu(), q_want, rtol=0, atol=1e-6)
    assert torch.equal(got.last_tree.n.cpu(), want.last_tree.n)


@pytest.mark.gpu
def test_cuda_evaluator_tick_never_waits_for_the_device():
    """An evaluator tick (8 simulations of a network's evaluation on a
    tree of max_sims + 2 rows) under CUDA's sync debug mode: nothing in it
    waits for the device; the host reads the tree in ``_publish`` only."""
    from alphazero_general_tpu_torch.players.evaluator import MCTSEvaluator
    from alphazero_general_tpu_torch.utils import get_args

    dev = _cuda()
    env = get_env("connect4")
    args = get_args()
    # The table stays on the card: _eval_fn copies it there each call.
    ev = MCTSEvaluator(env, args, nn=_TableNet(env, args, dev,
                                               _table_eval(env)),
                       max_sims=2000, device=dev)
    state = env.init(1, dev)
    ev.analyze_blocking(state, sims=16)  # warm-up: tables, allocator
    tree = S.init_batched_trees(env, state, ev.max_sims + 2, 3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ev._tick(tree, 0, ev.sims_per_tick, S.SearchDraws())
        ev._tick(tree, ev.sims_per_tick, ev.sims_per_tick, S.SearchDraws())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ev._publish(tree, 16, 0.0, running=False) >= 1
    assert ev.analysis.sims == 16 and sum(ev.analysis.policy) == 1.0


# --------------------------------------------------------------------------
# The search layer: multi-leaf rounds and growing-arena segments
# --------------------------------------------------------------------------

def _fixed_draws(batch, sims, seed=5):
    """Tie and root-noise draws made on the CPU, the same on any device."""
    rng = np.random.default_rng(seed)
    return S.SearchDraws(
        tie=torch.from_numpy(rng.random((sims, batch, 7)).astype(np.float32)),
        gammas=torch.from_numpy(rng.gamma(1.5, size=(batch, 7)).astype(
            np.float32)))


def _on(draws, dev):
    return S.SearchDraws(tie=draws.tie.to(dev), gammas=draws.gammas.to(dev))


def _hold_columns(tt, values, spec, walk: bool):
    """The game-minor descend (``walk``) or backup kernel bit for bit
    against its plain version on the TreeT ``tt``, the backup from the
    leaf values ``values``."""
    cols = [getattr(tt, c) for c in COLUMNS]
    if walk:
        got = OD.descend_columns(*cols, spec)
        torch.cuda.synchronize()
        want = OD.descend_plain(*cols, spec.cpuct, spec.fpu_reduction)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))
        return
    args = (tt.parent, tt.player, tt.leaf, values, tt.max_depth)
    k_nqv = [tt.n.clone(), tt.q.clone(), tt.v.clone()]
    p_nqv = [x.clone() for x in k_nqv]
    OB.backup_columns_(*args, *k_nqv, spec)
    torch.cuda.synchronize()
    OB.backup_plain_(*args, *p_nqv, spec)
    for g, w in zip(k_nqv, p_nqv):
        assert torch.equal(_bits(g), _bits(w))


def _held_search(monkeypatch, dev, batch, sims, leaf_batch):
    """A connect4 fresh search on the card with both game-minor kernels
    held against their plain versions before every walk and backup;
    returns (the TreeT, the tree sizes held, the pending children seen
    before each walk)."""
    spec = SearchSpec(**SPEC_KW)
    walk, backup = S.descend_batched_t, S.backup_batched_t
    sizes, pending = set(), []

    def held_walk(tt, sp):
        sizes.add(tt.parent.shape[0])
        pending.append(int(((tt.parent[:-1] >= 0) & (tt.n[:-1] == 0)).sum()))
        _hold_columns(tt, None, sp, walk=True)
        return walk(tt, sp)

    def held_backup(tt, values, sp):
        _hold_columns(tt, values, sp, walk=False)
        return backup(tt, values, sp)

    monkeypatch.setattr(S, "descend_batched_t", held_walk)
    monkeypatch.setattr(S, "backup_batched_t", held_backup)
    env = get_env("connect4")
    tt = init_tree_t(env, _openings(batch, dev), sims + 2, 3)
    S.search(env, tt, spec, _eval_fn, sims,
             draws=_on(_fixed_draws(batch, sims), dev),
             leaf_batch=leaf_batch)
    assert (tt.n[0] == sims).all()
    return tt, sizes, pending


@pytest.mark.gpu
def test_cuda_multileaf_search_matches_cpu():
    """A search of 8-leaf rounds (39 simulations after the root's: 4 rounds
    and 7 single) with root and tie noise from fixed draws, on the card
    against the CPU: counts, n and links equal, q and v within 1e-6."""
    dev = _cuda()
    env = get_env("connect4")
    spec = SearchSpec(**dict(SPEC_KW, add_root_noise=True,
                             add_root_temp=True))
    draws = _fixed_draws(256, 40)
    trees = []
    for d in (dev, "cpu"):
        tt = init_tree_t(env, _openings(256, d), 42, 3)
        trees.append(S.search(env, tt, spec, _eval_fn, 40,
                              draws=_on(draws, d), leaf_batch=8))
    got, want = trees
    for name in ("n", "parent", "parent_action"):
        assert torch.equal(getattr(got, name)[:-1].cpu(),
                           getattr(want, name)[:-1]), name
    for name in ("q", "v"):
        torch.testing.assert_close(getattr(got, name)[:-1].cpu(),
                                   getattr(want, name)[:-1], rtol=1e-6,
                                   atol=1e-6)
    assert torch.equal(T.counts(got).cpu(), T.counts(want))


@pytest.mark.gpu
def test_cuda_kernels_match_plain_under_rounds(monkeypatch):
    """Both game-minor kernels bit for bit at every walk and backup of an
    8-leaf search on the card, among them walks that meet pending
    children (allocated earlier in the round, not yet backed up)."""
    _, sizes, pending = _held_search(monkeypatch, _cuda(), 256, 40, 8)
    assert sizes == {43}
    assert max(pending) > 0


@pytest.mark.gpu
def test_cuda_kernels_match_plain_at_segment_shapes(monkeypatch):
    """Both game-minor kernels bit for bit at every walk and backup of a
    segmented 200-simulation search on the card: the slices of N = 32,
    64 and 128 rows and the whole tree of 203."""
    _, sizes, pending = _held_search(monkeypatch, _cuda(), 256, 200, 1)
    assert sizes == {32, 64, 128, 203}
    assert max(pending) == 0  # one leaf a network call: nothing pending


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 7])
def test_cuda_rows_kernels_match_plain_at_batch_major_slices(B, monkeypatch):
    """Both batch-major kernels bit for bit at every walk and backup of a
    segmented 200-simulation fresh batch-major search on the card (the
    players' search, B = 1; and 7 games): on the contiguous slices of 32,
    64 and 128 rows and on the whole tree."""
    dev = _cuda()
    spec = SearchSpec(**SPEC_KW)
    walk, backup = S.descend_batched, S.backup_batched
    sizes = set()

    def held_walk(tree, sp):
        sizes.add(tree.parent.shape[1])
        eany = (tree.e > 0).any(dim=-1).to(torch.float32)
        cols = [eany if c == "eany" else getattr(tree, c) for c in COLUMNS]
        got = OD.descend_rows(*cols, sp)
        torch.cuda.synchronize()
        want = OD.descend_plain(*(c.t() for c in cols), sp.cpuct,
                                sp.fpu_reduction)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))
        return walk(tree, sp)

    def held_backup(tree, values, sp):
        _hold_rows(dict(parent=tree.parent, parent_action=tree.parent_action,
                        n=tree.n, q=tree.q, v=tree.v,
                        edge_prior=tree.edge_prior,
                        eany=(tree.e > 0).any(dim=-1).to(torch.float32),
                        nba=tree.nba, nbp=tree.nbp, player=tree.player,
                        leaf=tree.leaf, value=values,
                        max_depth=tree.max_depth), sp)
        return backup(tree, values, sp)

    monkeypatch.setattr(S, "descend_batched", held_walk)
    monkeypatch.setattr(S, "backup_batched", held_backup)
    env = get_env("connect4")
    tree = S.init_batched_trees(env, _openings(B, dev), 202, 3)
    S.search(env, tree, spec, _eval_fn, 200,
             draws=_on(_fixed_draws(B, 200), dev))
    assert sizes == {32, 64, 128, 203}
    assert (tree.n[:, 0] == 200).all()


@pytest.mark.gpu
def test_cuda_wrappers_count_launches_by_tree_rows():
    """Each game-minor wrapper counts its launches by the tree's rows: a
    segmented 200-simulation search walks 30 / 32 / 64 / 73 times on 32 /
    64 / 128 / 203 rows, and backs up once more on the whole tree (the
    root's expansion)."""
    dev = _cuda()
    env = get_env("connect4")
    before = (Counter(OD.descend_columns.launches_by_rows),
              Counter(OB.backup_columns_.launches_by_rows))
    tt = init_tree_t(env, _openings(64, dev), 202, 3)
    S.search(env, tt, SearchSpec(**SPEC_KW), _eval_fn, 200,
             draws=_on(_fixed_draws(64, 200), dev))
    assert OD.descend_columns.launches_by_rows - before[0] == Counter(
        {32: 30, 64: 32, 128: 64, 203: 73})
    assert OB.backup_columns_.launches_by_rows - before[1] == Counter(
        {32: 30, 64: 32, 128: 64, 203: 74})


@pytest.mark.gpu
def test_cuda_rounds_and_segments_never_wait_for_the_device():
    """Under CUDA's sync debug mode: a segmented fresh TreeT search (40
    simulations: slices of 32 and 43 rows), an 8-leaf search, and the
    batch-major segment (slice, simulations, merge) make no call that
    waits for the device. (``search`` on a batch-major tree reads its
    allocation fronts once before the loop, by design.)"""
    dev = _cuda()
    env = get_env("connect4")
    eval_fn = _table_eval(env)  # its tables stay on the card
    spec = SearchSpec(**dict(SPEC_KW, tie_noise=1e-6))
    roots = _openings(64, dev)
    gen = torch.Generator(dev).manual_seed(0)
    S.search(env, init_tree_t(env, roots, 10, 3), spec, eval_fn, 8,
             generator=gen, leaf_batch=4)  # warm-up: tables, allocator
    trees = [init_tree_t(env, roots, 42, 3) for _ in range(2)]
    tree = S.init_batched_trees(env, roots, 42, 3)
    S.simulate_step(env, tree, spec, eval_fn, True, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        S.search(env, trees[0], spec, eval_fn, 40, generator=gen)
        S.search(env, trees[1], spec, eval_fn, 40, generator=gen,
                 leaf_batch=8)
        part = T.slice_batched_rows(tree, 32)
        for _ in range(1, 31):
            S.simulate_step(env, part, spec, eval_fn, False, generator=gen)
        T.merge_batched_rows(tree, part)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for tt in trees:
        assert (tt.n[0] == 40).all()
    assert (tree.n[:, 0] == 31).all()


@pytest.mark.gpu
def test_cuda_two_rank_train_step_matches_one_rank(tmp_path):
    """Two ranks sharing the card in a Gloo group (its collectives on CUDA
    tensors; tests/torch_rank_worker.py): two float32 train steps of a
    small ResNet on each rank's half of each global batch of 16, the
    ranks' weights and statistics bit-identical and within 1e-4 relative
    plus 1e-5 of the same steps of one process on the card (BatchNorm over
    the global batch, the mean gradient)."""
    dev = _cuda()
    from alphazero_general_tpu_torch.models import NNetWrapper
    from alphazero_general_tpu_torch.utils import get_args
    from torch_rank_worker import launch

    env = get_env("connect4")
    knobs = dict(num_channels=16, depth=2, value_head_channels=4,
                 policy_head_channels=4, value_dense_layers=[32],
                 policy_dense_layers=[32], compute_dtype="float32", seed=3)
    one = NNetWrapper(env, get_args(**knobs), device=dev)
    state = {k: v.cpu().clone() for k, v in one.model.state_dict().items()}
    g = torch.Generator().manual_seed(4)
    batches = []
    for _ in range(2):
        s = env.init(16, "cpu")
        for _ in range(8):
            valid = env.valid_moves(s).to(torch.float32)
            s = env.step(s, torch.multinomial(valid, 1, generator=g)[:, 0])
        pi = torch.rand((16, 7), generator=g)
        value = torch.nn.functional.one_hot(
            torch.randint(0, 3, (16,), generator=g), 3).to(torch.float32)
        batches.append((env.observation(s).to(torch.float32),
                        pi / pi.sum(-1, keepdim=True), value))
    outs = launch("train", str(tmp_path), dict(
        args=knobs, state=state, batches=batches, device="cuda"))
    one.train(batches, 2)
    assert outs[0]["digest"] == outs[1]["digest"]
    for k, w in one.model.state_dict().items():
        got = outs[0]["state"][k]
        assert torch.allclose(got, w.cpu(), rtol=1e-4, atol=1e-5), k
        assert not torch.equal(got, state[k]), k  # trained


@pytest.mark.gpu
def test_cuda_kernels_match_plain_in_each_rank(tmp_path):
    """Both game-minor kernels bit for bit against their plain versions
    in each of two ranks that share the card, each at a snapshot of a
    search of its 128 of 256 games (its draws the global batch's, cut
    through a GameShard, whose root noise gathers every rank's rows)."""
    _cuda()
    from torch_rank_worker import launch

    outs = launch("kernels", str(tmp_path), dict(games=256, sims=40,
                                                  snapshot=20))
    for r, out in enumerate(outs):
        assert all(out["same"]), (r, out["same"])
        # descend: the compared launch and the snapshot's own walk.
        assert out["launches"] == (2, 1) and out["root_n"] == 20


# --------------------------------------------------------------------------
# The GUI and the Coach's pause and stop
# --------------------------------------------------------------------------

def _hold_every_rows_launch(monkeypatch, held: Counter, bad: list):
    """Both batch-major wrappers, wherever the searches look them up,
    replaced by ones that hold each launch bit for bit against the plain
    version on CPU copies of its inputs (from any thread: a mismatch is
    recorded in ``bad``)."""
    descend, backup = OD.descend_rows, OB.backup_rows_

    def descend_held(*cols_spec):
        *cols, spec = cols_spec
        got = descend(*cols, spec)
        want = OD.descend_plain(*(c.t().cpu() for c in cols), spec.cpuct,
                                spec.fpu_reduction)
        if not all(torch.equal(_bits(g.cpu()), _bits(w))
                   for g, w in zip(got, want)):
            bad.append(("descend_rows", cols[0].shape))
        held["descend_rows"] += 1
        return got

    def backup_held(parent, player, leaf, value, max_depth, n, q, v, spec):
        args = [x.cpu() for x in (parent, player, leaf, value, max_depth)]
        p_nqv = [x.cpu() for x in (n, q, v)]
        backup(parent, player, leaf, value, max_depth, n, q, v, spec)
        OB.backup_plain_(args[0].t(), args[1].t(), *args[2:],
                         *(x.t() for x in p_nqv), spec)
        if not all(torch.equal(_bits(g.cpu()), _bits(w))
                   for g, w in zip((n, q, v), p_nqv)):
            bad.append(("backup_rows", parent.shape))
        held["backup_rows"] += 1

    # The wrappers count their launches on whatever their module's name
    # holds: these.
    for held_fn in (descend_held, backup_held):
        held_fn.launches, held_fn.launches_by_rows = 0, Counter()
    monkeypatch.setattr(OD, "descend_rows", descend_held)
    monkeypatch.setattr(OB, "backup_rows_", backup_held)


@pytest.mark.gpu
def test_cuda_gui_session_kernels_match_plain(monkeypatch):
    """A GUI connect4 session on the card against rawmcts: every launch
    of both batch-major kernels, the opponent's searches (N = sims + 3)
    and the live evaluator's (N = 403, on its own thread), bit for bit
    against the plain versions; the board equals the CPU's replay."""
    from alphazero_general_tpu_torch.gui import server as G

    dev = _cuda()
    held, bad = Counter(), []
    _hold_every_rows_launch(monkeypatch, held, bad)
    sess = G.GameSession("connect4", "rawmcts", 0, sims=32, device=dev)
    assert sess.state.board.device.type == "cuda"
    assert sess.evaluator.device.type == "cuda"
    sess.start()
    for col in (3, 3, 2):
        out = sess.human_move(None, [0, col])
        assert out["player"] == 0 and not out["terminal"], out["message"]
    sess.evaluator._thread.join(timeout=60)
    sess.evaluator.stop()
    assert sess.evaluator.analysis.sims > 0
    assert not bad, bad
    # Three agent moves of 32 simulations, and the evaluator's, each a
    # launch of both kernels.
    assert held["descend_rows"] == held["backup_rows"] >= 3 * 32 + 1
    assert OD.descend_rows.launches == held["descend_rows"]
    assert OB.backup_rows_.launches == held["backup_rows"]
    replay = sess.env.init(1, "cpu")
    for s in sess.history[1:]:
        replay = sess.env.step(replay, s.last_action.cpu())
    assert torch.equal(sess.state.board.cpu(), replay.board)


@pytest.mark.gpu
def test_cuda_coach_paused_and_stopped():
    """A tictactoe Coach on the card, on a thread: paused before its
    first move it launches no kernel; resumed, it plays; stopped, it
    leaves self-play and learn, in STANDBY, without training."""
    import tempfile
    import threading
    import time

    from alphazero_general_tpu_torch.models import NNetWrapper
    from alphazero_general_tpu_torch.train import Coach, TrainState
    from alphazero_general_tpu_torch.utils import get_args

    dev = _cuda()
    with tempfile.TemporaryDirectory() as root:
        args = get_args(
            run_name="paused", checkpoint=f"{root}/checkpoint",
            data=f"{root}/data", log_dir=f"{root}/runs", numIters=1,
            process_batch_size=64, gamesPerIteration=10**6,
            numWarmupSims=8, num_channels=8, depth=1,
            value_dense_layers=[8], policy_dense_layers=[8],
            deviceWindowRows=16384)
        env = get_env("tictactoe")
        coach = Coach(env, NNetWrapper(env, args, device=dev), args)
        coach.pause_train.set()
        start = OD.descend_columns.launches
        t = threading.Thread(target=coach.learn, daemon=True)
        t.start()
        time.sleep(2.0)
        assert coach.state == TrainState.SELF_PLAY
        assert OD.descend_columns.launches == start
        coach.pause_train.clear()
        deadline = time.time() + 60
        while coach.games_played_iter == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert coach.games_played_iter > 0
        coach.stop_train.set()
        t.join(timeout=60)
        assert not t.is_alive()
        assert coach.state == TrainState.STANDBY and coach.model_iter == 1
        assert OD.descend_columns.launches > start
        coach.writer.close()


@pytest.mark.gpu
def test_cuda_search_kernels_launch_inside_their_stage_spans():
    """A profiled connect4 search on the card with the program's tracing
    on, in both tree layouts: every launch of a descend kernel lies inside
    a ``search.descend`` range and every launch of a backup kernel inside
    a ``search.backup`` range, on the trace's own clock."""
    from alphazero_general_tpu_torch.utils import trace

    dev = _cuda()
    env = get_env("connect4")
    spec = SearchSpec(**dict(SPEC_KW, tie_noise=0.0))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with trace.tracing(), torch.profiler.profile(activities=acts) as prof:
        S.search(env, init_tree_t(env, _openings(256, dev), 40, 3), spec,
                 _eval_fn, 24)
        S.search(env, T.init_tree(env, _openings(1, dev), 40, 3), spec,
                 _eval_fn, 24)
        torch.cuda.synchronize()
    trace.reset()
    ranges = {"descend": [], "backup": []}
    launch, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # The ranges laid over the device's timeline are no kernels.
            kind = [k for k in ranges if k in e.name()
                    and not e.name().startswith("search")]
            if kind:
                kernels.append((kind[0], e.correlation_id()))
        elif e.name() in ("search.descend", "search.backup"):
            ranges[e.name().split(".")[1]].append((start, end))
        elif e.name().startswith("cu") and e.correlation_id():
            launch[e.correlation_id()] = start
    placed = Counter()
    for kind, corr in kernels:
        if corr in launch:
            t = launch[corr]
            assert any(s <= t <= e for s, e in ranges[kind]), (kind, t)
            placed[kind] += 1
    # 23 descends on the TreeT (the root's expansion walks nowhere) and 24
    # on the one-game Tree; 24 backups on each. The profiler may lose a
    # few records of a long run; it keeps most.
    assert placed["descend"] >= 40 and placed["backup"] >= 40, placed
