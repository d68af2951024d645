"""The yardstick's counting functions: the network's operations against
the hand-worked figures, the search kernels' bytes against the
repository's smoke script's rules (copied here, not imported) applied walk
by walk to a seeded search, and the card's peaks."""

import numpy as np
import pytest
import torch

from azbench import counting, peaks, program as P, registry

torch.set_num_threads(1)


# --- copied from chip_smoke.py (_path_lengths, _descend_bytes) ----------
def _path_lengths(parent, leaf) -> np.ndarray:
    parent = parent.cpu().numpy()
    leaf = leaf.cpu().numpy()
    out = np.zeros(leaf.shape[0], np.int64)
    for b, node in enumerate(leaf):
        while node != 0:
            node = parent[node, b]
            out[b] += 1
    return out


def _descend_bytes(cols, walk) -> int:
    parent = cols[0].cpu().numpy()
    node, _, child, depth = (x.cpu().numpy().astype(np.int64)
                             for x in walk[:4])
    N, B = parent.shape
    games = np.arange(B)
    kids = np.zeros((N, B), np.int64)
    r, b = np.nonzero(parent[:N - 1] >= 0)
    np.add.at(kids, (parent[r, b], b), 1)
    walked = depth > 0
    new_edge = walked & (child < 0)
    elems = B * (2 + 5) + int(walked.sum()) * (N - 1)
    elems += 2 * int((depth - new_edge).sum()) + int(new_edge.sum())
    cur = np.where(child < 0, node, parent[node, games])
    live = walked.copy()
    scored = np.zeros(B, np.int64)
    while live.any():
        elems += int((2 + 3 * kids[cur, games])[live].sum())
        scored += live
        live &= cur != 0
        cur = np.where(live, parent[cur, games], 0)
    assert np.array_equal(scored, depth)
    return elems * 4
# -------------------------------------------------------------------------


def test_network_operations():
    c4 = registry.config("connect4")
    ops = registry.network(c4).ops(c4)
    one_conv = 2 * 42 * 9 * 128 * 128
    assert ops["tower"] == 16 * one_conv
    assert 2048 * one_conv == pytest.approx(25.4e9, rel=2e-3)
    assert ops["tower"] == pytest.approx(0.198e9, rel=2e-3)


def test_peaks():
    assert (peaks.BF16_FLOPS, peaks.INT8_OPS, peaks.HBM_BYTES_PER_S) == (
        989e12, 1979e12, 3.35e12)
    assert peaks.PEAK_OF["int8"] == peaks.INT8_OPS


def test_segment_plan_covers_every_simulation():
    for sims, rows in ((200, 203), (40, 43), (250, 253), (8, 11)):
        plan = counting.segment_plan(sims, rows)
        ks = [k for _, lo, hi in plan for k in range(lo, hi)]
        assert ks == list(range(1, sims))
        assert all(hi <= n - 1 for n, _, hi in plan)


def test_search_bytes_follow_the_smoke_scripts_rules(monkeypatch):
    """Walk by walk, the smoke script's rules on each snapshot of a seeded
    search sum to what counting reconstructs from the final tree."""
    cfg = registry.config("connect4")
    env = P.env(cfg)
    S, TT = P.search_module(), P.tree_t_module()
    spec_mod = P._mod("mcts.tree")
    spec = spec_mod.SearchSpec(cpuct=4.0, fpu_reduction=0.4)
    B, sims = 6, 40
    seen = {"descend": 0, "backup": 0, "launches": 0}
    real_d, real_b = S.descend_batched_t, S.backup_batched_t

    def descend(tt, sp):
        cols = tuple(x.clone() for x in (tt.parent, tt.parent_action, tt.n,
                                          tt.q, tt.v, tt.edge_prior,
                                          tt.eany, tt.nba, tt.nbp))
        out = real_d(tt, sp)
        seen["descend"] += _descend_bytes(cols, out)
        return out

    def backup(tt, values, sp):
        path = _path_lengths(tt.parent, tt.leaf)
        seen["backup"] += int(path.sum()) * 32 + B * 36
        seen["launches"] += 1
        return real_b(tt, values, sp)

    monkeypatch.setattr(S, "descend_batched_t", descend)
    monkeypatch.setattr(S, "backup_batched_t", backup)
    gen = torch.Generator().manual_seed(5)
    states = env.init(B, "cpu")
    tt = TT.init_tree_t(env, states, sims + 2, spec.value_size)
    S.search(env, tt, spec, S.uniform_eval_fn(env.ACTION_SIZE, 3), sims,
             generator=gen)
    walks = counting.search_walks(tt.parent.numpy(), sims)
    assert walks["unseen"] == 0
    assert seen["launches"] == sims
    assert counting.descend_search_bytes(
        walks, sims, tt.parent.shape[0], B) == seen["descend"]
    assert counting.backup_search_bytes(walks, sims, B) == seen["backup"]
