"""The yardstick's arithmetic: the network's least time at the card's
peaks (from the operations its reference module counts) and bytes of the
search kernels, computed from shapes and trees.

Frozen here so that a change to the program cannot change how it is
measured. The byte rules of the two search kernels are those of the
repository's smoke script at the time this benchmark was written
(``_descend_bytes`` and ``kernel_bound``), copied, and applied to every
walk of a whole search, reconstructed from the final tree of that search.
"""

from __future__ import annotations

import numpy as np

from azbench import peaks, registry


def forward_least_s(cfg: dict, rows: int, tower_precision: str,
                    other_precision: str = "bfloat16") -> float:
    """The least time ``rows`` forwards need at the card's peaks: the tower
    at the peak of ``tower_precision``, the rest at ``other_precision``'s.
    The operations of a row are the configuration's network's
    (``registry.network(cfg).ops``)."""
    ops = registry.network(cfg).ops(cfg)
    return rows * (ops["tower"] / peaks.PEAK_OF[tower_precision]
                   + ops["other"] / peaks.PEAK_OF[other_precision])


def segment_plan(sims: int, rows: int, min_nodes: int = 32) -> list:
    """[(n, lo, hi)]: simulations k in [lo, hi) of a fresh search walk the
    first n rows of a tree of ``rows`` rows, n doubling from ``min_nodes``
    (the growing arena of the search; simulation 0 expands the root without
    a walk)."""
    segs = []
    lo = 1
    n = min(min_nodes, rows)
    while lo < sims:
        if n >= rows:
            segs.append((rows, lo, sims))
            break
        hi = min(sims, n - 1)
        if hi > lo:
            segs.append((n, lo, hi))
            lo = hi
        n *= 2
    return segs


def search_walks(parent: np.ndarray, sims: int) -> dict:
    """Per-simulation walk statistics of a fresh search of ``sims``
    simulations from its final game-minor parent links ``parent`` [R, B]
    (row k allocated by simulation k; -1 where unallocated).

    For each simulation k >= 1 whose walk allocated row k, the walk's depth
    d (edges from the root to row k) and the sum over the d nodes it scored
    (the root down to row k's parent) of their children then (rows below
    k). A walk that ended on an existing terminal child allocates nothing;
    it is counted as unseen. Returns numpy arrays over k = 1..sims-1,
    summed over games: ``depth``, ``scored_kids``, ``walked`` (games), and
    the total ``unseen``."""
    parent = np.asarray(parent, np.int64)
    R, B = parent.shape
    games = np.arange(B)
    depth_of = np.zeros((R, B), np.int64)
    kids = np.zeros((R, B), np.int64)
    out = {k: np.zeros(max(sims - 1, 0), np.int64)
           for k in ("depth", "scored_kids", "walked")}
    unseen = 0
    for k in range(1, sims):
        par = parent[k]
        alloc = par >= 0
        unseen += int((~alloc).sum())
        p = np.where(alloc, par, 0)
        depth_of[k] = np.where(alloc, depth_of[p, games] + 1, 0)
        s = np.zeros(B, np.int64)
        a = p.copy()
        live = alloc.copy()
        while live.any():
            s += np.where(live, kids[a, games], 0)
            nxt = parent[a, games]
            live &= (a != 0) & (nxt >= 0)
            a = np.where(live, nxt, 0)
        out["depth"][k - 1] = int(depth_of[k][alloc].sum())
        out["scored_kids"][k - 1] = int(s[alloc].sum())
        out["walked"][k - 1] = int(alloc.sum())
        np.add.at(kids, (p[alloc], games[alloc]), 1)
    out["unseen"] = unseen
    return out


def descend_search_bytes(walks: dict, sims: int, rows: int,
                         games: int) -> int:
    """Bytes the descend kernel's walks of one fresh search need, by the
    smoke script's rules (4 B an element): per launch and game the root's
    n and eany and the five outputs; per walking game the parent column
    of the launch's slice once (rows 0..n-2); per node scored its v and nbp
    and the q, n and edge_prior of each of its children; per step to an
    existing child its parent_action and eany; nba where the walk ends on
    a new edge."""
    elems = 0
    for n, lo, hi in segment_plan(sims, rows):
        for k in range(lo, hi):
            i = k - 1
            d = int(walks["depth"][i])
            walked = int(walks["walked"][i])
            elems += games * 7 + walked * (n - 1)
            elems += 2 * (d - walked) + walked
            elems += 2 * d + 3 * int(walks["scored_kids"][i])
    return 4 * elems


def backup_search_bytes(walks: dict, sims: int, games: int) -> int:
    """Bytes the backup kernel of one fresh search needs
    (``kernel_bound``): 32 per path edge (parent, player, n, q, v read; n,
    q, v written) and 36 per game and launch (leaf, value, max_depth read;
    the root's n, v, player)."""
    return 32 * int(walks["depth"].sum()) + 36 * games * sims
