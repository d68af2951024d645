"""Seeded random trees in the game-minor ``[N, B]`` layout, for holding the
descent and backup kernels against their plain versions (and the plain
versions against the JAX kernels) on trees that no search would grow:
every tree size, ragged game counts, long paths, terminal and pending rows,
nodes with nothing left to expand, and junk in the sink row.

Numpy only, so that the CPU tests (with JAX) and ``chip_smoke.py`` (without)
make the same trees from the same seed.
"""

from __future__ import annotations

import numpy as np

from alphazero_general_tpu_torch.mcts.tree import NBP_NONE

#: Column names and dtypes of the descent's inputs, in its argument order.
DESCEND_COLUMNS = (("parent", np.int32), ("parent_action", np.int32),
                   ("n", np.int32), ("q", np.float32), ("v", np.float32),
                   ("edge_prior", np.float32), ("eany", np.float32),
                   ("nba", np.int32), ("nbp", np.float32))
#: Rows of the chain at the top of every eighth game's tree (or all rows of
#: a smaller tree): its walks go deep and its backups cross many chunks.
CHAIN_ROWS = 40


def random_tree(num_nodes: int, batch: int, seed: int, *,
                action_size: int = 7, num_players: int = 2,
                has_draw: bool = True) -> dict:
    """One random tree per game on ``num_nodes`` rows (row N-1 is the sink).

    Game b allocates rows ``[0, alloc_b)``: row 0 is the root, row r >= 1
    hangs under a parent drawn uniformly from ``[0, r)``, except in every
    eighth game, whose first ``CHAIN_ROWS`` rows form a chain (parent
    r - 1) with nothing left to expand and no stops, so that walks follow
    it to its end (the rest of such a tree hangs below the chain). Rows
    from ``alloc_b`` to N-2 are free (parent -1); the sink row links to a
    random live row, which must never count as a child.
    About 10% of the rows are terminal (``eany`` 1), 10% pending (n 0) and
    20% have nothing left to expand (``nbp`` = NBP_NONE); some roots are
    unvisited or terminal. Values are exact draws (0.5 to each player) in
    some games.

    Returns numpy arrays: the nine descent columns (``DESCEND_COLUMNS``),
    and for the backup ``player`` [N, B], ``leaf`` [B] (a live row, the
    deepest chain row in chain games), ``value`` [B, V] and ``max_depth``
    [B].
    """
    N, B = num_nodes, batch
    if N < 2 or B < 1:
        raise ValueError(f"need N >= 2 and B >= 1, got N={N}, B={B}")
    rng = np.random.default_rng(seed)
    rows = np.arange(N)[:, None]
    alloc = rng.integers(1, N, size=B)  # live rows per game, in [1, N-1]
    chain = (np.arange(B) % 8) == 0
    alloc[chain] = np.maximum(alloc[chain], min(N - 1, CHAIN_ROWS))
    live = rows < alloc[None, :]

    # Parents uniform in [lo, r): lo is 0, or in chain games the chain's
    # last row, so that every chain row but the last has one child.
    lo = np.where(chain, min(CHAIN_ROWS, N) - 1, 0)[None, :]
    lo = np.minimum(lo, np.maximum(rows - 1, 0))
    parent = (lo + np.floor(rng.random((N, B)) * (rows - lo))).astype(
        np.int32)
    in_chain = chain[None, :] & (rows < CHAIN_ROWS)
    parent = np.where(in_chain, rows - 1, parent).astype(np.int32)
    parent = np.where(live, parent, -1)
    parent[0] = -1
    parent[N - 1] = np.floor(rng.random(B) * alloc).astype(np.int32)

    n = rng.integers(1, 60, size=(N, B)).astype(np.int32)
    n[rng.random((N, B)) < 0.1] = 0
    eany = (rng.random((N, B)) < 0.1).astype(np.float32)
    nbp = rng.random((N, B)).astype(np.float32)
    nbp[rng.random((N, B)) < 0.2] = NBP_NONE
    chain_stop = in_chain & live
    n = np.where(chain_stop, np.maximum(n, 1), n)
    eany = np.where(chain_stop, 0.0, eany).astype(np.float32)
    nbp = np.where(chain_stop, NBP_NONE, nbp).astype(np.float32)
    # Roots: mostly visited and live, some unvisited, some terminal.
    n[0] = np.where(rng.random(B) < 0.1, 0, rng.integers(1, 500, size=B))
    eany[0] = np.where(~chain & (rng.random(B) < 0.05), 1.0, 0.0)
    n[0, chain] = np.maximum(n[0, chain], 1)

    V = num_players + int(has_draw)
    value = rng.dirichlet(np.ones(V), size=B).astype(np.float32)
    if has_draw:
        draws = rng.random(B) < 0.1
        value[draws] = 0.0
        value[draws, :num_players] = 0.5
    leaf = np.floor(rng.random(B) * alloc).astype(np.int32)
    leaf[chain] = min(N - 1, CHAIN_ROWS) - 1

    return dict(
        parent=parent,
        parent_action=rng.integers(0, action_size, size=(N, B)).astype(
            np.int32),
        n=n,
        q=rng.uniform(-1.0, 1.0, size=(N, B)).astype(np.float32),
        v=rng.uniform(-1.0, 1.0, size=(N, B)).astype(np.float32),
        edge_prior=rng.random((N, B)).astype(np.float32),
        eany=eany,
        nba=rng.integers(0, action_size, size=(N, B)).astype(np.int32),
        nbp=nbp,
        player=rng.integers(0, num_players, size=(N, B)).astype(np.int32),
        leaf=leaf,
        value=value,
        max_depth=rng.integers(1, N + 1, size=B).astype(np.int32),
    )
