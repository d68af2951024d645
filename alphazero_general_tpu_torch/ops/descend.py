"""Batched PUCT descent: the CUDA kernels of ``csrc/descend.cu`` and their
plain PyTorch version — the port of alphazero_general_tpu/ops/descend.py.

The walk reads nine tree columns — parent, parent_action, n, q, v,
edge_prior, eany, nba, nbp — and never the per-action prior rows: the best
unexpanded action of a node is its rank-walk pointer (``nba``/``nbp``, see
mcts/tree.next_best), so nothing here depends on the action-space size. It
draws no randomness. Two entry points take the two tree layouts, each
reading the columns where they lie:

* :func:`descend_columns`: game-minor ``[N, B]`` columns (a ``TreeT``);
* :func:`descend_rows`: batch-major ``[B, N]`` rows (a ``Tree``), with
  :func:`descend_batched` over a whole ``Tree``.

Each launches its kernel for CUDA tensors and runs :func:`descend_plain`
for CPU tensors; there is no other fallback. The kernels stage each game's
parent links in shared memory, so they take trees of up to ``MAX_NODES``
rows; a larger CUDA tree raises ValueError.
"""

from __future__ import annotations

from collections import Counter

import torch

from alphazero_general_tpu_torch.mcts.tree import SearchSpec, UNVISITED
from alphazero_general_tpu_torch.ops.build import current_stream, \
    load_library

NEG_INF = -3.0e38

_COLUMN_NAMES = ("parent", "parent_action", "n", "q", "v", "edge_prior",
                 "eany", "nba", "nbp")
_DTYPES = (torch.int32, torch.int32, torch.int32, torch.float32,
           torch.float32, torch.float32, torch.float32, torch.int32,
           torch.float32)
#: Games a block of the kernel takes, largest first (one warp each); the
#: kernel is built for each of them (csrc/descend.cu).
GAMES_PER_BLOCK = (8, 4, 2, 1)
#: Shared memory one block may use on an H100 (227 KB).
SMEM_PER_BLOCK = 232448
#: The largest N the kernel takes (one game a block): 58,081 rows.
MAX_NODES = SMEM_PER_BLOCK // 4 - 32 + 1


def _sum_rows_in_order(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Column sums of ``x`` [N, B] over the rows where ``mask`` is set,
    accumulated one row at a time in ascending row order — the kernel's
    order — so that the plain version rounds exactly as the kernel does.

    The same sum as adding every row with 0.0 where the mask is clear: a
    sum that starts at +0.0 is never -0.0, so adding +0.0 leaves it as it
    is. Only the rows that count are added, in as many steps as a column
    has of them."""
    N, B = x.shape
    rows = torch.arange(N, device=x.device)[:, None]
    key = torch.where(mask, rows, N)
    most = int(mask.sum(dim=0).max())
    acc = torch.zeros(B, dtype=x.dtype, device=x.device)
    if most == 0:
        return acc
    # Each column's masked rows first, in ascending order; then padding.
    key, order = torch.topk(key, most, dim=0, largest=False, sorted=True)
    vals = torch.where(key < N, x.gather(0, order), 0.0)
    for row in vals:
        acc = acc + row
    return acc


def descend_plain(parent, parent_action, n, q, v, edge_prior, eany, nba,
                  nbp, cpuct: float, fpu_reduction: float):
    """Plain PyTorch walk over ``[N, B]`` columns; the same function as the
    kernel, one vectorised step for all games per loop turn.

    Returns (node, action, child, depth) int32[B] and p_sel float32[B].
    """
    N, B = parent.shape
    dev = parent.device
    games = torch.arange(B, device=dev)
    nf = n.to(torch.float32)
    not_sink = (torch.arange(N, device=dev) < N - 1)[:, None]
    stops = (eany > 0.5) | (n == 0)  # terminal or pending children stop

    node = torch.zeros(B, dtype=torch.int64, device=dev)
    action = torch.zeros(B, dtype=torch.int32, device=dev)
    child = torch.full((B,), UNVISITED, dtype=torch.int32, device=dev)
    depth = torch.zeros(B, dtype=torch.int32, device=dev)
    p_sel = torch.zeros(B, dtype=torch.float32, device=dev)
    done = (n[0] == 0) | (eany[0] > 0.5)

    for _ in range(N):  # a walk visits at most N nodes
        if bool(done.all()):
            break
        cur_n = nf[node, games]
        cur_v = v[node, games]
        is_child = (parent == node[None, :]) & not_sink  # [N, B]
        seen = _sum_rows_in_order(edge_prior, is_child)
        fpu = cur_v - fpu_reduction * torch.sqrt(torch.clamp(seen, min=0.0))
        sqrt_n = torch.sqrt(cur_n)

        score = q + cpuct * edge_prior * sqrt_n[None, :] / (1.0 + nf)
        score = torch.where(is_child, score, NEG_INF)
        c_star = score.argmax(dim=0)
        best_c = score.amax(dim=0)
        a_c = parent_action[c_star, games]
        ep_c = edge_prior[c_star, games]
        term_c = stops[c_star, games]

        a_u = nba[node, games]
        pv_u = nbp[node, games]
        best_u = torch.where(pv_u >= 0.0, fpu + cpuct * pv_u * sqrt_n,
                             NEG_INF)

        child_wins = best_c > best_u  # exact tie → the unexpanded action
        live = ~done
        action = torch.where(live, torch.where(child_wins, a_c, a_u), action)
        child = torch.where(
            live, torch.where(child_wins, c_star.to(torch.int32), UNVISITED),
            child)
        p_sel = torch.where(live, torch.where(child_wins, ep_c, pv_u), p_sel)
        node = torch.where(live & child_wins, c_star, node)
        depth = depth + live.to(torch.int32)
        done = done | ~child_wins | term_c
    return node.to(torch.int32), action, child, depth, p_sel


def _check_columns(cols: tuple, batch_major: bool = False) -> tuple:
    """Raise on a column of the wrong type, shape or device, or one that is
    not contiguous; returns the shape, (N, B) or with ``batch_major``
    (B, N)."""
    parent = cols[0]
    shape = parent.shape
    device = parent.device
    want = "[B, N >= 2]" if batch_major else "[N >= 2, B]"
    if len(shape) != 2 or shape[int(batch_major)] < 2:
        raise ValueError(f"tree columns must be {want}, got {tuple(shape)}")
    for name, x, want in zip(_COLUMN_NAMES, cols, _DTYPES):
        if x.dtype != want:
            raise TypeError(f"{name}: expected {want}, got {x.dtype}")
        if x.shape != shape:
            raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                             f"got {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, parent on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return shape


def staged_bytes(num_nodes: int, games: int) -> int:
    """Shared memory of one block of the kernel: the staged parent rows
    0..N-2 of ``games`` games and a list of 32 child rows per game (as
    ``smem_bytes`` in csrc/descend.cu)."""
    return 4 * games * (num_nodes - 1 + 32)


def games_per_block(num_nodes: int) -> int:
    """The most games a block of the kernel can take for trees of
    ``num_nodes`` rows: the largest of ``GAMES_PER_BLOCK`` whose staged
    rows fit in ``SMEM_PER_BLOCK``. Raises ValueError for trees too large
    even for one game a block."""
    for games in GAMES_PER_BLOCK:
        if staged_bytes(num_nodes, games) <= SMEM_PER_BLOCK:
            return games
    raise ValueError(
        f"trees of {num_nodes} rows need {staged_bytes(num_nodes, 1)} bytes "
        f"of shared memory per game, more than the {SMEM_PER_BLOCK} a block "
        f"may use (at most {MAX_NODES} rows)")


def _launch(entry: str, cols: tuple, num_nodes: int, batch: int,
            spec: SearchSpec):
    """Launch the kernel behind the C entry point ``entry`` on CUDA columns;
    returns (node, action, child, depth, p_sel)."""
    device = cols[0].device
    if device.type != "cuda":
        raise ValueError(f"descend runs on cuda or cpu, not {device}")
    games = games_per_block(num_nodes)
    out = torch.empty((4, batch), dtype=torch.int32, device=device)
    p_sel = torch.empty(batch, dtype=torch.float32, device=device)
    err = getattr(load_library(), entry)(
        *(x.data_ptr() for x in cols), num_nodes, batch, games, spec.cpuct,
        spec.fpu_reduction, out.data_ptr(), p_sel.data_ptr(), device.index,
        current_stream(device.index))
    if err != 0:
        raise RuntimeError(f"descend kernel launch failed: CUDA error {err}")
    node, action, child, depth = out
    return node, action, child, depth, p_sel


def descend_columns(parent, parent_action, n, q, v, edge_prior, eany, nba,
                    nbp, spec: SearchSpec):
    """The walk for every game over game-minor ``[N, B]`` columns: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. Counts
    kernel launches in ``descend_columns.launches``, and by the tree's
    rows N in ``descend_columns.launches_by_rows``.

    Returns (node, action, child, depth) int32[B] and p_sel float32[B].
    """
    cols = (parent, parent_action, n, q, v, edge_prior, eany, nba, nbp)
    N, B = _check_columns(cols)
    if parent.device.type == "cpu":
        return descend_plain(*cols, spec.cpuct, spec.fpu_reduction)
    out = _launch("azg_descend", cols, N, B, spec)
    descend_columns.launches += 1
    descend_columns.launches_by_rows[N] += 1
    return out


descend_columns.launches = 0
descend_columns.launches_by_rows = Counter()


def descend_rows(parent, parent_action, n, q, v, edge_prior, eany, nba, nbp,
                 spec: SearchSpec):
    """The walk for every game over batch-major ``[B, N]`` rows, read where
    they lie (no transpose): the CUDA kernel for CUDA tensors, the plain
    version (on transposed views) for CPU tensors. Counts kernel launches
    in ``descend_rows.launches``, and by the tree's rows N in
    ``descend_rows.launches_by_rows``.

    Returns (node, action, child, depth) int32[B] and p_sel float32[B].
    """
    cols = (parent, parent_action, n, q, v, edge_prior, eany, nba, nbp)
    B, N = _check_columns(cols, batch_major=True)
    if parent.device.type == "cpu":
        return descend_plain(*(x.t() for x in cols), spec.cpuct,
                             spec.fpu_reduction)
    out = _launch("azg_descend_rows", cols, N, B, spec)
    descend_rows.launches += 1
    descend_rows.launches_by_rows[N] += 1
    return out


descend_rows.launches = 0
descend_rows.launches_by_rows = Counter()


def descend_batched_t(tt, spec: SearchSpec):
    """Walk on a game-minor TreeT (its columns are already [N, B]).

    Returns (node, action, child, depth, skip_walk, p_sel)."""
    node, action, child, depth, p_sel = descend_columns(
        tt.parent, tt.parent_action, tt.n, tt.q, tt.v, tt.edge_prior,
        tt.eany, tt.nba, tt.nbp, spec)
    skip_walk = (tt.n[0] == 0) | (tt.eany[0] > 0.5)
    depth = torch.where(skip_walk, 0, depth)
    return node, action, child, depth, skip_walk, p_sel


def descend_batched(tree, spec: SearchSpec):
    """Walk on a batch-major Tree (JAX ``descend_batched`` :226 and
    ``descend_batched_pallas`` :198). A node is terminal where any entry of
    its win vector ``e`` [B, N, V] is set.

    Returns (node, action, child, depth, skip_walk, p_sel)."""
    eany = (tree.e > 0).any(dim=-1)
    node, action, child, depth, p_sel = descend_rows(
        tree.parent, tree.parent_action, tree.n, tree.q, tree.v,
        tree.edge_prior, eany.to(torch.float32), tree.nba, tree.nbp, spec)
    skip_walk = (tree.n[:, 0] == 0) | eany[:, 0]
    depth = torch.where(skip_walk, 0, depth)
    return node, action, child, depth, skip_walk, p_sel
