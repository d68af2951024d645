"""Batched PUCT descent: the CUDA kernel ``csrc/descend.cu`` and its plain
PyTorch version — the port of alphazero_general_tpu/ops/descend.py.

The walk reads nine game-minor ``[N, B]`` tree columns — parent,
parent_action, n, q, v, edge_prior, eany, nba, nbp — and never the ``[N*A]``
prior rows: the best unexpanded action of a node is its rank-walk pointer
(``nba``/``nbp``, see mcts/tree.next_best), so nothing here depends on the
action-space size. It draws no randomness.

:func:`descend_columns` launches the kernel for CUDA tensors and runs
:func:`descend_plain` for CPU tensors; there is no other fallback.
"""

from __future__ import annotations

import torch

from alphazero_general_tpu_torch.mcts.tree import SearchSpec, UNVISITED

NEG_INF = -3.0e38

_INT_COLUMNS = ("parent", "parent_action", "n", "nba")
_COLUMN_NAMES = ("parent", "parent_action", "n", "q", "v", "edge_prior",
                 "eany", "nba", "nbp")


def _sum_rows_in_order(x: torch.Tensor) -> torch.Tensor:
    """Column sums of ``x`` [N, B] accumulated row by row in ascending order
    — the order of the kernel's loop — so that the plain version rounds
    exactly as the kernel does."""
    acc = torch.zeros_like(x[0])
    for row in x:
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
        seen = _sum_rows_in_order(torch.where(is_child, edge_prior, 0.0))
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


def _check_columns(cols: dict) -> tuple:
    shape = cols["parent"].shape
    device = cols["parent"].device
    if len(shape) != 2 or shape[0] < 2:
        raise ValueError(f"tree columns must be [N >= 2, B], got {shape}")
    for name, x in cols.items():
        want = torch.int32 if name in _INT_COLUMNS else torch.float32
        if x.dtype != want:
            raise TypeError(f"{name}: expected {want}, got {x.dtype}")
        if x.shape != shape:
            raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                             f"got {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, parent on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return shape, device


def descend_columns(parent, parent_action, n, q, v, edge_prior, eany, nba,
                    nbp, spec: SearchSpec):
    """The walk for every game: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Counts kernel launches in
    ``descend_columns.launches``.

    Returns (node, action, child, depth) int32[B] and p_sel float32[B].
    """
    cols = dict(zip(_COLUMN_NAMES, (parent, parent_action, n, q, v,
                                    edge_prior, eany, nba, nbp)))
    (N, B), device = _check_columns(cols)
    if device.type == "cpu":
        return descend_plain(parent, parent_action, n, q, v, edge_prior,
                             eany, nba, nbp, spec.cpuct, spec.fpu_reduction)
    if device.type != "cuda":
        raise ValueError(f"descend runs on cuda or cpu, not {device}")
    from alphazero_general_tpu_torch.ops.build import load_library

    lib = load_library()
    outs = [torch.empty(B, dtype=torch.int32, device=device)
            for _ in range(4)]
    p_sel = torch.empty(B, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.azg_descend(
            *(x.data_ptr() for x in cols.values()), N, B, spec.cpuct,
            spec.fpu_reduction, *(o.data_ptr() for o in outs),
            p_sel.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"descend kernel launch failed: CUDA error {err}")
    descend_columns.launches += 1
    return (*outs, p_sel)


descend_columns.launches = 0


def descend_batched_t(tt, spec: SearchSpec):
    """Walk on a game-minor TreeT (its columns are already [N, B]).

    Returns (node, action, child, depth, skip_walk, p_sel)."""
    node, action, child, depth, p_sel = descend_columns(
        tt.parent, tt.parent_action, tt.n, tt.q, tt.v, tt.edge_prior,
        tt.eany, tt.nba, tt.nbp, spec)
    skip_walk = (tt.n[0] == 0) | (tt.eany[0] > 0.5)
    depth = torch.where(skip_walk, 0, depth)
    return node, action, child, depth, skip_walk, p_sel
