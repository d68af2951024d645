"""Batched MCTS backup: the CUDA kernels of ``csrc/backup.cu`` and their
plain PyTorch version — the port of alphazero_general_tpu/ops/backup.py.

All update the n / q / v columns IN PLACE (the JAX kernel returns new
arrays; updating in place saves three column copies per simulation).
``values`` must already be terminal-resolved. Two entry points take the two
tree layouts, each reading the columns where they lie:

* :func:`backup_columns_`: game-minor ``[N, B]`` columns (a ``TreeT``);
* :func:`backup_rows_`: batch-major ``[B, N]`` rows (a ``Tree``), with
  :func:`backup_batched` over a whole ``Tree``.

Each launches its kernel for CUDA tensors and runs :func:`backup_plain_`
for CPU tensors; there is no other fallback.
"""

from __future__ import annotations

from collections import Counter

import torch

from alphazero_general_tpu_torch.mcts.tree import DRAW_VALUE, SearchSpec
from alphazero_general_tpu_torch.ops.build import current_stream, \
    load_library


def backup_plain_(parent, player, leaf, value, max_depth, n, q, v,
                  spec: SearchSpec) -> None:
    """Plain PyTorch backup, one vectorised step for all games per loop
    turn; the same function as the kernel. Updates n, q, v in place."""
    N, B = parent.shape
    dev = parent.device
    games = torch.arange(B, device=dev)
    V = value.shape[1]
    maxd = torch.clamp(max_depth.to(torch.float32), min=1.0)
    log_md = spec.log_min_discount
    # The draw share as a true division, like the kernel's: torch on CUDA
    # divides by a Python number through its reciprocal, which rounds
    # otherwise for 3 players (exact for 2).
    draw = value[:, V - 1]
    share = draw / torch.full_like(draw, spec.num_players)

    def value_at(p):
        val = value[games, p.long()]
        if spec.has_draw:
            val = val + share
        return val

    node = leaf.long()
    i = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(N):  # a path has fewer than N edges
        # As in the kernel, a node or link out of range (only in a corrupted
        # tree) stops the walk; ``row`` keeps the reads in range.
        row = node.clamp(0, N - 1)
        par = parent[row, games].long()
        active = (node > 0) & (node < N) & (par >= 0) & (par < N)
        if not bool(active.any()):
            break
        par = torch.where(active, par, 0)
        val = value_at(player[par, games])
        frac = i.to(torch.float32) / maxd
        disc = torch.exp(frac * log_md)
        disc = torch.where(val < DRAW_VALUE, 2.0 - disc, disc)
        disc = torch.where(val == DRAW_VALUE, 1.0, disc)

        n_node = n[row, games]
        nf = n_node.to(torch.float32)
        new_q = (q[row, games] * nf + val * disc) / (nf + 1.0)
        new_v = torch.where(n_node == 0, value_at(player[row, games]),
                            v[row, games])
        # Finished games write their row back unchanged.
        q[row, games] = torch.where(active, new_q, q[row, games])
        v[row, games] = torch.where(active, new_v, v[row, games])
        n[row, games] = n_node + active.to(torch.int32)
        node = torch.where(active, par, node)
        i = i + active.to(torch.int32)

    root_v = value_at(player[0])
    v[0] = torch.where(n[0] == 0, root_v, v[0])
    n[0] += 1


_NAMES = ("parent", "player", "leaf", "value", "max_depth", "n", "q", "v")
_DTYPES = (torch.int32, torch.int32, torch.int32, torch.float32, torch.int32,
           torch.int32, torch.float32, torch.float32)
#: Threads a block of the kernel, one game each. Blocks this small spread
#: the 2048 games of a production batch over 32 SMs (PERF.md).
THREADS = 64


def _check(tensors: tuple, spec: SearchSpec,
           batch_major: bool = False) -> tuple:
    """Raise on an input of the wrong type, shape or device, or one that is
    not contiguous; returns (N, B)."""
    parent = tensors[0]
    if parent.dim() != 2:
        want = "[B, N]" if batch_major else "[N, B]"
        raise ValueError(f"parent must be {want}, got {tuple(parent.shape)}")
    if batch_major:
        B, N = parent.shape
    else:
        N, B = parent.shape
    column, row = tuple(parent.shape), (B,)
    shapes = (column, column, row, (B, spec.value_size), row, column, column,
              column)
    device = parent.device
    for name, x, dtype, shape in zip(_NAMES, tensors, _DTYPES, shapes):
        if x.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
        if x.shape != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, parent on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return N, B


def _launch(entry: str, tensors: tuple, num_nodes: int, batch: int,
            spec: SearchSpec, threads: int) -> None:
    """Launch the kernel behind the C entry point ``entry`` on CUDA
    tensors."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"backup runs on cuda or cpu, not {device}")
    err = getattr(load_library(), entry)(
        *(x.data_ptr() for x in tensors), num_nodes, batch, spec.value_size,
        spec.num_players, int(spec.has_draw), spec.log_min_discount, threads,
        device.index, current_stream(device.index))
    if err != 0:
        raise RuntimeError(f"backup kernel launch failed: CUDA error {err}")


def backup_columns_(parent, player, leaf, value, max_depth, n, q, v,
                    spec: SearchSpec, threads: int = THREADS) -> None:
    """Back ``value`` [B, V] up from ``leaf`` [B] to the root of every game
    over game-minor ``[N, B]`` columns, updating n / q / v in place: the
    CUDA kernel (``threads`` a block) for CUDA tensors, the plain version
    for CPU tensors. Counts kernel launches in
    ``backup_columns_.launches``, and by the tree's rows N in
    ``backup_columns_.launches_by_rows``."""
    tensors = (parent, player, leaf, value, max_depth, n, q, v)
    N, B = _check(tensors, spec)
    if parent.device.type == "cpu":
        backup_plain_(*tensors, spec)
        return
    _launch("azg_backup", tensors, N, B, spec, threads)
    backup_columns_.launches += 1
    backup_columns_.launches_by_rows[N] += 1


backup_columns_.launches = 0
backup_columns_.launches_by_rows = Counter()


def backup_rows_(parent, player, leaf, value, max_depth, n, q, v,
                 spec: SearchSpec, threads: int = THREADS) -> None:
    """:func:`backup_columns_` over batch-major ``[B, N]`` rows, read and
    updated where they lie (no transpose); the plain version runs on
    transposed views. Counts kernel launches in
    ``backup_rows_.launches``, and by the tree's rows N in
    ``backup_rows_.launches_by_rows``."""
    tensors = (parent, player, leaf, value, max_depth, n, q, v)
    N, B = _check(tensors, spec, batch_major=True)
    if parent.device.type == "cpu":
        backup_plain_(parent.t(), player.t(), leaf, value, max_depth, n.t(),
                      q.t(), v.t(), spec)
        return
    _launch("azg_backup_rows", tensors, N, B, spec, threads)
    backup_rows_.launches += 1
    backup_rows_.launches_by_rows[N] += 1


backup_rows_.launches = 0
backup_rows_.launches_by_rows = Counter()


def backup_batched_t(tt, values, spec: SearchSpec) -> None:
    """Backup on a game-minor TreeT, in place; ``values`` is [B, V]."""
    backup_columns_(tt.parent, tt.player, tt.leaf, values, tt.max_depth,
                    tt.n, tt.q, tt.v, spec)


def backup_batched(tree, values, spec: SearchSpec) -> None:
    """Backup on a batch-major Tree, in place (JAX ``backup_batched`` :233
    and ``backup_batched_pallas`` :101); ``values`` is [B, V]."""
    backup_rows_(tree.parent, tree.player, tree.leaf, values, tree.max_depth,
                 tree.n, tree.q, tree.v, spec)
