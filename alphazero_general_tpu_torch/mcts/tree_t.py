"""The game-minor search tree — the port of
alphazero_general_tpu/mcts/tree_t.py (TreeT :44-90, the row slices of the
segmented search :207-264 and the fresh-tree write path :285-542).

Every tree column is ``[N, B]``: the game batch rides the LAST axis, so
thread ``b`` of a kernel reads column ``b`` of each row and a warp's loads
are coalesced. The win vectors are flattened per node on the first axis
(``e`` is ``[N*V, B]``), and each env-state field is stored ``[N, S, B]`` in
``node_state``. Row ``N-1`` is the write sink, which no walk ever treats as
a child.

The prior rows are the exception: ``prior`` is batch-major ``[B, N, A]``
for every action-space size. Per simulation the tree reads one A-wide row
per game, at a different node per game (the rank-walk pointer advance of
``apply_walk_observe_t``), and writes one row per game at the same node
(``install_prior_t``). Batch-major, each game's row is A contiguous floats;
game-minor ``[N*A, B]``, every element of the read sits in its own 32-byte
sector (8x the bytes), and at hnefatafl's A = 2420 and B = 512 that is
40 MB a simulation instead of 5 MB. The write is one strided copy either
way. The kernels never read the prior rows.

Fresh trees only: simulation ``k`` of a search writes every game's new node
at the same row ``k`` (the uniform slot). A game whose walk ended at a
terminal node writes junk at that row instead, and its ``parent`` entry
there stays UNVISITED, so nothing can reach the junk.

The functions here update the TreeT IN PLACE (the JAX versions return new
trees), which spares a copy of every column per simulation. Every write of
a search is in place (an indexed assignment, ``copy_``, ``fill_``, an
``out=`` or the kernels' writes), never a reassignment of a field, so a
search may run on the views of ``slice_rows_t`` and needs no merge.

Differences from the JAX TreeT, on purpose:

* no ``expanded`` bitmask: the walk reads only the rank-walk pointers
  (``nba``/``nbp``), and the expanded set of a node is recoverable from them
  (actions expand in descending-(prior, -index) order, see tree.next_best);
* no ``valids`` rows: the sign of a stored prior row packs the valid-move
  mask (``tree.INVALID_PRIOR``), and nothing else reads them;
* one prior layout for every A, where the JAX TreeT keeps small rows
  game-minor and switches to batch-major (``big_rows``) at A >= 128, a
  choice made for the TPU's lane tiles.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from alphazero_general_tpu_torch.envs.core import state_items
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts.tree import (
    NBP_PRISTINE, ROOT, UNVISITED, SearchSpec,
)


@dataclasses.dataclass
class TreeT:
    """A batch of search trees in game-minor layout (batch axis last)."""

    node_state: Dict[str, torch.Tensor]  # field → [N, S, B]
    state_shapes: Dict[str, Tuple[int, ...]]  # field → per-game shape
    parent: torch.Tensor  # int32[N, B]
    parent_action: torch.Tensor  # int32[N, B]
    prior: torch.Tensor  # float32[B, N, A]; INVALID_PRIOR where invalid
    n: torch.Tensor  # int32[N, B] visit counts
    q: torch.Tensor  # float32[N, B] mean backed-up value (parent's view)
    v: torch.Tensor  # float32[N, B] first-visit value (own view)
    e: torch.Tensor  # float32[N*V, B] terminal win vectors
    eany: torch.Tensor  # float32[N, B]; 1.0 where the node is terminal
    player: torch.Tensor  # int32[N, B] player to move at the node
    edge_prior: torch.Tensor  # float32[N, B] prior of the edge into the node
    nba: torch.Tensor  # int32[N, B] rank-walk pointer: best unexpanded action
    nbp: torch.Tensor  # float32[N, B] its prior (NBP_NONE / NBP_PRISTINE)
    next_free: torch.Tensor  # int32[B]
    depth: torch.Tensor  # int32[B] depth of the last walk
    max_depth: torch.Tensor  # int32[B]
    leaf: torch.Tensor  # int32[B] node of the pending leaf
    num_actions: int
    value_size: int

    @property
    def capacity(self) -> int:
        """Usable node rows (the last row is the write sink)."""
        return self.parent.shape[0] - 1


def init_tree_t(env, root_states, capacity: int, value_size: int) -> TreeT:
    """Fresh trees rooted at ``root_states`` (a batched env state) with
    ``capacity`` node rows plus the sink (tree.py:299 init_tree, built
    directly in the game-minor layout)."""
    items = state_items(root_states)
    B = root_states.player.shape[0]
    dev = root_states.player.device
    rows = capacity + 1
    A = env.ACTION_SIZE
    node_state, shapes = {}, {}
    for name, x in items.items():
        shapes[name] = tuple(x.shape[1:])
        S = math.prod(shapes[name])
        buf = torch.zeros((rows, S, B), dtype=x.dtype, device=dev)
        buf[0] = x.reshape(B, S).T
        node_state[name] = buf

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    i32, f32 = torch.int32, torch.float32
    return TreeT(
        node_state=node_state,
        state_shapes=shapes,
        parent=full((rows, B), UNVISITED, i32),
        parent_action=full((rows, B), UNVISITED, i32),
        prior=full((B, rows, A), 0.0, f32),
        n=full((rows, B), 0, i32),
        q=full((rows, B), 0.0, f32),
        v=full((rows, B), 0.0, f32),
        e=full((rows * value_size, B), 0.0, f32),
        eany=full((rows, B), 0.0, f32),
        player=full((rows, B), 0, i32),
        edge_prior=full((rows, B), 0.0, f32),
        nba=full((rows, B), 0, i32),
        nbp=full((rows, B), NBP_PRISTINE, f32),
        next_free=full((B,), 1, i32),
        depth=full((B,), 0, i32),
        max_depth=full((B,), 0, i32),
        leaf=full((B,), ROOT, i32),
        num_actions=A,
        value_size=value_size,
    )


def slice_rows_t(tt: TreeT, n: int) -> TreeT:
    """The first ``n`` node rows of ``tt`` as views (tree_t.py:207
    slice_rows_t): row ``n-1`` is the slice's sink, and the per-game
    vectors (``next_free``, ``depth``, ``max_depth``, ``leaf``) are the
    same tensors.

    A search writes through the views (see the module docstring), so the
    full tree holds its results with no merge (the JAX package's
    ``merge_rows_t`` copies the slice back). Simulation k of a fresh
    search writes row k and walks rows below it, so simulations in [lo,
    hi) may run on a slice of ``n >= hi + 1`` rows: they never write its
    sink, and the walk and backup cost O(n) instead of O(N) (the growing
    arena of ``search._segment_plan``). Each column ``[n, B]``, ``e``
    ``[n*V, B]`` and ``node_state`` ``[n, S, B]`` is contiguous; ``prior``
    ``[B, n, A]`` is strided, and only indexed reads and writes touch it.
    """
    V = tt.value_size
    cols = ("parent", "parent_action", "n", "q", "v", "eany", "player",
            "edge_prior", "nba", "nbp")
    return dataclasses.replace(
        tt, node_state={k: x[:n] for k, x in tt.node_state.items()},
        prior=tt.prior[:, :n], e=tt.e[:n * V],
        **{k: getattr(tt, k)[:n] for k in cols})


def gather_states(env, tt: TreeT, idx: torch.Tensor):
    """The env state stored at node ``idx[b]`` of every game b
    (tree_t.py:285 _gather_states), as a batched game-major state."""
    games = torch.arange(idx.shape[0], device=idx.device)
    rows = idx.long()
    return T.make_state(env, tt.state_shapes, {
        name: buf[rows, :, games] for name, buf in tt.node_state.items()})


def root_states(env, tt: TreeT):
    """Row 0 of every game's node_state."""
    return T.make_state(env, tt.state_shapes, {
        name: buf[0].T for name, buf in tt.node_state.items()})


def scatter_states_uniform(tt: TreeT, states, slot: int) -> None:
    """Write every game's state at the same row ``slot``."""
    for name, x in state_items(states).items():
        buf = tt.node_state[name]
        buf[slot] = x.reshape(x.shape[0], -1).T


def leaf_data(env, states):
    """(win f32[B, V], valid bool[B, A], obs f32[B, ...], player i32[B]) of
    a batched state (tree_t.py _leaf_data), through the env's
    ``win_and_valids``."""
    win, valid = env.win_and_valids(states)
    return win.to(torch.float32), valid, env.observation(states), \
        states.player


def write_expansion(tt: TreeT, slot: int, win, player) -> None:
    """Expansion writes at the uniform ``slot`` (MCTS.pyx:223-226): player
    and terminal vector (tree_t.py:336 _write_expansion). The valid moves
    reach the tree through the prior row ``install_prior_t`` stores."""
    V = tt.value_size
    tt.player[slot] = player
    tt.e[slot * V:(slot + 1) * V] = win.T
    tt.eany[slot] = (win > 0).any(dim=-1).to(torch.float32)


def expand_root_t(env, tt: TreeT):
    """First simulation on a fresh tree: every game's leaf is the root
    (tree_t.py:369). Returns (obs, e_leaf, leaf_valids)."""
    win, valid, obs, player = leaf_data(env, root_states(env, tt))
    write_expansion(tt, 0, win, player)
    tt.depth.zero_()
    tt.leaf.zero_()
    return obs, win, valid


def apply_walk_observe_t(env, tt: TreeT, node, action, child, depth,
                         skip_walk, p_sel, slot: int,
                         multi_leaf: bool = False):
    """Allocate and expand the walk's leaf at the uniform row ``slot``
    (tree_t.py:382). Returns (obs, e_leaf, leaf_valids).

    The leaf's terminal vector is read back from the STORED e row, not from
    the stepped state: when a walk stops at an already-terminal child, the
    re-stepped state is junk (it can even change the winner).

    ``multi_leaf`` (the walks of a multi-leaf round, ``search``): a walk
    may also stop at a PENDING child, allocated by an earlier walk of the
    round and not yet backed up (n == 0). Its stepped state is junk too,
    but its observation is evaluated, so obs and valids are derived from
    the leaf's stored state instead (tree_t.py:461-467), for every kind of
    leaf.
    """
    B = node.shape[0]
    games = torch.arange(B, device=node.device)
    rows = node.long()
    need_alloc = (child == UNVISITED) & ~skip_walk

    child_states = env.step(gather_states(env, tt, node), action)
    win, valid, obs, player = leaf_data(env, child_states)

    # Edge insertion: games that do not allocate keep UNVISITED at the slot,
    # so the junk they write there stays unreachable.
    tt.parent[slot] = torch.where(need_alloc, node, tt.parent[slot])
    tt.parent_action[slot] = torch.where(need_alloc, action,
                                         tt.parent_action[slot])
    # Advance the expanded node's rank-walk pointer past the new edge.
    nb_a, nb_p = T.next_best(tt.prior[games, rows], p_sel, action)
    tt.nba[rows, games] = torch.where(need_alloc, nb_a, tt.nba[rows, games])
    tt.nbp[rows, games] = torch.where(need_alloc, nb_p, tt.nbp[rows, games])
    scatter_states_uniform(tt, child_states, slot)
    tt.edge_prior[slot] = p_sel
    tt.next_free.fill_(slot + 1)

    leaf = torch.where(skip_walk, ROOT,
                       torch.where(need_alloc, slot, child)).to(torch.int32)
    write_expansion(tt, slot, win, player)
    tt.depth.copy_(depth)
    torch.maximum(tt.max_depth, depth, out=tt.max_depth)
    tt.leaf.copy_(leaf)
    e_leaf = tt.e.view(-1, tt.value_size, B)[leaf.long(), :, games]  # [B, V]
    if multi_leaf:
        leaf_states = gather_states(env, tt, leaf)
        obs = env.observation(leaf_states)
        valid = env.valid_moves(leaf_states)
    return obs, e_leaf, valid


def install_prior_t(tt: TreeT, pi, spec: SearchSpec, root_adjust: bool,
                    slot: int, leaf_valids, gammas=None, tie=None,
                    generator=None) -> None:
    """Store the prior row of every game's leaf (``tree.prior_rows``: the
    policy ``pi`` [B, A] masked and renormalised against the leaf's valid
    moves, with root temperature and Dirichlet noise where the leaf is the
    root and ``root_adjust`` is set, and tie noise) at row ``slot``
    (tree_t.py:472, MCTS.pyx:236-258). A multi-leaf round installs after
    all its walks, each at its walk's row, with ``root_adjust=False``.
    The random draws are those of ``prior_rows``."""
    new_prior, nb_a, nb_p = T.prior_rows(
        pi, leaf_valids, spec, (tt.leaf == ROOT) if root_adjust else None,
        gammas, tie, generator)
    tt.prior[:, slot] = new_prior
    tt.nba[slot] = nb_a
    tt.nbp[slot] = nb_p
