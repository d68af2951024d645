"""The batch-major search tree and the search constants — the port of the
JAX package's ``mcts/tree.py`` (SearchSpec :74, the sentinels :55-71,
``Tree`` :101-170, ``init_tree`` :299, the general walk writes :538-601 and
:725-830, the row slices of the segmented search :898-960, ``reroot``
:961-1068, ``child_row`` :348 and the root readers ``counts`` /
``root_child_stats`` / ``probs`` / ``best_action`` / ``root_value``
:1075-1120).

The port has two tree layouts, as the JAX package does:

* ``Tree`` (here), batch-major: every per-node column is ``[B, N]``, every
  per-node row ``[B, N, A]`` or ``[B, N, V]``, each env-state field
  ``[B, N, S]``. It is the tree that self-play with tree reuse carries
  across moves: its games' allocation fronts (``next_free``) differ, so
  its writes go to per-game rows (the "general" path), and ``reroot``
  compacts each game's kept subtree to the front of its rows.
* ``TreeT`` (``tree_t.py``), game-minor ``[N, B]``: the fresh tree of one
  move's search, whose simulation k writes row k of every game.

Row ``N-1`` of either is the write sink: masked writes land there, and no
walk ever treats it as a child. The functions here update a ``Tree`` IN
PLACE (the JAX versions return new trees), except ``init_tree``,
``reroot``, ``select_games`` and ``slice_batched_rows``, which build new
ones. Functions that read columns in ``[N, B]`` (``child_row``) take a
batch-major tree as transposed views.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from alphazero_general_tpu_torch.envs.core import state_items
from alphazero_general_tpu_torch.parallel.mesh import draw_gamma, \
    draw_uniform

NOISE_ALPHA_RATIO = 10.83  # MCTS.pyx:20
DRAW_VALUE = 0.5  # MCTS.pyx:21
UNVISITED = -1
ROOT = 0
#: Invalid actions store exactly this prior: the sign of a stored prior row
#: packs the valid-move mask (valid priors are >= 0 after renormalisation).
INVALID_PRIOR = -1.0
#: ``nbp`` sentinel: the node has no unexpanded valid action left.
NBP_NONE = -3.0e38
#: ``nbp`` sentinel of never-installed rows.
NBP_PRISTINE = 3.0e38


class SearchSpec(NamedTuple):
    """Static search hyperparameters (MCTS.pyx:133-145)."""

    cpuct: float = 1.25
    fpu_reduction: float = 0.2
    root_policy_temp: float = 1.1
    root_noise_frac: float = 0.1
    min_discount: float = 1.0
    add_root_noise: bool = True
    add_root_temp: bool = True
    num_players: int = 2
    has_draw: bool = True
    #: Amplitude of the uniform noise added to each installed prior row, which
    #: fixes a random tie order per node (the reference shuffles children once
    #: per expansion, MCTS.pyx:76-79). 0 disables it.
    tie_noise: float = 1e-6

    @property
    def value_size(self) -> int:
        return self.num_players + int(self.has_draw)

    @property
    def log_min_discount(self) -> float:
        """``log(min_discount)`` rounded as the JAX backup kernel computes it
        (a float32 log of the float32 discount, floored at 1e-9)."""
        return _log_discount(self.min_discount)


@functools.lru_cache(maxsize=None)
def _log_discount(min_discount: float) -> float:
    # Cached: the backup wrapper reads it at every launch, and numpy's
    # float32 log costs microseconds of host time there.
    return float(np.log(np.float32(max(min_discount, 1e-9))))


def next_best(prior_row: torch.Tensor, p_star=None, a_star=None):
    """(action i32[B], prior f32[B]) of the best valid action of each row of
    ``prior_row`` [B, A] strictly BELOW ``(p_star, a_star)`` in
    descending-(prior, -index) order — the rank-walk pointer advance. With
    ``p_star=None``, the unrestricted best (fresh-row init).

    Equal priors break toward the lower index, as ``argmax`` does, so the
    pointer tracks the walk's picks even at exact ties. A row with no such
    action returns prior NBP_NONE.
    """
    mask = prior_row >= 0.0
    if p_star is not None:
        iota_a = torch.arange(prior_row.shape[-1], device=prior_row.device)
        p = p_star[:, None]
        below = (prior_row < p) | ((prior_row == p)
                                   & (iota_a[None, :] > a_star[:, None]))
        mask = mask & below
    vals = torch.where(mask, prior_row, NBP_NONE)
    return vals.argmax(dim=-1).to(torch.int32), vals.amax(dim=-1)


def child_row(parent, parent_action, n, q, node, num_actions: int):
    """(child_idx, child_n, child_q), each [B, A]: the child of ``node[b]``
    along each action, derived from the ``[N, B]`` parent links (there is no
    stored child-pointer array). The sink row N-1 is never a child."""
    links = parent[:-1] == node[None, :]  # [N-1, B]
    acts = torch.arange(num_actions, device=parent.device)
    onehot = links[:, :, None] & (parent_action[:-1, :, None] == acts)
    rows = torch.arange(parent.shape[0] - 1, device=parent.device)
    exists = onehot.any(dim=0)  # [B, A]
    idx = torch.where(onehot, rows[:, None, None], 0).sum(dim=0)
    child_idx = torch.where(exists, idx, UNVISITED).to(torch.int32)
    child_n = torch.where(onehot, n[:-1, :, None], 0).sum(dim=0)
    child_q = torch.where(onehot, q[:-1, :, None], 0.0).sum(dim=0)
    return child_idx, child_n.to(torch.int32), child_q


def _game_minor_links(t):
    """(parent, parent_action, n, q) of a tree as ``[N, B]`` columns: a
    TreeT's own, a batch-major Tree's as transposed views."""
    if isinstance(t, Tree):
        return t.parent.t(), t.parent_action.t(), t.n.t(), t.q.t()
    return t.parent, t.parent_action, t.n, t.q


def _at_root(t, column: torch.Tensor, dtype) -> torch.Tensor:
    """[B, A]: the ``column`` ([N, B]) entry of each root child added at
    its action, 0 elsewhere — O(N·B) work where ``child_row`` builds an
    [N, B, A] one-hot (1.25 G elements at hnefatafl's N = 253, B = 512,
    A = 2420). A root has at most one child per action."""
    parent, parent_action = _game_minor_links(t)[:2]
    at_root = parent[:-1] == ROOT  # [N-1, B]; the sink is never a child
    acts = torch.where(at_root, parent_action[:-1], 0).t().long()
    vals = torch.where(at_root, column[:-1], 0).t().to(dtype)
    out = torch.zeros((acts.shape[0], t.num_actions), dtype=dtype,
                      device=acts.device)
    return out.scatter_add_(1, acts, vals)


def counts(t) -> torch.Tensor:
    """i32[B, A] root child visit counts of a Tree or a TreeT."""
    return _at_root(t, _game_minor_links(t)[2], torch.int32)


def root_child_stats(t):
    """(visit counts i32[B, A], q f32[B, A]) of each root child of a Tree
    or a TreeT, 0 where an action has no child — the evaluator's and the
    GUI's readers (tree.py:1084; MCTS.pyx:297-344)."""
    _, _, n, q = _game_minor_links(t)
    return _at_root(t, n, torch.int32), _at_root(t, q, torch.float32)


def best_action(t) -> torch.Tensor:
    """i32[B]: each game's most visited root action (tree.py:1108)."""
    return counts(t).argmax(dim=-1).to(torch.int32)


def root_value(t, average: bool = False) -> torch.Tensor:
    """f32[B]: the max (``average``: the mean over the root's valid
    actions) of the visited root children's q, unvisited ones counting 0
    (tree.py:1112, MCTS.pyx:329-344)."""
    root_n, root_q = root_child_stats(t)
    child_q = torch.where(root_n > 0, root_q, 0.0)
    if not average:
        return child_q.amax(dim=-1)
    valid = t.valids[:, ROOT] if isinstance(t, Tree) else t.prior[:, ROOT] >= 0
    return child_q.sum(dim=-1) / torch.clamp(valid.sum(dim=-1), min=1)


def _renorm(p: torch.Tensor) -> torch.Tensor:
    return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


def probs(visit_counts, temp) -> torch.Tensor:
    """Visit-count policy [B, A] of root visit counts i32[B, A] (or of a
    Tree or TreeT, whose ``counts`` it reads) with per-game temperature
    ``temp`` (a float or f32[B]); temperature 0 gives the argmax one-hot
    (MCTS.pyx:308-327; tree.py:1090). Computed in log space so a large
    1/temp cannot overflow."""
    if not isinstance(visit_counts, torch.Tensor):
        visit_counts = counts(visit_counts)
    c = visit_counts.to(torch.float32)
    B, A = c.shape
    total = torch.clamp(c.sum(dim=-1, keepdim=True), min=1.0)
    frac = c / total
    logf = torch.where(c > 0, torch.log(torch.clamp(frac, min=1e-30)),
                       -torch.inf)
    temp = torch.as_tensor(temp, dtype=torch.float32, device=c.device)
    temp = temp.reshape(-1, 1).expand(B, 1)
    scaled = logf / torch.clamp(temp, min=1e-6)
    finite = torch.isfinite(scaled)
    scaled = scaled - torch.where(finite, scaled, -torch.inf).amax(
        dim=-1, keepdim=True)
    p = _renorm(torch.where(finite, torch.exp(scaled), 0.0))
    onehot = torch.nn.functional.one_hot(c.argmax(dim=-1), A).to(torch.float32)
    return torch.where(temp <= 1e-6, onehot, p)


def _draws_needed(what: str, generator):
    if generator is None:
        raise ValueError(f"install_prior needs {what}: pass them, or a "
                         "torch.Generator to draw them from")


def prior_rows(pi, valids, spec: SearchSpec, is_root=None, gammas=None,
               tie=None, generator=None):
    """The prior rows an install stores, and their fresh rank-walk pointers
    (tree.py:737-830, MCTS.pyx:236-258): ``pi`` [B, A] masked to ``valids``
    (bool[B, A]) and renormalised; where ``is_root`` (bool[B]; None skips
    the root adjustment) the root temperature and Dirichlet noise, as
    ``spec`` enables them; tie noise; INVALID_PRIOR at invalid actions.

    Random draws: ``gammas`` [B, A] are the standard Gamma(alpha) draws
    behind the Dirichlet noise (alpha = 10.83 / #valid moves of the game),
    ``tie`` [B, A] the uniform [0, 1) draws behind the tie noise. Each one
    that is needed and not given is drawn from ``generator`` (a
    ``torch.Generator``, or a ``parallel.GameShard`` for a rank's games).

    Returns (prior f32[B, A], nba i32[B], nbp f32[B]).
    """
    B, A = pi.shape
    masked = torch.where(valids, pi, 0.0)
    norm = masked.sum(dim=-1, keepdim=True)
    nvalid = torch.clamp(valids.sum(dim=-1, keepdim=True), min=1)
    masked = torch.where(norm > 0, masked / norm,
                         valids.to(torch.float32) / nvalid)

    new_prior = masked
    if is_root is not None:
        p = masked
        if spec.add_root_temp:
            p = _renorm(torch.where(valids, p ** (1.0 / spec.root_policy_temp),
                                    0.0))
        if spec.add_root_noise:
            if gammas is None:
                _draws_needed("Dirichlet gamma draws", generator)
                alpha = NOISE_ALPHA_RATIO / nvalid.to(torch.float32)
                gammas = draw_gamma(alpha.expand(B, A).contiguous(),
                                    generator)
            gam = torch.where(valids, gammas, 0.0)
            noise = gam / torch.clamp(gam.sum(dim=-1, keepdim=True),
                                      min=1e-30)
            p = p * (1 - spec.root_noise_frac) + spec.root_noise_frac * noise
            p = torch.where(valids, p, 0.0)
        new_prior = torch.where(is_root[:, None], p, masked)
    if spec.tie_noise:
        if tie is None:
            _draws_needed("tie-noise draws", generator)
            tie = draw_uniform((B, A), generator, pi.device)
        new_prior = torch.where(valids, new_prior + tie * spec.tie_noise,
                                new_prior)
    # Pack the valid mask into the stored row (the INVALID_PRIOR sign).
    new_prior = torch.where(valids, new_prior, INVALID_PRIOR)
    nb_a, nb_p = next_best(new_prior)
    return new_prior, nb_a, nb_p


def make_state(env, state_shapes: Dict[str, Tuple[int, ...]],
               rows: Dict[str, torch.Tensor]):
    """Env state from per-field ``[B, S]`` rows."""
    return env.State(**{
        name: x.reshape((x.shape[0],) + state_shapes[name])
        for name, x in rows.items()})


# --------------------------------------------------------------------------
# The batch-major tree
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Tree:
    """A batch of search trees in batch-major layout (batch axis first):
    the JAX package's vmapped ``Tree`` with its flat row arrays unflattened
    (``prior`` [B, N*A] there is [B, N, A] here).

    Node 0 is the root; rows are allocated in visit order from each game's
    ``next_free``; row N-1 is the write sink. There is no child-pointer
    array: the edge (node, a) -> c is the row c with ``parent[c] == node``
    and ``parent_action[c] == a`` (``child_row``).
    """

    node_state: Dict[str, torch.Tensor]  # field → [B, N, S]
    state_shapes: Dict[str, Tuple[int, ...]]  # field → per-game shape
    parent: torch.Tensor  # int32[B, N]
    parent_action: torch.Tensor  # int32[B, N]
    valids: torch.Tensor  # bool[B, N, A]
    prior: torch.Tensor  # float32[B, N, A]; INVALID_PRIOR where invalid
    n: torch.Tensor  # int32[B, N] visit counts
    q: torch.Tensor  # float32[B, N] mean backed-up value (parent's view)
    v: torch.Tensor  # float32[B, N] first-visit value (own view)
    e: torch.Tensor  # float32[B, N, V] terminal win vectors
    player: torch.Tensor  # int32[B, N] player to move at the node
    edge_prior: torch.Tensor  # float32[B, N] prior of the edge into the node
    #: bool[B, N, A]: the actions whose child row is allocated (the JAX
    #: tree packs it into uint32 words). The walk reads the rank-walk
    #: pointers instead; this mask is the tree's explicit edge set.
    expanded: torch.Tensor
    nba: torch.Tensor  # int32[B, N] rank-walk pointer: best unexpanded action
    nbp: torch.Tensor  # float32[B, N] its prior (NBP_NONE / NBP_PRISTINE)
    next_free: torch.Tensor  # int32[B] next unallocated row
    depth: torch.Tensor  # int32[B] depth of the last walk
    max_depth: torch.Tensor  # int32[B]
    leaf: torch.Tensor  # int32[B] node of the pending leaf
    num_actions: int
    value_size: int

    @property
    def capacity(self) -> int:
        """Usable node rows (the last row is the write sink)."""
        return self.parent.shape[1] - 1


#: The Tree's tensor fields other than ``node_state``.
TREE_TENSORS = tuple(f.name for f in dataclasses.fields(Tree)
                      if f.name not in ("node_state", "state_shapes",
                                        "num_actions", "value_size"))


def init_tree(env, root_states, capacity: int, value_size: int) -> Tree:
    """Fresh trees rooted at ``root_states`` (a batched env state) with
    ``capacity`` node rows plus the sink (tree.py:299 init_tree and
    search.py:26 init_batched_trees)."""
    items = state_items(root_states)
    B = root_states.player.shape[0]
    dev = root_states.player.device
    rows = capacity + 1
    A = env.ACTION_SIZE
    node_state, shapes = {}, {}
    for name, x in items.items():
        shapes[name] = tuple(x.shape[1:])
        buf = torch.zeros((B, rows, math.prod(shapes[name])), dtype=x.dtype,
                          device=dev)
        buf[:, 0] = x.reshape(B, -1)
        node_state[name] = buf

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    i32, f32 = torch.int32, torch.float32
    return Tree(
        node_state=node_state,
        state_shapes=shapes,
        parent=full((B, rows), UNVISITED, i32),
        parent_action=full((B, rows), UNVISITED, i32),
        valids=full((B, rows, A), False, torch.bool),
        prior=full((B, rows, A), 0.0, f32),
        n=full((B, rows), 0, i32),
        q=full((B, rows), 0.0, f32),
        v=full((B, rows), 0.0, f32),
        e=full((B, rows, value_size), 0.0, f32),
        player=full((B, rows), 0, i32),
        edge_prior=full((B, rows), 0.0, f32),
        expanded=full((B, rows, A), False, torch.bool),
        nba=full((B, rows), 0, i32),
        nbp=full((B, rows), NBP_PRISTINE, f32),
        next_free=full((B,), 1, i32),
        depth=full((B,), 0, i32),
        max_depth=full((B,), 0, i32),
        leaf=full((B,), ROOT, i32),
        num_actions=A,
        value_size=value_size,
    )


def select_games(mask: torch.Tensor, a: Tree, b: Tree) -> Tree:
    """A new Tree holding ``a``'s trees where ``mask`` (bool[B]) is set and
    ``b``'s elsewhere."""

    def pick(x, y):
        return torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)

    return dataclasses.replace(
        a,
        node_state={k: pick(x, b.node_state[k])
                    for k, x in a.node_state.items()},
        **{k: pick(getattr(a, k), getattr(b, k)) for k in TREE_TENSORS})


def slice_batched_rows(tree: Tree, n: int) -> Tree:
    """A copy of the first ``n`` node rows of every game of ``tree``
    (tree.py:898 slice_batched_rows), whose row ``n-1`` is the slice's
    sink; the per-game vectors (``next_free``, ``depth``, ``max_depth``,
    ``leaf``) are the same tensors.

    A ``[B, n]`` slice of a ``[B, N]`` column is not contiguous, and the
    kernels take contiguous rows, so the slice is a contiguous copy (a few
    small copies a segment at the players' one game). Simulation k of a
    fresh search allocates at most row k, so simulations in [lo, hi) may
    run on a slice of ``n >= hi + 1`` rows (the growing arena of
    ``search._segment_plan``); their masked writes land on the slice's
    sink, which :func:`merge_batched_rows` leaves behind.
    """

    def cut(x):
        return x[:, :n].clone(memory_format=torch.contiguous_format)

    return dataclasses.replace(
        tree, node_state={k: cut(x) for k, x in tree.node_state.items()},
        **{k: cut(getattr(tree, k)) for k in TREE_TENSORS
           if getattr(tree, k).dim() > 1})


def merge_batched_rows(full: Tree, part: Tree) -> None:
    """Copy the rows of a searched slice below its sink back into ``full``
    (tree.py:929 merge_batched_rows). The slice's sink row holds the junk
    of masked writes; the full tree's row there stays as it was, pristine,
    where the JAX package restores the slice's parent links to UNVISITED
    before merging the whole slice."""
    n = part.parent.shape[1] - 1
    for k, x in full.node_state.items():
        x[:, :n] = part.node_state[k][:, :n]
    for k in TREE_TENSORS:
        x = getattr(full, k)
        if x.dim() > 1:
            x[:, :n] = getattr(part, k)[:, :n]


def _games(tree: Tree) -> torch.Tensor:
    return torch.arange(tree.parent.shape[0], device=tree.parent.device)


def gather_states(env, tree: Tree, idx: torch.Tensor):
    """The env state stored at node ``idx[b]`` of every game b
    (tree.py:283 gather_state, batched)."""
    games, rows = _games(tree), idx.long()
    return make_state(env, tree.state_shapes, {
        name: buf[games, rows] for name, buf in tree.node_state.items()})


def scatter_states(tree: Tree, states, idx: torch.Tensor) -> None:
    """Write every game's state at its row ``idx[b]`` (tree.py:290
    _scatter_state, batched)."""
    games, rows = _games(tree), idx.long()
    for name, x in state_items(states).items():
        tree.node_state[name][games, rows] = x.reshape(x.shape[0], -1)


def _set_expanded_bit(expanded, node, action, active) -> None:
    """Mark action ``action[b]`` of node ``node[b]`` expanded where
    ``active[b]`` (tree.py:482)."""
    games = torch.arange(node.shape[0], device=node.device)
    rows, acts = node.long(), action.long()
    expanded[games, rows, acts] = expanded[games, rows, acts] | active


def apply_walk(env, tree: Tree, node, action, child, depth, skip_walk,
               p_sel) -> None:
    """Allocate and expand the walk's leaf, each game at its own
    ``next_free`` (tree.py:538-601, the ``uniform_slot=None`` branch;
    MCTS.pyx:218-228). Masked writes of games that allocate nothing go to
    the sink row, which no walk reads."""
    dummy = tree.parent.shape[1] - 1
    games = _games(tree)
    need_alloc = (child == UNVISITED) & ~skip_walk
    child_states = env.step(gather_states(env, tree, node), action)

    slot = torch.where(need_alloc, tree.next_free, dummy)
    scatter_states(tree, child_states, slot)
    # Advance the expanded node's rank-walk pointer past the new edge.
    nb_a, nb_p = next_best(tree.prior[games, node.long()], p_sel, action)
    upd = torch.where(need_alloc, node, dummy).long()
    # No child-pointer array: writing (parent, parent_action) at the new
    # row IS the edge insertion.
    rows = slot.long()
    tree.parent[games, rows] = node
    tree.parent_action[games, rows] = action
    tree.edge_prior[games, rows] = p_sel
    _set_expanded_bit(tree.expanded, node, action, need_alloc)
    tree.nba[games, upd] = nb_a
    tree.nbp[games, upd] = nb_p
    tree.next_free += need_alloc.to(torch.int32)

    leaf = torch.where(skip_walk, ROOT,
                       torch.where(need_alloc, slot, child)).to(torch.int32)
    tree.depth.copy_(depth)
    torch.maximum(tree.max_depth, depth, out=tree.max_depth)
    tree.leaf.copy_(leaf)

    # Expansion (MCTS.pyx:223-226): only a leaf never visited is written;
    # a revisited (terminal) leaf writes the sink.
    leaf_states = gather_states(env, tree, leaf)
    expand_row = torch.where(tree.n[games, leaf.long()] == 0, leaf,
                             dummy).long()
    win, valid = env.win_and_valids(leaf_states)
    tree.player[games, expand_row] = leaf_states.player
    tree.e[games, expand_row] = win.to(torch.float32)
    tree.valids[games, expand_row] = valid


def leaf_observation(env, tree: Tree) -> torch.Tensor:
    """The observation of every game's pending leaf (tree.py:725)."""
    return env.observation(gather_states(env, tree, tree.leaf))


def resolve_value(tree: Tree, value: torch.Tensor) -> torch.Tensor:
    """Terminal leaves back up their stored result instead of the network
    value (tree.py:729, MCTS.pyx:234-235)."""
    e_leaf = tree.e[_games(tree), tree.leaf.long()]
    is_term = (e_leaf > 0).any(dim=-1, keepdim=True)
    return torch.where(is_term, e_leaf, value)


def install_prior(tree: Tree, pi, spec: SearchSpec, root_adjust: bool,
                  gammas=None, tie=None, generator=None) -> None:
    """Store the prior row of every game's pending leaf (``prior_rows``),
    at the leaf where it is not terminal and at the sink where it is
    (tree.py:737-830, the general branch). ``root_adjust`` applies the
    root temperature and noise where the leaf is the root."""
    games = _games(tree)
    leaf = tree.leaf.long()
    new_prior, nb_a, nb_p = prior_rows(
        pi, tree.valids[games, leaf], spec,
        (tree.leaf == ROOT) if root_adjust else None, gammas, tie, generator)
    is_term = (tree.e[games, leaf] > 0).any(dim=-1)
    row = torch.where(is_term, tree.parent.shape[1] - 1, leaf)
    tree.prior[games, row] = new_prior
    tree.nba[games, row] = nb_a
    tree.nbp[games, row] = nb_p


def reroot(env, tree: Tree, action: torch.Tensor) -> Tree:
    """Re-root every game's tree at its root's child for ``action[b]`` —
    tree reuse as the reference's update_root (MCTS.pyx:185-195;
    tree.py:961-1068). Returns a new Tree.

    The child's subtree is compacted to the front of the rows in visit
    order, with its statistics, priors and states; rows past it are
    pristine. Membership comes from pointer doubling over the parent links
    in ceil(log2 N) rounds (a node's row is always after its parent's).
    Where the edge was never expanded, the result is a fresh tree at the
    stepped state.
    """
    B, N = tree.parent.shape
    dev = tree.parent.device
    idx = torch.arange(N, device=dev)
    next_free = tree.next_free.long()[:, None]
    is_child = ((tree.parent[:, :-1] == ROOT)
                & (tree.parent_action[:, :-1] == action[:, None])
                & (idx[:-1] < next_free))
    exists = is_child.any(dim=1)
    safe_child = torch.where(is_child, idx[:-1], 0).sum(dim=1)

    # Subtree membership by ancestor jumping.
    member = idx == safe_child[:, None]
    anc = torch.where(idx == ROOT, ROOT, tree.parent.long())
    anc = torch.where(anc == UNVISITED, 0, anc)
    for _ in range(max(1, math.ceil(math.log2(max(N, 2))))):
        member = member | member.gather(1, anc)
        anc = anc.gather(1, anc)
    member = member & (idx < next_free)  # rows past next_free are junk

    # Compaction: members keep their relative order; the rest read the sink.
    new_pos = torch.where(member, member.long().cumsum(dim=1) - 1, N - 1)
    gather_idx = torch.full((B, N), N - 1, dtype=torch.long, device=dev)
    gather_idx.scatter_(1, new_pos, torch.where(member, idx, N - 1))
    count = member.sum(dim=1)
    live_row = idx < count[:, None]

    def take(buf):
        if buf.dim() == 2:
            return buf.gather(1, gather_idx)
        return buf.gather(1, gather_idx[:, :, None].expand(-1, -1,
                                                           buf.shape[2]))

    def live(x, fill):
        # Rows past the subtree are pristine: they would otherwise copy the
        # sink, whose links are junk a later allocation could follow.
        mask = live_row if x.dim() == 2 else live_row[:, :, None]
        return torch.where(mask, x, fill)

    old_parent = take(tree.parent).long()
    parent = torch.where(old_parent == UNVISITED, UNVISITED,
                         new_pos.gather(1, old_parent.clamp(min=0)))
    parent = live(parent.to(torch.int32), UNVISITED)
    parent[:, ROOT] = UNVISITED
    parent_action = live(take(tree.parent_action), UNVISITED)
    parent_action[:, ROOT] = UNVISITED
    edge_prior = live(take(tree.edge_prior), 0.0)
    edge_prior[:, ROOT] = 0.0
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    compacted = Tree(
        node_state={k: take(x) for k, x in tree.node_state.items()},
        state_shapes=tree.state_shapes,
        parent=parent,
        parent_action=parent_action,
        valids=live(take(tree.valids), False),
        prior=live(take(tree.prior), 0.0),
        n=live(take(tree.n), 0),
        q=live(take(tree.q), 0.0),
        v=live(take(tree.v), 0.0),
        e=live(take(tree.e), 0.0),
        player=live(take(tree.player), 0),
        edge_prior=edge_prior,
        expanded=live(take(tree.expanded), False),
        # Rank-walk pointers ride along: action ids do not change, and the
        # kept nodes keep all their children.
        nba=live(take(tree.nba), 0),
        nbp=live(take(tree.nbp), NBP_PRISTINE),
        next_free=count.to(torch.int32),
        depth=zeros,
        max_depth=zeros.clone(),
        leaf=zeros.clone(),
        num_actions=tree.num_actions,
        value_size=tree.value_size,
    )
    stepped = env.step(gather_states(env, tree, zeros), action)
    fresh = init_tree(env, stepped, N - 1, tree.value_size)
    return select_games(exists, compacted, fresh)
