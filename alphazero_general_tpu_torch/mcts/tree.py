"""Search constants and root statistics — the parts of the JAX package's
``mcts/tree.py`` that the game-minor search uses (SearchSpec :74, the
sentinels :55-71, ``_next_best`` :503, ``child_row`` / ``counts`` / ``probs``
:348-1105).

The port keeps one tree layout, the game-minor ``TreeT`` of ``tree_t.py``
(the JAX package's batch-major ``Tree`` exists there only to be converted);
``init_tree`` lives there. Every function here takes the game batch on the
LAST axis of tree columns ([N, B]) and on the FIRST axis of per-game rows
([B, A]), as the JAX TreeT path does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

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


def counts(tt) -> torch.Tensor:
    """i32[B, A] root child visit counts of a TreeT."""
    root = torch.zeros_like(tt.leaf)
    return child_row(tt.parent, tt.parent_action, tt.n, tt.q, root,
                     tt.num_actions)[1]


def _renorm(p: torch.Tensor) -> torch.Tensor:
    return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


def probs(visit_counts: torch.Tensor, temp) -> torch.Tensor:
    """Visit-count policy [B, A] with per-game temperature ``temp`` (a float
    or f32[B]); temperature 0 gives the argmax one-hot (MCTS.pyx:308-327).
    Computed in log space so a large 1/temp cannot overflow."""
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
