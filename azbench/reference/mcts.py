"""The AlphaZero search of one game, node by node, in NumPy float32 (the
upstream project's ``MCTS.pyx``, as the configuration's ``args`` set it).

Each simulation walks from the root: at a node of n visits, each child c
scores q_c + cpuct·P_c·sqrt(n) / (1 + n_c); the best valid action not yet
expanded (highest prior, then lowest index) scores fpu + cpuct·P·sqrt(n),
where fpu is the node's first value less fpu_reduction·sqrt(the priors of
its children summed in the order they were made). The best child wins only
if it scores strictly more, and the walk goes on into it unless it is
terminal or unvisited; otherwise the walk expands the action. The leaf's
value (the network's, or a terminal leaf's result) is backed up: each node
on the path adds the value of the player who moved into it, the draw's
share split among the players, to its running mean q, and takes the
value of its own player as its first value v.

A node's prior is the policy masked to the valid actions and renormalised
(uniform over them if the mask takes every mass), plus ``tie_noise`` times
a uniform draw per action. At the root of the first simulation the prior
is first raised to 1/root_policy_temp and renormalised, then mixed with the
Dirichlet noise of the given Gamma draws at ``root_noise_frac``.

Random draws are given, never drawn: ``tie`` [sims, A] and ``gammas`` [A].
The network is a callback, so that a replay can take the program's
outputs where its leaf agrees with the reference's and evaluate the
reference network where it does not.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np

F32 = np.float32
NEG_INF = F32(-3.0e38)
#: Scores within this many float32 units in the last place (of the larger
#: of the top score's magnitude and 1) are a tie to rounding: the
#: reference's float32 sums may round apart from the program's. The tie
#: noise separates scores by far more (PERF.md gives the readings).
TIE_ULPS = 8
#: How far (in the same units) a walk that missed the program's leaf looks
#: for the one flip that would have hit it, to report the gap.
LOOK_ULPS = 1 << 16
ULP = float(np.spacing(F32(1)))


def gap_ulps(score, top) -> float:
    """The gap between two scores in units in the last place of the
    larger of ``top``'s magnitude and 1."""
    return abs(float(score) - float(top)) / (ULP * max(1.0, abs(float(top))))


class Node:
    __slots__ = ("state", "player", "e", "terminal", "prior", "order", "ptr",
                 "children", "action", "n", "q", "v", "edge_prior",
                 "parent")

    def __init__(self, env, state, parent=None, action=-1,
                 edge_prior=F32(0)):
        self.state = state
        self.player = int(state["player"])
        self.e = env.win(state).astype(F32)
        self.terminal = bool((self.e > 0).any())
        self.prior = None
        self.order: List[int] = []
        self.ptr = 0
        self.children: List["Node"] = []
        self.action = action
        self.n = 0
        self.q = F32(0)
        self.v = F32(0)
        self.edge_prior = F32(edge_prior)
        self.parent = parent


def install(node: Node, pi: np.ndarray, valid: np.ndarray, spec: dict,
            tie: np.ndarray, gammas: Optional[np.ndarray] = None) -> None:
    """The node's prior row from the policy ``pi`` (see the module)."""
    pi = pi.astype(F32)
    masked = np.where(valid, pi, F32(0)).astype(F32)
    norm = masked.sum(dtype=F32)
    nvalid = max(int(valid.sum()), 1)
    if norm > 0:
        p = (masked / norm).astype(F32)
    else:
        p = (valid.astype(F32) / F32(nvalid)).astype(F32)
    if gammas is not None:
        if spec["add_root_temp"]:
            t = np.where(valid, np.power(p, F32(1.0 / spec["root_policy_temp"]
                                                )), F32(0)).astype(F32)
            p = (t / max(t.sum(dtype=F32), F32(1e-30))).astype(F32)
        if spec["add_root_noise"]:
            g = np.where(valid, gammas.astype(F32), F32(0)).astype(F32)
            noise = (g / max(g.sum(dtype=F32), F32(1e-30))).astype(F32)
            frac = spec["root_noise_frac"]
            p = (p * F32(1 - frac) + F32(frac) * noise).astype(F32)
            p = np.where(valid, p, F32(0)).astype(F32)
    if spec["tie_noise"]:
        p = np.where(valid, p + tie.astype(F32) * F32(spec["tie_noise"]),
                     p).astype(F32)
    node.prior = np.where(valid, p, F32(-1)).astype(F32)
    acts = np.flatnonzero(valid)
    node.order = sorted(acts.tolist(), key=lambda a: (-float(p[a]), a))
    node.ptr = 0


class Search:
    """One game's search tree, simulation by simulation."""

    def __init__(self, env, root_state: dict, spec: dict):
        self.env = env
        self.spec = spec
        self.root = Node(env, root_state)
        self.max_depth = 0
        self.cpuct = F32(spec["cpuct"])
        self.fpu_red = F32(spec["fpu_reduction"])
        self.log_md = F32(math.log(F32(max(spec["min_discount"], 1e-9))))
        self.followed: List[float] = []
        self.missed: List[float] = []

    def _choices(self, node):
        """(the walk's choice at ``node``, [(gap in ulps, choice)] of the
        other choices that score within ``LOOK_ULPS`` of it). A choice is
        ("child", child) or ("new", action, its prior)."""
        sqrt_n = np.sqrt(F32(node.n))
        seen = F32(0)
        best_c, c_star = NEG_INF, None
        scored = []
        for c in node.children:
            seen = F32(seen + c.edge_prior)
            score = F32(c.q + F32(F32(self.cpuct * c.edge_prior) * sqrt_n)
                        / F32(F32(1) + F32(c.n)))
            scored.append((score, ("child", c)))
            if score > best_c:
                best_c, c_star = score, c
        fpu = F32(node.v - self.fpu_red * np.sqrt(max(seen, F32(0))))
        if node.ptr < len(node.order):
            a_u = node.order[node.ptr]
            pv = node.prior[a_u]
            best_u = F32(fpu + F32(self.cpuct * pv) * sqrt_n)
            scored.append((best_u, ("new", a_u, pv)))
        else:
            a_u, pv, best_u = -1, NEG_INF, NEG_INF
        choice = ("child", c_star) if best_c > best_u else ("new", a_u, pv)
        top = max(best_c, best_u)
        look = LOOK_ULPS * ULP * max(1.0, abs(float(top)))
        near = [(gap_ulps(sc, top), ch) for sc, ch in scored
                if ch[1] is not choice[1] and abs(float(sc - top)) <= look]
        return choice, near

    def _plan(self, flip_depth: int = 0, flip=None):
        """The walk from the root as (the node it ends at or the parent of
        its new edge, the choice there, its depth, the near choices on its
        way), without changing the tree; at ``flip_depth`` it takes
        ``flip`` instead of its own choice."""
        node, depth, near = self.root, 0, []
        while True:
            depth += 1
            choice, alts = self._choices(node)
            if depth == flip_depth:
                choice = flip
            near.append(alts)
            if choice[0] == "child":
                child = choice[1]
                if child.terminal or child.n == 0:
                    return child, choice, depth, near
                node = child
                continue
            return node, choice, depth, near

    def _leaf_obs(self, plan):
        node, choice = plan[0], plan[1]
        if choice[0] == "child":
            return None  # an existing leaf: the program's input is junk
        return self.env.obs(self.env.step(node.state, choice[1]))

    def walk(self, target=None):
        """The leaf of the next simulation: (node, is_new). A new node is
        made (its state stepped) but has no prior yet. Where the program's
        leaf observation ``target`` is given and this walk does not reach
        it, the choice at one node that scored within ``TIE_ULPS`` of the
        walk's own and reaches it is taken instead (the closest such): the
        two computations of a score round apart, so at such a near tie
        either is the search's. The gap of each tie followed goes to
        ``followed``; where none was close enough, the gap of the closest
        flip that would have reached it (within ``LOOK_ULPS``, else inf)
        goes to ``missed``."""
        root = self.root
        if root.n == 0 or root.terminal:
            return root, root.n == 0
        plan = self._plan()
        if target is not None:
            got = self._leaf_obs(plan)
            if got is not None and not np.array_equal(got, target):
                best = None
                for d, alts in enumerate(plan[3], 1):
                    for gap, alt in alts:
                        if best is not None and gap >= best[0]:
                            continue
                        p = self._plan(d, alt)
                        o = self._leaf_obs(p)
                        if o is not None and np.array_equal(o, target):
                            best = (gap, p)
                if best is not None and best[0] <= TIE_ULPS:
                    self.followed.append(best[0])
                    plan = best[1]
                else:
                    self.missed.append(math.inf if best is None
                                       else best[0])
        node, choice, depth = plan[:3]
        self.max_depth = max(self.max_depth, depth)
        if choice[0] == "child":
            return node, False
        a_u, pv = choice[1], choice[2]
        node.ptr += 1
        child = Node(self.env, self.env.step(node.state, a_u), node, a_u, pv)
        node.children.append(child)
        return child, True

    def backup(self, leaf: Node, value: np.ndarray) -> None:
        value = value.astype(F32)
        if leaf.terminal:
            value = leaf.e
        V = value.shape[0]
        share = F32(value[V - 1] / F32(self.env.num_players))

        def value_at(p):
            return F32(value[p] + share) if self.env.has_draw \
                else F32(value[p])

        maxd = F32(max(self.max_depth, 1))
        node, i = leaf, 0
        while node.parent is not None:
            val = value_at(node.parent.player)
            disc = np.exp(F32(F32(i) / maxd) * self.log_md).astype(F32)
            if val < F32(0.5):
                disc = F32(F32(2) - disc)
            elif val == F32(0.5):
                disc = F32(1)
            nf = F32(node.n)
            node.q = F32(F32(node.q * nf + val * disc) / F32(nf + F32(1)))
            if node.n == 0:
                node.v = value_at(node.player)
            node.n += 1
            node = node.parent
            i += 1
        if node.n == 0:
            node.v = value_at(node.player)
        node.n += 1

    def visits(self) -> np.ndarray:
        out = np.zeros(self.env.action_size, np.int64)
        for c in self.root.children:
            out[c.action] = c.n
        return out


def replay(env, roots: list, spec: dict, sims: int, tie: np.ndarray,
           gammas: np.ndarray, program_obs: Callable, program_eval: Callable,
           reference_eval: Callable) -> dict:
    """The searches of games ``roots`` (states), in lockstep by
    simulation. Simulation k of game g takes the draws ``tie[g, k]`` (and
    ``gammas[g]`` at the root). Where its new leaf's observation equals
    ``program_obs(k, g)``, the leaf is evaluated by ``program_eval(k, g)``
    (the program's network output there, which the network check judges
    on its own); else, and counted as a leaf mismatch, by the reference
    network ``reference_eval(obs [n, ...]) -> (pi [n, A], v [n, V])``.

    Returns the root visit counts [G, A], the leaf mismatches, and the
    gaps (in ulps) of the near ties followed and of the closest flips that
    were not (``Search.walk``)."""
    searches = [Search(env, s, spec) for s in roots]
    mismatches = 0
    for k in range(sims):
        leaves, ref_rows = [], []
        for g, s in enumerate(searches):
            node, new = s.walk(program_obs(k, g))
            if not new or node.terminal:
                leaves.append((node, None))
                continue
            obs = env.obs(node.state)
            if np.array_equal(obs, program_obs(k, g)):
                leaves.append((node, program_eval(k, g)))
            else:
                mismatches += 1
                leaves.append((node, len(ref_rows)))
                ref_rows.append(obs)
        if ref_rows:
            ref_pi, ref_v = reference_eval(np.stack(ref_rows))
        for g, (s, (node, got)) in enumerate(zip(searches, leaves)):
            if isinstance(got, int):
                got = (ref_pi[got], ref_v[got])
            if got is None:
                s.backup(node, node.e)
                continue
            pi, value = got
            install(node, pi, env.valid(node.state), spec, tie[g, k],
                    gammas[g] if node is s.root else None)
            s.backup(node, value)
    return {"visits": np.stack([s.visits() for s in searches]),
            "leaf_mismatch": mismatches,
            "followed": [x for s in searches for x in s.followed],
            "missed": [x for s in searches for x in s.missed]}
