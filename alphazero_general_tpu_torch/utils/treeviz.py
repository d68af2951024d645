"""Search-tree visualisation — the port of alphazero_general_tpu/utils/
treeviz.py (reference: utils.py:57-83 plot_mcts_tree).

Renders one game of a batch-major ``Tree`` (mcts/tree.py) as Graphviz DOT
text or as an indented console dump; producing the DOT needs no graphviz.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _snapshot(tree, game: int):
    """One game's arrays on the host, with the child pointers rebuilt from
    the parent links (the tree stores none; mcts/tree.py ``child_row``)."""
    def get(x):
        return x[game].cpu().numpy()

    rows = tree.parent.shape[1]
    A = tree.num_actions
    parent = get(tree.parent)
    parent_action = get(tree.parent_action)
    next_free = int(tree.next_free[game])
    children = np.full((rows, A), -1, np.int64)
    for c in range(min(rows - 1, next_free)):  # the sink and junk skipped
        p, a = int(parent[c]), int(parent_action[c])
        if p >= 0 and a >= 0:
            children[p, a] = c
    return {
        "children": children,
        "n": get(tree.n),
        "q": get(tree.q),
        "v": get(tree.v),
        # The stored row packs the valid mask as a -1 sentinel
        # (tree.INVALID_PRIOR); display the clean probabilities.
        "prior": np.maximum(get(tree.prior), 0.0),
        "next_free": next_free,
    }


def _kids(t, node: int):
    """(visits, action, child) of each child of ``node``, most visited
    first."""
    kids = [(int(t["n"][c]), a, int(c))
            for a, c in enumerate(t["children"][node]) if c >= 0]
    kids.sort(reverse=True)
    return kids


def tree_to_dot(tree, game: int = 0, max_depth: int = 3,
                max_children: int = 8) -> str:
    """DOT digraph of the most visited part of game ``game``'s tree."""
    t = _snapshot(tree, game)
    lines: List[str] = [
        "digraph mcts {",
        '  node [shape=box, fontname="monospace", fontsize=10];',
    ]

    def visit(node: int, depth: int) -> None:
        n, q, v = t["n"][node], t["q"][node], t["v"][node]
        lines.append(
            f'  n{node} [label="#{node}\\nn={n} q={q:.2f} v={v:.2f}"];')
        if depth >= max_depth:
            return
        for _, a, c in _kids(t, node)[:max_children]:
            p = t["prior"][node][a]
            lines.append(f'  n{node} -> n{c} [label="a={a} p={p:.2f}"];')
            visit(c, depth + 1)

    visit(0, 0)
    lines.append("}")
    return "\n".join(lines)


def tree_to_text(tree, game: int = 0, max_depth: int = 2,
                 max_children: int = 5) -> str:
    """Indented console dump of game ``game``'s tree."""
    t = _snapshot(tree, game)
    out: List[str] = []

    def visit(node: int, depth: int, prefix: str) -> None:
        out.append(f"{prefix}#{node} n={t['n'][node]} q={t['q'][node]:.3f} "
                   f"v={t['v'][node]:.3f}")
        if depth >= max_depth:
            return
        for _, a, c in _kids(t, node)[:max_children]:
            out.append(f"{prefix}  a={a} (p={t['prior'][node][a]:.2f}):")
            visit(c, depth + 1, prefix + "    ")

    visit(0, 0, "")
    return "\n".join(out)
