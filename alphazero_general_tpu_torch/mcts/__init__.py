from alphazero_general_tpu_torch.mcts.tree import (  # noqa: F401
    NOISE_ALPHA_RATIO,
    SearchSpec,
    Tree,
    best_action,
    child_row,
    counts,
    init_tree,
    next_best,
    probs,
    reroot,
    root_child_stats,
    root_value,
)
from alphazero_general_tpu_torch.mcts.tree_t import TreeT, init_tree_t  # noqa: F401
