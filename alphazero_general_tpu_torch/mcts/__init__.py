from alphazero_general_tpu_torch.mcts.tree import (  # noqa: F401
    NOISE_ALPHA_RATIO,
    SearchSpec,
    child_row,
    counts,
    next_best,
    probs,
)
from alphazero_general_tpu_torch.mcts.tree_t import TreeT, init_tree_t  # noqa: F401
from alphazero_general_tpu_torch.mcts import search as search_lib  # noqa: F401
from alphazero_general_tpu_torch.mcts.search import uniform_eval_fn  # noqa: F401
from alphazero_general_tpu_torch.mcts.search import search as run_search  # noqa: F401
