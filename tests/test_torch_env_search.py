"""The port's fresh-tree search and self-play move runners on gobang,
othello, tictactoe and brandubh against the JAX package's, on the CPU
(``test_torch_envs.assert_search_matches_jax`` and
``assert_move_runners_match_jax``, as the chess, stratego and nim3 tests
call them):

* a fresh-tree search from random openings, both sides driven by one
  table evaluation: visit counts and tree links equal, q, v within 1e-6.
  The JAX oracles are the ``xla`` walk and the interpreted Pallas kernels,
  but for gobang the ``xla`` walk only: the JAX game-minor tree asserts
  flat node-state rows (JAX mcts/tree_t.py:101), which gobang's 2-D board
  is not — a limit of the reference, not of the port;
* warmup, full and fast moves through a converted small ResNet in float32
  with JAX's draws injected: actions, win states, states and observations
  equal, the policy records equal (densified where sparse: brandubh,
  A = 588).
"""

import pytest
import torch

from alphazero_general_tpu_torch.envs import get_env
from test_torch_envs import (
    assert_move_runners_match_jax, assert_search_matches_jax, random_items)

torch.set_num_threads(1)

#: (games, simulations, max plies of the openings, JAX walks) per env.
SEARCHES = {
    "gobang": (4, 12, 20, ("xla",)),
    "othello": (6, 14, 20, ("xla", "pallas_interpret")),
    "tictactoe": (8, 12, 4, ("xla", "pallas_interpret")),
    "brandubh": (4, 12, 10, ("xla", "pallas_interpret")),
}


@pytest.mark.parametrize("name", list(SEARCHES))
def test_search_matches_jax(name):
    batch, sims, plies, walks = SEARCHES[name]
    items = random_items(get_env(name), batch, seed=3, max_plies=plies)
    assert_search_matches_jax(name, batch, sims, items, walk_impls=walks,
                              min_discount=0.9)


@pytest.mark.parametrize("name", list(SEARCHES))
def test_move_runners_match_jax(name):
    assert_move_runners_match_jax(name, 4)
