"""The port's search and self-play move runners on chess (A = 4672)
against the JAX package's, on the CPU; a file of its own because the JAX
side compiles the chess move generator into each search program (about a
minute each), so that the test runner can spread it over its workers.

* A fresh-tree search of 6 games from random openings, 10 simulations and
  a discount, both driven by one table evaluation: visit counts and tree
  links equal, q, v within 1e-6 (``test_torch_envs.assert_search_matches_jax``).
* A full and a fast move through a converted small ResNet in float32 with
  JAX's draws injected: actions and states equal, the sparse
  top-(sims + 1) policy records equal once densified
  (``test_torch_envs.assert_move_runners_match_jax``).
"""

import torch

from alphazero_general_tpu_torch.envs import get_env
from test_torch_envs import (
    assert_move_runners_match_jax, assert_search_matches_jax, random_items)

torch.set_num_threads(1)


def test_chess_search_matches_jax():
    items = random_items(get_env("chess"), 6, seed=7, max_plies=20)
    assert_search_matches_jax("chess", 6, 10, items, min_discount=0.8)


def test_chess_move_runners_match_jax():
    assert_move_runners_match_jax("chess", 3, kinds=("full", "fast"))
