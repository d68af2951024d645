"""Network lifecycle, inference half — the port of
alphazero_general_tpu/models/wrapper.py (build, ``process``,
``make_eval_fn`` :178-200; reference: alphazero/NNetWrapper.py:86-282).

Training, the optimizer and checkpoints arrive with the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from alphazero_general_tpu_torch.models.architectures import build_model
from alphazero_general_tpu_torch.utils.config import Args
from alphazero_general_tpu_torch.utils.convert import resnet_state_dict


class NNetWrapper:
    """Holds one network in eval mode on ``device``."""

    def __init__(self, env, args: Args, device="cuda"):
        self.env = env
        self.args = args
        self.device = torch.device(device)
        self.value_size = env.NUM_PLAYERS + int(env.HAS_DRAW)
        # Random initial weights made from args.seed, without touching the
        # process-wide generator.
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(args.get("seed", 0)))
            model = build_model(env, args)
        self.model = model.to(self.device)

    def load_jax_variables(self, variables) -> None:
        """Load flax ``{"params", "batch_stats"}`` (numpy leaves) converted
        by utils/convert.py."""
        self.model.load_state_dict(resnet_state_dict(variables))

    @torch.inference_mode()
    def process(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched eval → (policy probs [B, A], value probs [B, V])
        (NNetWrapper.py:225-232)."""
        logp, logv = self.model(obs)
        return torch.exp(logp), torch.exp(logv)

    def make_eval_fn(self):
        """EvalFn over the current weights, for the search."""
        return self.process
