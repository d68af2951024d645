"""Tiny configurations of the benchmark's cells for the CPU tests: the
published game shapes and search constants, a network of a few channels,
a few games and simulations."""

from __future__ import annotations

import time

import torch

from azbench import registry
from azbench.common import Context

#: A tiny network of each ``nnet_type``: its args, and the precisions it
#: changes (a network without a quantized tower plays a float one).
TINY_NETS = {
    "resnet": {"args": dict(num_channels=8, depth=1, value_head_channels=2,
                            policy_head_channels=2, value_dense_layers=[16],
                            policy_dense_layers=[16])},
    "fc": {"args": dict(input_fc_layers=[32, 32, 32],
                        value_dense_layers=[16], policy_dense_layers=[16]),
           "precision": {"selfplay_tower": "bfloat16"}},
}


def context(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 0.0,
            control: bool = False, nnet_type: str = "resnet",
            **args) -> Context:
    """A CPU context of ``cell`` at tiny sizes with the tiny network of
    ``nnet_type`` (``args`` override more)."""
    w = registry.workload(cell)
    cfg = registry.config(w["config"])
    tr = registry.traffic(w["traffic"])
    cfg["args"].update(TINY_NETS[nnet_type]["args"], nnet_type=nnet_type)
    cfg["precision"].update(TINY_NETS[nnet_type].get("precision", {}))
    if tr["driver"] == "selfplay":
        cfg["args"].update(process_batch_size=4, numMCTSSims=8,
                           numFastSims=4)
        tr["check_games"] = 3
    elif tr["driver"] == "play":
        cfg["args"].update(numMCTSSims=12)
    cfg["args"].update(args)
    return Context(cell=w, cfg=cfg, traffic=tr, seed=seed, seconds=seconds,
                   trace=False, device=torch.device("cpu"), t0=time.time(),
                   control=control)


def run(ctx):
    """The cell's driver on ``ctx``; returns (result, correct by the
    cell's limits)."""
    res = registry.driver(ctx.traffic["driver"]).run(ctx)
    limits = registry.limits(ctx.cell["name"])
    correct = all(v <= limits[k] for k, v in res.checks.items()
                  if not k.startswith("control."))
    return res, correct
