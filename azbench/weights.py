"""The network's weights, made on the device from the seed in a few large
draws, in float32 (the type the program keeps its parameters in). The same
dict goes to the program and to the reference."""

from __future__ import annotations

import math

import torch

from azbench import registry


def make(cfg: dict, seed: int, device) -> dict:
    """Named float32 weights (the ``layout`` of the configuration's
    network, ``registry.network``): conv and dense weights normal with
    variance 1/fan-in, biases and BatchNorm shifts and running means normal
    at 0.1, BatchNorm scales 1 + 0.1·normal, running variances
    exp(0.2·normal)."""
    shapes = registry.network(cfg).layout(cfg)
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in shapes:
        n = math.prod(shape)
        x = z[at:at + n].view(shape)
        at += n
        if kind in ("conv", "dense"):
            x = x * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif kind == "bn.weight":
            x = 1.0 + 0.1 * x
        elif kind == "bn.var":
            x = torch.exp(0.2 * x)
        else:
            x = 0.1 * x
        out[name] = x.contiguous()
    return out
