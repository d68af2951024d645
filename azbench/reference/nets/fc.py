"""The fully connected network in plain float32 PyTorch (the upstream
project's ``NNetArchitecture.py`` flat variant, ``nnet_type="fc"``).

The observation flattened in (C, H, W) order, ``input_fc_layers`` dense
layers each followed by a ReLU, then two heads, each an ELU MLP
(``value_dense_layers``, ``policy_dense_layers``); log-softmax over the
actions and over the value's outcomes. No quantized tower: a
configuration of this network states a float self-play tower.

Weights: ``fc{j}`` the input layers, ``vmlp{j}`` and ``pmlp{j}`` the
heads' layers, each a ``.weight`` [out, in] and a ``.bias``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from azbench.reference.nets import fp8, in_blocks


def _sizes(cfg: dict) -> dict:
    """Layer sizes of the trunk and of each head, inputs first."""
    a = cfg["args"]
    trunk = [math.prod(cfg["obs_shape"]), *a["input_fc_layers"]]
    return {"fc": trunk,
            "vmlp": [trunk[-1], *a["value_dense_layers"], cfg["value_size"]],
            "pmlp": [trunk[-1], *a["policy_dense_layers"],
                     cfg["action_size"]]}


def layout(cfg: dict) -> list:
    """[(name, shape, kind)] of every weight: the trunk, then the value
    head, then the policy head."""
    out = []
    for part, sizes in _sizes(cfg).items():
        for j, (i, o) in enumerate(zip(sizes[:-1], sizes[1:])):
            out.append((f"{part}{j}.weight", (o, i), "dense"))
            out.append((f"{part}{j}.bias", (o,), "bias"))
    return out


def program_names(cfg: dict) -> dict:
    """Each weight's name -> the program's ``FullyConnected`` key."""
    module = {"fc": "input_layers", "vmlp": "value_mlp.layers",
              "pmlp": "policy_mlp.layers"}
    out = {}
    for name, _, _ in layout(cfg):
        layer, field = name.split(".")
        part = layer.rstrip("0123456789")
        out[name] = f"{module[part]}.{layer[len(part):]}.{field}"
    return out


def forward(W: dict, obs: torch.Tensor, cfg: dict, low: bool = False):
    """(log-policy [B, A], log-value [B, V]) in float32; ``low`` rounds
    every dense operand to float8 (``fp8``)."""
    q = fp8 if low else (lambda t: t)
    sizes = _sizes(cfg)

    def dense(x, layer):
        return F.linear(q(x), q(W[f"{layer}.weight"]), W[f"{layer}.bias"])

    x = obs.float().reshape(obs.shape[0], -1)
    for j in range(len(sizes["fc"]) - 1):
        x = F.relu(dense(x, f"fc{j}"))
    outs = []
    for head in ("vmlp", "pmlp"):
        y = x
        n = len(sizes[head]) - 1
        for j in range(n):
            y = dense(y, f"{head}{j}")
            if j < n - 1:
                y = F.elu(y)
        outs.append(F.log_softmax(y, dim=-1))
    log_v, log_p = outs
    return log_p, log_v


def evaluate(W: dict, obs: torch.Tensor, cfg: dict, tower_levels: int = 0,
             maxima=None, low: bool = False):
    """Policy and value probabilities of ``obs``, in blocks of rows."""
    if tower_levels:
        raise ValueError("the fc network has no quantized tower")
    return in_blocks(lambda rows: forward(W, rows, cfg, low=low), obs)


def ops(cfg: dict) -> dict:
    """Operations of one row: 2 per multiply-add of every dense layer.
    {"tower": the input layers, "other": both heads}."""
    out = {}
    for part, sizes in _sizes(cfg).items():
        out[part] = sum(2 * i * o for i, o in zip(sizes[:-1], sizes[1:]))
    return {"tower": out["fc"], "other": out["vmlp"] + out["pmlp"]}
