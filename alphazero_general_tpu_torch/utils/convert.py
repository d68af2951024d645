"""Convert the JAX package's flax variables into the port's ``state_dict``.

Input: ``{"params": ..., "batch_stats": ...}`` as nested dicts of arrays
(``NNetWrapper.state.variables``), or a whole ``NetState`` (its params and
batch stats; e.g. after training), from the JAX ResNet
(alphazero_general_tpu/models/architectures.py). Leaves may be numpy or
any array ``np.asarray`` takes. Output: a ``state_dict`` for the port's
ResNet (models/architectures.py).

* Convolution kernels go from HWIO to OIHW.
* Dense kernels go from ``[in, out]`` to ``[out, in]``. The JAX heads
  flatten NHWC activations, i.e. in (H, W, C) order; the port's heads
  flatten in that same order, so the first dense weight needs no permutation.
* BatchNorm ``scale``/``bias``/``mean``/``var`` become ``weight``/``bias``/
  ``running_mean``/``running_var`` (both sides use epsilon 1e-5).

flax names submodules by creation order: ``Conv_0``/``Norm_0`` is the stem,
``Conv_1``/``Norm_1``/``Mlp_0`` the value head (built first), and
``Conv_2``/``Norm_2``/``Mlp_1`` the policy head.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _conv(kernel) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))))


def _dense(kernel) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel, np.float32).T))


def _vec(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _norm(out: Dict[str, torch.Tensor], prefix: str, params, stats) -> None:
    bn_p, bn_s = params["BatchNorm_0"], stats["BatchNorm_0"]
    out[prefix + ".weight"] = _vec(bn_p["scale"])
    out[prefix + ".bias"] = _vec(bn_p["bias"])
    out[prefix + ".running_mean"] = _vec(bn_s["mean"])
    out[prefix + ".running_var"] = _vec(bn_s["var"])


def _mlp(out: Dict[str, torch.Tensor], prefix: str, params) -> None:
    for j in range(len(params)):
        dense = params[f"Dense_{j}"]
        out[f"{prefix}.layers.{j}.weight"] = _dense(dense["kernel"])
        out[f"{prefix}.layers.{j}.bias"] = _vec(dense["bias"])


def resnet_state_dict(variables) -> Dict[str, torch.Tensor]:
    """flax ResNet variables, or a ``NetState``, → the port's ResNet
    ``state_dict``."""
    if not isinstance(variables, dict):
        variables = {"params": variables.params,
                     "batch_stats": variables.batch_stats}
    p, s = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    out["stem_conv.weight"] = _conv(p["Conv_0"]["kernel"])
    _norm(out, "stem_norm", p["Norm_0"], s["Norm_0"])
    depth = sum(1 for k in p if k.startswith("ResidualBlock_"))
    for i in range(depth):
        bp, bs = p[f"ResidualBlock_{i}"], s[f"ResidualBlock_{i}"]
        _norm(out, f"blocks.{i}.norm1", bp["Norm_0"], bs["Norm_0"])
        out[f"blocks.{i}.conv1.weight"] = _conv(bp["Conv_0"]["kernel"])
        _norm(out, f"blocks.{i}.norm2", bp["Norm_1"], bs["Norm_1"])
        out[f"blocks.{i}.conv2.weight"] = _conv(bp["Conv_1"]["kernel"])
    out["value_conv.weight"] = _conv(p["Conv_1"]["kernel"])
    _norm(out, "value_norm", p["Norm_1"], s["Norm_1"])
    _mlp(out, "value_mlp", p["Mlp_0"])
    out["policy_conv.weight"] = _conv(p["Conv_2"]["kernel"])
    _norm(out, "policy_norm", p["Norm_2"], s["Norm_2"])
    _mlp(out, "policy_mlp", p["Mlp_1"])
    return out
