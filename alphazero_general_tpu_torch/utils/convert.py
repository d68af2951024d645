"""Convert the JAX package's flax variables into the port's ``state_dict``,
and its int8 ``QuantResNet`` into the port's module.

Input: ``{"params": ..., "batch_stats": ...}`` as nested dicts of arrays
(``NNetWrapper.state.variables``), or a whole ``NetState`` (its params and
batch stats; e.g. after training), from the JAX ResNet (BatchNorm or
GroupNorm) or FC net (alphazero_general_tpu/models/architectures.py).
Leaves may be numpy or any array ``np.asarray`` takes. Output: a
``state_dict`` for the port's model (models/architectures.py).

* Convolution kernels go from HWIO to OIHW.
* Dense kernels go from ``[in, out]`` to ``[out, in]``. The JAX heads
  flatten NHWC activations, i.e. in (H, W, C) order; the port's heads
  flatten in that same order, so the first dense weight needs no permutation.
* BatchNorm ``scale``/``bias``/``mean``/``var`` become ``weight``/``bias``/
  ``running_mean``/``running_var`` (both sides use epsilon 1e-5);
  GroupNorm ``scale``/``bias`` become ``weight``/``bias`` (no statistics).

flax names submodules by creation order: ``Conv_0``/``Norm_0`` is the stem,
``Conv_1``/``Norm_1``/``Mlp_0`` the value head (built first), and
``Conv_2``/``Norm_2``/``Mlp_1`` the policy head. In the FC net
``Dense_i`` are the input layers, ``Mlp_0`` the value head and ``Mlp_1``
the policy head.
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
    if "GroupNorm_0" in params:
        out[prefix + ".weight"] = _vec(params["GroupNorm_0"]["scale"])
        out[prefix + ".bias"] = _vec(params["GroupNorm_0"]["bias"])
        return
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


def _variables(variables):
    if not isinstance(variables, dict):
        variables = {"params": variables.params,
                     "batch_stats": variables.batch_stats}
    return variables["params"], variables.get("batch_stats") or {}


def state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax variables, or a ``NetState``, of either architecture → the
    port's ``state_dict`` (the ResNet has ``Conv_0``, the FC net not)."""
    if "Conv_0" in _variables(variables)[0]:
        return resnet_state_dict(variables)
    return fc_state_dict(variables)


def fc_state_dict(variables) -> Dict[str, torch.Tensor]:
    """flax FC-net variables, or a ``NetState``, → the port's
    ``FullyConnected`` ``state_dict``."""
    p = _variables(variables)[0]
    out: Dict[str, torch.Tensor] = {}
    for j in range(sum(1 for k in p if k.startswith("Dense_"))):
        out[f"input_layers.{j}.weight"] = _dense(p[f"Dense_{j}"]["kernel"])
        out[f"input_layers.{j}.bias"] = _vec(p[f"Dense_{j}"]["bias"])
    _mlp(out, "value_mlp", p["Mlp_0"])
    _mlp(out, "policy_mlp", p["Mlp_1"])
    return out


def resnet_state_dict(variables) -> Dict[str, torch.Tensor]:
    """flax ResNet variables, or a ``NetState``, → the port's ResNet
    ``state_dict``."""
    p, s = _variables(variables)
    out: Dict[str, torch.Tensor] = {}
    out["stem_conv.weight"] = _conv(p["Conv_0"]["kernel"])
    _norm(out, "stem_norm", p["Norm_0"], s.get("Norm_0"))
    depth = sum(1 for k in p if k.startswith("ResidualBlock_"))
    for i in range(depth):
        bp, bs = p[f"ResidualBlock_{i}"], s.get(f"ResidualBlock_{i}", {})
        _norm(out, f"blocks.{i}.norm1", bp["Norm_0"], bs.get("Norm_0"))
        out[f"blocks.{i}.conv1.weight"] = _conv(bp["Conv_0"]["kernel"])
        _norm(out, f"blocks.{i}.norm2", bp["Norm_1"], bs.get("Norm_1"))
        out[f"blocks.{i}.conv2.weight"] = _conv(bp["Conv_1"]["kernel"])
    out["value_conv.weight"] = _conv(p["Conv_1"]["kernel"])
    _norm(out, "value_norm", p["Norm_1"], s.get("Norm_1"))
    _mlp(out, "value_mlp", p["Mlp_0"])
    out["policy_conv.weight"] = _conv(p["Conv_2"]["kernel"])
    _norm(out, "policy_norm", p["Norm_2"], s.get("Norm_2"))
    _mlp(out, "policy_mlp", p["Mlp_1"])
    return out


def _tensor(x) -> torch.Tensor:
    """A numpy (or JAX) leaf as a tensor of its dtype; bfloat16, which
    numpy lacks, through float32 (exact)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def quant_params_from_jax(qp) -> dict:
    """A JAX ``QuantResNet`` (models/quant.py; numpy leaves) as the dict
    of ``quant_params`` (models/quant.py of the port): the same fields and
    layouts."""
    out = {k: _tensor(getattr(qp, k)) for k in (
        "stem_w", "stem_s", "stem_b", "vh_w", "vh_s", "vh_b", "ph_w",
        "ph_s", "ph_b")}
    out["blocks"] = [{k: _tensor(getattr(b, k)) for k in (
        "s1", "b1", "w1", "s2", "b2", "w2", "d2")} for b in qp.blocks]
    for head in ("v_dense", "p_dense"):
        out[head] = [(_tensor(k), _tensor(b)) for k, b in getattr(qp, head)]
    return out


def quant_from_jax(qp):
    """A JAX ``QuantResNet`` → the port's int8 ``QuantResNet`` module (on
    the CPU; ``.to(device)`` moves it)."""
    from alphazero_general_tpu_torch.models.quant import QuantResNet

    return QuantResNet(quant_params_from_jax(qp))
