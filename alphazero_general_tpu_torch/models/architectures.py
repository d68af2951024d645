"""Policy and value network — the port of
alphazero_general_tpu/models/architectures.py (reference:
alphazero/NNetArchitecture.py:36-162).

Same topology as the JAX ResNet: a 3x3 conv stem with BatchNorm and ReLU,
``depth`` pre-activation residual blocks, and 1x1-conv heads with ELU MLPs;
the value head is a softmax over num_players + has_draw. ``norm`` selects
BatchNorm or flax's GroupNorm, as in the JAX package. ``FullyConnected`` is
the JAX package's flat MLP variant (``nnet_type="fc"``).

Numerics follow the JAX package's ``compute_dtype``: parameters are float32,
each conv and dense layer runs in the compute dtype (bfloat16 by default),
BatchNorm normalises in float32 and rounds its output to the compute dtype
(as flax's ``_normalize`` does), and both log-softmaxes are float32.

Inference (a forward without autograd, as every search runs it) reuses
what depends on the parameters alone, each recomputed when a parameter or
statistic it reads changes (``_inference_cache``): the weights cast to the
compute dtype and each BatchNorm's float32 scale ``rsqrt(var + eps) *
weight``. That saves about a third of a forward's kernel launches and
computes the same values with the same operations.

Layout: activations are NCHW, PyTorch's habit. The JAX model flattens each
head in NHWC order, so the heads here flatten in (H, W, C) order too, which
keeps the converted dense weights as they are (utils/convert.py).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from alphazero_general_tpu_torch.parallel.mesh import global_moments, \
    world_size


def _inference_cache(module: nn.Module, name, sources, make):
    """``make()``, computed once and reused for as long as every tensor of
    ``sources`` is unchanged: the same version counter (bumped by every
    in-place write: an optimizer step, a checkpoint load, a statistics
    update) and the same storage. For forwards without autograd only: the
    cached tensors carry no gradient."""
    key = tuple((t._version, t.data_ptr()) for t in sources)
    hit = module.__dict__.get(name)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, make())
        module.__dict__[name] = hit
    return hit[1]


class Norm(nn.Module):
    """BatchNorm as flax's ``nn.BatchNorm`` computes it (epsilon 1e-5):
    ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32,
    rounded to the input's dtype.

    In eval mode mean and var are the running statistics. In training mode
    they are the batch's, over (N, H, W) in float32, with flax's variance
    ``E[x^2] - E[x]^2`` clipped at 0 (the biased one; ``nn.BatchNorm2d``
    updates its running variance with the unbiased one, so it is not used
    here), and the running statistics move by flax's momentum:
    ``running = momentum * running + (1 - momentum) * batch`` with
    momentum 0.9 (torch's convention calls this 0.1). Under a process
    group of more than one rank the training statistics are the global
    batch's (``parallel.global_moments``), as XLA's sharded BatchNorm takes
    them.
    """

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        xf = x.to(torch.float32)
        if self.training:
            if world_size() > 1:
                mean, sq = global_moments(xf, (0, 2, 3))
            else:
                mean, sq = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(
                    dim=(0, 2, 3))
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var)
        elif not torch.is_grad_enabled():
            mul = _inference_cache(
                self, "_scale", (self.running_var, self.weight),
                lambda: torch.rsqrt(self.running_var + self.eps)
                * self.weight)
            y = ((xf - self.running_mean.view(shape)) * mul.view(shape)
                 + self.bias.view(shape))
            return y.to(x.dtype)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm as flax's ``nn.GroupNorm`` computes it (flax 0.12, with
    the JAX package's ``group_size=min(16, C)``): per sample, over (H, W)
    and the channels of each group of ``group_size`` consecutive ones, the
    mean and ``E[x^2] - E[x]^2`` clipped at 0 in float32; then
    ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32 with
    epsilon 1e-6, rounded to the input's dtype. The same in training and
    in eval mode: it keeps no running statistics."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.group_size = min(16, channels)
        if channels % self.group_size:
            raise ValueError(f"GroupNorm: {channels} channels are not a "
                             f"multiple of the group size {self.group_size}")
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        xf = x.to(torch.float32)
        grouped = xf.reshape(b, c // self.group_size, -1)
        mean = grouped.mean(dim=-1)
        var = torch.clamp((grouped * grouped).mean(dim=-1) - mean * mean,
                          min=0.0)
        mean = mean.repeat_interleave(self.group_size, dim=1)
        mul = torch.rsqrt(var.repeat_interleave(self.group_size, dim=1)
                          + self.eps) * self.weight
        shape = (b, c) + (1,) * (x.dim() - 2)
        y = (xf - mean.view(shape)) * mul.view(shape) \
            + self.bias.view((1, c) + (1,) * (x.dim() - 2))
        return y.to(x.dtype)


def make_norm(kind: str, channels: int) -> nn.Module:
    """The normalisation of ``norm=kind``: "batchnorm" or "groupnorm"."""
    if kind == "batchnorm":
        return Norm(channels)
    if kind == "groupnorm":
        return GroupNorm(channels)
    raise ValueError(f"Unknown norm {kind!r}")


def _cast(module: nn.Module, name: str, dtype) -> torch.Tensor:
    """The parameter ``name`` of ``module`` in ``dtype``; without autograd,
    the cast made once per change of the parameter."""
    param = getattr(module, name)
    if torch.is_grad_enabled() or param.dtype == dtype:
        return param.to(dtype)
    return _inference_cache(module, f"_cast_{name}_{dtype}", (param,),
                            lambda: param.to(dtype))


class Conv(nn.Conv2d):
    """Bias-free 'SAME' convolution whose float32 weight is cast to the
    input's dtype for the product."""

    def __init__(self, c_in: int, c_out: int, kernel: int):
        super().__init__(c_in, c_out, kernel, padding=kernel // 2,
                         bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _cast(self, "weight", x.dtype), None)


class Dense(nn.Linear):
    """Linear layer whose float32 parameters are cast to the input's
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _cast(self, "weight", x.dtype),
                        _cast(self, "bias", x.dtype))


class ResidualBlock(nn.Module):
    """Pre-activation residual block (NNetArchitecture.py:36-66)."""

    def __init__(self, channels: int, norm: str = "batchnorm"):
        super().__init__()
        self.norm1 = make_norm(norm, channels)
        self.conv1 = Conv(channels, channels, 3)
        self.norm2 = make_norm(norm, channels)
        self.conv2 = Conv(channels, channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return out + x


class Mlp(nn.Module):
    """ELU MLP head (NNetArchitecture.py:20-32)."""

    def __init__(self, in_features: int, layer_sizes: Sequence[int],
                 output_size: int):
        super().__init__()
        sizes = [in_features, *layer_sizes, output_size]
        self.layers = nn.ModuleList(
            Dense(a, b) for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = F.elu(layer(x))
        return self.layers[-1](x)


class ResNet(nn.Module):
    """AlphaZero tower (NNetArchitecture.py:69-120).

    Input: observations [B, C, H, W] float32. Output: (log-policy [B, A],
    log-value [B, value_size]) in float32.
    """

    def __init__(self, obs_shape, action_size: int, value_size: int,
                 num_channels: int = 32, depth: int = 4,
                 value_head_channels: int = 16,
                 policy_head_channels: int = 16,
                 value_dense_layers: Sequence[int] = (512, 64),
                 policy_dense_layers: Sequence[int] = (512, 256),
                 norm: str = "batchnorm",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c, h, w = obs_shape
        self.dtype = dtype
        self.norm = norm
        self.stem_conv = Conv(c, num_channels, 3)
        self.stem_norm = make_norm(norm, num_channels)
        self.blocks = nn.ModuleList(
            ResidualBlock(num_channels, norm) for _ in range(depth))
        self.value_conv = Conv(num_channels, value_head_channels, 1)
        self.value_norm = make_norm(norm, value_head_channels)
        self.value_mlp = Mlp(value_head_channels * h * w, value_dense_layers,
                             value_size)
        self.policy_conv = Conv(num_channels, policy_head_channels, 1)
        self.policy_norm = make_norm(norm, policy_head_channels)
        self.policy_mlp = Mlp(policy_head_channels * h * w,
                              policy_dense_layers, action_size)

    @staticmethod
    def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, obs: torch.Tensor):
        x = obs.to(self.dtype)
        x = F.relu(self.stem_norm(self.stem_conv(x)))
        for block in self.blocks:
            x = block(x)
        v = self._flatten_hwc(self.value_norm(self.value_conv(x)))
        v = self.value_mlp(v)
        pi = self._flatten_hwc(self.policy_norm(self.policy_conv(x)))
        pi = self.policy_mlp(pi)
        return (F.log_softmax(pi.to(torch.float32), dim=-1),
                F.log_softmax(v.to(torch.float32), dim=-1))


class FullyConnected(nn.Module):
    """Flat MLP variant (NNetArchitecture.py:123-162): the whole
    observation flattened in (C, H, W) order (the reference sizes its input
    as ``sum(observation_size())``, C + H + W, a bug the JAX package fixes),
    ReLU dense layers, then the two ELU MLP heads."""

    def __init__(self, obs_shape, action_size: int, value_size: int,
                 input_fc_layers: Sequence[int] = (1024,) * 4,
                 value_dense_layers: Sequence[int] = (512, 64),
                 policy_dense_layers: Sequence[int] = (512, 256),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        sizes = [math.prod(obs_shape), *input_fc_layers]
        self.input_layers = nn.ModuleList(
            Dense(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.value_mlp = Mlp(sizes[-1], value_dense_layers, value_size)
        self.policy_mlp = Mlp(sizes[-1], policy_dense_layers, action_size)

    def forward(self, obs: torch.Tensor):
        x = obs.reshape(obs.shape[0], -1).to(self.dtype)
        for layer in self.input_layers:
            x = F.relu(layer(x))
        v = self.value_mlp(x)
        pi = self.policy_mlp(x)
        return (F.log_softmax(pi.to(torch.float32), dim=-1),
                F.log_softmax(v.to(torch.float32), dim=-1))


def build_model(env, args) -> nn.Module:
    """Model factory from args (NNetWrapper.py:111-117), in eval mode:
    the ResNet (``nnet_type="resnet"``, with ``norm`` "batchnorm" or
    "groupnorm") or the FC net (``"fc"``)."""
    # TF32 off for both convolutions and matrix products. The default
    # compute dtype, bfloat16, never uses TF32; float32 mode exists to match
    # the JAX reference, which computes float32 in full float32, while cuDNN
    # would run float32 convolutions in TF32 (about three decimal digits).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = (torch.bfloat16 if args.get("compute_dtype", "bfloat16")
             == "bfloat16" else torch.float32)
    value_size = env.NUM_PLAYERS + int(env.HAS_DRAW)
    kind = args.get("nnet_type", "resnet")
    if kind == "resnet":
        model = ResNet(
            obs_shape=env.OBS_SHAPE,
            action_size=env.ACTION_SIZE,
            value_size=value_size,
            num_channels=args.num_channels,
            depth=args.depth,
            value_head_channels=args.value_head_channels,
            policy_head_channels=args.policy_head_channels,
            value_dense_layers=tuple(args.value_dense_layers),
            policy_dense_layers=tuple(args.policy_dense_layers),
            norm=args.get("norm", "batchnorm"),
            dtype=dtype,
        )
    elif kind == "fc":
        model = FullyConnected(
            obs_shape=env.OBS_SHAPE,
            action_size=env.ACTION_SIZE,
            value_size=value_size,
            input_fc_layers=tuple(args.input_fc_layers),
            value_dense_layers=tuple(args.value_dense_layers),
            policy_dense_layers=tuple(args.policy_dense_layers),
            dtype=dtype,
        )
    else:
        raise ValueError(f"Unknown nnet_type {kind!r}")
    return model.eval()
