"""Policy and value network — the port of
alphazero_general_tpu/models/architectures.py (reference:
alphazero/NNetArchitecture.py:36-162).

Same topology as the JAX ResNet: a 3x3 conv stem with BatchNorm and ReLU,
``depth`` pre-activation residual blocks, and 1x1-conv heads with ELU MLPs;
the value head is a softmax over num_players + has_draw.

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

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


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
    momentum 0.9 (torch's convention calls this 0.1).
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
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
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

    def __init__(self, channels: int):
        super().__init__()
        self.norm1 = Norm(channels)
        self.conv1 = Conv(channels, channels, 3)
        self.norm2 = Norm(channels)
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
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c, h, w = obs_shape
        self.dtype = dtype
        self.stem_conv = Conv(c, num_channels, 3)
        self.stem_norm = Norm(num_channels)
        self.blocks = nn.ModuleList(
            ResidualBlock(num_channels) for _ in range(depth))
        self.value_conv = Conv(num_channels, value_head_channels, 1)
        self.value_norm = Norm(value_head_channels)
        self.value_mlp = Mlp(value_head_channels * h * w, value_dense_layers,
                             value_size)
        self.policy_conv = Conv(num_channels, policy_head_channels, 1)
        self.policy_norm = Norm(policy_head_channels)
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


def build_model(env, args) -> nn.Module:
    """Model factory from args (NNetWrapper.py:111-117), in eval mode.
    Raises ValueError for the FC net and GroupNorm, not ported yet."""
    if args.get("nnet_type", "resnet") != "resnet":
        raise ValueError(f"nnet_type {args.nnet_type!r} is not ported yet")
    if args.get("norm", "batchnorm") != "batchnorm":
        raise ValueError(f"norm {args.norm!r} is not ported yet")
    # TF32 off for both convolutions and matrix products. The default
    # compute dtype, bfloat16, never uses TF32; float32 mode exists to match
    # the JAX reference, which computes float32 in full float32, while cuDNN
    # would run float32 convolutions in TF32 (about three decimal digits).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = (torch.bfloat16 if args.get("compute_dtype", "bfloat16")
             == "bfloat16" else torch.float32)
    model = ResNet(
        obs_shape=env.OBS_SHAPE,
        action_size=env.ACTION_SIZE,
        value_size=env.NUM_PLAYERS + int(env.HAS_DRAW),
        num_channels=args.num_channels,
        depth=args.depth,
        value_head_channels=args.value_head_channels,
        policy_head_channels=args.policy_head_channels,
        value_dense_layers=tuple(args.value_dense_layers),
        policy_dense_layers=tuple(args.policy_dense_layers),
        dtype=dtype,
    )
    return model.eval()
