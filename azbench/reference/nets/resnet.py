"""The AlphaZero ResNet in plain float32 PyTorch, with the quantized
tower.

The network (the upstream project's ``NNetArchitecture.py``): a 3x3 conv
stem with BatchNorm and ReLU; ``depth`` pre-activation residual blocks
(BatchNorm, ReLU, 3x3 conv, twice, plus the block's input); two heads, each
a 1x1 conv with BatchNorm, flattened in (H, W, C) order, then an ELU MLP;
log-softmax over the actions and over the value's outcomes (the players'
wins and the draw). BatchNorm has epsilon 1e-5 and its running
statistics.

The weights are a dict of named float32 tensors (``layout``); the benchmark
makes them and hands the same to the program, under the program's
``ResNet`` names (``program_names``).

The quantized tower (``tower_levels``): each residual conv's input is
quantized per tensor to the integers 0..L (its scale the largest value the
input takes on the calibration set, over L), each conv weight per output
channel to -L..L (its scale the largest magnitude over L), the product
summed exactly, and dequantized. L = 127 is int8; L = 7 is int4, the
control of an int8 configuration.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from azbench.reference.nets import fp8, full_float32, in_blocks

EPS = 1e-5
BN_FIELDS = ("weight", "bias", "mean", "var")


def layout(cfg: dict) -> list:
    """[(name, shape, kind)] of every weight, kind one of "conv", "dense",
    "bias", "bn.weight", "bn.bias", "bn.mean", "bn.var"."""
    a = cfg["args"]
    c_in, h, w = cfg["obs_shape"]
    ch = a["num_channels"]
    out = [("stem.conv", (ch, c_in, 3, 3), "conv")]

    def bn(prefix, n):
        return [(f"{prefix}.{f}", (n,), f"bn.{f}") for f in BN_FIELDS]

    out += bn("stem.bn", ch)
    for i in range(a["depth"]):
        for j in (1, 2):
            out += bn(f"block{i}.bn{j}", ch)
            out.append((f"block{i}.conv{j}", (ch, ch, 3, 3), "conv"))
    for head, hc, dense, n_out in (
            ("v", a["value_head_channels"], a["value_dense_layers"],
             cfg["value_size"]),
            ("p", a["policy_head_channels"], a["policy_dense_layers"],
             cfg["action_size"])):
        out.append((f"{head}head.conv", (hc, ch, 1, 1), "conv"))
        out += bn(f"{head}head.bn", hc)
        sizes = [hc * h * w, *dense, n_out]
        for j, (i, o) in enumerate(zip(sizes[:-1], sizes[1:])):
            out.append((f"{head}mlp{j}.weight", (o, i), "dense"))
            out.append((f"{head}mlp{j}.bias", (o,), "bias"))
    return out


def program_names(cfg: dict) -> dict:
    """Each weight's name -> the program's ``ResNet`` state-dict key."""
    bn = {"weight": "weight", "bias": "bias", "mean": "running_mean",
          "var": "running_var"}
    heads = {"v": "value", "p": "policy"}
    out = {}
    for name, _, _ in layout(cfg):
        parts = name.split(".")
        if parts[0] == "stem":
            key = "stem_conv.weight" if parts[1] == "conv" \
                else f"stem_norm.{bn[parts[2]]}"
        elif parts[0].startswith("block"):
            i = parts[0][5:]
            kind, j = parts[1][:-1], parts[1][-1]
            key = (f"blocks.{i}.conv{j}.weight" if kind == "conv"
                   else f"blocks.{i}.norm{j}.{bn[parts[2]]}")
        elif parts[0] in ("vhead", "phead"):
            head = heads[parts[0][0]]
            key = f"{head}_conv.weight" if parts[1] == "conv" \
                else f"{head}_norm.{bn[parts[2]]}"
        else:
            key = f"{heads[parts[0][0]]}_mlp.layers.{parts[0][4:]}.{parts[1]}"
        out[name] = key
    return out


def ops(cfg: dict) -> dict:
    """Operations of one row (one observation): 2 per multiply-add of
    every conv and dense layer. {"tower": the 3x3 convs of the residual
    blocks, "other": the stem, the 1x1 head convs and both MLPs}."""
    a = cfg["args"]
    c_in, h, w = cfg["obs_shape"]
    hw = h * w
    ch = a["num_channels"]
    tower = 2 * a["depth"] * 2 * hw * 9 * ch * ch
    stem = 2 * hw * 9 * c_in * ch
    heads = 0
    for head_ch, dense, out in (
            (a["value_head_channels"], a["value_dense_layers"],
             cfg["value_size"]),
            (a["policy_head_channels"], a["policy_dense_layers"],
             cfg["action_size"])):
        heads += 2 * hw * ch * head_ch
        sizes = [head_ch * hw, *dense, out]
        heads += sum(2 * i * o for i, o in zip(sizes[:-1], sizes[1:]))
    return {"tower": tower, "other": stem + heads}


def _bn(x, W, prefix):
    mean, var = W[f"{prefix}.mean"], W[f"{prefix}.var"]
    scale = torch.rsqrt(var + EPS) * W[f"{prefix}.weight"]
    return (x - mean[:, None, None]) * scale[:, None, None] \
        + W[f"{prefix}.bias"][:, None, None]


def _quant_conv(x, w, levels: int, amax) -> torch.Tensor:
    """A 3x3 'SAME' conv of a ReLU'd input through the quantized tower:
    input to 0..levels at scale amax / levels, weight per output channel to
    -levels..levels, the integer product summed exactly (float64), then
    dequantized to float32."""
    a = torch.clamp(amax, min=1e-6).double()
    q = torch.clamp(torch.round(x.double() * (levels / a)), 0, levels)
    ws = torch.clamp(w.double().abs().amax(dim=(1, 2, 3)) / levels,
                     min=1e-12)
    wq = torch.clamp(torch.round(w.double() / ws[:, None, None, None]),
                     -levels, levels)
    acc = F.conv2d(q, wq, padding=1)
    return (acc * (ws * (a / levels))[None, :, None, None]).float()


def forward(W: dict, obs: torch.Tensor, cfg: dict, tower_levels: int = 0, maxima=None, low: bool = False,
            _maxima_out: list = None):
    """(log-policy [B, A], log-value [B, V]) in float32. ``tower_levels``
    with ``maxima`` (the 2·depth calibration maxima) runs the quantized
    tower; ``low`` rounds every conv and dense operand to float8
    (``fp8``);
    ``_maxima_out`` collects the largest input of each tower conv."""
    depth = cfg["args"]["depth"]
    q = fp8 if low else (lambda t: t)

    def conv(x, w, pad):
        return F.conv2d(q(x), q(w), padding=pad)

    x = obs.float()
    x = F.relu(_bn(conv(x, W["stem.conv"], 1), W, "stem.bn"))
    for i in range(depth):
        t = x
        for j in (1, 2):
            t = F.relu(_bn(t, W, f"block{i}.bn{j}"))
            if _maxima_out is not None:
                _maxima_out.append(t.amax())
            w = W[f"block{i}.conv{j}"]
            if tower_levels:
                t = _quant_conv(t, w, tower_levels, maxima[2 * i + j - 1])
            else:
                t = conv(t, w, 1)
        x = x + t
    outs = []
    for head in ("v", "p"):
        y = _bn(conv(x, W[f"{head}head.conv"], 0), W, f"{head}head.bn")
        y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)
        j = 0
        while f"{head}mlp{j}.weight" in W:
            y = F.linear(q(y), q(W[f"{head}mlp{j}.weight"]),
                         W[f"{head}mlp{j}.bias"])
            if f"{head}mlp{j + 1}.weight" in W:
                y = F.elu(y)
            j += 1
        outs.append(F.log_softmax(y, dim=-1))
    log_v, log_p = outs
    return log_p, log_v


@torch.no_grad()
def calibration_maxima(W: dict, obs: torch.Tensor, cfg: dict,
                       block_rows: int = 4096) -> torch.Tensor:
    """The largest input of each tower conv over the calibration
    observations, through the float network."""
    best = None
    with full_float32():
        for s in range(0, obs.shape[0], block_rows):
            got = []
            forward(W, obs[s:s + block_rows], cfg, _maxima_out=got)
            got = torch.stack(got)
            best = got if best is None else torch.maximum(best, got)
    return best


def evaluate(W: dict, obs: torch.Tensor, cfg: dict, tower_levels: int = 0,
             maxima=None, low: bool = False):
    """Policy and value probabilities of ``obs``, in blocks of rows."""
    return in_blocks(lambda rows: forward(
        W, rows, cfg, tower_levels=tower_levels, maxima=maxima, low=low), obs)
