"""Int8 post-training quantization of the ResNet tower for inference — the
port of alphazero_general_tpu/models/quant.py.

The scheme is the JAX package's (standard post-training static
quantization):

* tower conv weights: symmetric per-output-channel int8
  (``ws[c] = max|W[..., c]| / 127``);
* tower conv inputs: symmetric per-tensor int8 with a static scale
  calibrated on a batch of observations (max |activation|), folded into the
  BatchNorm affine before it, so each chain between two convs is one
  multiply-add, round, clip to [0, 127] and cast;
* the stem conv, both 1x1 head convs and both MLPs with bfloat16
  operands, the residual stream in bfloat16, both log-softmaxes in
  float32.

``QuantResNet`` is an ``nn.Module`` whose ``forward(obs)`` returns
``(log_pi, log_v)``, the contract of the port's ResNet, so the move runners
and the arena take either. Re-quantizing (``quantize_resnet(..., out=q)``)
writes its buffers in place, so runners built over it follow.

Layout: activations are NHWC, as in JAX: a [B, H, W, C] tensor is a
[B·H·W, C] matrix of rows. The weight of a 3x3 tower conv, HWIO [3, 3, C,
C], reshapes to the [9C, C] right-hand side of the 9-tap patch matrix with
no permutation (``int8_weight_matrix`` stores it transposed). Int8
products summed into int32 are exact (|acc| <= 127² · 9C < 2³¹), so the
accumulators equal JAX's (``lax.conv_general_dilated`` into int32)
whenever the int8 inputs do.

A residual block is two calls, each a tower conv with the chain that
follows it: ``conv_quantize`` (conv1, then conv2's quantizer) and
``conv_residual`` (conv2, the residual sum, and the next block's
quantizer). On the card each is one launch of the fused implicit-GEMM
kernel of ``csrc/conv_int8.cu``; on the CPU each runs its plain version
(``conv_quantize_plain``, ``conv_residual_plain``): ``conv3x3_int8`` (the
padded input, the patch matrix and one ``torch._int_mm``), ``_quantize``
and the residual ops. The kernel's outputs are bit-equal to the plain
versions run on the card.

Numerics kept from the JAX package as XLA compiles it under ``jit``:
``round`` is half-to-even in both; every scale product of the parameters
is taken in the same order, with true float32 divisions (``_div``: a
division by a Python number may run as a product with its reciprocal);
each affine ``x * s + b`` is one fused multiply-add (``torch.addcmul``), as
XLA contracts it; and a bf16 result that the JAX code casts to float32
right away enters that step unrounded, as XLA's fusions leave it: the
stem's and the 1x1 head convs' float32 sums (``_conv_f32``), the last
dense layer's sum, and the residual sum that the next block quantizes (the
stream itself is rounded to bf16). The dense products and the ELUs round
to bf16 as JAX's do.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from alphazero_general_tpu_torch.envs.core import state_items
from alphazero_general_tpu_torch.models.architectures import ResNet
from alphazero_general_tpu_torch.ops.build import current_stream, \
    load_library
from alphazero_general_tpu_torch.utils import trace

BN_EPS = 1e-5  # flax.linen.BatchNorm default
#: cuBLASLt's int8 product takes more than 16 rows and inner and outer
#: widths that are multiples of 8: tiny batches are padded to this many
#: rows, and channel counts to a multiple of ``ALIGN``.
MIN_ROWS = 17
ALIGN = 8
#: Output rows a block of the fused conv kernel takes at a time, and the
#: shared memory one block may use on an H100 (227 KB).
CONV_TILE_ROWS = 128
SMEM_PER_BLOCK = 232448


def _ceil(n: int, k: int) -> int:
    return -(-n // k) * k


def _div(a, b) -> torch.Tensor:
    """``a / b`` as a true float32 division, for numbers or tensors."""
    like = a if torch.is_tensor(a) else b
    a = a if torch.is_tensor(a) else torch.full_like(like, a)
    b = b if torch.is_tensor(b) else torch.full_like(like, b)
    return a / b


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """An OIHW conv weight in the JAX package's HWIO layout."""
    return w.detach().permute(2, 3, 1, 0)


def bn_affine(norm) -> tuple:
    """BatchNorm with running statistics as a per-channel (scale, bias),
    float32 (JAX quant.py:86)."""
    s = _div(norm.weight.detach(), torch.sqrt(norm.running_var + BN_EPS))
    b = norm.bias.detach() - norm.running_mean * s
    return s.to(torch.float32), b.to(torch.float32)


def weight_int8(w: torch.Tensor) -> tuple:
    """Symmetric per-output-channel int8 weights of an HWIO kernel:
    ``(wq int8 HWIO, ws float32[Cout])`` (JAX quant.py:93)."""
    ws = _div(w.abs().amax(dim=(0, 1, 2)), 127.0)
    ws = torch.clamp(ws, min=1e-12)
    wq = torch.clamp(torch.round(w / ws), -127, 127).to(torch.int8)
    return wq, ws.to(torch.float32)


def int8_weight_matrix(wq: torch.Tensor) -> torch.Tensor:
    """An int8 HWIO [3, 3, Cin, Cout] kernel laid out once for
    ``conv3x3_int8``: the [9·Cin8, Cout8] right-hand side (channels padded
    with zeros to multiples of ``ALIGN``) stored transposed, [Cout8,
    9·Cin8] contiguous, so that each output channel's taps are contiguous
    (the "TN" operands cuBLASLt's int8 product takes)."""
    kh, kw, cin, cout = wq.shape
    padded = F.pad(wq, (0, _ceil(cout, ALIGN) - cout,
                        0, _ceil(cin, ALIGN) - cin))
    return padded.reshape(kh * kw * _ceil(cin, ALIGN), -1).t().contiguous()


def conv3x3_int8(q: torch.Tensor, wt: torch.Tensor,
                 out_channels: int) -> torch.Tensor:
    """'SAME' 3x3 convolution of int8 NHWC activations ``q`` [B, H, W, C]
    with a weight laid out by ``int8_weight_matrix``, into int32 [B, H, W,
    out_channels]: zero padding (zero point 0, so it matches 'SAME'), the
    9-tap patch matrix [B·H·W, 9·C8] from slices of the padded tensor, and
    one ``torch._int_mm`` (cuBLASLt's on the card, where a failure of the
    product raises). The plain versions' conv; the forward's own route on
    the card is the fused kernel.
    The padding and the patch matrix are copied as int32 words of 4
    channels each: the same bytes, moved by copies of 4-byte elements
    (byte-wide copies of them were slower on an H100; PERF.md has both)."""
    b, h, w, c = q.shape
    c8 = wt.shape[1] // 9
    if q.dtype != torch.int8 or wt.dtype != torch.int8 or c8 < c:
        raise ValueError(f"conv3x3_int8: int8 activations of {c} channels "
                         f"and an int8 weight of {c8} padded input "
                         f"channels, got {q.dtype} {tuple(q.shape)} and "
                         f"{wt.dtype} {tuple(wt.shape)}")
    if c8 != c:
        q = F.pad(q, (0, c8 - c))
    p = F.pad(q.contiguous().view(torch.int32), (0, 0, 1, 1, 1, 1))
    rows = b * h * w
    patches = torch.cat([p[:, i:i + h, j:j + w] for i in range(3)
                         for j in range(3)], dim=-1).view(torch.int8)
    patches = patches.reshape(rows, 9 * c8)
    if rows < MIN_ROWS:
        patches = F.pad(patches, (0, 0, 0, MIN_ROWS - rows))
    acc = torch._int_mm(patches, wt.t())
    return acc[:rows, :out_channels].reshape(b, h, w, out_channels)


def _quantize(t: torch.Tensor, s: torch.Tensor, b: torch.Tensor):
    """clip(round(relu(t * s + b)), 0, 127) as int8; ``s`` and ``b`` carry
    the 127 / a quant scale (the ReLU is the clip's lower bound)."""
    return torch.addcmul(b, t, s).round_().clamp_(0.0, 127.0).to(torch.int8)


def conv_quantize_plain(q: torch.Tensor, wt: torch.Tensor, s: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """The first conv of a block, quantized for the second: int8 [B, H, W,
    Cout] from int8 ``q`` [B, H, W, Cin] and a weight ``wt`` [Cout, 9·Cin]
    laid out by ``int8_weight_matrix``, with the second conv's quantizer
    ``s``, ``b`` (which fold in the first conv's dequantization)."""
    return _quantize(conv3x3_int8(q, wt, wt.shape[0]), s, b)


def conv_residual_plain(q: torch.Tensor, wt: torch.Tensor, x: torch.Tensor,
                        d: torch.Tensor, s: torch.Tensor | None = None,
                        b: torch.Tensor | None = None) -> tuple:
    """The second conv of a block and the residual sum: ``(x', q')``, the
    new bf16 residual stream ``x' = bf16(xf)`` with ``xf = float(x) +
    float(bf16(acc · d))``, and the next block's int8 input quantized from
    the unrounded float32 ``xf`` with ``s``, ``b`` (None without them: the
    last block)."""
    acc = conv3x3_int8(q, wt, wt.shape[0])
    # The residual stream stays bf16; the next quantize reads the float32
    # sum before its rounding.
    xf = x.to(torch.float32).add_((acc * d).to(torch.bfloat16))
    return xf.to(torch.bfloat16), None if s is None else _quantize(xf, s, b)


def conv_smem_bytes(width: int, cin: int, cout: int, residual: bool) -> int:
    """Shared memory of one block of the fused conv kernel (``layout`` in
    csrc/conv_int8.cu): the weight's rows for the output channels padded
    to 16 · a power of two, two tiles of input rows with their halo, a
    zero row and the staging tile of the outputs."""
    ncta = 16
    while ncta < cout:
        ncta *= 2
    cin32 = _ceil(cin, 32)
    rows = CONV_TILE_ROWS + 2 * (width + 1)
    return (ncta * (9 * cin32 + 16) + 2 * rows * (cin32 + 16) + cin32
            + CONV_TILE_ROWS * ((2 if residual else 1) * ncta + 16))


@functools.lru_cache(maxsize=None)
def _check_fits(width: int, cin: int, cout: int, residual: bool) -> None:
    """Raise for widths the kernel cannot hold in a block's shared memory:
    more than 128 output channels, more than ``SMEM_PER_BLOCK`` bytes, or
    (the second conv stages its codes in a tile's input rows) more output
    channels than input channels rounded up to 32."""
    need = conv_smem_bytes(width, cin, cout, residual)
    codes = CONV_TILE_ROWS * (_ceil(cout, 16) + 16)
    if (cout > 128 or need > SMEM_PER_BLOCK or codes > (
            CONV_TILE_ROWS + 2 * (width + 1)) * (_ceil(cin, 32) + 16)):
        raise ValueError(
            f"conv: {cin} -> {cout} channels on a board {width} wide need "
            f"{need} bytes of shared memory a block (at most 128 output "
            f"channels, no more than the input's rounded up to 32, and "
            f"{SMEM_PER_BLOCK} bytes)")


def _check_conv(q, wt, x, vectors: dict) -> tuple:
    """Raise on operands the fused conv does not take: the wrong dtype,
    shape or device, channels that are not a multiple of ``ALIGN`` or do
    not match the weight's, rows that are not contiguous. Returns (rows,
    H, W, Cin, Cout). Every launch of a forward makes these checks, so the
    common case reads each attribute once."""
    if q.dtype != torch.int8 or wt.dtype != torch.int8:
        raise TypeError(f"conv: int8 activations and weight, got {q.dtype} "
                        f"and {wt.dtype}")
    if q.dim() != 4 or wt.dim() != 2:
        raise ValueError(f"conv: activations [B, H, W, C] and a weight "
                         f"[Cout, 9·C], got {tuple(q.shape)} and "
                         f"{tuple(wt.shape)}")
    bsz, h, w, cin = q.shape
    cout, k = wt.shape
    if cin % ALIGN or cout % ALIGN or k != 9 * cin:
        raise ValueError(f"conv: {cin} input channels against a weight of "
                         f"{(cout, k)}; channels must be multiples of "
                         f"{ALIGN} and the weight [Cout, 9·{cin}]")
    if x is not None:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"conv: a bf16 residual stream, got {x.dtype}")
        if x.shape != (bsz, h, w, cout):
            raise ValueError(f"conv: residual stream {tuple(x.shape)}, "
                             f"expected {(bsz, h, w, cout)}")
    for name, v in vectors.items():
        if v.dtype != torch.float32 or v.shape != (cout,):
            raise ValueError(f"conv: {name} must be float32 [{cout}], got "
                             f"{v.dtype} {tuple(v.shape)}")
    device = q.device
    for name, t in (("q", q), ("wt", wt), ("x", x), *vectors.items()):
        if t is not None and (t.device != device or not t.is_contiguous()):
            raise ValueError(f"conv: {name} must be contiguous and on "
                             f"{device}, the activations' device; it is on "
                             f"{t.device}")
    return bsz * h * w, h, w, cin, cout


def _launch_conv(q, wt, x, s, b, d, out_q, out_x, shape) -> None:
    """One launch of the fused conv on CUDA tensors; raises where the
    kernel cannot take the shape or the launch fails."""
    rows, h, w, cin, cout = shape
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"conv runs on cuda or cpu, not {device}")
    _check_fits(w, cin, cout, x is not None)
    for t in (q, wt, x, s, b, d):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("conv: every operand must start at a multiple "
                             "of 16 bytes")
    if rows:
        ptr = (lambda t: None if t is None else t.data_ptr())
        err = load_library().azg_conv3x3_int8(
            *map(ptr, (q, wt, x, s, b, d, out_q, out_x)), rows, h, w, cin,
            cout, device.index, current_stream(device.index))
        if err != 0:
            raise RuntimeError(f"conv kernel launch failed: CUDA error {err}")
    trace.count("network.conv_int8", 1)


def conv_quantize(q: torch.Tensor, wt: torch.Tensor, s: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """``conv_quantize_plain``'s function: the fused kernel for CUDA
    tensors (one launch, counted in ``conv_quantize.launches``), the plain
    version for CPU tensors."""
    shape = _check_conv(q, wt, None, dict(s=s, b=b))
    if q.device.type == "cpu":
        return conv_quantize_plain(q, wt, s, b)
    out = torch.empty(q.shape[:-1] + (shape[-1],), dtype=torch.int8,
                      device=q.device)
    _launch_conv(q, wt, None, s, b, None, out, None, shape)
    conv_quantize.launches += 1
    return out


conv_quantize.launches = 0


def conv_residual(q: torch.Tensor, wt: torch.Tensor, x: torch.Tensor,
                  d: torch.Tensor, s: torch.Tensor | None = None,
                  b: torch.Tensor | None = None) -> tuple:
    """``conv_residual_plain``'s function: the fused kernel for CUDA
    tensors (one launch, counted in ``conv_residual.launches``), the plain
    version for CPU tensors."""
    if (s is None) != (b is None):
        raise ValueError("conv_residual: give both s and b, or neither")
    vectors = dict(d=d) if s is None else dict(d=d, s=s, b=b)
    shape = _check_conv(q, wt, x, vectors)
    if q.device.type == "cpu":
        return conv_residual_plain(q, wt, x, d, s, b)
    out_x = torch.empty_like(x)
    out_q = None if s is None else torch.empty(
        x.shape, dtype=torch.int8, device=x.device)
    _launch_conv(q, wt, x, s, b, d, out_q, out_x, shape)
    conv_residual.launches += 1
    return out_x, out_q


conv_residual.launches = 0


def _conv_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'SAME' convolution of bf16 NHWC ``x`` with an OIHW weight rounded to
    bf16, summed and returned in float32, NHWC: the JAX package's bf16
    conv, whose float32 result XLA hands unrounded to the float32 affine
    after it. The NCHW view of NHWC activations is channels-last."""
    w = w.to(torch.bfloat16).to(torch.float32)
    y = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2),
                 w.contiguous(memory_format=torch.channels_last),
                 padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def check_quantizable(model) -> None:
    """Raise ValueError for a model without an int8 path: the FC net and
    GroupNorm towers (JAX wrapper.py:216-224)."""
    if not isinstance(model, ResNet):
        raise ValueError("quantized inference supports ResNet only")
    if model.norm != "batchnorm":
        raise ValueError("int8 quantization requires batchnorm running "
                         f"stats (norm={model.norm!r})")


@torch.no_grad()
def calibration_maxima(model: ResNet, obs: torch.Tensor) -> torch.Tensor:
    """The bf16 forward over stem and tower that mirrors the quantized
    structure (JAX quant.py:129): max |activation| at each of the
    ``2 · depth`` quant points, float32. Where ``QuantResNet.forward``
    keeps a float32 value unrounded, so does this."""
    x = obs.permute(0, 2, 3, 1).to(torch.bfloat16)
    s0, b0 = bn_affine(model.stem_norm)
    x = torch.relu(torch.addcmul(b0, _conv_f32(x, model.stem_conv.weight),
                                 s0)).to(torch.bfloat16)
    xf = x.to(torch.float32)
    maxima = []
    for blk in model.blocks:
        s1, b1 = bn_affine(blk.norm1)
        t = torch.relu(torch.addcmul(b1, xf, s1))
        maxima.append(t.amax())
        h = _conv_f32(t.to(torch.bfloat16), blk.conv1.weight)
        s2, b2 = bn_affine(blk.norm2)
        t2 = torch.relu(torch.addcmul(b2, h, s2))
        maxima.append(t2.amax())
        h2 = _conv_f32(t2.to(torch.bfloat16), blk.conv2.weight)
        xf = x.to(torch.float32) + h2.to(torch.bfloat16).to(torch.float32)
        x = xf.to(torch.bfloat16)
    return torch.stack(maxima)


def _dense_layers(mlp) -> list:
    return [(layer.weight.detach().t(), layer.bias.detach())
            for layer in mlp.layers]


@torch.no_grad()
def quant_params(model: ResNet, maxima: torch.Tensor) -> dict:
    """The int8 inference parameters of ``model`` from calibration maxima
    (JAX quant.py:159-219), as a dict in the JAX ``QuantResNet``'s fields
    and layouts: HWIO kernels, ``blocks`` a list of dicts, ``v_dense`` and
    ``p_dense`` lists of float32 (kernel [in, out], bias)."""
    check_quantizable(model)
    maxima = torch.clamp(maxima, min=1e-6)
    s0, b0 = bn_affine(model.stem_norm)
    blocks = []
    for i, blk in enumerate(model.blocks):
        a1, a2 = maxima[2 * i], maxima[2 * i + 1]
        s1, b1 = bn_affine(blk.norm1)
        s2, b2 = bn_affine(blk.norm2)
        w1q, ws1 = weight_int8(_hwio(blk.conv1.weight))
        w2q, ws2 = weight_int8(_hwio(blk.conv2.weight))
        q1 = _div(127.0, a1)
        q2 = _div(127.0, a2)
        d1 = ws1 * _div(a1, 127.0)  # conv1 acc (int32) -> float
        blocks.append(dict(
            s1=s1 * q1, b1=b1 * q1, w1=w1q,
            # feed conv2's quantizer: relu((acc*d1)*s2 + b2) * q2
            s2=d1 * s2 * q2, b2=b2 * q2, w2=w2q,
            d2=ws2 * _div(a2, 127.0)))
    vh_s, vh_b = bn_affine(model.value_norm)
    ph_s, ph_b = bn_affine(model.policy_norm)
    return dict(
        stem_w=_hwio(model.stem_conv.weight).to(torch.bfloat16),
        stem_s=s0, stem_b=b0, blocks=blocks,
        vh_w=_hwio(model.value_conv.weight).to(torch.bfloat16),
        vh_s=vh_s, vh_b=vh_b, v_dense=_dense_layers(model.value_mlp),
        ph_w=_hwio(model.policy_conv.weight).to(torch.bfloat16),
        ph_s=ph_s, ph_b=ph_b, p_dense=_dense_layers(model.policy_mlp))


def _laid_out(params: dict) -> dict:
    """Buffer name -> tensor, in the module's layouts, from ``params``
    (``quant_params``' dict): the stem OIHW channels-last, the tower
    weights as ``int8_weight_matrix`` gives them, the 1x1 head convs as
    [C, Hc] matrices, the dense layers bf16."""
    f32, bf16 = torch.float32, torch.bfloat16
    out = {"stem_w": params["stem_w"].permute(3, 2, 0, 1).to(bf16).to(f32)
           .contiguous(memory_format=torch.channels_last),
           "stem_s": params["stem_s"].to(f32),
           "stem_b": params["stem_b"].to(f32)}
    for i, blk in enumerate(params["blocks"]):
        for k in ("s1", "b1", "s2", "b2", "d2"):
            out[f"block{i}_{k}"] = blk[k].to(f32)
        for k in ("w1", "w2"):
            out[f"block{i}_{k}"] = int8_weight_matrix(blk[k])
    for h in ("vh", "ph"):
        w = params[f"{h}_w"]
        out[f"{h}_w"] = w.reshape(w.shape[-2], w.shape[-1]).to(bf16) \
            .to(f32).contiguous()
        out[f"{h}_s"] = params[f"{h}_s"].to(f32)
        out[f"{h}_b"] = params[f"{h}_b"].to(f32)
    for head in ("v_dense", "p_dense"):
        for j, (k, b) in enumerate(params[head]):
            out[f"{head}{j}_k"] = k.to(bf16).contiguous()
            out[f"{head}{j}_b"] = b.to(bf16)
    return out


class QuantResNet(nn.Module):
    """Int8-tower inference of a BatchNorm ResNet: ``forward(obs [B, C, H,
    W] float32) -> (log_pi [B, A], log_v [B, V])`` float32, as the ResNet's.

    Built from ``quant_params``' dict (or ``quant_from_jax``'s, of a JAX
    ``QuantResNet``); ``load_params`` writes a new one of the same shapes
    into the buffers in place. ``forwards`` counts the forwards of every
    instance, so a run can show that it went through the int8 tower."""

    forwards = 0

    def __init__(self, params: dict):
        super().__init__()
        self.depth = len(params["blocks"])
        self.channels = params["stem_w"].shape[-1]
        self.dense = {h: len(params[h]) for h in ("v_dense", "p_dense")}
        for name, t in _laid_out(params).items():
            self.register_buffer(name, t)

    @torch.no_grad()
    def load_params(self, params: dict) -> None:
        """Re-quantized parameters, written into the buffers in place."""
        new = _laid_out(params)
        for name, buf in self.named_buffers():
            if new[name].shape != buf.shape:
                raise ValueError(f"load_params: {name} of shape "
                                 f"{tuple(new[name].shape)}, the module's "
                                 f"is {tuple(buf.shape)}")
            buf.copy_(new[name])

    def _mlp(self, x: torch.Tensor, head: str) -> torch.Tensor:
        """The ELU MLP in bf16; the last layer's sum is returned unrounded
        in float32."""
        n = self.dense[head]
        for j in range(n):
            k, b = (getattr(self, f"{head}{j}_{t}") for t in ("k", "b"))
            if j + 1 == n:
                return (x @ k).to(torch.float32) + b.to(torch.float32)
            x = x @ k + b
            x = torch.where(x > 0, x, torch.expm1(x))  # ELU

    def _head(self, x: torch.Tensor, h: str, head: str) -> torch.Tensor:
        b = x.shape[0]
        y = x.reshape(-1, self.channels).to(torch.float32) \
            @ getattr(self, f"{h}_w")
        y = torch.addcmul(getattr(self, f"{h}_b"), y,
                          getattr(self, f"{h}_s")).to(torch.bfloat16)
        return self._mlp(y.reshape(b, -1), head)

    def _block(self, i: int, c8: int) -> dict:
        """Block ``i``'s weights and per-channel vectors, the vectors
        padded with zeros to ``c8`` channels."""
        blk = {k: getattr(self, f"block{i}_{k}")
               for k in ("s1", "b1", "w1", "s2", "b2", "w2", "d2")}
        if c8 != self.channels:
            for k in ("s1", "b1", "s2", "b2", "d2"):
                blk[k] = F.pad(blk[k], (0, c8 - self.channels))
        return blk

    def _tower(self, obs: torch.Tensor, operands=None) -> torch.Tensor:
        """Stem and residual tower: the bf16 residual stream [B, H, W, C].
        Each tower conv's int8 input and weight are appended to
        ``operands`` where given. A width that is not a multiple of
        ``ALIGN`` runs padded with zero channels (their weights, scales
        and so their codes and stream are zero)."""
        c = self.channels
        c8 = _ceil(c, ALIGN)
        x = obs.permute(0, 2, 3, 1).to(torch.bfloat16)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float32), self.stem_w,
                     padding=1)
        # The stem's NHWC view is contiguous where the conv's output is
        # channels-last; the fused convs take contiguous rows.
        x = torch.relu(torch.addcmul(self.stem_b, y.permute(0, 2, 3, 1),
                                     self.stem_s)).to(torch.bfloat16) \
            .contiguous()
        if c8 != c:
            x = F.pad(x, (0, c8 - c))
        blk = self._block(0, c8)
        q = _quantize(x, blk["s1"], blk["b1"])
        for i in range(self.depth):
            nxt = self._block(i + 1, c8) if i + 1 < self.depth else {}
            if operands is not None:
                operands.append((q, blk["w1"]))
            q = conv_quantize(q, blk["w1"], blk["s2"], blk["b2"])
            if operands is not None:
                operands.append((q, blk["w2"]))
            x, q = conv_residual(q, blk["w2"], x, blk["d2"], nxt.get("s1"),
                                 nxt.get("b1"))
            blk = nxt
        return x if c8 == c else x[..., :c]

    def forward(self, obs: torch.Tensor):
        QuantResNet.forwards += 1
        x = self._tower(obs)
        pi = self._head(x, "ph", "p_dense")
        v = self._head(x, "vh", "v_dense")
        return (F.log_softmax(pi, dim=-1), F.log_softmax(v, dim=-1))

    def conv_operands(self, obs: torch.Tensor) -> list:
        """(int8 input [B, H, W, C8], weight) of each tower conv that
        ``forward(obs)`` multiplies, in order (on the card, the fused
        kernels' own outputs): what a check holds one device's products to
        another's with."""
        operands = []
        self._tower(obs, operands)
        return operands


def quantize_resnet(model: ResNet, calib_obs: torch.Tensor,
                    out: QuantResNet | None = None,
                    reduce=None) -> QuantResNet:
    """Int8 inference of a trained BatchNorm ResNet, with static activation
    scales calibrated on ``calib_obs`` (float32 [Bc, C, H, W] on the
    model's device; JAX quant.py:159). With ``out``, its buffers are
    re-quantized in place and it is returned. ``reduce(maxima) ->
    maxima``, where given, combines the calibration maxima first (the max
    over ranks). Raises ValueError for a model without an int8 path."""
    check_quantizable(model)
    maxima = calibration_maxima(model, calib_obs)
    if reduce is not None:
        maxima = reduce(maxima)
    params = quant_params(model, maxima)
    if out is None:
        return QuantResNet(params)
    out.load_params(params)
    return out


@torch.no_grad()
def calibration_observations(env, batch: int = 256, moves: int = 24,
                             generator=None, actions=None,
                             device="cuda") -> torch.Tensor:
    """Observations of random playouts, the cold-start calibration set
    (JAX quant.py:255): ``moves`` uniformly random valid moves from the
    initial position over ``batch`` games with auto-reset, every pre-move
    observation, move-major: [moves · batch, C, H, W] float32. ``actions``
    [moves, batch], where given, replaces the random choices (tests pass
    the JAX package's)."""
    states = env.init(batch, device)
    obs = []
    for k in range(moves):
        obs.append(env.observation(states))
        if actions is None:
            valid = env.valid_moves(states).to(torch.float32)
            act = torch.multinomial(valid, 1, generator=generator)[:, 0]
        else:
            act = torch.as_tensor(actions[k], device=device)
        nxt = env.step(states, act.to(torch.int32))
        done = (env.win_state(nxt) > 0).any(dim=-1)
        fresh = env.init(batch, device)
        states = type(nxt)(**{
            f: torch.where(done.reshape((-1,) + (1,) * (x.dim() - 1)),
                           getattr(fresh, f), x)
            for f, x in state_items(nxt).items()})
    return torch.cat(obs).to(torch.float32)
