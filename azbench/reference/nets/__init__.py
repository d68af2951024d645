"""The reference networks, one module a network, found by the
configuration's ``args["nnet_type"]`` (``registry.network``): the network
``<nnet_type>`` is ``nets/<nnet_type>.py``. Each module gives:

- ``layout(cfg)``: ``[(name, shape, kind)]`` of every weight, in the order
  ``weights.make`` draws them; kind one of "conv", "dense", "bias",
  "bn.weight", "bn.bias", "bn.mean", "bn.var";
- ``program_names(cfg)``: each weight's name -> the program's state-dict
  key, as strings (nothing here imports the program);
- ``evaluate(W, obs, cfg, tower_levels=0, maxima=None, low=False)``: the
  policy and value probabilities of ``obs`` in float32; ``low`` rounds
  every conv and dense operand to float8 (``fp8``), ``tower_levels`` with
  ``maxima`` runs a quantized tower;
- ``calibration_maxima(W, obs, cfg)``: only where the network has a
  quantized tower, the calibration maxima ``evaluate`` takes;
- ``ops(cfg)``: ``{"tower": ..., "other": ...}``, the operations of one row
  (2 per multiply-add), "tower" run at the tower's precision.

What the networks share is here: float32 without TF32, the float8
operand, and evaluation in blocks of rows.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    """float32 products in full float32 (no TF32) inside the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to a float8 e4m3 operand (saturated at its largest finite
    value): the control of a bfloat16 configuration, one precision below
    it."""
    return torch.clamp(x, -448.0, 448.0).to(torch.float8_e4m3fn).to(x.dtype)


@torch.no_grad()
def in_blocks(forward, obs: torch.Tensor, block_rows: int = 4096):
    """Policy and value probabilities of ``obs`` from ``forward(rows) ->
    (log-policy, log-value)``, in blocks of rows, in full float32."""
    ps, vs = [], []
    with full_float32():
        for s in range(0, obs.shape[0], block_rows):
            lp, lv = forward(obs[s:s + block_rows])
            ps.append(torch.exp(lp))
            vs.append(torch.exp(lv))
    return torch.cat(ps), torch.cat(vs)
