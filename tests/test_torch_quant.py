"""The port's int8 tower (models/quant.py) against the JAX package's.

Small shapes (16-channel two-block ResNet with random BatchNorm statistics,
from test_torch_model), the same numpy inputs on both sides. What is held:

* exactly equal: the int8 weights and per-channel scales
  (``weight_int8``), every parameter built from the same calibration
  maxima (the same float32 operations in the same order), and each int8
  conv's int32 output for the same int8 input (int8 products summed into
  int32 are exact in any order);
* the calibration maxima within bf16 rounding (``MAXIMA_RTOL``);
* the forward of a JAX ``QuantResNet`` converted by ``quant_from_jax``
  against ``quant_apply`` under ``jax.jit`` within ``FORWARD_ATOL``;
* the random calibration playouts, with JAX's actions injected, equal to
  JAX's observations;
* the port's own int8 tower against its bf16 ResNet within the accuracy
  bounds of tests/test_quant.py:42-60;
* the tower's two fused stages a block (``conv_quantize``,
  ``conv_residual``; plain versions on the CPU) bit for bit against the
  chain of one quantize and one ``conv3x3_int8`` a conv that they replace,
  and against a jitted JAX tower built from ``quant_apply``'s own ops; and
  the stages' wrappers refusing what the CUDA kernel does not take before
  they dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_general_tpu.envs import get_env as j_get_env
from alphazero_general_tpu.models import quant as JQ
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs.presets import PRESETS, preset_args
from alphazero_general_tpu_torch.models import NNetWrapper
from alphazero_general_tpu_torch.models import quant as Q
from alphazero_general_tpu_torch.selfplay import selfplay as SP
from alphazero_general_tpu_torch.utils import get_args
from alphazero_general_tpu_torch.utils.convert import (
    quant_from_jax, quant_params_from_jax,
)
from test_torch_arena import jax_calibration
from test_torch_model import SMALL, jax_and_port, observations

# Small tensors: one intra-op thread. Several test processes share the
# host's cores, and idle OpenMP threads that spin while waiting slow every
# process down many times over.
torch.set_num_threads(1)

#: Calibration maxima: the two frameworks' bf16 stem convolutions sum in
#: another order, and where one bf16 activation rounds the other way the
#: max of the float32 affine after it moves by less than a bf16 ulp
#: (2^-8 relative). Seen: 1.4e-7.
MAXIMA_RTOL = 2**-8
#: The int8 forward against jitted ``quant_apply`` from the same
#: parameters: equal int8 codes and accumulators; the stem's and heads'
#: float32 sums differ in order, so a bf16 rounding may flip, about one
#: bf16 ulp of a logit (2^-6 for logits of magnitude 2 to 4, as in the
#: bf16 ResNet's test). Seen: 6.0e-8.
FORWARD_ATOL = 0.02


def _jax_vars(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor as integers of its bits (bf16 and float32 compare bit for
    bit, so -0.0 and 0.0 differ)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _assert_tree_bit_equal(got, want, name="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), name
        for k in want:
            _assert_tree_bit_equal(got[k], want[k], f"{name}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), name
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_tree_bit_equal(a, b, f"{name}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(_bits(got.contiguous()), _bits(want)), name


@pytest.fixture(scope="module")
def nets():
    """A JAX and a port bf16 wrapper with the same weights, a calibration
    batch, and JAX's quantized parameters and maxima of it."""
    jnet, variables, net = jax_and_port("bfloat16", seed=1)
    calib = observations(64, seed=5)
    jmax = np.asarray(JQ._calib_forward_jit(
        _jax_vars(variables), jnp.asarray(calib), jnet.model.depth))
    qp = jax.device_get(JQ.quantize_resnet(
        jnet.model, _jax_vars(variables), jnp.asarray(calib)))
    return jnet, variables, net, calib, jmax, qp


def test_weight_int8_is_bit_equal():
    """Per-output-channel int8 weights and scales of random HWIO kernels,
    one output channel all zeros (its scale clamps at 1e-12)."""
    rng = np.random.default_rng(0)
    for shape in ((3, 3, 16, 16), (3, 3, 12, 20)):
        w = (rng.standard_normal(shape) * rng.uniform(0.01, 2.0)).astype(
            np.float32)
        w[..., 3] = 0.0
        wq_j, ws_j = JQ._weight_int8(jnp.asarray(w))
        wq, ws = Q.weight_int8(torch.from_numpy(w))
        assert wq.dtype == torch.int8 and ws.dtype == torch.float32
        np.testing.assert_array_equal(wq.numpy(), np.asarray(wq_j))
        np.testing.assert_array_equal(ws.numpy().view(np.int32),
                                      np.asarray(ws_j).view(np.int32))


def test_params_from_jax_maxima_are_bit_equal(nets):
    """Every leaf of the JAX ``QuantResNet`` (BatchNorm affines, int8
    weights, the fused scales s1/b1/s2/b2/d2, the bf16 head convs, the
    dense layers) equals the port's built from JAX's maxima."""
    _, _, net, _, jmax, qp = nets
    got = Q.quant_params(net.model, torch.from_numpy(jmax.copy()))
    _assert_tree_bit_equal(got, quant_params_from_jax(qp))


def test_calibration_maxima_agree_within_bf16(nets):
    _, _, net, calib, jmax, _ = nets
    got = Q.calibration_maxima(net.model, torch.from_numpy(calib)).numpy()
    assert got.shape == jmax.shape == (2 * SMALL["depth"],)
    np.testing.assert_allclose(got, jmax, rtol=MAXIMA_RTOL, atol=0)


@pytest.mark.parametrize("batch,hw,cin,cout", [
    (4, (6, 7), 16, 16),    # connect4 rows, aligned widths
    (3, (6, 7), 12, 20),    # widths padded to multiples of 8
    (1, (3, 3), 8, 8),      # 9 rows: padded past cuBLASLt's 16
], ids=["aligned", "padded_channels", "padded_rows"])
def test_conv3x3_int8_equals_jax(batch, hw, cin, cout):
    """``conv3x3_int8`` through ``int8_weight_matrix`` gives the int32
    accumulators of the JAX package's ``_conv_int8`` exactly, extremes of
    both ranges included."""
    rng = np.random.default_rng(batch)
    q = rng.integers(0, 128, (batch, *hw, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    q[0, 0, 0] = 127
    w[..., 0] = 127
    want = np.asarray(JQ._conv_int8(jnp.asarray(q), jnp.asarray(w)))
    wt = Q.int8_weight_matrix(torch.from_numpy(w))
    assert wt.shape == (-(-cout // 8) * 8, 9 * (-(-cin // 8) * 8))
    got = Q.conv3x3_int8(torch.from_numpy(q), wt, cout)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_forward_matches_jitted_quant_apply(nets):
    """``quant_from_jax`` of JAX's parameters, forward on the same
    observations, against ``jax.jit(quant_apply)``."""
    _, _, _, _, _, qp = nets
    obs = observations(32, seed=7)
    want = jax.jit(JQ.quant_apply)(qp, jnp.asarray(obs))
    with torch.inference_mode():
        got = quant_from_jax(qp)(torch.from_numpy(obs))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FORWARD_ATOL)


def test_quantize_resnet_matches_jax_end_to_end(nets):
    """Calibrate and quantize in each package from the same weights and
    calibration batch, then forward: within FORWARD_ATOL (seen: 1.1e-3,
    where a maximum one float32 ulp apart moved a scale and so an int8
    code at a rounding boundary)."""
    _, _, net, calib, _, qp = nets
    obs = observations(32, seed=8)
    want = jax.jit(JQ.quant_apply)(qp, jnp.asarray(obs))
    q = Q.quantize_resnet(net.model, torch.from_numpy(calib))
    with torch.inference_mode():
        got = q(torch.from_numpy(obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FORWARD_ATOL)


def test_calibration_observations_with_jax_actions():
    """Random playouts with auto-reset: with JAX's actions injected, the
    port's observations equal JAX's (connect4, 24 moves, so games end and
    restart), and the helper's observations equal
    ``calibration_observations``'."""
    rng = jax.random.PRNGKey(3)
    want_obs, actions = jax_calibration("connect4", rng, batch=32, moves=24)
    np.testing.assert_array_equal(want_obs, np.asarray(
        JQ.calibration_observations(j_get_env("connect4"), rng, batch=32,
                                    moves=24)))
    got = Q.calibration_observations(get_env("connect4"), batch=32, moves=24,
                                     actions=torch.from_numpy(actions),
                                     device="cpu")
    np.testing.assert_array_equal(got.numpy(), want_obs)
    # Drawn from a generator: valid moves only, the same from the same seed.
    env = get_env("connect4")
    draws = [Q.calibration_observations(
        env, batch=16, moves=8, device="cpu",
        generator=torch.Generator().manual_seed(4)) for _ in range(2)]
    assert draws[0].shape == (128, *env.OBS_SHAPE)
    assert torch.equal(draws[0], draws[1])


def _accuracy(env, q, model, obs):
    with torch.inference_mode():
        logp_q, logv_q = q(obs)
        logp_f, logv_f = model(obs)
    pi_f = torch.exp(logp_f)
    kl = float((pi_f * (logp_f - logp_q)).sum(-1).mean())
    dv = float((torch.exp(logv_q) - torch.exp(logv_f)).abs().max())
    agree = float((logp_q.argmax(-1) == logp_f.argmax(-1)).float().mean())
    return kl, dv, agree


def test_int8_tower_is_close_to_the_bf16_resnet():
    """tests/test_quant.py:42-60 for the port: a random 32-channel 3-block
    net, calibrated on 64 x 12 random playout positions and evaluated on
    64 x 6 others: mean KL(bf16 || int8) < 5e-3, max |dv| < 0.05, argmax
    agreement > 0.97."""
    env = get_env("connect4")
    net = NNetWrapper(env, get_args(
        num_channels=32, depth=3, value_head_channels=8,
        policy_head_channels=8, value_dense_layers=[64],
        policy_dense_layers=[64], seed=0), device="cpu")
    q = net.quantized_inference(calib_obs=Q.calibration_observations(
        env, batch=64, moves=12, device="cpu",
        generator=torch.Generator().manual_seed(1)))
    obs = Q.calibration_observations(env, batch=64, moves=6, device="cpu",
                                     generator=torch.Generator()
                                     .manual_seed(2))
    kl, dv, agree = _accuracy(env, q, net.model, obs)
    assert kl < 5e-3, kl
    assert dv < 0.05, dv
    assert agree > 0.97, agree


def test_wrapper_requantizes_in_place_and_refuses_other_towers(monkeypatch):
    """``quantized_inference`` returns one module per wrapper, written in
    place on each call (so move runners built over it follow the new
    weights); the FC net and GroupNorm raise before any playout."""
    env = get_env("connect4")
    net = NNetWrapper(env, get_args(**SMALL), device="cpu")
    q = net.quantized_inference()
    obs = observations(8, seed=2)
    obs_t = torch.from_numpy(obs)
    with torch.inference_mode():
        before = q(obs_t)[0].clone()
    cfg = SP.SelfPlayConfig(sims_full=4, sims_fast=2)
    runner = SP.make_move_fns(env, cfg, q)["full"]
    with torch.no_grad():
        for p in net.model.parameters():
            p.mul_(1.5)
    assert net.quantized_inference() is q
    with torch.inference_mode():
        after = q(obs_t)[0]
    assert not torch.equal(before, after)
    fresh = Q.quantize_resnet(net.model, Q.calibration_observations(
        env, device="cpu", generator=torch.Generator().manual_seed(0)))
    with torch.inference_mode():
        assert torch.equal(after, fresh(obs_t)[0])
    carry = SP.init_selfplay(env, 4, device="cpu")
    _, rec = runner(carry, generator=torch.Generator().manual_seed(0))
    assert rec.action.shape == (4,)

    def no_playouts(*a, **k):
        raise AssertionError("calibration playouts ran")

    monkeypatch.setattr(Q, "calibration_observations", no_playouts)
    for knob in (dict(norm="groupnorm"), dict(nnet_type="fc")):
        other = NNetWrapper(env, get_args(**SMALL, **knob), device="cpu")
        with pytest.raises(ValueError):
            other.quantized_inference()


def _unfused_tower(m, obs):
    """The tower as one quantize and one ``conv3x3_int8`` a conv, then the
    residual sum: the chain that the fused stages replace."""
    x = obs.permute(0, 2, 3, 1).to(torch.bfloat16)
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).to(torch.float32),
                                   m.stem_w, padding=1)
    x = torch.relu(torch.addcmul(m.stem_b, y.permute(0, 2, 3, 1),
                                 m.stem_s)).to(torch.bfloat16)
    xf = x
    for i in range(m.depth):
        blk = {k: getattr(m, f"block{i}_{k}")
               for k in ("s1", "b1", "w1", "s2", "b2", "w2", "d2")}
        acc = xf
        for conv in ("1", "2"):
            q = Q._quantize(acc, blk["s" + conv], blk["b" + conv])
            acc = Q.conv3x3_int8(q, blk["w" + conv], m.channels)
        xf = x.to(torch.float32).add_((acc * blk["d2"]).to(torch.bfloat16))
        x = xf.to(torch.bfloat16)
    return x


@pytest.mark.parametrize("channels", [16, 12, 40],
                         ids=["aligned", "padded_channels", "cin_not_x32"])
def test_fused_stages_equal_the_unfused_chain(channels):
    """``QuantResNet._tower`` through ``conv_quantize`` and ``conv_residual``
    equals the unfused chain bit for bit, and hands out each conv's int8
    input: a width that is not a multiple of 8 runs padded with zero
    channels."""
    env = get_env("connect4")
    net = NNetWrapper(env, get_args(
        num_channels=channels, depth=3, value_head_channels=4,
        policy_head_channels=4, value_dense_layers=[32],
        policy_dense_layers=[32], seed=channels), device="cpu")
    q = net.quantized_inference(calib_obs=Q.calibration_observations(
        env, batch=32, moves=6, device="cpu",
        generator=torch.Generator().manual_seed(1)))
    obs = torch.from_numpy(observations(16, seed=3))
    with torch.inference_mode():
        got = q._tower(obs)
        assert got.shape == (16, 6, 7, channels)
        assert torch.equal(_bits(got), _bits(_unfused_tower(q, obs)))
        operands = q.conv_operands(obs)
    assert len(operands) == 2 * q.depth
    c8 = -(-channels // Q.ALIGN) * Q.ALIGN
    for a, w in operands:
        assert a.dtype == torch.int8 and a.shape == (16, 6, 7, c8)
        assert w.shape == (c8, 9 * c8)


def _jax_tower(qp, obs):
    """The stem and tower of JAX ``quant_apply``, its own ops, jitted."""
    x = jnp.transpose(obs, (0, 2, 3, 1)).astype(jnp.bfloat16)
    x = JQ._conv_bf16(x, qp.stem_w)
    x = jnp.maximum(x.astype(jnp.float32) * qp.stem_s + qp.stem_b, 0.0)
    x = x.astype(jnp.bfloat16)
    for blk in qp.blocks:
        q1 = JQ._quantize_act(
            jnp.maximum(x.astype(jnp.float32) * blk.s1 + blk.b1, 0.0))
        acc1 = JQ._conv_int8(q1, blk.w1)
        q2 = JQ._quantize_act(
            jnp.maximum(acc1.astype(jnp.float32) * blk.s2 + blk.b2, 0.0))
        acc2 = JQ._conv_int8(q2, blk.w2)
        x = x + (acc2.astype(jnp.float32) * blk.d2).astype(jnp.bfloat16)
    return x


def test_fused_stages_match_the_jax_tower(nets):
    """The tower of ``quant_from_jax`` of JAX's parameters, through the
    fused stages, against the jitted JAX tower on the same observations:
    within one bf16 ulp of the stream (the stems' float32 sums differ in
    order, as in ``test_forward_matches_jitted_quant_apply``), and equal
    where the stems agree."""
    _, _, _, _, _, qp = nets
    obs = observations(32, seed=9)
    want = np.asarray(jax.jit(_jax_tower)(qp, jnp.asarray(obs))
                      .astype(jnp.float32))
    port = quant_from_jax(qp)
    with torch.inference_mode():
        got = port._tower(torch.from_numpy(obs)).to(torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=2**-7)
    assert (got == want).mean() > 0.99


def _conv_operands(c=16, batch=2):
    q = torch.zeros((batch, 6, 7, c), dtype=torch.int8)
    wt = Q.int8_weight_matrix(torch.zeros((3, 3, c, c), dtype=torch.int8))
    v = torch.zeros(c, dtype=torch.float32)
    x = torch.zeros((batch, 6, 7, c), dtype=torch.bfloat16)
    return q, wt, v, x


_REFUSED = {
    "float_activations": (TypeError, lambda q, wt, v, x: Q.conv_quantize(
        q.float(), wt, v, v)),
    "channel_mismatch": (ValueError, lambda q, wt, v, x: Q.conv_quantize(
        q[..., :8].contiguous(), wt, v, v)),
    "channels_not_x8": (ValueError, lambda q, wt, v, x: Q.conv_quantize(
        q[..., :12].contiguous(), Q.int8_weight_matrix(
            torch.zeros((3, 3, 12, 12), dtype=torch.int8))[:12, :108]
        .contiguous(), v[:12], v[:12])),
    "rows_not_contiguous": (ValueError, lambda q, wt, v, x: Q.conv_quantize(
        q.transpose(1, 2), wt, v, v)),
    "weight_not_contiguous": (ValueError, lambda q, wt, v, x: Q.conv_quantize(
        q, wt.t().contiguous().t(), v, v)),
    "scale_length": (ValueError, lambda q, wt, v, x: Q.conv_quantize(
        q, wt, v[:8], v)),
    "scale_dtype": (ValueError, lambda q, wt, v, x: Q.conv_quantize(
        q, wt, v.double(), v)),
    "stream_dtype": (TypeError, lambda q, wt, v, x: Q.conv_residual(
        q, wt, x.float(), v, v, v)),
    "stream_shape": (ValueError, lambda q, wt, v, x: Q.conv_residual(
        q, wt, x[:1], v, v, v)),
    "stream_not_contiguous": (ValueError, lambda q, wt, v, x:
                              Q.conv_residual(q, wt, x.transpose(1, 2)
                                              .contiguous().transpose(1, 2),
                                              v, v, v)),
    "scale_without_bias": (ValueError, lambda q, wt, v, x: Q.conv_residual(
        q, wt, x, v, v, None)),
    "other_device": (ValueError, lambda q, wt, v, x: Q.conv_quantize(
        q, wt.to("meta"), v, v)),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_fused_conv_wrappers_refuse_what_the_kernel_does_not_take(
        case, monkeypatch):
    """Each wrapper raises on operands the CUDA kernel does not take, before
    it dispatches to the kernel or the plain version."""

    def dispatched(*a, **k):
        raise AssertionError("dispatched")

    monkeypatch.setattr(Q, "conv_quantize_plain", dispatched)
    monkeypatch.setattr(Q, "conv_residual_plain", dispatched)
    monkeypatch.setattr(Q, "_launch_conv", dispatched)
    error, call = _REFUSED[case]
    with pytest.raises(error):
        call(*_conv_operands())


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_fused_conv_fits_every_preset(name):
    """Each preset's tower fits the fused kernel's shared memory on the
    card, both convs (the check the CUDA wrapper makes before a launch);
    a 256-channel tower does not, and raises."""
    env = get_env(name)
    width = env.OBS_SHAPE[-1]
    c8 = -(-preset_args(name).num_channels // Q.ALIGN) * Q.ALIGN
    for residual in (False, True):
        Q._check_fits(width, c8, c8, residual)
        assert Q.conv_smem_bytes(width, c8, c8, residual) <= \
            Q.SMEM_PER_BLOCK
    with pytest.raises(ValueError):
        Q._check_fits(width, 256, 256, True)
