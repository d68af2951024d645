"""Flax checkpoints of the JAX package loaded by the port.

``utils/flax_bytes.py`` decodes ``flax.serialization.to_bytes`` output
without flax or msgpack: held equal to ``msgpack.unpackb`` and flax's own
``msgpack_restore`` on every type flax writes, chunked arrays included; a
truncated or foreign file raises ValueError. ``NNetWrapper.load_checkpoint``
maps a JAX ``NetState`` (BatchNorm ResNet, GroupNorm ResNet, FC net) onto
the port: model state and ``step`` equal, the optax trace equal to SGD's
momentum buffers, and one more train step of each package within float32
tolerance (rtol 1e-4, atol 1e-5: sums of another order in the products and
their gradients).
"""

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from alphazero_general_tpu.envs import get_env as j_get_env
from alphazero_general_tpu.models.wrapper import NNetWrapper as JWrapper
from alphazero_general_tpu.utils import config as JC
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.models import NNetWrapper
from alphazero_general_tpu_torch.utils.convert import state_dict_from_jax
from alphazero_general_tpu_torch.utils.flax_bytes import from_bytes
from test_torch_model import SMALL, observations

# Small tensors: one intra-op thread. Several test processes share the
# host's cores, and idle OpenMP threads that spin while waiting slow every
# process down many times over.
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
KNOBS = {
    "batchnorm": SMALL,
    "groupnorm": dict(SMALL, norm="groupnorm", value_head_channels=4),
    "fc": dict(SMALL, nnet_type="fc", input_fc_layers=[64, 32]),
}


def test_decoder_matches_msgpack_on_every_type():
    """Scalars of every width and sign, floats, nil, bools, str and bin of
    every length class, arrays and maps past 15 and 65,535 entries."""
    values = [
        0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
        -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1,
        -2**63, 1.5, -0.0, float("inf"), None, True, False, "", "x" * 31,
        "y" * 32, "z" * 300, "ü" * 70000, b"", b"\x00" * 300,
        b"\x01" * 70000, list(range(20)), list(range(70000)),
        {f"k{i}": i for i in range(20)}, {f"k{i}": i for i in range(70000)},
        {"nested": {"a": [1, {"b": None}], "c": -3}},
    ]
    for v in values:
        for single in (False, True):
            data = msgpack.packb(v, use_bin_type=True,
                                 use_single_float=single)
            assert from_bytes(data) == msgpack.unpackb(data, raw=False,
                                                       strict_map_key=False)


def test_decoder_matches_flax_on_arrays(monkeypatch):
    """ndarray leaves of every dtype a NetState holds and others, 0-d
    arrays and numpy scalars, and arrays split into chunks (flax's chunk
    size made small)."""
    rng = np.random.default_rng(0)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {
        "f32": rng.standard_normal((3, 4, 5)).astype(np.float32),
        "i32": np.int32(7) * np.ones((), np.int32),
        "scalar": np.float64(2.5),
        "u8": rng.integers(0, 255, (17,)).astype(np.uint8),
        "i8": rng.integers(-128, 127, (2, 3)).astype(np.int8),
        "f16": rng.standard_normal((5,)).astype(np.float16),
        "bool": np.array([True, False]),
        "empty": {},
        "big": rng.standard_normal((40, 3)).astype(np.float32),
    }
    data = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(data)
    got = from_bytes(data)
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            assert got[k] == w
            continue
        assert np.asarray(got[k]).dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _jax_checkpoint(tmp_path, kind):
    """A JAX wrapper of ``kind`` with momentum and weight decay, trained
    two steps, saved as ``jax.ckpt``; and the batch it trains on."""
    knobs = dict(KNOBS[kind], compute_dtype="float32", seed=4,
                 optimizer_args=dict(momentum=0.9, weight_decay=1e-4))
    jnet = JWrapper(j_get_env("connect4"), JC.get_args(**knobs))
    rng = np.random.default_rng(5)
    obs = observations(16, seed=5)
    pi = rng.dirichlet(np.ones(7), 16).astype(np.float32)
    value = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    batch = (obs, pi, value)
    jnet.train([batch], 2)
    jnet.save_checkpoint(str(tmp_path), "jax")
    return jnet, batch


@pytest.mark.parametrize("kind", sorted(KNOBS))
def test_flax_checkpoint_loads_with_equal_state(tmp_path, kind):
    jnet, batch = _jax_checkpoint(tmp_path, kind)
    net = NNetWrapper.from_checkpoint(get_env("connect4"), str(tmp_path),
                                      "jax", device="cpu")
    state = jax.device_get(jnet.state)
    assert net.step == int(state.step) == 2
    want = state_dict_from_jax(state)
    got = net.model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name
    trace = state_dict_from_jax({"params": state.opt_state[1].trace,
                                 "batch_stats": state.batch_stats})
    params = dict(net.model.named_parameters())
    for name, p in params.items():
        buf = net.optimizer.state[p]["momentum_buffer"]
        assert torch.equal(buf, trace[name]), name
    # One more step of each, from the same state on the same batch.
    jnet.train([batch], 1)
    net.train([batch], 1)
    want = state_dict_from_jax(jax.device_get(jnet.state))
    for name, w in want.items():
        np.testing.assert_allclose(net.model.state_dict()[name].numpy(),
                                   w.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert net.step == int(jnet.state.step) == 3


def test_truncated_or_foreign_files_raise(tmp_path):
    """Every cut of a real flax checkpoint, an unknown extension type, and
    a map without a NetState's keys: ValueError "not a checkpoint"."""
    _jax_checkpoint(tmp_path, "batchnorm")
    data = (tmp_path / "jax.ckpt").read_bytes()
    net = NNetWrapper(get_env("connect4"), JC.get_args(**SMALL),
                      device="cpu")
    cuts = sorted({1, 2, 7, 100, len(data) // 2, len(data) - 1} | set(
        np.random.default_rng(0).integers(1, len(data), 20).tolist()))
    for cut in cuts:
        (tmp_path / "cut.ckpt").write_bytes(data[:cut])
        with pytest.raises(ValueError, match="not a checkpoint"):
            net.load_checkpoint(str(tmp_path), "cut")
    for payload in (msgpack.packb({"params": msgpack.ExtType(9, b"x")}),
                    msgpack.packb({"params": {}, "step": 1}),
                    msgpack.packb([1, 2, 3])):
        (tmp_path / "foreign.ckpt").write_bytes(payload)
        with pytest.raises(ValueError, match="not a checkpoint"):
            net.load_checkpoint(str(tmp_path), "foreign")
