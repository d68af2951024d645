"""The port's training against the JAX package's: training-mode BatchNorm,
SGD steps, the learning-rate schedule and checkpoints.

Both sides start from the same weights (the JAX wrapper's, with random
BatchNorm statistics, converted by utils/convert.py) and take the same
batches, float32. Tolerances: the training-mode forward within 1e-5
(relative) of flax's; after three SGD steps, params and batch statistics
within 1e-5 relative plus 1e-6 absolute (float32 sums of another order in
the convolutions and their gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_general_tpu.envs.connect4 import Connect4 as JConnect4
from alphazero_general_tpu.models.wrapper import multistep_lr as j_multistep
from alphazero_general_tpu.selfplay.device_window import DeviceWindow as JDW
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.models import NNetWrapper
from alphazero_general_tpu_torch.models.wrapper import multistep_lr
from alphazero_general_tpu_torch.selfplay.device_window import DeviceWindow
from alphazero_general_tpu_torch.utils import get_args
from alphazero_general_tpu_torch.utils.convert import resnet_state_dict
from test_torch_model import SMALL, jax_and_port, observations

# Small tensors: one intra-op thread. Several test processes share the
# host's cores, and idle OpenMP threads that spin while waiting slow every
# process down many times over.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
BATCH = 16


def _samples(n, seed):
    """Training rows: observations of random games, random policies and
    one-hot or draw values."""
    rng = np.random.default_rng(seed)
    obs = observations(n, seed=seed).astype(np.float16)
    pi = rng.dirichlet(np.ones(7), n).astype(np.float16)
    value = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return obs, pi, value


def test_training_mode_batchnorm_matches_flax():
    """One training-mode forward: outputs and the updated batch statistics
    (flax momentum 0.9, biased variance) against flax's."""
    jnet, variables, net = jax_and_port("float32", seed=3)
    obs = observations(24, seed=3)
    (j_logp, j_logv), mutated = jnet.model.apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(obs),
        train=True, mutable=["batch_stats"])
    net.model.train()
    logp, logv = net.model(torch.from_numpy(obs))
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(j_logp),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logv.detach().numpy(), np.asarray(j_logv),
                               rtol=RTOL, atol=ATOL)
    want = resnet_state_dict({"params": variables["params"],
                              "batch_stats": jax.device_get(
                                  mutated["batch_stats"])})
    got = net.model.state_dict()
    stats = [k for k in want if "running" in k]
    assert len(stats) == 2 * (1 + 2 * SMALL["depth"] + 2)
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("mode", ["window_symmetries", "host_batches"])
def test_sgd_steps_match_jax(mode):
    """Three SGD steps (momentum 0.9, weight decay 1e-4, lr 0.01, value
    loss weight 1.5) on the same batches: in window mode with a random
    symmetry per sample (the Coach's default), and with host batches."""
    jnet, variables, net = jax_and_port("float32", seed=6)
    jnet.state = jnet.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))
    env = get_env("connect4")
    rng = np.random.default_rng(8)
    obs, pi, value = _samples(40, seed=8)
    if mode == "window_symmetries":
        jw = JDW((4, 6, 7), 7, 3, rows=64, chunk=32)
        tw = DeviceWindow((4, 6, 7), 7, 3, rows=64, chunk=32, device="cpu")
        for w in (jw, tw):
            w.add_iteration(1, obs, pi, value)
        phys = tw.indices_for(1, 1)
        np.testing.assert_array_equal(phys, jw.indices_for(1, 1))
        idx = [phys[rng.permutation(len(phys))[:BATCH]] for _ in range(3)]
        sym = [rng.integers(0, 2, BATCH, dtype=np.int32) for _ in range(3)]
        j_batches = [jw.buffers + (i, s) for i, s in zip(idx, sym)]
        t_batches = [tw.buffers + (i, s) for i, s in zip(idx, sym)]
        assert any(s.any() for s in sym) and any((~s.astype(bool)).any()
                                                 for s in sym)
        jnet.set_device_symmetries(JConnect4)
        jnet.set_device_window(True)
        net.set_device_symmetries(env)
        net.set_device_window(True)
    else:
        rows = [rng.permutation(40)[:BATCH] for _ in range(3)]
        j_batches = t_batches = [(obs[r], pi[r], value[r]) for r in rows]
    j_losses = jnet.train(j_batches, 3, iteration=1)
    t_losses = net.train(t_batches, 3, iteration=1)
    np.testing.assert_allclose(t_losses, j_losses, rtol=RTOL)
    assert net.step == 3 and not net.model.training

    want = resnet_state_dict(jax.device_get(jnet.state))
    got = net.model.state_dict()
    before = resnet_state_dict(variables)
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        moved += not torch.equal(w, before[k])
    assert moved == len(want)  # every param and statistic was trained
    # The momentum buffers: optax's trace against torch's buffers.
    trace = next(s.trace for s in jnet.state.opt_state if hasattr(s, "trace"))
    j_bufs = resnet_state_dict({"params": jax.device_get(trace),
                                "batch_stats": variables["batch_stats"]})
    for name, p in net.model.named_parameters():
        np.testing.assert_allclose(
            net.optimizer.state[p]["momentum_buffer"].numpy(),
            j_bufs[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)


def test_multistep_lr_matches_jax():
    for it in (0, 1, 74, 75, 76, 124, 125, 200):
        assert multistep_lr(0.01, [75, 125], 0.1, it) == \
            j_multistep(0.01, [75, 125], 0.1, it)
    net = NNetWrapper(get_env("connect4"), get_args(**SMALL), device="cpu")
    assert net.current_lr(80) == pytest.approx(1e-3)


def test_checkpoint_round_trip(tmp_path):
    """Weights, batch statistics, momentum buffers and the step count come
    back from a checkpoint, and the loaded net gives bit-equal outputs;
    a file that is not one of the port's checkpoints raises."""
    env = get_env("connect4")
    net = NNetWrapper(env, get_args(**SMALL, compute_dtype="float32"),
                      device="cpu")
    obs, pi, value = _samples(32, seed=2)
    net.train([(obs[:16], pi[:16], value[:16])], 2, iteration=0)
    net.save_checkpoint(str(tmp_path), "iteration-0001")
    back = NNetWrapper.from_checkpoint(env, str(tmp_path), "iteration-0001",
                                       device="cpu")
    assert back.step == net.step == 2
    for (k, x), y in zip(net.model.state_dict().items(),
                         back.model.state_dict().values()):
        assert torch.equal(x, y), k
    for x, y in zip(net.optimizer.state_dict()["state"].values(),
                    back.optimizer.state_dict()["state"].values()):
        assert torch.equal(x["momentum_buffer"], y["momentum_buffer"])
    o = torch.from_numpy(obs.astype(np.float32))
    for a, b in zip(net.process(o), back.process(o)):
        assert torch.equal(a, b)
    (tmp_path / "bad.ckpt").write_bytes(b"\x82\xa6params\x80")
    with pytest.raises(ValueError, match="not a checkpoint"):
        back.load_checkpoint(str(tmp_path), "bad")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inference_caches_follow_weight_changes(dtype):
    """Inference reuses the cast weights and BatchNorm scales; after a
    train step, and after a checkpoint load into a net that has already
    run inference, its outputs are those of a fresh net with the same
    weights."""
    env = get_env("connect4")
    args = get_args(**SMALL, compute_dtype=dtype)
    net = NNetWrapper(env, args, device="cpu")
    obs, pi, value = _samples(32, seed=5)
    o = torch.from_numpy(obs.astype(np.float32))

    def fresh_outputs(src):
        twin = NNetWrapper(env, args, device="cpu")
        twin.model.load_state_dict(src.model.state_dict())
        return twin.process(o)

    before = net.process(o)
    net.train([(obs[:16], pi[:16], value[:16])], 1, iteration=0)
    after = net.process(o)
    for a, b, c in zip(after, fresh_outputs(net), before):
        assert torch.equal(a, b) and not torch.equal(a, c)
    other = NNetWrapper(env, get_args(**SMALL, compute_dtype=dtype,
                                      seed=9), device="cpu")
    net.model.load_state_dict(other.model.state_dict())
    for a, b in zip(net.process(o), other.process(o)):
        assert torch.equal(a, b)
