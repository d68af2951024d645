"""The port's ResNet against the JAX ResNet, on weights initialised by the
JAX wrapper and converted with utils/convert.py.

BatchNorm statistics, scales and biases are replaced by random non-trivial
values first, so that the conversion of ``batch_stats`` is really tested.
float32: log-policy and log-value within rtol 1e-4, atol 1e-5 (summation
order differs between XLA's and PyTorch's CPU convolutions). bfloat16: the
two frameworks round activations to bfloat16 at different places (e.g. a
dense layer's bias is added before or after the rounding), so the outputs
agree to about one bfloat16 ulp of the logits: atol 0.02, against an ulp of
2^-6 ≈ 0.016 for logits of magnitude 2 to 4 as here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_general_tpu.envs import get_env as j_get_env
from alphazero_general_tpu.models.wrapper import NNetWrapper as JWrapper
from alphazero_general_tpu.utils.config import get_args as j_get_args
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.models import NNetWrapper
from alphazero_general_tpu_torch.utils import get_args

SMALL = dict(num_channels=16, depth=2, value_head_channels=4,
             policy_head_channels=4, value_dense_layers=[32],
             policy_dense_layers=[32])


def randomize_norms(variables, seed=0):
    """Random BatchNorm scale/bias/mean/var (var > 0) in a flax variable
    tree, returned as numpy leaves."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.array, variables)

    def walk(params, stats):
        for k in params:
            if k == "BatchNorm_0":
                c = params[k]["scale"].shape[0]
                params[k]["scale"] = rng.uniform(0.5, 1.5, c).astype(
                    np.float32)
                params[k]["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
                stats[k]["mean"] = rng.normal(0, 0.3, c).astype(np.float32)
                stats[k]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif k in stats:
                walk(params[k], stats[k])

    walk(out["params"], out["batch_stats"])
    return out


def jax_and_port(dtype: str, seed: int = 0, env_name: str = "connect4"):
    """A JAX wrapper and a port wrapper of the env ``env_name`` holding the
    same converted weights."""
    jnet = JWrapper(j_get_env(env_name),
                    j_get_args(compute_dtype=dtype, seed=seed, **SMALL))
    variables = randomize_norms(jnet.state.variables, seed)
    net = NNetWrapper(get_env(env_name),
                      get_args(compute_dtype=dtype, **SMALL), device="cpu")
    net.load_jax_variables(variables)
    return jnet, variables, net


def observations(batch=32, seed=0):
    env = get_env("connect4")
    rng = np.random.default_rng(seed)
    s = env.init(batch, device="cpu")
    for _ in range(12):
        valid = env.valid_moves(s).numpy()
        a = np.array([rng.choice(np.flatnonzero(v)) for v in valid])
        s = env.step(s, torch.from_numpy(a))
    return env.observation(s).numpy()


@pytest.mark.parametrize("dtype,rtol,atol", [
    ("float32", 1e-4, 1e-5),
    ("bfloat16", 0.0, 0.02),
])
def test_resnet_matches_jax(dtype, rtol, atol):
    jnet, variables, net = jax_and_port(dtype)
    obs = observations()
    j_logp, j_logv = jnet.model.apply(variables, jnp.asarray(obs),
                                      train=False)
    with torch.inference_mode():
        logp, logv = net.model(torch.from_numpy(obs))
    assert logp.dtype == logv.dtype == torch.float32
    np.testing.assert_allclose(logp.numpy(), np.asarray(j_logp), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(logv.numpy(), np.asarray(j_logv), rtol=rtol,
                               atol=atol)


def test_converted_state_dict_is_complete_and_used():
    _, variables, net = jax_and_port("float32", seed=3)
    sd = net.model.state_dict()
    # Every BatchNorm buffer came from the randomized flax batch_stats.
    mean = variables["batch_stats"]["ResidualBlock_1"]["Norm_1"][
        "BatchNorm_0"]["mean"]
    np.testing.assert_array_equal(sd["blocks.1.norm2.running_mean"].numpy(),
                                  mean)
    assert not torch.allclose(sd["stem_norm.running_var"],
                              torch.ones_like(sd["stem_norm.running_var"]))
    # Policy/value probabilities are proper distributions.
    pi, v = net.process(torch.from_numpy(observations(8, seed=1)))
    assert pi.shape == (8, 7) and v.shape == (8, 3)
    assert torch.allclose(pi.sum(-1), torch.ones(8), atol=1e-5)
    assert torch.allclose(v.sum(-1), torch.ones(8), atol=1e-5)


def test_training_mode_norm_is_refused():
    """Training-mode normalisation the port does not have is refused:
    GroupNorm (and the FC net) raise when built. BatchNorm trains
    (tests/test_torch_train.py holds it against flax's): in training mode
    it normalises with the batch's statistics and moves its running ones."""
    env = get_env("connect4")
    for knob in (dict(norm="groupnorm"), dict(nnet_type="fc")):
        with pytest.raises(ValueError, match="not ported"):
            NNetWrapper(env, get_args(**SMALL, **knob), device="cpu")
    net = NNetWrapper(env, get_args(**SMALL), device="cpu")
    net.model.train()
    before = net.model.stem_norm.running_mean.clone()
    net.model(torch.from_numpy(observations(4)))
    assert not torch.equal(net.model.stem_norm.running_mean, before)