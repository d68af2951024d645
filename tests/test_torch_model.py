"""The port's networks against the JAX package's (the ResNet with BatchNorm
or GroupNorm, and the FC net), on weights initialised by the JAX wrapper
and converted with utils/convert.py.

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
    """What has no running statistics is refused by the int8 path only:
    GroupNorm and the FC net build and run, and ``quantized_inference``
    raises for them. BatchNorm trains (tests/test_torch_train.py holds it
    against flax's): in training mode it normalises with the batch's
    statistics and moves its running ones."""
    env = get_env("connect4")
    for knob in (dict(norm="groupnorm"), dict(nnet_type="fc")):
        other = NNetWrapper(env, get_args(**SMALL, **knob), device="cpu")
        assert not any("running" in k for k in other.model.state_dict())
        pi, v = other.process(torch.from_numpy(observations(4)))
        assert pi.shape == (4, 7) and v.shape == (4, 3)
        with pytest.raises(ValueError, match="ResNet only|batchnorm"):
            other.quantized_inference()
    net = NNetWrapper(env, get_args(**SMALL), device="cpu")
    net.model.train()
    before = net.model.stem_norm.running_mean.clone()
    net.model(torch.from_numpy(observations(4)))
    assert not torch.equal(net.model.stem_norm.running_mean, before)

#: The JAX package's other architectures at small widths: GroupNorm over
#: groups of min(16, C) channels (16 and 4 here), and the FC net.
OTHER_NETS = {
    "groupnorm": dict(SMALL, norm="groupnorm", value_head_channels=4),
    "fc": dict(SMALL, nnet_type="fc", input_fc_layers=[64, 32]),
}


def jax_and_port_other(kind: str, dtype: str = "float32", seed: int = 0,
                       **extra):
    """A JAX and a port wrapper of ``OTHER_NETS[kind]`` (and ``extra``
    args) holding the same weights; GroupNorm scales and biases randomised
    first."""
    knobs = dict(OTHER_NETS[kind], compute_dtype=dtype, seed=seed, **extra)
    jnet = JWrapper(j_get_env("connect4"), j_get_args(**knobs))
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(np.array, jnet.state.variables)

    def walk(params):
        for k, sub in params.items():
            if k == "GroupNorm_0":
                c = sub["scale"].shape[0]
                sub["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                sub["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub)

    walk(variables["params"])
    jnet.state = jnet.state.replace(params=jax.tree_util.tree_map(
        jnp.asarray, variables["params"]))
    net = NNetWrapper(get_env("connect4"), get_args(**knobs), device="cpu")
    net.load_jax_variables(variables)
    return jnet, variables, net


@pytest.mark.parametrize("kind", sorted(OTHER_NETS))
def test_other_architectures_match_jax(kind):
    """Eval forward of GroupNorm and FC nets, float32: rtol 1e-4, atol
    1e-5, as the BatchNorm ResNet's."""
    jnet, variables, net = jax_and_port_other(kind)
    obs = observations()
    want = jnet.model.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                            jnp.asarray(obs), train=False)
    with torch.inference_mode():
        got = net.model(torch.from_numpy(obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_groupnorm_matches_flax_groupnorm():
    """The layer alone against ``flax.linen.GroupNorm`` as the JAX package
    builds it (group_size=min(16, C), epsilon 1e-6), float32 and bfloat16
    inputs, with an offset mean so that E[x^2] - E[x]^2 is exercised."""
    from flax import linen as fnn
    from alphazero_general_tpu_torch.models.architectures import GroupNorm

    rng = np.random.default_rng(1)
    for c, dtype in ((32, jnp.float32), (4, jnp.float32), (32, jnp.bfloat16)):
        x = (rng.standard_normal((5, 6, 7, c)) * 2 + 3).astype(np.float32)
        layer = fnn.GroupNorm(num_groups=None, group_size=min(16, c),
                              dtype=dtype, param_dtype=jnp.float32)
        params = {"params": {
            "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.normal(0, 0.2, c).astype(np.float32)}}
        xj = jnp.asarray(x).astype(dtype)
        want = np.asarray(layer.apply(params, xj).astype(jnp.float32))
        gn = GroupNorm(c)
        gn.load_state_dict({"weight": torch.from_numpy(
            params["params"]["scale"]), "bias": torch.from_numpy(
            params["params"]["bias"])})
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
            torch.float32 if dtype == jnp.float32 else torch.bfloat16)
        with torch.no_grad():
            got = gn(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()
        # bf16: the outputs round to bf16 on both sides; one ulp apart at
        # most (2^-7 relative to values of magnitude up to 4).
        tol = (1e-5, 1e-4) if dtype == jnp.float32 else (2**-7 * 4, 0)
        np.testing.assert_allclose(got.numpy(), want, atol=tol[0],
                                   rtol=tol[1])


@pytest.mark.parametrize("kind", sorted(OTHER_NETS))
def test_other_architectures_train_like_jax(kind):
    """Two SGD steps (momentum 0.9, weight decay, float32) of each
    package's wrapper from the same weights on the same batch: the
    parameters agree within rtol 1e-4, atol 1e-5."""
    from alphazero_general_tpu_torch.utils.convert import state_dict_from_jax

    jnet2, _, net2 = jax_and_port_other(
        kind, seed=2, optimizer_args=dict(momentum=0.9, weight_decay=1e-4))
    rng = np.random.default_rng(3)
    obs = observations(16, seed=3)
    pi = rng.dirichlet(np.ones(7), 16).astype(np.float32)
    value = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    jnet2.train([(obs, pi, value)], 2)
    net2.train([(obs, pi, value)], 2)
    want = state_dict_from_jax(jax.device_get(jnet2.state))
    got = net2.model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
