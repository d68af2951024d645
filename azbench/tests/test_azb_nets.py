"""The reference networks found by ``nnet_type`` (``registry.network``):
the ResNet's weights, names, outputs and operations as they were pinned
before the network moved behind that seam, and the port's fully connected
network as a second network that runs through the same drivers, checks and
counting with no other file changed."""

import hashlib
import re
from pathlib import Path

import pytest
import torch

from azbench import counting, program as P, registry, weights
from azbench.reference import rules_module
from azbench.reference.nets import fc
from azbench.tests import tiny

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 11
CPU = torch.device("cpu")

#: Taken on the CPU from the harness before its network moved behind
#: ``registry.network``: the connect4 weights of ``SEED`` (names, shapes,
#: kinds and values in order), the program's key of each weight in that
#: order, and the program's state dict after the load.
WEIGHTS_SHA = "c8302dee4cf9624cdf184775378b8e41d8fab67b7dc85e84d887441b48fd53f1"
NAMES_SHA = "10a51ae9ef6b8a95a89404b3ff3705ff89d4c09924bed87d34e39357559d7bfc"
STATE_SHA = "7204da60b69a3493b00d4910363ca0e48554b645d7217d89262fb84f281cebe0"


def _c4():
    cfg = registry.config("connect4")
    return cfg, weights.make(cfg, SEED, CPU)


def test_resnet_weights_are_those_pinned():
    cfg, W = _c4()
    h = hashlib.sha256()
    layout = registry.network(cfg).layout(cfg)
    assert list(W) == [name for name, _, _ in layout]
    for (name, x), (_, shape, kind) in zip(W.items(), layout):
        assert tuple(x.shape) == tuple(shape)
        h.update(f"{name}:{tuple(x.shape)}:{kind};".encode())
        h.update(x.numpy().tobytes())
    assert h.hexdigest() == WEIGHTS_SHA


def test_resnet_loads_strictly_under_the_pinned_names():
    cfg, W = _c4()
    names = registry.network(cfg).program_names(cfg)
    assert hashlib.sha256(repr([(k, names[k]) for k in W]).encode()
                          ).hexdigest() == NAMES_SHA
    wr = P.wrapper(P.env(cfg), P.args(cfg), CPU, W, cfg)
    sd = wr.model.state_dict()
    assert set(sd) == set(names.values())
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].float().numpy().tobytes())
    assert h.hexdigest() == STATE_SHA


def test_resnet_reference_outputs_are_those_pinned():
    """The float32 and int8 reference on random playouts: sums taken from
    the harness before the move (float32 rounding room only)."""
    cfg, W = _c4()
    net = registry.network(cfg)
    obs = rules_module(cfg).playouts(
        8, 12, torch.Generator().manual_seed(7), CPU)["obs"]
    actions = torch.arange(cfg["action_size"], dtype=torch.float64)
    pi, v = net.evaluate(W, obs, cfg)
    maxima = net.calibration_maxima(W, obs, cfg)
    pi8, v8 = net.evaluate(W, obs, cfg, tower_levels=127, maxima=maxima)
    got = [float((pi.double() * actions).sum()), float(v[:, 0].double().sum()),
           float((pi8.double() * actions).sum()),
           float(v8[:, 0].double().sum()), float(maxima.double().sum())]
    assert got == pytest.approx([286.4180971160531, 9.839850656688213,
                                 286.4668221306056, 9.921236112713814,
                                 52.71180522441864], rel=1e-6)


def test_resnet_least_time_is_the_pinned_one():
    cfg = registry.config("connect4")
    assert registry.network(cfg).ops(cfg) == {"tower": 198180864,
                                              "other": 7120384}
    assert counting.forward_least_s(cfg, 655360, "int8") == pytest.approx(
        0.07034732645975642, rel=1e-12)


def test_a_network_without_a_module_is_a_clear_error():
    cfg = registry.config("connect4")
    cfg["args"]["nnet_type"] = "nested_bottleneck"
    with pytest.raises(FileNotFoundError,
                       match=r"nnet_type 'nested_bottleneck'.*"
                             r"reference/nets/nested_bottleneck\.py"):
        registry.network(cfg)


def test_fc_operations_by_hand():
    cfg = tiny.context("c4.play", nnet_type="fc").cfg
    trunk = 2 * (168 * 32 + 32 * 32 + 32 * 32)
    heads = 2 * (32 * 16 + 16 * 3) + 2 * (32 * 16 + 16 * 7)
    assert fc.ops(cfg) == {"tower": trunk, "other": heads}
    assert counting.forward_least_s(cfg, 10, "bfloat16") == pytest.approx(
        10 * (trunk + heads) / 989e12)


@pytest.mark.parametrize("cell", ["c4.selfplay", "c4.play"])
def test_fc_runs_through_the_drivers_and_agrees(cell):
    ctx = tiny.context(cell, seconds=0.3, nnet_type="fc")
    res, correct = tiny.run(ctx)
    assert correct, res.checks
    assert res.attempted >= 2
    wr = P.wrapper(P.env(ctx.cfg), P.args(ctx.cfg), CPU,
                   weights.make(ctx.cfg, SEED, CPU), ctx.cfg)
    assert type(wr.model).__name__ == "FullyConnected"


def _fc_trunk_names_swapped(monkeypatch):
    real = fc.program_names

    def names(cfg):
        out = dict(real(cfg))
        out["fc1.weight"], out["fc2.weight"] = (out["fc2.weight"],
                                                out["fc1.weight"])
        return out

    monkeypatch.setattr(fc, "program_names", names)


def _fc_weight_transposed(monkeypatch):
    real = P.wrapper

    def wrapper(*a, **k):
        wr = real(*a, **k)
        w = wr.model.input_layers[1].weight
        w.data = w.data.t().contiguous()
        return wr

    monkeypatch.setattr(P, "wrapper", wrapper)


@pytest.mark.parametrize("fault", [_fc_trunk_names_swapped,
                                   _fc_weight_transposed],
                         ids=lambda f: f.__name__[1:])
def test_fc_fault_is_caught(monkeypatch, fault):
    """In the player's mix, whose limits are a bfloat16 network's. (The
    self-play mix's limits are an int8 tower's, against an int4 control,
    and are wider than these faults read at the tiny width.)"""
    fault(monkeypatch)
    res, correct = tiny.run(tiny.context("c4.play", seconds=0.3,
                                         nnet_type="fc"))
    assert not correct, res.checks


#: What names a part of one network: the ResNet's weight names and its
#: operation count. Only its module under ``reference/nets/`` may.
NETWORK_PARTS = re.compile(r"stem\.|vhead|phead|\"block|resnet_ops")


@pytest.mark.parametrize(
    "path", [p for p in sorted(HERE.rglob("*.py"))
             if "nets" not in p.relative_to(HERE).parts
             and "tests" not in p.relative_to(HERE).parts],
    ids=lambda p: str(p.relative_to(HERE)))
def test_no_network_part_outside_its_module(path):
    assert not NETWORK_PARTS.search(path.read_text())
