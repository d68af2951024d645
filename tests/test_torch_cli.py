"""The port's training entry point and its config: ``cli.train.main``
runs a Coach cycle on the CPU from the connect4 preset cut by ``--set``
overrides, or from an args file the JAX package wrote, at the default
``quant_selfplay=True`` and with the FC net and GroupNorm; the args schema
and its JSON round trip match the JAX package's; and every knob that names
a path the port does not run raises instead of falling back."""

import json

import pytest
import torch

from alphazero_general_tpu.utils import config as JC
from alphazero_general_tpu_torch.cli import train as cli_train
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.models import NNetWrapper
from alphazero_general_tpu_torch.selfplay import selfplay as SP
from alphazero_general_tpu_torch.train import Coach
from alphazero_general_tpu_torch.utils import config as C
from test_torch_coach import TINY, _dirs

# Small tensors: one intra-op thread. Several test processes share the
# host's cores, and idle OpenMP threads that spin while waiting slow every
# process down many times over.
torch.set_num_threads(1)


def test_cli_train_runs_a_coach_cycle_on_cpu(tmp_path):
    """``python -m alphazero_general_tpu_torch.cli.train connect4`` with
    ``--set`` overrides and ``--device cpu`` writes checkpoints, samples
    and metrics; an ``--args-file`` saved by the JAX package loads too."""
    sets = [f"{k}={v!r}" for k, v in TINY.items() if k != "seed"]
    sets += [f"{k}={v}" for k, v in _dirs(str(tmp_path), "cli").items()]
    argv = ["connect4", "--device", "cpu"]
    for s in sets + ["numIters=1"]:
        argv += ["--set", s]
    assert cli_train.main(argv) == 0
    ckpt = tmp_path / "checkpoint" / "cli"
    assert sorted(p.name for p in ckpt.glob("*.ckpt")) == [
        "iteration-0000.ckpt", "iteration-0001.ckpt"]
    assert (tmp_path / "data" / "cli" / "iteration-0001.npz").is_file()
    tags = {json.loads(line)["tag"] for line in
            open(tmp_path / "runs" / "cli" / "metrics.jsonl")}
    assert {"loss/policy", "win_rate/baseline", "win_rate/past",
            "time/self_play", "time/train"} <= tags
    # The preset's width came through, cut by the overrides.
    saved = C.load_args_file(str(ckpt / "iteration-0001.json"))
    assert saved.cpuct == 4.0 and saved.num_channels == 8

    # An args file written by the JAX package.
    path = str(tmp_path / "jax_args.json")
    JC.save_args_file(JC.get_args(**dict(TINY, numIters=1),
                                  **_dirs(str(tmp_path), "cli2")), path)
    assert cli_train.main(["connect4", "--device", "cpu", "--args-file",
                           path]) == 0
    assert (tmp_path / "checkpoint" / "cli2" / "iteration-0001.ckpt") \
        .is_file()


def test_args_files_round_trip_between_packages(tmp_path):
    """Same keys and defaults as the JAX schema, and each package loads
    the other's args file, callables included."""
    assert set(C.get_args()) == set(JC.get_args())
    for key, value in JC.get_args().items():
        if not callable(value):
            assert C.get_args()[key] == value, key
    path = str(tmp_path / "a.json")
    JC.save_args_file(JC.get_args(temp_scaling_fn=JC.get_args()
                                  .temp_scaling_fn), path)
    loaded = C.load_args_file(path)
    from alphazero_general_tpu_torch.utils.misc import default_temp_scaling
    assert loaded.temp_scaling_fn is default_temp_scaling
    from alphazero_general_tpu_torch.utils.misc import const_temp_scaling
    C.save_args_file(C.get_args(temp_scaling_fn=const_temp_scaling), path)
    from alphazero_general_tpu.utils import misc as JM
    assert JC.load_args_file(path).temp_scaling_fn is JM.const_temp_scaling
    cfg = SP.SelfPlayConfig.from_args(C.load_args_file(path), 2, True)
    assert cfg.const_temp


@pytest.mark.parametrize("knob,raises", [
    (dict(leaf_batch=2), False), (dict(mesh_batch_axis=4), True),
], ids=["leaf_batch", "multi_device"])
def test_unported_knobs_raise(knob, raises, tmp_path):
    """More than one device raises in the Coach and in ``cli.train``;
    ``leaf_batch`` > 1 (multi-leaf rounds) is ported: the Coach takes it
    into its self-play config, and a cut ``cli.train`` cycle runs with
    it."""
    args = C.get_args(**dict(TINY, **knob), **_dirs(str(tmp_path), "x"))
    env = get_env("connect4")
    net = NNetWrapper(env, C.get_args(**TINY), device="cpu")
    argv = ["connect4", "--device", "cpu"]
    for k, v in knob.items():
        argv += ["--set", f"{k}={v!r}"]
    if raises:
        with pytest.raises(ValueError, match="not ported"):
            Coach(env, net, args)
        with pytest.raises(ValueError, match="not ported"):
            cli_train.main(argv)
        return
    assert Coach(env, net, args)._cfg.leaf_batch == knob["leaf_batch"]
    cut = {k: v for k, v in TINY.items() if k != "seed"}
    cut.update(numIters=1, numWarmupIters=0, numMCTSSims=6, numFastSims=3,
               **_dirs(str(tmp_path), "lb"))
    for k, v in cut.items():
        argv += ["--set", f"{k}={v!r}"]
    assert cli_train.main(argv) == 0
    assert (tmp_path / "data" / "lb" / "iteration-0001.npz").is_file()
    saved = C.load_args_file(str(tmp_path / "checkpoint" / "lb" /
                                 "iteration-0001.json"))
    assert saved.leaf_batch == knob["leaf_batch"]


@pytest.mark.parametrize("knob,int8", [
    (dict(quant_selfplay=True), True),
    (dict(quant_selfplay=True, nnet_type="fc", input_fc_layers=[16]), False),
    (dict(quant_selfplay=True, norm="groupnorm"), False),
], ids=["int8_default", "fc", "groupnorm"])
def test_cli_train_runs_every_architecture(knob, int8, tmp_path):
    """A cut cycle through ``cli.train.main`` (2 iterations, the first a
    warmup; 4 games, 3 / 2 simulations; an 8-channel one-block net; both
    arenas after iteration 1 only) under the JAX default
    ``quant_selfplay=True``: the ResNet plays the int8 tower in iteration
    2's self-play and in both arenas; the FC net and GroupNorm, which have
    no int8 path, play the float tower."""
    cut = {k: v for k, v in TINY.items() if k not in ("seed",
                                                      "quant_selfplay")}
    cut.update(numMCTSSims=3, numFastSims=2, numWarmupSims=2,
               baselineCompareFreq=2, pastCompareFreq=2, **knob)
    argv = ["connect4", "--device", "cpu"]
    for k, v in {**cut, **_dirs(str(tmp_path), "cli")}.items():
        argv += ["--set", f"{k}={v!r}"]
    assert cli_train.main(argv) == 0
    m = {}
    for line in open(tmp_path / "runs" / "cli" / "metrics.jsonl"):
        r = json.loads(line)
        m[(r["tag"], r["step"])] = r["value"]
    assert (m[("self_play/int8", 1)], m[("self_play/int8", 2)]) == (
        0.0, float(int8))
    for kind in ("baseline", "past"):
        assert m[(f"arena_{kind}/int8", 1)] == float(int8)
        assert (f"arena_{kind}/games", 2) not in m
    assert (tmp_path / "checkpoint" / "cli" / "iteration-0002.ckpt") \
        .is_file()
