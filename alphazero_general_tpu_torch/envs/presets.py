"""Per-env training presets — the port of
alphazero_general_tpu/envs/presets.py, for the envs the port has.

connect4's production config (reference: envs/connect4/train.py:11-51),
and the tafl variants' (JAX envs/presets.py:73-96).
"""

from __future__ import annotations

from alphazero_general_tpu_torch.utils.config import Args, get_args

CONNECT4 = dict(
    run_name="connect4",
    numWarmupIters=1,
    process_batch_size=2048,
    train_batch_size=1024,
    gamesPerIteration=8192,
    numMCTSSims=200,
    numFastSims=40,
    probFastSim=0.75,
    arenaCompareBaseline=512,
    arenaCompare=512,
    arenaTemp=1.0,
    cpuct=4.0,
    fpu_reduction=0.4,
    lr=0.01,
    num_channels=128,
    depth=8,
    value_head_channels=32,
    policy_head_channels=32,
    value_dense_layers=[1024, 256],
    policy_dense_layers=[1024],
    scheduler_args=Args(milestones=[75, 150], gamma=0.1),
)

# brandubh 7x7 tafl (reference: envs/hnefatafl/train_brandubh.py).
BRANDUBH = dict(
    run_name="brandubh",
    process_batch_size=1024,
    gamesPerIteration=4096,
    numMCTSSims=150,
    numFastSims=30,
    num_channels=128,
    depth=10,
    value_dense_layers=[2048, 256],
    policy_dense_layers=[2048, 512],
)

# hnefatafl 11x11 (reference: envs/hnefatafl/train_fastafl.py:50-51).
HNEFATAFL = dict(
    run_name="hnefatafl",
    process_batch_size=512,
    gamesPerIteration=2048,
    numMCTSSims=250,
    numFastSims=50,
    num_channels=128,
    depth=10,
    value_dense_layers=[2048, 256],
    policy_dense_layers=[2048, 512],
)

PRESETS = {"connect4": CONNECT4, "brandubh": BRANDUBH,
           "hnefatafl": HNEFATAFL}


def preset_args(env_name: str, **overrides) -> Args:
    base = dict(PRESETS.get(env_name, {}))
    base.update(overrides)
    return get_args(**base)
