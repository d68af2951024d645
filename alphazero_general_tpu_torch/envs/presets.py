"""Per-env training presets — the port of
alphazero_general_tpu/envs/presets.py (all eight; nim3 has none, as in
the JAX package).
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

# tictactoe: small everything (reference: envs/tictactoe/train.py).
TICTACTOE = dict(
    run_name="tictactoe",
    process_batch_size=512,
    gamesPerIteration=2048,
    numMCTSSims=25,
    numFastSims=5,
    num_channels=32,
    depth=2,
    arenaCompare=128,
)

# othello 8x8 (reference: envs/othello/train.py).
OTHELLO = dict(
    run_name="othello",
    process_batch_size=1024,
    gamesPerIteration=4096,
    numMCTSSims=100,
    numFastSims=20,
    num_channels=64,
    depth=6,
    cpuct=2.0,
)

# gobang 15x15 (reference: envs/gobang/train.py).
GOBANG = dict(
    run_name="gobang",
    process_batch_size=512,
    gamesPerIteration=2048,
    numMCTSSims=100,
    numFastSims=20,
    num_channels=64,
    depth=6,
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

STRATEGO = dict(
    run_name="stratego",
    process_batch_size=512,
    gamesPerIteration=2048,
    numMCTSSims=100,
    numFastSims=20,
    num_channels=64,
    depth=8,
)

# chess (the reference's env is a stub; JAX envs/presets.py:108-124: defaults
# for the 4672-action space, not reference-tuned).
CHESS = dict(
    run_name="chess",
    process_batch_size=256,
    gamesPerIteration=1024,
    numMCTSSims=200,
    numFastSims=40,
    num_channels=128,
    depth=10,
    cpuct=2.5,
    fpu_reduction=0.4,
    symmetricSamples=False,
    value_dense_layers=[2048, 256],
    policy_dense_layers=[2048, 1024],
)

PRESETS = {
    "connect4": CONNECT4,
    "chess": CHESS,
    "tictactoe": TICTACTOE,
    "othello": OTHELLO,
    "gobang": GOBANG,
    "brandubh": BRANDUBH,
    "hnefatafl": HNEFATAFL,
    "stratego": STRATEGO,
}


def preset_args(env_name: str, **overrides) -> Args:
    base = dict(PRESETS.get(env_name, {}))
    base.update(overrides)
    return get_args(**base)
