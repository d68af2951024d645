"""Players and the live evaluator (the port of alphazero_general_tpu/
players/)."""

from alphazero_general_tpu_torch.players.players import (  # noqa: F401
    BasePlayer,
    GreedyValuePlayer,
    HumanConsolePlayer,
    MCTSPlayer,
    NativeRawMCTSPlayer,
    NNPlayer,
    OneStepLookaheadPlayer,
    RandomPlayer,
    RawMCTSPlayer,
)
