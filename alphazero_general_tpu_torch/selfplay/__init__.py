from alphazero_general_tpu_torch.selfplay.selfplay import (  # noqa: F401
    MoveDraws,
    MoveRecord,
    SelfPlayConfig,
    SelfPlayState,
    densify_pi,
    init_selfplay,
    make_move_fns,
    move_step,
)
