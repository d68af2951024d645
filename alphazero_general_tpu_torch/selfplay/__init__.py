from alphazero_general_tpu_torch.selfplay.selfplay import (  # noqa: F401
    MoveDraws,
    MoveRecord,
    SelfPlayConfig,
    SelfPlayState,
    densify_pi,
    init_selfplay,
    make_move_fns,
    make_play_chunk_fn,
    move_step,
    play_chunk,
)
