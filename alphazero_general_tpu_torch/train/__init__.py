from alphazero_general_tpu_torch.train.coach import Coach, TrainState  # noqa: F401
