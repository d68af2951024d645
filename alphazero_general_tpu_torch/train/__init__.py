from alphazero_general_tpu_torch.train.coach import Coach  # noqa: F401
