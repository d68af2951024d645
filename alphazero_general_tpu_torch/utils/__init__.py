from alphazero_general_tpu_torch.utils.config import Args, get_args  # noqa: F401
