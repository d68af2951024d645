from alphazero_general_tpu_torch.models.architectures import ResNet, build_model  # noqa: F401
from alphazero_general_tpu_torch.models.wrapper import NNetWrapper  # noqa: F401
