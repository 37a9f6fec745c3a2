from repro_torch.configs.base import CNNConfig, ConvSpec  # noqa: F401
