from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, SHAPES_BY_NAME, TRAIN_4K,
    CNNConfig, ConvSpec, ModelConfig, ParallelConfig, ShapeConfig, shapes_for)
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS, all_configs, get_config, reduced_config)
