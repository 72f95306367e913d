from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    INPUT_SHAPES,
    ArchBundle,
    InputShape,
    ModelConfig,
    ParallelConfig,
    get_config,
)
