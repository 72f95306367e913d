from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    ArchBundle,
    ModelConfig,
    ParallelConfig,
    get_config,
)
