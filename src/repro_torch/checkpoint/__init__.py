from repro_torch.checkpoint.store import (  # noqa: F401
    load_checkpoint,
    load_meta,
    save_checkpoint,
)
