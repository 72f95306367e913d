from repro_torch.checkpoint.store import (  # noqa: F401
    load_checkpoint,
    load_experiment,
    load_meta,
    load_spec,
    save_checkpoint,
    save_experiment,
)
