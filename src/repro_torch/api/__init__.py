"""repro_torch.api — the declarative experiment surface.

Counterpart of ``repro.api``.  One spec (:class:`ExperimentSpec`, a
frozen, JSON-round-trippable tree of sub-specs whose JSON is the
reference's), one entry point (:func:`build`), one step contract
(``engine.step(EngineState, batch, key) -> (EngineState, metrics)``).  New
backends register against the string-keyed registries in
:mod:`repro_torch.api.build`; the Section-IV variants
(:mod:`repro_torch.core.variants`) register themselves as named presets,
resolved through :func:`get_preset` / the launchers' ``--preset`` flag.
"""
from repro_torch.api.spec import (  # noqa: F401
    AsyncSpec,
    AttackSpec,
    CompressionSpec,
    DataSpec,
    ExperimentSpec,
    GraphSpec,
    MixerSpec,
    ModelSpec,
    OptimizerSpec,
    ParticipationSpec,
    PRESETS,
    PrivacySpec,
    Registry,
    RunSpec,
    TopologySpec,
)
from repro_torch.api.build import (  # noqa: F401
    ATTACKS,
    COMPRESSORS,
    DATASETS,
    GRAPHS,
    MIXERS,
    MODELS,
    ModelBundle,
    OPTIMIZERS,
    PARTICIPATION,
    TOPOLOGIES,
    build,
)
from repro_torch.api.cli import (  # noqa: F401
    add_spec_args,
    get_preset,
    preset_names,
    spec_from_args,
)
from repro_torch.core.state import EngineState  # noqa: F401
