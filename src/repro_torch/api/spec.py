"""ExperimentSpec — the declarative description of one Algorithm-1 run.

Counterpart of ``repro.api.spec``: the same dataclasses, field names,
defaults and JSON, so ``to_json()`` is byte-equal to the reference's for
the same spec and a spec written by either package loads into the other.

Every experiment the repo can run is one frozen, JSON-round-trippable tree
of sub-specs:

    ExperimentSpec
      ├─ TopologySpec        which base graph backs the combination matrix A
      ├─ GraphSpec           how that graph varies over time (core/graphs.py:
      │                      static | link_dropout | gossip | tv_erdos)
      ├─ ParticipationSpec   the agent-availability model (eq. 18 default)
      ├─ MixerSpec           combination-step backend (core/mixing.py)
      ├─ CompressionSpec     wire compressor + exchange mode (CommPipeline)
      ├─ AttackSpec          Byzantine gradient adversaries (core/attacks.py)
      ├─ OptimizerSpec       local-update gradient transform
      ├─ ModelSpec           what the agents train (transformer arch or an
      │                      externally supplied loss)
      ├─ DataSpec            who holds which data: the per-agent sampling /
      │                      partitioning law (IID streams | Dirichlet
      │                      label skew | contiguous shards)
      ├─ AsyncSpec           event-driven execution: per-agent clocks,
      │                      staleness cap, age-discount law
      ├─ PrivacySpec         differential privacy: clip + noise on the
      │                      grad_transform seam, RDP accountant,
      │                      secure-agg wire masks (core/privacy.py)
      └─ RunSpec             scalar hyper-parameters (K, T, mu, ...) and
                             driver settings (blocks, batch, seed)

Each sub-spec selects its implementation through a string ``kind`` resolved
against a :class:`Registry` in :mod:`repro_torch.api.build` — registering a new
backend is one ``@REGISTRY.register("name")`` decorator, and every CLI,
checkpoint, and test picks it up through the same spec field.  The spec is
pure data (no torch / no model imports): hash it, diff it, store it next
to the checkpoint (:func:`repro_torch.checkpoint.save_experiment`), rebuild
the exact engine from it (:func:`repro_torch.api.build`).

Round trip: ``spec == ExperimentSpec.from_json(spec.to_json())`` exactly
(tested per preset in ``tests/test_torch_api.py``, against the reference's
JSON).
"""

import dataclasses
import json
from typing import Any, Optional, Union

__all__ = [
    "Registry",
    "TopologySpec",
    "GraphSpec",
    "ParticipationSpec",
    "MixerSpec",
    "CompressionSpec",
    "AttackSpec",
    "OptimizerSpec",
    "ModelSpec",
    "DataSpec",
    "AsyncSpec",
    "PrivacySpec",
    "RunSpec",
    "ExperimentSpec",
    "PRESETS",
]


class Registry:
    """String-keyed implementation registry behind one spec ``kind`` field.

    >>> MIXERS = Registry("mixer")
    >>> @MIXERS.register("dense")
    ... def _build_dense(spec, topology, num_agents): ...

    Unknown keys fail with the full list of registered alternatives —
    misspelled spec fields and JSON files must not die in a KeyError three
    layers down.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, Any] = {}

    def register(self, name: str):
        def deco(fn):
            if name in self._entries:
                raise ValueError(
                    f"{self.kind} {name!r} is already registered")
            self._entries[name] = fn
            return fn
        return deco

    def get(self, name: str):
        try:
            return self._entries[name]
        except KeyError:
            raise ValueError(
                f"unknown {self.kind} kind {name!r} — registered "
                f"{self.kind} kinds: {sorted(self._entries)}") from None

    def names(self) -> tuple:
        return tuple(sorted(self._entries))

    def __contains__(self, name: str) -> bool:
        return name in self._entries


#: named experiment presets (the Section-IV variants factories register
#: here; resolve through :func:`repro_torch.api.get_preset`, which imports
#: them)
PRESETS = Registry("preset")


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Graph behind the base combination matrix A (core/topology.py)."""

    kind: str = "ring"           # ring|grid|full|fedavg|erdos|<registered>
    kwargs: tuple = ()           # extra make_topology kwargs, sorted (k, v)


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Time variation of the combination graph (core/graphs.py).

    ``kind="static"`` wraps the base topology (bit-identical to the
    pre-redesign baked-A path); the dynamic kinds sample a fresh
    symmetric doubly-stochastic matrix every block.
    """

    kind: str = "static"         # static|link_dropout|gossip|tv_erdos|
                                 # <registered>
    drop: float = 0.3            # link_dropout: per-block edge failure prob
    corr: float = 0.0            # link_dropout: link-outage autocorrelation
    p: float = 0.3               # tv_erdos: per-block edge probability


@dataclasses.dataclass(frozen=True)
class ParticipationSpec:
    """Agent-availability model (core/schedules.py)."""

    kind: str = "iid"            # iid|markov|cyclic|<registered>
    q: Any = 1.0                 # activation probability (scalar or tuple)
    corr: float = 0.5            # markov: availability autocorrelation
    num_groups: int = 2          # cyclic: round-robin group count


@dataclasses.dataclass(frozen=True)
class MixerSpec:
    """Combination-step backend (core/mixing.py)."""

    kind: str = "dense"          # dense|sparse|pallas|gather|auto|none|
                                 # trimmed_mean|median|adaptive_trim|
                                 # <registered>
    tile_m: int = 512            # pallas tile
    interpret: Optional[bool] = None   # pallas interpret override
    trim: int = 1                # trimmed_mean: per-side trim count;
                                 # adaptive_trim: per-side trim CAP
    scope: str = "global"        # robust backends: global (SLSGD server)
                                 # | neighborhood (realized A_t support)
    gather: str = "auto"         # neighborhood scope: bounded-degree
                                 # policy — auto|table|fused|off


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Wire compressor + exchange mode (core/compression.py, CommPipeline)."""

    kind: str = "none"           # none|topk|randk|int8|gauss|<registered>
    ratio: float = 1.0           # kept fraction (topk/randk/gauss)
    sigma: float = 0.0           # Gaussian-mask noise scale
    error_feedback: bool = False
    mode: str = "auto"           # auto|identity|direct|diff
    gamma: Union[float, str, None] = None  # consensus step: float fixed,
                                 # None legacy heuristic, "auto" spectral-
                                 # gap floor + observed-contraction anneal
    ef_host_offload: bool = False  # park the error-feedback residual in
                                 # host memory between blocks (sharded
                                 # engine; no-op where the backend has no
                                 # distinct host memory space)


@dataclasses.dataclass(frozen=True)
class AttackSpec:
    """Byzantine gradient adversaries (core/attacks.py).

    ``kind="none"`` is the honest network; the attack kinds corrupt the
    local-update gradients of the Byzantine agents only (evenly spaced by
    default, or the explicit ``agents`` tuple), composing in front of the
    optimizer spec's transform.  The defense is selected independently on
    the mixer spec (robust kinds + ``scope``).
    """

    kind: str = "none"           # none|sign_flip|noise|shift|<registered>
    num_byzantine: int = 1       # adversary count (evenly spaced)
    scale: float = 1.0           # attack magnitude (see core/attacks.py)
    agents: tuple = ()           # explicit adversary indices (overrides
                                 # num_byzantine placement)
    seed: int = 0                # "noise" adversary PRNG seed


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Local-update gradient transform (repro_torch/optim)."""

    kind: str = "sgd"            # sgd|momentum|adam|<registered>
    kwargs: tuple = ()           # transform kwargs, sorted (k, v)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """What the agents train.

    ``kind="transformer"`` resolves ``arch`` through repro_torch.configs
    and trains the repo's transformer family; ``kind="external"`` means
    the caller supplies ``loss_fn`` to :func:`repro_torch.api.build` (the
    regression / theory workloads of the paper figures).
    """

    kind: str = "external"       # external|transformer|<registered>
    arch: str = "smollm-360m"
    smoke: bool = True


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Who holds which data: the per-agent sampling / partitioning law
    (data/pipeline.py, data/synthetic.py; compiled by the ``DATASETS``
    registry in :mod:`repro_torch.api.build`).

    ``kind="iid"`` is the legacy fresh-random stream — bit-identical to the
    pre-DataSpec inline samplers on the same key stream (parity-gated).
    The heterogeneous kinds are *index-replayable*: block ``i`` for agent
    ``k`` is a pure function of ``(seed, i, k)`` (the
    :class:`repro_torch.data.pipeline.BlockIterator` design), so checkpoint
    resume replays the exact stream with no data-state files.

    * ``dirichlet`` — label/cluster skew at concentration ``alpha`` (Hsu
      et al.): each agent's local distribution is a Dirichlet(alpha) draw
      over latent classes.  ``alpha -> inf`` recovers IID-like mixing,
      ``alpha -> 0`` gives one-class agents.
    * ``shards`` — contiguous disjoint shards (``shards_per_agent`` per
      agent), the classic FedAvg pathological split; drives the LM token
      path through :class:`repro_torch.data.pipeline.TokenDataset`.
    """

    kind: str = "iid"            # iid|dirichlet|shards|<registered>
    alpha: float = 1.0           # dirichlet: concentration over classes
    shards_per_agent: int = 1    # shards: contiguous shards per agent
    seed: int = 0                # partition + per-(block, agent) draw seed
    clusters: int = 4            # dirichlet: latent classes (regression)
    samples_per_agent: int = 0   # per-agent local dataset size; 0 = the
                                 # workload default (N for regression)
    corpus_tokens: int = 65536   # LM shard kinds: synthetic corpus length


@dataclasses.dataclass(frozen=True)
class AsyncSpec:
    """Event-driven execution model (core/async_engine.py).

    ``enabled=False`` is the bulk-synchronous default (both classic
    engines).  When enabled (or ``engine="async"`` is requested from
    :func:`repro_torch.api.build`), each agent carries a local clock whose
    event times arrive at a per-agent rate: within a block an agent
    *fires* iff its participation draw succeeds AND its thinned clock
    ticks, runs its local updates, and combines against the
    *last-received* neighbor iterates from a bounded-degree staleness
    buffer with age-discounted weights (Rizk/Yuan/Sayed, arXiv
    2402.05529).  At ``tau_max=0`` with uniform rates every buffered
    iterate is fresh and the engine reduces exactly to the synchronous
    eq.-20 combination.
    """

    enabled: bool = False
    rates: Any = 1.0             # per-agent event rates (scalar or tuple);
                                 # ignored when rate_dist="lognormal"
    rate_dist: str = "uniform"   # uniform|lognormal (straggler simulation:
                                 # delay_k ~ LogNormal(0, rate_sigma),
                                 # rate_k = 1/delay_k)
    rate_sigma: float = 0.0      # lognormal: log-std of per-agent delays
    rate_seed: int = 0           # lognormal: delay-draw seed
    tau_max: int = 16            # staleness cap: buffered iterates older
                                 # than tau_max events get zero weight
    discount: str = "exp"        # age-discount law — none|exp|poly
    discount_rate: float = 0.1   # exp: e^(-rate*age); poly: (1+age)^-rate


@dataclasses.dataclass(frozen=True)
class PrivacySpec:
    """Differential-privacy tier (core/privacy.py).

    ``enabled=False`` is the non-private default (bit-identical to every
    pre-privacy configuration).  When enabled, each agent's local-update
    gradient is L2-clipped to ``clip`` and Gaussian-noised at std
    ``noise_multiplier * clip`` on the grad_transform seam — at EVERY
    one of the ``run.local_steps`` local steps — and an RDP accountant
    in ``EngineState.privacy_state`` tracks the spent epsilon at the
    *realized* per-block participation rate (partial participation is
    the subsampling event), composing ``local_steps`` mechanism
    invocations per block.  Requires a homogeneous participation rate
    (the single tracked epsilon is a per-agent guarantee only when all
    agents share one rate; heterogeneous ``q`` vectors are rejected in
    ``build()``).  Exactly one of ``noise_multiplier`` / ``epsilon``
    must be positive to drive the mechanism: a positive
    ``noise_multiplier`` is used as given (``epsilon`` then only sets
    the budget ``train`` halts at), otherwise the noise multiplier is
    derived from the ``epsilon`` budget over
    ``run.blocks * run.local_steps`` invocations.  With ``secure_agg``
    the combination step runs through pairwise-canceling per-edge wire
    masks (identity-mode linear pipelines only)."""

    enabled: bool = False
    epsilon: float = 0.0         # budget (and calibration target when
                                 # noise_multiplier is 0); 0 = no budget
    delta: float = 1e-5          # the (epsilon, delta)-DP delta
    clip: float = 1.0            # per-agent L2 clip norm
    noise_multiplier: float = 0.0  # noise std / clip; 0 = derive from
                                 # epsilon over run.blocks
    secure_agg: bool = False     # pairwise-canceling wire masks
    mask_scale: float = 1.0      # secure-agg mask std
    seed: int = 0                # noise + mask PRNG seed
    allow_gauss: bool = False    # opt in to combining with GaussianMask
                                 # compression (double noising otherwise
                                 # rejected — uncounted utility loss)


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Scalar hyper-parameters of Algorithm 1 + driver settings."""

    num_agents: int = 4          # K
    local_steps: int = 1         # T
    step_size: float = 0.01      # mu
    drift_correction: bool = False     # eq. (31)
    blocks: int = 20             # driver: block iterations
    batch: int = 2               # driver: per-agent batch
    seq: int = 64                # driver: sequence length (LM models)
    seed: int = 0
    local_steps_mode: str = "uniform"  # uniform: every agent runs T
                                 # steps; degree: per-agent T_k =
                                 # max(1, round(T * d_min / d_k)) — hubs
                                 # do less local work (eq. 17 with early
                                 # identity updates)


_SUBSPECS = (TopologySpec, GraphSpec, ParticipationSpec, MixerSpec,
             CompressionSpec, AttackSpec, OptimizerSpec, ModelSpec,
             DataSpec, AsyncSpec, PrivacySpec, RunSpec)


def _tuplify(v):
    """JSON arrays come back as lists; specs store tuples (hashable,
    equality-stable round trip)."""
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def _from_dict(cls, d: dict):
    if not isinstance(d, dict):
        raise ValueError(f"{cls.__name__} expects an object, got {d!r}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(fields)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} field(s) "
                         f"{sorted(unknown)} — known fields: "
                         f"{sorted(fields)}")
    kwargs = {}
    for name, value in d.items():
        ftype = fields[name].type
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
            kwargs[name] = _from_dict(ftype, value)
        else:
            kwargs[name] = _tuplify(value)
    return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """The full declarative experiment description (see module docstring)."""

    topology: TopologySpec = TopologySpec()
    graph: GraphSpec = GraphSpec()
    participation: ParticipationSpec = ParticipationSpec()
    mixer: MixerSpec = MixerSpec()
    compression: CompressionSpec = CompressionSpec()
    attack: AttackSpec = AttackSpec()
    optimizer: OptimizerSpec = OptimizerSpec()
    model: ModelSpec = ModelSpec()
    asynchrony: AsyncSpec = AsyncSpec()   # "async" is a keyword
    privacy: PrivacySpec = PrivacySpec()
    run: RunSpec = RunSpec()
    data: DataSpec = DataSpec()  # appended (spec evolution: new sub-specs
                                 # go last so older JSON still hydrates)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    def replace(self, **changes) -> "ExperimentSpec":
        return dataclasses.replace(self, **changes)

    # -- derived views ------------------------------------------------------
    def stationary_q(self):
        """Stationary per-agent activation probability implied by the
        participation spec (what the Lemma-1 surrogates consume)."""
        p = self.participation
        if p.kind == "cyclic":
            return 1.0 / p.num_groups
        return p.q

    def graph_kwargs(self) -> tuple:
        """The graph-process kwargs this spec denotes, as sorted (k, v)
        pairs (what ``DiffusionConfig.graph_kwargs`` stores) — only the
        fields the selected built-in kind actually consumes, so the static
        default stays ``()`` and configs compare clean.  Registered
        third-party kinds get every field: the registry builder picks what
        it reads, and nothing is silently dropped on the config path."""
        g = self.graph
        if g.kind == "link_dropout":
            return (("corr", g.corr), ("drop", g.drop))
        if g.kind == "tv_erdos":
            return (("p", g.p),)
        if g.kind in ("static", "gossip"):
            return ()
        return (("corr", g.corr), ("drop", g.drop), ("p", g.p))

    def to_diffusion_config(self):
        """The :class:`repro_torch.core.diffusion.DiffusionConfig` this
        spec denotes — the scalar-hyper-parameter view both engines consume
        (pluggable components are built separately by the registries)."""
        from repro_torch.core.diffusion import DiffusionConfig
        r, c = self.run, self.compression
        return DiffusionConfig(
            num_agents=r.num_agents, local_steps=r.local_steps,
            step_size=r.step_size, topology=self.topology.kind,
            topology_kwargs=tuple(self.topology.kwargs),
            graph=self.graph.kind, graph_kwargs=self.graph_kwargs(),
            participation=self.stationary_q(),
            drift_correction=r.drift_correction, mix=self.mixer.kind,
            compress=c.kind, compress_ratio=c.ratio, compress_sigma=c.sigma,
            error_feedback=c.error_feedback, comm_mode=c.mode,
            comm_gamma=c.gamma, local_steps_mode=r.local_steps_mode)

    def q_vector(self):
        """(K,) stationary activation probabilities (numpy)."""
        return self.to_diffusion_config().q_vector()
