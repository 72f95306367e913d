"""build(spec) — the single entry point from :class:`ExperimentSpec` to a
running engine.

Counterpart of ``repro.api.build``.  Every spec ``kind`` resolves through a
string-keyed :class:`Registry` (:mod:`repro_torch.api.spec`), filled with
the port's built-in backends; ``@REGISTRY.register("name")`` adds new ones
without touching the engines, the CLIs or the checkpoint format.

The engines come back with one surface:

    engine = build(spec[, loss_fn], device=...)
    state  = engine.init_state(params, opt_state, key=...)
    state, metrics = engine.step(state, block_batch, key)

``engine="stacked"`` returns the exact-paper
:class:`repro_torch.core.diffusion.DiffusionEngine`; ``engine="sharded"``
the agent-sharded :class:`repro_torch.core.sharded.ShardedEngine` (one
device without a mesh; the agent rows split over a ``torch.distributed``
mesh with one); ``engine="async"`` the event-driven
:class:`repro_torch.core.async_engine.AsyncEngine`.  ``engine="auto"``
resolves as the reference's does (:func:`resolve_engine`): async when
``spec.asynchrony.enabled``, else sharded for a self-contained model
(``kind="transformer"``) and stacked for an external loss.  The sharded
engine takes the 3-arg loss ``loss_fn(params, batch, rng)``: the model
bundle's ``loss_rng``, or the caller's ``loss_fn``.

The registries' builders take the reference's arguments plus the device
where a component holds tensors: ``GRAPHS`` and ``MIXERS`` take
``device``, ``DATASETS`` takes ``(DataSpec, spec, cfg, device)``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.api.spec import (AttackSpec, CompressionSpec, DataSpec,
                                  ExperimentSpec, GraphSpec, MixerSpec,
                                  ModelSpec, OptimizerSpec,
                                  ParticipationSpec, Registry, TopologySpec)
from repro_torch.core import attacks as attack_lib
from repro_torch.core import compression as comp_lib
from repro_torch.core import graphs as graph_lib
from repro_torch.core import mixing
from repro_torch.core import privacy as privacy_lib
from repro_torch.core import schedules
from repro_torch.core import topology as topo_lib
from repro_torch.core.async_engine import AsyncEngine
from repro_torch.core.diffusion import DiffusionEngine
from repro_torch.core.sharded import ShardedEngine
from repro_torch.device import resolve_device
from repro_torch.optim import adam, momentum, sgd
from repro_torch.tree import tree_map

PyTree = Any

__all__ = [
    "build",
    "resolve_engine",
    "ModelBundle",
    "train_block_struct",
    "make_block_provider",
    "TOPOLOGIES",
    "GRAPHS",
    "PARTICIPATION",
    "MIXERS",
    "COMPRESSORS",
    "ATTACKS",
    "OPTIMIZERS",
    "MODELS",
    "DATASETS",
    "ENGINES",
]

TOPOLOGIES = Registry("topology")        # (TopologySpec, K) -> Topology
GRAPHS = Registry("graph")               # (GraphSpec, topology, K, device)
PARTICIPATION = Registry("participation")  # (ParticipationSpec, K) -> process
MIXERS = Registry("mixer")               # (MixerSpec, topology, K, device)
COMPRESSORS = Registry("compressor")     # (CompressionSpec,) -> Compressor
ATTACKS = Registry("attack")             # (AttackSpec, K, inner) -> transform
OPTIMIZERS = Registry("optimizer")       # (OptimizerSpec,) -> GradTransform
MODELS = Registry("model")               # (ModelSpec,) -> ModelBundle | None
DATASETS = Registry("dataset")           # (DataSpec, spec, cfg, device)

#: the engines ``build`` returns
ENGINES = ("stacked", "sharded", "async")


# -- topologies (delegate to core/topology.make_topology) -------------------

def _register_topologies():
    for kind in topo_lib.TOPOLOGY_KINDS:
        @TOPOLOGIES.register(kind)
        def _build(spec: TopologySpec, K: int, _kind=kind):
            return topo_lib.make_topology(_kind, K, **dict(spec.kwargs))


_register_topologies()


# -- graph processes (time-varying topology, core/graphs.py) ----------------

@GRAPHS.register("static")
def _static_graph(spec: GraphSpec, topology, K: int, device=None):
    return graph_lib.StaticGraph(topology, device=device)


@GRAPHS.register("link_dropout")
def _link_dropout(spec: GraphSpec, topology, K: int, device=None):
    return graph_lib.LinkDropout(topology, drop=spec.drop, corr=spec.corr,
                                 device=device)


@GRAPHS.register("gossip")
def _gossip(spec: GraphSpec, topology, K: int, device=None):
    return graph_lib.GossipMatching(topology, device=device)


@GRAPHS.register("tv_erdos")
def _tv_erdos(spec: GraphSpec, topology, K: int, device=None):
    return graph_lib.TimeVaryingErdos(K, p=spec.p, topology=topology,
                                      device=device)


# -- participation processes ------------------------------------------------

@PARTICIPATION.register("iid")
def _iid(spec: ParticipationSpec, K: int):
    return schedules.IIDBernoulli(spec.q, num_agents=K)


@PARTICIPATION.register("markov")
def _markov(spec: ParticipationSpec, K: int):
    return schedules.MarkovAvailability(spec.q, spec.corr, num_agents=K)


@PARTICIPATION.register("cyclic")
def _cyclic(spec: ParticipationSpec, K: int):
    return schedules.CyclicGroups(K, spec.num_groups)


# -- mixers (delegate to core/mixing.make_mixer) ----------------------------

def _register_mixers():
    # MixerSpec.tile_m and .interpret configure the reference's Pallas
    # kernel; the port's kernels tile themselves (core/mixing.tiled_apply)
    for kind in ("dense", "sparse", "pallas", "gather", "auto", "none",
                 "trimmed_mean", "median", "adaptive_trim"):
        @MIXERS.register(kind)
        def _build(spec: MixerSpec, topology, K: int, device=None,
                   _kind=kind):
            return mixing.make_mixer(_kind, topology, num_agents=K,
                                     trim=spec.trim, scope=spec.scope,
                                     gather=spec.gather, device=device)


_register_mixers()


# -- compressors ------------------------------------------------------------

def _register_compressors():
    for kind in ("none", "topk", "randk", "int8", "gauss"):
        @COMPRESSORS.register(kind)
        def _build(spec: CompressionSpec, _kind=kind):
            return comp_lib.make_compressor(
                _kind, ratio=spec.ratio, error_feedback=spec.error_feedback,
                sigma=spec.sigma)


_register_compressors()


# -- byzantine gradient attacks (core/attacks.py) ---------------------------

def _register_attacks():
    for kind in attack_lib.ATTACK_KINDS:
        @ATTACKS.register(kind)
        def _build(spec: AttackSpec, K: int, inner, _kind=kind):
            return attack_lib.make_attack(
                _kind, K, num_byzantine=spec.num_byzantine,
                scale=spec.scale, agents=spec.agents, seed=spec.seed,
                inner=inner)


_register_attacks()


# -- optimizers -------------------------------------------------------------

for _kind, _factory in (("sgd", sgd), ("momentum", momentum), ("adam", adam)):
    OPTIMIZERS.register(_kind)(
        lambda spec, _f=_factory: _f(**dict(spec.kwargs)))


# -- models -----------------------------------------------------------------

class ModelBundle(NamedTuple):
    """Self-contained model half of an experiment: the configuration, the
    2-arg per-agent loss, single-agent initialization from a
    ``torch.Generator``, and the 3-arg loss the sharded engine calls
    (``loss_rng(params, batch, rng)``)."""

    cfg: Any
    loss: Callable[[PyTree, Any], torch.Tensor]
    init_params: Callable[[torch.Generator], PyTree]
    loss_rng: Callable[[PyTree, Any, torch.Generator], torch.Tensor] | None \
        = None


@MODELS.register("external")
def _external(spec: ModelSpec):
    return None        # loss supplied by the build() caller


@MODELS.register("transformer")
def _transformer(spec: ModelSpec):
    """Any arch of the model zoo (``repro_torch.configs``, the
    reference's ten), its smoke config under ``spec.smoke``."""
    from repro_torch.configs import get_config    # lazy: keep api light
    from repro_torch.models import transformer as tf
    bundle = get_config(spec.arch)
    cfg = bundle.smoke if spec.smoke else bundle.model

    def loss(p, b):
        return tf.train_loss(p, cfg, b, remat=False)

    def loss_rng(p, b, rng):
        del rng                   # deterministic loss (the reference's)
        return loss(p, b)

    return ModelBundle(cfg=cfg, loss=loss,
                       init_params=lambda key: tf.init_params(key, cfg),
                       loss_rng=loss_rng)


# -- datasets (per-agent block providers) -----------------------------------

def train_block_struct(cfg, *, T: int, K: int, batch: int, seq: int,
                       img_dtype: torch.dtype = torch.float32) -> dict:
    """(shape, dtype) of every leaf of one (T, K, B, S[, C]) training block
    (the reference's ``train_block_struct``; the port's
    :func:`repro_torch.data.pipeline.train_block_struct`)."""
    from repro_torch.data.pipeline import train_block_struct as struct
    return struct(cfg, T=T, K=K, batch=batch, seq=seq, img_dtype=img_dtype)


def _provider(kind: str, dspec: DataSpec, spec: ExperimentSpec, cfg, device,
              **kind_kwargs):
    from repro_torch.data import pipeline
    run = spec.run
    return pipeline.make_block_provider(
        kind, cfg, num_agents=run.num_agents, local_steps=run.local_steps,
        batch=run.batch, seq=run.seq, device=device, **kind_kwargs)


@DATASETS.register("iid")
def _iid_provider(dspec: DataSpec, spec: ExperimentSpec, cfg, device=None):
    """Fresh synthetic tokens every block, drawn from the block's key."""
    return _provider("iid", dspec, spec, cfg, device)


@DATASETS.register("dirichlet")
def _dirichlet_provider(dspec: DataSpec, spec: ExperimentSpec, cfg,
                        device=None):
    """Label-Dirichlet skew over ``dspec.clusters`` latent classes of the
    seeded corpus; every block replayable from its index."""
    return _provider("dirichlet", dspec, spec, cfg, device,
                     alpha=dspec.alpha, clusters=dspec.clusters,
                     seed=dspec.seed, corpus_tokens=dspec.corpus_tokens)


@DATASETS.register("shards")
def _shards_provider(dspec: DataSpec, spec: ExperimentSpec, cfg,
                     device=None):
    """Contiguous disjoint shards, ``shards_per_agent`` an agent."""
    return _provider("shards", dspec, spec, cfg, device,
                     shards_per_agent=dspec.shards_per_agent,
                     seed=dspec.seed, corpus_tokens=dspec.corpus_tokens)


def make_block_provider(spec: ExperimentSpec, cfg, device=None):
    """Compile ``spec.data`` into ``provider(block_index, key) -> batch``
    on ``device``: the data half of the driver loop."""
    return DATASETS.get(spec.data.kind)(spec.data, spec, cfg, device)


# -- the entry point --------------------------------------------------------

def _need_loss(loss_fn, model):
    loss = loss_fn if loss_fn is not None else (model.loss if model
                                                else None)
    if loss is None:
        raise ValueError('model kind "external" needs an explicit '
                         "loss_fn (or select a self-contained model "
                         "spec, e.g. kind='transformer')")
    return loss


def resolve_engine(spec: ExperimentSpec, engine: str = "auto") -> str:
    """The engine ``build`` makes for ``engine``: "auto" is async when
    ``spec.asynchrony.enabled``, else sharded for a self-contained model
    and stacked for an external loss (the reference's rule)."""
    if engine == "auto":
        if spec.asynchrony.enabled:
            return "async"
        return "sharded" if spec.model.kind != "external" else "stacked"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} "
                         "(expected stacked|sharded|async|auto)")
    return engine


def build(spec: ExperimentSpec, loss_fn=None, *, engine: str = "auto",
          grad_transform=None, device=None, grad_fn=None, mesh=None):
    """Materialize an engine from a declarative spec.

    Args:
      spec: the experiment description.
      loss_fn: required when ``spec.model.kind == "external"``: the
        per-agent loss, 2-arg for the stacked and async engines and 3-arg
        ``(params, batch, rng)`` for the sharded one.  Overrides the model
        bundle's loss when both exist (the train driver hands in its
        kernel-path loss this way).
      engine: "stacked" | "sharded" | "async" | "auto" (:func:`resolve_
        engine`).
      grad_transform: explicit gradient-transform override; defaults to the
        optimizer spec ("sgd" means None: exact Algorithm 1).
      device: where the engine and its state live (``None`` means CUDA).
      grad_fn: per-agent gradients over stacked trees, handed to the
        engine (the §VII regression's closed form).
      mesh: the sharded engine's ``torch.distributed`` mesh
        (:func:`repro_torch.launch.mesh.make_production_mesh`), whose
        ``data`` axis splits the agent rows; ``None`` runs on one device.

    Returns:
      A :class:`~repro_torch.core.diffusion.DiffusionEngine`,
      :class:`~repro_torch.core.sharded.ShardedEngine` or
      :class:`~repro_torch.core.async_engine.AsyncEngine`, decorated with
      ``.spec``, ``.optimizer`` (the composed GradTransform), ``.model``
      (the :class:`ModelBundle` or None), ``.engine_kind`` (what was
      built) and, for a self-contained model, ``.init_params(key)`` (the
      stacked (K, ...) parameters, agent after agent from one generator;
      this rank's rows under a mesh) and ``.data`` (the block provider,
      whole (T, K, ...) blocks).
    """
    dev = resolve_device(device)
    K = spec.run.num_agents
    cfg = spec.to_diffusion_config()
    topology = (TOPOLOGIES.get(spec.topology.kind)(spec.topology, K)
                if K > 1 else None)
    process = PARTICIPATION.get(spec.participation.kind)(spec.participation, K)
    graph = (GRAPHS.get(spec.graph.kind)(spec.graph, topology, K, dev)
             if topology is not None else None)
    # "auto" must not pick a support-bound path for graphs that realize
    # edges outside the base support; resolve before the registry lookup
    mix_kind = graph_lib.resolve_mix_for_graph(spec.mixer.kind, graph, dev)
    mixer = MIXERS.get(mix_kind)(spec.mixer, topology, K, dev)
    graph_lib.check_mixer_support(mixer, graph)
    compressor = COMPRESSORS.get(spec.compression.kind)(spec.compression)
    optimizer = OPTIMIZERS.get(spec.optimizer.kind)(spec.optimizer)
    p = spec.privacy
    privacy = privacy_lib.compile_privacy(
        K, spec.q_vector(), blocks=spec.run.blocks,
        local_steps=spec.run.local_steps, enabled=p.enabled,
        epsilon=p.epsilon, delta=p.delta, clip=p.clip,
        noise_multiplier=p.noise_multiplier, secure_agg=p.secure_agg,
        mask_scale=p.mask_scale, seed=p.seed)
    if privacy is not None:
        if grad_transform is not None:
            raise ValueError(
                "spec.privacy and an explicit grad_transform were both "
                "supplied — compose them yourself via "
                "repro_torch.core.privacy.PrivateGradients(..., inner=...) "
                "and pass its .update as grad_transform, or drop one")
        if spec.compression.kind == "gauss" and not p.allow_gauss:
            raise ValueError(
                "spec.privacy with GaussianMask compression double-noises "
                "the exchange: the compressor's sigma is NOT counted by "
                "the accountant, so it is silent utility loss with no "
                "epsilon credit — set PrivacySpec.allow_gauss=True to opt "
                "in deliberately, or drop one of the noise sources")
        # raw grads -> attack -> privacy clip + noise -> optimizer: the
        # privacy stage wraps the optimizer first, the attack lands
        # outermost
        optimizer = privacy.wrap(optimizer)
    if spec.attack.kind != "none":
        if grad_transform is not None:
            raise ValueError(
                "spec.attack and an explicit grad_transform were both "
                "supplied — compose them yourself via "
                "repro_torch.core.attacks.make_attack(..., inner=...) and "
                "pass its .update as grad_transform, or drop one")
        optimizer = ATTACKS.get(spec.attack.kind)(spec.attack, K, optimizer)
    model = MODELS.get(spec.model.kind)(spec.model)

    engine = resolve_engine(spec, engine)
    if spec.compression.ef_host_offload and engine != "sharded":
        # the stacked/async engines have no between-block comm memory to
        # park on the host; silently ignoring the flag would report a
        # memory optimization that never ran
        raise ValueError(
            "CompressionSpec.ef_host_offload parks the sharded engine's "
            f"between-block pipeline memory in host RAM; engine={engine!r} "
            "has no such residency to move — use engine='sharded' or drop "
            "the flag")
    if mesh is not None and engine != "sharded":
        raise ValueError(f"a mesh splits the sharded engine's agent rows; "
                         f"engine={engine!r} runs on one device")
    if engine != "async" and spec.asynchrony.enabled:
        raise ValueError(
            f"spec.asynchrony.enabled is set but engine={engine!r} was "
            "requested — use engine='async'/'auto', or disable the "
            "asynchrony sub-spec")
    if grad_transform is None and (spec.optimizer.kind != "sgd"
                                   or spec.attack.kind != "none"
                                   or privacy is not None):
        grad_transform = optimizer.update

    if engine == "sharded":
        loss = loss_fn if loss_fn is not None else (model.loss_rng if model
                                                    else None)
        if loss is None:
            raise ValueError('model kind "external" needs an explicit '
                             "3-arg loss_fn for the sharded engine")
        eng = ShardedEngine(
            loss, cfg, topology=topology, mix=mixer, participation=process,
            compress=compressor, graph=graph, grad_transform=grad_transform,
            privacy=privacy, mesh=mesh, device=dev,
            ef_host_offload=spec.compression.ef_host_offload,
            grad_fn=(None if grad_fn is None else
                     lambda p, b, rngs, _g=grad_fn: _g(p, b)))
        return _decorate(eng, spec, optimizer, model, engine, dev)
    loss = _need_loss(loss_fn, model)
    if engine == "async":
        if privacy is not None and privacy.secure_agg:
            raise ValueError(
                "secure-agg wire masks ride the CommPipeline, which the "
                "async engine's staleness buffer replaces — stale masked "
                "payloads from different blocks cannot cancel; drop "
                "PrivacySpec.secure_agg or use a synchronous engine")
        eng = AsyncEngine(cfg, loss, grad_transform,
                          async_spec=spec.asynchrony, participation=process,
                          graph=graph, privacy=privacy, device=dev,
                          grad_fn=grad_fn)
    else:
        eng = DiffusionEngine(cfg, loss, grad_transform, mixer=mixer,
                              participation=process, compressor=compressor,
                              graph=graph, privacy=privacy, device=dev,
                              grad_fn=grad_fn)

    return _decorate(eng, spec, optimizer, model, engine, dev)


def _decorate(eng, spec: ExperimentSpec, optimizer, model, engine: str,
              dev):
    eng.spec = spec
    eng.optimizer = optimizer
    eng.model = model
    eng.engine_kind = engine
    if model is not None:
        shard = getattr(eng, "shard", None)
        rows = (range(spec.run.num_agents) if shard is None
                else shard.local_agents)

        def init_params(key, _init=model.init_params, _K=spec.run.num_agents,
                        _dev=dev, _rows=rows):
            # every agent is drawn (the generator advances as at world 1);
            # only this rank's rows go to the device
            agents = []
            for k in range(_K):
                p = _init(key)
                if k in _rows:
                    agents.append(tree_map(lambda x: x.to(_dev), p))
                del p
            return tree_map(lambda *xs: torch.stack(xs), *agents)
        eng.init_params = init_params
        eng.data = make_block_provider(spec, model.cfg, dev)
    return eng

