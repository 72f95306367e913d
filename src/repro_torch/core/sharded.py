"""Agent-sharded execution of Algorithm 1 (the reference's production
engine).

Counterpart of ``repro.core.sharded``.  Layout: every parameter leaf
carries the leading agent axis of size K, split over one axis of a
``torch.distributed`` mesh (``data`` by default,
:func:`repro_torch.launch.mesh.make_production_mesh`): rank ``r`` of ``W``
holds rows ``[r K/W, (r+1) K/W)`` of the parameters, the optimizer state
and the pipeline memory (:class:`repro_torch.sharding.agents.AgentShard`;
a K that W does not divide stays whole on every rank).  Without a mesh the
engine runs on one device, which is the reference's default path.

The block step is assembled from the stacked engine's layers
(:mod:`repro_torch.core.diffusion`):

* local updates: the shared :func:`~repro_torch.core.diffusion.
  local_update_scan` on the local rows, with the 3-arg loss
  ``loss_fn(agent_params, agent_batch, rng)`` and one generator per
  (local step, agent);
* the combination: a :class:`repro_torch.core.mixing.CommPipeline` whose
  mixer is put on the row split (:meth:`~repro_torch.core.mixing.Mixer.
  shard_agent_axis`): each column tile is all-gathered, combined by the
  same kernel and cut back to the local rows; the int8 branches gather the
  int8 codes and float32 scales;
* the activation and the graph: drawn on the host, identically on every
  rank from the same generator (or injected).

Draws.  A block draws from its generator ``key`` in a fixed order: the
activation mask, the graph's uniforms (the static graph draws nothing),
the loss seed, then the compression seed: the reference's ``key_act``,
``fold_in(key, 0x9A)``, ``key_loss`` and ``fold_in(key, 0xC0)``.  The
activation and graph draws are the stacked engine's, so both engines
realize the same masks from one generator; the compression stream differs
from the stacked engine's, as in the reference.  Replay parity injects the
realized draws (``active=``, ``part_u=``, ``graph_u=``, ``comm_key=``).

The contract is the stacked engine's:

    block_step(state: EngineState, block_batch, key) -> (EngineState, metrics)

with ``block_batch`` leaves (T, K, ...) whole on every rank (the engine
keeps its rows) and ``metrics["active"]`` the whole (K,) mask on every
rank.  The privacy accountant advances on the whole mask.

EF host offload.  With ``ef_host_offload`` the pipeline memory (the
error-feedback residual or the diff-mode reference, about one parameter
stack) parks in pinned host memory outside the combination: the step
fetches it onto the card after the local updates, just before the
combination, and parks it again after, so the local updates run without
it.  The fused int8 path with error feedback (compressed_fedavg) does not
fetch it whole: it streams a leaf at a time into the target and returns
only the inactive agents' rows (``CommPipeline.streams_residual``), so
its combination, where that block's memory peaks, holds it neither.  ``offload(state)`` parks a state's
pipeline memory (the train driver calls it once after ``init_state``);
``fetch(state)`` brings it back to the card (before a checkpoint is
gathered).  Fetching before each block, as the reference's driver does,
would keep it on the card through the local updates and lower no peak.
On the CPU there is no distinct pinned space and all of it is the
identity.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import compression as comp_lib
from repro_torch.core import graphs as graph_lib
from repro_torch.core import mixing
from repro_torch.core import participation as part
from repro_torch.core import schedules
from repro_torch.core import topology as topo_lib
from repro_torch.core.diffusion import (DiffusionConfig, _sync,
                                        local_update_scan, resolve_step_mask,
                                        stacked_grad)
from repro_torch.core.mixing import mix_dense, mix_sparse  # noqa: F401
from repro_torch.core.state import (EngineState, check_engine_state,
                                    init_engine_state)
from repro_torch.device import resolve_device
from repro_torch.sharding.agents import local_rows
from repro_torch.tree import tree_map

PyTree = Any

__all__ = ["mix_dense", "mix_sparse", "make_block_step", "ShardedEngine",
           "ef_host_sharding", "offload_comm_state", "fetch_comm_state"]


# ---------------------------------------------------------------------------
# error-feedback residual host offload
# ---------------------------------------------------------------------------

def _empty(comm_state) -> bool:
    return comm_state is None or (isinstance(comm_state, tuple)
                                  and not comm_state)


def ef_host_sharding(device=None) -> torch.device | None:
    """Where the offload parks the pipeline memory: pinned host memory
    (``torch.device("cpu")``, allocated pinned) when ``device`` (default:
    CUDA if a card is present) is a card, ``None`` otherwise (the CPU:
    the leaves already live in host RAM, so the offload is the identity)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = "cuda"
    return torch.device("cpu") if torch.device(device).type == "cuda" \
        else None


def offload_comm_state(comm_state: PyTree) -> PyTree:
    """Move the pipeline memory (EF residual / diff reference) into pinned
    host tensors.  Each CUDA leaf is copied with
    ``non_blocking`` into a pinned buffer and the stream is synchronized
    once, so the returned leaves are readable and the device copies are
    free; CPU leaves (and ``None``, ``()``) pass through."""
    if _empty(comm_state):
        return comm_state
    moved = []

    def park(leaf):
        if not isinstance(leaf, torch.Tensor) or not leaf.is_cuda:
            return leaf
        host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
        host.copy_(leaf, non_blocking=True)
        moved.append(leaf.device)
        return host

    out = tree_map(park, comm_state)
    for device in set(moved):
        torch.cuda.current_stream(device).synchronize()
    return out


def fetch_comm_state(comm_state: PyTree, device=None) -> PyTree:
    """Bring an offloaded pipeline memory back onto ``device`` (default
    CUDA) ahead of the combination: each pinned leaf is copied with
    ``non_blocking``, ordered before the combination's work on the stream.  Leaves
    that were never offloaded pass through."""
    if _empty(comm_state):
        return comm_state
    target = torch.device(device if device is not None else "cuda")

    def bring(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
                and leaf.is_pinned()):
            return leaf.to(target, non_blocking=True)
        return leaf

    return tree_map(bring, comm_state)


def make_block_step(
    loss_fn: Callable[[PyTree, Any, torch.Generator], torch.Tensor],
    config: DiffusionConfig,
    A=None,
    *,
    mix: str | mixing.Mixer | None = None,
    offsets: Sequence[int] = (),
    grad_transform=None,
    topology=None,
    participation: schedules.ParticipationProcess | None = None,
    graph: "str | graph_lib.GraphProcess | None" = None,
    tile_m: int = 512,
    interpret: bool | None = None,
    trim: int = 1,
    robust_scope: str = "global",
    robust_gather: str = "auto",
    compress: str | comp_lib.Compressor | None = None,
    compress_ratio: float | None = None,
    compress_sigma: float | None = None,
    error_feedback: bool | None = None,
    comm_mode: str | None = None,
    comm_gamma: float | None = None,
    mesh=None,
    agent_axis: str | None = None,
    privacy=None,
    ef_host_offload: bool = False,
    device=None,
    grad_fn=None,
) -> Callable:
    """Build the block-step function.

    Args:
      loss_fn: ``loss_fn(agent_params, agent_batch, rng) -> scalar``, one
        agent's loss with its own ``torch.Generator`` (the transformer's
        ``loss_rng`` ignores it).
      config: Algorithm 1 hyper-parameters; ``config.num_agents`` is K.
      A: (K, K) base combination matrix; optional when ``topology`` is
        given or ``mix`` is already a Mixer.
      mix: a :func:`repro_torch.core.mixing.make_mixer` name or a prebuilt
        Mixer; defaults to ``config.mix``.
      offsets: circulant offsets for the sparse path (derived from
        ``topology`` when omitted).
      grad_transform: optional ``(grads, state, params) -> (updates,
        state)`` applied per agent before the step-size mask.
      topology: the :class:`~repro_torch.core.topology.Topology` behind A.
      participation: activation model; defaults to i.i.d. Bernoulli with
        the config's q vector.
      graph: combination-graph model, a GraphProcess or kind name;
        defaults to ``config.graph`` / ``config.graph_kwargs``.
      tile_m / interpret: the reference's Pallas knobs, accepted for its
        signature; the port's kernels tile themselves
        (:func:`repro_torch.core.mixing.tiled_apply`).
      trim / robust_scope / robust_gather: the robust backends' knobs.
      compress / compress_ratio / compress_sigma / error_feedback: the
        compression stage; each defaults to the config's field.
      comm_mode / comm_gamma: exchange scheme and consensus step of the
        pipeline (defaults: config fields).
      mesh / agent_axis: agent-axis sharding: a ``DeviceMesh`` whose axis
        ``agent_axis`` (default "data") carries the agents.  The state
        then holds this rank's rows and the combination gathers each tile
        (int8 codes and scales on the int8 paths).
      privacy: compiled :class:`repro_torch.core.privacy.Privacy` or None:
        advances the RDP accountant on the realized (whole) mask every
        block and routes the combination through the secure-agg wire
        masks when asked (the clip+noise transform arrives composed in
        ``grad_transform``).
      ef_host_offload: park the pipeline memory in pinned host memory
        outside the combination: the step fetches it just before the
        combination and parks it after (``offload(state)`` /
        ``fetch(state)`` move a state's explicitly; identity on the CPU).
        A stateless pipeline raises ``ValueError``.
      device: where the engine's matrices and the state live (``None``
        means CUDA).
      grad_fn: per-agent gradients over stacked trees taking one generator
        per agent, ``grad_fn(params, batch, rngs)``; defaults to
        ``stacked_grad(loss_fn)``.

    Returns:
      ``block_step(state, block_batch, key, *, active=None, part_u=None,
      graph_u=None, comm_key=None) -> (EngineState, metrics)``: the
      metrics hold the whole (K,) ``active`` mask, the realized ``A_t``,
      ``local_s`` and ``combine_s`` (host seconds around work ending in a
      device sync) and, with privacy, ``epsilon``.  The function carries
      ``.pipeline``, ``.process``, ``.graph``, ``.config``, ``.privacy``,
      ``.init_state``, ``.step_mask``, ``.ef_host_offload``, ``.offload``,
      ``.fetch`` and ``.shard`` (the row split, or None unsharded).
    """
    del tile_m, interpret          # the reference's Pallas knobs
    K = config.num_agents
    dev = resolve_device(device)
    process, q_np = schedules.resolve(config, participation)
    q = torch.as_tensor(q_np, dtype=torch.float32, device=dev)
    mix_name = mix if mix is not None else config.mix
    mixer = mixing.make_mixer(mix_name, topology, A=A,
                              offsets=tuple(offsets) or None, num_agents=K,
                              trim=trim, scope=robust_scope,
                              gather=robust_gather, device=dev)
    A_graph = A
    if topology is None and A is None and not mixer.uses_matrix:
        # mixers that ignore the matrix operand (K = 1, global robust
        # aggregation) run against an inert identity; matrix-consuming
        # mixers without a topology still fail loudly in the graph build
        A_graph = np.eye(K, dtype=np.float32)
    graph_proc = graph_lib.make_graph_process(
        graph if graph is not None else config.graph, topology, A=A_graph,
        num_agents=K, device=dev, **dict(config.graph_kwargs))
    resolved = graph_lib.resolve_mix_for_graph(mix_name, graph_proc, dev)
    if resolved is not mix_name:
        # "auto" picked a support-bound path before the graph was known;
        # the realized edges can leave the base support
        mixer = mixing.make_mixer(resolved, topology, A=A, num_agents=K,
                                  trim=trim, scope=robust_scope,
                                  gather=robust_gather, device=dev)
    graph_lib.check_mixer_support(mixer, graph_proc)
    if mesh is not None:
        mixer.shard_agent_axis(mesh, agent_axis or "data", K)
    compressor = comp_lib.make_compressor(
        compress if compress is not None else config.compress,
        ratio=(compress_ratio if compress_ratio is not None
               else config.compress_ratio),
        error_feedback=(error_feedback if error_feedback is not None
                        else config.error_feedback),
        sigma=(compress_sigma if compress_sigma is not None
               else config.compress_sigma))
    pipeline = mixing.CommPipeline(
        mixer, compressor,
        mode=comm_mode if comm_mode is not None else config.comm_mode,
        gamma=comm_gamma if comm_gamma is not None else config.comm_gamma,
        base_A=topology.A if topology is not None else A,
        secure_agg=(privacy.make_mask_stage() if privacy is not None
                    else None))
    if ef_host_offload and not pipeline.stateful:
        raise ValueError(
            "ef_host_offload requires a stateful pipeline (error feedback "
            "or a diff-mode compressor) — this pipeline carries no "
            "between-block memory to offload")
    mask_topo = topology
    if mask_topo is None and config.local_steps_mode != "uniform":
        if A is None:
            raise ValueError(
                "local_steps_mode='degree' reads per-agent degrees — pass "
                "topology= (or the base matrix A)")
        A_np = np.asarray(A, dtype=np.float64)
        mask_topo = topo_lib.Topology(name="from_A", A=A_np,
                                      adjacency=A_np != 0)
    step_mask = resolve_step_mask(config, mask_topo, dev)
    grad_fn = grad_fn if grad_fn is not None else stacked_grad(loss_fn)
    shard = pipeline.shard
    rows = shard.rows if shard is not None else slice(None)
    agents = shard.local_agents if shard is not None else range(K)
    local_mask = step_mask[:, rows] if step_mask is not None else None

    def block_step(state: EngineState, block_batch, key, *, active=None,
                   part_u=None, graph_u=None, comm_key=None):
        with spans.span("engine.block"):
            return _block_step(state, block_batch, key, active=active,
                               part_u=part_u, graph_u=graph_u,
                               comm_key=comm_key)

    def _block_step(state, block_batch, key, *, active, part_u, graph_u,
                    comm_key):
        with spans.span("engine.prologue"):
            check_engine_state(process, pipeline, state,
                               "block_step.init_state", graph=graph_proc,
                               privacy=privacy)
            part_state = state.part_state
            if active is None:
                active, part_state = process.sample(part_state, key,
                                                    u=part_u)
            else:
                part_state = process.advance(part_state, active)
            active = torch.as_tensor(active, dtype=torch.float32).to(dev)
            A_t, graph_state = graph_proc.sample(state.graph_state, key,
                                                 u=graph_u)
            loss_key = (int(torch.randint(0, 2 ** 62, (1,),
                                          generator=key))
                        if key is not None else 0)
            if comm_key is None and pipeline.needs_key:
                comm_key = comp_lib.device_stream(key, dev)
            mus = part.step_size_matrix(config.step_size, active, q,
                                        config.drift_correction)
            batch = tree_map(lambda x: x[:, rows], block_batch)
        with spans.span("engine.local_updates"):
            t0 = time.perf_counter()
            with local_rows(shard):
                params, opt_state = local_update_scan(
                    grad_fn, state.params, state.opt_state, mus[rows],
                    batch, local_steps=config.local_steps,
                    grad_transform=grad_transform, step_mask=local_mask,
                    loss_key=loss_key, agents=agents)
            del batch
            _sync(dev)
            t1 = time.perf_counter()
        with spans.span("engine.combination"):
            comm_state = state.comm_state
            if ef_host_offload and not pipeline.streams_residual:
                # the pipeline memory comes onto the card for the
                # combination only; the fused int8 path streams its
                # residual from the host
                comm_state = fetch_comm_state(comm_state, dev)
            params, comm_state = pipeline(params, active, A_t, comm_state,
                                          comm_key)
            if ef_host_offload:
                comm_state = offload_comm_state(comm_state)
            _sync(dev)
            t2 = time.perf_counter()
        metrics = {"active": active, "A_t": A_t, "local_s": t1 - t0,
                   "combine_s": t2 - t1}
        privacy_state = state.privacy_state
        if privacy is not None:
            privacy_state = privacy.advance(privacy_state, active)
            metrics["epsilon"] = privacy.epsilon(privacy_state)
        return EngineState(params, opt_state, part_state, comm_state,
                           graph_state, state.async_state,
                           privacy_state), metrics

    def init_state(params, opt_state=None, *, key=None) -> EngineState:
        """The initial state of this rank's rows (``params`` and
        ``opt_state`` hold the local rows when sharded)."""
        return init_engine_state(process, pipeline, params, opt_state,
                                 key=key, graph=graph_proc, privacy=privacy)

    def offload(state: EngineState) -> EngineState:
        if not ef_host_offload:
            return state
        return state.replace(comm_state=offload_comm_state(state.comm_state))

    def fetch(state: EngineState) -> EngineState:
        if not ef_host_offload:
            return state
        return state.replace(comm_state=fetch_comm_state(state.comm_state,
                                                         dev))

    block_step.pipeline = pipeline
    block_step.process = process
    block_step.graph = graph_proc
    block_step.config = config
    block_step.privacy = privacy
    block_step.init_state = init_state
    block_step.step_mask = step_mask
    block_step.ef_host_offload = ef_host_offload
    block_step.offload = offload
    block_step.fetch = fetch
    block_step.shard = shard
    return block_step


class ShardedEngine:
    """Engine-shaped wrapper over :func:`make_block_step`, with the
    object surface of :class:`repro_torch.core.diffusion.DiffusionEngine`:

        state = engine.init_state(params, opt_state, key=...)
        state, metrics = engine.step(state, block_batch, key)

    All keyword arguments go to :func:`make_block_step`.  ``shard`` is the
    row split (None unsharded): ``shard.local(tree)`` cuts a whole (K, ...)
    tree to this rank's rows, ``shard.gather_tree(tree)`` rebuilds it.
    """

    def __init__(self, loss_fn, config: DiffusionConfig, A=None, **kwargs):
        self.config = config
        self.step = make_block_step(loss_fn, config, A, **kwargs)
        self.pipeline = self.step.pipeline
        self.mixer = self.pipeline.mixer
        self.compressor = self.pipeline.compressor
        self.process = self.step.process
        self.graph = self.step.graph
        self.privacy = self.step.privacy
        self.init_state = self.step.init_state
        self.step_mask = self.step.step_mask
        self.ef_host_offload = self.step.ef_host_offload
        self.offload = self.step.offload
        self.fetch = self.step.fetch
        self.shard = self.step.shard

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ShardedEngine(K={self.config.num_agents}, "
                f"pipeline={self.pipeline!r}, shard={self.shard!r})")
