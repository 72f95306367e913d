"""Algorithm 1 — diffusion learning with local updates and partial agent
participation (paper eq. 25) — stacked-agent execution engine.

Counterpart of ``repro.core.diffusion``.  All K agents live on the leading
axis of every parameter leaf.  One *block step* performs:

  1. the activation mask from the participation process (eq. 18) and the
     realized step sizes (eq. 18, or eq. 31 with drift correction),
  2. ``T`` local stochastic-gradient updates in :func:`local_update_scan`
     (eq. 17 with A_{iT+t} = I for t != T),
  3. one combination step through the engine's
     :class:`repro_torch.core.mixing.CommPipeline` (eq. 20).

The step contract is the reference's,

    engine.step(state: EngineState, block_batch, key) -> (EngineState, metrics)

with ``key`` a ``torch.Generator``.  A block draws from it in a fixed order:
the activation mask, then the graph's uniforms (the static graph draws
nothing), then the compression seed.  Replay parity (torch cannot replay
JAX's random streams) injects the realized draws instead: ``active=`` a
mask, ``part_u=`` the participation process's uniforms, ``graph_u=`` the
graph's, ``comm_key=`` the compression draws.
The optimizer state is advanced in place (:mod:`repro_torch.optim`), so
``step`` consumes the state it is given: the returned state holds the same
optimizer tensors, and the old state is not to be stepped again.

Per-agent gradients.  The reference vmaps ``grad(loss)`` over the agent
axis.  The port gives the stacked (K, ...) leaves ``requires_grad``, sums
the K per-agent losses (agent k's loss reads only its own slice) and takes
one ``torch.autograd.grad``: agent k's slice of the result is exactly
``grad(loss_k)``, since the other terms contribute exact zeros.  This needs
no batching rule for the custom attention op.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import compression
from repro_torch.core import graphs as graph_lib
from repro_torch.core import mixing
from repro_torch.core import participation as part
from repro_torch.core import schedules
from repro_torch.core import topology as topo_lib
from repro_torch.core.state import (EngineState, check_engine_state,
                                    init_engine_state)
from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any
LossFn = Callable[[PyTree, Any], torch.Tensor]

__all__ = ["DiffusionConfig", "DiffusionEngine", "EngineState",
           "degree_local_steps", "local_steps_mask", "local_update_scan",
           "network_msd", "resolve_step_mask", "stacked_grad"]


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Hyper-parameters of Algorithm 1 (the reference's fields)."""

    num_agents: int
    local_steps: int = 1                 # T
    step_size: float = 0.01              # mu
    topology: str = "ring"               # ring|grid|full|fedavg|erdos|...
    topology_kwargs: tuple = ()          # extra kwargs as sorted (k, v) pairs
    graph: str = "static"                # static|link_dropout|gossip|tv_erdos
    graph_kwargs: tuple = ()             # graph-process kwargs, sorted (k, v)
    participation: Any = 1.0             # scalar or length-K sequence of q_k
    drift_correction: bool = False       # eq. (31): mu/q_k for active agents
    mix: str = "dense"                   # dense|sparse|pallas|gather|auto|
                                         # none|trimmed_mean|median|
                                         # adaptive_trim
    compress: str = "none"               # none|topk|randk|int8|gauss
    compress_ratio: float = 1.0          # kept fraction (topk/randk/gauss)
    compress_sigma: float = 0.0          # Gaussian-mask noise scale (gauss)
    error_feedback: bool = False
    comm_mode: str = "auto"              # auto|identity|direct|diff
    comm_gamma: Any = None               # consensus step (None: auto)
    local_steps_mode: str = "uniform"    # uniform|degree (per-agent T_k)

    def q_vector(self) -> np.ndarray:
        q = np.asarray(self.participation, dtype=np.float64)
        if q.ndim == 0:
            q = np.full((self.num_agents,), float(q))
        if q.shape != (self.num_agents,):
            raise ValueError(f"participation shape {q.shape} != "
                             f"({self.num_agents},)")
        if ((q < 0) | (q > 1)).any():
            raise ValueError("participation probabilities must lie in [0, 1]")
        if self.drift_correction and (q <= 0).any():
            raise ValueError("drift correction requires q_k > 0")
        return q

    def make_topology(self) -> topo_lib.Topology:
        return topo_lib.make_topology(
            self.topology, self.num_agents, **dict(self.topology_kwargs))


def _bshape(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Reshape a (K,) vector for broadcasting against a (K, ...) leaf."""
    return v.reshape((v.shape[0],) + (1,) * (leaf.ndim - 1))


def degree_local_steps(topology, local_steps: int) -> np.ndarray:
    """Per-agent local-update counts for ``local_steps_mode="degree"``:
    ``T_k = max(1, round(T * d_min / d_k))``; on a regular graph every
    agent keeps the full T."""
    K = topology.num_agents
    off = np.asarray(topology.adjacency, dtype=bool) & ~np.eye(K, dtype=bool)
    deg = np.maximum(off.sum(axis=1), 1)
    return np.maximum(
        1, np.round(local_steps * deg.min() / deg)).astype(np.int32)


def local_steps_mask(t_k: np.ndarray, local_steps: int,
                     device=None) -> torch.Tensor:
    """(T, K) float32 step mask: row t is 1 for agents still updating at
    local step t (``t < T_k``), 0 once frozen."""
    t_k = np.asarray(t_k)
    mask = np.arange(local_steps)[:, None] < t_k[None, :]
    return torch.as_tensor(mask.astype(np.float32), device=device)


def resolve_step_mask(config: DiffusionConfig, topology,
                      device=None) -> torch.Tensor | None:
    """The (T, K) freeze mask a config's ``local_steps_mode`` denotes;
    ``None`` for the uniform mode and for a degree law that collapses to
    uniform (regular graphs), so the update runs the unmasked path."""
    mode = config.local_steps_mode
    if mode == "uniform":
        return None
    if mode != "degree":
        raise ValueError(f"unknown local_steps_mode {mode!r} — valid "
                         "modes: ['degree', 'uniform']")
    t_k = degree_local_steps(topology, config.local_steps)
    if (t_k == config.local_steps).all():
        return None
    return local_steps_mask(t_k, config.local_steps, device)


def stacked_grad(loss_fn: LossFn):
    """Per-agent gradients over a stacked tree, without ``vmap``:
    ``grad_fn(params, batch)`` with leaves (K, ...) returns the (K, ...)
    tree whose slice k is the gradient of ``loss_fn(params[k], batch[k])``.
    """
    def grad_fn(params: PyTree, batch: PyTree) -> PyTree:
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        K = leaves[0].shape[0]
        # one unbind per leaf: its backward stacks the K slices' gradients
        slices = [leaf.unbind(0) for leaf in leaves]
        with torch.enable_grad():
            total = sum(
                loss_fn(tree_unflatten(params, [s[k] for s in slices]),
                        tree_map(lambda x, k=k: x[k], batch))
                for k in range(K))
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        return tree_unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, leaves)])
    return grad_fn


def local_update_scan(grad_fn, params: PyTree, opt_state: PyTree,
                      mus: torch.Tensor, block_batch: PyTree, *,
                      local_steps: int, grad_transform=None,
                      step_mask: torch.Tensor | None = None):
    """The T local stochastic-gradient updates of Algorithm 1 (eq. 17).

    Args:
      grad_fn: per-agent gradient ``grad_fn(params, batch_t)`` over stacked
        trees (:func:`stacked_grad`).
      params / opt_state: stacked (K, ...) trees.
      mus: (K,) realized per-agent step sizes (already activation-masked).
      block_batch: tree with leaves (T, K, ...).
      local_steps: T.
      grad_transform: optional ``(grads, state, params) -> (updates,
        state)`` that advances ``state`` in place (:mod:`repro_torch.optim`).
      step_mask: optional (T, K) freeze mask (:func:`local_steps_mask`): a
        frozen agent takes the identity update for both its parameters and
        its optimizer state; leaves without the (K, ...) agent axis (Adam's
        step counter, the privacy transform's noise counter) advance as
        usual.
    Returns:
      (params, opt_state) after T updates; ``opt_state`` is the argument,
      advanced in place.  The update ``w - mu_k u`` is taken in the
      parameter's dtype, under ``torch.no_grad()``.
    """
    p, s = params, opt_state
    for t in range(local_steps):
        batch_t = tree_map(lambda x: x[t], block_batch)
        grads = grad_fn(p, batch_t)
        with torch.no_grad():
            if grad_transform is None:
                updates = grads
            else:
                frozen = _frozen_slices(s, step_mask, t)
                updates, s = grad_transform(grads, s, p)
                for leaf, (idx, old) in frozen:
                    leaf[idx] = old
            del grads
            m = mus if step_mask is None else mus * step_mask[t].to(mus.dtype)
            p = tree_map(lambda w, g: w - _bshape(m, w).to(w.dtype)
                         * g.to(w.dtype), p, updates)
            del updates
    return p, s


def _frozen_slices(opt_state: PyTree, step_mask: torch.Tensor | None,
                   t: int) -> list:
    """(leaf, (agent indices, their slices)) of the agents that local step
    ``t`` freezes, for each optimizer-state leaf with the (K, ...) agent
    axis: written back after the in-place update, they keep those agents'
    state as it was.  Other leaves (a shared step or noise counter, the
    ``None`` state of a stateless inner transform) are left to advance."""
    if step_mask is None or opt_state is None or bool(step_mask[t].all()):
        return []
    idx = torch.nonzero(step_mask[t] == 0).flatten()
    K = step_mask.shape[1]
    return [(leaf, (idx, leaf[idx])) for leaf in tree_leaves(opt_state)
            if isinstance(leaf, torch.Tensor) and leaf.ndim >= 1
            and leaf.shape[0] == K]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DiffusionEngine:
    """Stacked-agent executor for Algorithm 1.

    Args:
      config: diffusion hyper-parameters.
      loss_fn: per-agent scalar loss ``loss_fn(params, batch)`` on one
        agent's tree and minibatch.
      grad_transform: optional per-agent gradient transformation applied
        before the step-size mask (:mod:`repro_torch.optim`); default the
        identity (plain SGD, as in the paper).  A Byzantine attack
        (:func:`repro_torch.core.attacks.make_attack`) wraps the optimizer
        and comes in here: raw gradients, then the attack, then the
        optimizer, as the reference's ``build`` orders them.
      mixer: a :class:`~repro_torch.core.mixing.Mixer` or a name for
        :func:`~repro_torch.core.mixing.make_mixer`; defaults to
        ``config.mix``.
      trim, scope, gather: the robust backends' per-side trim, scope
        ("global" | "neighborhood") and bounded-degree policy ("auto" |
        "table" | "fused" | "off"), handed to ``make_mixer`` (the
        reference's ``MixerSpec`` fields).
      participation: a :class:`~repro_torch.core.schedules.
        ParticipationProcess`; defaults to i.i.d. Bernoulli with the
        config's q vector.
      compressor: the compression stage, a
        :class:`~repro_torch.core.compression.Compressor`; defaults to the
        config's ``compress`` / ``compress_ratio`` / ``compress_sigma`` /
        ``error_feedback``.  The pipeline takes ``comm_mode`` and
        ``comm_gamma`` and the base matrix; stateful pipelines (error
        feedback, diff mode) carry their memory in
        ``EngineState.comm_state``.
      privacy: the differential-privacy tier, a
        :class:`repro_torch.core.privacy.Privacy`, or ``None``
        (non-private).  The engine advances its RDP accountant every block
        at the realized participation rate after the combination
        (``EngineState.privacy_state``; ``metrics["epsilon"]``) and routes
        the combination through the secure-agg wire masks when the tier
        asks for them.  The clip+noise transform itself comes in composed
        through ``grad_transform`` (:meth:`~repro_torch.core.privacy.
        Privacy.wrap`), as the reference's ``build`` composes it.
      graph: a :class:`~repro_torch.core.graphs.GraphProcess` or a kind
        name; defaults to ``config.graph`` with ``config.graph_kwargs``.
      grad_fn: per-agent gradients over stacked trees,
        ``grad_fn(params, batch)``; defaults to ``stacked_grad(loss_fn)``
        (the §VII regression's closed form:
        :meth:`repro_torch.data.synthetic.RegressionData.grad_fn`).
      device: where the engine's matrices, masks and step sizes live
        (``None`` means CUDA); the parameters must live there too.
    """

    def __init__(self, config: DiffusionConfig, loss_fn: LossFn,
                 grad_transform=None, *, mixer=None, participation=None,
                 compressor=None, graph=None, privacy=None, device=None,
                 trim: int = 1, scope: str = "global",
                 gather: str = "auto", grad_fn=None):
        self.config = config
        self.loss_fn = loss_fn
        self.grad_transform = grad_transform
        self.device = resolve_device(device)
        self.topology = config.make_topology()
        self.process, q = schedules.resolve(config, participation)
        self._q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        self.graph = graph_lib.make_graph_process(
            graph if graph is not None else config.graph, self.topology,
            num_agents=config.num_agents, device=self.device,
            **dict(config.graph_kwargs))
        self.mixer = mixing.make_mixer(
            graph_lib.resolve_mix_for_graph(
                mixer if mixer is not None else config.mix, self.graph,
                self.device),
            self.topology, num_agents=config.num_agents, trim=trim,
            scope=scope, gather=gather, device=self.device)
        graph_lib.check_mixer_support(self.mixer, self.graph)
        if compressor is None:
            compressor = compression.make_compressor(
                config.compress, ratio=config.compress_ratio,
                error_feedback=config.error_feedback,
                sigma=config.compress_sigma)
        self.privacy = privacy
        self.pipeline = mixing.CommPipeline(
            self.mixer, compressor, mode=config.comm_mode,
            gamma=config.comm_gamma, base_A=self.topology.A,
            secure_agg=(privacy.make_mask_stage() if privacy is not None
                        else None))
        self.compressor = self.pipeline.compressor
        self.step_mask = resolve_step_mask(config, self.topology,
                                           self.device)
        self._grad_fn = grad_fn if grad_fn is not None else stacked_grad(
            loss_fn)

    def init_state(self, params: PyTree, opt_state: PyTree = None, *,
                   key: torch.Generator | None = None) -> EngineState:
        """The initial :class:`EngineState` for :meth:`step`."""
        return init_engine_state(self.process, self.pipeline, params,
                                 opt_state, key=key, graph=self.graph,
                                 privacy=self.privacy)

    def step(self, state: EngineState, block_batch: PyTree,
             key: torch.Generator | None, *, active=None, comm_key=None,
             part_u=None, graph_u=None):
        """One block iteration of Algorithm 1.

        Args:
          state: :class:`EngineState` with ``params`` leaves (K, ...); its
            optimizer state is advanced in place.
          block_batch: tree with leaves (T, K, ...) on the engine's device.
          key: generator of the block's draws (any device; the mask and
            the realized matrix are moved to the engine's).  May be
            ``None`` when every draw the block makes is injected.
          active: a realized (K,) mask to use instead of drawing one; a
            stateful process's state advances as its draw would have
            (:meth:`~repro_torch.core.schedules.ParticipationProcess.
            advance`).
          part_u: the participation process's (K,) uniforms (replay).
          graph_u: the graph process's (K, K) uniforms (replay).
          comm_key: the compression stage's draws: a generator or injected
            :class:`~repro_torch.core.compression.Draws` (replay; for the
            secure-agg masks, ``Draws(noise=eta)``).  Without
            it, a pipeline that draws takes a generator on the engine's
            device seeded by one draw from ``key``, after the activation
            and graph draws.
        Returns:
          ``(new_state, metrics)``: ``metrics["active"]`` is the realized
          (K,) mask, ``metrics["A_t"]`` the realized (K, K) matrix,
          ``metrics["local_s"]`` and ``metrics["combine_s"]`` the
          seconds of the local updates and of the combination (host clock
          around work that ends in a device sync), and with the privacy
          tier ``metrics["epsilon"]`` the spent epsilon (a float32 tensor).
        """
        cfg = self.config
        check_engine_state(self.process, self.pipeline, state,
                           "engine.init_state", graph=self.graph,
                           privacy=self.privacy)
        part_state = state.part_state
        if active is None:
            active, part_state = self.process.sample(part_state, key,
                                                     u=part_u)
        else:
            part_state = self.process.advance(part_state, active)
        active = torch.as_tensor(active, dtype=torch.float32).to(self.device)
        A_t, graph_state = self.graph.sample(state.graph_state, key,
                                             u=graph_u)
        if comm_key is None and self.pipeline.needs_key:
            comm_key = compression.device_stream(key, self.device)
        mus = part.step_size_matrix(cfg.step_size, active, self._q,
                                    cfg.drift_correction)
        t0 = time.perf_counter()
        params, opt_state = local_update_scan(
            self._grad_fn, state.params, state.opt_state, mus, block_batch,
            local_steps=cfg.local_steps, grad_transform=self.grad_transform,
            step_mask=self.step_mask)
        _sync(self.device)
        t1 = time.perf_counter()
        params, comm_state = self.pipeline(params, active, A_t,
                                           state.comm_state, comm_key)
        _sync(self.device)
        metrics = {"active": active, "A_t": A_t, "local_s": t1 - t0,
                   "combine_s": time.perf_counter() - t1}
        privacy_state = state.privacy_state
        if self.privacy is not None:
            privacy_state = self.privacy.advance(privacy_state, active)
            metrics["epsilon"] = self.privacy.epsilon(privacy_state)
        return EngineState(params, opt_state, part_state, comm_state,
                           graph_state, state.async_state,
                           privacy_state), metrics

    def run(self, params: PyTree, sampler: Callable[[torch.Generator],
                                                    PyTree],
            num_blocks: int, seed: int = 0, opt_state: PyTree = None,
            w_star: PyTree | None = None):
        """Run ``num_blocks`` block iterations from one CPU generator seeded
        with ``seed`` (so every device realizes the same draws).

        ``sampler(key)`` returns a block batch with leaves (T, K, ...).  If
        ``w_star`` is given, records the per-block network MSD.
        Returns (params, opt_state, msd_history list).
        """
        key = torch.Generator().manual_seed(seed)
        state = self.init_state(params, opt_state, key=key)
        history = []
        for _ in range(num_blocks):
            state, _ = self.step(state, sampler(key), key)
            if w_star is not None:
                history.append(float(network_msd(state.params, w_star)))
        return state.params, state.opt_state, history


def network_msd(params: PyTree, w_star: PyTree) -> torch.Tensor:
    """(1/K) sum_k ||w_k - w*||^2 over all leaves (stacked layout)."""
    sq = 0.0
    K = None
    for p, w in zip(tree_leaves(params), tree_leaves(w_star)):
        K = p.shape[0]
        diff = p - torch.broadcast_to(w, p.shape)
        sq = sq + torch.sum(diff.float() ** 2)
    return sq / K
