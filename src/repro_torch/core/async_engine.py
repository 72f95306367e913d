"""AsyncEngine — event-driven diffusion with per-agent clocks and a
bounded-degree staleness buffer (Rizk/Yuan/Sayed, arXiv 2402.05529).

Counterpart of ``repro.core.async_engine``.  Both synchronous engines wait
on the slowest agent before every combination.  Here each agent k carries
a *local clock* that advances only when it fires; its events arrive at a
per-agent rate ``rate_k``, thinned into the block grid as an independent
Bernoulli(rate_k / max_j rate_j) tick on top of the participation draw;
and the combination reads the *last-received* neighbor iterates from a
staleness buffer instead of the neighbors' current ones:

  1. ``fire = active * tick``: an agent updates this block iff its
     participation draw succeeds AND its clock ticks;
  2. fired agents run the T local updates through the shared
     :func:`repro_torch.core.diffusion.local_update_scan` (non-fired agents
     get step size 0 and keep their iterate bit-exactly);
  3. fired agents overwrite their slots in every neighbor's buffer; each
     slot carries an *age* (blocks since last receive);
  4. fired agents combine over their buffer with age-discounted weights
     ``A_t[j, k] * discount(age_kj)``, zero past ``tau_max``; the self slot
     (always fresh) takes the removed mass, eq.-20 style, so every row sums
     to exactly 1.

The buffer is ``(K, D, ...)``-shaped on the base topology's
:meth:`~repro_torch.core.topology.Topology.neighbor_table` (D = max degree
+ 1, never K) and lives in ``EngineState.async_state`` with the per-slot
ages and the per-agent clocks, so checkpoints carry the whole asynchronous
state (:func:`repro_torch.checkpoint.save_experiment`).  The combination
is a plain batched product over the ``(K, D, n)`` buffer in float32, in
column chunks, as the reference's ``einsum`` is plain: it reads a private
stale copy per slot, which is not what the gather kernel reads (``W[idx]``).

Draws.  A block draws from its ``torch.Generator`` in the order: the
activation mask, the graph's uniforms, then the tick (skipped when every
rate equals the largest, where the tick is surely 1, so uniform rates
consume the synchronous engine's stream).  Replay parity injects the
reference's draws instead: ``part_u=``, ``graph_u=`` and ``tick_u=`` (the
uniforms of ``bernoulli(fold_in(key, 0xA5), rel_rate)``).

As the other engines' optimizer state, the buffer is refreshed in place:
``step`` consumes the state it is given.

Reduction: at ``tau_max=0`` with uniform rates the tick is surely 1 and
only neighbors that fired this block keep weight, so each fired row is
exactly the eq.-20 masked combination of the current iterates
(``tests/test_torch_async.py`` holds it against the port's
:class:`~repro_torch.core.diffusion.DiffusionEngine` step for step).

Wall-clock accounting: each fired event on agent k costs ``delay_k = 1 /
rate_k`` seconds of its local time; ``metrics["t_wall"]`` is the makespan
``max_k t_local``.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import graphs as graph_lib
from repro_torch.core import participation as part
from repro_torch.core import schedules
from repro_torch.core.diffusion import (DiffusionConfig, local_update_scan,
                                        network_msd, resolve_step_mask,
                                        stacked_grad)
from repro_torch.core.state import EngineState
from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any
LossFn = Callable[[PyTree, Any], torch.Tensor]

__all__ = ["AsyncEngine", "resolve_rates", "combine_buffer",
           "COMBINE_CHUNK_ELEMS"]

_DISCOUNTS = ("none", "exp", "poly")
_RATE_DISTS = ("uniform", "lognormal")

#: most float32 elements of the (K, D, n) buffer one combination chunk
#: widens at a time (256 MiB)
COMBINE_CHUNK_ELEMS = 1 << 26


def resolve_rates(async_spec, num_agents: int) -> np.ndarray:
    """(K,) per-agent event rates (float64) from an
    :class:`repro_torch.api.spec.AsyncSpec`.

    ``rate_dist="lognormal"`` is the straggler model: per-agent delays
    ``delay_k ~ LogNormal(0, rate_sigma)`` drawn once per run from
    ``rate_seed`` (numpy, as the reference: bit-equal), ``rate_k = 1 /
    delay_k``.  ``rate_dist="uniform"`` broadcasts ``rates`` (scalar or
    length K).
    """
    if async_spec.rate_dist not in _RATE_DISTS:
        raise ValueError(f"unknown rate_dist {async_spec.rate_dist!r} "
                         f"(expected one of {_RATE_DISTS})")
    if async_spec.rate_dist == "lognormal":
        rng = np.random.default_rng(async_spec.rate_seed)
        delays = rng.lognormal(0.0, float(async_spec.rate_sigma),
                               size=num_agents)
        rates = 1.0 / delays
    else:
        rates = np.asarray(async_spec.rates, dtype=np.float64)
        if rates.ndim == 0:
            rates = np.full((num_agents,), float(rates))
        if rates.shape != (num_agents,):
            raise ValueError(f"rates shape {rates.shape} != "
                             f"({num_agents},)")
    if (rates <= 0).any():
        raise ValueError("per-agent event rates must be positive")
    return rates


def _bshape(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Reshape a (K,) vector for broadcasting against a (K, ...) leaf."""
    return v.reshape((v.shape[0],) + (1,) * (leaf.ndim - 1))


def combine_buffer(gw: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """``out[k] = sum_d gw[k, d] * buf[k, d]`` in float32 for one (K, D,
    ...) buffer leaf: a batched (1, D) x (D, n) product per agent, in
    column chunks of at most :data:`COMBINE_CHUNK_ELEMS` widened elements.
    Returns the float32 (K, ...) result."""
    K, D = buf.shape[:2]
    flat = buf.reshape(K, D, -1)
    n = flat.shape[2]
    out = torch.empty((K, n), dtype=torch.float32, device=buf.device)
    w = gw.to(device=buf.device, dtype=torch.float32)[:, None, :]
    width = max(1, COMBINE_CHUNK_ELEMS // (K * D))
    for a in range(0, n, width):
        out[:, a:a + width] = torch.bmm(
            w, flat[:, :, a:a + width].float()).squeeze(1)
    return out.reshape((K,) + tuple(buf.shape[2:]))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class AsyncEngine:
    """Event-driven executor speaking the unified step contract.

    ``engine.step(state, block_batch, key) -> (state, metrics)`` with the
    :class:`~repro_torch.core.state.EngineState` both synchronous engines
    thread, plus the ``async_state`` this engine owns: ``{"t_local": (K,)
    float32, "ages": (K, D) int32, "buffer": (K, D, ...)}``.

    Args:
      config: the shared :class:`~repro_torch.core.diffusion.
        DiffusionConfig` (``compress`` must be "none": the staleness buffer
        is the wire format; ``mix`` a linear kind, dense|auto|gather).
      loss_fn: per-agent scalar loss ``loss_fn(params, batch)``.
      grad_transform: optional per-agent gradient transform.
      async_spec: :class:`repro_torch.api.spec.AsyncSpec`; ``None`` means
        its defaults (uniform unit rates).
      participation / graph: process overrides, as on the synchronous
        engine.  The graph must stay on base support
        (``within_base_support``): the buffer is indexed by the base
        neighbor table.
      privacy: the :class:`repro_torch.core.privacy.Privacy` tier or
        None.  The accountant advances at the realized *fired* rate (an
        agent that does not fire computes and leaks nothing), times the T
        local mechanism invocations; ``metrics["epsilon"]`` is the spent
        epsilon.  Secure-agg wire masks are refused: the buffer replaces
        the CommPipeline, and masked payloads received in different blocks
        cannot cancel.
      device: where the state and the engine's tables live (``None`` means
        CUDA).
      grad_fn: per-agent gradients over stacked trees; defaults to
        ``stacked_grad(loss_fn)``.
    """

    def __init__(self, config: DiffusionConfig, loss_fn: LossFn,
                 grad_transform=None, *, async_spec=None,
                 participation=None, graph=None, privacy=None, device=None,
                 grad_fn=None):
        if async_spec is None:
            from repro_torch.api.spec import AsyncSpec
            async_spec = AsyncSpec(enabled=True)
        if config.num_agents < 2:
            raise ValueError("AsyncEngine needs num_agents >= 2 (the "
                             "staleness buffer is built on the neighbor "
                             "table of a real topology)")
        if config.compress != "none":
            raise ValueError(
                f"AsyncEngine does not compose with compression "
                f"(compress={config.compress!r}): the staleness buffer "
                "holds full last-received iterates")
        if config.mix not in ("dense", "auto", "gather"):
            raise ValueError(
                f"AsyncEngine combines through its staleness buffer "
                f"(a linear bounded-degree gather); mix={config.mix!r} "
                "is not supported — use dense|auto|gather")
        if async_spec.discount not in _DISCOUNTS:
            raise ValueError(f"unknown discount {async_spec.discount!r} "
                             f"(expected one of {_DISCOUNTS})")
        if async_spec.tau_max < 0:
            raise ValueError("tau_max must be >= 0")
        if privacy is not None and privacy.secure_agg:
            raise ValueError(
                "AsyncEngine does not support secure-agg wire masks: the "
                "staleness buffer replaces the CommPipeline, and masked "
                "payloads received in different blocks cannot cancel — "
                "drop PrivacySpec.secure_agg or use a synchronous engine")
        self.privacy = privacy
        self.config = config
        self.loss_fn = loss_fn
        self.grad_transform = grad_transform
        self.async_spec = async_spec
        self.device = resolve_device(device)
        self.topology = config.make_topology()
        self.process, q = schedules.resolve(config, participation)
        self._q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        self.graph = graph_lib.make_graph_process(
            graph if graph is not None else config.graph, self.topology,
            num_agents=config.num_agents, device=self.device,
            **dict(config.graph_kwargs))
        if not self.graph.within_base_support:
            raise ValueError(
                f"{type(self.graph).__name__} leaves the base-topology "
                "support; the AsyncEngine staleness buffer is indexed by "
                "the base neighbor table and needs within_base_support")
        # hub-degree guard: the buffer is (K, D, ...) per leaf; on
        # heavy-tailed degrees (scale_free) D approaches K and the
        # "bounded-degree" buffer turns denser than a (K, K) exchange, so
        # the table refuses past the cap, naming the hub degree
        idx, valid = self.topology.neighbor_table(
            dmax_cap=max(config.num_agents // 2, 8))
        self._idx = torch.as_tensor(idx, dtype=torch.long,
                                    device=self.device)       # (K, D)
        self._valid = torch.as_tensor(valid, dtype=torch.float32,
                                      device=self.device)     # (K, D)
        self.step_mask = resolve_step_mask(config, self.topology,
                                           self.device)
        rates = resolve_rates(async_spec, config.num_agents)
        self.rates = rates
        self.delays = 1.0 / rates                        # seconds / event
        self._delays = torch.as_tensor(self.delays, dtype=torch.float32,
                                       device=self.device)
        rel = rates / rates.max()
        self._rel_rate = torch.as_tensor(rel, dtype=torch.float32)
        # every rate the largest: the tick is surely 1 and is not drawn
        self._tick_sure = bool((self._rel_rate == 1.0).all())
        self._q_eff = self._q * self._rel_rate.to(self.device)  # P[fire_k]
        self._grad_fn = grad_fn if grad_fn is not None else stacked_grad(
            loss_fn)

    # -- staleness discount --------------------------------------------------
    def _discount(self, ages: torch.Tensor) -> torch.Tensor:
        """Age-discount weights of ``ages`` (integer slot ages or float
        clock ages), float32; zero beyond the staleness cap."""
        s = self.async_spec
        ages = torch.as_tensor(ages)
        age = ages.to(torch.float32)
        if s.discount == "exp":
            w = torch.exp(-s.discount_rate * age)
        elif s.discount == "poly":
            w = (1.0 + age) ** (-s.discount_rate)
        else:
            w = torch.ones_like(age)
        return w * (ages <= s.tau_max).to(torch.float32)

    # -- state construction --------------------------------------------------
    def init_state(self, params: PyTree, opt_state: PyTree = None, *,
                   key: torch.Generator | None = None) -> EngineState:
        """Initial :class:`EngineState` with the async component filled:
        clocks at 0, every buffer slot holding the initial iterate at age 0
        (everything starts fresh).  Stateful processes draw their initial
        state from ``key`` (a host generator seeded 0 when none is given):
        participation first, then the graph."""
        if key is None:
            key = torch.Generator().manual_seed(0)
        part_state = (self.process.init_state(key)
                      if self.process.stateful else None)
        graph_state = (self.graph.init_state(key)
                       if self.graph.stateful else None)
        K, D = self._idx.shape
        idx = self._idx.to(tree_leaves(params)[0].device)
        async_state = {
            "t_local": torch.zeros((K,), dtype=torch.float32,
                                   device=self.device),
            "ages": torch.zeros((K, D), dtype=torch.int32,
                                device=self.device),
            "buffer": tree_map(lambda p: p[idx], params),
        }
        privacy_state = (self.privacy.init_state(self.device)
                         if self.privacy is not None else None)
        return EngineState(params, opt_state, part_state, None, graph_state,
                           async_state, privacy_state)

    def _check_state(self, state: EngineState) -> None:
        if self.process.stateful and state.part_state is None:
            raise ValueError(
                f"{type(self.process).__name__} carries participation "
                "state but state.part_state is None; build the state "
                "with engine.init_state(params, opt_state, key=...)")
        if self.graph.stateful and state.graph_state is None:
            raise ValueError(
                f"{type(self.graph).__name__} carries graph state but "
                "state.graph_state is None; build the state with "
                "engine.init_state(params, opt_state, key=...)")
        if state.async_state is None:
            raise ValueError(
                "AsyncEngine threads clocks/ages/buffer through "
                "state.async_state; build the state with "
                "engine.init_state(params, opt_state, key=...)")
        if self.privacy is not None and state.privacy_state is None:
            raise ValueError(
                "the privacy tier carries accountant state but "
                "state.privacy_state is None; build the state with "
                "engine.init_state(params, opt_state, key=...)")

    # -- the single block iteration ------------------------------------------
    def step(self, state: EngineState, block_batch: PyTree,
             key: torch.Generator | None, *, part_u=None, graph_u=None,
             tick_u=None):
        """One event-grid iteration.

        Args:
          state: :class:`EngineState` from :meth:`init_state`; its
            optimizer state and buffer are advanced in place.
          block_batch: tree with leaves (T, K, ...) on the engine's device.
          key: generator of the block's draws; may be ``None`` when every
            draw is injected.
          part_u / graph_u / tick_u: the participation process's (K,)
            uniforms, the graph's (K, K) uniforms and the clock tick's (K,)
            uniforms, injected for replay.
        Returns:
          ``(new_state, metrics)``: ``metrics["active"]`` is the realized
          (K,) *fired* mask (participation AND tick), ``"t_wall"`` the
          makespan ``max_k t_local``, ``"A_t"`` the realized (K, K) graph
          matrix, ``"weights"`` the (K, D) combination weights (rows of
          fired and non-fired agents alike; each sums to 1), ``"local_s"``
          and ``"combine_s"`` the seconds of the local updates and of the
          receive + combination, and with the privacy tier ``"epsilon"``.
        """
        with spans.span("engine.block"):
            return self._step(state, block_batch, key, part_u, graph_u,
                              tick_u)

    def _step(self, state, block_batch, key, part_u, graph_u, tick_u):
        cfg = self.config
        with spans.span("engine.prologue"):
            self._check_state(state)
            active, part_state = self.process.sample(state.part_state, key,
                                                     u=part_u)   # eq. (18)
            active = torch.as_tensor(active, dtype=torch.float32).to(
                self.device)
            A_t, graph_state = self.graph.sample(state.graph_state, key,
                                                 u=graph_u)
            if tick_u is not None:
                u = part.injected_uniforms(tick_u,
                                           tuple(self._rel_rate.shape))
                tick = (u < self._rel_rate).float()
            elif self._tick_sure:
                tick = torch.ones_like(self._rel_rate)
            else:
                tick = torch.bernoulli(self._rel_rate.to(key.device),
                                       generator=key)
            fire = active * tick.to(self.device)
            mus = part.step_size_matrix(cfg.step_size, fire, self._q_eff,
                                        cfg.drift_correction)     # (K,)
        with spans.span("engine.local_updates"):
            t0 = time.perf_counter()
            psi, opt_state = local_update_scan(
                self._grad_fn, state.params, state.opt_state, mus,
                block_batch, local_steps=cfg.local_steps,
                grad_transform=self.grad_transform, step_mask=self.step_mask)
            _sync(self.device)
            t1 = time.perf_counter()
        with spans.span("engine.combination"):
            idx = self._idx
            K = cfg.num_agents
            # receive: fired sources refresh their slots everywhere (slot
            # 0 is self: a fired agent refreshes its own entry)
            nf = fire[idx] > 0                                # (K, D)
            ages = torch.where(nf, 0, state.async_state["ages"] + 1).to(
                torch.int32)
            buffer = state.async_state["buffer"]
            if bool(nf.any()):
                src = idx[nf]
                for b, p in zip(tree_leaves(buffer), tree_leaves(psi)):
                    b[nf] = p[src].to(b.dtype)
            # combine: age-discounted realized weights over the buffer, the
            # self slot completing each row to exactly 1 (removed or
            # discounted neighbor mass folds into the always-fresh self
            # slot)
            gw = (A_t.to(device=self.device, dtype=torch.float32)[
                idx, torch.arange(K, device=self.device)[:, None]]
                * self._valid * self._discount(ages))
            gw[:, 0] = 0.0
            gw[:, 0] = 1.0 - gw.sum(dim=1)
            # non-fired agents keep their iterate bit-exactly (the eq.-20
            # inactive-keep invariant)
            keep = fire > 0
            params = tree_map(
                lambda p, b: torch.where(
                    _bshape(keep, p), combine_buffer(gw, b).to(p.dtype), p),
                psi, buffer)
            del psi
            t_local = state.async_state["t_local"] + fire * self._delays
            _sync(self.device)
            t2 = time.perf_counter()
        metrics = {"active": fire, "t_wall": t_local.max(), "A_t": A_t,
                   "weights": gw, "local_s": t1 - t0, "combine_s": t2 - t1}
        privacy_state = state.privacy_state
        if self.privacy is not None:
            privacy_state = self.privacy.advance(privacy_state, fire)
            metrics["epsilon"] = self.privacy.epsilon(privacy_state)
        new_state = EngineState(params, opt_state, part_state,
                                state.comm_state, graph_state,
                                {"t_local": t_local, "ages": ages,
                                 "buffer": buffer}, privacy_state)
        return new_state, metrics

    # -- convenience runner --------------------------------------------------
    def run(self, params: PyTree, sampler: Callable[[torch.Generator],
                                                    PyTree],
            num_blocks: int, seed: int = 0, opt_state: PyTree = None,
            w_star: PyTree | None = None):
        """Run ``num_blocks`` iterations from one CPU generator seeded with
        ``seed`` (the synchronous engine's driver loop and draw order);
        returns (params, opt_state, msd_history)."""
        key = torch.Generator().manual_seed(seed)
        state = self.init_state(params, opt_state, key=key)
        history = []
        for _ in range(num_blocks):
            state, _ = self.step(state, sampler(key), key)
            if w_star is not None:
                history.append(float(network_msd(state.params, w_star)))
        return state.params, state.opt_state, history
