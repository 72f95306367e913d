"""Section IV — existing algorithms as special cases of Algorithm 1.

Counterpart of ``repro.core.variants``.  Each factory returns an
:class:`repro_torch.api.ExperimentSpec` whose block recursion reduces
*exactly* to the named algorithm; materialize it with
:func:`repro_torch.api.build` (``build(spec, loss_fn, device=...)``).  The
factories return the reference's specs (their JSON is byte-equal,
``tests/test_torch_variants.py``), and ``tests/test_torch_api.py`` holds
``build(spec)`` bit-equal to the engine built by hand from a
:class:`~repro_torch.core.diffusion.DiffusionConfig`.

Every factory is also registered as a named *preset*
(``repro_torch.api.spec.PRESETS``), so the launch drivers reach it as
``--preset <name>`` through the shared spec front end.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.spec import (AttackSpec, CompressionSpec, DataSpec,
                                  ExperimentSpec, GraphSpec, MixerSpec,
                                  ParticipationSpec, PRESETS, PrivacySpec,
                                  RunSpec, TopologySpec)
from repro_torch.core.diffusion import network_msd, stacked_grad
from repro_torch.core.mixing import mix_dense
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map

__all__ = [
    "fedavg_full",
    "fedavg_partial_uniform",
    "vanilla_diffusion",
    "asynchronous_diffusion",
    "decentralized_fedavg",
    "cyclic_fedavg",
    "markov_asynchronous_diffusion",
    "link_dropout_diffusion",
    "compressed_diffusion",
    "compressed_fedavg",
    "byzantine_robust_diffusion",
    "private_diffusion",
    "heterogeneous_diffusion",
    "ExactDiffusionEngine",
]


def _q_field(q):
    """Normalize a participation argument to a spec-storable value."""
    return (tuple(float(x) for x in np.asarray(q, dtype=float).reshape(-1))
            if np.ndim(q) else float(q))


def _spec(*, K: int, T: int, mu: float, topology: str = "ring",
          participation: ParticipationSpec | None = None, q=1.0,
          mix: str = "dense", graph: GraphSpec | None = None,
          compression: CompressionSpec | None = None) -> ExperimentSpec:
    return ExperimentSpec(
        topology=TopologySpec(kind=topology),
        graph=graph or GraphSpec(),
        participation=(participation if participation is not None
                       else ParticipationSpec(kind="iid", q=_q_field(q))),
        mixer=MixerSpec(kind=mix),
        compression=compression or CompressionSpec(),
        run=RunSpec(num_agents=K, local_steps=T, step_size=mu))


def fedavg_full(K: int, T: int, mu: float, *,
                mix: str = "dense") -> ExperimentSpec:
    """FedAvg with full participation (paper eq. 39-40):
    q_k = 1, A_{iT} = (1/K) 11^T."""
    return _spec(K=K, T=T, mu=mu, topology="fedavg", q=1.0, mix=mix)


def fedavg_partial_uniform(K: int, T: int, mu: float, q: float,
                           *, mix: str = "dense") -> ExperimentSpec:
    """FedAvg with partial participation (paper eq. 42-43).

    The paper's eq. (41) uses weights 1/S over the realized active set S_i.
    With the i.i.d.-Bernoulli activation model of Algorithm 1 the closest
    member of the family is the fedavg topology (a_lk = 1/K) with q_k = q and
    eq. (20) re-normalization — active agents average over active peers with
    weight 1/K and keep the remaining mass on themselves.  For |S_i| = S this
    matches eq. (41) up to the self-weight redistribution, and exactly in
    expectation.  (Exact eq. (41) sampling — fixed-size uniform subsets — is
    provided by tests via explicit masks.)
    """
    return _spec(K=K, T=T, mu=mu, topology="fedavg", q=q, mix=mix)


def vanilla_diffusion(K: int, mu: float, topology: str = "ring",
                      *, mix: str = "dense") -> ExperimentSpec:
    """Standard diffusion (paper eq. 44-45): q_k = 1, T = 1."""
    return _spec(K=K, T=1, mu=mu, topology=topology, q=1.0, mix=mix)


def asynchronous_diffusion(K: int, mu: float, q, topology: str = "ring",
                           *, mix: str = "dense") -> ExperimentSpec:
    """Asynchronous diffusion (paper eq. 46-47): T = 1, Bernoulli q_k."""
    return _spec(K=K, T=1, mu=mu, topology=topology, q=q, mix=mix)


def decentralized_fedavg(K: int, T: int, mu: float,
                         topology: str = "ring",
                         *, mix: str = "dense") -> ExperimentSpec:
    """Decentralized FedAvg (paper eq. 48-49): q_k = 1, local updates, A."""
    return _spec(K=K, T=T, mu=mu, topology=topology, q=1.0, mix=mix)


# ---------------------------------------------------------------------------
# beyond-paper participation models (schedules.ParticipationProcess plug-ins)
# ---------------------------------------------------------------------------

def cyclic_fedavg(K: int, T: int, mu: float, num_groups: int,
                  *, mix: str = "dense") -> ExperimentSpec:
    """FedAvg with *cyclic client sampling*: the K clients are split into
    ``num_groups`` round-robin groups and exactly one group participates per
    block (deterministic, as in cyclic/incremental client-selection FL).
    The stationary activation frequency is 1/num_groups per agent, which
    ``spec.stationary_q()`` reflects so the Lemma-1 surrogates stay
    meaningful.
    """
    part = ParticipationSpec(kind="cyclic", q=1.0 / num_groups,
                             num_groups=num_groups)
    return _spec(K=K, T=T, mu=mu, topology="fedavg", participation=part,
                 mix=mix)


def markov_asynchronous_diffusion(K: int, mu: float, q, corr: float,
                                  topology: str = "ring",
                                  *, mix: str = "dense") -> ExperimentSpec:
    """Asynchronous diffusion under *bursty* availability: a two-state
    Markov chain per agent with stationary activation probability q and
    autocorrelation ``corr`` (the Rizk–Yuan–Sayed correlated-availability
    regime, arXiv:2402.05529).  ``corr = 0`` recovers
    :func:`asynchronous_diffusion` in distribution.
    """
    part = ParticipationSpec(kind="markov", q=_q_field(q), corr=float(corr))
    return _spec(K=K, T=1, mu=mu, topology=topology, participation=part,
                 mix=mix)


def link_dropout_diffusion(K: int, mu: float, *, drop: float = 0.3,
                           corr: float = 0.0, T: int = 1, q=1.0,
                           topology: str = "ring",
                           mix: str = "dense") -> ExperimentSpec:
    """Diffusion over a *time-varying* graph: every block, each link of the
    base topology fails independently with probability ``drop`` (``corr``
    makes outages bursty — a two-state Markov chain per link) and the
    surviving adjacency is Metropolis-reweighted, so every realized
    combination matrix stays symmetric doubly stochastic
    (:class:`repro_torch.core.graphs.LinkDropout`).  ``drop = 0`` recovers the
    static Metropolis topology; with ``q < 1`` both the agents AND the
    links are volatile — the full edge-device regime the paper motivates.
    """
    graph = GraphSpec(kind="link_dropout", drop=float(drop),
                      corr=float(corr))
    return _spec(K=K, T=T, mu=mu, topology=topology, q=q, mix=mix,
                 graph=graph)


# ---------------------------------------------------------------------------
# beyond-paper: compressed communication (core/compression.py plug-ins)
# ---------------------------------------------------------------------------

def compressed_diffusion(K: int, mu: float, *, topology: str = "ring",
                         T: int = 1, q=1.0, compress: str = "topk",
                         ratio: float = 0.1, sigma: float = 0.0,
                         error_feedback: bool = True,
                         gamma: float | None = None,
                         mix: str = "dense") -> ExperimentSpec:
    """Diffusion learning with a compressed combination step.

    The block recursion is Algorithm 1 with the eq.-20 exchange replaced by
    the :class:`repro_torch.core.mixing.CommPipeline`: sparsifiers (top-k /
    rand-k / Gaussian mask) run the CHOCO-style reference-difference
    exchange with consensus step ``gamma`` (implicit error feedback — the
    reference accumulates exactly what compression dropped), int8
    stochastic quantization runs the direct exchange where
    ``error_feedback`` (on by default) threads the classic EF residual.
    ``compress="none"`` recovers :func:`asynchronous_diffusion` (T = 1) /
    :func:`decentralized_fedavg` (T > 1) bit-for-bit.
    """
    comp = CompressionSpec(kind=compress, ratio=ratio, sigma=sigma,
                           error_feedback=error_feedback, gamma=gamma)
    return _spec(K=K, T=T, mu=mu, topology=topology, q=q, mix=mix,
                 compression=comp)


def compressed_fedavg(K: int, T: int, mu: float, q: float = 1.0, *,
                      compress: str = "int8", ratio: float = 1.0,
                      error_feedback: bool = True,
                      gamma: float | None = None,
                      mix: str = "dense") -> ExperimentSpec:
    """FedAvg (a_lk = 1/K) with compressed model exchange — the
    communication-efficient federated regime (int8 uplink by default).
    ``compress="none"`` recovers :func:`fedavg_partial_uniform`."""
    comp = CompressionSpec(kind=compress, ratio=ratio,
                           error_feedback=error_feedback, gamma=gamma)
    return _spec(K=K, T=T, mu=mu, topology="fedavg", q=q, mix=mix,
                 compression=comp)


# ---------------------------------------------------------------------------
# beyond-paper: Byzantine-robust diffusion (core/attacks.py adversaries vs
# the neighborhood-scoped robust backends of core/mixing.py)
# ---------------------------------------------------------------------------

def byzantine_robust_diffusion(K: int, mu: float, *, T: int = 1, q=1.0,
                               topology: str = "ring", trim: int = 1,
                               scope: str = "neighborhood",
                               attack: str = "sign_flip",
                               num_byzantine: int = 1, scale: float = 3.0,
                               mix: str = "trimmed_mean") -> ExperimentSpec:
    """Diffusion learning under Byzantine *gradient* adversaries with a
    robust combination step.

    The block recursion is Algorithm 1 with (a) the adversaries of
    :mod:`repro_torch.core.attacks` corrupting the local-update gradients of the
    ``num_byzantine`` evenly spaced Byzantine agents (sign-flip by
    default), and (b) the eq.-20 exchange replaced by an order-statistic
    robust backend (SLSGD, arXiv:1903.06996).  ``scope="neighborhood"``
    (the default) aggregates per agent over its realized neighborhood —
    tolerant to up to ``trim`` adversaries *per neighborhood*, which on a
    ring covers evenly spaced adversary counts up to ``K // 3``;
    ``scope="global"`` is the SLSGD server setting, tolerant only to
    ``trim`` adversaries *total*.  ``attack="none"`` recovers the honest
    robust network.
    """
    spec = _spec(K=K, T=T, mu=mu, topology=topology, q=q, mix=mix)
    return spec.replace(
        mixer=MixerSpec(kind=mix, trim=trim, scope=scope),
        attack=AttackSpec(kind=attack, num_byzantine=num_byzantine,
                          scale=scale))


# ---------------------------------------------------------------------------
# beyond-paper: differentially private diffusion (core/privacy.py — clip +
# Gaussian noise on local gradients, RDP accounting under the realized
# participation rate, optional secure-agg wire masks)
# ---------------------------------------------------------------------------

def private_diffusion(K: int, mu: float, *, T: int = 1, q=1.0,
                      topology: str = "ring", epsilon: float = 8.0,
                      delta: float = 1e-5, clip: float = 1.0,
                      noise_multiplier: float = 0.0,
                      secure_agg: bool = True,
                      mix: str = "dense") -> ExperimentSpec:
    """Diffusion learning under a per-agent (epsilon, delta)-DP guarantee.

    The block recursion is Algorithm 1 with (a) every agent's local-update
    gradient clipped to L2 norm ``clip`` and perturbed with Gaussian noise
    ``noise_multiplier * clip`` (DP-SGD, arXiv:1607.00133) at every one
    of the ``T`` local steps, (b) an RDP accountant threaded through
    ``EngineState.privacy_state`` whose subsampling amplification uses
    the *realized* participation rate of each block, composing the T
    mechanism invocations each block releases, and (c) pairwise-canceling
    secure-aggregation masks on the combination step (on by default), so
    wire payloads are uninformative while the eq.-20 exchange stays
    exact.  With ``noise_multiplier=0`` (the default) the multiplier is
    calibrated so the budget ``epsilon`` is spent over
    ``RunSpec.blocks * T`` invocations at the stationary participation
    rate.
    """
    spec = _spec(K=K, T=T, mu=mu, topology=topology, q=q, mix=mix)
    return spec.replace(privacy=PrivacySpec(
        enabled=True, epsilon=epsilon, delta=delta, clip=clip,
        noise_multiplier=noise_multiplier, secure_agg=secure_agg))


# ---------------------------------------------------------------------------
# beyond-paper: statistical + structural heterogeneity as first-class dials
# (api/spec.DataSpec partitions, complex-network topologies, degree-aware
# local-update counts)
# ---------------------------------------------------------------------------

def heterogeneous_diffusion(K: int, mu: float, *, T: int = 4, q=1.0,
                            topology: str = "scale_free",
                            data_kind: str = "dirichlet",
                            alpha: float = 0.1, clusters: int = 4,
                            local_steps_mode: str = "degree",
                            mix: str = "dense") -> ExperimentSpec:
    """Diffusion learning in the heterogeneous edge regime.

    The block recursion is Algorithm 1 with three heterogeneity dials
    turned at once: (a) per-agent data drawn from a label-Dirichlet
    partition at concentration ``alpha`` (``DataSpec``; alpha → 0 is
    one-class agents), (b) a Barabási–Albert scale-free base topology
    (hub-dominated degree distribution, Metropolis-reweighted so
    Assumption 1 still holds), and (c) degree-aware local-update counts
    ``T_k = max(1, round(T·d_min/d_k))`` — hubs, which already average
    many neighbors per eq.-20 exchange, run fewer eq.-17 local steps, so
    local compute decorrelates from graph centrality.  Uniform-degree
    topologies and ``alpha = inf``-like concentrations recover
    :func:`decentralized_fedavg` behavior.
    """
    spec = _spec(K=K, T=T, mu=mu, topology=topology, q=q, mix=mix)
    return spec.replace(
        data=DataSpec(kind=data_kind, alpha=alpha, clusters=clusters),
        run=dataclasses.replace(spec.run,
                                local_steps_mode=local_steps_mode))


# ---------------------------------------------------------------------------
# preset registry: uniform (K, T, mu, q, corr, num_groups) adapters so the
# launchers' --preset flag can parameterize every factory from shared flags
# ---------------------------------------------------------------------------

def _register_presets():
    adapters = {
        "fedavg_full":
            lambda K, T, mu, q, corr, num_groups: fedavg_full(K, T, mu),
        "fedavg_partial_uniform":
            lambda K, T, mu, q, corr, num_groups:
                fedavg_partial_uniform(K, T, mu, q),
        "vanilla_diffusion":
            lambda K, T, mu, q, corr, num_groups: vanilla_diffusion(K, mu),
        "asynchronous_diffusion":
            lambda K, T, mu, q, corr, num_groups:
                asynchronous_diffusion(K, mu, q),
        "decentralized_fedavg":
            lambda K, T, mu, q, corr, num_groups:
                decentralized_fedavg(K, T, mu),
        "cyclic_fedavg":
            lambda K, T, mu, q, corr, num_groups:
                cyclic_fedavg(K, T, mu, num_groups),
        "markov_asynchronous_diffusion":
            lambda K, T, mu, q, corr, num_groups:
                markov_asynchronous_diffusion(K, mu, q, corr),
        "link_dropout_diffusion":
            lambda K, T, mu, q, corr, num_groups:
                link_dropout_diffusion(K, mu, T=T, q=q),
        "compressed_diffusion":
            lambda K, T, mu, q, corr, num_groups:
                compressed_diffusion(K, mu, T=T, q=q),
        "compressed_fedavg":
            lambda K, T, mu, q, corr, num_groups:
                compressed_fedavg(K, T, mu, q),
        "byzantine_robust_diffusion":
            lambda K, T, mu, q, corr, num_groups:
                byzantine_robust_diffusion(K, mu, T=T, q=q),
        "private_diffusion":
            lambda K, T, mu, q, corr, num_groups:
                private_diffusion(K, mu, T=T, q=q),
        "heterogeneous_diffusion":
            lambda K, T, mu, q, corr, num_groups:
                heterogeneous_diffusion(K, mu, T=T, q=q),
    }
    for name, fn in adapters.items():
        def adapted(K, T, mu, q=1.0, corr=0.5, num_groups=2, _fn=fn):
            return _fn(K, T, mu, q, corr, num_groups)
        adapted.__name__ = name
        PRESETS.register(name)(adapted)


_register_presets()


# ---------------------------------------------------------------------------
# beyond-paper: exact diffusion (bias-corrected ATC, the paper's ref. [39])
# ---------------------------------------------------------------------------

class ExactDiffusionEngine:
    """Exact diffusion / ED-ATC (Yuan, Alghunaim, Ying, Sayed, 2020).

    Removes the O(mu^2) heterogeneity bias of standard diffusion under
    *full* participation via the correction step

        psi_i  = w_{i-1} - mu grad(w_{i-1})
        phi_i  = psi_i + w_{i-1} - psi_{i-1}
        w_i    = bar-A phi_i ,          bar-A = (A + I)/2

    for the T = 1, q = 1 regime the original analysis covers.  (Combining
    exact diffusion with partial participation is open research: the
    correction state of an inactive agent would stale; it is not claimed
    here.)  Accepts a :class:`~repro_torch.core.diffusion.DiffusionConfig`
    or an :class:`~repro_torch.api.spec.ExperimentSpec`; ``device`` as the
    other engines (``None`` means CUDA), ``grad_fn`` the per-agent
    gradients over stacked trees (default ``stacked_grad(loss_fn)``).
    """

    def __init__(self, config, loss_fn, *, device=None, grad_fn=None):
        if isinstance(config, ExperimentSpec):
            config = config.to_diffusion_config()
        if config.local_steps != 1:
            raise ValueError("exact diffusion is defined for T = 1")
        self.config = config
        self.device = resolve_device(device)
        self.topology = config.make_topology()
        A_bar = (self.topology.A + np.eye(config.num_agents)) / 2.0
        self._A_bar = torch.as_tensor(A_bar, dtype=torch.float32,
                                      device=self.device)
        self.loss_fn = loss_fn
        self._grad_fn = grad_fn if grad_fn is not None else stacked_grad(
            loss_fn)

    def step(self, w, psi_prev, batch):
        """One block: ``(w, psi_prev, batch) -> (w_new, psi)`` with
        ``batch`` one local step's (K, ...) leaves."""
        g = self._grad_fn(w, batch)
        with torch.no_grad():
            mu = self.config.step_size
            psi = tree_map(lambda x, gx: x - mu * gx, w, g)       # adapt
            phi = tree_map(lambda p, x, pp: p + x - pp, psi, w,
                           psi_prev)                             # correct
            w_new = mix_dense(self._A_bar, phi)                  # combine
        return w_new, psi

    def run(self, w0, sampler, num_blocks: int, seed: int = 0,
            w_star=None):
        """``num_blocks`` blocks from one CPU generator seeded ``seed``;
        ``sampler(key)`` returns (T = 1, K, ...) leaves.  Returns (w,
        msd history)."""
        key = torch.Generator().manual_seed(seed)
        w, psi_prev = w0, w0
        hist = []
        for _ in range(num_blocks):
            batch = tree_map(lambda x: x[0], sampler(key))        # T = 1
            w, psi_prev = self.step(w, psi_prev, batch)
            if w_star is not None:
                hist.append(float(network_msd(w, w_star)))
        return w, hist
