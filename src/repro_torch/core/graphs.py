"""Combination graphs as a runtime layer.

Counterpart of ``repro.core.graphs``.  A :class:`GraphProcess` is a state
machine mirroring :class:`repro_torch.core.schedules.ParticipationProcess`,

    state      = graph.init_state(key)              # () for stateless ones
    A_t, state = graph.sample(state, key)           # (K, K) float32

and the realized ``A_t`` flows into the combination step as data (the
mixer contract is ``mixer(params, active, A_t)``).

Processes: :class:`StaticGraph` (the paper's fixed topology),
:class:`LinkDropout` (i.i.d. or Markov-correlated symmetric link failures,
Metropolis-reweighted), :class:`GossipMatching` (one mutual-max matching of
the base graph a block) and :class:`TimeVaryingErdos` (a fresh G(K, p)
each block, off the base support).  Every realized matrix is symmetric and
doubly stochastic.

Where draws come from.  ``key`` is a ``torch.Generator``: the (K, K)
uniforms are drawn on its device and the realized matrix is built there,
then moved to the process's ``device``, so a host generator gives the card
and the CPU the same graph.  In place of a generator, ``sample`` and
``init_state`` take ``u=``, the (K, K) float32 uniforms the reference draws
with ``jax.random.uniform(key, (K, K))`` (replay).  Every threshold is
formed as the reference forms it, rounded to float32 once, and compared in
float32, so a uniform at a threshold selects alike.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import participation as part
from repro_torch.core import topology as topo_lib

PyTree = Any

__all__ = ["GraphProcess", "StaticGraph", "LinkDropout", "GossipMatching",
           "TimeVaryingErdos", "make_graph_process",
           "metropolis_weights_torch", "resolve_mix_for_graph",
           "check_mixer_support"]


def metropolis_weights_torch(off_adj: torch.Tensor) -> torch.Tensor:
    """Metropolis–Hastings weights from a {0,1} off-diagonal adjacency:
    ``a_lk = 1 / (1 + max(deg_l, deg_k))`` on surviving edges, the self
    weight completing each column to one (the reference's
    ``metropolis_weights_jnp``).  ``off_adj`` must be symmetric with a
    zero diagonal; the result is symmetric doubly stochastic."""
    off = off_adj.to(torch.float32)
    deg = off.sum(dim=1)
    pair = torch.maximum(deg[:, None], deg[None, :])
    W = off / (1.0 + pair)
    return W + torch.diag(1.0 - W.sum(dim=0))


def _sym_uniforms(key: torch.Generator | None, u, K: int,
                  name: str) -> torch.Tensor:
    """Symmetric (K, K) uniforms with a zero diagonal: one value per
    undirected edge (the upper triangle of a (K, K) draw), mirrored.  The
    draw is ``u`` when injected, else made from ``key`` on its device."""
    if u is not None:
        u = part.injected_uniforms(u, (K, K))
    elif key is None:
        raise ValueError(f"the {name!r} graph process draws every block: "
                         "pass a torch.Generator or injected uniforms u=")
    else:
        u = torch.rand((K, K), generator=key, device=key.device)
    u = torch.triu(u, diagonal=1)
    return u + u.T


def _f32(x: float) -> torch.Tensor:
    """A threshold rounded to float32 once, as JAX rounds a Python float
    compared with a float32 array."""
    return torch.tensor(x, dtype=torch.float32)


class GraphProcess:
    """Per-block combination-matrix model.

    ``stateful`` processes carry their state in ``EngineState.graph_state``.
    ``within_base_support`` says whether every realized edge lies on the
    base topology's support (the sparse and gather mixers need it).
    ``device`` is where the realized matrices are returned (``None``: where
    they were built).
    """

    name = "base"
    stateful: bool = False
    within_base_support: bool = True
    topology: topo_lib.Topology | None = None
    device: torch.device | None = None

    @property
    def num_agents(self) -> int:
        raise NotImplementedError

    def base_matrix(self) -> torch.Tensor:
        """The (K, K) float32 base matrix (spectral-gap / theory anchor)."""
        raise NotImplementedError

    def init_state(self, key: torch.Generator | None, *, u=None) -> PyTree:
        return ()

    def sample(self, state: PyTree, key: torch.Generator | None, *, u=None):
        """Advance one block: returns ((K, K) float32 A_t, new state)."""
        raise NotImplementedError

    def _out(self, A: torch.Tensor) -> torch.Tensor:
        return A if self.device is None else A.to(self.device)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}(K={self.num_agents})"


class StaticGraph(GraphProcess):
    """The paper's fixed topology: every block sees the same matrix."""

    name = "static"

    def __init__(self, topology: topo_lib.Topology | None = None, *, A=None,
                 device=None):
        if A is None:
            if topology is None:
                raise ValueError("StaticGraph needs a topology or a matrix A")
            A = topology.A
        self.topology = topology
        self._A = torch.as_tensor(A, dtype=torch.float32, device=device)

    @property
    def num_agents(self) -> int:
        return int(self._A.shape[0])

    def base_matrix(self) -> torch.Tensor:
        return self._A

    def sample(self, state: PyTree, key: torch.Generator | None, *, u=None):
        return self._A, state


class _BaseSupport(GraphProcess):
    """A process over the base topology's off-diagonal adjacency."""

    def __init__(self, topology: topo_lib.Topology, device=None):
        self.topology = topology
        self.device = None if device is None else torch.device(device)
        K = topology.num_agents
        off = np.asarray(topology.adjacency, dtype=bool) & ~np.eye(K,
                                                                   dtype=bool)
        self._base_off = torch.as_tensor(off.astype(np.float32))

    @property
    def num_agents(self) -> int:
        return int(self._base_off.shape[0])

    def base_matrix(self) -> torch.Tensor:
        return self._out(torch.as_tensor(self.topology.A,
                                         dtype=torch.float32))


class LinkDropout(_BaseSupport):
    """Random link failures on the base graph, Metropolis-reweighted.

    Each undirected base edge is up with probability ``1 - drop`` a block;
    the surviving adjacency is reweighted by the Metropolis rule, so
    ``A_t`` is symmetric doubly stochastic (an agent whose links all failed
    holds its iterate).  ``corr`` in [0, 1) makes outages bursty: a
    two-state chain per link with the same stationary up-probability, whose
    state, the current {0,1} link mask, is ``graph_state``.
    """

    name = "link_dropout"

    def __init__(self, topology: topo_lib.Topology, drop: float,
                 corr: float = 0.0, device=None):
        if not 0.0 <= drop < 1.0:
            raise ValueError(f"drop={drop} must lie in [0, 1)")
        if not 0.0 <= corr < 1.0:
            raise ValueError(f"corr={corr} must lie in [0, 1)")
        super().__init__(topology, device)
        self.drop = float(drop)
        self.corr = float(corr)
        self.stateful = corr > 0.0
        up = 1.0 - self.drop
        # the reference's thresholds, formed in Python floats
        self._t_up = _f32(up)
        self._t_stay_up = _f32(up + self.corr * self.drop)
        self._t_up_from_down = _f32((1.0 - self.corr) * up)

    def init_state(self, key: torch.Generator | None, *, u=None) -> PyTree:
        if not self.stateful:
            return ()
        u = _sym_uniforms(key, u, self.num_agents, self.name)
        return ((u < self._t_up.to(u.device)).float()
                * self._base_off.to(u.device))

    def sample(self, state: PyTree, key: torch.Generator | None, *, u=None):
        u = _sym_uniforms(key, u, self.num_agents, self.name)
        base = self._base_off.to(u.device)
        if not self.stateful:
            up = (u < self._t_up.to(u.device)).float()
            new_state = state
        else:
            # both branches go up on a low-u region, as the reference's
            state = torch.as_tensor(state, dtype=torch.float32).to(u.device)
            up = torch.where(state > 0.5,
                             (u < self._t_stay_up.to(u.device)).float(),
                             (u < self._t_up_from_down.to(u.device)).float())
            new_state = up * base
        return self._out(metropolis_weights_torch(base * up)), new_state

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"LinkDropout(K={self.num_agents}, drop={self.drop}, "
                f"corr={self.corr})")


class GossipMatching(_BaseSupport):
    """One random pairwise matching of the base graph a block.

    Every base edge draws a symmetric uniform priority; an edge is matched
    iff it has the largest priority at both endpoints.  Matched pairs
    average with weight 1/2, unmatched agents hold.  Stateless.
    """

    name = "gossip"

    def sample(self, state: PyTree, key: torch.Generator | None, *, u=None):
        K = self.num_agents
        u = _sym_uniforms(key, u, K, self.name)
        u = u * self._base_off.to(u.device)          # priorities on edges
        rowmax = u.max(dim=1).values
        matched = ((u > 0) & (u >= rowmax[:, None])
                   & (u >= rowmax[None, :])).float()
        eye = torch.eye(K, dtype=torch.float32, device=u.device)
        A = eye - 0.5 * torch.diag(matched.sum(dim=1)) + 0.5 * matched
        return self._out(A), state


class TimeVaryingErdos(GraphProcess):
    """A fresh Erdős–Rényi graph G(K, p) every block, Metropolis-weighted.

    A realized matrix may put weight on any pair, so
    ``within_base_support`` is False and the support-bound mixers are
    rejected.  The base matrix is the topology's, else ``full``'s.
    """

    name = "tv_erdos"
    within_base_support = False

    def __init__(self, num_agents: int, p: float = 0.3,
                 topology: topo_lib.Topology | None = None, device=None):
        if not 0.0 < p <= 1.0:
            raise ValueError(f"p={p} must lie in (0, 1]")
        if num_agents < 1:
            raise ValueError(f"num_agents={num_agents} must be >= 1")
        self._K = int(num_agents)
        self.p = float(p)
        self.topology = topology
        self.device = None if device is None else torch.device(device)
        self._t_p = _f32(self.p)

    @property
    def num_agents(self) -> int:
        return self._K

    def base_matrix(self) -> torch.Tensor:
        topo = (self.topology if self.topology is not None
                else topo_lib.make_topology("full", self._K))
        return self._out(torch.as_tensor(topo.A, dtype=torch.float32))

    def sample(self, state: PyTree, key: torch.Generator | None, *, u=None):
        u = _sym_uniforms(key, u, self._K, self.name)
        adj = ((u > 0) & (u < self._t_p.to(u.device))).float()
        return self._out(metropolis_weights_torch(adj)), state

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TimeVaryingErdos(K={self._K}, p={self.p})"


def make_graph_process(kind: "str | GraphProcess",
                       topology: topo_lib.Topology | None = None, *,
                       A=None, num_agents: int | None = None,
                       drop: float = 0.3, corr: float = 0.0,
                       p: float = 0.3, device=None) -> GraphProcess:
    """Build a graph process.

    Args:
      kind: "static" | "link_dropout" | "gossip" | "tv_erdos", or an
        existing :class:`GraphProcess` (returned unchanged).
      topology: the base topology (required by link_dropout and gossip,
        optional for tv_erdos, either-or with ``A`` for static).
      A: explicit base matrix for the static graph.
      num_agents: K for tv_erdos when no topology is given.
      drop / corr: link_dropout's knobs; p: tv_erdos's edge probability.
      device: where the realized matrices are returned.
    """
    if isinstance(kind, GraphProcess):
        return kind
    if kind == "static":
        if topology is None and A is None and num_agents == 1:
            A = [[1.0]]                  # K = 1: mixing disabled anyway
        if topology is None and A is None:
            raise ValueError("the static graph needs a base topology or "
                             "matrix (pass topology= or A=)")
        return StaticGraph(topology, A=A, device=device)
    if kind in ("link_dropout", "gossip") and topology is None:
        raise ValueError(f"graph kind {kind!r} needs a base topology")
    if kind == "link_dropout":
        return LinkDropout(topology, drop=drop, corr=corr, device=device)
    if kind == "gossip":
        return GossipMatching(topology, device=device)
    if kind == "tv_erdos":
        K = (num_agents if num_agents is not None
             else topology.num_agents if topology is not None else None)
        if K is None:
            raise ValueError("tv_erdos needs num_agents or a topology")
        return TimeVaryingErdos(K, p=p, topology=topology, device=device)
    raise ValueError(f"unknown graph kind {kind!r} (expected static|"
                     "link_dropout|gossip|tv_erdos)")


def resolve_mix_for_graph(mix, graph: GraphProcess | None,
                          device=None):
    """``"auto"`` must not pick a support-bound backend for a graph that
    realizes edges off the base support: it takes the always-correct fused
    kernel on CUDA, as the reference's TPU branch does, else dense."""
    if (isinstance(mix, str) and mix == "auto" and graph is not None
            and not graph.within_base_support):
        return ("pallas" if torch.device(device or "cpu").type == "cuda"
                else "dense")
    return mix


def check_mixer_support(mixer, graph: GraphProcess | None) -> None:
    """Reject mixer/graph pairs that would silently drop edges, and tune
    the support-bound backends for the graph.

    The sparse circulant backend moves bytes only along the base
    topology's offsets and the gather backend reads only its neighbor rows,
    so both are rejected for a graph that realizes edges off that support.
    The sparse backend's auto ``skip_dead`` turns on for every graph but the
    static one (a dynamic graph can kill a whole offset).  The robust
    backends' gather machinery follows the same convention: an auto choice
    is re-derived per build (the table attached for an on-support graph
    with a known base topology, detached otherwise; the fused kernel on or
    off the same way), while an explicit ``gather="table"`` or
    ``use_kernel=True`` off support is a build-time error.

    ``tv_erdos`` is the graph off support: the sparse and gather mixers
    and an explicit gather table or fused kernel are rejected for it, and
    the auto choices detach.
    """
    from repro_torch.core import mixing

    on_support = graph is None or graph.within_base_support
    for cls, verb in ((mixing.SparseCirculantMixer,
                       "moves bytes only along the base topology's "
                       "circulant offsets"),
                      (mixing.NeighborGatherMixer,
                       "gathers only the base topology's neighbor rows")):
        if not on_support and isinstance(mixer, cls):
            raise ValueError(
                f"{cls.__name__} {verb}, but the {graph.name!r} graph "
                "process realizes edges outside that support; use "
                "mix='dense' or 'pallas'")
    if (isinstance(mixer, mixing.SparseCirculantMixer)
            and mixer._skip_dead_auto):
        mixer.skip_dead = (graph is not None
                           and not isinstance(graph, StaticGraph))
    if isinstance(mixer, mixing.FusedNeighborhoodMixer):
        if not on_support and mixer.use_kernel is True:
            raise ValueError(
                f"{type(mixer).__name__}(use_kernel=True) gathers only the "
                f"base topology's neighbor rows, but the {graph.name!r} "
                "graph process realizes edges outside that support; use "
                "gather='off' (all-slots sort)")
        if mixer._use_kernel_auto:
            mixer.use_kernel = None if on_support else False
        _sync_robust_table(mixer.inner, graph, on_support)
        return
    if isinstance(mixer, mixing._SortedRobustMixer):
        _sync_robust_table(mixer, graph, on_support)


def _sync_robust_table(mixer, graph: GraphProcess | None,
                       on_support: bool) -> None:
    """Attach or detach a robust mixer's neighbor table per the graph:
    explicit choices (``gather="table"``/``"off"``) are never touched,
    "auto" follows the graph."""
    if mixer.scope != "neighborhood":
        return
    explicit = mixer._gather_mode != "auto"
    if not on_support:
        if mixer._table is not None:
            if explicit:
                raise ValueError(
                    f"{type(mixer).__name__}(gather='table') gathers only "
                    f"the base topology's neighbor rows, but the "
                    f"{graph.name!r} graph process realizes edges outside "
                    "that support; use gather='off' (all-slots sort)")
            mixer.detach_neighbor_table()
        return
    if (mixer._table is None and not explicit and graph is not None
            and graph.topology is not None):
        mixer.attach_neighbor_table(graph.topology)
