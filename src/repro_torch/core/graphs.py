"""Combination graphs as a runtime layer.

Counterpart of ``repro.core.graphs``.  A :class:`GraphProcess` is a state
machine mirroring :class:`repro_torch.core.schedules.ParticipationProcess`,

    state      = graph.init_state(key)              # () for stateless ones
    A_t, state = graph.sample(state, key)           # (K, K) float32

and the realized ``A_t`` flows into the combination step as data (the
mixer contract is ``mixer(params, active, A_t)``).

The port runs :class:`StaticGraph`, the paper's fixed topology, and
:func:`check_mixer_support` holds the support rules of the sparse, gather
and robust mixers.  The time-varying kinds (``link_dropout``, ``gossip``, ``tv_erdos``) raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import topology as topo_lib

PyTree = Any

__all__ = ["GraphProcess", "StaticGraph", "make_graph_process",
           "resolve_mix_for_graph", "check_mixer_support"]

_PENDING_KINDS = ("link_dropout", "gossip", "tv_erdos")


class GraphProcess:
    """Per-block combination-matrix model.

    ``within_base_support`` says whether every realized edge lies on the
    base topology's support (the sparse and gather mixers need it).
    """

    name = "base"
    stateful: bool = False
    within_base_support: bool = True
    topology: topo_lib.Topology | None = None

    @property
    def num_agents(self) -> int:
        raise NotImplementedError

    def init_state(self, key: torch.Generator | None) -> PyTree:
        return ()

    def sample(self, state: PyTree, key: torch.Generator | None):
        """Advance one block: returns ((K, K) float32 A_t, new state)."""
        raise NotImplementedError

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

    def sample(self, state: PyTree, key: torch.Generator | None):
        return self._A, state


def make_graph_process(kind: "str | GraphProcess",
                       topology: topo_lib.Topology | None = None, *,
                       A=None, num_agents: int | None = None,
                       device=None, **kwargs) -> GraphProcess:
    """Build a graph process: ``"static"`` (the base topology or ``A``), or
    an existing :class:`GraphProcess` (returned unchanged).  ``device`` is
    where the realized matrices live."""
    if isinstance(kind, GraphProcess):
        return kind
    if kind in _PENDING_KINDS:
        raise NotImplementedError(
            f"graph kind {kind!r} is not ported yet: see ROADMAP.md queue 1 "
            "item 18 (graph processes)")
    if kind != "static":
        raise ValueError(f"unknown graph kind {kind!r} (expected static|"
                         "link_dropout|gossip|tv_erdos)")
    if kwargs:
        raise ValueError(f"the static graph takes no kwargs, got "
                         f"{sorted(kwargs)}")
    if topology is None and A is None and num_agents == 1:
        A = [[1.0]]                  # K = 1: mixing disabled anyway
    if topology is None and A is None:
        raise ValueError("the static graph needs a base topology or matrix "
                         "(pass topology= or A=)")
    return StaticGraph(topology, A=A, device=device)


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

    The port runs only the static graph today (item 18 adds the others),
    which is always on support; the off-support branches hold the rules
    for those.
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
