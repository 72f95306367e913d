"""The single training-state object of the block-step contract.

Counterpart of ``repro.core.state``.  The engines expose one block
iteration

    engine.step(state: EngineState, block_batch, key) -> (EngineState, metrics)

where :class:`EngineState` bundles what Algorithm 1 threads between blocks,
with the reference's seven fields in the reference's order:

* ``params``        — the agent-stacked iterate tree, leaves ``(K, ...)``;
* ``opt_state``     — per-agent gradient-transform state (``None`` for SGD);
* ``part_state``    — participation-process state (``None`` for i.i.d.);
* ``comm_state``    — communication-pipeline memory (``None`` for the
  stateless pipelines; the error-feedback residual shaped like
  ``params``, or ``{"ref"[, "delta"]}`` in diff mode);
* ``graph_state``   — combination-graph state (``None`` for static graphs);
* ``async_state``   — event-driven engine state (``None`` for the
  bulk-synchronous engines);
* ``privacy_state`` — accountant state (``None`` for non-private runs).

Absent components are ``None``.  Build the state with
``engine.init_state(params, opt_state)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tree import tree_leaves

PyTree = Any

__all__ = ["EngineState", "init_engine_state", "check_engine_state"]


@dataclasses.dataclass(frozen=True)
class EngineState:
    """Everything a block step consumes and produces."""

    params: PyTree
    opt_state: PyTree = None
    part_state: PyTree = None
    comm_state: PyTree = None
    graph_state: PyTree = None
    async_state: PyTree = None
    privacy_state: PyTree = None

    def replace(self, **changes) -> "EngineState":
        return dataclasses.replace(self, **changes)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        have = [f.name for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None]
        return f"EngineState({', '.join(have)})"


def init_engine_state(process, pipeline, params: PyTree,
                      opt_state: PyTree = None, *,
                      key: torch.Generator | None = None,
                      graph=None, privacy=None) -> EngineState:
    """Initial-state construction: stateful participation processes, then
    stateful graphs (the link mask of a correlated :class:`~repro_torch.
    core.graphs.LinkDropout`), draw their initial state from ``key`` (a
    host generator seeded 0 when none is given), stateful pipelines
    allocate theirs, the privacy tier's accountant starts at zero on the
    parameters' device, and absent components stay ``None``."""
    part_state = comm_state = graph_state = privacy_state = None
    if key is None:
        key = torch.Generator().manual_seed(0)
    if process.stateful:
        part_state = process.init_state(key)
    if pipeline.stateful:
        comm_state = pipeline.init_state(params)
    if graph is not None and graph.stateful:
        graph_state = graph.init_state(key)
    if privacy is not None:
        privacy_state = privacy.init_state(tree_leaves(params)[0].device)
    return EngineState(params, opt_state, part_state, comm_state,
                       graph_state, privacy_state=privacy_state)


def check_engine_state(process, pipeline, state: EngineState,
                       init_hint: str, graph=None, privacy=None) -> None:
    """A stateful process, pipeline or graph, or the privacy tier, fed a
    ``None`` state component fails loudly, pointing at the engine's
    ``init_state``."""
    if process.stateful and state.part_state is None:
        raise ValueError(
            f"{type(process).__name__} carries participation state but "
            f"state.part_state is None; build the state with "
            f"{init_hint}(params, opt_state, key=...)")
    if pipeline.stateful and state.comm_state is None:
        raise ValueError(
            f"the {pipeline.mode}-mode pipeline carries communication "
            f"state but state.comm_state is None; build the state with "
            f"{init_hint}(params, ...)")
    if (graph is not None and graph.stateful
            and state.graph_state is None):
        raise ValueError(
            f"{type(graph).__name__} carries graph state but "
            f"state.graph_state is None; build the state with "
            f"{init_hint}(params, opt_state, key=...)")
    if privacy is not None and state.privacy_state is None:
        raise ValueError(
            "the privacy tier carries accountant state (per-order RDP + "
            "block counter) but state.privacy_state is None; build the "
            f"state with {init_hint}(params, ...) — a checkpoint from a "
            "non-private run cannot resume under a PrivacySpec without a "
            "fresh accountant")
