"""Serving-side primitives: consensus extraction and the double-buffered
parameter store.

Counterpart of ``repro.core.serving``.  :func:`consensus_from_stacked`
collapses a ``(K, ...)``-stacked agent checkpoint to the consensus model
through the mixing layer; with ``mix="pallas"`` (or ``"auto"`` on CUDA)
that is one launch of the fused eq.-20 kernel.
"""
from __future__ import annotations

import threading
from typing import Any

import torch

from repro_torch.core.mixing import NullMixer, make_mixer
from repro_torch.core.topology import averaging_matrix, make_topology, spectral_gap
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["consensus_from_stacked", "ParamStore", "CONSENSUS_QUANTIZE"]

#: accepted values for the ``quantize`` argument (reference names)
CONSENSUS_QUANTIZE = ("none", "int8")

_ROBUST = ("trimmed_mean", "median", "adaptive_trim")


def consensus_from_stacked(stacked, K: int, mix: str = "dense", *,
                           topology=None, quantize: str | None = None,
                           weights=None):
    """Collapse (K, ...)-stacked agent params to the consensus model via
    the mixing layer, over the topology the checkpoint was trained on.

    With the default ``topology=None`` (spec-less checkpoints) the base
    graph is FedAvg and one all-active combination step makes every agent
    hold the exact network mean.  With an explicit topology, the linear
    backends ported here (dense / pallas) take the exact (1/K) 11^T
    averaging matrix as their ``A_t`` operand — one step, exact mean.

    ``weights`` (a (K,) nonnegative vector) switches to the freshness-
    weighted consensus ``sum_k w_k x_k / sum_k w_k``; all-zero weights fall
    back to the uniform mean.

    Takes agent 0 at the end, as a copy, so the mixed stack is freed.

    Not ported yet: ``quantize="int8"`` (ROADMAP.md queue 1 item 20) and the
    robust backends with their ``trim``/``scope`` arguments (item 21) raise
    ``NotImplementedError``.
    """
    if (isinstance(stacked, dict) and "params" in stacked
            and ("async_state" in stacked or "opt_state" in stacked)):
        # dict-shaped engine state: the consensus comes from the param stack
        stacked = stacked["params"]
    if quantize not in (None,) + CONSENSUS_QUANTIZE:
        raise ValueError(f"quantize={quantize!r} not in {CONSENSUS_QUANTIZE}")
    if quantize == "int8":
        raise NotImplementedError(
            "int8 consensus extraction is not ported yet: see ROADMAP.md "
            "queue 1 item 20 (compression)")
    if mix in _ROBUST:
        raise NotImplementedError(
            f"robust consensus ({mix!r}) is not ported yet: see ROADMAP.md "
            "queue 1 item 21 (robust aggregation)")
    device = tree_leaves(stacked)[0].device
    if weights is not None:
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=device).reshape(-1)
        if tuple(w.shape) != (K,):
            raise ValueError(f"weights shape {tuple(w.shape)} != ({K},)")
        total = w.sum()
        w = torch.where(total > 0, w / torch.clamp(total, min=1e-12),
                        torch.full((K,), 1.0 / K, device=device))
        return tree_map(
            lambda x: torch.tensordot(w, x.float(), dims=1).to(x.dtype),
            stacked)
    topo = topology if topology is not None else make_topology("fedavg", K)
    mixer = make_mixer(mix, topo, num_agents=K, device=device)
    A = torch.as_tensor(topo.A, dtype=torch.float32, device=device)
    ones = torch.ones((K,), dtype=torch.float32, device=device)
    gap = spectral_gap(topo.A)
    if not (gap >= 1.0 - 1e-9 or isinstance(mixer, NullMixer)):
        # dense / pallas apply ANY matrix: one exact averaging step (the
        # reference iterates only for the sparse and robust backends, which
        # raise above)
        A = torch.as_tensor(averaging_matrix(K), dtype=torch.float32,
                            device=device)
    mixed = mixer(stacked, ones, A)
    return tree_map(lambda x: x[0].clone(), mixed)


class ParamStore:
    """Generation-counted double buffer for the served parameters.

    :meth:`swap` fills the inactive buffer and then publishes
    ``(buffer index, generation)`` under a lock; :meth:`snapshot` returns
    the ``(params, generation)`` pair under the same lock, so a reader never
    observes a half-published update.  Published trees are never written in
    place, so a decode that captured a snapshot keeps its checkpoint.
    """

    def __init__(self, params: PyTree):
        self._buffers = [params, params]
        self._active = 0
        self._generation = 0
        self._lock = threading.Lock()

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def snapshot(self) -> tuple[PyTree, int]:
        """The active params and their generation, as one consistent pair."""
        with self._lock:
            return self._buffers[self._active], self._generation

    def swap(self, new_params: PyTree) -> int:
        """Publish ``new_params`` as the next generation; returns it."""
        nxt = 1 - self._active
        self._buffers[nxt] = new_params
        with self._lock:
            self._active = nxt
            self._generation += 1
            return self._generation
