"""Serving-side primitives: consensus extraction and the double-buffered
parameter store.

Counterpart of ``repro.core.serving``.  :func:`consensus_from_stacked`
collapses a ``(K, ...)``-stacked agent checkpoint to the consensus model
through the mixing layer; with ``mix="pallas"`` (or ``"auto"`` on CUDA)
that runs the fused eq.-20 kernel, with ``mix="gather"`` the gather kernel
and with a neighborhood-robust mixer the fused gather-sort kernel on CUDA;
``quantize="int8"`` collapses from int8-quantized leaves.
"""
from __future__ import annotations

import threading
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.core.compression import Int8Stochastic
from repro_torch.core.mixing import NullMixer, make_mixer
from repro_torch.core.topology import averaging_matrix, make_topology, spectral_gap
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["consensus_from_stacked", "ParamStore", "CONSENSUS_QUANTIZE"]

#: accepted values for the ``quantize`` argument (reference names)
CONSENSUS_QUANTIZE = ("none", "int8")

_ROBUST = ("trimmed_mean", "median", "adaptive_trim")

#: most combination rounds a support-bound consensus runs (the reference's
#: cap)
_CONSENSUS_MAX_ROUNDS = 512


def consensus_rounds(mixer, gap: float) -> int:
    """Combination rounds of a consensus through ``mixer`` on a base
    graph of spectral gap ``gap``, as the reference counts them, or 0 for
    a mixer that applies the exact averaging matrix once.

    One round for a complete graph, for matrix-oblivious mixers (global
    robust aggregation, none); 0 for the mixers that apply any matrix
    (dense, the fused kernel); otherwise, for the support-bound mixers
    (sparse, gather) and the neighborhood-robust ones, enough rounds of
    the base matrix for ``(1 - gap)^rounds`` to fall below float32
    resolution, capped at ``_CONSENSUS_MAX_ROUNDS`` with a warning.

    The gather mixer counts as support-bound.  The reference sends it down
    the "any matrix" branch, but it reads only the base topology's
    neighbor rows, so the averaging matrix is off its support there and the
    result is not the mean (ROADMAP.md queue 3); the port iterates the base
    matrix, as the reference's docstring promises.
    """
    from repro_torch.core.mixing import (NeighborGatherMixer,
                                         SparseCirculantMixer)

    needs_support = (isinstance(mixer, (SparseCirculantMixer,
                                        NeighborGatherMixer))
                     or not mixer.linear)
    if (gap >= 1.0 - 1e-9 or isinstance(mixer, NullMixer)
            or not mixer.uses_matrix):
        return 1
    if not needs_support:
        return 0
    # the disagreement contracts by (1 - gap) per linear step: stop once
    # it is below float32 resolution
    needed = int(max(1, np.ceil(np.log(1e-7)
                                / np.log(max(1.0 - gap, 1e-12)))))
    rounds = min(_CONSENSUS_MAX_ROUNDS, needed)
    if rounds < needed:
        warnings.warn(
            f"consensus extraction capped at {rounds} combination rounds "
            f"but the topology's spectral gap ({gap:.2e}) needs ~{needed} "
            f"to converge: ~{(1.0 - gap) ** rounds:.0%} of the "
            "disagreement remains; re-extract with --mix dense for the "
            "exact mean", stacklevel=3)
    return rounds


def consensus_from_stacked(stacked, K: int, mix="dense", *,
                           trim: int = 1, scope: str = "global",
                           topology=None, quantize: str | None = None,
                           quantize_seed: int = 0, weights=None):
    """Collapse (K, ...)-stacked agent params to the consensus model via
    the mixing layer, over the topology the checkpoint was trained on.

    With the default ``topology=None`` (spec-less checkpoints) the base
    graph is FedAvg and one all-active combination step makes every agent
    hold the exact network mean.  With an explicit topology, the mixers
    that apply any matrix (dense, pallas) take the exact (1/K) 11^T
    averaging matrix, one step; the support-bound mixers (sparse, gather)
    and the neighborhood-robust ones iterate the base matrix
    (:func:`consensus_rounds`); the global robust ones apply once.
    ``mix`` is a mixer name for ``make_mixer`` (with ``trim``/``scope``)
    or a built :class:`~repro_torch.core.mixing.Mixer`.

    ``weights`` (a (K,) nonnegative vector) switches to the freshness-
    weighted consensus ``sum_k w_k x_k / sum_k w_k``; all-zero weights fall
    back to the uniform mean.  A robust backend refuses it: a weighted
    mean of its inputs is not its robust aggregate.

    ``quantize="int8"`` first re-encodes every stacked leaf with the
    training-side int8 stochastic quantizer
    (:class:`~repro_torch.core.compression.Int8Stochastic`: per-agent
    scales, unbiased; the uniforms drawn leaf after leaf from a generator
    on the stack's device seeded with ``quantize_seed``) and collapses from
    the dequantized leaves, as the reference does; the fused int8 kernel is
    not on this path.  Deterministic given ``quantize_seed`` on one device.

    Takes agent 0 at the end, as a copy, so the mixed stack is freed.
    """
    if (isinstance(stacked, dict) and "params" in stacked
            and ("async_state" in stacked or "opt_state" in stacked)):
        # dict-shaped engine state: the consensus comes from the param stack
        stacked = stacked["params"]
    if quantize not in (None,) + CONSENSUS_QUANTIZE:
        raise ValueError(f"quantize={quantize!r} not in {CONSENSUS_QUANTIZE}")
    device = tree_leaves(stacked)[0].device
    if quantize == "int8":
        comp = Int8Stochastic()
        q, scales = comp.encode_quantized(
            stacked, torch.Generator(device=device).manual_seed(
                int(quantize_seed)))
        stacked = comp.dequantize(q, scales, stacked)
        del q, scales
    if weights is not None:
        if mix in _ROBUST or getattr(mix, "linear", True) is False:
            raise ValueError(
                f"freshness weights need a linear collapse; the {mix!r} "
                "backend is an order statistic: a weighted mean of its "
                "inputs is not its robust aggregate")
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
    mixer = make_mixer(mix, topo, num_agents=K, trim=trim, scope=scope,
                       device=device)
    A = torch.as_tensor(topo.A, dtype=torch.float32, device=device)
    ones = torch.ones((K,), dtype=torch.float32, device=device)
    rounds = consensus_rounds(mixer, spectral_gap(topo.A))
    if rounds == 0:
        # dense / pallas apply ANY matrix: one exact averaging step
        A = torch.as_tensor(averaging_matrix(K), dtype=torch.float32,
                            device=device)
        rounds = 1
    mixed = stacked
    for _ in range(rounds):
        mixed = mixer(mixed, ones, A)
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
