"""Gradient transformations for the diffusion engines.

Counterpart of ``repro.optim.optimizers``.  The paper's Algorithm 1 is plain
SGD: the engine applies the step size itself, masked by agent activation,
so each transform maps raw gradients to *updates*.  Transforms act leaf by
leaf, so they work unchanged on agent-stacked trees (leading K axis): each
agent carries its own state slice, which the combination step does not mix.

The dtypes and the arithmetic are the reference's: momentum keeps its
buffer in the parameter's dtype, Adam keeps ``m``/``v`` in float32 with a
shared int32 step counter and casts the update to the parameter's dtype.
Unlike the reference's pure functions, ``update`` advances the state's
tensors in place and returns the same state, as ``torch.optim`` does: one
set of Adam moments is alive per run, not one per local step (each set is
two float32 copies of the parameters).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["GradTransform", "sgd", "momentum", "adam"]


class GradTransform(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)``, advancing ``state`` in place."""

    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]


def sgd() -> GradTransform:
    """Identity transform — exact Algorithm 1."""
    return GradTransform(init=lambda params: None,
                         update=lambda g, s, p: (g, s))


def momentum(beta: float = 0.9) -> GradTransform:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(g, s, p):
        for m, gi in zip(tree_leaves(s), tree_leaves(g)):
            # beta takes the buffer's dtype, as JAX's weakly typed scalar
            # does
            m.mul_(torch.tensor(beta, dtype=m.dtype, device=m.device)
                   ).add_(gi.to(m.dtype))
        return s, s

    return GradTransform(init=init, update=update)


def adam(b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradTransform:
    def init(params):
        def zeros(x):
            return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

        device = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(g, s, p):
        s["t"].add_(1)
        for mi, vi, gi in zip(tree_leaves(s["m"]), tree_leaves(s["v"]),
                              tree_leaves(g)):
            gf = gi.float()
            mi.mul_(b1).add_((1 - b1) * gf)
            vi.mul_(b2).add_((1 - b2) * gf.square())
        tf = s["t"].float()
        c1 = 1 - torch.pow(torch.tensor(b1, device=tf.device), tf)
        c2 = 1 - torch.pow(torch.tensor(b2, device=tf.device), tf)
        upd = tree_map(
            lambda mi, vi, pi: ((mi / c1) / ((vi / c2).sqrt() + eps)
                                ).to(pi.dtype), s["m"], s["v"], p)
        return upd, s

    return GradTransform(init=init, update=update)
