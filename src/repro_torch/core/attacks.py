"""Byzantine gradient adversaries for the local-update stage.

Counterpart of ``repro.core.attacks``.  The adversaries are engine
``grad_transform`` layers (the ``(grads, state, params) -> (updates,
state)`` protocol of :mod:`repro_torch.optim`), so an attack composes with
any optimizer and every mixing backend:

* ``sign_flip``: Byzantine agents ascend, ``g -> -scale * g``;
* ``noise``: Byzantine agents replace their gradient with ``scale *
  N(0, I)``, fresh per local step;
* ``shift``: coordinated constant-direction poisoning, ``g -> g + scale``.

Honest agents are untouched.  Which agents are Byzantine is a static (K,)
mask: evenly spaced by default (:func:`byzantine_indices`), or an explicit
agent tuple.  The defense lives on the mixer seam (the robust backends of
:mod:`repro_torch.core.mixing`).

The ``noise`` adversary keeps a step counter ``t`` in its state, as the
reference does, and draws each step's noise from a ``torch.Generator``
seeded with ``(seed, t)`` on the gradients' device: fresh per step and
reproducible, but torch's stream, not JAX's.  Its state ``{"t", "inner"}``
is advanced in place, like the port's optimizers.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.compression import seeded_generator
from repro_torch.optim import GradTransform, sgd
from repro_torch.sharding.agents import current_shard
from repro_torch.tree import tree_leaves, tree_unflatten

PyTree = Any

__all__ = ["ATTACK_KINDS", "byzantine_indices", "byzantine_mask",
           "make_attack"]

ATTACK_KINDS = ("none", "sign_flip", "noise", "shift")


def byzantine_indices(num_agents: int, num_byzantine: int) -> tuple:
    """Evenly spaced Byzantine agent indices (deterministic).

    On a ring this puts at most one adversary in each closed neighborhood
    while ``num_byzantine <= K // 3``: the regime a per-neighborhood
    trimmed mean with ``trim = 1`` tolerates.
    """
    if not 0 <= num_byzantine <= num_agents:
        raise ValueError(f"num_byzantine={num_byzantine} must lie in "
                         f"[0, {num_agents}]")
    if num_byzantine == 0:
        return ()
    return tuple(int(round(i * num_agents / num_byzantine))
                 for i in range(num_byzantine))


def byzantine_mask(num_agents: int, num_byzantine: int = 1,
                   agents: Sequence[int] = ()) -> np.ndarray:
    """(K,) float32 {0,1} mask of Byzantine agents: explicit ``agents``
    when given, evenly spaced otherwise."""
    idx = (tuple(int(a) for a in agents) if agents
           else byzantine_indices(num_agents, num_byzantine))
    mask = np.zeros((num_agents,), np.float32)
    for a in idx:
        if not 0 <= a < num_agents:
            raise ValueError(f"byzantine agent {a} out of range "
                             f"[0, {num_agents})")
        mask[a] = 1.0
    return mask


def make_attack(kind: str, num_agents: int, *, num_byzantine: int = 1,
                scale: float = 1.0, agents: Sequence[int] = (),
                seed: int = 0,
                inner: GradTransform | None = None) -> GradTransform:
    """Build a Byzantine gradient attack as a :class:`GradTransform`.

    Args:
      kind: "none" | "sign_flip" | "noise" | "shift".
      num_agents: K (the leading axis of every gradient leaf).
      num_byzantine: adversary count, evenly spaced (ignored when
        ``agents`` is given).
      scale: attack magnitude.
      agents: explicit Byzantine agent indices.
      seed: seed of the "noise" adversary.
      inner: optimizer transform the corrupted gradients feed (default:
        plain SGD, exact Algorithm 1 for the honest agents).

    Returns:
      A :class:`GradTransform` that corrupts the raw gradients and hands
      them to ``inner``.  For the stateless attacks its state is the inner
      transform's; for "noise" it is ``{"t": counter, "inner": state}``
      (allocate it with ``.init``).
    """
    inner_t = inner if inner is not None else sgd()
    if kind in (None, "none"):
        return inner_t
    if kind not in ATTACK_KINDS:
        raise ValueError(f"unknown attack kind {kind!r} "
                         f"(expected one of {ATTACK_KINDS})")
    mask_np = byzantine_mask(num_agents, num_byzantine, agents)
    scale = float(scale)

    def corrupt(grads: PyTree, gen: torch.Generator | None) -> PyTree:
        # agent-sharded local updates see their rows: the mask's rows, and
        # the noise drawn for all K rows and sliced (world 1's numbers)
        shard = current_shard()
        rows = shard.rows if shard is not None else slice(None)
        out = []
        for g in tree_leaves(grads):
            m = torch.as_tensor(mask_np[rows], device=g.device).to(
                g.dtype).reshape((g.shape[0],) + (1,) * (g.ndim - 1))
            if kind == "sign_flip":
                bad = -scale * g
            elif kind == "shift":
                bad = g + torch.tensor(scale, dtype=g.dtype, device=g.device)
            else:  # noise
                full = (num_agents,) + tuple(g.shape[1:])
                bad = scale * torch.randn(full, generator=gen,
                                          device=g.device)[rows].to(g.dtype)
            out.append((1.0 - m) * g + m * bad)
        return tree_unflatten(grads, out)

    if kind != "noise":
        def update(grads, state, params):
            return inner_t.update(corrupt(grads, None), state, params)

        return GradTransform(init=inner_t.init, update=update)

    def init(params: PyTree) -> PyTree:
        device = tree_leaves(params)[0].device
        return {"t": torch.zeros((), dtype=torch.int64, device=device),
                "inner": inner_t.init(params)}

    def update(grads, state, params):
        if state is None:
            raise ValueError(
                'the "noise" attack derives fresh noise from a counter in '
                "its transform state: allocate it with make_attack(...)"
                ".init(params)")
        # local step t's noise: one generator per (seed, t)
        gen = seeded_generator(tree_leaves(grads)[0].device, seed,
                               int(state["t"]))
        upd, inner_state = inner_t.update(corrupt(grads, gen),
                                          state["inner"], params)
        state["t"].add_(1)
        state["inner"] = inner_state
        return upd, state

    return GradTransform(init=init, update=update)
