"""Agent-availability processes (participation models) for Algorithm 1.

Counterpart of ``repro.core.schedules``.  A process is a state machine:

  state  = process.init_state(key)              # () for stateless ones
  active, state = process.sample(state, key)    # (K,) float32 mask in {0,1}

``key`` is a ``torch.Generator``; the mask comes back on its device.
``process.q_vector()`` gives the stationary per-agent activation
probabilities (the eq.-31 drift correction and the Lemma-1 closed forms).

The port runs the paper's i.i.d. Bernoulli model (eq. 18).
:class:`MarkovAvailability` and :class:`CyclicGroups` raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import participation as part

PyTree = Any

__all__ = ["ParticipationProcess", "IIDBernoulli", "MarkovAvailability",
           "CyclicGroups", "from_config", "resolve"]

_PENDING = "ROADMAP.md queue 1 item 18 (the remaining schedules)"


def _as_q(q, num_agents: int | None) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    if q.ndim == 0:
        if num_agents is None:
            raise ValueError("scalar q needs num_agents")
        q = np.full((num_agents,), float(q))
    if num_agents is not None and q.shape != (num_agents,):
        raise ValueError(f"q shape {q.shape} != ({num_agents},)")
    if ((q < 0) | (q > 1)).any():
        raise ValueError("activation probabilities must lie in [0, 1]")
    return q


class ParticipationProcess:
    """Availability model driving the activation mask of Algorithm 1.

    ``stateful`` processes carry their state in ``EngineState.part_state``;
    stateless ones (i.i.d. Bernoulli) leave it ``None``.
    """

    stateful: bool = False

    @property
    def num_agents(self) -> int:
        return int(self.q_vector().shape[0])

    def q_vector(self) -> np.ndarray:
        """Stationary activation probabilities (K,) — Lemma-1 inputs."""
        raise NotImplementedError

    def init_state(self, key: torch.Generator) -> PyTree:
        """Initial process state (drawn from the stationary law)."""
        return ()

    def sample(self, state: PyTree, key: torch.Generator):
        """Advance one block: returns ((K,) float32 mask, new state)."""
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}(K={self.num_agents})"


class IIDBernoulli(ParticipationProcess):
    """The paper's activation model (eq. 18): active_k ~ Bernoulli(q_k)
    i.i.d.  Stateless; the Lemma-1 closed forms are exact."""

    stateful = False

    def __init__(self, q, num_agents: int | None = None):
        self._q = _as_q(q, num_agents)
        self._qt = torch.as_tensor(self._q, dtype=torch.float32)

    def q_vector(self) -> np.ndarray:
        return self._q

    def sample(self, state: PyTree, key: torch.Generator):
        return part.sample_active(key, self._qt), state


class MarkovAvailability(ParticipationProcess):
    """Two-state Markov availability per agent: not ported yet."""

    stateful = True

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"MarkovAvailability is not ported yet: "
                                  f"see {_PENDING}")


class CyclicGroups(ParticipationProcess):
    """Round-robin availability: not ported yet."""

    stateful = True

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"CyclicGroups is not ported yet: see "
                                  f"{_PENDING}")


def from_config(config) -> IIDBernoulli:
    """Default process for a :class:`repro_torch.core.diffusion.
    DiffusionConfig`: i.i.d. Bernoulli with the config's q vector."""
    return IIDBernoulli(config.q_vector())


def resolve(config, participation: ParticipationProcess | None):
    """Default and validate a process against a config.  Returns
    ``(process, q)`` with q the stationary (K,) float64 vector."""
    process = (participation if participation is not None
               else from_config(config))
    q = process.q_vector()
    if q.shape != (config.num_agents,):
        raise ValueError(f"participation process is over {q.shape[0]} "
                         f"agents, config has {config.num_agents}")
    if config.drift_correction and (q <= 0).any():
        raise ValueError("drift correction requires q_k > 0")
    return process, q
