"""Agent-availability processes (participation models) for Algorithm 1.

Counterpart of ``repro.core.schedules``.  A process is a state machine:

  state  = process.init_state(key)              # () for stateless ones
  active, state = process.sample(state, key)    # (K,) float32 mask in {0,1}

``key`` is a ``torch.Generator``; the mask comes back on its device.  In
place of a generator, ``sample`` takes ``u=``, the (K,) float32 uniforms
the reference draws (replay); each threshold is formed in float32 in the
reference's order, so a uniform at a threshold selects alike.  When a
block's mask is injected instead, :meth:`ParticipationProcess.advance`
moves the state as the reference's ``sample`` would have.
``process.q_vector()`` gives the stationary per-agent activation
probabilities (the eq.-31 drift correction and the Lemma-1 closed forms).

Processes: :class:`IIDBernoulli`, the paper's model (eq. 18);
:class:`MarkovAvailability`, a two-state chain per agent (bursty
availability at the same long-run q); :class:`CyclicGroups`, deterministic
round-robin groups.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import participation as part

PyTree = Any

__all__ = ["ParticipationProcess", "IIDBernoulli", "MarkovAvailability",
           "CyclicGroups", "from_config", "resolve"]


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

    def init_state(self, key: torch.Generator, *, u=None) -> PyTree:
        """Initial process state (drawn from the stationary law)."""
        return ()

    def sample(self, state: PyTree, key: torch.Generator, *, u=None):
        """Advance one block: returns ((K,) float32 mask, new state)."""
        raise NotImplementedError

    def advance(self, state: PyTree, active) -> PyTree:
        """The state after a block whose mask ``active`` was injected:
        what ``sample`` would have returned with that mask."""
        return state

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

    def sample(self, state: PyTree, key: torch.Generator, *, u=None):
        if u is not None:
            u = part.injected_uniforms(u, self._qt.shape)
            return (u < self._qt.to(u.device)).float(), state
        return part.sample_active(key, self._qt), state


class MarkovAvailability(ParticipationProcess):
    """Two-state Markov chain per agent with stationary probability q_k.

    Transition kernel (autocorrelation ``corr`` in [0, 1)):

      P(active   -> active)   = q + corr (1 - q)
      P(inactive -> inactive) = (1 - q) + corr q

    ``corr = 0`` is :class:`IIDBernoulli`'s law; larger ``corr`` means
    longer outages at the same long-run activation frequency q.  The state
    is the current mask, kept on the device of the draws.
    """

    stateful = True

    def __init__(self, q, corr: float, num_agents: int | None = None):
        if not 0.0 <= corr < 1.0:
            raise ValueError(f"corr={corr} must lie in [0, 1)")
        self._q = _as_q(q, num_agents)
        self.corr = float(corr)
        self._qt = torch.as_tensor(self._q, dtype=torch.float32)
        # float32, in the reference's order of operations
        q32 = self._qt
        self._p_stay_active = q32 + self.corr * (1.0 - q32)
        self._p_stay_inactive = (1.0 - q32) + self.corr * q32
        self._p_wake = 1.0 - self._p_stay_inactive

    def q_vector(self) -> np.ndarray:
        return self._q

    def init_state(self, key: torch.Generator, *, u=None) -> torch.Tensor:
        if u is not None:                          # stationary draw
            u = part.injected_uniforms(u, self._qt.shape)
            return (u < self._qt.to(u.device)).float()
        return part.sample_active(key, self._qt)

    def sample(self, state: torch.Tensor, key: torch.Generator, *, u=None):
        if u is None:
            u = torch.rand(self._qt.shape, generator=key, device=key.device)
        u = part.injected_uniforms(u, self._qt.shape)
        state = torch.as_tensor(state).to(u.device)
        # both branches activate on a low-u region, so corr = 0 is exactly
        # state-independent
        active = torch.where(state > 0.5,
                             (u < self._p_stay_active.to(u.device)).float(),
                             (u < self._p_wake.to(u.device)).float())
        return active, active

    def advance(self, state: PyTree, active) -> torch.Tensor:
        if not isinstance(active, torch.Tensor):
            active = torch.from_numpy(np.array(active, dtype=np.float32))
        return active.to(torch.float32)


class CyclicGroups(ParticipationProcess):
    """Deterministic round-robin availability: agent k sits in group
    ``k % num_groups`` and the groups take turns, one a block.  The state
    is a host int32 counter of blocks."""

    stateful = True

    def __init__(self, num_agents: int, num_groups: int):
        if not 1 <= num_groups <= num_agents:
            raise ValueError(f"num_groups={num_groups} must lie in "
                             f"[1, {num_agents}]")
        self._K = int(num_agents)
        self.num_groups = int(num_groups)
        self._group = torch.arange(self._K, dtype=torch.int32) % num_groups

    def q_vector(self) -> np.ndarray:
        return np.full((self._K,), 1.0 / self.num_groups)

    def init_state(self, key: torch.Generator, *, u=None) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int32)

    def sample(self, state: torch.Tensor, key: torch.Generator, *, u=None):
        state = torch.as_tensor(state, dtype=torch.int32).cpu()
        active = (self._group == state % self.num_groups).float()
        return active, state + 1

    def advance(self, state: PyTree, active) -> torch.Tensor:
        return torch.as_tensor(state, dtype=torch.int32).cpu() + 1


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
