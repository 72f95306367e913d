"""The row split of an agent stack over one mesh axis.

An agent-sharded stack holds rows ``[r K/W, (r+1) K/W)`` of every (K, ...)
leaf on rank ``r`` of the ``W`` ranks of the agent axis
(:func:`repro_torch.sharding.rules.agent_stack_pspec`).  Where ``W`` does
not divide ``K`` the rule replicates: every rank holds all K rows and the
split is the identity (correct, just not sharded).

:class:`AgentShard` is that split on one rank: which rows are local
(:meth:`~AgentShard.local`), and the all-gather of a local (K/W, ...)
block into the full (K, ...) one (:meth:`~AgentShard.gather`, over the
axis's process group).  Gloo moves host tensors: a CUDA tensor on a gloo
group is staged explicitly through pinned host buffers (one device-to-host
copy of the local rows, the gather between host buffers, one
host-to-device copy of the result).  NCCL gathers device tensors in place.
The bytes each gather put on the wire are counted by dtype
(:attr:`~AgentShard.wire`).

:class:`RowDraws` keeps world W equal to world 1 bit for bit wherever the
combination draws random numbers: every draw is made for all K rows from
the same generator (or taken from the injected full draws) on every rank,
then sliced to the local rows.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any

import torch

from repro_torch.core.compression import Draws
from repro_torch.sharding.rules import agent_stack_pspec, axis_sizes
from repro_torch.tree import tree_map

PyTree = Any

__all__ = ["AgentShard", "RowDraws", "current_shard", "local_rows"]

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("agent_shard",
                                                         default=None)


def current_shard():
    """The row split of the local updates running now (inside
    :func:`local_rows`), or None.  The agent-indexed gradient transforms
    read it: a Byzantine mask takes its local rows, the privacy noise is
    drawn for all K rows and sliced."""
    shard = _CURRENT.get()
    return shard if shard is not None and shard.sharded else None


@contextlib.contextmanager
def local_rows(shard):
    """Run the enclosed local updates on ``shard``'s rows (``None``: the
    whole stack)."""
    token = _CURRENT.set(shard)
    try:
        yield
    finally:
        _CURRENT.reset(token)


class AgentShard:
    """The agent rows of this rank on axis ``axis`` of ``mesh``.

    Args:
      mesh: a ``DeviceMesh`` (or any mesh with named axis sizes that also
        answers ``get_group(axis)`` and ``get_local_rank(axis)``).
      axis: the mesh axis that carries the agents ("data" by default).
      num_agents: K, the full stack's leading size.
    """

    def __init__(self, mesh, axis: str, num_agents: int):
        self.mesh = mesh
        self.axis = axis
        self.num_agents = K = int(num_agents)
        spec = agent_stack_pspec(mesh, axis, num_agents=K)
        self.world = axis_sizes(mesh).get(axis, 1)
        self.sharded = spec[0] is not None and self.world > 1
        if self.sharded:
            self.group = mesh.get_group(axis)
            self.rank = int(mesh.get_local_rank(axis))
            n = K // self.world
            self.rows = slice(self.rank * n, (self.rank + 1) * n)
        else:
            self.group, self.rank, self.rows = None, 0, slice(0, K)
        self.local_agents = range(K)[self.rows]
        #: bytes gathered, by dtype name (every rank's rows, this rank's
        #: view of the result)
        self.wire: dict[str, int] = {}

    @property
    def backend(self) -> str | None:
        if self.group is None:
            return None
        import torch.distributed as dist
        return dist.get_backend(self.group)

    def local(self, x):
        """This rank's rows of a full (K, ...) tensor or tree."""
        if not self.sharded:
            return x
        return tree_map(lambda t: t[self.rows], x)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The full (K, ...) tensor from every rank's local rows."""
        if not self.sharded:
            return t
        import torch.distributed as dist

        t = t.contiguous()
        name = str(t.dtype).removeprefix("torch.")
        self.wire[name] = (self.wire.get(name, 0)
                           + t.numel() * t.element_size() * self.world)
        if t.is_cuda and self.backend == "gloo":
            # gloo gathers host tensors: stage through pinned buffers
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            full = torch.empty((self.world,) + tuple(t.shape),
                               dtype=t.dtype, pin_memory=True)
            dist.all_gather(list(full.unbind(0)), host, group=self.group)
            return full.reshape((-1,) + tuple(t.shape[1:])).to(
                t.device, non_blocking=True)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def gather_tree(self, tree: PyTree) -> PyTree:
        return tree_map(self.gather, tree)

    def draws(self, key):
        """``key`` (a generator or :class:`Draws`) as draws of the local
        rows: :class:`RowDraws`, or ``key`` itself when not sharded."""
        if not self.sharded or key is None:
            return key
        return RowDraws(key, self)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"AgentShard(K={self.num_agents}, world={self.world}, "
                f"rank={self.rank}, rows={self.rows}, "
                f"sharded={self.sharded})")


class RowDraws(Draws):
    """The local rows of full-stack draws: each leaf's draw is made for all
    K rows (from the generator, or taken from the injected :class:`Draws`)
    and sliced, so every rank sees world 1's numbers."""

    def __init__(self, key, shard: AgentShard):
        super().__init__()
        self.key = key
        self.shard = shard

    def leaf(self, kind: str, i: int, shape, device) -> torch.Tensor:
        full = (self.shard.num_agents,) + tuple(shape[1:])
        if isinstance(self.key, Draws):
            x = self.key.leaf(kind, i, full, device)
        else:
            fn = torch.rand if kind == "u" else torch.randn
            x = fn(full, generator=self.key,
                   device=self.key.device).to(device)
        return x[self.shard.rows]
