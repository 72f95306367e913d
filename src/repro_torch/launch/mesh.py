"""The agent mesh: the process group and the ``DeviceMesh`` the sharded
engine splits its agent rows over.

Counterpart of ``repro.launch.mesh``.  The reference's mesh shapes are TPU
pod layouts; the port's mesh is whatever ranks the process group holds:
``make_production_mesh()`` is a ``(world, 1)`` ``DeviceMesh`` over
``("data", "model")``, whose ``data`` axis carries the agents
(:mod:`repro_torch.sharding.rules`).  Functions, not module constants, so
importing this module never touches ``torch.distributed``.

``init_agent_group`` joins the group from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``) or from explicit arguments.  It picks
NCCL when each rank of the host has its own card and gloo when ranks share
one card or run on the CPU.  Gloo is the wire there, not a fallback: the
parameters stay on the card, and the agent gather stages each CUDA tensor
through pinned host buffers (:meth:`repro_torch.sharding.agents.
AgentShard.gather`).  World 1 without that environment creates no group.
"""
from __future__ import annotations

import datetime
import os

import torch

__all__ = ["init_agent_group", "make_production_mesh"]


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def init_agent_group(backend: str | None = None, *,
                     init_method: str | None = None,
                     rank: int | None = None,
                     world_size: int | None = None,
                     local_rank: int | None = None,
                     timeout_s: float = 600.0) -> str | None:
    """Join the agent process group; returns its backend, or None at world
    1 without a group.

    Args:
      backend: "nccl" | "gloo" | None (NCCL when every rank of this host
        has a card of its own, gloo otherwise).
      init_method: the rendezvous (``"file:///..."`` or
        ``"tcp://localhost:<port>"``); default ``env://`` (torchrun's
        ``MASTER_ADDR``/``MASTER_PORT``).
      rank / world_size / local_rank: explicit ranks; default torchrun's
        ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``.
      timeout_s: how long a rank waits for the others before it raises.

    An existing group is kept (its backend is returned).  A rank that
    cannot join raises.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_backend()
    rank = rank if rank is not None else _env_int("RANK")
    world = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if world is None or (world == 1 and init_method is None):
        return None
    rank = 0 if rank is None else rank
    local = local_rank if local_rank is not None else (
        _env_int("LOCAL_RANK") or 0)
    local_world = _env_int("LOCAL_WORLD_SIZE") or world
    own_cards = (torch.cuda.is_available()
                 and torch.cuda.device_count() >= local_world)
    if backend is None:
        backend = "nccl" if own_cards else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        where = ("a card each" if backend == "nccl" else
                 "sharing one card" if torch.cuda.is_available()
                 else "on the CPU")
        print(f"agents: process group of {world} ranks over {backend} "
              f"({where})")
    return backend


def make_production_mesh(world: int | None = None):
    """The ``(world, 1)`` ``DeviceMesh`` over ``("data", "model")`` of the
    initialized process group, or None at world 1 without a group (the
    sharded engine then runs on one device).  ``world`` (default: the
    group's size) must match the group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        if world in (None, 1):
            return None
        raise ValueError(f"a mesh of {world} ranks needs a process group: "
                         "call init_agent_group() (or run under torchrun)")
    W = dist.get_world_size()
    if world is not None and world != W:
        raise ValueError(f"world={world} but the process group has {W} "
                         "ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (W, 1),
                            mesh_dim_names=("data", "model"))
