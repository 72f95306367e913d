"""The fused neighborhood gather + sort + order-statistic mix kernel,
hand-written in CUDA for Hopper.

Counterpart of ``repro.kernels.diffusion_mix.gather_robust_mix`` (the
Pallas TPU kernel ``_gather_robust_kernel`` with ``_bitonic_sort``).  The
CUDA source is ``csrc/gather_robust_mix.cu``; it is built with ``nvcc`` for
``sm_90a`` at first use (:mod:`repro_torch.kernels.build`), bound through
ctypes, and registered with the PyTorch dispatcher as
``torch.ops.repro_torch.gather_robust_mix(idx, member, wslot, active, W)``
for CUDA tensors.

:func:`gather_robust_mix` is the wrapper callers use.  A CPU tensor takes
the plain version (:func:`repro_torch.kernels.ref.gather_robust_mix_ref`);
a CUDA tensor launches the kernel, and a failure to build or launch raises.
``gather_robust_mix.launches`` counts the kernel's launches.

The kernel sorts the D gathered values of a column in registers through a
network of ``csrc/sort_networks.cuh``: :data:`MAX_SLOTS` slots at most.  A
wider table raises ``ValueError``; there is no fallback.  Its routes are
those of :mod:`repro_torch.kernels.gather_mix` (the plan of
:func:`~repro_torch.kernels.gather_mix.stage_plan`); on the group route
the targets of a group whose member sets are equal share one sort, in the
walk :func:`share_sorts` gives.
"""
from __future__ import annotations

import ctypes
from dataclasses import replace

import torch

from repro_torch.kernels.gather_mix import (StagePlan, _ptr, check_plan,
                                            check_table, stage_plan)
from repro_torch.kernels.ref import gather_robust_mix_ref

__all__ = ["gather_robust_mix", "check_operands", "share_sorts",
           "LEADER", "INACTIVE", "SAME", "TARGET", "MAX_SLOTS", "build"]

#: widest neighbor table (D = max degree + 1) the sort networks cover
MAX_SLOTS = 32
#: flags of an ``order`` entry, above the target's index (``e & TARGET``)
LEADER = 1 << 30
INACTIVE = 1 << 29
SAME = 1 << 28
TARGET = SAME - 1


def share_sorts(plan: StagePlan, idx: torch.Tensor, member: torch.Tensor,
                wslot: torch.Tensor, active: torch.Tensor) -> StagePlan:
    """``plan`` with the robust kernel's walk of each group for one
    realized draw (the one-target route needs none and comes back as it
    is).

    ``order`` (G R,) int32 lists each group's targets: the active ones set
    by set, where a set is the multiset of rows a target's members read
    (equal sets sort equal values), each set's first target flagged
    :data:`LEADER` (it sorts); then the inactive ones, flagged
    :data:`INACTIVE`; then the padding of the last group.  An active target
    that is not a leader and whose ``wslot`` row is bit-equal to the one
    before it in the walk is flagged :data:`SAME`: its result is that
    target's.  An entry is the target's index (``e & TARGET``) plus its
    flags.  Pure torch on ``idx``'s device, no host sync.
    """
    if plan.group == 0:
        return plan
    R = plan.group
    K, D = idx.shape
    dev = idx.device
    G = plan.rows.shape[0]
    pad = G * R - K
    act = active.to(dev).reshape(-1) > 0
    # a target's member rows, ascending, non-members as K: equal keys,
    # equal sorted values
    key = torch.where(member.to(dev) > 0, idx.to(dev, torch.long), K)
    key = torch.cat([key.sort(dim=1).values,
                     torch.full((pad, D), -1, dtype=torch.long, device=dev)])
    act = torch.cat([act, torch.zeros(pad, dtype=torch.bool, device=dev)])
    key, act = key.reshape(G, R, D), act.reshape(G, R)
    same = ((key[:, :, None, :] == key[:, None, :, :]).all(dim=-1)
            & act[:, None, :])
    t = torch.arange(R, device=dev).expand(G, R)
    lead = same.to(torch.uint8).argmax(dim=2)            # first equal target
    # inactive targets after the active ones, the padding (the last
    # targets of the last group) after them
    local = torch.argsort(torch.where(act, lead, R) * R + t, dim=1)
    walk = local + R * torch.arange(G, device=dev)[:, None]
    leader = (act & (lead == t)).gather(1, local)
    live = act.gather(1, local)
    bits = wslot.to(dev, torch.float32).contiguous().view(torch.int32)
    bits = torch.cat([bits, torch.zeros((pad, D), dtype=torch.int32,
                                        device=dev)])[walk]     # (G, R, D)
    repeat = torch.zeros_like(live)
    repeat[:, 1:] = (bits[:, 1:] == bits[:, :-1]).all(dim=-1)
    flags = (torch.where(leader, LEADER, 0)
             + torch.where(live, 0, INACTIVE)
             + torch.where(live & ~leader & repeat, SAME, 0))
    order = (walk + flags).reshape(-1).to(torch.int32)
    return replace(plan, order=order)


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    from repro_torch.kernels.build import load_library

    lib = load_library("gather_robust_mix")
    fn = lib.gather_robust_mix_launch
    fn.argtypes = ([ctypes.c_void_p] * 6
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int64]
                   + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    shape = lib.gather_robust_mix_shape
    shape.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    shape.restype = ctypes.c_int
    return lib


def check_operands(idx: torch.Tensor, member: torch.Tensor,
                   wslot: torch.Tensor, active: torch.Tensor,
                   W: torch.Tensor) -> None:
    """Raise ``ValueError`` on operands the CUDA kernel does not take."""
    if idx.ndim == 2 and idx.shape[1] > MAX_SLOTS:
        raise ValueError(
            f"D={idx.shape[1]} table slots exceed the kernel's sort network "
            f"of at most {MAX_SLOTS} slots (max degree {MAX_SLOTS - 1})")
    check_table(idx, W, member=member, wslot=wslot)
    if tuple(active.shape) != (W.shape[0],):
        raise ValueError(f"active {tuple(active.shape)} must be "
                         f"({W.shape[0]},)")
    if (active.dtype != torch.float32 or not active.is_contiguous()
            or active.device != W.device):
        raise ValueError("active must be contiguous float32 on W's device")


@torch.library.custom_op("repro_torch::gather_robust_mix", mutates_args=(),
                         device_types="cuda")
def _gather_robust_mix_cuda(idx: torch.Tensor, member: torch.Tensor,
                            wslot: torch.Tensor, active: torch.Tensor,
                            W: torch.Tensor,
                            rows: torch.Tensor | None = None,
                            slot: torch.Tensor | None = None,
                            order: torch.Tensor | None = None,
                            group: int = 0) -> torch.Tensor:
    check_operands(idx, member, wslot, active, W)
    check_plan(group, rows, slot, idx, order=order)
    out = torch.empty_like(W)
    K, M = W.shape
    if K == 0 or M == 0:
        return out
    lib = build()
    D = idx.shape[1]
    U = 0 if rows is None else rows.shape[1]
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.gather_robust_mix_launch(
            idx.data_ptr(), member.data_ptr(), wslot.data_ptr(),
            active.data_ptr(), W.data_ptr(), out.data_ptr(), K, D, M,
            _ptr(rows), _ptr(slot), _ptr(order), group, U, stream)
    if err != 0:
        raise RuntimeError(f"gather_robust_mix kernel launch failed: CUDA "
                           f"error {err} (K={K}, D={D}, M={M}, R={group}, "
                           f"U={U})")
    gather_robust_mix.launches += 1
    return out


def gather_robust_mix(idx: torch.Tensor, member: torch.Tensor,
                      wslot: torch.Tensor, active: torch.Tensor,
                      W: torch.Tensor,
                      plan: StagePlan | None = None) -> torch.Tensor:
    """Fused neighborhood gather + order-statistic selection + mix.

    Args:
      idx: (K, D) neighbor table, values in [0, K) (slot 0 = self; padding
        = self), D <= :data:`MAX_SLOTS` on CUDA.
      member: (K, D) {0, 1} realized membership (self slot 1, padding 0).
      wslot: (K, D) weights over the ascending sorted member values (rows
        of a robust mixer's ``_slot_weights``), zero on every slot >= S_k.
      active: (K,) activation mask; an inactive target keeps its own row
        exactly.
      W: (K, M) stacked flattened parameters, any M.  On CUDA it must be
        float32 and contiguous.
      plan: :func:`~repro_torch.kernels.gather_mix.stage_plan` of ``idx``
        on W's device, with or without this draw's :func:`share_sorts`;
        what is missing is computed here.  Callers that launch on many
        tiles compute it once.  Unused on the CPU.
    Returns:
      (K, M) float32 robust-aggregated parameters.
    """
    if W.device.type == "cpu":
        return gather_robust_mix_ref(idx, member, wslot, active, W)
    dev = W.device
    idx = idx.to(device=dev, dtype=torch.int32).contiguous()
    member = member.to(device=dev, dtype=torch.float32).contiguous()
    wslot = wslot.to(device=dev, dtype=torch.float32).contiguous()
    active = active.to(device=dev,
                       dtype=torch.float32).reshape(-1).contiguous()
    if plan is None:
        check_operands(idx, member, wslot, active, W)
        plan = stage_plan(idx)
    if plan.group and plan.order is None:
        plan = share_sorts(plan, idx, member, wslot, active)
    return torch.ops.repro_torch.gather_robust_mix(
        idx, member, wslot, active, W, plan.rows, plan.slot, plan.order,
        plan.group)


#: kernel launches since the count was last reset (set it to 0 to reset)
gather_robust_mix.launches = 0
