"""The bounded-degree gather-and-mix kernel, hand-written in CUDA for
Hopper.

Counterpart of ``repro.kernels.diffusion_mix.gather_mix`` (the Pallas TPU
kernel ``_gather_mix_kernel``).  The CUDA source is ``csrc/gather_mix.cu``;
it is built with ``nvcc`` for ``sm_90a`` at first use
(:mod:`repro_torch.kernels.build`), bound through ctypes, and registered
with the PyTorch dispatcher as ``torch.ops.repro_torch.gather_mix(idx, gw,
W)`` for CUDA tensors.

:func:`gather_mix` is the wrapper callers use.  A CPU tensor takes the
plain version (:func:`repro_torch.kernels.ref.gather_mix_ref`); a CUDA
tensor launches the kernel, and a failure to build or launch raises.
``gather_mix.launches`` counts the kernel's launches.

The kernel has two routes, chosen by the plan (:func:`stage_plan`, a
function of the table alone): a block stages the union of the rows a group
of targets reads and serves the whole group (the group route), or, where
no grouping keeps that union within :data:`MAX_STAGED_ROWS`, serves one
target (the one-target route).  Both are the same op and one launch.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace

import torch

from repro_torch.kernels.ref import gather_mix_ref

__all__ = ["gather_mix", "check_operands", "check_plan", "check_table",
           "group_launch", "stage_plan", "StagePlan", "MAX_SLOTS",
           "MAX_STAGED_ROWS", "MAX_GROUP", "MAX_GROUP_SLOTS", "build"]

#: largest table width D whose row (D int32 + D float32) a block stages in
#: the 48 KB of shared memory it gets without opting in
MAX_SLOTS = 48 * 1024 // 8
#: the group route's limits (``csrc/gather_stage.cuh``): distinct rows a
#: group stages (U), targets in a group (R), and slot entries R * D
MAX_STAGED_ROWS = 16
MAX_GROUP = 16
MAX_GROUP_SLOTS = 512


@dataclass(frozen=True)
class StagePlan:
    """Which route the gather kernels take for a table, and how.

    ``group`` is R, the targets a block serves (0: the one-target route,
    and ``rows`` and ``slot`` are None).  ``rows`` is the (G, U) int32 list
    of the distinct rows each group of R consecutive targets reads
    (ascending, padded with -1), ``slot`` the (K, D) int32 position of
    ``idx[k, s]`` in its group's ``rows``.  ``order`` is the robust
    kernel's (G R,) int32 walk of each group (:func:`repro_torch.kernels.
    gather_robust_mix.share_sorts`), None until a realized draw gives it.
    """

    group: int
    rows: torch.Tensor | None = None
    slot: torch.Tensor | None = None
    order: torch.Tensor | None = None

    @property
    def route(self) -> str:
        return "group" if self.group else "target"

    @property
    def staged_rows(self) -> int:
        """U: the most rows a group stages (0 on the one-target route)."""
        return 0 if self.rows is None else int(self.rows.shape[1])

    def to(self, device) -> "StagePlan":
        move = (lambda t: None if t is None else t.to(device))
        return replace(self, rows=move(self.rows), slot=move(self.slot),
                       order=move(self.order))


def _grouped(idx: torch.Tensor, R: int) -> torch.Tensor:
    """(G, R D) rows each group of R consecutive targets reads, target by
    target; the last group is padded with copies of the last target's."""
    K, D = idx.shape
    pad = -K % R
    if pad:
        idx = torch.cat([idx, idx[-1:].expand(pad, D)])
    return idx.reshape(-1, R * D)


def _distinct(srt: torch.Tensor) -> torch.Tensor:
    """(G, R D) bool: the first occurrence of each value of a sorted row."""
    new = torch.ones_like(srt, dtype=torch.bool)
    new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    return new


def stage_plan(idx: torch.Tensor) -> StagePlan:
    """The gather kernels' plan for the (K, D) neighbour table ``idx``.

    Targets are cut into groups of R consecutive ones; a group stages the
    U distinct rows its targets read.  R is the size up to
    :data:`MAX_GROUP` (with R D <= :data:`MAX_GROUP_SLOTS`) whose groups
    need U <= :data:`MAX_STAGED_ROWS` and read the fewest rows per target
    (U / R; the larger R on a tie).  On a ring of K targets and h hops
    U <= R + 2 h, on FedAvg U = K (so K <= 16), on a grid U <= 3 R + 2.
    Where no R qualifies the plan takes the one-target route.  Computed on
    the host from ``idx`` alone; the tensors land on ``idx``'s device.
    """
    host = idx.detach().to("cpu", torch.long)
    K, D = host.shape
    best = None
    for R in range(min(K, MAX_GROUP), 0, -1):
        if R * D > MAX_GROUP_SLOTS:
            continue
        srt = _grouped(host, R).sort(dim=1).values
        U = int(_distinct(srt).sum(dim=1).max())
        if U <= MAX_STAGED_ROWS and (best is None or U / R < best[0]):
            best = (U / R, R, U)
    if best is None:
        return StagePlan(0)
    _, R, U = best
    grouped = _grouped(host, R)
    srt = grouped.sort(dim=1).values
    # each group's distinct rows first (ascending), then the sentinel K
    rows = torch.where(_distinct(srt), srt, K).sort(dim=1).values
    rows = rows[:, :U].contiguous()
    slot = torch.searchsorted(rows, grouped).reshape(-1, D)[:K]
    rows = torch.where(rows < K, rows, -1)
    return StagePlan(R, rows.to(torch.int32).contiguous(),
                     slot.to(torch.int32).contiguous()).to(idx.device)


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    from repro_torch.kernels.build import load_library

    lib = load_library("gather_mix")
    fn = lib.gather_mix_launch
    fn.argtypes = ([ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int64]
                   + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    shape = lib.gather_mix_shape
    shape.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    shape.restype = ctypes.c_int
    return lib


def group_launch(query, plan: StagePlan, D: int, K: int,
                 M: int) -> dict | None:
    """How the group route launches on the current card for a (K, M)
    buffer and table width D: blocks, ring depth (staging buffers),
    shared-memory bytes and chunk columns; None on the one-target route.
    ``query`` is a library's ``*_shape`` function."""
    if plan.group == 0:
        return None
    out = (ctypes.c_int * 4)()
    err = query(K, D, M, plan.group, plan.staged_rows, out)
    if err != 0:
        raise RuntimeError(f"launch shape query failed: CUDA error {err}")
    return dict(zip(("blocks", "stages", "smem_bytes", "chunk"), out))


def check_table(idx: torch.Tensor, W: torch.Tensor,
                **rows: torch.Tensor) -> None:
    """Raise ``ValueError`` unless ``W`` is a contiguous float32 (K, M)
    buffer, ``idx`` a contiguous int32 (K, D) table and every other (K, D)
    row operand contiguous float32, all on W's device."""
    if W.ndim != 2:
        raise ValueError(f"W must be (K, M), got shape {tuple(W.shape)}")
    K = W.shape[0]
    if idx.ndim != 2 or idx.shape[0] != K or idx.shape[1] < 1:
        raise ValueError(f"idx {tuple(idx.shape)} must be ({K}, D), D >= 1")
    D = idx.shape[1]
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")
    for name, t in rows.items():
        if tuple(t.shape) != (K, D):
            raise ValueError(f"{name} {tuple(t.shape)} must be ({K}, {D})")
    for name, t in (("idx", idx), ("W", W), *rows.items()):
        if name != "idx" and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != W.device:
            raise ValueError(f"{name} is on {t.device}, W on {W.device}")


def check_operands(idx: torch.Tensor, gw: torch.Tensor,
                   W: torch.Tensor) -> None:
    """Raise ``ValueError`` on operands the CUDA kernel does not take."""
    check_table(idx, W, gw=gw)
    if idx.shape[1] > MAX_SLOTS:
        raise ValueError(f"D={idx.shape[1]} table slots exceed the kernel's "
                         f"limit of {MAX_SLOTS}")


def check_plan(group: int, rows: torch.Tensor | None,
               slot: torch.Tensor | None, idx: torch.Tensor,
               **more: torch.Tensor | None) -> None:
    """Raise ``ValueError`` unless the plan's tensors fit the group route
    for the table ``idx`` (or the plan is the one-target route: group 0,
    no tensors).  ``more`` are further (G R,) int32 tensors of the route
    (the robust kernel's ``order``)."""
    K, D = idx.shape
    tensors = {"rows": rows, "slot": slot, **more}
    if group == 0:
        if any(t is not None for t in tensors.values()):
            raise ValueError("the one-target route takes no plan tensors")
        return
    if not 1 <= group <= MAX_GROUP or group * D > MAX_GROUP_SLOTS:
        raise ValueError(f"group of {group} targets at D={D} is outside "
                         f"the group route (R <= {MAX_GROUP}, R D <= "
                         f"{MAX_GROUP_SLOTS})")
    G = -(-K // group)
    U = -1 if rows is None or rows.ndim != 2 else rows.shape[1]
    shapes = {"rows": (G, U), "slot": (K, D),
              **{name: (G * group,) for name in more}}
    if not 1 <= U <= MAX_STAGED_ROWS:
        raise ValueError(f"rows must be ({G}, U), 1 <= U <= "
                         f"{MAX_STAGED_ROWS}")
    for name, t in tensors.items():
        if t is None or tuple(t.shape) != shapes[name]:
            raise ValueError(f"plan {name} must be {shapes[name]}")
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or t.device != idx.device):
            raise ValueError(f"plan {name} must be contiguous int32 on "
                             f"{idx.device}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


@torch.library.custom_op("repro_torch::gather_mix", mutates_args=(),
                         device_types="cuda")
def _gather_mix_cuda(idx: torch.Tensor, gw: torch.Tensor, W: torch.Tensor,
                     rows: torch.Tensor | None = None,
                     slot: torch.Tensor | None = None,
                     group: int = 0) -> torch.Tensor:
    check_operands(idx, gw, W)
    check_plan(group, rows, slot, idx)
    out = torch.empty_like(W)
    K, M = W.shape
    if K == 0 or M == 0:
        return out
    lib = build()
    D = idx.shape[1]
    U = 0 if rows is None else rows.shape[1]
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.gather_mix_launch(idx.data_ptr(), gw.data_ptr(),
                                    W.data_ptr(), out.data_ptr(), K, D, M,
                                    _ptr(rows), _ptr(slot), group, U, stream)
    if err != 0:
        raise RuntimeError(f"gather_mix kernel launch failed: CUDA error "
                           f"{err} (K={K}, D={D}, M={M}, R={group}, U={U})")
    gather_mix.launches += 1
    return out


def gather_mix(idx: torch.Tensor, gw: torch.Tensor, W: torch.Tensor,
               plan: StagePlan | None = None) -> torch.Tensor:
    """Bounded-degree linear combination over flattened stacked parameters.

    Args:
      idx: (K, D) neighbor table, values in [0, K) (slot 0 = self; padding
        = self).
      gw: (K, D) realized weights ``A_eff[idx[k, j], k] * valid[k, j]``,
        padding slots exactly 0.
      W: (K, M) stacked flattened parameters, any M.  On CUDA it must be
        float32 and contiguous (a tile of the mixers' column-tiled flatten
        is).
      plan: :func:`stage_plan` of ``idx`` on W's device; computed here
        when None.  Callers that launch on many tiles compute it once.
        Unused on the CPU.
    Returns:
      (K, M) float32: out[k] = sum_j gw[k, j] W[idx[k, j]].
    """
    if W.device.type == "cpu":
        return gather_mix_ref(idx, gw, W)
    idx = idx.to(device=W.device, dtype=torch.int32).contiguous()
    gw = gw.to(device=W.device, dtype=torch.float32).contiguous()
    if plan is None:
        check_operands(idx, gw, W)
        plan = stage_plan(idx)
    return torch.ops.repro_torch.gather_mix(idx, gw, W, plan.rows,
                                            plan.slot, plan.group)


#: kernel launches since the count was last reset (set it to 0 to reset)
gather_mix.launches = 0
