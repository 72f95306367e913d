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
network unrolled for the next power of two: :data:`MAX_SLOTS` slots at
most.  A wider table raises ``ValueError``; there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.gather_mix import check_table
from repro_torch.kernels.ref import gather_robust_mix_ref

__all__ = ["gather_robust_mix", "check_operands", "MAX_SLOTS", "build"]

#: widest neighbor table (D = max degree + 1) the sort network is built for
MAX_SLOTS = 32


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    from repro_torch.kernels.build import load_library

    lib = load_library("gather_robust_mix")
    fn = lib.gather_robust_mix_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
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
                            W: torch.Tensor) -> torch.Tensor:
    check_operands(idx, member, wslot, active, W)
    out = torch.empty_like(W)
    K, M = W.shape
    if K == 0 or M == 0:
        return out
    lib = build()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.gather_robust_mix_launch(
            idx.data_ptr(), member.data_ptr(), wslot.data_ptr(),
            active.data_ptr(), W.data_ptr(), out.data_ptr(), K,
            idx.shape[1], M, stream)
    if err != 0:
        raise RuntimeError(f"gather_robust_mix kernel launch failed: CUDA "
                           f"error {err} (K={K}, D={idx.shape[1]}, M={M})")
    gather_robust_mix.launches += 1
    return out


def gather_robust_mix(idx: torch.Tensor, member: torch.Tensor,
                      wslot: torch.Tensor, active: torch.Tensor,
                      W: torch.Tensor) -> torch.Tensor:
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
    Returns:
      (K, M) float32 robust-aggregated parameters.
    """
    if W.device.type == "cpu":
        return gather_robust_mix_ref(idx, member, wslot, active, W)
    dev = W.device
    idx = idx.to(device=dev, dtype=torch.int32).contiguous()
    member = member.to(device=dev, dtype=torch.float32).contiguous()
    wslot = wslot.to(device=dev, dtype=torch.float32).contiguous()
    active = active.to(device=dev, dtype=torch.float32).reshape(-1)
    return torch.ops.repro_torch.gather_robust_mix(
        idx, member, wslot, active.contiguous(), W)


#: kernel launches since the count was last reset (set it to 0 to reset)
gather_robust_mix.launches = 0
