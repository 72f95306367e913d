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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import gather_mix_ref

__all__ = ["gather_mix", "check_operands", "check_table", "MAX_SLOTS", "build"]

#: largest table width D whose row (D int32 + D float32) a block stages in
#: the 48 KB of shared memory it gets without opting in
MAX_SLOTS = 48 * 1024 // 8


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    from repro_torch.kernels.build import load_library

    lib = load_library("gather_mix")
    fn = lib.gather_mix_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


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


@torch.library.custom_op("repro_torch::gather_mix", mutates_args=(),
                         device_types="cuda")
def _gather_mix_cuda(idx: torch.Tensor, gw: torch.Tensor,
                     W: torch.Tensor) -> torch.Tensor:
    check_operands(idx, gw, W)
    out = torch.empty_like(W)
    K, M = W.shape
    if K == 0 or M == 0:
        return out
    lib = build()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.gather_mix_launch(idx.data_ptr(), gw.data_ptr(),
                                    W.data_ptr(), out.data_ptr(), K,
                                    idx.shape[1], M, stream)
    if err != 0:
        raise RuntimeError(f"gather_mix kernel launch failed: CUDA error "
                           f"{err} (K={K}, D={idx.shape[1]}, M={M})")
    gather_mix.launches += 1
    return out


def gather_mix(idx: torch.Tensor, gw: torch.Tensor,
               W: torch.Tensor) -> torch.Tensor:
    """Bounded-degree linear combination over flattened stacked parameters.

    Args:
      idx: (K, D) neighbor table, values in [0, K) (slot 0 = self; padding
        = self).
      gw: (K, D) realized weights ``A_eff[idx[k, j], k] * valid[k, j]``,
        padding slots exactly 0.
      W: (K, M) stacked flattened parameters, any M.  On CUDA it must be
        float32 and contiguous (a tile of the mixers' column-tiled flatten
        is).
    Returns:
      (K, M) float32: out[k] = sum_j gw[k, j] W[idx[k, j]].
    """
    if W.device.type == "cpu":
        return gather_mix_ref(idx, gw, W)
    idx = idx.to(device=W.device, dtype=torch.int32).contiguous()
    gw = gw.to(device=W.device, dtype=torch.float32).contiguous()
    return torch.ops.repro_torch.gather_mix(idx, gw, W)


#: kernel launches since the count was last reset (set it to 0 to reset)
gather_mix.launches = 0
