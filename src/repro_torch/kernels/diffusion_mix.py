"""The eq.-20 fused mask-and-mix kernel, hand-written in CUDA for Hopper.

Counterpart of ``repro.kernels.diffusion_mix.diffusion_mix`` (the Pallas
TPU kernel ``_mix_kernel``/``_masked_matrix``).  The CUDA source is
``csrc/diffusion_mix.cu``; it is built with ``nvcc`` for ``sm_90a`` at first
use (:mod:`repro_torch.kernels.build`), bound through ctypes, and
registered with the PyTorch dispatcher as ``torch.ops.repro_torch.
diffusion_mix(A, active, W)`` for CUDA tensors.

:func:`diffusion_mix` is the wrapper callers use.  A CPU tensor takes the
plain version (:func:`repro_torch.kernels.ref.mix_ref`); a CUDA tensor
launches the kernel, and a failure to build or launch raises.
``diffusion_mix.launches`` counts the kernel's launches.

The kernel keeps the realized (K, K) matrix in shared memory, so K is
bounded by the 227 KB a block may use: :data:`MAX_AGENTS` agents.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import mix_ref

__all__ = ["diffusion_mix", "check_operands", "MAX_AGENTS", "build"]

#: dynamic shared memory a block may opt into on Hopper (bytes)
_SMEM_BYTES = 232_448

#: largest K whose (K, K) matrix and (K,) mask fit one block's shared memory
MAX_AGENTS = max(k for k in range(1, 512) if (k * k + k) * 4 <= _SMEM_BYTES)


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    from repro_torch.kernels.build import load_library

    lib = load_library("diffusion_mix")
    fn = lib.diffusion_mix_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def check_operands(A: torch.Tensor, active: torch.Tensor,
                   W: torch.Tensor) -> None:
    """Raise ``ValueError`` on operands the CUDA kernel does not take."""
    if W.ndim != 2:
        raise ValueError(f"W must be (K, M), got shape {tuple(W.shape)}")
    K = W.shape[0]
    if K > MAX_AGENTS:
        raise ValueError(
            f"K={K} agents exceed the kernel's limit of {MAX_AGENTS}: the "
            f"({K}, {K}) combination matrix does not fit one block's shared "
            f"memory ({_SMEM_BYTES} bytes)")
    if tuple(A.shape) != (K, K) or tuple(active.shape) != (K,):
        raise ValueError(f"A {tuple(A.shape)} and active "
                         f"{tuple(active.shape)} must be ({K}, {K}) and "
                         f"({K},)")
    for name, t in (("A", A), ("active", active), ("W", W)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != W.device:
            raise ValueError(f"{name} is on {t.device}, W on {W.device}")


@torch.library.custom_op("repro_torch::diffusion_mix", mutates_args=(),
                         device_types="cuda")
def _diffusion_mix_cuda(A: torch.Tensor, active: torch.Tensor,
                        W: torch.Tensor) -> torch.Tensor:
    check_operands(A, active, W)
    out = torch.empty_like(W)
    K, M = W.shape
    if K == 0 or M == 0:
        return out
    lib = build()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.diffusion_mix_launch(A.data_ptr(), active.data_ptr(),
                                       W.data_ptr(), out.data_ptr(), K, M,
                                       stream)
    if err != 0:
        raise RuntimeError(f"diffusion_mix kernel launch failed: CUDA error "
                           f"{err} (K={K}, M={M})")
    diffusion_mix.launches += 1
    return out


def diffusion_mix(A: torch.Tensor, active: torch.Tensor,
                  W: torch.Tensor) -> torch.Tensor:
    """Masked combination step over flattened stacked parameters.

    Args:
      A: (K, K) base combination matrix.
      active: (K,) activation mask in {0, 1}.
      W: (K, M) stacked flattened parameters, any M.  On CUDA it must be
        float32 and contiguous (the flatten layout of
        :class:`repro_torch.core.mixing.PallasFusedMixer` is).
    Returns:
      (K, M) mixed parameters, dtype of W.
    """
    if W.device.type == "cpu":
        return mix_ref(A, active, W)
    A = A.to(device=W.device, dtype=torch.float32).contiguous()
    active = active.to(device=W.device, dtype=torch.float32).contiguous()
    return torch.ops.repro_torch.diffusion_mix(A, active, W)


#: kernel launches since the count was last reset (set it to 0 to reset)
diffusion_mix.launches = 0
