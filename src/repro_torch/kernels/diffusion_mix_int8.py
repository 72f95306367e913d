"""The fused dequantize + eq.-20 mask-and-mix kernel, hand-written in CUDA
for Hopper.

Counterpart of ``repro.kernels.diffusion_mix.diffusion_mix_int8`` (the
Pallas TPU kernel ``_mix_int8_kernel``).  The CUDA source is
``csrc/diffusion_mix_int8.cu``; it is built with ``nvcc`` for ``sm_90a`` at
first use (:mod:`repro_torch.kernels.build`), bound through ctypes, and
registered with the PyTorch dispatcher as ``torch.ops.repro_torch.
diffusion_mix_int8(A, active, Wq, scales, tile_m, subtract_identity)`` for
CUDA tensors.

:func:`diffusion_mix_int8` is the wrapper callers use.  It validates the
operands as the reference does; then a CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.mix_int8_ref`) and a CUDA tensor launches
the kernel, and a failure to build or launch raises.
``diffusion_mix_int8.launches`` counts the kernel's launches.

The kernel keeps the realized (K, K) matrix in shared memory, as
``diffusion_mix`` does, so K is at most
:data:`repro_torch.kernels.diffusion_mix.MAX_AGENTS`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.diffusion_mix import MAX_AGENTS
from repro_torch.kernels.ref import mix_int8_ref

__all__ = ["diffusion_mix_int8", "check_operands", "build"]


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    from repro_torch.kernels.build import load_library

    lib = load_library("diffusion_mix_int8")
    fn = lib.diffusion_mix_int8_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int64,
                                           ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def check_operands(A: torch.Tensor, active: torch.Tensor, Wq: torch.Tensor,
                   scales: torch.Tensor, tile_m: int) -> None:
    """Raise ``ValueError`` on operands the kernel does not take: the
    reference's checks (Wq int8, ``M % tile_m == 0``, scales
    ``(K, M // tile_m)``), then the CUDA kernel's (K, types, contiguity,
    one device)."""
    if Wq.ndim != 2:
        raise ValueError(f"Wq must be (K, M), got shape {tuple(Wq.shape)}")
    K, M = Wq.shape
    if Wq.dtype != torch.int8:
        raise ValueError(f"Wq dtype {Wq.dtype} != int8")
    if tile_m <= 0 or M % tile_m:
        raise ValueError(f"M={M} not divisible by tile_m={tile_m}")
    nm = M // tile_m
    if tuple(scales.shape) != (K, nm):
        raise ValueError(f"scales shape {tuple(scales.shape)} != "
                         f"({K}, {nm})")
    if K > MAX_AGENTS:
        raise ValueError(
            f"K={K} agents exceed the kernel's limit of {MAX_AGENTS}: the "
            f"({K}, {K}) combination matrix does not fit one block's shared "
            "memory")
    if tuple(A.shape) != (K, K) or tuple(active.shape) != (K,):
        raise ValueError(f"A {tuple(A.shape)} and active "
                         f"{tuple(active.shape)} must be ({K}, {K}) and "
                         f"({K},)")
    if Wq.device.type == "cpu":
        return
    for name, t in (("A", A), ("active", active), ("scales", scales),
                    ("Wq", Wq)):
        if name != "Wq" and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != Wq.device:
            raise ValueError(f"{name} is on {t.device}, Wq on {Wq.device}")


@torch.library.custom_op("repro_torch::diffusion_mix_int8", mutates_args=(),
                         device_types="cuda")
def _diffusion_mix_int8_cuda(A: torch.Tensor, active: torch.Tensor,
                             Wq: torch.Tensor, scales: torch.Tensor,
                             tile_m: int,
                             subtract_identity: bool) -> torch.Tensor:
    check_operands(A, active, Wq, scales, tile_m)
    K, M = Wq.shape
    out = torch.empty((K, M), dtype=torch.float32, device=Wq.device)
    if K == 0 or M == 0:
        return out
    lib = build()
    with torch.cuda.device(Wq.device):
        stream = torch.cuda.current_stream(Wq.device).cuda_stream
        err = lib.diffusion_mix_int8_launch(
            A.data_ptr(), active.data_ptr(), Wq.data_ptr(),
            scales.data_ptr(), out.data_ptr(), K, M, tile_m,
            int(subtract_identity), stream)
    if err != 0:
        raise RuntimeError(f"diffusion_mix_int8 kernel launch failed: CUDA "
                           f"error {err} (K={K}, M={M}, tile_m={tile_m})")
    diffusion_mix_int8.launches += 1
    return out


def diffusion_mix_int8(A: torch.Tensor, active: torch.Tensor,
                       Wq: torch.Tensor, scales: torch.Tensor, *,
                       tile_m: int = 512,
                       subtract_identity: bool = False) -> torch.Tensor:
    """Fused dequantize + masked combination over int8 parameters.

    Args:
      A: (K, K) base combination matrix.
      active: (K,) activation mask in {0, 1}.
      Wq: (K, M) int8 quantized stack; M % tile_m == 0.  On CUDA it must
        be contiguous.
      scales: (K, M // tile_m) float32 scales, one per (agent, tile).
      subtract_identity: return (A_eff - I)^T C instead of A_eff^T C, the
        combination delta of the pipeline's correction.
    Returns:
      (K, M) float32.
    """
    if Wq.device.type == "cpu":
        check_operands(A, active, Wq, scales, tile_m)
        return mix_int8_ref(A, active, Wq, scales, tile_m=tile_m,
                            subtract_identity=subtract_identity)
    A, active, scales = (
        t.to(device=Wq.device, dtype=torch.float32).contiguous()
        for t in (A, active, scales))
    check_operands(A, active, Wq, scales, tile_m)
    return torch.ops.repro_torch.diffusion_mix_int8(
        A, active, Wq, scales, int(tile_m), bool(subtract_identity))


#: kernel launches since the count was last reset (set it to 0 to reset)
diffusion_mix_int8.launches = 0
