"""Flash-attention forward (GQA, causal, sliding window), hand-written in
CUDA for Hopper.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` (the Pallas
TPU kernel ``_flash_kernel``).  The CUDA source is
``csrc/flash_attention.cu``; it is built with ``nvcc`` for ``sm_90a`` at
first use (:mod:`repro_torch.kernels.build`), bound through ctypes, and
registered with the PyTorch dispatcher as ``torch.ops.repro_torch.
flash_attention(q, k, v, causal, window)`` for CUDA tensors.  It has no
autograd of its own: :func:`repro_torch.kernels.ops.attention_op` wraps it
with the reference's backward.

:func:`flash_attention` is the wrapper callers use.  A CPU tensor takes the
plain version (:func:`repro_torch.kernels.ref.attention_ref`); a CUDA tensor
launches the kernel, and a failure to build or launch raises.
``flash_attention.launches`` counts the kernel's launches.

Unlike the TPU kernel, the CUDA kernel takes any sequence lengths: it
bounds its tiles by Sq and Skv, so there is no padding contract.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.ref import attention_ref

__all__ = ["flash_attention", "check_operands", "HEAD_DIMS", "build"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    from repro_torch.kernels.build import load_library

    lib = load_library("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int | None = None) -> None:
    """Raise ``ValueError`` on operands the CUDA kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, S, heads, D)")
    B, _, H, D = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({B}, Skv, Kv, {D})")
    Kv = k.shape[2]
    if Kv == 0 or H % Kv:
        raise ValueError(f"{H} query heads are not a multiple of {Kv} kv "
                         "heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one the kernel is built for "
                         f"{HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive key count, got "
                         f"{window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name} must be float32 or bfloat16, got "
                             f"{t.dtype}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, window: int) -> torch.Tensor:
    check_operands(q, k, v, window if window > 0 else None)
    out = torch.empty_like(q)
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    if out.numel() == 0:
        return out
    lib = build()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], B, Sq, Skv, H, Kv, D, int(causal),
            window, float(1.0 / np.sqrt(D)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Forward GQA attention.

    Args:
      q: (B, Sq, H, D); k, v: (B, Skv, Kv, D) with H % Kv == 0, one dtype
        (float32 or bfloat16 on CUDA), D in :data:`HEAD_DIMS`.
      causal: mask keys after the query position (positions from 0).
      window: keep only keys with position > query position - window.
    Returns:
      (B, Sq, H, D) in q's dtype, accumulated in float32.
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return torch.ops.repro_torch.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal,
        0 if window is None else int(window))


#: kernel launches since the count was last reset (set it to 0 to reset)
flash_attention.launches = 0
