"""The Mamba2 SSD intra-chunk step, hand-written in CUDA for Hopper.

Counterpart of ``repro.kernels.ssd_scan`` (the Pallas TPU kernel
``_ssd_chunk_kernel`` behind ``ssd_intra_chunk``).  The CUDA source is
``csrc/ssd_scan.cu``; it is built with ``nvcc`` for ``sm_90a`` at first use
(:mod:`repro_torch.kernels.build`), bound through ctypes, and registered
with the PyTorch dispatcher as ``torch.ops.repro_torch.ssd_intra_chunk(xd,
dA, B, C, chunk)`` for CUDA tensors.  It has no autograd of its own:
:func:`repro_torch.kernels.ops.ssd_op` wraps the whole chunked SSD with
the reference's backward.

:func:`ssd_intra_chunk` is the wrapper callers use.  A CPU tensor takes the
plain version (:func:`repro_torch.kernels.ref.ssd_intra_chunk_ref`); a CUDA
tensor launches the kernel, and a failure to build or launch raises.
``ssd_intra_chunk.launches`` counts the kernel's launches.
:func:`ssd_chunked_kernel` adds the inter-chunk recurrence and ``Y_off`` in
plain PyTorch, as the reference's ``ssd_chunked_kernel`` does in jnp.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import ssd_intra_chunk_ref
from repro_torch.models.ssm import inter_chunk

__all__ = ["ssd_intra_chunk", "ssd_chunked_kernel", "check_operands",
           "CHUNKS", "HEAD_DIMS", "MAX_STATE", "build"]

#: chunk lengths, head dims and the largest state the kernel is built for
#: (the largest, Q = 128, N = 128, P = 64, takes 165,888 bytes of the
#: 232,448 of shared memory a block may opt into on Hopper)
CHUNKS = (32, 64, 128)
HEAD_DIMS = (16, 32, 64)
MAX_STATE = 128

#: the kernel's grid puts chunks on y and batch on z (at most 65,535 each)
_GRID_YZ = 65_535

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    from repro_torch.kernels.build import load_library

    lib = load_library("ssd_scan")
    fn = lib.ssd_intra_chunk_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_int64] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def check_operands(xd: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, chunk: int) -> None:
    """Raise ``ValueError`` on shapes the CUDA kernel does not take (after
    :func:`ssd_intra_chunk` has made xd and dA contiguous float32, C of
    B's dtype and both of unit stride over n)."""
    if xd.ndim != 4 or dA.ndim != 3 or B.ndim != 3 or C.ndim != 3:
        raise ValueError("xd must be (b, s, h, p), dA (b, s, h), B and C "
                         "(b, s, n)")
    b, s, h, p = xd.shape
    n = B.shape[-1]
    if tuple(dA.shape) != (b, s, h):
        raise ValueError(f"dA {tuple(dA.shape)} must be ({b}, {s}, {h})")
    if tuple(B.shape) != (b, s, n) or tuple(C.shape) != (b, s, n):
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} must "
                         f"be ({b}, {s}, n)")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk {chunk} is not one the kernel is built for "
                         f"{CHUNKS}")
    if s % chunk:
        raise ValueError(f"s={s} not divisible by chunk={chunk}")
    if p not in HEAD_DIMS:
        raise ValueError(f"head dim {p} is not one the kernel is built for "
                         f"{HEAD_DIMS}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state {n} outside the kernel's 1..{MAX_STATE}")
    if s // chunk > _GRID_YZ or b > _GRID_YZ:
        raise ValueError(f"{s // chunk} chunks or batch {b} exceed the "
                         f"grid's {_GRID_YZ}")
    if B.dtype not in _DTYPE_CODES:
        raise ValueError(f"B and C must be float32 or bfloat16, got "
                         f"{B.dtype}")
    for name, t in (("dA", dA), ("B", B), ("C", C)):
        if t.device != xd.device:
            raise ValueError(f"{name} is on {t.device}, xd on {xd.device}")


@torch.library.custom_op("repro_torch::ssd_intra_chunk", mutates_args=(),
                         device_types="cuda")
def _ssd_intra_chunk_cuda(xd: torch.Tensor, dA: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor, chunk: int
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    b, s, h, p = xd.shape
    n = B.shape[-1]
    y = torch.empty_like(xd)
    states = torch.empty((b, s // chunk, h, p, n), dtype=torch.float32,
                         device=xd.device)
    dacs = torch.empty_like(dA)
    if y.numel() == 0 or states.numel() == 0:
        return y, states, dacs
    lib = build()
    with torch.cuda.device(xd.device):
        stream = torch.cuda.current_stream(xd.device).cuda_stream
        err = lib.ssd_intra_chunk_launch(
            xd.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), states.data_ptr(), dacs.data_ptr(),
            _DTYPE_CODES[B.dtype], b, s, h, p, n, chunk, B.stride(0),
            B.stride(1), C.stride(0), C.stride(1), stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed: CUDA "
                           f"error {err} (xd {tuple(xd.shape)}, n={n}, "
                           f"chunk={chunk}, {B.dtype})")
    ssd_intra_chunk.launches += 1
    return y, states, dacs


def ssd_intra_chunk(xd: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, *, chunk: int):
    """Intra-chunk SSD.

    Args:
      xd: (b, s, h, p) dt-scaled inputs; dA: (b, s, h) = dt * A (both cast
        to float32 here).
      B, C: (b, s, n), float32 or bfloat16; on CUDA any strides over b and
        s (the slices of ``xBC`` are read in place), unit stride over n.
      chunk: Q, with s % Q == 0.
    Returns:
      (Y_diag (b, s, h, p), states (b, nc, h, p, n), dA_cumsum (b, s, h)),
      all float32.
    """
    xd = xd.float().contiguous()
    dA = dA.float().contiguous()
    if xd.device.type == "cpu":
        return ssd_intra_chunk_ref(xd, dA, B, C, chunk=chunk)
    if C.dtype != B.dtype:
        C = C.to(B.dtype)
    if B.stride(-1) != 1:
        B = B.contiguous()
    if C.stride(-1) != 1:
        C = C.contiguous()
    check_operands(xd, dA, B, C, chunk)
    return torch.ops.repro_torch.ssd_intra_chunk(xd, dA, B, C, chunk)


#: kernel launches since the count was last reset (set it to 0 to reset)
ssd_intra_chunk.launches = 0


def ssd_chunked_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                       initial_state: torch.Tensor | None = None):
    """Full SSD: the intra-chunk kernel, then the inter-chunk recurrence and
    the state-to-output term in plain PyTorch.

    Same contract as :func:`repro_torch.models.ssm.ssd_chunked` (s a
    multiple of ``chunk``): returns (y (b, s, h, p) in x's dtype,
    final_state (b, h, p, n) float32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    xd = x.to(f32) * dt.to(f32)[..., None]
    dA = dt.to(f32) * A.to(f32)[None, None, :]

    y_diag, states, dA_cs = ssd_intra_chunk(xd, dA, B, C, chunk=chunk)
    nc = s // chunk
    y_off, final = inter_chunk(states, C.to(f32).reshape(b, nc, chunk, n),
                               dA_cs.reshape(b, nc, chunk, h), initial_state)
    y = y_diag.reshape(b, nc, chunk, h, p) + y_off
    return y.reshape(b, s, h, p).to(x.dtype), final
