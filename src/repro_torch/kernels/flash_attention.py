"""Flash attention (GQA, causal, sliding window), hand-written in CUDA for
Hopper: the forward, and the backward of its bf16 route.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` (the
Pallas TPU kernel ``_flash_kernel``).  The CUDA source is
``csrc/flash_attention.cu``, with two forward routes chosen by dtype:
float32 through float32 FMAs (the reference's 2e-5 gate rules out TF32),
bfloat16 through Hopper's tensor cores (``wgmma`` on bf16 operands with
float32 accumulation, TMA loads, P rounded to bf16 before P V: its plain
model is :func:`repro_torch.kernels.ref.attention_bf16p_ref`).  It is
built with ``nvcc`` for ``sm_90a`` at first use
(:mod:`repro_torch.kernels.build`), bound through ctypes, and registered
with the PyTorch dispatcher as ``torch.ops.repro_torch.flash_attention(q,
k, v, causal, window)`` for CUDA tensors, and as
``torch.ops.repro_torch.flash_attention_lse``, which also returns each
row's log-sum-exp for the backward.

:func:`flash_attention_backward` is the bf16 route's backward kernel (the
reference has none: its custom VJP differentiates the plain streaming
attention): dq, dk and dv from q, k, v, the output, its gradient and the
stored log-sum-exp, P and dZ rounded to bf16 before their products (plain
model: :func:`repro_torch.kernels.ref.attention_bf16_backward_ref`).
:func:`repro_torch.kernels.ops.attention_op` wires the two into autograd.

:func:`flash_attention` is the forward callers use.  A CPU tensor takes the
plain version (:func:`repro_torch.kernels.ref.attention_ref`); a CUDA tensor
launches the kernel, and a failure to build or launch raises.
``flash_attention.launches`` and ``flash_attention_backward.launches``
count the kernels' launches.

Unlike the TPU kernel, the CUDA kernels take any sequence lengths: they
bound their tiles by Sq and Skv, so there is no padding contract.  They
take the head dims :data:`HEAD_DIMS`; the bf16 route runs a head dim of 112
(kimi-k2's) through its D = 128 layout, TMA filling the missing columns
with zeros.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.ref import (attention_bf16_backward_ref,
                                     attention_lse_ref, attention_ref)

__all__ = ["flash_attention", "flash_attention_lse",
           "flash_attention_backward", "check_operands", "HEAD_DIMS",
           "build"]

#: head dims the kernel takes
HEAD_DIMS = (32, 64, 112, 128)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    from repro_torch.kernels.build import load_library

    lib = load_library("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.flash_attention_backward_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
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


def _aligned(*ts: torch.Tensor):
    """The tensor-core route reads through TMA, which takes 16-byte aligned
    buffers: a view that starts elsewhere is copied."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


def _forward_cuda(q, k, v, causal: bool, window: int, with_lse: bool):
    check_operands(q, k, v, window if window > 0 else None)
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    scale = float(1.0 / np.sqrt(D))
    out = torch.empty_like(q)
    lse = None
    if with_lse:
        if q.dtype != torch.bfloat16:
            raise ValueError(f"the log-sum-exp is stored by the bf16 route "
                             f"only, not for {q.dtype}")
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        if Skv == 0:            # no keys: out is 0, every row's sum empty
            return out.zero_(), lse.fill_(float("-inf"))
    if q.numel() == 0:
        return out, lse
    if q.dtype == torch.bfloat16:
        q, k, v = _aligned(q, k, v)
    lib = build()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPE_CODES[q.dtype], B, Sq, Skv, H, Kv, D, int(causal),
            window, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    flash_attention.launches += 1
    return out, lse


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, window: int) -> torch.Tensor:
    return _forward_cuda(q, k, v, causal, window, with_lse=False)[0]


@torch.library.custom_op("repro_torch::flash_attention_lse",
                         mutates_args=(), device_types="cuda")
def _flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool,
                              window: int) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    return _forward_cuda(q, k, v, causal, window, with_lse=True)


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


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` that also returns each row's log-sum-exp of
    its scaled scores, (B, H, Sq) float32, for
    :func:`flash_attention_backward`.  On CUDA the bf16 route only (one
    launch, counted in ``flash_attention.launches``); a CPU tensor takes
    the plain versions."""
    if q.device.type == "cpu":
        return (attention_ref(q, k, v, causal=causal, window=window),
                attention_lse_ref(q, k, causal=causal, window=window))
    return torch.ops.repro_torch.flash_attention_lse(
        q.contiguous(), k.contiguous(), v.contiguous(), causal,
        0 if window is None else int(window))


def check_backward_operands(q, k, v, out, dout, lse,
                            window: int | None = None) -> None:
    """Raise ``ValueError`` on operands the backward kernel does not take:
    :func:`check_operands`' rules, bfloat16 only, out and dout shaped and
    typed like q, lse float32 (B, H, Sq), all contiguous on q's device."""
    check_operands(q, k, v, window)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the backward kernel takes bfloat16, got "
                         f"{q.dtype}")
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must be "
                             f"shaped and typed like q {tuple(q.shape)}")
    B, Sq, H, _ = q.shape
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} must be "
                         f"float32 ({B}, {H}, {Sq})")
    for name, t in (("out", out), ("dout", dout), ("lse", lse)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Gradients of bf16 attention: (dq, dk, dv) shaped like q, k and v.

    Args:
      q: (B, Sq, H, D); k, v: (B, Skv, Kv, D); out and dout (B, Sq, H, D):
        the forward's output and its gradient; lse (B, H, Sq) float32 from
        :func:`flash_attention_lse`.  bfloat16, D in :data:`HEAD_DIMS`.
      causal, window: as the forward took them.
    A CUDA tensor launches the kernel (three launches: the row sums, the
    main kernel, dq's conversion; counted once in
    ``flash_attention_backward.launches``) or raises; a CPU tensor takes
    the plain model :func:`repro_torch.kernels.ref.attention_bf16_backward_ref`.
    dq sums the key tiles' parts in int32 fixed point, whose sum does not
    depend on the order the parts arrive in: the same operands give the
    same bits on every run.
    """
    if q.device.type == "cpu":
        return attention_bf16_backward_ref(q, k, v, out, dout, lse,
                                           causal=causal, window=window)
    q, k, v, out, dout, lse = (t.contiguous()
                               for t in (q, k, v, out, dout, lse))
    check_backward_operands(q, k, v, out, dout, lse, window)
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if Skv == 0 or q.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    q, k, v, dout = _aligned(q, k, v, dout)
    sq_pad = -(-Sq // 64) * 64          # the kernel's query tiles of 64
    acc_d = 128 if D == 112 else D       # head dim 112 runs the 128 layout
    dqacc = torch.empty(B * H * sq_pad * acc_d, dtype=torch.int32,
                        device=q.device)
    # each row's delta, lse in log2 and |dO|_1, then max |K| and max |V|
    stats = torch.empty(3 * B * H * sq_pad + 2, dtype=torch.float32,
                        device=q.device)
    lib = build()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_backward_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dqacc.data_ptr(), stats.data_ptr(), B, Sq, Skv,
            H, Kv, D, int(causal),
            0 if window is None else int(window), float(1.0 / np.sqrt(D)),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_backward kernel launch failed: "
                           f"CUDA error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    flash_attention_backward.launches += 1
    return dq, dk, dv


#: backward kernel launches since the count was last reset (set it to 0 to
#: reset)
flash_attention_backward.launches = 0
