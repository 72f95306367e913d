"""Differentiable wrappers around the port's kernels.

Counterpart of ``repro.kernels.ops``.  :func:`attention_op` runs the
flash-attention kernel forward (the plain version for CPU tensors).  Its
backward takes one of two routes, by the operands' device and dtype: bf16
on CUDA runs the backward kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention_backward`) on
the log-sum-exp the forward stored; a CPU tensor or float32 operands
differentiate the streaming twin
:func:`repro_torch.models.layers.flash_attention_jnp` in float32, as the
reference's custom VJP does.  The reference has no backward kernel: this
one was added because the plain backward took most of a training block.
:func:`ssd_op` runs the SSD intra-chunk kernel forward and differentiates
the plain :func:`repro_torch.models.ssm.ssd_chunked` (kernel forward,
framework backward, as the reference does).  :func:`mix_op` is the masked
combination step over a stacked tree through the ``diffusion_mix`` kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.core.mixing import tiled_apply
from repro_torch.kernels.diffusion_mix import diffusion_mix
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_backward,
                                                 flash_attention_lse)
from repro_torch.kernels.ssd_scan import ssd_chunked_kernel
from repro_torch.models.layers import flash_attention_jnp
from repro_torch.models.ssm import pad_to_chunk, ssd_chunked
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["attention_op", "mix_op", "ssd_op"]

#: the reference's key block (``attention_op``'s ``block_kv``)
BLOCK_KV = 128


def _pad(q, k, v, causal: bool):
    Sq, Skv = q.shape[1], k.shape[1]
    pad = (-Skv) % BLOCK_KV
    if pad and (not causal or Sq > Skv):
        # The reference pads K/V with zero keys up to whole blocks and masks
        # them only by position, so where the causal mask does not hide them
        # they enter the softmax with score 0 (ROADMAP.md queue 3).  Keep
        # that result here; on the model path (causal, Sq == Skv) no padded
        # key is ever visible and nothing is padded.
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v


def _forward(q, k, v, causal: bool, window: int | None) -> torch.Tensor:
    k, v = _pad(q, k, v, causal)
    return flash_attention(q, k, v, causal=causal, window=window)


class _Attention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.causal, ctx.window = causal, window
        # the route: bf16 on CUDA keeps what the backward kernel needs
        ctx.kernel = (q.is_cuda and q.dtype == torch.bfloat16
                      and any(ctx.needs_input_grad[:3]))
        if not ctx.kernel:
            ctx.save_for_backward(q, k, v)
            return _forward(q, k, v, causal, window)
        ctx.skv = k.shape[1]
        kp, vp = _pad(q, k, v, causal)
        out, lse = flash_attention_lse(q, kp, vp, causal=causal,
                                       window=window)
        ctx.save_for_backward(q, kp, vp, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.kernel:
            q, k, v, out, lse = ctx.saved_tensors
            with spans.span("model.attention.backward"):
                dq, dk, dv = flash_attention_backward(
                    q, k, v, out, g.contiguous(), lse, causal=ctx.causal,
                    window=ctx.window)
            # the zero keys _pad appended have no gradient to return
            return dq, dk[:, :ctx.skv], dv[:, :ctx.skv], None, None
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad(), spans.span("model.attention.backward"):
            out = flash_attention_jnp(q, k, v, causal=ctx.causal,
                                      window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True,
                 window: int | None = None) -> torch.Tensor:
    """Flash attention, differentiable.  q: (B, Sq, H, D); k, v:
    (B, Skv, Kv, D).  Returns (B, Sq, H, D) in q's dtype."""
    return _Attention.apply(q, k, v, causal, window)


class _SSD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        s = x.shape[1]
        xp, dtp, Bp, Cp = pad_to_chunk(x, dt, B, C, chunk)
        y, final = ssd_chunked_kernel(xp, dtp, A, Bp, Cp, chunk=chunk)
        return y[:, :s], final

    @staticmethod
    def backward(ctx, gy, gfinal):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        x, dt, A, B, C = inputs
        s = x.shape[1]
        with torch.enable_grad(), spans.span("model.ssm.backward"):
            xp, dtp, Bp, Cp = pad_to_chunk(x, dt, B, C, ctx.chunk)
            y, final = ssd_chunked(xp, dtp, A, Bp, Cp, chunk=ctx.chunk)
            grads = torch.autograd.grad((y[:, :s], final), inputs,
                                        (gy, gfinal), allow_unused=True)
        return (*grads, None)


def ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
           initial_state: torch.Tensor | None = None):
    """Chunked SSD through the intra-chunk kernel, with s zero-padded to a
    multiple of ``chunk``.

    x: (b, s, h, p); dt: (b, s, h); A: (h,); B, C: (b, s, n).  Returns
    (y (b, s, h, p) in x's dtype, final_state (b, h, p, n) float32).
    Differentiable in x, dt, A, B and C through the plain chunked twin
    (kernel forward, framework backward).  ``initial_state`` bypasses the
    autograd function, as in the reference (prefill continuation only; not
    used in training).
    """
    if initial_state is not None:
        s = x.shape[1]
        xp, dtp, Bp, Cp = pad_to_chunk(x, dt, B, C, chunk)
        y, final = ssd_chunked_kernel(xp, dtp, A, Bp, Cp, chunk=chunk,
                                      initial_state=initial_state)
        return y[:, :s], final
    return _SSD.apply(x, dt, A, B, C, chunk)


def mix_op(A: torch.Tensor, active: torch.Tensor, params):
    """Masked combination step (eq. 20) over an agent-stacked tree.

    The leaves are flattened to (K, M) float32 one column tile at a time
    (:func:`repro_torch.core.mixing.tiled_apply`), each tile goes through
    :func:`~repro_torch.kernels.diffusion_mix.diffusion_mix` (one kernel
    launch a tile on CUDA, the plain version on the CPU), and the result
    comes back in each leaf's shape and dtype.  Equal to the dense mixer
    on ``masked_combination(A, active)`` up to float32 summation order.
    """
    leaves = tree_leaves(params)
    device = leaves[0].device
    A = torch.as_tensor(A, dtype=torch.float32, device=device).contiguous()
    active = torch.as_tensor(active, dtype=torch.float32,
                             device=device).contiguous()
    return tree_unflatten(params, tiled_apply(
        leaves, lambda tile: diffusion_mix(A, active, tile)))
