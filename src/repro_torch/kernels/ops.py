"""Differentiable wrappers around the port's kernels.

Counterpart of ``repro.kernels.ops``.  :func:`attention_op` runs the
flash-attention kernel forward (the plain version for CPU tensors) and
differentiates the streaming twin
:func:`repro_torch.models.layers.flash_attention_jnp`, as the reference's
custom VJP does: kernel forward, framework backward.  The reference has no
backward kernel, so neither has the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import flash_attention_jnp

__all__ = ["attention_op"]

#: the reference's key block (``attention_op``'s ``block_kv``)
BLOCK_KV = 128


def _forward(q, k, v, causal: bool, window: int | None) -> torch.Tensor:
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
    return flash_attention(q, k, v, causal=causal, window=window)


class _Attention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
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
