"""Plain PyTorch versions of the port's kernels (ground truth for allclose).

Counterpart of ``repro.kernels.ref``.  The CPU path and the tests call
these; nothing on the CUDA path does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.participation import masked_combination

__all__ = ["attention_ref", "mix_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: int | None = None) -> torch.Tensor:
    """Naive GQA attention with the full score matrix, in float32.

    q: (B, Sq, H, D); k, v: (B, Skv, Kv, D).  Positions start at 0 for both
    q and k; masked scores are -inf.  Returns q's dtype.
    """
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = 1.0 / np.sqrt(D)
    qg = q.reshape(B, Sq, Kv, G, D).float()
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def mix_ref(A: torch.Tensor, active: torch.Tensor,
            W: torch.Tensor) -> torch.Tensor:
    """Masked diffusion combination: W'_k = sum_l a_lk(mask) W_l.

    A: (K, K) base matrix; active: (K,) in {0,1}; W: (K, M).
    Applies the eq. (20) masking then mixes in float32; returns W's dtype.
    """
    A_eff = masked_combination(A.to(device=W.device, dtype=torch.float32),
                               active)
    return torch.einsum("lk,lm->km", A_eff, W.float()).to(W.dtype)
