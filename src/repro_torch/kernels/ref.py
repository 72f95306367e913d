"""Plain PyTorch versions of the port's kernels (ground truth for allclose).

Counterpart of ``repro.kernels.ref``.  The CPU path and the tests call
these; nothing on the CUDA path does.
"""
from __future__ import annotations

import torch

from repro_torch.core.participation import masked_combination

__all__ = ["mix_ref"]


def mix_ref(A: torch.Tensor, active: torch.Tensor,
            W: torch.Tensor) -> torch.Tensor:
    """Masked diffusion combination: W'_k = sum_l a_lk(mask) W_l.

    A: (K, K) base matrix; active: (K,) in {0,1}; W: (K, M).
    Applies the eq. (20) masking then mixes in float32; returns W's dtype.
    """
    A_eff = masked_combination(A.to(device=W.device, dtype=torch.float32),
                               active)
    return torch.einsum("lk,lm->km", A_eff, W.float()).to(W.dtype)
