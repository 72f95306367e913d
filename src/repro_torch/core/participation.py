"""Partial agent participation (paper §III-B): the eq.-20 realized matrix.

Counterpart of ``repro.core.participation``.  This slice ports the masked
combination matrix; the samplers and the Lemma-1 closed forms come with the
training slice (ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["masked_combination", "masked_combination_np"]


def masked_combination(A: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Realized combination matrix A_i per eq. (20), vectorized.

    For active k: off-diagonal a_lk kept for active neighbors l, self weight
    re-normalized; for inactive k: a_kk = 1, everything else 0.  The result
    is doubly stochastic for every mask because A is symmetric.

    Args:
      A: (K, K) base combination matrix (symmetric doubly stochastic).
      active: (K,) mask in {0, 1}.
    Returns:
      (K, K) realized matrix, same dtype and device as A.
    """
    K = A.shape[0]
    m = active.to(device=A.device, dtype=A.dtype)
    eye = torch.eye(K, dtype=A.dtype, device=A.device)
    off = A * (1.0 - eye)
    # off-diagonal entries survive iff both endpoints active
    off_masked = off * (m[:, None] * m[None, :])
    col_off = off_masked.sum(dim=0)
    diag_active = m * (1.0 - col_off)     # active k: re-normalized self weight
    diag_inactive = (1.0 - m) * 1.0       # inactive k: frozen (self-loop 1)
    return off_masked + torch.diag(diag_active + diag_inactive)


def masked_combination_np(A: np.ndarray, active: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`masked_combination`."""
    A = np.asarray(A, dtype=np.float64)
    K = A.shape[0]
    m = np.asarray(active, dtype=np.float64)
    off = A * (1.0 - np.eye(K))
    off_masked = off * np.outer(m, m)
    col_off = off_masked.sum(axis=0)
    diag = m * (1.0 - col_off) + (1.0 - m)
    return off_masked + np.diag(diag)
