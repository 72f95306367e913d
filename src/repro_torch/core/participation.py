"""Partial agent participation (paper §III-B).

Counterpart of ``repro.core.participation``: the Bernoulli activation model
(eq. 18), the per-sample-path masked combination matrix (eq. 20), the
random step sizes (eq. 18, or eq. 31 with drift correction), and the
Lemma-1 closed forms for ``E[A_i]`` and ``E[A_i M_i]`` (numpy).  Random
draws come from an explicit ``torch.Generator``; its stream is torch's, not
JAX's.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["sample_active", "injected_uniforms", "masked_combination",
           "masked_combination_np", "expected_combination",
           "expected_step_sizes", "expected_A_M", "step_size_matrix"]


def sample_active(key: torch.Generator, q: torch.Tensor) -> torch.Tensor:
    """Bernoulli activation mask (K,) float32 in {0, 1} (paper eq. 18).

    ``q`` is the (K,) vector of participation probabilities q_k; the draw
    is made on the generator's device and returned there.
    """
    q = q.to(device=key.device, dtype=torch.float32)
    return torch.bernoulli(q, generator=key)


def injected_uniforms(u, shape: tuple) -> torch.Tensor:
    """Uniforms handed in for replay, in place of a generator's draw (the
    reference's ``jax.random.uniform``), as a float32 tensor of ``shape``;
    a numpy array is copied."""
    if not isinstance(u, torch.Tensor):
        u = torch.from_numpy(np.array(u, dtype=np.float32))
    u = u.to(torch.float32)
    if tuple(u.shape) != tuple(shape):
        raise ValueError(f"injected uniforms of shape {tuple(u.shape)}, "
                         f"expected {tuple(shape)}")
    return u


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


def expected_combination(A: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Lemma 1 eq. (22): E[A_i] at a combination slot (t = T).

    bar_a_lk = q_l q_k a_lk for l != k; the diagonal completes columns to 1.
    """
    A = np.asarray(A, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    K = A.shape[0]
    off = A * (1.0 - np.eye(K)) * np.outer(q, q)
    bar = off.copy()
    np.fill_diagonal(bar, 1.0 - off.sum(axis=0))
    return bar


def expected_step_sizes(mu: float, q: np.ndarray) -> np.ndarray:
    """Lemma 1 eq. (23): bar_M = diag(mu * q_k)."""
    return np.diag(mu * np.asarray(q, dtype=np.float64))


def expected_A_M(A: np.ndarray, q: np.ndarray, mu: float) -> np.ndarray:
    """Lemma 1 eq. (24): E[A_i M_i] = mu (bar_A - I) + bar_M."""
    bar_A = expected_combination(A, q)
    bar_M = expected_step_sizes(mu, q)
    K = A.shape[0]
    return mu * (bar_A - np.eye(K)) + bar_M


def step_size_matrix(mu: float, active: torch.Tensor,
                     q: torch.Tensor | None = None,
                     drift_correction: bool = False) -> torch.Tensor:
    """Random per-agent step sizes (K,) float32: eq. (18), or eq. (31)
    (mu / q_k for active agents) when ``drift_correction``."""
    m = active.float()
    if drift_correction:
        if q is None:
            raise ValueError("drift correction requires q")
        return mu * m / torch.as_tensor(q, dtype=torch.float32,
                                        device=m.device)
    return mu * m
