"""Synthetic data: the paper's non-IID linear regression (§VII) and token
streams for the language-model drivers.

Counterpart of ``repro.data.synthetic``.  Paper setting (eq. 80-81): K
agents, each with N inputs u_{k,n} ~ N(m_k, R_u) with varying means m_k and
noise variances sigma_{k,v}^2 (non-IID), outputs d_k(n) = u_{k,n}^T w* +
v_k(n).  The dataset is made with numpy from a seed, as the reference
makes it, so its arrays are bit-equal to the reference's, and so is its
Dirichlet/shard/iid re-partition (:func:`partition_regression_data`,
through :mod:`repro_torch.data.pipeline`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.msd import QuadraticProblem
from repro_torch.device import resolve_device

__all__ = ["RegressionData", "make_regression_problem", "make_block_sampler",
           "make_indexed_block_sampler", "lm_token_batch",
           "partition_regression_data"]


@dataclasses.dataclass
class RegressionData:
    """Stacked per-agent regression dataset."""

    U: np.ndarray        # (K, N, M)
    d: np.ndarray        # (K, N)
    w_star: np.ndarray   # (M,) generative model
    rho: float
    noise_std: np.ndarray  # (K,)

    @property
    def num_agents(self) -> int:
        return int(self.U.shape[0])

    def problem(self) -> QuadraticProblem:
        return QuadraticProblem(U=list(self.U), d=list(self.d), rho=self.rho)

    def loss_fn(self):
        """Per-agent loss matching eq. (81): mean squared error +
        rho ||w||^2, on ``batch = (u, d)`` with u (B, M), d (B,)."""
        rho = self.rho

        def loss(w, batch):
            u, d = batch
            resid = d - u @ w
            return torch.mean(resid ** 2) + rho * torch.sum(w ** 2)

        return loss

    def grad_fn(self):
        """Per-agent gradients of :meth:`loss_fn` over the stack in closed
        form, for the engine's ``grad_fn=``: ``grad(w, (u, d))`` with w
        (K, M), u (K, B, M), d (K, B) returns the (K, M) stack of
        ``-(2/B) u_k^T (d_k - u_k w_k) + 2 rho w_k``.  A few batched
        operations a local step, where autograd over K per-agent losses
        would launch hundreds."""
        rho = self.rho

        def grad(w, batch):
            u, d = batch
            resid = d - torch.einsum("kbm,km->kb", u, w)
            return ((-2.0 / u.shape[1]) * torch.einsum("kbm,kb->km", u, resid)
                    + (2.0 * rho) * w)

        return grad


def make_regression_problem(K: int = 20, N: int = 100, M: int = 2,
                            rho: float = 0.1, seed: int = 0,
                            mean_scale: float = 1.0,
                            noise_low: float = 0.05,
                            noise_high: float = 0.5,
                            w_star_spread: float = 0.0) -> RegressionData:
    """Generate the paper's §VII dataset (non-IID means and noise levels).

    ``w_star_spread > 0`` gives each agent its own generative model
    ``w*_k = w* + spread * delta_k`` (stronger objective heterogeneity).
    """
    rng = np.random.default_rng(seed)
    w_star = rng.normal(size=(M,))
    # shared input covariance, per-agent means (non-IID)
    L = rng.normal(size=(M, M)) * 0.3
    R_u = L @ L.T + np.eye(M)
    chol = np.linalg.cholesky(R_u)
    means = rng.normal(size=(K, M)) * mean_scale
    noise_std = rng.uniform(noise_low, noise_high, size=(K,))
    U = rng.normal(size=(K, N, M)) @ chol.T + means[:, None, :]
    v = rng.normal(size=(K, N)) * noise_std[:, None]
    w_k = w_star[None, :] + w_star_spread * rng.normal(size=(K, M))
    d = np.einsum("knm,km->kn", U, w_k) + v
    return RegressionData(U=U, d=d, w_star=w_star, rho=rho,
                          noise_std=noise_std)


def partition_regression_data(data: RegressionData, K: int, *,
                              kind: str = "dirichlet", alpha: float = 1.0,
                              shards_per_agent: int = 1, seed: int = 0,
                              samples_per_agent: int = 0) -> RegressionData:
    """Re-partition the §VII pool across ``K`` agents with controlled skew.

    The generator's per-origin-agent input means make the original K0
    agents K0 latent classes: the pooled (K0 N) rows, labelled by origin,
    are re-dealt by the federated partition protocols.  ``kind=
    "dirichlet"`` deals each class by a Dirichlet(alpha) draw;
    ``"shards"`` gives each agent ``shards_per_agent`` contiguous shards of
    the class-sorted pool; ``"iid"`` shuffles the pool uniformly.  Every
    agent is resampled (with replacement, seeded) to the same local size
    (``samples_per_agent``, else the pool over K), and ``noise_std`` is
    recomputed from the residuals against ``w_star``.
    """
    from repro_torch.data.pipeline import (contiguous_partition,
                                           dirichlet_partition)

    pool_U = data.U.reshape(-1, data.U.shape[-1])          # (K0*N, M)
    pool_d = data.d.reshape(-1)                            # (K0*N,)
    labels = np.repeat(np.arange(data.num_agents), data.U.shape[1])
    n_pool = len(pool_d)
    n_local = samples_per_agent if samples_per_agent > 0 else max(
        1, n_pool // K)

    rng = np.random.default_rng(seed)
    if kind == "dirichlet":
        parts = dirichlet_partition(labels, K, alpha, seed=seed)
    elif kind == "shards":
        S = max(1, shards_per_agent)
        order = np.argsort(labels, kind="stable")          # class-sorted pool
        shards = contiguous_partition(n_pool, K * S)
        deal = rng.permutation(K * S)
        parts = [np.concatenate([order[shards[j]]
                                 for j in deal[k * S:(k + 1) * S]])
                 for k in range(K)]
    elif kind == "iid":
        perm = rng.permutation(n_pool)
        parts = [perm[k::K] for k in range(K)]
    else:
        raise ValueError(f"unknown data kind {kind!r} — valid kinds for the "
                         "regression path: ['dirichlet', 'iid', 'shards']")

    U = np.empty((K, n_local, data.U.shape[-1]), data.U.dtype)
    d = np.empty((K, n_local), data.d.dtype)
    for k, part in enumerate(parts):
        if len(part) == 0:
            raise ValueError(f"agent {k} received an empty partition")
        agent_rng = np.random.default_rng(
            np.random.SeedSequence([seed, 0x9A97, k]))
        take = part[agent_rng.integers(0, len(part), size=n_local)]
        U[k], d[k] = pool_U[take], pool_d[take]
    resid = d - np.einsum("knm,m->kn", U, data.w_star)
    return RegressionData(U=U, d=d, w_star=data.w_star, rho=data.rho,
                          noise_std=resid.std(axis=1))


def make_block_sampler(data: RegressionData, T: int, batch: int = 1,
                       device=None):
    """Return ``sampler(key) -> ((T, K, B, M), (T, K, B))`` float32 on
    ``device`` (``None`` means CUDA): samples drawn uniformly with
    replacement, the indices from the generator ``key`` on its device."""
    dev = resolve_device(device)
    U = torch.as_tensor(data.U, dtype=torch.float32, device=dev)
    d = torch.as_tensor(data.d, dtype=torch.float32, device=dev)
    K, N, _ = U.shape
    ar = torch.arange(K, device=dev)[None, :, None]

    def sampler(key: torch.Generator):
        idx = torch.randint(0, N, (T, K, batch), generator=key,
                            device=key.device).to(dev)
        return U[ar, idx], d[ar, idx]

    return sampler


def make_indexed_block_sampler(data: RegressionData, T: int, batch: int = 1,
                               seed: int = 0, device=None):
    """Return ``sampler(index) -> ((T, K, B, M), (T, K, B))``, the
    index-replayable sibling of :func:`make_block_sampler`: the indices
    are a pure function of ``(seed, block_index, agent)`` (one numpy
    ``SeedSequence`` each), as the reference draws them, so the batches
    are bit-equal to the reference's."""
    dev = resolve_device(device)
    U = np.asarray(data.U)
    d = np.asarray(data.d)
    K, N, _ = U.shape
    ar = np.arange(K)[None, :, None]

    def sampler(index: int):
        idx = np.empty((T, K, batch), np.int64)
        for k in range(K):
            rng = np.random.default_rng(
                np.random.SeedSequence([seed, int(index), k]))
            idx[:, k, :] = rng.integers(0, N, size=(T, batch))
        return (torch.as_tensor(U[ar, idx], dtype=torch.float32,
                                device=dev),
                torch.as_tensor(d[ar, idx], dtype=torch.float32,
                                device=dev))

    return sampler


def lm_token_batch(key: torch.Generator, shape: tuple[int, ...], vocab: int,
                   dtype=torch.int32) -> dict:
    """Synthetic next-token-prediction batch: uniform tokens on the
    generator's device and labels shifted by one (last label 0)."""
    tokens = torch.randint(0, vocab, shape, generator=key, device=key.device,
                           dtype=dtype)
    labels = torch.cat([tokens[..., 1:], torch.zeros_like(tokens[..., :1])],
                       dim=-1)
    return {"tokens": tokens, "labels": labels}
