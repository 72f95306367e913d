"""Plain PyTorch reference of one Algorithm-1 block, shared by the model
families.

Diffusion learning with partial participation and local updates (the
paper's eq. 17-20): every agent k takes T stochastic-gradient steps
``w_k <- w_k - mu a_k grad_k`` (``a_k`` its 0/1 activation in the block),
then the agents combine through the realized matrix A_t of eq. 20: an
active agent keeps the base weight ``a_lk`` of each active neighbour and
puts the rest on itself, an inactive agent keeps its own parameters.

Everything is computed in float32 with TF32 off.  Each parameter is stored
in the dtype the configuration gives it (the inputs arrive in it), so an
update or a combination is rounded to that dtype as the configuration
states.  :class:`Precision` ``"fp8"`` is the control: the same arithmetic
with every linear layer's operands and every stored bf16 parameter
rounded to float8 e4m3 with a per-tensor scale, one step below bf16.

This module imports nothing of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Precision", "ring_matrix", "realized_matrix", "run_blocks",
           "set_exact_float32", "FP8_MAX"]

#: the largest finite float8 e4m3 value
FP8_MAX = 448.0


def set_exact_float32() -> None:
    """float32 products without TF32, on the card and in cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice over
    ``dims`` (amax over them maps to 448), returned in float32."""
    amax = x.detach().abs().amax(dim=dims, keepdim=True).float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x.float() / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """``"stated"``: float32 arithmetic, parameters stored in their stated
    dtype.  ``"fp8"``: the control (see the module docstring)."""

    def __init__(self, name: str = "stated"):
        if name not in ("stated", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.fp8 = name == "fp8"

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` in float32; under fp8 both operands are rounded first
        (straight through: the backward sees the rounded values)."""
        x, w = x.float(), w.float()
        if self.fp8:
            x = x + (_fp8(x, tuple(range(x.ndim))) - x).detach()
            w = w + (_fp8(w, tuple(range(w.ndim))) - w).detach()
        return x @ w

    def store(self, x: torch.Tensor, dtype: torch.dtype,
              layered: bool) -> torch.Tensor:
        """A parameter leaf as it is kept: in ``dtype``, or under fp8, for
        a bf16 leaf, rounded to float8 (one scale per layer of a stacked
        ``layered`` leaf) and kept in float32."""
        if self.fp8 and dtype == torch.bfloat16:
            dims = tuple(range(1, x.ndim)) if layered and x.ndim > 1 \
                else tuple(range(x.ndim))
            return _fp8(x, dims)
        return x.to(dtype)


def ring_matrix(K: int) -> np.ndarray:
    """The ring's Metropolis-Hastings matrix: each agent's two neighbours
    (one when K = 2) get ``1 / (1 + max(deg_l, deg_k))``, the agent
    itself the rest of its column."""
    A = np.zeros((K, K))
    if K == 1:
        return np.ones((1, 1))
    nbrs = [{(k - 1) % K, (k + 1) % K} for k in range(K)]
    for k in range(K):
        for l in nbrs[k]:
            A[l, k] = 1.0 / (1 + max(len(nbrs[l]), len(nbrs[k])))
        A[k, k] = 1.0 - sum(A[l, k] for l in nbrs[k])
    return A


def realized_matrix(A: np.ndarray, active: np.ndarray) -> np.ndarray:
    """Eq. 20: column k of an active agent keeps ``a_lk`` for each active
    l != k and its diagonal completes the column; an inactive agent's
    column is the unit vector e_k."""
    K = A.shape[0]
    out = np.zeros((K, K))
    for k in range(K):
        if not active[k]:
            out[k, k] = 1.0
            continue
        for l in range(K):
            if l != k and active[l]:
                out[l, k] = A[l, k]
        out[k, k] = 1.0 - out[:, k].sum()
    return out


def run_blocks(family, cfg: dict, weights: dict, agents: int,
               blocks: list, masks, *, topology: str, step_size: float,
               local_steps: int, precision: Precision, device,
               fault: str | None = None):
    """Follow ``len(blocks)`` blocks of Algorithm 1 from ``weights``, the
    start of each of the ``agents`` agents.

    ``weights``: {path: tensor} of one agent in each leaf's stated dtype
    (this function keeps its own copies); ``blocks[b]``: {name: (T, K,
    ...) tensor}; ``masks[b]``: the (K,) activation.  ``family`` computes one
    agent's loss and gradients (``family.loss_and_grad``).  ``fault``
    plants a fault in place of the arithmetic (``"half_batch"``: each
    loss the mean over the first half of the positions; ``"no_exchange"``:
    the combination left out).

    Returns {"loss": (blocks, T, K) float64 array, "grad0": {path: (K,)
    norms of local step 0's gradient in block 0}, "weights": the final
    {path: (K, ...)} leaves}.
    """
    if topology != "ring":
        raise ValueError(f"the reference has the ring only, not "
                         f"{topology!r}")
    K = agents
    dtypes = {p: x.dtype for p, x in weights.items()}
    W = {}
    for p, x in weights.items():
        one = precision.store(x.to(device).float(), x.dtype,
                              layered=family.layered(p))
        W[p] = one.unsqueeze(0).expand((K,) + tuple(one.shape)).clone()
        del one
    A = ring_matrix(K)
    losses = np.zeros((len(blocks), local_steps, K))
    grad0 = {p: torch.zeros(K, dtype=torch.float64) for p in W}
    for b, (batch, active) in enumerate(zip(blocks, masks)):
        active = np.asarray(active, dtype=np.float64)
        for t in range(local_steps):
            for k in range(K):
                agent = {p: x[k] for p, x in W.items()}
                one = {n: v[t, k].to(device) for n, v in batch.items()}
                loss, grads = family.loss_and_grad(agent, one, cfg,
                                                   precision, fault=fault)
                losses[b, t, k] = loss
                if b == 0 and t == 0:
                    for p, g in grads.items():
                        grad0[p][k] = torch.linalg.vector_norm(
                            g.double()).item()
                mu = step_size * active[k]
                for p, g in grads.items():
                    new = agent[p].float() - mu * g
                    W[p][k] = precision.store(new, dtypes[p],
                                              family.layered(p))
                del grads, agent
        if fault == "no_exchange":
            continue
        At = torch.as_tensor(realized_matrix(A, active), dtype=torch.float32,
                             device=device)
        for p, x in W.items():
            # one layer of a stacked leaf at a time bounds the float32
            # transient
            slices = range(x.shape[1]) if family.layered(p) else [None]
            for j in slices:
                xs = x if j is None else x[:, j]
                mixed = torch.einsum("lk,l...->k...", At, xs.float())
                # each agent's row as the update stores it (under fp8 one
                # scale per agent and layer)
                for k in range(K):
                    xs[k] = precision.store(mixed[k], dtypes[p],
                                            layered=False)
                del mixed
    return {"loss": losses, "grad0": {p: g.numpy() for p, g in grad0.items()},
            "weights": W}
