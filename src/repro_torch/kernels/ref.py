"""Plain PyTorch versions of the port's kernels (ground truth for allclose).

Counterpart of ``repro.kernels.ref``.  The CPU path and the tests call
these; nothing on the CUDA path does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.participation import masked_combination

__all__ = ["attention_ref", "gather_mix_ref", "gather_robust_mix_ref",
           "mix_int8_exact", "mix_int8_ref", "mix_ref", "ssd_ref",
           "ssd_intra_chunk_ref"]


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


def mix_int8_ref(A: torch.Tensor, active: torch.Tensor, Wq: torch.Tensor,
                 scales: torch.Tensor, *, tile_m: int,
                 subtract_identity: bool = False) -> torch.Tensor:
    """Dequantize, then the masked combination, in float32.

    Wq: (K, M) int8; scales: (K, M // tile_m), one per (agent, tile of
    tile_m columns).  C = Wq * scale of each column's tile; returns
    ``masked_combination(A, active).T @ C``, or ``(A_eff - I).T @ C`` with
    ``subtract_identity``.
    """
    K, M = Wq.shape
    C = (Wq.float().reshape(K, M // tile_m, tile_m)
         * scales.to(device=Wq.device, dtype=torch.float32)[:, :, None]
         ).reshape(K, M)
    A_eff = masked_combination(A.to(device=Wq.device, dtype=torch.float32),
                               active)
    if subtract_identity:
        A_eff = A_eff - torch.eye(K, device=Wq.device)
    return A_eff.T @ C


def mix_int8_exact(A: torch.Tensor, active: torch.Tensor, Wq: torch.Tensor,
                   scales: torch.Tensor, *, tile_m: int,
                   subtract_identity: bool = False):
    """:func:`mix_int8_ref`'s function in float64, and the error bound of
    any float32 evaluation of it.

    Returns ``(exact, bound)``, both (K, M) float64: ``exact`` is the
    float32 ``A_eff`` (as :func:`mix_int8_ref` builds it) times the
    exactly dequantized C; ``bound`` is ``(K + 2) u (|A_eff|^T |C| + 2
    |C|)`` with u = 2^-24.  Its first term covers K float32 products summed
    in any order and the float32 rounding of each dequantized value; its
    second, the self weight, which an evaluation may rebuild from its
    column's off-diagonal sum in another order than ``masked_combination``
    (each within (K + 2) u of the true weight).
    """
    K, M = Wq.shape
    C = (Wq.double().reshape(K, M // tile_m, tile_m)
         * scales.to(device=Wq.device, dtype=torch.float64)[:, :, None]
         ).reshape(K, M)
    A_eff = masked_combination(A.to(device=Wq.device, dtype=torch.float32),
                               active)
    if subtract_identity:
        A_eff = A_eff - torch.eye(K, device=Wq.device)
    A64 = A_eff.double()
    absC = C.abs()
    bound = (K + 2) * 2.0 ** -24 * (A64.abs().T @ absC + 2 * absC)
    return A64.T @ C, bound


def gather_mix_ref(idx: torch.Tensor, gw: torch.Tensor,
                   W: torch.Tensor) -> torch.Tensor:
    """Bounded-degree combination: out[k] = sum_j gw[k, j] W[idx[k, j]].

    idx: (K, D) neighbor table (slot 0 = self, padding = self); gw: (K, D)
    realized weights (padding exactly 0); W: (K, M).  Gathers, then one
    float32 einsum; returns float32.
    """
    idx = idx.to(device=W.device, dtype=torch.long)
    gw = gw.to(device=W.device, dtype=torch.float32)
    return torch.einsum("kd,kdm->km", gw, W.float()[idx])


def gather_robust_mix_ref(idx: torch.Tensor, member: torch.Tensor,
                          wslot: torch.Tensor, active: torch.Tensor,
                          W: torch.Tensor) -> torch.Tensor:
    """Neighborhood gather + order-statistic slot weights, in float32.

    idx: (K, D) neighbor table; member: (K, D) {0, 1} realized membership
    (self slot 1, padding 0); wslot: (K, D) weights over the ascending
    sorted member values, zero on every slot >= S_k; active: (K,) or
    (K, 1) mask; W: (K, M).  Non-members go to +inf, the D slots are
    sorted, and ``where(w > 0, srt, 0) * w`` is summed over the slots (the
    where keeps 0 * inf = nan out); an inactive row keeps W's own row
    exactly.  Returns float32.
    """
    dev = W.device
    idx = idx.to(device=dev, dtype=torch.long)
    member = member.to(device=dev, dtype=torch.float32)
    wslot = wslot.to(device=dev, dtype=torch.float32)
    active = active.to(device=dev, dtype=torch.float32).reshape(-1, 1)
    x = W.float()
    vals = torch.where(member[:, :, None] > 0, x[idx],
                       torch.tensor(float("inf"), device=dev))
    srt = torch.sort(vals, dim=1).values
    wb = wslot[:, :, None]
    agg = (torch.where(wb > 0, srt, torch.zeros((), device=dev)) * wb
           ).sum(dim=1)
    return torch.where(active > 0, agg, x)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, *,
            initial_state: torch.Tensor | None = None):
    """Sequential SSD recurrence (ground truth), a float32 loop over s.

    x: (b, s, h, p); dt: (b, s, h); A: (h,); B, C: (b, s, n).
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T ;  y_t = h_t C_t.
    Returns (y (b, s, h, p) in x's dtype, final_state (b, h, p, n) float32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    A = A.to(f32)
    ys = []
    for t in range(s):
        dtt = dt[:, t].to(f32)                                    # (b, h)
        decay = torch.exp(dtt * A)
        xd = x[:, t].to(f32) * dtt[..., None]                     # (b, h, p)
        state = (state * decay[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", xd, B[:, t].to(f32)))
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t].to(f32)))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_intra_chunk_ref(xd: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                        C: torch.Tensor, *, chunk: int):
    """The SSD intra-chunk step in float32, chunk by chunk.

    xd: (b, s, h, p) dt-scaled inputs; dA: (b, s, h) = dt * A; B, C:
    (b, s, n); s a multiple of ``chunk`` (Q).  For every chunk:
        dA_cs   = cumsum(dA_c)
        Y_diag  = ((C_c B_c^T) o L) xd_c,
                  L_ij = exp(dA_cs_i - dA_cs_j) for j <= i, else 0
        state_c = xd_c^T (B_c o exp(dA_cs_Q - dA_cs))
    Returns (Y_diag (b, s, h, p), states (b, nc, h, p, n),
    dA_cumsum (b, s, h)), all float32.
    """
    b, s, h, p = xd.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"s={s} not divisible by chunk={chunk}")
    nc, Q = s // chunk, chunk
    f32 = torch.float32
    xdc = xd.to(f32).reshape(b, nc, Q, h, p)
    Bc = B.to(f32).reshape(b, nc, Q, n)
    Cc = C.to(f32).reshape(b, nc, Q, n)
    cs = torch.cumsum(dA.to(f32).reshape(b, nc, Q, h), dim=2)    # (b,c,l,h)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]             # (b,c,i,j,h)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xd.device).tril()
    Lm = torch.exp(seg.masked_fill(~mask[:, :, None], float("-inf")))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None] * Lm
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xdc)
    decay = torch.exp(cs[:, :, -1:, :] - cs)                      # (b,c,l,h)
    states = torch.einsum("bcjhp,bcjn->bchpn", xdc * decay[..., None], Bc)
    return y.reshape(b, s, h, p), states, cs.reshape(b, s, h)
