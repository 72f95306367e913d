"""Plain PyTorch versions of the port's kernels (ground truth for allclose).

Counterpart of ``repro.kernels.ref``.  The CPU path and the tests call
these; nothing on the CUDA path does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.participation import masked_combination

__all__ = ["attention_ref", "attention_bf16p_ref", "attention_bf16p_budget",
           "gather_mix_ref", "gather_robust_mix_ref",
           "mix_int8_exact", "mix_int8_ref", "mix_ref", "ssd_ref",
           "ssd_intra_chunk_ref", "ssd_intra_chunk_split_ref", "tf32_rna"]


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


def attention_bf16p_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        block_kv: int = 64, tiles=None) -> torch.Tensor:
    """The bf16 flash-attention kernel's arithmetic, in float32.

    An online softmax over key tiles of ``block_kv`` keys (the kernel's
    tile) with P rounded to bf16 before P V and float32 everywhere else: the
    running max m, the running sum l of the unrounded p, and O = O corr +
    bf16(p) V.  Masked scores take -1e30 and keys past Skv are absent, as
    in the kernel; the result is O / max(l, 1e-30) in q's dtype.

    ``tiles`` lists the key tiles to visit, in order (default: all of them
    once); the tests drop or repeat one to show that the card's tolerance
    sees it.
    """
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = 1.0 / np.sqrt(D)
    qg = q.reshape(B, Sq, Kv, G, D).float()
    kf, vf = k.float(), v.float()
    qpos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, Kv, G, Sq, 1), -1e30, device=q.device)
    l = torch.zeros((B, Kv, G, Sq, 1), device=q.device)
    o = torch.zeros((B, Kv, G, Sq, D), device=q.device)
    if tiles is None:
        tiles = range(-(-Skv // block_kv))
    for t in tiles:
        k0, k1 = t * block_kv, min((t + 1) * block_kv, Skv)
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, kf[:, k0:k1]) * scale
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        mask = torch.ones((Sq, k1 - k0), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + torch.einsum("bkgqc,bckd->bkgqd",
                                    p.bfloat16().float(), vf[:, k0:k1])
        m = m_new
    out = o / l.clamp(min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |x| (float32; 0 at 0): 2^(e - 8) for |x| in
    [2^(e-1), 2^e)."""
    _, e = torch.frexp(x.float().abs())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x != 0, ulp, torch.zeros_like(ulp))


def attention_bf16p_budget(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           out: torch.Tensor, *, causal: bool = True,
                           window: int | None = None) -> torch.Tensor:
    """Elementwise error budget of rounding P to bf16, around ``out``:
    2^-7 (P |V|) + one bf16 ulp of |out|, with P |V| = softmax(S) |V| in
    float32.

    Rounding one p_j to bf16 moves it by at most half an ulp, 2^-8 p_j, so
    the bf16-P model stays within 2^-8 (P |V|) of exact attention before its
    own rounding to bf16 (one ulp); 2^-7 doubles that for slack.  Between
    the kernel and the model the same budget holds: their float32 p may
    differ in the last bits (summation order, exp2 against exp), so one p_j
    may round to the neighbouring bf16 value, one ulp of p_j away (at most
    2^-7 p_j), and the final rounding may differ by one ulp.
    """
    pv = attention_ref(q.float(), k.float(), v.float().abs(), causal=causal,
                       window=window)
    return 2.0 ** -7 * pv + _bf16_ulp(out)


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


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    the nearest value with 10 fraction bits, ties away from zero (integer
    operations on the bits; finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor, *,
                  split: bool = True) -> torch.Tensor:
    """``einsum(eq, a, b)`` of float32 operands as the tensor cores take
    them: with ``split``, hi*hi + hi*lo + lo*hi of TF32 parts, else one
    product of the rounded operands; products and sums in float64 (only
    the operands' rounding shows), the result in float32."""
    f64 = torch.float64
    ah, al = _split(a)
    bh, bl = _split(b)
    out = torch.einsum(eq, ah.to(f64), bh.to(f64))
    if split:
        out = (out + torch.einsum(eq, ah.to(f64), bl.to(f64))
               + torch.einsum(eq, al.to(f64), bh.to(f64)))
    return out.float()


def ssd_intra_chunk_split_ref(xd: torch.Tensor, dA: torch.Tensor,
                              B: torch.Tensor, C: torch.Tensor, *,
                              chunk: int, split: bool = True):
    """The arithmetic of the CUDA intra-chunk kernel (``csrc/ssd_scan.cu``),
    in plain PyTorch: the products :func:`ssd_intra_chunk_ref` computes in
    float32, taken on TF32 operands.

    * G = C_c B_c^T once per chunk: one product of the operands as they
      are when B and C are bfloat16 (exact in TF32), else split;
    * S = G o L in float32; Y_diag = S xd_c, split;
    * state_c^T = (B_c o dec)^T xd_c with B_c o dec formed in float32,
      split.

    A split product is hi*hi + hi*lo + lo*hi, each part rounded by
    :func:`tf32_rna`; with ``split=False`` every product is one TF32
    product of the rounded operands (what one pass on the tensor cores
    would give).  Sums are in float64, so the model shows the operands'
    rounding and not the kernel's summation order.  Returns (Y_diag,
    states, dA_cumsum) as :func:`ssd_intra_chunk_ref` does.
    """
    b, s, h, p = xd.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"s={s} not divisible by chunk={chunk}")
    nc, Q = s // chunk, chunk
    f32, f64 = torch.float32, torch.float64
    exact = B.dtype == torch.bfloat16 and C.dtype == torch.bfloat16
    xdc = xd.to(f32).reshape(b, nc, Q, h, p)
    Bc = B.to(f32).reshape(b, nc, Q, n)
    Cc = C.to(f32).reshape(b, nc, Q, n)
    if exact:
        G = torch.einsum("bcin,bcjn->bcij", Cc.to(f64), Bc.to(f64)).float()
    else:
        G = _tf32_product("bcin,bcjn->bcij", Cc, Bc, split=split)
    cs = torch.cumsum(dA.to(f32).reshape(b, nc, Q, h), dim=2)    # (b,c,l,h)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]             # (b,c,i,j,h)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xd.device).tril()
    Lm = torch.exp(seg.masked_fill(~mask[:, :, None], float("-inf")))
    S = G[..., None] * Lm
    y = _tf32_product("bcijh,bcjhp->bcihp", S, xdc, split=split)
    decay = torch.exp(cs[:, :, -1:, :] - cs)                      # (b,c,l,h)
    Bd = Bc[:, :, :, None, :] * decay[..., None]                  # (b,c,j,h,n)
    states = _tf32_product("bcjhn,bcjhp->bchpn", Bd, xdc, split=split)
    return y.reshape(b, s, h, p), states, cs.reshape(b, s, h)
