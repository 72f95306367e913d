"""Transformer building blocks in plain PyTorch.

Counterpart of ``repro.models.layers``; names and numerics follow the
reference: RMSNorm computes in float32 and casts back, RoPE rotates
interleaved pairs (``x[..., 0::2]``, ``x[..., 1::2]``), masking uses
``NEG_INF = -1e30`` and the softmax denominator is clamped at 1e-30.
Parameters are plain dicts of tensors; initializers draw from an explicit
``torch.Generator`` and create tensors on its device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

PyTree = Any
NEG_INF = -1e30

__all__ = ["NEG_INF", "rms_norm", "init_rms_norm", "rope_frequencies",
           "apply_rope", "AttnDims", "init_attention", "qkv_project",
           "flash_attention_jnp", "decode_attention_jnp", "init_mlp",
           "mlp_forward"]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def init_rms_norm(dim: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, rotary_pct: float,
                     theta: float) -> np.ndarray:
    """Inverse frequencies for the rotated sub-dimension."""
    rot_dim = int(head_dim * rotary_pct)
    rot_dim -= rot_dim % 2
    return 1.0 / (theta ** (np.arange(0, rot_dim, 2, dtype=np.float64)
                            / rot_dim))


@functools.lru_cache(maxsize=16)
def _inv_freq(head_dim: int, rotary_pct: float, theta: float,
              device: torch.device) -> torch.Tensor:
    """:func:`rope_frequencies` as a float32 tensor on ``device``, made once:
    a host-to-device copy per call would stall the host behind the device
    at every layer.  Callers must not write to it."""
    return torch.as_tensor(rope_frequencies(head_dim, rotary_pct, theta),
                           dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               rotary_pct: float = 1.0, theta: float = 1e4) -> torch.Tensor:
    """Rotate the first ``rotary_pct`` fraction of the head dim.

    x: (..., S, H, D); positions: broadcastable to (..., S).
    """
    inv_freq = _inv_freq(x.shape[-1], rotary_pct, theta, x.device)
    rot_dim = inv_freq.shape[0] * 2
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    ang = positions[..., None].float() * inv_freq             # (..., S, rot/2)
    ang = ang[..., None, :]                                   # broadcast heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    num_heads: int
    num_kv_heads: int
    head_dim: int

    @property
    def group(self) -> int:
        return self.num_heads // self.num_kv_heads


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    # scaled in place: one float32 transient, not two (kimi-k2's expert
    # leaves are 22.5 GB each in float32)
    return torch.randn(shape, generator=gen, device=gen.device).mul_(
        scale).to(dtype)


def init_attention(gen: torch.Generator, d_model: int, dims: AttnDims,
                   qk_norm: bool, dtype=torch.float32) -> dict:
    H, Kv, D = dims.num_heads, dims.num_kv_heads, dims.head_dim
    s = 1.0 / np.sqrt(d_model)
    p = {
        "wq": _normal(gen, (d_model, H * D), s, dtype),
        "wk": _normal(gen, (d_model, Kv * D), s, dtype),
        "wv": _normal(gen, (d_model, Kv * D), s, dtype),
        "wo": _normal(gen, (H * D, d_model), s, dtype),
    }
    if qk_norm:
        p["q_norm"] = init_rms_norm(D, dtype, gen.device)
        p["k_norm"] = init_rms_norm(D, dtype, gen.device)
    return p


def qkv_project(params: dict, x: torch.Tensor, dims: AttnDims, *,
                positions: torch.Tensor, rotary_pct: float, theta: float,
                qk_norm: bool, norm_eps: float = 1e-5):
    """Project hidden states to (q, k, v) with qk-norm + RoPE applied."""
    B, S, _ = x.shape
    H, Kv, D = dims.num_heads, dims.num_kv_heads, dims.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, D)
    k = (x @ params["wk"]).reshape(B, S, Kv, D)
    v = (x @ params["wv"]).reshape(B, S, Kv, D)
    if qk_norm:
        q = rms_norm(q, params["q_norm"]["scale"], norm_eps)
        k = rms_norm(k, params["k_norm"]["scale"], norm_eps)
    q = apply_rope(q, positions, rotary_pct=rotary_pct, theta=theta)
    k = apply_rope(k, positions, rotary_pct=rotary_pct, theta=theta)
    return q, k, v


def flash_attention_jnp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        q_offset: int = 0, q_chunk: int = 512,
                        kv_chunk: int = 512) -> torch.Tensor:
    """Streaming (online-softmax) GQA attention in plain PyTorch.

    The counterpart of ``repro.models.layers.flash_attention_jnp`` (the
    name is kept so the reference's call sites map one to one).
    q: (B, Sq, H, D);  k, v: (B, Skv, Kv, D)  with H % Kv == 0.
    ``q_offset``: absolute position of q[0] relative to k[0].
    Memory is O(q_chunk * kv_chunk) per (batch, head) — never S^2.
    """
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = 1.0 / np.sqrt(D)
    dev = q.device

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    pad_q = (-Sq) % q_chunk
    pad_kv = (-Skv) % kv_chunk
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    nq, nkv = qp.shape[1] // q_chunk, kp.shape[1] // kv_chunk

    qc = qp.reshape(B, nq, q_chunk, Kv, G, D)
    kc = kp.reshape(B, nkv, kv_chunk, Kv, D)
    vc = vp.reshape(B, nkv, kv_chunk, Kv, D)
    q_pos = (torch.arange(nq * q_chunk, device=dev).reshape(nq, q_chunk)
             + q_offset)
    kv_pos = torch.arange(nkv * kv_chunk, device=dev).reshape(nkv, kv_chunk)
    kv_valid = kv_pos < Skv                            # padding mask

    outs = []
    for qi in range(nq):
        q_blk = qc[:, qi].float()                      # (B, Cq, Kv, G, D)
        qpos = q_pos[qi]
        acc = torch.zeros((B, Kv, G, q_chunk, D), device=dev)
        m = torch.full((B, Kv, G, q_chunk), NEG_INF, device=dev)
        denom = torch.zeros((B, Kv, G, q_chunk), device=dev)
        for ki in range(nkv):
            kpos = kv_pos[ki]
            s = torch.einsum("bqkgd,bckd->bkgqc", q_blk,
                             kc[:, ki].float()) * scale
            mask = kv_valid[ki][None, :]
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            denom = denom * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p, vc[:, ki].float())
            m = m_new
        out = acc / torch.clamp(denom[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))        # (B, Cq, Kv, G, D)
    out = torch.stack(outs, dim=1).reshape(B, nq * q_chunk, H, D)
    return out[:, :Sq].to(q.dtype)


def decode_attention_jnp(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffer) cache.

    q: (B, 1, H, D); caches: (B, C, Kv, D); valid: (C,) or (B, C) bool.
    """
    B, _, H, D = q.shape
    Kv = k_cache.shape[2]
    G = H // Kv
    scale = 1.0 / np.sqrt(D)
    qg = q.reshape(B, Kv, G, D)
    s = torch.einsum("bkgd,bckd->bkgc", qg.float(), k_cache.float()) * scale
    if valid.ndim == 1:
        valid = valid[None, :]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU and plain GELU variants)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype=torch.float32) -> dict:
    s_in, s_out = 1.0 / np.sqrt(d_model), 1.0 / np.sqrt(d_ff)
    if act == "silu":  # gated
        return {"w_gate": _normal(gen, (d_model, d_ff), s_in, dtype),
                "w_up": _normal(gen, (d_model, d_ff), s_in, dtype),
                "w_down": _normal(gen, (d_ff, d_model), s_out, dtype)}
    return {"w_up": _normal(gen, (d_model, d_ff), s_in, dtype),
            "w_down": _normal(gen, (d_ff, d_model), s_out, dtype)}


def mlp_forward(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]
