"""Plain float32 reference of the Mistral decoder
[hf:mistralai/Mistral-7B-Instruct-v0.2].

Each decoder layer: RMSNorm, grouped-query attention (query head h reads
key/value head h // (heads / kv_heads)) with rotary position embeddings
over the whole sequence (pairs (2i, 2i+1) rotated by pos *
theta^(-2i/d)), causal softmax, the output projection; RMSNorm and the
SwiGLU MLP (silu(x W_gate) * (x W_up)) W_down.  Then the final RMSNorm,
the untied head and next-token cross-entropy.  Attention is the plain
(S, S) softmax, one layer at a time, its activations recomputed in the
backward pass.

Parameters are a flat {path: tensor} dict under the paths
:func:`layout` names.  This module imports nothing of the program under
test.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["layout", "layered", "loss_and_grad"]

SEG = "segments/00.attn.{n:03d}"
NAMES = ("ln1/scale", "attn/wq", "attn/wk", "attn/wv", "attn/wo",
         "ln2/scale", "mlp/w_gate", "mlp/w_up", "mlp/w_down")


def layout(cfg: dict) -> list:
    """[(path, shape, dtype, init)] of one agent's parameters (see
    :func:`portbench.reference.mamba2.layout` for ``init``)."""
    D, V, L, F_ = cfg["d_model"], cfg["vocab_size"], cfg["num_layers"], \
        cfg["d_ff"]
    Hd = cfg["num_heads"] * cfg["head_dim"]
    Kd = cfg["num_kv_heads"] * cfg["head_dim"]
    dt = getattr(torch, cfg["dtype"])
    s = 1 / math.sqrt(D)
    seg = SEG.format(n=L)
    return [("embed", (V, D), dt, ("normal", 0.02)),
            ("final_norm/scale", (D,), dt, ("ones",)),
            ("lm_head", (D, V), dt, ("normal", s)),
            (f"{seg}/ln1/scale", (L, D), dt, ("ones",)),
            (f"{seg}/attn/wq", (L, D, Hd), dt, ("normal", s)),
            (f"{seg}/attn/wk", (L, D, Kd), dt, ("normal", s)),
            (f"{seg}/attn/wv", (L, D, Kd), dt, ("normal", s)),
            (f"{seg}/attn/wo", (L, Hd, D), dt, ("normal", s)),
            (f"{seg}/ln2/scale", (L, D), dt, ("ones",)),
            (f"{seg}/mlp/w_gate", (L, D, F_), dt, ("normal", s)),
            (f"{seg}/mlp/w_up", (L, D, F_), dt, ("normal", s)),
            (f"{seg}/mlp/w_down", (L, F_, D), dt,
             ("normal", 1 / math.sqrt(F_)))]


def layered(path: str) -> bool:
    return path.startswith("segments/")


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x (b, s, heads, d): pair (2i, 2i+1) at position t rotated by
    t * theta^(-2i/d)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = torch.arange(x.shape[1], dtype=torch.float64,
                       device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def _layer(x, ln1, wq, wk, wv, wo, ln2, w_gate, w_up, w_down, cfg, prec):
    b, s, _ = x.shape
    H, Kv, Dh = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    eps = cfg["norm_eps"]
    h = _rms(x, ln1, eps)
    q = rope(prec.mm(h, wq).reshape(b, s, H, Dh), cfg["rope_theta"])
    k = rope(prec.mm(h, wk).reshape(b, s, Kv, Dh), cfg["rope_theta"])
    v = prec.mm(h, wv).reshape(b, s, Kv, Dh)
    k = k.repeat_interleave(H // Kv, dim=2)
    v = v.repeat_interleave(H // Kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, H * Dh)
    x = x + prec.mm(o, wo)
    h = _rms(x, ln2, eps)
    return x + prec.mm(F.silu(prec.mm(h, w_gate)) * prec.mm(h, w_up),
                       w_down)


def loss_and_grad(agent: dict, batch: dict, cfg: dict, prec,
                  fault: str | None = None):
    """One agent's next-token loss on ``batch`` (``tokens`` and ``labels``
    (B, S)) and its gradients {path: float32}.  ``fault="half_batch"``:
    the loss is the mean over the first half of the positions only."""
    params = {p: x.detach().float().requires_grad_() for p, x in
              agent.items()}
    seg = SEG.format(n=cfg["num_layers"])
    with torch.enable_grad():
        x = params["embed"][batch["tokens"].long()]
        for j in range(cfg["num_layers"]):
            x = checkpoint(_layer, x, *(params[f"{seg}/{m}"][j]
                                        for m in NAMES),
                           cfg, prec, use_reentrant=False)
        x = _rms(x, params["final_norm/scale"], cfg["norm_eps"])
        labels = batch["labels"].long()
        if fault == "half_batch":
            half = x.shape[1] // 2
            x, labels = x[:, :half], labels[:, :half]
        logits = prec.mm(x, params["lm_head"])
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), dict(zip(params, grads))
