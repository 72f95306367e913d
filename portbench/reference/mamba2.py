"""Plain float32 reference of a Mamba-2 language model [arXiv:2405.21060].

Each layer: RMSNorm, the input projection to [z, x, B, C, dt], a depthwise
causal convolution of [x, B, C] and SiLU, the selective state space model
in its quadratic (attention-like) form over the whole sequence

    y_t = sum_{s <= t} (C_t . B_s) exp(sum_{s < r <= t} dt_r A_h) dt_s x_s
          + D_h x_t,

a SiLU gate by z, a gated RMSNorm and the output projection, added to the
residual stream.  Then the final RMSNorm, the tied embedding as the head,
and next-token cross-entropy.  One group of B and C; ``dt =
softplus(dt_raw + dt_bias)``, ``A_h = -exp(A_log_h)``.  The segment sums
are taken in float64 (their differences reach thousands), everything else
in float32.  No chunking: the whole (S, S) form, one layer at a time, its
activations recomputed in the backward pass.

Parameters are a flat {path: tensor} dict under the paths
:func:`layout` names; the layer leaves are stacked on a leading axis.
This module imports nothing of the program under test.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["layout", "layered", "loss_and_grad"]

SEG = "segments/00.mamba.{n:03d}"


def _dims(cfg: dict):
    d_inner = cfg["ssm_expand"] * cfg["d_model"]
    heads = d_inner // cfg["ssm_head_dim"]
    n = cfg["ssm_state"]
    return d_inner, heads, n, d_inner + 2 * n, 2 * d_inner + 2 * n + heads


def layout(cfg: dict) -> list:
    """[(path, shape, dtype, init)] of one agent's parameters, ``init``
    ("normal", std) | ("ones",) | ("zeros",) | ("a_log",) | ("dt_bias",)."""
    D, V, L = cfg["d_model"], cfg["vocab_size"], cfg["num_layers"]
    di, H, n, conv_dim, proj = _dims(cfg)
    k = cfg["conv_kernel"]
    dt = getattr(torch, cfg["dtype"])
    f32 = torch.float32
    seg = SEG.format(n=L)
    out = [("embed", (V, D), dt, ("normal", 0.02)),
           ("final_norm/scale", (D,), dt, ("ones",)),
           (f"{seg}/ln1/scale", (L, D), dt, ("ones",)),
           (f"{seg}/ssm/in_proj", (L, D, proj), dt,
            ("normal", 1 / math.sqrt(D))),
           (f"{seg}/ssm/conv_w", (L, k, conv_dim), dt, ("normal", 0.1)),
           (f"{seg}/ssm/conv_b", (L, conv_dim), dt, ("zeros",)),
           (f"{seg}/ssm/A_log", (L, H), f32, ("a_log",)),
           (f"{seg}/ssm/D", (L, H), f32, ("ones",)),
           (f"{seg}/ssm/dt_bias", (L, H), f32, ("dt_bias",)),
           (f"{seg}/ssm/norm/scale", (L, di), dt, ("ones",)),
           (f"{seg}/ssm/out_proj", (L, di, D), dt,
            ("normal", 1 / math.sqrt(di)))]
    if not cfg["tie_embeddings"]:
        out.append(("lm_head", (D, V), dt, ("normal", 1 / math.sqrt(D))))
    return out


def layered(path: str) -> bool:
    return path.startswith("segments/")


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def ssd(x, dt, A, B, C):
    """x (b, s, h, p), dt (b, s, h), A (h,), B and C (b, s, n) -> y
    (b, s, h, p), the quadratic form of the module docstring without the
    D term."""
    s = x.shape[1]
    cs = torch.cumsum((dt * A).double(), dim=1)             # (b, s, h)
    seg = cs[:, :, None, :] - cs[:, None, :, :]             # (b, t, s, h)
    keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~keep[None, :, :, None],
                                      float("-inf"))).float()
    cb = torch.einsum("btn,bsn->bts", C, B)
    return torch.einsum("btsh,bshp->bthp", cb[..., None] * decay,
                        dt[..., None] * x)


def _layer(x, ln1, in_proj, conv_w, conv_b, A_log, Dh, dt_bias, norm,
           out_proj, cfg, prec):
    di, H, n, conv_dim, _ = _dims(cfg)
    b, s, _ = x.shape
    P, k = cfg["ssm_head_dim"], cfg["conv_kernel"]
    eps = cfg["norm_eps"]
    h = _rms(x, ln1, eps)
    zxbcdt = prec.mm(h, in_proj)
    z, xbc, dt = zxbcdt.split([di, conv_dim, H], dim=-1)
    # depthwise causal convolution: out_t = sum_i w_i xbc_{t - (k-1) + i}
    xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)),
                   conv_w.t().unsqueeze(1), conv_b, groups=conv_dim)
    xbc = F.silu(xbc.transpose(1, 2))
    xs, B, C = xbc.split([di, n, n], dim=-1)
    xs = xs.reshape(b, s, H, P)
    dt = F.softplus(dt + dt_bias)
    A = -torch.exp(A_log)
    y = ssd(xs, dt, A, B, C) + Dh[:, None] * xs
    y = y.reshape(b, s, di) * F.silu(z)
    y = _rms(y, norm, eps)
    return x + prec.mm(y, out_proj)


def loss_and_grad(agent: dict, batch: dict, cfg: dict, prec,
                  fault: str | None = None):
    """One agent's next-token loss on ``batch`` (tokens and labels (B, S))
    and its gradients {path: float32}.  ``fault="half_batch"``: the loss
    is the mean over the first half of the positions only."""
    params = {p: x.detach().float().requires_grad_() for p, x in
              agent.items()}
    L = cfg["num_layers"]
    seg = SEG.format(n=L)
    names = ("ln1/scale", "ssm/in_proj", "ssm/conv_w", "ssm/conv_b",
             "ssm/A_log", "ssm/D", "ssm/dt_bias", "ssm/norm/scale",
             "ssm/out_proj")
    with torch.enable_grad():
        E = params["embed"]
        x = E[batch["tokens"].long()]
        for j in range(L):
            x = checkpoint(_layer, x, *(params[f"{seg}/{m}"][j]
                                        for m in names),
                           cfg, prec, use_reentrant=False)
        x = _rms(x, params["final_norm/scale"], cfg["norm_eps"])
        head = E.t() if cfg["tie_embeddings"] else params["lm_head"]
        labels = batch["labels"].long()
        if fault == "half_batch":
            half = x.shape[1] // 2
            x, labels = x[:, :half], labels[:, :half]
        logits = prec.mm(x, head)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), dict(zip(params, grads))
