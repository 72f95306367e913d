"""Mamba2 — the state-space duality (SSD) mixer [arXiv:2405.21060].

Counterpart of ``repro.models.ssm``: the chunked SSD dual form for
training and prefill (quadratic within chunks, a linear recurrence across
them) and the O(1)-state recurrent step for decode.  Dtypes follow the
reference at every step: :func:`ssd_chunked` computes in float32 and
returns ``y`` in ``x``'s dtype, :func:`_causal_conv` adds its k products in
the input dtype, and the gated RMSNorm runs in float32 and casts back.
With ``use_kernel`` the SSD goes through
:func:`repro_torch.kernels.ops.ssd_op` (the intra-chunk CUDA kernel).

Single group (G = 1) for the B/C projections; heads H = d_inner / head_dim.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal

__all__ = ["init_ssm", "ssm_specs", "ssm_forward", "ssm_decode_step",
           "ssd_chunked", "ssm_state_shapes", "pad_to_chunk", "inter_chunk"]


def _dims(d_model: int, expand: int, head_dim: int, state: int):
    d_inner = expand * d_model
    H = d_inner // head_dim
    conv_dim = d_inner + 2 * state          # conv over [x, B, C]
    proj_out = 2 * d_inner + 2 * state + H  # [z, x, B, C, dt]
    return d_inner, H, conv_dim, proj_out


def init_ssm(gen: torch.Generator, d_model: int, *, expand: int,
             head_dim: int, state: int, conv_kernel: int,
             dtype=torch.float32) -> dict:
    """Random mixer parameters drawn from ``gen``, on its device, at the
    reference's shapes and scales (not its values)."""
    d_inner, H, conv_dim, proj_out = _dims(d_model, expand, head_dim, state)
    dev = gen.device
    u = torch.rand((H,), generator=gen, device=dev)
    dt = torch.exp(u * (np.log(0.1) - np.log(0.001)) + np.log(0.001))
    return {
        "in_proj": _normal(gen, (d_model, proj_out), 1.0 / np.sqrt(d_model),
                           dtype),
        "conv_w": _normal(gen, (conv_kernel, conv_dim), 0.1, dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": (dt + torch.log(-torch.expm1(-dt))).float(),
        "norm": {"scale": torch.ones((d_inner,), dtype=dtype, device=dev)},
        "out_proj": _normal(gen, (d_inner, d_model), 1.0 / np.sqrt(d_inner),
                            dtype),
    }


def ssm_specs(d_model: int, *, expand: int, head_dim: int, state: int,
              conv_kernel: int, dtype, lead: tuple = ()) -> dict:
    """``meta``-device tensors matching :func:`init_ssm`, each with the
    leading dims ``lead``."""
    d_inner, H, conv_dim, proj_out = _dims(d_model, expand, head_dim, state)

    def spec(shape, dt=dtype):
        return torch.empty(lead + shape, dtype=dt, device="meta")

    return {
        "in_proj": spec((d_model, proj_out)),
        "conv_w": spec((conv_kernel, conv_dim)),
        "conv_b": spec((conv_dim,)),
        "A_log": spec((H,), torch.float32),
        "D": spec((H,), torch.float32),
        "dt_bias": spec((H,), torch.float32),
        "norm": {"scale": spec((d_inner,))},
        "out_proj": spec((d_inner, d_model)),
    }


def ssm_state_shapes(batch: int, d_model: int, *, expand: int, head_dim: int,
                     state: int, conv_kernel: int):
    """(ssm_state, conv_state) shapes of the decode cache."""
    d_inner, H, conv_dim, _ = _dims(d_model, expand, head_dim, state)
    return ((batch, H, head_dim, state), (batch, conv_kernel - 1, conv_dim))


# ---------------------------------------------------------------------------
# chunked SSD (training / prefill)
# ---------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = sum_{j < t <= i} x_t,
    -inf above the diagonal."""
    Lq = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Lq, Lq), dtype=torch.bool, device=x.device).tril()
    return d.masked_fill(~mask, float("-inf"))


def pad_to_chunk(x, dt, B, C, chunk: int):
    """Zero-pad s up to a multiple of ``chunk``: padded steps have dt = 0,
    so they neither decay nor feed the state."""
    pad = (-x.shape[1]) % chunk
    if not pad:
        return x, dt, B, C
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
            F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)))


def inter_chunk(states: torch.Tensor, Cc: torch.Tensor,
                dA_cs: torch.Tensor,
                initial_state: torch.Tensor | None = None):
    """The SSD's linear part: the recurrence over chunk-end states (a loop
    over chunks) and the state-to-output term.

    states: (b, c, h, p, n) chunk-end states; Cc: (b, c, l, n) and dA_cs
    (b, c, l, h), both float32.  Returns (Y_off (b, c, l, h, p), the final
    state (b, h, p, n)).
    """
    b, c, h, p, n = states.shape
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])        # (b, c, h)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32,
                         device=states.device)
             if initial_state is None else initial_state.float())
    entering = []
    for ci in range(c):
        entering.append(carry)                         # state entering ci
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    states_in = torch.stack(entering, dim=1)           # (b, c, h, p, n)
    Y_off = (torch.einsum("bcln,bchpn->bclhp", Cc, states_in)
             * torch.exp(dA_cs)[..., None])
    return Y_off, carry


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                initial_state: torch.Tensor | None = None):
    """SSD dual form.

    Args:
      x:  (b, s, h, p) inputs (pre-activation, not yet dt-scaled).
      dt: (b, s, h) positive step sizes.
      A:  (h,) negative decay rates.
      B, C: (b, s, n) single-group projections.
      chunk: chunk length (s % chunk == 0 required; pad upstream).
      initial_state: optional (b, h, p, n).
    Returns:
      (y, final_state): y (b, s, h, p) in x's dtype, final_state
      (b, h, p, n) float32.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    assert s % chunk == 0, "sequence must be chunk-padded"
    c = s // chunk
    f32 = torch.float32

    xd = (x.to(f32) * dt.to(f32)[..., None]).reshape(b, c, chunk, h, p)
    dA = (dt.to(f32) * A.to(f32)).reshape(b, c, chunk, h)
    dA = dA.permute(0, 3, 1, 2)                        # (b, h, c, l)
    Bc = B.to(f32).reshape(b, c, chunk, n)
    Cc = C.to(f32).reshape(b, c, chunk, n)

    dA_cs = torch.cumsum(dA, dim=-1)                   # (b, h, c, l)

    # 1. intra-chunk (diagonal blocks): (C B^T), then o L, then . xd, so no
    #    (b, c, l, s, h, p) intermediate is built
    Lm = torch.exp(_segsum(dA))                        # (b, h, c, l, s)
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", CB[:, None] * Lm, xd)

    # 2. per-chunk final states
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)  # (b, h, c, l)
    states = torch.einsum("bclhp,bcln->bchpn",
                          xd * decay_states.permute(0, 2, 3, 1)[..., None],
                          Bc)

    # 3, 4. inter-chunk recurrence, state -> output within chunk
    Y_off, final = inter_chunk(states, Cc, dA_cs.permute(0, 2, 3, 1),
                               initial_state)
    y = (Y_diag + Y_off).reshape(b, s, h, p)
    return y.to(x.dtype), final


# ---------------------------------------------------------------------------
# full block forward (train / prefill)
# ---------------------------------------------------------------------------

def _split_zxbcdt(zxbcdt: torch.Tensor, d_inner: int, state: int):
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * state]
    dt = zxbcdt[..., 2 * d_inner + 2 * state:]
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 conv_state: torch.Tensor | None = None):
    """Depthwise causal conv1d + SiLU.  xBC: (b, s, c); w: (k, c).  The k
    products are added in order, in the input dtype, as the reference
    does."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xBC.shape[0], k - 1, xBC.shape[2]),
                          dtype=xBC.dtype, device=xBC.device)
    else:
        pad = conv_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)
    s = xBC.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(k - 1):] if k > 1 else pad[:, :0]
    return F.silu(out + bias), new_state


def ssm_forward(params: dict, u: torch.Tensor, *, expand: int,
                head_dim: int, state: int, chunk: int, conv_kernel: int = 4,
                norm_eps: float = 1e-5,
                conv_state: torch.Tensor | None = None,
                ssm_state: torch.Tensor | None = None,
                return_state: bool = False, use_kernel: bool = False):
    """Full Mamba2 mixer.  u: (b, s, d_model) -> (b, s, d_model); with
    ``return_state`` also (final ssm state, conv state)."""
    d_model = u.shape[-1]
    d_inner, H, conv_dim, _ = _dims(d_model, expand, head_dim, state)
    b, s, _ = u.shape

    zxbcdt = u @ params["in_proj"]
    z, xBC, dt = _split_zxbcdt(zxbcdt, d_inner, state)
    xBC, new_conv = _causal_conv(xBC, params["conv_w"], params["conv_b"],
                                 conv_state)
    x = xBC[..., :d_inner].reshape(b, s, H, head_dim)
    B = xBC[..., d_inner:d_inner + state]
    C = xBC[..., d_inner + state:]

    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    xp, dtp, Bp, Cp = pad_to_chunk(x, dt, B, C, chunk)
    if use_kernel:
        from repro_torch.kernels.ops import ssd_op
        y, final_state = ssd_op(xp, dtp, A, Bp, Cp, chunk=chunk,
                                initial_state=ssm_state)
    else:
        y, final_state = ssd_chunked(xp, dtp, A, Bp, Cp, chunk=chunk,
                                     initial_state=ssm_state)
    y = y[:, :s].float()
    y = y + params["D"][None, None, :, None] * x.float()
    y = y.reshape(b, s, d_inner)

    # gated RMSNorm (mamba2's RMSNormGated): float32 inside, u's dtype out
    y = y * F.silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + norm_eps)
         * params["norm"]["scale"].float()).to(u.dtype)
    out = y @ params["out_proj"]
    if return_state:
        return out, (final_state, new_conv)
    return out


def ssm_decode_step(params: dict, u: torch.Tensor, ssm_state: torch.Tensor,
                    conv_state: torch.Tensor, *, expand: int, head_dim: int,
                    state: int, conv_kernel: int = 4,
                    norm_eps: float = 1e-5):
    """Single-token recurrent step.

    u: (b, 1, d_model); ssm_state: (b, H, P, N); conv_state:
    (b, k-1, conv_dim).  Returns (out (b, 1, d_model), new_ssm_state,
    new_conv_state).
    """
    d_model = u.shape[-1]
    d_inner, H, conv_dim, _ = _dims(d_model, expand, head_dim, state)
    b = u.shape[0]

    zxbcdt = u @ params["in_proj"]                       # (b, 1, proj)
    z, xBC, dt = _split_zxbcdt(zxbcdt, d_inner, state)
    # conv over the window [conv_state, xBC_t]
    k = params["conv_w"].shape[0]
    window = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    out_c = torch.einsum("bkc,kc->bc", window[:, -k:], params["conv_w"])
    xBC_t = F.silu(out_c + params["conv_b"])             # (b, conv_dim)
    new_conv = window[:, -(k - 1):] if k > 1 else conv_state

    x = xBC_t[:, :d_inner].reshape(b, H, head_dim)
    B = xBC_t[:, d_inner:d_inner + state]                # (b, n)
    C = xBC_t[:, d_inner + state:]

    dt = F.softplus(dt[:, 0].float() + params["dt_bias"])  # (b, H)
    A = -torch.exp(params["A_log"])                      # (H,)
    decay = torch.exp(dt * A[None, :])                   # (b, H)
    xd = x.float() * dt[..., None]
    new_state = (ssm_state * decay[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", xd, B.float()))
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float())
    y = y + params["D"][None, :, None] * x.float()
    y = y.reshape(b, d_inner)

    y = y * F.silu(z[:, 0]).float()
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + norm_eps) * params["norm"]["scale"].float()
    out = (y.to(u.dtype) @ params["out_proj"])[:, None, :]
    return out, new_state, new_conv
