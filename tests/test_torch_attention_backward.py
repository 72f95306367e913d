"""The bf16 flash-attention backward: its plain model on the CPU, the
kernel on the card.

``attention_bf16_backward_ref`` is the kernel's arithmetic in float32 (P
and dZ rounded to bf16 before their products).  On the CPU it is held to
float32 autograd through ``attention_ref``, with witnesses that the
tolerance sees a missing delta term or a missing key tile, and
``attention_op`` is shown to keep the plain float32 backward for CPU and
float32 operands.  The kernel against this model and against the plain
backward on the card is in ``tests/test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ops import attention_op  # noqa: E402
from repro_torch.kernels.ref import (attention_bf16_backward_ref,  # noqa: E402
                                     attention_bf16p_ref, attention_lse_ref,
                                     attention_ref)
from repro_torch.models.layers import flash_attention_jnp  # noqa: E402

# The model against exact float32 gradients, relative Frobenius error of
# each of dq, dk and dv: the model rounds its outputs to bf16 (2^-9
# relative an element at most), and P and dZ once each before their
# products (2^-9 each), so about 3 x 2^-9 = 5.9e-3 at worst; 2^-7 leaves
# room above that.  It reads 2.3e-3 to 2.7e-3 on the cases below.
EXACT_TOL = 2.0 ** -7
# The kernel against its model on the card: the same bf16 operands and
# products, so they differ only where a float32 value of P, dZ or an
# output sits so near a bf16 rounding boundary that the other summation
# order or exp2 rounds it to the neighbouring value (2^-8 relative of that
# term): one bf16 ulp, 2^-8, in norm.
MODEL_TOL = 2.0 ** -8


def _inputs(seed, B, Sq, Skv, H, Kv, D, device="cpu"):
    """Seeded numpy q, k, v and an output gradient, in bf16."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, Kv, D), (B, Skv, Kv, D),
                      (B, Sq, H, D))]
    return [torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)
            for a in arrs]


def _rel(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm()).item()


def _exact_grads(q, k, v, g, causal, window):
    """Gradients of float32 attention (``attention_ref``) at the bf16
    inputs, by autograd."""
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    out = attention_ref(*leaves, causal=causal, window=window)
    return torch.autograd.grad(out, leaves, g.float())


def _model_grads(q, k, v, g, causal, window, *, out=None, tiles=None):
    """The model's (dq, dk, dv) on the bf16 forward model's output and the
    plain log-sum-exp, as the kernels produce them."""
    if out is None:
        out = attention_bf16p_ref(q, k, v, causal=causal, window=window)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    return attention_bf16_backward_ref(q, k, v, out, g, lse, causal=causal,
                                       window=window, tiles=tiles)


# (B, Sq, Skv, H, Kv, D, causal, window): causal and windowed, G = 1 and
# 4, every head dim the kernel takes, Sq = 200 not a multiple of the
# kernel's query tile (64) nor its key tile (128); and non-causal ragged
CASES = [(1, 200, 200, Kv * G, Kv, D, True, window)
         for D in (32, 64, 112, 128) for G, Kv in ((1, 2), (4, 1))
         for window in (None, 48)]
CASES += [(2, 130, 260, 4, 2, 64, False, None)]


@pytest.mark.parametrize("B,Sq,Skv,H,Kv,D,causal,window", CASES)
def test_backward_model_matches_float32_autograd(B, Sq, Skv, H, Kv, D,
                                                 causal, window):
    q, k, v, g = _inputs(0, B, Sq, Skv, H, Kv, D)
    got = _model_grads(q, k, v, g, causal, window)
    want = _exact_grads(q, k, v, g, causal, window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert _rel(a, b) <= EXACT_TOL, (name, _rel(a, b))


@pytest.mark.parametrize("fault", ["no_delta", "tile_dropped"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 96),
                                           (False, None)])
def test_backward_tolerance_sees_a_missing_term(fault, causal, window):
    """The delta term left out (the model fed a zero output, so delta = 0)
    moves dq and dk, and one key tile of 128 left out moves all three, by
    at least ten times the tolerance."""
    q, k, v, g = _inputs(1, 1, 384, 384, 4, 2, 64)
    want = _exact_grads(q, k, v, g, causal, window)
    if fault == "no_delta":
        bad = _model_grads(q, k, v, g, causal, window,
                           out=torch.zeros_like(q))[:2]
    else:
        bad = _model_grads(q, k, v, g, causal, window, tiles=[0, 2])
    for a, b in zip(bad, want):
        assert _rel(a, b) >= 10 * EXACT_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_operands_keep_the_plain_backward(dtype):
    """On the CPU, in either dtype, ``attention_op``'s gradients are the
    plain float32 backward's: autograd through ``flash_attention_jnp``,
    bit for bit."""
    q, k, v, g = (t.to(dtype) for t in _inputs(2, 1, 192, 192, 6, 2, 32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(attention_op(*leaves, window=64), leaves, g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        flash_attention_jnp(*leaves, causal=True, window=64), leaves, g)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert torch.equal(a, b)


def test_backward_wrapper_takes_the_model_on_the_cpu():
    q, k, v, g = _inputs(3, 1, 100, 100, 4, 1, 64)
    out, lse = fa.flash_attention_lse(q, k, v)
    assert torch.equal(out, attention_ref(q, k, v))
    assert lse.shape == (1, 4, 100) and lse.dtype == torch.float32
    before = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(q, k, v, out, g, lse)
    want = attention_bf16_backward_ref(q, k, v, out, g, lse)
    assert fa.flash_attention_backward.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_lse_ref_is_the_rows_log_sum_exp():
    """``attention_lse_ref`` against the softmax it normalises: exp(z -
    lse) sums to 1 over the keys each row sees."""
    q, k, _, _ = _inputs(4, 2, 70, 90, 6, 3, 32)
    for causal, window in ((True, None), (True, 20), (False, None)):
        lse = attention_lse_ref(q, k, causal=causal, window=window)
        z = torch.einsum("bqhd,bchd->bhqc", q.float(),
                         k.float().repeat_interleave(2, dim=2)) / np.sqrt(32)
        qpos, kpos = torch.arange(70)[:, None], torch.arange(90)[None, :]
        mask = torch.ones(70, 90, dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        total = torch.where(mask, torch.exp(z - lse[..., None]), 0.0).sum(-1)
        assert torch.allclose(total, torch.ones_like(total), atol=1e-5)


def test_backward_operands_are_checked():
    q, k, v, g = _inputs(5, 1, 8, 8, 4, 2, 64)
    lse = torch.zeros(1, 4, 8)
    fa.check_backward_operands(q, k, v, q, g, lse, 4)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.check_backward_operands(q.float(), k.float(), v.float(),
                                   q.float(), g.float(), lse)
    with pytest.raises(ValueError, match="dout"):
        fa.check_backward_operands(q, k, v, q, g[:, :4], lse)
    with pytest.raises(ValueError, match="lse"):
        fa.check_backward_operands(q, k, v, q, g, lse.double())
    with pytest.raises(ValueError, match="lse"):
        fa.check_backward_operands(q, k, v, q, g, lse[:, :2])
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_backward_operands(
            q, k, v, q.transpose(1, 2).contiguous().transpose(1, 2), g, lse)
    with pytest.raises(ValueError, match="head dim"):
        fa.check_backward_operands(q[..., :48], k[..., :48], v[..., :48],
                                   q[..., :48], g[..., :48], lse)
