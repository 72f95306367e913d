"""Port parity: the flash-attention op.

``repro_torch.kernels.ops.attention_op`` (on the CPU: the plain version
``attention_ref`` forward, the streaming twin backward) against the
reference's ``repro.kernels.ops.attention_op`` run in interpret mode, on
the cases of ``tests/test_kernels.py``.  The CUDA kernel against its plain
version on the card is in ``tests/test_torch_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ops import attention_op as ref_attention_op  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ops import attention_op  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402

# the reference's gates (tests/test_kernels.py), atol = rtol
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, Sq, Skv, H, Kv, D, dtype):
    """The same seeded numpy q, k, v for both packages, cast to ``dtype``
    (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, Kv, D), (B, Skv, Kv, D))]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _assert_close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("B,S,H,Kv,D", [
    (1, 128, 4, 4, 64),    # MHA
    (2, 256, 8, 2, 64),    # GQA 4x
    (1, 192, 6, 1, 32),    # MQA, ragged (192 % 128 != 0)
    (2, 128, 4, 2, 128),   # head dim 128
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_op_matches_reference(B, S, H, Kv, D, dtype):
    jx, tt = _inputs(0, B, S, S, H, Kv, D, dtype)
    want = ref_attention_op(*jx, causal=True, interpret=True)
    got = attention_op(*tt, causal=True)
    assert got.dtype == tt[0].dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("window", [32, 96])
def test_attention_op_sliding_window_matches_reference(window):
    jx, tt = _inputs(1, 1, 256, 256, 4, 2, 32, "float32")
    want = ref_attention_op(*jx, causal=True, window=window, interpret=True)
    _assert_close(attention_op(*tt, causal=True, window=window), want,
                  "float32")


def test_attention_op_model_path_shape_matches_reference():
    jx, tt = _inputs(2, 2, 160, 160, 4, 2, 32, "float32")
    want = ref_attention_op(*jx, interpret=True)
    _assert_close(attention_op(*tt), want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noncausal_ragged_keeps_the_reference_padding(dtype):
    """Non-causal with Skv % 128 != 0: the reference pads K/V with zero keys
    that no mask hides, so they enter the softmax with score 0.  The port
    reproduces that result, which differs from unpadded attention."""
    jx, tt = _inputs(3, 1, 200, 200, 4, 2, 32, dtype)
    want = ref_attention_op(*jx, causal=False, interpret=True)
    got = attention_op(*tt, causal=False)
    _assert_close(got, want, dtype)
    unpadded = attention_ref(*tt, causal=False).float()
    assert (got.float() - unpadded).abs().max() > 0.05 * unpadded.abs().max()


def test_attention_op_gradients_match_reference():
    """The backward differentiates the streaming twin in both packages."""
    jx, tt = _inputs(4, 1, 192, 192, 6, 1, 32, "float32")
    g = np.random.default_rng(5).standard_normal(
        (1, 192, 6, 32)).astype(np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(
        ref_attention_op(q, k, v, interpret=True) * g), argnums=(0, 1, 2))(
        *jx)
    tt = [t.requires_grad_() for t in tt]
    got = torch.autograd.grad((attention_op(*tt) * torch.from_numpy(g)).sum(),
                              tt)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_kernel_operands_are_checked():
    q = torch.zeros(1, 8, 4, 64)
    kv = torch.zeros(1, 8, 2, 64)
    fa.check_operands(q, kv, kv, 16)
    with pytest.raises(ValueError, match="head dim"):
        fa.check_operands(torch.zeros(1, 8, 4, 48), torch.zeros(1, 8, 2, 48),
                          torch.zeros(1, 8, 2, 48))
    with pytest.raises(ValueError, match="multiple"):
        fa.check_operands(torch.zeros(1, 8, 3, 64), kv, kv)
    with pytest.raises(ValueError, match="q is"):
        fa.check_operands(q, kv.bfloat16(), kv.bfloat16())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.check_operands(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_operands(q, kv.transpose(1, 2).contiguous().transpose(1, 2),
                          kv)
    with pytest.raises(ValueError, match="window"):
        fa.check_operands(q, kv, kv, 0)
    assert (build.CSRC / "flash_attention.cu").is_file()
