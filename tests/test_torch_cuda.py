"""The port's compiled kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card; the module
imports neither JAX nor the reference, so it runs on a machine that has
only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.kernels import diffusion_mix as dm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import attention_ref, mix_ref  # noqa: E402

# the reference's attention gates (tests/test_kernels.py), atol = rtol
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the compiled kernels run only there")


@pytest.mark.cuda
def test_cuda_kernel_matches_mix_ref():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for K in (4, 8, 12, 20, 64):
        for M in (1, 1001, 65_537):
            A = torch.as_tensor(make_topology("erdos", K).A,
                                dtype=torch.float32, device="cuda")
            for m in (torch.zeros(K), torch.ones(K),
                      (torch.rand(K) < 0.6).float()):
                W = torch.randn((K, M), generator=gen, device="cuda")
                before = dm.diffusion_mix.launches
                out = dm.diffusion_mix(A, m.cuda(), W)
                ref = mix_ref(A, m.cuda(), W)
                torch.cuda.synchronize()
                assert dm.diffusion_mix.launches == before + 1
                err = ((out - ref).abs() / ref.abs().clamp(min=1)).max()
                assert err.item() <= 1e-5, (K, M, err.item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_attention_ref(dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(1, 128, 128, 4, 4, 64, True, None),
             (2, 256, 256, 8, 2, 64, True, None),
             (1, 192, 192, 6, 1, 32, True, None),
             (2, 128, 128, 4, 2, 128, True, None),
             (1, 256, 256, 4, 2, 32, True, 32),
             (1, 300, 300, 4, 2, 128, True, 96),
             (2, 200, 333, 4, 2, 64, False, None)]
    tol = ATTN_TOL[dtype]
    for B, Sq, Skv, H, Kv, D, causal, window in cases:
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                   for s in ((B, Sq, H, D), (B, Skv, Kv, D),
                             (B, Skv, Kv, D)))
        before = fa.flash_attention.launches
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        assert fa.flash_attention.launches == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        ref = attention_ref(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
