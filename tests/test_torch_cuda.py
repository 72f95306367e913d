"""The port's compiled kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card; the module
imports neither JAX nor the reference, so it runs on a machine that has
only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import compression as comp  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.kernels import diffusion_mix as dm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.kernels.ops import mix_op, ssd_op  # noqa: E402
from repro_torch.kernels.ops import attention_op  # noqa: E402
from repro_torch.kernels.ref import (attention_bf16_backward_ref,  # noqa: E402
                                     attention_bf16p_budget,
                                     attention_bf16p_ref, attention_lse_ref,
                                     attention_ref, mix_ref,
                                     ssd_intra_chunk_ref, ssd_ref)
from repro_torch.models.layers import flash_attention_jnp  # noqa: E402

# the reference's attention gates (tests/test_kernels.py), atol = rtol
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the reference's SSD gates (tests/test_kernels.py), atol = rtol
SSD_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
# the intra-chunk kernel against its plain version: float32 sums of up to
# Q N = 16,384 products per output, the kernel's split into three TF32
# products each (chip_smoke.py states the gate's origin)
INTRA_TOL = 2e-4
# the attention backward kernel against its plain model and against the
# plain float32 backward, relative Frobenius norm of dq, dk and dv
# (tests/test_torch_attention_backward.py states why)
ATTN_BWD_MODEL_TOL = 2.0 ** -8
ATTN_BWD_EXACT_TOL = 2.0 ** -7


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
def test_cuda_mix_op_and_link_dropout_matrices_match_plain(monkeypatch):
    """``mix_op`` on the card, one launch a tile, against the plain version
    on the same tiles, under realized link-dropout matrices drawn from a
    host generator (the same matrices on the card and the CPU)."""
    _need_card()
    from repro_torch.core import mixing

    monkeypatch.setattr(mixing, "TILE_ELEMS", 8 * 1000)
    K = 8
    topo = make_topology("ring", K)
    on_card = graphs.LinkDropout(topo, 0.4, corr=0.5, device="cuda")
    on_cpu = graphs.LinkDropout(topo, 0.4, corr=0.5, device="cpu")
    key_a, key_b = (torch.Generator().manual_seed(3) for _ in range(2))
    masks = torch.Generator().manual_seed(7)
    st_a, st_b = on_card.init_state(key_a), on_cpu.init_state(key_b)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tree = {"a": torch.randn((K, 37, 61), generator=gen, device="cuda"),
            "b": torch.randn((K, 2500), generator=gen,
                             device="cuda").to(torch.bfloat16)}
    for _ in range(4):
        A_t, st_a = on_card.sample(st_a, key_a)
        A_c, st_b = on_cpu.sample(st_b, key_b)
        assert A_t.device.type == "cuda" and torch.equal(A_t.cpu(), A_c)
        m = (torch.rand(K, generator=masks) < 0.7).float().cuda()
        before = dm.diffusion_mix.launches
        got = mix_op(A_t, m, tree)
        torch.cuda.synchronize()
        assert dm.diffusion_mix.launches - before == mixing.num_tiles(
            K, 37 * 61 + 2500)
        for k, x in tree.items():
            want = mix_ref(A_t, m, x.reshape(K, -1).float()).reshape(x.shape)
            assert got[k].dtype == x.dtype
            torch.testing.assert_close(got[k].float(),
                                       want.to(x.dtype).float(), atol=1e-5,
                                       rtol=2 ** -7)
            assert torch.equal(got[k][m == 0], x[m == 0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_attention_ref(dtype):
    """Both routes within the reference's gate of ``attention_ref``; the
    bf16 (tensor-core) route also within :func:`attention_bf16p_budget` of
    its rounding model ``attention_bf16p_ref``: one p_j rounded to the
    neighbouring bf16 value (at most 2^-7 p_j) and one ulp of the final
    rounding, a budget a dropped or doubled key tile breaks
    (``tests/test_torch_attention.py``)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(1, 128, 128, 4, 4, 64, True, None),
             (2, 256, 256, 8, 2, 64, True, None),
             (1, 192, 192, 6, 1, 32, True, None),
             (2, 128, 128, 4, 2, 128, True, None),
             (1, 256, 256, 4, 2, 32, True, 32),
             (1, 300, 300, 4, 2, 128, True, 96),
             (2, 200, 333, 4, 2, 64, False, None),
             # the training path's and zamba2's full-width shapes
             (2, 1024, 1024, 15, 5, 64, True, None),
             (1, 1024, 1024, 32, 32, 64, True, None)]
    # Skv ragged against the 64-key tile, with a window, for every D
    cases += [(1, 333, 333, 3, 1, D, True, 50) for D in (32, 64, 112, 128)]
    # head dim 112 (kimi-k2's; the bf16 route runs its D = 128 layout,
    # TMA filling columns 112..127 with zeros): its
    # full-width layer, a window, non-causal ragged lengths
    cases += [(1, 1024, 1024, 64, 8, 112, True, None),
              (1, 256, 256, 4, 2, 112, True, 96),
              (2, 200, 333, 4, 2, 112, False, None)]
    # llava's full-width layer over its 2,880-token image prefix and 1,024
    # tokens (3,904 queries, ragged against the 128-query tiles) and
    # musicgen's (24 heads of 64, no GQA)
    cases += [(1, 3904, 3904, 32, 8, 128, True, None),
              (1, 1024, 1024, 24, 24, 64, True, None)]
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
        if dtype == torch.bfloat16:
            model = attention_bf16p_ref(q, k, v, causal=causal,
                                        window=window)
            budget = attention_bf16p_budget(q, k, v, model, causal=causal,
                                            window=window)
            over = (out.float() - model.float()).abs() > budget
            assert not bool(over.any()), (B, Sq, Skv, H, Kv, D, window)


def _bwd_inputs(seed, B, S, H, Kv, D):
    """Seeded q, k, v and an output gradient on the card, in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda").bfloat16()
            for s in ((B, S, H, D), (B, S, Kv, D), (B, S, Kv, D),
                      (B, S, H, D))]


def _frobenius_rel(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm()).item()


# (B, S, H, Kv, D, window): mistral-7b's training shape, musicgen's (D =
# 64, no GQA), kimi-k2's head dim 112, a windowed ragged one, and head dim
# 32 ragged under a window
ATTN_BWD_SHAPES = [(1, 4096, 32, 8, 128, None), (1, 1024, 24, 24, 64, None),
                   (1, 1024, 64, 8, 112, None), (2, 1000, 8, 2, 64, 300),
                   (1, 333, 4, 1, 32, 50)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Kv,D,window", ATTN_BWD_SHAPES)
def test_cuda_attention_backward_matches_model_and_plain(B, S, H, Kv, D,
                                                         window):
    """On the kernel forward's own output and log-sum-exp: the backward
    kernel's dq, dk and dv within ATTN_BWD_MODEL_TOL of the plain model,
    and within ATTN_BWD_EXACT_TOL of the plain float32 backward (autograd
    through ``flash_attention_jnp``); the stored log-sum-exp against the
    plain one."""
    _need_card()
    q, k, v, g = _bwd_inputs(6, B, S, H, Kv, D)
    out, lse = fa.flash_attention_lse(q, k, v, window=window)
    torch.cuda.synchronize()
    want_lse = attention_lse_ref(q, k, window=window)
    assert bool(((lse - want_lse).abs()
                 <= 1e-5 * (1 + want_lse.abs())).all())
    before = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(q, k, v, out, g, lse, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_backward.launches == before + 1
    model = attention_bf16_backward_ref(q, k, v, out, g, lse, window=window)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = torch.autograd.grad(
        flash_attention_jnp(*leaves, causal=True, window=window), leaves, g)
    for name, a, m, p in zip(("dq", "dk", "dv"), got, model, plain):
        assert a.shape == m.shape and a.dtype == torch.bfloat16
        assert bool(torch.isfinite(a).all()), name
        assert _frobenius_rel(a, m) <= ATTN_BWD_MODEL_TOL, (
            name, _frobenius_rel(a, m))
        assert _frobenius_rel(a, p) <= ATTN_BWD_EXACT_TOL, (
            name, _frobenius_rel(a, p))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Kv,D,window", [ATTN_BWD_SHAPES[0],
                                               ATTN_BWD_SHAPES[3]])
def test_cuda_attention_backward_is_the_same_bits_every_run(B, S, H, Kv, D,
                                                            window):
    """dq, dk and dv are the same bits on three runs of the same operands
    (dQ is summed in int32 fixed point, so the order in which the key
    tiles' parts arrive does not round it), and with the output gradient's
    rows scaled by 2^0 .. 2^-63 (each row's own fixed-point unit) still
    within ATTN_BWD_MODEL_TOL of the plain model."""
    _need_card()
    q, k, v, g = _bwd_inputs(8, B, S, H, Kv, D)
    out, lse = fa.flash_attention_lse(q, k, v, window=window)
    runs = [fa.flash_attention_backward(q, k, v, out, g, lse, window=window)
            for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert torch.equal(a, b)
    rows = torch.arange(S, device="cuda") % 64
    g = (g.float() * torch.exp2(-rows.float())[None, :, None, None]).bfloat16()
    got = fa.flash_attention_backward(q, k, v, out, g, lse, window=window)
    torch.cuda.synchronize()
    model = attention_bf16_backward_ref(q, k, v, out, g, lse, window=window)
    for name, a, m in zip(("dq", "dk", "dv"), got, model):
        assert _frobenius_rel(a, m) <= ATTN_BWD_MODEL_TOL, (
            name, _frobenius_rel(a, m))
    # dq's rows scaled back, so the small rows count as much as the large
    back = torch.exp2(rows.float())[None, :, None, None]
    assert _frobenius_rel(got[0].float() * back,
                          model[0].float() * back) <= ATTN_BWD_MODEL_TOL


@pytest.mark.cuda
def test_cuda_attention_op_backward_runs_the_kernel_once_per_forward():
    """One training block of smollm-360m's full width (2 layers, K = 2, T
    = 2) through ``train.main`` with the kernels on: the backward kernel
    launches once for each launch of the forward kernel in the block's
    local steps (one a layer, agent and step); the forwards that log each
    agent's loss after the block take no gradient and launch no backward.
    The float32 route keeps the plain backward (no launch)."""
    _need_card()
    from repro_torch.launch import train

    L, K, T = 2, 2, 2
    argv = ["--full", "--agents", str(K), "--local-steps", str(T),
            "--batch", "1", "--seq", "256", "--blocks", "1", "--optimizer",
            "sgd", "--step-size", "0.05"]
    fwd, bwd = fa.flash_attention.launches, fa.flash_attention_backward.launches
    out = train.main(argv, use_kernels=True, num_layers=L,
                     init_on_device=True)
    torch.cuda.synchronize()
    fwd = fa.flash_attention.launches - fwd
    bwd = fa.flash_attention_backward.launches - bwd
    assert bwd == L * K * T
    assert fwd == bwd + L * K * len(out["losses"])
    q, k, v, g = (t.float() for t in _bwd_inputs(7, 1, 128, 4, 2, 64))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    bwd = fa.flash_attention_backward.launches
    torch.autograd.grad(attention_op(*leaves), leaves, g)
    torch.cuda.synchronize()
    assert fa.flash_attention_backward.launches == bwd


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
def test_cuda_moe_smoke_forward_matches_the_cpu(arch):
    """The MoE archs' smoke forward in float32, card (the attention kernel
    on) against the CPU from the same weights: the same routing, the
    logits within ROADMAP's 2e-3 and the load-balance loss within 1e-5."""
    _need_card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map

    cfg = get_config(arch).smoke
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    routes = {}

    def run(device, p, c):
        with torch.no_grad(), moe.Routing() as routing:
            out = tf.forward(p, c, toks.to(device), remat=False)
        routes[device] = [x.cpu() for x in routing.ids]
        return out

    lg_cpu, aux_cpu, _ = run("cpu", params, cfg)
    before = fa.flash_attention.launches
    lg, aux, _ = run("cuda", tree_map(lambda x: x.cuda(), params),
                     dataclasses.replace(cfg, use_kernels=True))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + cfg.num_layers
    for a, b in zip(routes["cuda"], routes["cpu"]):
        assert torch.equal(a, b)
    torch.testing.assert_close(lg.cpu(), lg_cpu, atol=2e-3, rtol=0)
    torch.testing.assert_close(aux.cpu(), aux_cpu, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "musicgen-medium"])
def test_cuda_modality_smoke_matches_the_cpu(arch):
    """llava's image prefix and musicgen's codebooks at smoke size in
    float32, card (the attention kernel on, one launch a layer) against
    the CPU from the same weights and inputs: the logits within ROADMAP's
    2e-3, the loss within 1e-5 relative, ``n_prefix`` equal."""
    _need_card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map

    cfg = get_config(arch).smoke
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    shape = (2, 48) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    batch = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, shape, generator=gen)}
    if cfg.img_tokens:
        batch["img_embeds"] = 0.02 * torch.randn(
            (2, cfg.img_tokens, tf.VISION_DIM), generator=gen)
    with torch.no_grad():
        lg_cpu, _, n_cpu = tf.forward(params, cfg, batch["tokens"],
                                      img_embeds=batch.get("img_embeds"),
                                      remat=False)
        loss_cpu = tf.train_loss(params, cfg, batch, remat=False)
        p, b = (tree_map(lambda x: x.cuda(), t) for t in (params, batch))
        kern = dataclasses.replace(cfg, use_kernels=True)
        before = fa.flash_attention.launches
        lg, _, n = tf.forward(p, kern, b["tokens"],
                              img_embeds=b.get("img_embeds"), remat=False)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == before + cfg.num_layers
        loss = tf.train_loss(p, kern, b, remat=False)
    assert n == n_cpu == cfg.img_tokens
    torch.testing.assert_close(lg.cpu(), lg_cpu, atol=2e-3, rtol=0)
    torch.testing.assert_close(loss.cpu(), loss_cpu, atol=0, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_serveloop_replays_and_matches_the_cpu():
    """The continuous-batching loop on the card at musicgen's smoke size in
    float32: swaps after every tick while 5 requests share 2 slots; every
    completion replays under its generations on the card (alone and at
    the loop's width), and the card's tokens and tags equal the CPU's."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.launch.serving import (Request, ServeLoop,
                                            replay_completion)
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map

    cfg = get_config("musicgen-medium").smoke
    base = tf.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(5)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (7 + 3 * i, 4)
                                    ).astype(np.int32), 6 + i)
            for i in range(5)]
    runs = {}
    for device in ("cpu", "cuda"):
        params = tree_map(lambda x: x.to(device), base)
        loop = ServeLoop(cfg, params, slots=2, max_len=48, chunk=3)
        for r in reqs:
            loop.submit(r)
        by_gen, done = {0: params}, []
        while loop._queue or loop.active:
            done.extend(loop.step())
            g = loop.store.generation + 1
            newp = tree_map(lambda x, s=g: x * (1.0 + 0.03 * s), params)
            by_gen[loop.store.swap(newp)] = newp
        runs[device] = sorted(done, key=lambda c: c.uid)
        if device == "cuda":
            spans = [replay_completion(cfg, by_gen, c, max_len=48)
                     for c in done]
            for c in done:
                replay_completion(cfg, by_gen, c, max_len=48, slots=2)
            assert max(spans) > 1
    for a, b in zip(runs["cuda"], runs["cpu"]):
        assert a.tokens == b.tokens and a.generations == b.generations


@pytest.mark.cuda
def test_cuda_top_k_ties_select_as_on_the_cpu():
    """The tie rule on the card: rows whose k-th value ties (all-equal
    rows, bf16 norm scales, a coarse grid of both signs, repeated
    uniforms, and rows long enough for ``torch.topk``'s multi-block path)
    give the CPU's top-k and rand-k masks and top-k messages."""
    _need_card()
    rng = np.random.default_rng(5)
    rows = [(np.ones((2, 960), np.float32), 96, torch.float32),
            (1.0 + 0.02 * rng.standard_normal((4, 960)), 96, torch.bfloat16),
            (np.round(rng.standard_normal((3, 1001)) * 4) / 4, 300,
             torch.float32),
            (np.repeat(rng.random((4, 128)), 8, axis=1), 102, torch.float32),
            (np.round(rng.standard_normal((2, 4_000_037)) * 64) / 64,
             400_003, torch.float32)]
    for x, k, dtype in rows:
        cpu = torch.from_numpy(np.asarray(x, np.float32)).to(dtype)
        card = cpu.cuda()
        for a, b in ((cpu, card), (cpu.abs().float(), card.abs().float())):
            want = comp._top_k_mask(a.float(), k)
            assert int(want.sum()) == k * a.shape[0]
            assert torch.equal(comp._top_k_mask(b.float(), k).cpu(), want)
        ratio = k / x.shape[1]
        want = comp.TopK(ratio).encode({"s": cpu}, ())[0]["s"]
        got = comp.TopK(ratio).encode({"s": card}, ())[0]["s"]
        assert torch.equal(got.cpu(), want)


def _ssd_inputs(gen, b, s, h, p, n, dtype):
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device="cuda")) * 0.5
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda") * 0.3)
    B = torch.randn((b, s, n), generator=gen, device="cuda").to(dtype)
    C = torch.randn((b, s, n), generator=gen, device="cuda").to(dtype)
    return x, dt, A, B, C


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_intra_chunk_matches_plain(dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (b, s, h, p, n, chunk, A's scale): every chunk and head dim, states
    # from 1 to 128 (8, 13, 33 and 100 are not multiples of the tensor
    # cores' depth), mamba2's and zamba2's path shapes cut in s; head counts
    # (5, 7) that split unevenly over the persistent blocks; and 168 to 640
    # (chunk, head) items, more than the card has SMs, so the blocks' runs
    # cross chunks.  A scale of 400 makes dA so negative that L and the
    # decay underflow to 0.
    cases = [(1, 64, 2, 16, 8, 32, 1), (2, 128, 4, 32, 16, 64, 1),
             (1, 96, 3, 64, 32, 32, 1), (1, 64, 2, 16, 13, 32, 1),
             (1, 256, 4, 64, 128, 128, 1), (2, 256, 3, 64, 64, 128, 1),
             (1, 128, 2, 32, 128, 64, 1), (1, 128, 5, 16, 100, 128, 1),
             (2, 192, 7, 32, 33, 64, 1), (1, 64, 3, 16, 1, 64, 1),
             (3, 512, 7, 64, 33, 64, 1), (1, 1024, 80, 64, 128, 128, 1),
             (2, 256, 5, 32, 100, 32, 1), (1, 256, 3, 16, 64, 128, 400),
             (1, 128, 2, 32, 128, 128, 400)]
    for b, s, h, p, n, chunk, scale in cases:
        x, dt, A, _, _ = _ssd_inputs(gen, b, s, h, p, n, dtype)
        A = A * scale
        # B and C as strided slices of one projection, as in the model
        xBC = torch.randn((b, s, 3 * n + 5), generator=gen,
                          device="cuda").to(dtype)
        B, C = xBC[..., 1:1 + n], xBC[..., 2 * n + 3:3 * n + 3]
        xd = x.float() * dt[..., None]
        dA = dt * A
        before = ssd_scan.ssd_intra_chunk.launches
        outs = ssd_scan.ssd_intra_chunk(xd, dA, B, C, chunk=chunk)
        assert ssd_scan.ssd_intra_chunk.launches == before + 1
        refs = ssd_intra_chunk_ref(xd, dA, B, C, chunk=chunk)
        torch.cuda.synchronize()
        for name, out, ref in zip(("Y_diag", "states", "dA_cumsum"), outs,
                                  refs):
            assert out.dtype == torch.float32 and out.shape == ref.shape
            err = ((out - ref).abs() / ref.abs().clamp(min=1)).max().item()
            assert err <= INTRA_TOL, (b, s, h, p, n, chunk, scale, name,
                                      err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_op_matches_ssd_ref(dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    tol = SSD_TOL[dtype]
    # the reference's sweep (tests/test_kernels.py), s = 100 padded
    for b, s, h, p, n, chunk in ((1, 64, 2, 16, 8, 32),
                                 (2, 128, 4, 32, 16, 64),
                                 (1, 100, 3, 64, 32, 32)):
        x, dt, A, B, C = _ssd_inputs(gen, b, s, h, p, n, dtype)
        y, fin = ssd_op(x, dt, A, B, C, chunk=chunk)
        yr, finr = ssd_ref(x, dt, A, B, C)
        assert y.dtype == dtype and fin.dtype == torch.float32
        torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(fin, finr, atol=tol, rtol=tol)
    # with an initial state (the reference's test: float32, 2e-3)
    x, dt, A, B, C = _ssd_inputs(gen, 1, 64, 2, 16, 8, torch.float32)
    init = torch.randn((1, 2, 16, 8), generator=gen, device="cuda")
    y, fin = ssd_op(x, dt, A, B, C, chunk=32, initial_state=init)
    yr, finr = ssd_ref(x, dt, A, B, C, initial_state=init)
    torch.testing.assert_close(y, yr, atol=2e-3, rtol=0)
    torch.testing.assert_close(fin, finr, atol=2e-3, rtol=0)


@pytest.mark.cuda
def test_cuda_ssd_intra_chunk_rejects_what_it_does_not_take():
    _need_card()
    xd = torch.zeros((1, 64, 2, 48), device="cuda")
    dA = torch.zeros((1, 64, 2), device="cuda")
    B = C = torch.zeros((1, 64, 8), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        ssd_scan.ssd_intra_chunk(xd, dA, B, C, chunk=32)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan.ssd_intra_chunk(xd[..., :16], dA, B, C, chunk=16)


def _gather_cases():
    """(label, topology, realized A, mask) cases of the two gather kernels:
    ring, ring hops = 2, grid and FedAvg (D = 3, 5, 5, K), all-active,
    all-inactive and random masks; K = 1024 ring and grid (the group route
    with more staged rows than targets); FedAvg at K = 20, whose D = 20
    rows no group stages (the one-target route); and a FedAvg draw in which
    some targets share a member set and others do not."""
    import numpy as np

    from repro_torch.core.topology import metropolis_weights

    rng = np.random.default_rng(0)
    for kind, K, kw in (("ring", 12, {}), ("ring", 16, {"hops": 2}),
                        ("grid", 12, {}), ("fedavg", 8, {}),
                        ("fedavg", 12, {}), ("ring", 1024, {}),
                        ("grid", 1024, {}), ("fedavg", 20, {})):
        topo = make_topology(kind, K, **kw)
        for mname, mask in (("ones", np.ones(K)), ("zeros", np.zeros(K)),
                            ("random", (rng.random(K) < 0.6) * 1.0)):
            yield f"{kind}{kw} K={K} {mname}", topo, topo.A, mask
    topo = make_topology("fedavg", 8)
    adj = np.eye(8, dtype=bool)
    adj[:4, :4] = adj[4:6, 4:6] = True       # sets {0..3}, {4, 5}, {6}, {7}
    yield ("fedavg K=8 cliques", topo, metropolis_weights(adj),
           np.array([1.0] * 7 + [0.0]))


#: column counts: M = 1, and M = 1 (mod 4) to 3 (mod 4), so that the rows
#: of a (K, M) buffer start at every phase of a 16-byte word
_GATHER_M = (1, 1001, 1002, 1003, 65_537)


def _rel(out, ref):
    return ((out - ref).abs() / ref.abs().clamp(min=1)).max().item()


@pytest.mark.cuda
def test_cuda_gather_mix_matches_plain():
    _need_card()
    from repro_torch.core.mixing import _gather_weights
    from repro_torch.core.participation import masked_combination
    from repro_torch.kernels import gather_mix as gm
    from repro_torch.kernels.ref import gather_mix_ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    routes = set()
    for label, topo, A_np, mask in _gather_cases():
        idx, valid = (torch.as_tensor(t, device="cuda")
                      for t in topo.neighbor_table())
        A = torch.as_tensor(A_np, dtype=torch.float32, device="cuda")
        m = torch.as_tensor(mask, dtype=torch.float32, device="cuda")
        gw = _gather_weights(masked_combination(A, m), idx, valid)
        plan = gm.stage_plan(idx)
        routes.add(plan.route)
        for M in _GATHER_M:
            W = torch.randn((topo.num_agents, M), generator=gen,
                            device="cuda")
            before = gm.gather_mix.launches
            out = gm.gather_mix(idx, gw, W, plan)
            torch.cuda.synchronize()
            assert gm.gather_mix.launches == before + 1
            assert _rel(out, gather_mix_ref(idx, gw, W)) <= 1e-5, (label, M)
            dead = m == 0
            assert torch.equal(out[dead], W[dead]), label
    assert routes == {"group", "target"}


@pytest.mark.cuda
@pytest.mark.parametrize("robust", ["trimmed_mean", "median"])
def test_cuda_gather_robust_mix_matches_plain(robust):
    _need_card()
    from repro_torch.core.mixing import make_mixer
    from repro_torch.kernels import gather_mix as gm
    from repro_torch.kernels import gather_robust_mix as grm
    from repro_torch.kernels.ref import gather_robust_mix_ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    routes, shared = set(), False
    for label, topo, A_np, mask in _gather_cases():
        mixer = make_mixer(robust, topo, trim=1, scope="neighborhood",
                           gather="table", device="cuda")
        A = torch.as_tensor(A_np, dtype=torch.float32, device="cuda")
        m = torch.as_tensor(mask, dtype=torch.float32, device="cuda")
        idx, member, S = mixer._gather_members(m, A)
        wslot = mixer._slot_weights(S, idx.shape[1])
        plan = grm.share_sorts(gm.stage_plan(idx), idx, member, wslot, m)
        routes.add(plan.route)
        if plan.route == "group":
            leaders = int(((plan.order & grm.LEADER) != 0).sum())
            shared |= 0 < leaders < int((m > 0).sum())
        for M in _GATHER_M:
            W = torch.randn((topo.num_agents, M), generator=gen,
                            device="cuda")
            before = grm.gather_robust_mix.launches
            out = grm.gather_robust_mix(idx, member, wslot, m, W, plan)
            torch.cuda.synchronize()
            assert grm.gather_robust_mix.launches == before + 1
            ref = gather_robust_mix_ref(idx, member, wslot, m, W)
            assert _rel(out, ref) <= 1e-5, (label, M)
            dead = m == 0
            assert torch.equal(out[dead], W[dead]), label
    assert routes == {"group", "target"} and shared


@pytest.mark.cuda
def test_cuda_gather_kernels_reject_what_they_do_not_take():
    _need_card()
    from repro_torch.kernels import gather_mix as gm
    from repro_torch.kernels import gather_robust_mix as grm

    K, D = 40, 33                        # one slot past the sort network
    idx = torch.zeros((K, D), dtype=torch.int32, device="cuda")
    rows = torch.zeros((K, D), device="cuda")
    W = torch.zeros((K, 7), device="cuda")
    with pytest.raises(ValueError, match="sort network"):
        grm.gather_robust_mix(idx, rows, rows, torch.ones(K), W)
    with pytest.raises(ValueError, match="float32"):
        gm.gather_mix(idx, rows, W.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        gm.gather_mix(idx, rows, torch.zeros((7, K), device="cuda").T)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pallas", "gather", "trimmed_mean"])
def test_cuda_tiled_mixers_match_their_plain_paths(monkeypatch, name):
    """The three kernel mixers over a tiled flatten whose tiles split
    leaves: one launch per tile, and the result of the plain path on the
    card (inactive agents bit-equal)."""
    _need_card()
    from repro_torch.core import mixing
    from repro_torch.kernels import diffusion_mix as dm
    from repro_torch.kernels import gather_mix as gm
    from repro_torch.kernels import gather_robust_mix as grm

    monkeypatch.setattr(mixing, "TILE_ELEMS", 12 * 1000)
    K = 12
    topo = make_topology("ring", K)
    gen = torch.Generator(device="cuda").manual_seed(4)
    tree = {"a": torch.randn((K, 37, 61), generator=gen, device="cuda"),
            "b": torch.randn((K, 2500), generator=gen,
                             device="cuda").to(torch.bfloat16)}
    m = torch.tensor([1.0, 0.0] * 6, device="cuda")
    A = torch.as_tensor(topo.A, dtype=torch.float32, device="cuda")
    kw = dict(trim=1, scope="neighborhood") if name == "trimmed_mean" else {}
    fused = mixing.make_mixer(name, topo, device="cuda", **kw)
    plain = (mixing.DenseMixer() if name != "trimmed_mean" else
             mixing.make_mixer(name, topo, gather="table", device="cuda",
                               **kw))
    counter = {"pallas": dm.diffusion_mix, "gather": gm.gather_mix,
               "trimmed_mean": grm.gather_robust_mix}[name]
    before = counter.launches
    got = fused(tree, m, A)
    want = plain({k: v.float() for k, v in tree.items()}, m, A)
    assert counter.launches - before == mixing.num_tiles(K, 37 * 61 + 2500)
    # the kernels are column-wise: another tile width, the same bits
    monkeypatch.setattr(mixing, "TILE_ELEMS", 12 * 777)
    again = fused(tree, m, A)
    for k in tree:
        assert torch.equal(again[k], got[k])
    for k in tree:
        assert got[k].dtype == tree[k].dtype
        torch.testing.assert_close(got[k].float(), want[k].to(
            tree[k].dtype).float(), atol=1e-5, rtol=2 ** -7)
        assert torch.equal(got[k][m == 0], tree[k][m == 0])


def _int8_operands(gen, K, M, tile_m):
    """The operands the fused path hands the kernel: a (K, M) standard
    normal stack quantized per (agent, tile) by the path's quantizer, with
    agent 0's first tile all zero (scale 1.0) and the last 77 columns zero,
    as padding leaves them; every other tile's largest value lands on
    +-127.  Returns (int8 Wq, float32 scales (K, M / tile_m))."""
    import torch

    from repro_torch.core.compression import quantize_int8

    x = torch.randn((K, M // tile_m, tile_m), generator=gen, device="cuda")
    x[0, 0] = 0.0
    x.view(K, M)[:, M - 77:] = 0.0
    u = torch.rand(x.shape, generator=gen, device="cuda")
    q, scale = quantize_int8(x, axis=2, u=u)
    del x, u
    return q.to(torch.int8).view(K, M), scale[:, :, 0].contiguous()


def _uniform_int8_operands(gen, K, M, tile_m):
    """Int8 values uniform in [-127, 127] times scales uniform in (0, 1]
    (terms up to 127), with agent 0's first tile all zero (scale 1.0)."""
    Wq = torch.randint(-127, 128, (K, M), generator=gen, device="cuda",
                       dtype=torch.int8)
    scales = 1.0 - torch.rand((K, M // tile_m), generator=gen, device="cuda")
    Wq[0, :tile_m] = 0
    scales[0, 0] = 1.0
    return Wq, scales


@pytest.mark.cuda
def test_cuda_int8_kernel_matches_mix_int8_ref():
    """Kernel 5 against its plain version: K on each side of the routes'
    edges (rows up to 16, passes past it) up to the shared-memory limit,
    both tiles at an odd count of tiles, both outputs, all-zero, all-one
    and random masks.  On the quantizer's operands, within 1e-5 relative
    to max(1, |plain|); on uniform int8 times uniform scales (terms up to
    127), within the float32 summation bound of the float64 value
    (mix_int8_exact), elementwise; an inactive agent's delta row exactly
    zero.  A Wq at a storage offset that breaks its alignment takes the
    scalar route and gives the aligned Wq's result bit for bit."""
    _need_card()
    from repro_torch.kernels import diffusion_mix_int8 as dmi
    from repro_torch.kernels.ref import mix_int8_exact, mix_int8_ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    routes = set()
    for K in (1, 2, 3, 4, 5, 8, 9, 12, 16, 17, 64, 240):
        A = torch.as_tensor(make_topology("erdos", K, seed=K).A,
                            dtype=torch.float32, device="cuda")
        for tile_m in (128, 512):
            M = tile_m * 7
            for make in (_int8_operands, _uniform_int8_operands):
                Wq, scales = make(gen, K, M, tile_m)
                for m in (torch.zeros(K), torch.ones(K),
                          (torch.rand(K) < 0.6).float()):
                    m = m.cuda()
                    for sub in (False, True):
                        before = dmi.diffusion_mix_int8.launches
                        out = dmi.diffusion_mix_int8(A, m, Wq, scales,
                                                     tile_m=tile_m,
                                                     subtract_identity=sub)
                        torch.cuda.synchronize()
                        assert dmi.diffusion_mix_int8.launches == before + 1
                        case = (K, tile_m, make.__name__, sub)
                        if make is _int8_operands:
                            ref = mix_int8_ref(A, m, Wq, scales,
                                               tile_m=tile_m,
                                               subtract_identity=sub)
                            assert _rel(out, ref) <= 1e-5, case
                        else:
                            exact, bound = mix_int8_exact(
                                A, m, Wq, scales, tile_m=tile_m,
                                subtract_identity=sub)
                            assert bool(((out.double() - exact).abs()
                                         <= bound).all()), case
                        if sub:
                            assert not out[m == 0].any()
                routes.add(dmi.route(Wq, tile_m))
    for K in (8, 20):
        A = torch.as_tensor(make_topology("erdos", K, seed=K).A,
                            dtype=torch.float32, device="cuda")
        m = torch.ones(K, device="cuda")
        m[1] = 0.0
        Wq, scales = _int8_operands(gen, K, 512 * 7, 512)
        want = dmi.diffusion_mix_int8(A, m, Wq, scales, tile_m=512,
                                      subtract_identity=True)
        ref = mix_int8_ref(A, m, Wq, scales, tile_m=512,
                           subtract_identity=True)
        for off in (1, 2, 3, 8):
            buf = torch.zeros(Wq.numel() + 16, dtype=torch.int8,
                              device="cuda")
            Wm = buf[off:off + Wq.numel()].view(Wq.shape)
            Wm.copy_(Wq)
            got = dmi.diffusion_mix_int8(A, m, Wm, scales, tile_m=512,
                                         subtract_identity=True)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (K, off)
            assert _rel(got, ref) <= 1e-5, (K, off)
            routes.add(dmi.route(Wm, 512))
    assert routes == set(dmi.ROUTES), routes
    with pytest.raises(ValueError, match="int8"):
        dmi.diffusion_mix_int8(A, m, Wq.float(), scales, tile_m=512)
    with pytest.raises(ValueError, match="divisible"):
        dmi.diffusion_mix_int8(A, m, Wq[:, :100].contiguous(), scales,
                               tile_m=512)


@pytest.mark.cuda
def test_cuda_fused_int8_pipeline_matches_cpu(monkeypatch):
    """The compressed_fedavg pipeline (FedAvg, int8 + error feedback,
    fused mixer) on the card and on the CPU with the same injected
    uniforms, over column tiles that split leaves: parameters within float32 summation order (1e-5) or one
    bf16 rounding of it; one launch per column tile.  The first round's
    residual is bit-equal (the same quantizer on the same inputs)."""
    _need_card()
    from repro_torch.core import compression, mixing
    from repro_torch.kernels import diffusion_mix_int8 as dmi

    monkeypatch.setattr(mixing, "TILE_ELEMS", 8 * 1024)
    K = 8
    topo = make_topology("fedavg", K)
    gen = torch.Generator().manual_seed(6)
    tree = {"a": torch.randn((K, 37, 61), generator=gen),
            "b": torch.randn((K, 2500), generator=gen).to(torch.bfloat16)}
    M = 37 * 61 + 2500
    pipe = mixing.make_pipeline("pallas", topo, compress="int8",
                                error_feedback=True, device="cuda")
    _, width, _ = mixing.int8_layout(K, M)
    m = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 1.0, 1.0])
    A = torch.as_tensor(topo.A, dtype=torch.float32)
    outs, first = {}, {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in tree.items()}
        state = pipe.init_state(p)
        before = dmi.diffusion_mix_int8.launches
        for rnd in range(2):
            u = torch.rand((K, width), generator=torch.Generator()
                           .manual_seed(rnd))
            p, state = pipe(p, m.to(dev), A.to(dev), state,
                            compression.Draws(u=u))
            if rnd == 0:
                first[dev] = {k: v.cpu() for k, v in state.items()}
        if dev == "cuda":
            assert (dmi.diffusion_mix_int8.launches - before
                    == 2 * mixing.num_tiles(K, M, int8=True))
        outs[dev] = (p, state)
    for k in tree:
        # the first round quantizes the same inputs: the same residual
        assert torch.equal(first["cuda"][k], first["cpu"][k])
        got, want = outs["cuda"][0][k].cpu(), outs["cpu"][0][k]
        assert got.dtype == tree[k].dtype
        torch.testing.assert_close(got.float(), want.float(), atol=1e-5,
                                   rtol=2 ** -7)
        assert torch.equal(got[m == 0], tree[k][m == 0])
        assert torch.equal(outs["cuda"][1][k].cpu()[m == 0],
                           torch.zeros_like(tree[k][m == 0]))


@pytest.mark.cuda
def test_cuda_secure_agg_and_clip_match_the_cpu(monkeypatch):
    """The privacy tier on the card: the masked combination (several mask
    tiles) within 5e-5 of the kernel mixer, inactive rows bit-equal; the
    clip at noise 0 equal to the CPU's within float32 rounding; the noise
    drawn on the card's own generator; partitioned blocks bit-equal."""
    _need_card()
    from repro_torch.core import privacy as priv
    from repro_torch.configs import get_config
    from repro_torch.core.mixing import make_mixer
    from repro_torch.data.pipeline import make_block_provider

    monkeypatch.setattr(priv, "MASK_TILE_ELEMS", 64 * 1000)
    K = 8
    topo = make_topology("ring", K)
    A = torch.as_tensor(topo.A, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    X = {"a": torch.randn((K, 3001), generator=gen, device="cuda"),
         "b": torch.randn((K, 7, 11), generator=gen, device="cuda")}
    active = torch.tensor([1.0, 1, 0, 1, 1, 1, 0, 1], device="cuda")
    before = dm.diffusion_mix.launches
    got = priv.make_secure_agg(K, seed=2)(X, active, A, 5)
    assert dm.diffusion_mix.launches == before
    want = make_mixer("pallas", topo, device="cuda")(X, active, A)
    for name in X:
        assert (got[name] - want[name]).abs().max().item() <= 5e-5
        dead = active == 0
        assert torch.equal(got[name][dead], X[name][dead])
    g = {"w": 3.0 * torch.randn((K, 5000), generator=gen, device="cuda")}
    on_card = priv.clip_and_noise(g, None, clip=1.0, noise_multiplier=0.0)
    on_cpu = priv.clip_and_noise({"w": g["w"].cpu()}, None, clip=1.0,
                                 noise_multiplier=0.0)
    torch.testing.assert_close(on_card["w"].cpu(), on_cpu["w"], atol=1e-6,
                               rtol=1e-6)
    noised = priv.clip_and_noise(g, priv.noise_generator(0, 0, "cuda"),
                                 clip=1.0, noise_multiplier=1.0)
    assert noised["w"].device.type == "cuda"
    assert abs((noised["w"] - on_card["w"]).std().item() - 1.0) < 0.05
    cfg = get_config("smollm-360m").smoke
    for kind, kw in (("dirichlet", {"alpha": 0.3}),
                     ("shards", {"shards_per_agent": 2})):
        pv = [make_block_provider(kind, cfg, num_agents=K, local_steps=2,
                                  batch=1, seq=64, device=d, **kw)
              for d in ("cuda", "cpu")]
        a, b = pv[0](3, None), pv[1](3, None)
        assert a["tokens"].is_cuda
        assert all(torch.equal(a[n].cpu(), b[n]) for n in a)


_ASYNC_ARGV = ["--agents", "4", "--blocks", "2", "--batch", "1", "--seq",
               "32", "--optimizer", "sgd", "--step-size", "0.05",
               "--engine", "async", "--async-rate-dist", "lognormal",
               "--async-rate-sigma", "0.5", "--async-tau-max", "4",
               "--mix", "auto"]


@pytest.mark.cuda
def test_cuda_async_training_matches_the_cpu():
    """The event-driven engine at smoke size through train.main on the card
    (flash_attention in the local updates) and on the CPU from one seed:
    the same fire masks, losses within 1e-4 relative, parameters and the
    staleness buffer within 1e-4 (phase 6's SGD gates)."""
    _need_card()
    from repro_torch.launch import train

    before = fa.flash_attention.launches
    gpu = train.main(_ASYNC_ARGV, use_kernels=True)
    assert fa.flash_attention.launches > before
    cpu = train.main(_ASYNC_ARGV + ["--device", "cpu"], use_kernels=True)
    assert gpu["active"] == cpu["active"]
    rel = np.max(np.abs(np.subtract(gpu["losses"], cpu["losses"]))
                 / np.abs(cpu["losses"]))
    assert rel <= 1e-4
    for tree in ("params", "buffer"):
        a = (gpu["state"].params if tree == "params"
             else gpu["state"].async_state["buffer"])
        b = (cpu["state"].params if tree == "params"
             else cpu["state"].async_state["buffer"])
        for x, y in zip(_leaves(a), _leaves(b)):
            assert (x.cpu().float() - y.float()).abs().max().item() <= 1e-4
    assert torch.equal(gpu["state"].async_state["ages"].cpu(),
                       cpu["state"].async_state["ages"])


@pytest.mark.cuda
def test_cuda_spec_checkpoint_serves_on_the_cpu(tmp_path):
    """A spec checkpoint of an async run saved on the card serves on the
    CPU with no other spec flag: the freshness-weighted consensus of the
    stored stack, equal to the card's within 1e-5, and greedy tokens that
    repeat."""
    _need_card()
    from repro_torch.launch import serve, train

    path = str(tmp_path / "async.npz")
    out = train.main(_ASYNC_ARGV + ["--checkpoint", path], use_kernels=True)
    argv = ["--checkpoint", path, "--batch", "2", "--prompt-len", "8",
            "--decode", "4", "--temperature", "0"]
    on_cpu = serve.main(argv + ["--device", "cpu"])
    on_card = serve.main(argv)
    state = out["state"]
    w = on_cpu["weights"].double()
    w = w / w.sum()
    for got, x in zip(_leaves(on_cpu["params"]), _leaves(state.params)):
        want = torch.tensordot(w, x.cpu().double(), dims=1)
        assert (got.double() - want).abs().max().item() <= 1e-5 * (
            1 + want.abs().max().item())
    for a, b in zip(_leaves(on_card["params"]), _leaves(on_cpu["params"])):
        assert (a.cpu().float() - b.float()).abs().max().item() <= 1e-5
    assert torch.equal(serve.main(argv + ["--device", "cpu"])["tokens"],
                       on_cpu["tokens"])
    toks = on_card["tokens"]
    assert int(toks.min()) >= 0 and int(toks.max()) < out["cfg"].vocab_size


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


@pytest.mark.cuda
def test_cuda_checkpoint_streams_through_the_staging_buffers(tmp_path):
    """A tree on the card saved and loaded through the pinned staging
    buffers (one leaf of 80 MiB: two pieces of 64 MiB and 16 MiB each
    way) equals a save of its host copy byte for byte, and loads back
    bit-equal on the card and on the CPU."""
    _need_card()
    import zipfile

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    g = torch.Generator(device="cuda").manual_seed(5)
    tree = {"big": torch.randn(40 << 20, generator=g, device="cuda").to(
                torch.bfloat16),
            "f32": torch.randn(3, 7, generator=g, device="cuda"),
            "mask": torch.rand(9, generator=g, device="cuda") > 0.5,
            "step": torch.tensor(4, dtype=torch.int32, device="cuda"),
            "empty": torch.zeros((0, 3), device="cuda")}
    card, host = str(tmp_path / "card.npz"), str(tmp_path / "host.npz")
    save_checkpoint(card, tree, step=1)
    save_checkpoint(host, {k: v.cpu() for k, v in tree.items()}, step=1)
    with zipfile.ZipFile(card) as a, zipfile.ZipFile(host) as b:
        assert sorted(a.namelist()) == sorted(b.namelist())
        for name in a.namelist():
            assert a.read(name) == b.read(name)
    for device in ("cuda", "cpu"):
        got, meta = load_checkpoint(card, tree, device=device)
        assert meta["step"] == 1 and meta["dtypes"] == {"big": "bfloat16"}
        for k, v in tree.items():
            assert got[k].device.type == device and got[k].dtype == v.dtype
            assert torch.equal(got[k].cpu(), v.cpu())


@pytest.mark.cuda
def test_cuda_ef_host_offload_parks_pinned_and_fetches_bit_equal():
    """The EF host offload on the card: the offloaded leaves are pinned
    CPU tensors, fetch brings them back bit-equal, and a compressed_fedavg
    run (int8 + EF, the fused path) with the offload equals the run
    without it bit for bit."""
    _need_card()
    from repro_torch.core.sharded import (ef_host_sharding,
                                          fetch_comm_state,
                                          offload_comm_state)
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    assert ef_host_sharding() == torch.device("cpu")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = {"e": torch.randn((4, 1000), generator=gen, device="cuda")
            .to(torch.bfloat16), "f": torch.randn((4, 3, 5), generator=gen,
                                                  device="cuda")}
    host = offload_comm_state(tree)
    for leaf in tree_leaves(host):
        assert leaf.device.type == "cpu" and leaf.is_pinned()
    back = fetch_comm_state(host)
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
    argv = ["--agents", "4", "--blocks", "3", "--batch", "1", "--seq", "16",
            "--optimizer", "sgd", "--step-size", "0.05", "--topology",
            "fedavg", "--mix", "pallas", "--compress", "int8",
            "--error-feedback", "--engine", "sharded"]
    seen = []

    def on_block(i, before, after, metrics):
        seen.append([leaf.is_pinned() for leaf in
                     tree_leaves(after.comm_state)])

    off = train.main(argv)
    on = train.main(argv + ["--ef-host-offload"], on_block=on_block)
    assert seen and all(all(s) for s in seen)
    for a, b in zip(tree_leaves(off["state"].params),
                    tree_leaves(on["state"].params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(off["state"].comm_state),
                    tree_leaves(on["state"].comm_state)):
        assert torch.equal(a, b.cuda())


@pytest.mark.cuda
def test_cuda_checkpoint_load_checks_the_crc(tmp_path):
    """The card's staged load: a file whose largest member spans four 64
    MiB pieces (the two pinned buffers take turns) loads bit-equal, and a
    flipped byte in that member's last piece or in a .npy header raises
    BadZipFile."""
    _need_card()
    import zipfile

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = {"big": torch.randn((50 << 20,), generator=gen, device="cuda"),
            "bf16": torch.randn((3, 1000), generator=gen,
                                device="cuda").to(torch.bfloat16),
            "host": torch.arange(10)}
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, tree)
    got, _ = load_checkpoint(path, tree, device="cuda")
    for k, v in tree.items():
        assert got[k].is_cuda and torch.equal(got[k].cpu(), v.cpu()), k
    with zipfile.ZipFile(path) as z:
        info = z.getinfo("big.npy")
    raw = bytearray(open(path, "rb").read())
    name_len, extra_len = np.frombuffer(
        bytes(raw[info.header_offset + 26:info.header_offset + 30]), "<u2")
    start = info.header_offset + 30 + int(name_len) + int(extra_len)
    for at in (start + info.file_size - 8, start + 20):
        bad = bytearray(raw)
        bad[at] ^= 0x10
        with open(tmp_path / "bad.npz", "wb") as f:
            f.write(bad)
        with pytest.raises(zipfile.BadZipFile, match="'big.npy'"):
            load_checkpoint(str(tmp_path / "bad.npz"), tree, device="cuda")


@pytest.mark.cuda
def test_cuda_serve_lm_example_matches_the_cpu():
    """``repro_torch.examples.serve_lm`` on the card against the CPU: the
    weights and prompts come from one host generator, so each smoke arch's
    prefill logits agree within 1e-4 and its 16 greedy tokens are equal,
    the cache at position 64 on both."""
    _need_card()
    import contextlib
    import io

    from repro_torch.examples import serve_lm

    with contextlib.redirect_stdout(io.StringIO()):
        for arch in serve_lm.ARCHS:
            card = serve_lm.serve(arch)
            cpu = serve_lm.serve(arch, device="cpu")
            assert card["prefill_logits"].is_cuda
            torch.testing.assert_close(card["prefill_logits"].cpu(),
                                       cpu["prefill_logits"], atol=1e-4,
                                       rtol=0)
            assert torch.equal(card["tokens"], cpu["tokens"]), arch
            assert card["cache_pos"] == cpu["cache_pos"] == 64
