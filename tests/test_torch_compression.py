"""Port parity: compressed combination and the fused int8 mix kernel.

The compressors, the int8 kernel's plain version, the fused mixer's int8
path, CommPipeline's exchange modes, the engine's compressed block step and
int8 consensus extraction of ``repro_torch`` against ``repro``, on the same
seeded inputs.  torch cannot replay JAX's threefry streams, so every
random draw the reference realizes (rounding uniforms, rand-k subsets,
Gaussian noise) is recomputed here from the reference's keys and handed to
the port through ``Draws``."""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import compression as ref_comp  # noqa: E402
from repro.core import diffusion as ref_diff  # noqa: E402
from repro.core import mixing as ref_mixing  # noqa: E402
from repro.core.serving import consensus_from_stacked as ref_consensus  # noqa: E402
from repro.core.topology import make_topology as ref_make_topology  # noqa: E402
from repro.kernels.diffusion_mix import diffusion_mix_int8 as ref_mix_int8  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import compression as comp  # noqa: E402
from repro_torch.core import diffusion as diff  # noqa: E402
from repro_torch.core import mixing  # noqa: E402
from repro_torch.core.participation import masked_combination  # noqa: E402
from repro_torch.core.serving import consensus_from_stacked  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.kernels import diffusion_mix_int8 as dmi  # noqa: E402
from repro_torch.kernels.ref import mix_int8_exact, mix_int8_ref  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_jax, to_numpy  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

KEY = jax.random.PRNGKey(0)


def _to_torch(tree):
    return params_from_jax(jax.device_get(tree), device="cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    """A port leaf as float32 numpy (bfloat16 widened exactly)."""
    return t.detach().float().numpy()


def _ref_np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _rand_tree(key, K, bf16=False):
    """The reference tests' tree; ``bf16`` makes leaf "b" bfloat16."""
    ks = jax.random.split(key, 3)
    b = jax.random.normal(ks[1], (K, 5))
    return {"w": jax.random.normal(ks[0], (K, 7, 3)),
            "b": b.astype(jnp.bfloat16) if bf16 else b,
            "s": jax.random.normal(ks[2], (K, 2, 2, 2))}


def _leaf_draws(key, tree, noise=False) -> comp.Draws:
    """The reference's per-leaf draws for ``key``: leaf i's uniforms (and,
    with ``noise``, its Gaussian noise) from ``split(key, leaves)[i]``."""
    leaves = jax.tree.leaves(tree)
    keys = list(jax.random.split(key, len(leaves)))
    shapes = [(l.shape[0], int(np.prod(l.shape[1:]))) for l in leaves]
    u = [torch.from_numpy(np.array(jax.random.uniform(k, s)))
         for k, s in zip(keys, shapes)]
    nz = ([torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(k, 1), s, jnp.float32)))
           for k, s in zip(keys, shapes)] if noise else None)
    return comp.Draws(u=u, noise=nz)


def _flat_draws(key, K, M) -> comp.Draws:
    """The reference's fused int8 draw: (K, tiles, tile) uniforms over the
    padded layout, flattened to (K, M_padded)."""
    tile, width, _ = mixing.int8_layout(K, M)
    nm = width // tile
    u = np.array(jax.random.uniform(key, (K, nm, tile)))
    return comp.Draws(u=torch.from_numpy(u.reshape(K, nm * tile)))


def _assert_bit_equal(got, want):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name
        np.testing.assert_array_equal(_np(g), _ref_np(w))


# ---------------------------------------------------------------------------
# the quantizer and the compressors: bit-equal under injected draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((6, 300), 1), ((4, 3, 128), 2),
                                        ((5, 1000), -1)])
def test_quantize_int8_bit_equal_with_reference_draws(shape, axis):
    rng = np.random.default_rng(len(shape) + axis)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    x[0] = 0.0                                  # an all-zero row: scale 1
    x[1].flat[:2] = (-50.0, 50.0)               # values at +-127 steps
    key = jax.random.PRNGKey(7)
    q_ref, s_ref = ref_comp.quantize_int8(jnp.asarray(x), key, axis=axis)
    u = torch.from_numpy(np.array(jax.random.uniform(key, shape)))
    q, s = comp.quantize_int8(torch.from_numpy(x), axis=axis, u=u)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert (s.numpy().reshape(-1)[:1] == 1.0).all()
    # from a generator: integral, in range, within one step of x
    q, s = comp.quantize_int8(torch.from_numpy(x),
                              torch.Generator().manual_seed(0), axis=axis)
    assert (q == q.floor()).all() and q.abs().max() <= 127
    assert ((q * s - torch.from_numpy(x)).abs() <= s * (1 + 1e-6)).all()
    with pytest.raises(ValueError, match="Generator"):
        comp.quantize_int8(torch.from_numpy(x), axis=axis)


@pytest.mark.parametrize("bf16", [False, True])
def test_int8_stochastic_bit_equal(bf16):
    tree = _rand_tree(KEY, 6, bf16=bf16)
    key = jax.random.PRNGKey(3)
    c = comp.Int8Stochastic()
    draws = _leaf_draws(key, tree)
    q_ref, s_ref = ref_comp.Int8Stochastic().encode_quantized(tree, key)
    q, s = c.encode_quantized(_to_torch(tree), draws)
    for a, b in zip(tree_leaves(q), jax.tree.leaves(q_ref)):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _assert_bit_equal(s, s_ref)
    msgs_ref, _ = ref_comp.Int8Stochastic().encode(tree, (), key)
    _assert_bit_equal(c.dequantize(q, s, _to_torch(tree)), msgs_ref)
    msgs, st = c.encode(_to_torch(tree), (), draws)
    _assert_bit_equal(msgs, msgs_ref)
    assert st == ()


@pytest.mark.parametrize("ratio", [0.1, 0.3, 1.0])
def test_topk_bit_equal(ratio):
    """Continuous float32 data: no magnitude ties at the threshold."""
    tree = _rand_tree(jax.random.PRNGKey(11), 8)
    want, _ = ref_comp.TopK(ratio).encode(tree, ())
    got, _ = comp.TopK(ratio).encode(_to_torch(tree), ())
    _assert_bit_equal(got, want)


def _tie_rows(case):
    """Rows (numpy, and the dtype to cast to) whose k-th value ties, and
    the ratio: all-equal rows (k = 96 of 960), norm scales near 1 in bf16
    (32 distinct values across 960), float32 values on a coarse grid of
    both signs (also over rows longer than three scan chunks), and each
    float32 uniform repeated 8 times."""
    rng = np.random.default_rng(3)
    if case == "ones":
        return np.ones((2, 960), np.float32), jnp.float32, 0.1
    if case == "bf16_scales":
        x = 1.0 + 0.02 * rng.standard_normal((4, 960))
        return x.astype(np.float32), jnp.bfloat16, 0.1
    if case == "grid":
        x = np.round(rng.standard_normal((3, 1001)) * 4) / 4
        return x.astype(np.float32), jnp.float32, 0.3
    if case == "long":        # ties spread over several scan chunks
        x = np.round(rng.standard_normal((2, 3 * comp._SCAN_CHUNK + 7)) * 2)
        return (x / 2).astype(np.float32), jnp.float32, 0.3
    u = rng.random((4, 128), dtype=np.float32)
    return np.repeat(u, 8, axis=1), jnp.float32, 0.1


def _jax_top_k_mask(x, k):
    """{0,1} mask of ``jax.lax.top_k``'s set per row (numpy)."""
    _, idx = jax.lax.top_k(x, k)
    mask = np.zeros(x.shape, np.float32)
    np.put_along_axis(mask, np.asarray(idx), 1.0, axis=1)
    return mask


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 * 4096 + 5])
def test_top_k_mask_across_tie_chunks(n):
    """Ties are counted per chunk of ``_SCAN_CHUNK`` columns: rows whose
    last kept tie falls before, on and after a chunk boundary (all-equal
    rows with k on either side of 4096, and rows of few values) give
    ``jax.lax.top_k``'s set."""
    rng = np.random.default_rng(n)
    rows = np.concatenate([np.ones((1, n)), rng.integers(0, 3, (2, n))])
    x = rows.astype(np.float32)
    for k in sorted({1, max(1, n // 3), max(1, n - 1), 4095 % n + 1,
                     4097 % n + 1}):
        np.testing.assert_array_equal(
            comp._top_k_mask(torch.from_numpy(x), k).numpy(),
            _jax_top_k_mask(jnp.asarray(x), k) > 0, err_msg=str(k))


@pytest.mark.parametrize("case", ["ones", "bf16_scales", "grid", "long",
                                  "repeated"])
def test_topk_ties_select_as_jax_top_k(case):
    """Magnitudes tied at each row's k-th value: the port's top-k keeps the
    lower index among equal magnitudes, as ``jax.lax.top_k`` does, and the
    messages are bit-equal to the reference's."""
    x, dtype, ratio = _tie_rows(case)
    tree = {"s": jnp.asarray(x, dtype)}
    want, _ = ref_comp.TopK(ratio).encode(tree, ())
    got, _ = comp.TopK(ratio).encode(_to_torch(tree), ())
    _assert_bit_equal(got, want)
    k = comp._num_kept(x.shape[1], ratio)
    flat = jnp.abs(tree["s"]).astype(jnp.float32)
    kth = np.sort(np.asarray(flat), axis=1)[:, -k]
    assert (np.asarray(flat) == kth[:, None]).sum() > x.shape[0]   # ties
    np.testing.assert_array_equal(
        comp._top_k_mask(torch.from_numpy(np.array(flat)), k).numpy(),
        _jax_top_k_mask(flat, k) > 0)


@pytest.mark.parametrize("case", ["ones", "grid", "long", "repeated"])
def test_rand_subset_ties_select_as_jax_top_k(case):
    """Uniforms tied at each row's k-th value: the rand-k mask (RandK's and
    GaussianMask's one definition) is ``jax.lax.top_k``'s set, and RandK's
    rescaled and contractive messages on those uniforms are the
    reference's arithmetic on that mask."""
    u, _, ratio = _tie_rows(case)
    u = np.abs(u) / (np.abs(u).max() + 1)          # uniforms in [0, 1)
    K, n = u.shape
    k = comp._num_kept(n, ratio)
    flat = np.random.default_rng(4).standard_normal((K, n)).astype(
        np.float32)
    want = _jax_top_k_mask(jnp.asarray(u), k)
    got = comp._rand_subset_mask(torch.from_numpy(u), torch.from_numpy(flat),
                                 k)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    draws = comp.Draws(u=[torch.from_numpy(u)])
    x = torch.from_numpy(flat)
    masked = jnp.asarray(flat) * jnp.asarray(want)
    np.testing.assert_array_equal(
        comp.RandK(ratio).encode_contractive({"s": x}, draws)["s"].numpy(),
        np.asarray(masked))
    np.testing.assert_array_equal(
        comp.RandK(ratio).encode({"s": x}, (), draws)[0]["s"].numpy(),
        np.asarray(masked * (n / k)))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name,sigma", [("randk", 0.0), ("gauss", 0.0),
                                        ("gauss", 0.5)])
def test_randk_and_gaussian_mask_bit_equal(name, sigma, bf16):
    tree = _rand_tree(jax.random.PRNGKey(5), 8, bf16=bf16)
    key = jax.random.PRNGKey(21)
    ref = (ref_comp.RandK(0.3) if name == "randk"
           else ref_comp.GaussianMask(0.3, sigma))
    port = (comp.RandK(0.3) if name == "randk"
            else comp.GaussianMask(0.3, sigma))
    draws = _leaf_draws(key, tree, noise=sigma > 0)
    want, _ = ref.encode(tree, (), key)
    got, _ = port.encode(_to_torch(tree), (), draws)
    _assert_bit_equal(got, want)
    _assert_bit_equal(port.encode_contractive(_to_torch(tree), draws),
                      ref.encode_contractive(tree, key))
    with pytest.raises(ValueError):
        port.encode(_to_torch(tree), ())


def test_error_feedback_bit_equal_and_residual():
    """EF(int8) and EF(top-k): the messages and the residual
    target - messages equal the reference's over three rounds."""
    tree = _rand_tree(jax.random.PRNGKey(2), 6)
    for inner, ref_inner in ((comp.Int8Stochastic(),
                              ref_comp.Int8Stochastic()),
                             (comp.TopK(0.25), ref_comp.TopK(0.25))):
        c, rc = comp.ErrorFeedback(inner), ref_comp.ErrorFeedback(ref_inner)
        st, rst = c.init_state(_to_torch(tree)), rc.init_state(tree)
        assert all(not leaf.any() for leaf in tree_leaves(st))
        for i in range(3):
            key = jax.random.PRNGKey(40 + i)
            rmsgs, rst = rc.encode(tree, rst, key)
            msgs, st = c.encode(_to_torch(tree), st,
                                _leaf_draws(key, tree))
            _assert_bit_equal(msgs, rmsgs)
            _assert_bit_equal(st, rst)
        assert c.name == ref_inner.name + "+ef" and c.stateful


def test_make_compressor_validation_wire_bytes_and_passthrough():
    tree = {"w": torch.zeros(4, 1000), "v": torch.zeros(4, 200)}
    ref_tree = {"w": jnp.zeros((4, 1000)), "v": jnp.zeros((4, 200))}
    dense = comp.dense_wire_bytes(tree)
    assert dense == ref_comp.dense_wire_bytes(ref_tree) == 4 * 4 * 1200
    for name, kw in (("int8", {}), ("topk", {"ratio": 0.1}),
                     ("randk", {"ratio": 0.1, "error_feedback": True}),
                     ("gauss", {"ratio": 0.3}), ("none", {})):
        assert (comp.make_compressor(name, **kw).wire_bytes(tree)
                == ref_comp.make_compressor(name, **kw).wire_bytes(ref_tree))
    c = comp.make_compressor("topk", ratio=0.25)
    assert isinstance(c, comp.TopK) and comp.make_compressor(c) is c
    wrapped = comp.make_compressor(c, error_feedback=True)
    assert isinstance(wrapped, comp.ErrorFeedback) and wrapped.inner is c
    assert comp.make_compressor(wrapped, error_feedback=True) is wrapped
    assert isinstance(comp.make_compressor("none", error_feedback=True),
                      comp.Identity)
    assert isinstance(comp.make_compressor(None), comp.Identity)
    assert comp.make_compressor("gaussian", ratio=0.5, sigma=0.1).sigma == 0.1
    for bad in (lambda: comp.make_compressor("nope"),
                lambda: comp.make_compressor("topk", ratio=0.0),
                lambda: comp.make_compressor("randk", ratio=1.5),
                lambda: comp.GaussianMask(0.5, sigma=-1.0),
                lambda: comp.ErrorFeedback(wrapped),
                lambda: comp.RandK(0.5).encode({"w": torch.zeros(2, 4)}, ()),
                lambda: comp.Int8Stochastic().encode(tree, ())):
        with pytest.raises(ValueError):
            bad()


# ---------------------------------------------------------------------------
# the compressors' laws (tests/test_compression_props.py), from generators
# ---------------------------------------------------------------------------

def _vector(seed, n=128, scale=3.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(0.0, scale, (1, n)).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 17, 4242])
def test_int8_and_randk_unbiased(seed):
    """E[c] = x: the mean over many draws lies within 6 standard errors
    (int8: one quantization step per coordinate at most; rand-k:
    |x| sqrt(n/k - 1))."""
    x = _vector(seed)
    gen = torch.Generator().manual_seed(seed)
    n_draws = 512
    mean = sum(comp.Int8Stochastic().encode({"x": x}, (), gen)[0]["x"]
               for _ in range(n_draws)) / n_draws
    step = float(x.abs().max()) / 127.0
    assert ((mean - x).abs() <= 6.0 * step / np.sqrt(n_draws) + 1e-7).all()
    x = _vector(seed, n=64)
    n_draws = 4096
    mean = sum(comp.RandK(0.25).encode({"x": x}, (), gen)[0]["x"]
               for _ in range(n_draws)) / n_draws
    sd = x.abs() * np.sqrt(1.0 / 0.25 - 1.0)
    assert ((mean - x).abs() <= 6.0 * sd / np.sqrt(n_draws) + 1e-6).all()


@pytest.mark.parametrize("seed", [1, 99, 2024])
def test_gaussian_mask_sigma0_is_randk_and_ef_residual_vanishes(seed):
    x = _vector(seed, n=64)
    g, _ = comp.GaussianMask(0.25, sigma=0.0).encode(
        {"x": x}, (), torch.Generator().manual_seed(seed))
    r, _ = comp.RandK(0.25).encode({"x": x}, (),
                                   torch.Generator().manual_seed(seed))
    np.testing.assert_array_equal(g["x"].numpy(), r["x"].numpy())
    # top-k + EF on a fixed vector: bounded residual, and the mean
    # transmitted message converges to x at rate O(1/T)
    T, ratio = 200, 0.25
    c = comp.ErrorFeedback(comp.TopK(ratio))
    state = c.init_state({"x": x})
    total = torch.zeros_like(x)
    norms = []
    for _ in range(T):
        msgs, state = c.encode({"x": x}, state)
        total += msgs["x"]
        norms.append(float(state["x"].norm()))
    x_norm = float(x.norm()) + 1e-9
    assert max(norms) <= (2.0 / ratio) * x_norm
    err = float((total / T - x).norm())
    assert err <= max(norms) / T + 1e-6 and err <= 0.05 * x_norm


def test_compressed_gradients_transform():
    """CompressedGradients as the engine's grad_transform: the counter and
    the EF residual advance in place (the port's optimizer protocol), and
    rand-k gradients inside the local steps still converge."""
    K = 3
    cg = comp.CompressedGradients(comp.make_compressor(
        "topk", ratio=0.5, error_feedback=True), seed=3)
    params = {"w": torch.zeros(K, 4)}
    state = cg.init(params)
    residual = state[1]["w"]
    g = {"w": torch.arange(12.0).reshape(K, 4)}
    msgs, state2 = cg(g, state, params)
    assert state2 is state and int(state[0]) == 1
    assert state[1]["w"] is residual
    np.testing.assert_array_equal((msgs["w"] + residual).numpy(),
                                  g["w"].numpy())
    w_star = torch.tensor([1.0, -2.0, 0.5, 3.0])
    cfg = diff.DiffusionConfig(num_agents=K, local_steps=2, step_size=0.1,
                               participation=0.9, topology="full")
    cg = comp.CompressedGradients(comp.make_compressor("randk", ratio=0.5),
                                  seed=3)
    eng = diff.DiffusionEngine(
        cfg, lambda p, b: ((p["w"] - b["x"]) ** 2).sum(), cg, device="cpu")
    p0 = {"w": torch.zeros(K, 4)}
    _, _, hist = eng.run(p0, lambda key: {"x": w_star.expand(2, K, 4)},
                         200, opt_state=cg.init(p0), w_star={"w": w_star})
    assert np.mean(hist[-20:]) < 0.05 * hist[0]


# ---------------------------------------------------------------------------
# kernel 5's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _quantized_inputs(K, M, tile, seed=0):
    """test_fused_int8_kernel_matches_reference's inputs."""
    key = jax.random.PRNGKey(seed)
    nm = M // tile
    W = jax.random.normal(key, (K, M))
    tiles = W.reshape(K, nm, tile)
    amax = jnp.abs(tiles).max(axis=2)
    scales = jnp.where(amax > 0, amax / 127.0, 1.0)
    u = jax.random.uniform(jax.random.PRNGKey(seed + 1), tiles.shape)
    q = jnp.clip(jnp.floor(tiles / scales[:, :, None] + u),
                 -127, 127).astype(jnp.int8)
    return q.reshape(K, M), scales


@pytest.mark.parametrize("K,M,tile", [(8, 512, 128), (12, 1536, 512),
                                      (4, 384, 128)])
@pytest.mark.parametrize("subtract_identity", [False, True])
def test_mix_int8_ref_matches_pallas_kernel(K, M, tile, subtract_identity):
    """The reference's gate, atol 1e-4 / rtol 1e-5, for the plain version
    and for the wrapper, which takes it for CPU tensors."""
    A = jnp.asarray(ref_make_topology("ring", K).A, jnp.float32)
    Wq, scales = _quantized_inputs(K, M, tile)
    for seed in range(3):
        m = jax.random.bernoulli(jax.random.fold_in(KEY, seed), 0.6,
                                 (K,)).astype(jnp.float32)
        want = np.asarray(ref_mix_int8(A, m, Wq, scales, tile_m=tile,
                                       interpret=True,
                                       subtract_identity=subtract_identity))
        args = (torch.from_numpy(np.array(A)), torch.from_numpy(
            np.array(m)), torch.from_numpy(np.array(Wq)),
            torch.from_numpy(np.array(scales)))
        got = mix_int8_ref(*args, tile_m=tile,
                           subtract_identity=subtract_identity)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
        via = dmi.diffusion_mix_int8(*args, tile_m=tile,
                                     subtract_identity=subtract_identity)
        np.testing.assert_array_equal(via.numpy(), got.numpy())


@pytest.mark.parametrize("K,tile", [(8, 128), (64, 512)])
@pytest.mark.parametrize("subtract_identity", [False, True])
def test_mix_int8_exact_bounds_float32_evaluations(K, tile,
                                                   subtract_identity):
    """mix_int8_exact's float64 value and summation bound, on uniform int8
    values times uniform scales up to 1 (terms up to 127): the reference's
    kernel (interpret mode), the plain version and a float32 sum in
    reversed agent order all lie within the bound, elementwise; and the
    float64 value is the plain version's to 1e-5 relative to max(1, |x|)."""
    rng = np.random.default_rng(K)
    M = tile * 3
    Wq = rng.integers(-127, 128, (K, M)).astype(np.int8)
    scales = (1.0 - rng.random((K, M // tile))).astype(np.float32)
    A = np.asarray(ref_make_topology("erdos", K, seed=K).A, np.float32)
    for mask in (np.ones(K), (rng.random(K) < 0.6) * 1.0):
        m = mask.astype(np.float32)
        args = tuple(torch.from_numpy(x) for x in (A, m, Wq, scales))
        exact, bound = mix_int8_exact(*args, tile_m=tile,
                                      subtract_identity=subtract_identity)
        got = mix_int8_ref(*args, tile_m=tile,
                           subtract_identity=subtract_identity)
        want = torch.from_numpy(np.array(ref_mix_int8(
            jnp.asarray(A), jnp.asarray(m), jnp.asarray(Wq),
            jnp.asarray(scales), tile_m=tile, interpret=True,
            subtract_identity=subtract_identity)))
        A_eff = masked_combination(args[0], args[1])
        if subtract_identity:
            A_eff = A_eff - torch.eye(K)
        C = (args[2].float().reshape(K, -1, tile)
             * args[3][:, :, None]).reshape(K, M)
        backwards = torch.zeros(K, M)
        for l in reversed(range(K)):
            backwards += A_eff[l][:, None] * C[l][None, :]
        for x in (want, got, backwards):
            assert bool(((x.double() - exact).abs() <= bound).all())
        assert ((got.double() - exact).abs()
                / exact.abs().clamp(min=1.0)).max() <= 1e-5


def test_mix_int8_operand_validation():
    """The reference's checks (test_fused_int8_kernel_validation) and the
    kernel's K limit raise ValueError."""
    K, M = 4, 256
    A, m = torch.eye(K), torch.ones(K)
    with pytest.raises(ValueError, match="int8"):
        dmi.diffusion_mix_int8(A, m, torch.zeros(K, M), torch.ones(K, 2),
                               tile_m=128)
    with pytest.raises(ValueError, match="scales shape"):
        dmi.diffusion_mix_int8(A, m, torch.zeros(K, M, dtype=torch.int8),
                               torch.ones(K, 3), tile_m=128)
    with pytest.raises(ValueError, match="divisible"):
        dmi.diffusion_mix_int8(A, m, torch.zeros(K, 300, dtype=torch.int8),
                               torch.ones(K, 2), tile_m=128)
    big = dmi.MAX_AGENTS + 1
    with pytest.raises(ValueError, match="limit"):
        dmi.diffusion_mix_int8(torch.eye(big), torch.ones(big),
                               torch.zeros(big, 128, dtype=torch.int8),
                               torch.ones(big, 1), tile_m=128)
    for ref_bad in ((jnp.zeros((K, M)), jnp.ones((K, 2))),
                    (jnp.zeros((K, M), jnp.int8), jnp.ones((K, 3)))):
        with pytest.raises(ValueError):
            ref_mix_int8(jnp.eye(K), jnp.ones(K), *ref_bad, tile_m=128,
                         interpret=True)


# ---------------------------------------------------------------------------
# the fused mixer's int8 path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("tile_m", [128, 512])
def test_fused_mix_int8_matches_reference(tile_m, bf16):
    """PallasFusedMixer.mix_int8 against the reference's (its default
    tile_m, 512) with its realized uniforms, on a stack narrow enough for
    one 128-column tile and on one of three 512-column tiles that span
    leaves: messages bit-equal (the same per-tile quantizer on the same
    concatenated, padded layout), deltas within float32 summation order
    (1e-5) or one bf16 rounding of it."""
    K = 8
    topo = ref_make_topology("ring", K)
    A = jnp.asarray(topo.A, jnp.float32)
    tree = _rand_tree(jax.random.PRNGKey(8), K, bf16=bf16)
    tree["e"] = jax.random.normal(jax.random.PRNGKey(9),
                                  (K, 90 if tile_m == 128 else 1000))
    M = sum(int(np.prod(l.shape[1:])) for l in jax.tree.leaves(tree))
    assert mixing.int8_layout(K, M)[0] == tile_m
    m = jnp.asarray([1, 0, 1, 1, 0, 1, 1, 1], jnp.float32)
    key = jax.random.PRNGKey(4)
    d_ref, c_ref = ref_mixing.PallasFusedMixer(
        interpret=True).mix_int8(tree, m, A, key, want_messages=True)
    mixer = mixing.PallasFusedMixer()
    u = _flat_draws(key, K, M).u
    d, c = mixer.mix_int8(_to_torch(tree), torch.from_numpy(np.array(m)),
                          torch.from_numpy(np.array(A)),
                          want_messages=True, u=u)
    _assert_bit_equal(c, c_ref)
    for g, w in zip(tree_leaves(d), jax.tree.leaves(d_ref)):
        tol = 2.0 ** -7 if g.dtype == torch.bfloat16 else 1e-5
        np.testing.assert_allclose(_np(g), _ref_np(w), atol=tol, rtol=tol)
    d2, none = mixer.mix_int8(_to_torch(tree), torch.from_numpy(
        np.array(m)), torch.from_numpy(np.array(A)), u=u)
    assert none is None
    for a, b in zip(tree_leaves(d), tree_leaves(d2)):
        assert torch.equal(a, b)


def test_int8_tile_cut_does_not_change_the_result(monkeypatch):
    """The fused int8 path cuts its column tiles at multiples of the int8
    tile and pads only the last one, so with the same uniforms the result
    is bit-equal whatever TILE_ELEMS is; one kernel call per column tile
    (mixing.num_tiles)."""
    K = 4
    rng = np.random.default_rng(3)
    tree = {"a": torch.from_numpy(rng.standard_normal((K, 3000)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(
            (K, 7, 31)).astype(np.float32)).to(torch.bfloat16),
        "c": torch.zeros(K, 600)}                 # an all-zero tile: scale 1
    M = 3000 + 217 + 600
    mixer = mixing.PallasFusedMixer()
    tile, width, cols = mixing.int8_layout(K, M)
    assert (tile, width, cols) == (512, 4096, 4096)
    u = torch.from_numpy(rng.random((K, width)).astype(np.float32))
    A = torch.as_tensor(make_topology("ring", K).A, dtype=torch.float32)
    m = torch.tensor([1.0, 0.0, 1.0, 1.0])
    calls = []
    real = dmi.diffusion_mix_int8

    def counted(*args, **kwargs):
        calls.append(args[2].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(dmi, "diffusion_mix_int8", counted)
    results = []
    for elems, launches in ((1 << 28, 1), (K * 300, 8), (K * 1100, 4),
                            (K * 1600, 3)):
        monkeypatch.setattr(mixing, "TILE_ELEMS", elems)
        calls.clear()
        results.append(mixer.mix_int8(tree, m, A, want_messages=True, u=u))
        assert len(calls) == mixing.num_tiles(K, M, int8=True) == launches
        assert all(s[1] % tile == 0 for s in calls)
    for d, c in results[1:]:
        for a, b in zip(tree_leaves(d) + tree_leaves(c),
                        tree_leaves(results[0][0])
                        + tree_leaves(results[0][1])):
            assert torch.equal(a, b)
    # the inactive agent's delta is exactly 0; the zero leaf's messages 0
    for leaf in tree_leaves(results[0][0]):
        assert not leaf[1].any()
    assert not results[0][1]["c"].any()


def test_int8_stages_are_marked_for_the_profiler(monkeypatch):
    """Each stage of the fused int8 path runs inside its record_function
    range, once per column tile, so a profiler trace can group a
    combination's device time by stage; under the profiler the result is
    bit-equal to the untraced one."""
    from torch.profiler import ProfilerActivity, profile

    K = 4
    rng = np.random.default_rng(5)
    tree = {"a": torch.from_numpy(rng.standard_normal((K, 3000)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(
            (K, 9, 40)).astype(np.float32)).to(torch.bfloat16)}
    M = 3000 + 360
    monkeypatch.setattr(mixing, "TILE_ELEMS", K * 1100)
    tiles = mixing.num_tiles(K, M, int8=True)
    assert tiles == 4
    A = torch.as_tensor(make_topology("ring", K).A, dtype=torch.float32)
    m = torch.tensor([1.0, 1.0, 0.0, 1.0])
    mixer = mixing.PallasFusedMixer()
    want = mixer.mix_int8(tree, m, A, torch.Generator().manual_seed(2),
                          want_messages=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = mixer.mix_int8(tree, m, A, torch.Generator().manual_seed(2),
                             want_messages=True)
    names = [e.name for e in prof.events()]
    for stage in ("tiled.gather", "tiled.scatter", "mix_int8.draw",
                  "mix_int8.quantize", "mix_int8.cast", "mix_int8.kernel",
                  "mix_int8.messages"):
        assert names.count(stage) == tiles, stage
    for a, b in zip(tree_leaves(got[0]) + tree_leaves(got[1]),
                    tree_leaves(want[0]) + tree_leaves(want[1])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# CommPipeline: replay parity, invariants, modes and gamma
# ---------------------------------------------------------------------------

_CASES = [  # (compress, ratio, error_feedback, mode, sigma)
    ("none", 1.0, False, "auto", 0.0), ("int8", 1.0, True, "auto", 0.0),
    ("int8", 1.0, False, "auto", 0.0), ("topk", 0.3, False, "auto", 0.0),
    ("topk", 0.3, True, "direct", 0.0), ("randk", 0.3, True, "auto", 0.0),
    ("gauss", 0.3, False, "auto", 0.2), ("gauss", 0.3, True, "direct", 0.2),
]


def _pipeline_draws(pipe, mix, key, tree, K):
    """The draws the reference's pipeline realizes for ``key``."""
    base = pipe._base()
    if isinstance(base, comp.Int8Stochastic) and mix == "pallas":
        M = sum(int(np.prod(l.shape[1:])) for l in jax.tree.leaves(tree))
        return _flat_draws(key, K, M)
    return _leaf_draws(key, tree, noise=isinstance(base, comp.GaussianMask))


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("mix", ["dense", "sparse", "pallas"])
@pytest.mark.parametrize("kind,K", [("ring", 8), ("grid", 12)])
def test_pipeline_replay_parity(kind, K, mix, case):
    """Two rounds (cold and warm state) of the reference's pipeline and the
    port's on the same params, masks and draws: the state (EF residual,
    reference copy) bit-equal, the output within float32 summation order
    (1e-5)."""
    compress, ratio, ef, mode, sigma = case
    topo = ref_make_topology(kind, K)
    A = jnp.asarray(topo.A, jnp.float32)
    kw = dict(compress=compress, compress_ratio=ratio, error_feedback=ef,
              sigma=sigma, mode=mode)
    ref = ref_mixing.make_pipeline(mix, topo, tile_m=512, interpret=True,
                                   **kw)
    port = mixing.make_pipeline(mix, make_topology(kind, K), device="cpu",
                                **kw)
    assert (port.mode, port.gamma, port.stateful) == (ref.mode, ref.gamma,
                                                      ref.stateful)
    tree = _rand_tree(jax.random.PRNGKey(K), K)
    rstate, state = ref.init_state(tree), port.init_state(_to_torch(tree))
    for rnd in range(2):
        key = jax.random.PRNGKey(30 + rnd)
        m = jax.random.bernoulli(jax.random.fold_in(key, 5), 0.6,
                                 (K,)).astype(jnp.float32)
        want, rstate = ref(tree, m, A, rstate, key)
        got, state = port(_to_torch(tree), torch.from_numpy(np.array(m)),
                          torch.from_numpy(np.array(A)), state,
                          _pipeline_draws(port, mix, key, tree, K))
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(_np(g), _ref_np(w), atol=1e-5,
                                       rtol=0)
        if port.stateful:
            _assert_bit_equal(state, rstate)
        else:
            assert state == rstate == ()


@pytest.mark.parametrize("compress,ratio,ef,mode", [
    ("topk", 0.3, False, "auto"), ("randk", 0.3, False, "auto"),
    ("gauss", 0.3, False, "auto"), ("int8", 1.0, True, "auto"),
    ("int8", 1.0, False, "auto"), ("topk", 0.3, True, "direct")])
@pytest.mark.parametrize("mix", ["dense", "pallas"])
def test_eq20_invariants_under_compression(mix, compress, ratio, ef, mode):
    """test_eq20_invariants_under_compression on the port, with generator
    draws: inactive agents keep their parameters and their state slices
    exactly; the network mean is kept within 1e-4."""
    K = 8
    pipe = mixing.make_pipeline(mix, make_topology("ring", K),
                                compress=compress, compress_ratio=ratio,
                                error_feedback=ef, mode=mode, device="cpu")
    A = torch.as_tensor(make_topology("ring", K).A, dtype=torch.float32)
    params = _to_torch(_rand_tree(KEY, K))
    state = pipe.init_state(params)
    m = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.float32)
    gen = torch.Generator().manual_seed(9)
    for _ in range(2):
        prev = state
        out, state = pipe(params, m, A, state, gen)
        for li, lo in zip(tree_leaves(params), tree_leaves(out)):
            for k in (1, 4):
                assert torch.equal(lo[k], li[k])
            np.testing.assert_allclose(lo.mean(0).numpy(),
                                       li.mean(0).numpy(), atol=1e-4)
        for new, old in zip(tree_leaves(state), tree_leaves(prev)):
            for k in (1, 4):
                assert torch.equal(new[k], old[k])


@pytest.mark.parametrize("compress", ["topk", "randk", "gauss"])
@pytest.mark.parametrize("kind,K", [("ring", 8), ("grid", 12)])
def test_ratio_one_matches_dense_mixer(kind, K, compress):
    """Every sparsifier at ratio 1.0 equals the plain dense mixer within
    1e-5 under random masks (diff mode, gamma 1, exact reference)."""
    topo = make_topology(kind, K)
    A = torch.as_tensor(topo.A, dtype=torch.float32)
    dense = mixing.make_mixer("dense", topo)
    pipe = mixing.make_pipeline("dense", topo, compress=compress,
                                compress_ratio=1.0, device="cpu")
    assert pipe.gamma == 1.0 and pipe.mode == "diff"
    gen = torch.Generator().manual_seed(1)
    state = None
    for seed in range(4):
        params = _to_torch(_rand_tree(jax.random.fold_in(KEY, seed), K))
        state = pipe.init_state(params) if state is None else state
        m = (torch.rand(K, generator=gen) < 0.6).float()
        want = dense(params, m, A)
        got, state = pipe(params, m, A, state, gen)
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                       rtol=1e-5)


def test_diff_mode_reference_tracks_params():
    """The diff-mode reference copy converges to a fixed iterate (implicit
    error feedback): after 12 rounds the gap is below 1e-5 of the first."""
    K = 8
    topo = make_topology("ring", K)
    A = torch.as_tensor(topo.A, dtype=torch.float32)
    pipe = mixing.make_pipeline("dense", topo, compress="topk",
                                compress_ratio=0.25, device="cpu")
    params = _to_torch(_rand_tree(KEY, K))
    state = pipe.init_state(params)
    gaps = []
    for _ in range(12):
        _, state = pipe(params, torch.ones(K), A, state)
        gaps.append(max(float((p - r).abs().max()) for p, r in
                        zip(tree_leaves(params), tree_leaves(state["ref"]))))
    assert gaps[-1] < 1e-5 * max(gaps[0], 1.0)


def test_mode_resolution_gamma_and_guards():
    """test_pipeline_mode_resolution_and_gamma and the reference's guards
    and warning, on the port."""
    topo = make_topology("ring", 8)

    def mk(**kw):
        return mixing.make_pipeline("dense", topo, device="cpu", **kw)

    p = mk()
    assert p.mode == "identity" and not p.stateful and p.gamma == 1.0
    p = mk(compress="topk", compress_ratio=0.1)
    assert p.mode == "diff" and p.stateful and p.gamma == 0.5
    assert mk(compress="randk", compress_ratio=0.1).gamma == pytest.approx(0.1)
    p = mk(compress="gauss", compress_ratio=0.25)
    assert p.mode == "diff" and p.gamma == pytest.approx(0.25)
    p = mk(compress="int8")
    assert p.mode == "direct" and not p.stateful and p.needs_key
    assert mk(compress="int8", error_feedback=True).stateful
    p = mk(compress="topk", compress_ratio=0.1, error_feedback=True)
    assert p.mode == "diff" and isinstance(p.compressor, comp.TopK)
    p = mk(compress="topk", compress_ratio=0.1, mode="direct",
           error_feedback=True, gamma=0.7)
    assert p.mode == "direct" and p.stateful and p.gamma == 0.7
    with pytest.raises(ValueError):
        mk(mode="nope")
    with pytest.raises(ValueError, match="identity mode"):
        mk(compress="topk", mode="identity")
    with pytest.warns(UserWarning, match="anneals"):
        p = mk(compress="int8", gamma="auto")
    assert p.gamma == 1.0 and not p.adaptive
    with pytest.raises(ValueError, match="base_A"):
        mixing.CommPipeline(mixing.DenseMixer(), comp.TopK(0.1),
                            gamma="auto")
    with pytest.raises(ValueError, match="robust"):
        mixing.make_pipeline("trimmed_mean", topo, compress="int8",
                             device="cpu")
    with pytest.raises(ValueError, match="identity-mode"):
        mixing.CommPipeline(mixing.DenseMixer(), comp.Int8Stochastic(),
                            secure_agg=object())
    with pytest.raises(ValueError, match="key"):
        mk(compress="int8")({"w": torch.zeros(8, 4)}, torch.ones(8),
                            torch.eye(8))
    null = mixing.CommPipeline(mixing.make_mixer("none", num_agents=1),
                               comp.make_compressor("topk", ratio=0.1))
    tree = {"w": torch.zeros(4, 1000)}
    assert null.wire_bytes(tree) == 0 and not null.stateful
    assert null.init_state(tree) == ()
    assert mk(compress="int8").wire_bytes(tree) == 4 * 1000
    assert mk().wire_bytes(tree) == 4 * 4 * 1000
    # the int8 layout: INT8_TILE columns to a scale, or M rounded up to
    # 128 when the stack is narrower
    assert mixing.int8_layout(8, 200) == (256, 256, 256)
    assert mixing.int8_layout(8, 1025)[:2] == (mixing.INT8_TILE, 1536)


@pytest.mark.parametrize("kind,K,ratio", [("ring", 8, 0.1), ("grid", 12, 0.3),
                                          ("erdos", 10, 0.05)])
def test_choco_and_annealed_gamma_match_reference(kind, K, ratio):
    """gamma="auto": the CHOCO floor from the spectral gap and ||I - A||_2
    and the annealed step over three rounds (the contraction EMA over
    active agents) against the reference's, within float32 rounding."""
    for args in ((0.05, 0.1, 1.2), (0.5, 1.0, 0.4), (1e-3, 0.01, 2.0)):
        assert mixing.choco_gamma(*args) == ref_mixing.choco_gamma(*args)
    topo = ref_make_topology(kind, K)
    A = jnp.asarray(topo.A, jnp.float32)
    ref = ref_mixing.make_pipeline("dense", topo, compress="topk",
                                   compress_ratio=ratio, gamma="auto")
    port = mixing.make_pipeline("dense", make_topology(kind, K),
                                compress="topk", compress_ratio=ratio,
                                gamma="auto", device="cpu")
    assert port.adaptive and port.gamma == "auto"
    assert port.gamma_floor == ref.gamma_floor
    tree = _rand_tree(KEY, K)
    rstate, state = ref.init_state(tree), port.init_state(_to_torch(tree))
    for rnd in range(3):
        m = jax.random.bernoulli(jax.random.PRNGKey(rnd), 0.7,
                                 (K,)).astype(jnp.float32)
        want, rstate = ref(tree, m, A, rstate, None)
        got, state = port(_to_torch(tree), torch.from_numpy(np.array(m)),
                          torch.from_numpy(np.array(A)), state)
        np.testing.assert_allclose(float(state["delta"]),
                                   float(rstate["delta"]), rtol=1e-6)
        np.testing.assert_allclose(float(port.annealed_gamma(state)),
                                   float(ref.annealed_gamma(rstate)),
                                   rtol=1e-6)
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(_np(g), _ref_np(w), atol=1e-5)
    with pytest.raises(ValueError, match="adaptive"):
        mixing.make_pipeline("dense", make_topology(kind, K),
                             compress="topk", device="cpu"
                             ).annealed_gamma(state)


# ---------------------------------------------------------------------------
# DiffusionEngine.step: replay parity of compressed training
# ---------------------------------------------------------------------------

K_E, T_E, B_E, S_E = 4, 2, 2, 32


def _engine_weights(ref_cfg, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        shape = (K_E,) + s.shape
        if "scale" in name:
            w = 1.0 + 0.1 * rng.standard_normal(shape)
        elif "embed" in name:
            w = 0.02 * rng.standard_normal(shape)
        else:
            w = rng.standard_normal(shape) / np.sqrt(s.shape[-2])
        return jnp.asarray(w, s.dtype)

    return jax.tree_util.tree_map_with_path(leaf,
                                            ref_tf.param_specs(ref_cfg))


def _engine_blocks(n, vocab, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, vocab, (T_E, K_E, B_E, S_E)).astype(np.int32)
        lab = np.concatenate([tok[..., 1:], np.zeros_like(tok[..., :1])], -1)
        out.append({"tokens": tok, "labels": lab})
    return out


_ENGINE_CASES = {
    "int8_ef_pallas": dict(mix="pallas", compress="int8",
                           error_feedback=True, topology="fedavg"),
    "int8_ef_dense": dict(mix="dense", compress="int8", error_feedback=True,
                          topology="fedavg"),
    "topk_diff_pallas": dict(mix="pallas", compress="topk",
                             compress_ratio=0.1, error_feedback=True),
    "randk_diff_pallas": dict(mix="pallas", compress="randk",
                              compress_ratio=0.1, error_feedback=True),
}


def _record_port(monkeypatch, kind, calls):
    """Append each of the port's compressor calls of a block to ``calls``:
    (input, q, scale, uniforms) of every int8 quantization, (input,
    message) of every top-k or rand-k leaf."""
    if kind == "int8":
        real = comp.quantize_int8

        def quantize(x, axis=-1, u=None):
            q, scale = real(x, axis=axis, u=u)
            calls.append((x.clone(), q.clone(), scale.clone(), u.clone()))
            return q, scale

        monkeypatch.setattr(comp, "quantize_int8", quantize)
    else:
        cls = comp.TopK if kind == "topk" else comp.RandK
        real_leaf = cls._leaf

        def leaf(self, x, *args, **kw):
            out = real_leaf(self, x, *args, **kw)
            calls.append((x.clone(), out.clone()))
            return out

        monkeypatch.setattr(cls, "_leaf", leaf)


def _record_reference(monkeypatch, kind, calls):
    """:func:`_record_port` for the reference's jitted step: a host
    callback per call fills ``calls[i]``, i the call's trace order."""
    traced = [0]

    def host(i):
        def rec(*arrays):
            calls[i] = tuple(torch.from_numpy(np.array(a)) for a in arrays)
        return rec

    if kind == "int8":
        real = ref_comp.quantize_int8

        def quantize(x, key, axis=-1):
            q, scale = real(x, key, axis=axis)
            jax.debug.callback(host(traced[0]), x, q, scale,
                               jax.random.uniform(key, x.shape))
            traced[0] += 1
            return q, scale

        monkeypatch.setattr(ref_comp, "quantize_int8", quantize)
    else:
        cls = ref_comp.TopK if kind == "topk" else ref_comp.RandK
        real_leaf = cls._leaf

        def leaf(self, x, *args, **kw):
            out = real_leaf(self, x, *args, **kw)
            jax.debug.callback(host(traced[0]), x, out)
            traced[0] += 1
            return out

        monkeypatch.setattr(cls, "_leaf", leaf)


def _threshold_flips(kind, port_calls, ref_calls, sizes, ratio, tol):
    """The coordinates where the port's message and the reference's differ
    because a rounding (int8) or a selection (top-k) sits at its threshold
    and the two inputs differ there.

    Holds the compressor inputs within ``tol (1 + |x|)``; for int8, the
    rounded values x / scale + u within a hundredth of a step of each
    other everywhere (so a flip is one step, at an integer); for top-k, the
    port's selection on the reference's own input is the reference's (bit-
    equal messages: no flip at a tie), no flip in a row whose inputs are
    bit-equal, as many coordinates leaving each row's selection as
    entering it, each at a magnitude within twice the row's input
    difference of the row's k-th largest; for rand-k (the same injected
    uniforms), no flip at all; and the messages off the flips within ``tol
    (1 + |c|)``.  Returns the (K, n) flip masks per leaf (a flattened
    layout split at ``sizes``) and the largest message difference at a
    flip."""
    masks, dc = [], 0.0
    for got, want in zip(port_calls, ref_calls, strict=True):
        K = got[0].shape[0]
        xp, xr = (t.reshape(K, -1).double() for t in (got[0], want[0]))
        assert bool(((xp - xr).abs() <= tol * (1 + xr.abs())).all())
        if kind == "int8":
            vp, vr = (t[0].double() / t[2].double() + t[3].double()
                      for t in (got, want))
            assert (vp - vr).abs().max() <= 1e-2
            qp, qr = got[1].reshape(K, -1), want[1].reshape(K, -1)
            flip = qp != qr
            cp = (got[1] * got[2]).reshape(K, -1).double()
            cr = (want[1] * want[2]).reshape(K, -1).double()
        else:
            cp, cr = (t.reshape(K, -1).double() for t in (got[1], want[1]))
            flip = (cp != 0) != (cr != 0)
            # a coordinate exactly 0 in one input only is a selection
            # either way; at every other coordinate a flip needs a tie
            # broken otherwise (none may be) or inputs that differ
            assert not bool(flip[(xp == xr).all(1)].any())
        if kind == "randk":
            assert not bool((flip & (xp != 0) & (xr != 0)).any())
        elif kind == "topk":
            x0 = want[0].reshape(K, -1)
            k = comp._num_kept(x0.shape[1], ratio)
            own = comp._top_k_mask(x0.abs().float(), k)
            assert torch.equal(x0 * own.to(x0.dtype), want[1].reshape(K, -1))
            thr = xr.abs().topk(k, dim=1).values[:, -1:]
            room = 2 * (xp - xr).abs().amax(dim=1, keepdim=True)
            near = (xr.abs() - thr).abs() <= room + 1e-12
            assert bool(near[flip].all())
            assert torch.equal((flip & (cp != 0)).sum(1),
                               (flip & (cr != 0)).sum(1))
        d = (cp - cr).abs()
        assert bool((d[~flip] <= tol * (1 + cr.abs()[~flip])).all())
        if flip.any():
            dc = max(dc, d[flip].max().item())
        masks.append(flip)
    if len(masks) == 1 and len(sizes) > 1:        # the fused int8 layout
        masks = list(torch.split(masks[0][:, :sum(sizes)], sizes, dim=1))
    return masks, dc


@pytest.mark.parametrize("name", list(_ENGINE_CASES))
def test_engine_step_replay_parity_under_compression(
        name, monkeypatch):
    """smollm-smoke, K = 4, T = 2, SGD, 2 blocks, q = 0.9: the reference's
    engine and the port's, each block from the reference's state, fed the
    reference's realized masks and compression draws and the same batches.

    Gate: the local updates sum float32 in another order, so a message
    coordinate whose rounding (int8) or selection (top-k) sits at its
    threshold may come out differently where the two inputs differ.  Both
    compressors' inputs and outputs are recorded and every such flip is
    accounted for (:func:`_threshold_flips`); a selection that breaks a tie
    otherwise than ``jax.lax.top_k`` fails it, for top-k and rand-k.  Every weight and every state entry is
    within 1e-5 (1 + |w|) of the reference's, except at a flipped
    coordinate of its own or a neighbor's message; there it is within 2
    gamma times the largest message difference at a flip, plus 1e-5 (1 +
    |w|).  The realized masks are equal."""
    cfg_case = _ENGINE_CASES[name]
    kind = cfg_case["compress"]
    dcfg = diff.DiffusionConfig(num_agents=K_E, local_steps=T_E,
                                step_size=0.1, participation=0.9,
                                **{"topology": "ring", **cfg_case})
    rcfg_model = ref_get_config("smollm-360m").smoke
    ref_calls, port_calls = {}, []
    _record_reference(monkeypatch, kind, ref_calls)
    _record_port(monkeypatch, kind, port_calls)
    ref_eng = ref_diff.DiffusionEngine(
        ref_diff.DiffusionConfig(**dataclasses.asdict(dcfg)),
        lambda p, b: ref_tf.train_loss(p, rcfg_model, b, remat=False))
    params = _engine_weights(rcfg_model)
    blocks = _engine_blocks(2, rcfg_model.vocab_size)
    rstate = ref_eng.init_state(params)
    cfg = get_config("smollm-360m").smoke
    eng = diff.DiffusionEngine(
        dcfg, lambda p, b: tf.train_loss(p, cfg, b, remat=False),
        device="cpu")
    assert eng.pipeline.mode == ref_eng.pipeline.mode
    assert type(eng.compressor).__name__ == type(
        ref_eng.compressor).__name__
    gamma = eng.pipeline.gamma
    sup = (torch.as_tensor(eng.topology.A) != 0) | torch.eye(K_E,
                                                             dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    sizes = [int(np.prod(l.shape[1:])) for l in jax.tree.leaves(params)]
    M, tol, flips = sum(sizes), 1e-5, 0
    for i, blk in enumerate(blocks):
        start = eng.init_state(_to_torch(rstate.params)).replace(
            comm_state=_to_torch(rstate.comm_state))
        key = jax.random.PRNGKey(100 + i)
        ref_calls.clear()
        port_calls.clear()
        rstate, metrics = ref_eng.step(rstate, jax.tree.map(jnp.asarray, blk),
                                       key)
        jax.effects_barrier()
        m = np.array(metrics["active"])
        key_comm = jax.random.split(key)[1]
        if kind == "int8" and dcfg.mix == "pallas":
            draws = _flat_draws(key_comm, K_E, M)
        elif kind in ("int8", "randk"):
            draws = _leaf_draws(key_comm, params)
        else:
            draws = None                       # top-k draws nothing
        state, pm = eng.step(start, tree_map(torch.from_numpy, blk), gen,
                             active=m, comm_key=draws)
        np.testing.assert_array_equal(pm["active"].numpy(), m)
        masks, dc = _threshold_flips(
            kind, port_calls, [ref_calls[j] for j in sorted(ref_calls)],
            sizes, dcfg.compress_ratio, tol)
        flips += sum(int(f.sum()) for f in masks)
        # a flip at agent j reaches agent k through a_jk
        near = [(sup.T.double() @ f.double()) > 0 for f in masks]
        got = tree_leaves(state.params) + tree_leaves(state.comm_state)
        want = (jax.tree.leaves(rstate.params)
                + jax.tree.leaves(rstate.comm_state))
        assert len(got) == len(want) == 2 * len(masks)
        for j, (g, w) in enumerate(zip(got, want)):
            w = torch.from_numpy(np.array(w, np.float64))
            d = (g.double() - w).abs().reshape(K_E, -1)
            room = tol * (1 + w.abs().reshape(K_E, -1))
            far = d > room
            assert not bool((far & ~near[j % len(masks)]).any()), (i, j)
            assert bool((d <= 2 * gamma * dc + room).all()), (i, j)
    print(f"{name}: {flips} threshold flips over {len(blocks)} blocks")


def test_engine_draws_one_compression_seed_after_the_mask():
    """A compressing pipeline takes exactly one draw from the block
    generator, after the activation draw: the mask is that of the
    uncompressed step, and the generator ends one seed draw further on
    (the identity pipeline draws nothing more)."""
    def loss(p, b):
        return ((p["w"] - b["x"]) ** 2).sum()

    def one_step(**changes):
        cfg = diff.DiffusionConfig(num_agents=6, participation=0.5,
                                   **changes)
        eng = diff.DiffusionEngine(cfg, loss, device="cpu")
        state = eng.init_state({"w": torch.zeros(6, 3)})
        gen = torch.Generator().manual_seed(5)
        state, m = eng.step(state, {"x": torch.ones(1, 6, 3)}, gen)
        return m["active"], gen, state

    m_plain, g_plain, _ = one_step()
    m_int8, g_int8, state = one_step(compress="int8", error_feedback=True)
    assert torch.equal(m_plain, m_int8)
    torch.randint(0, 2 ** 62, (1,), generator=g_plain)
    assert torch.equal(g_plain.get_state(), g_int8.get_state())
    assert tree_leaves(state.comm_state)[0].shape == (6, 3)


# ---------------------------------------------------------------------------
# serving: int8 consensus extraction
# ---------------------------------------------------------------------------

def test_consensus_int8_close_to_f32_and_deterministic():
    """The reference's gate: relative squared error of the int8 consensus
    against the float32 one below 1e-3; one seed gives bit-equal results;
    the reference meets the same gate on the same stack."""
    K = 6
    ks = jax.random.split(KEY, 2)
    stacked = {"w": jax.random.normal(ks[0], (K, 32, 16)),
               "b": jax.random.normal(ks[1], (K, 8))}
    port = _to_torch(stacked)
    f32 = consensus_from_stacked(port, K, "dense")
    for mix in ("dense", "pallas"):
        i8 = consensus_from_stacked(port, K, mix, quantize="int8")
        err = sum(float(((a.double() - b.double()) ** 2).sum())
                  for a, b in zip(tree_leaves(f32), tree_leaves(i8)))
        ref = sum(float((a.double() ** 2).sum()) for a in tree_leaves(f32))
        assert err / ref < 1e-3
        again = consensus_from_stacked(port, K, mix, quantize="int8")
        for a, b in zip(tree_leaves(i8), tree_leaves(again)):
            assert torch.equal(a, b)
        other = consensus_from_stacked(port, K, mix, quantize="int8",
                                       quantize_seed=1)
        assert not all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(i8), tree_leaves(other)))
    want = ref_consensus(stacked, K, "dense", quantize="int8")
    for a, b in zip(tree_leaves(f32), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=0.05)
    # a bf16 stack comes back in bf16
    bf = tree_map(lambda x: x.to(torch.bfloat16), port)
    out = consensus_from_stacked(bf, K, "pallas", quantize="int8")
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(out))
    assert to_numpy(out["w"]).dtype == np.int16


def test_consensus_int8_injected_draws_match_reference():
    """With the reference's uniforms, the int8 encode+dequantize that the
    consensus collapses from is the reference's, bit for bit, and the
    collapse agrees within float32 summation order."""
    K = 5
    ks = jax.random.split(jax.random.PRNGKey(2), 2)
    stacked = {"w": jax.random.normal(ks[0], (K, 12, 6)),
               "b": jax.random.normal(ks[1], (K, 9))}
    c = ref_comp.Int8Stochastic()
    q, s = c.encode_quantized(stacked, jax.random.PRNGKey(0))
    want = ref_consensus(c.dequantize(q, s, stacked), K, "dense")
    got_ref = ref_consensus(stacked, K, "dense", quantize="int8",
                            quantize_seed=0)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got_ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    pc = comp.Int8Stochastic()
    msgs, _ = pc.encode(_to_torch(stacked), (),
                        _leaf_draws(jax.random.PRNGKey(0), stacked))
    got = consensus_from_stacked(msgs, K, "dense")
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_consensus_quantize_rejects_unknown_and_serve_flag(tmp_path):
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch import serve

    port = {"w": torch.zeros(4, 3)}
    with pytest.raises(ValueError, match="quantize"):
        consensus_from_stacked(port, 4, "dense", quantize="int4")
    cfg = get_config("smollm-360m").smoke
    gen = torch.Generator().manual_seed(0)
    stack = tree_map(lambda *xs: torch.stack(xs),
                     *[tf.init_params(gen, cfg) for _ in range(4)])
    path = str(tmp_path / "k4.npz")
    save_checkpoint(path, stack)
    argv = ["--device", "cpu", "--agents", "4", "--checkpoint", path,
            "--mix", "pallas", "--batch", "2", "--prompt-len", "8",
            "--decode", "3", "--temperature", "0"]
    a = serve.main(argv + ["--consensus-quantize", "int8"])
    b = serve.main(argv + ["--consensus-quantize", "int8"])
    f = serve.main(argv)
    for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
        assert torch.equal(x, y)
    assert not all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(a["params"]), tree_leaves(f["params"])))
    assert torch.equal(a["tokens"], b["tokens"])
    with pytest.raises(SystemExit):
        serve.main(argv + ["--consensus-quantize", "int4"])


def test_masked_combination_of_the_kernel_delta_rows():
    """(A_eff - I)^T C: an inactive agent's delta row is exactly zero and
    every column of A_eff - I sums to zero, so the correction keeps the
    network mean."""
    K = 6
    A = torch.as_tensor(make_topology("ring", K).A, dtype=torch.float32)
    m = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0])
    rng = np.random.default_rng(0)
    Wq = torch.from_numpy(rng.integers(-127, 128, (K, 256)).astype(np.int8))
    scales = torch.from_numpy(rng.random((K, 2)).astype(np.float32))
    d = dmi.diffusion_mix_int8(A, m, Wq, scales, tile_m=128,
                               subtract_identity=True)
    assert not d[1].any() and not d[4].any()
    C = Wq.float().reshape(K, 2, 128) * scales[:, :, None]
    np.testing.assert_allclose(d.sum(0).numpy(), np.zeros(256), atol=1e-4)
    np.testing.assert_allclose(
        (d + C.reshape(K, 256)).numpy(),
        (masked_combination(A, m).T @ C.reshape(K, 256)).numpy(),
        atol=1e-5)


def test_quiet_without_auto_gamma():
    """No warning when gamma is fixed or defaulted."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mixing.make_pipeline("dense", make_topology("ring", 4),
                             compress="int8", gamma=0.5, device="cpu")
        mixing.make_pipeline("dense", make_topology("ring", 4),
                             compress="topk", gamma="auto", device="cpu")
