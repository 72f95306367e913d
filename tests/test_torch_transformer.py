"""Port parity: configs, prefill, the ring-buffer cache and greedy decode
(``repro_torch.models`` against ``repro.models``), with the reference's
weights carried across by ``params_from_jax``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import (params_from_jax,  # noqa: E402
                                        stacked_params_from_jax)
from repro_torch.tree import tree_flatten_with_path, tree_leaves  # noqa: E402

ATOL = 1e-4


def test_config_fields_match_reference():
    ref, port = ref_get_config("smollm-360m"), get_config("smollm-360m")
    for a, b in ((ref.model, port.model), (ref.smoke, port.smoke)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.segments() == b.segments()
    assert port.model.param_dtype == torch.bfloat16
    assert port.smoke.param_dtype == torch.float32
    assert dataclasses.asdict(ref.parallel) == dataclasses.asdict(
        port.parallel)


def test_unported_archs_name_their_roadmap_item():
    for arch in ("qwen3-32b", "mamba2-2.7b", "granite-moe-1b-a400m"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config(arch)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def _setup(window=None):
    ref_cfg = ref_get_config("smollm-360m").smoke
    cfg = get_config("smollm-360m").smoke
    if window is not None:
        ref_cfg = dataclasses.replace(ref_cfg, attention_window=window)
        cfg = dataclasses.replace(cfg, attention_window=window)
    # seeded numpy weights at the reference's init scales (1/sqrt(fan-in),
    # embeddings 0.02, norm scales near 1) in the reference's tree layout
    rng = np.random.default_rng(0)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            w = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif "embed" in name:
            w = 0.02 * rng.standard_normal(s.shape)
        else:
            w = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
        return jnp.asarray(w, s.dtype)

    ref_params = jax.tree_util.tree_map_with_path(
        leaf, ref_tf.param_specs(ref_cfg))
    params = params_from_jax(jax.device_get(ref_params), device="cpu")
    return ref_cfg, cfg, ref_params, params


def test_init_and_specs_match_reference_shapes():
    ref_cfg = ref_get_config("smollm-360m").smoke
    cfg = get_config("smollm-360m").smoke
    ref_specs = ref_tf.param_specs(ref_cfg)
    ref_paths = [(jax.tree_util.keystr(p), tuple(s.shape)) for p, s in
                 jax.tree_util.tree_flatten_with_path(ref_specs)[0]]
    got = tf.init_params(torch.Generator().manual_seed(0), cfg)
    specs = tf.param_specs(cfg)
    port_paths = [("".join(f"[{k!r}]" for k in p), tuple(t.shape))
                  for p, t in tree_flatten_with_path(got)]
    assert port_paths == ref_paths
    assert [tuple(t.shape) for t in tree_leaves(specs)] == [
        s for _, s in port_paths]
    assert all(t.device.type == "meta" for t in tree_leaves(specs))
    stacked = tf.param_specs(cfg, num_agents=3)
    assert all(t.shape[0] == 3 for t in tree_leaves(stacked))
    # the port's init draws the reference's distributions
    emb = got["embed"]
    assert abs(emb.std().item() - 0.02) < 2e-3


def _compare_cache(cache, ref_cache):
    assert cache.pos == int(ref_cache.pos)
    np.testing.assert_array_equal(cache.slot_pos.numpy(),
                                  np.asarray(ref_cache.slot_pos))
    for seg, ref_seg in zip(cache.segments, ref_cache.segments):
        for name in ("k", "v"):
            np.testing.assert_allclose(seg[name].numpy(),
                                       np.asarray(ref_seg[name]), atol=ATOL,
                                       rtol=0)


@pytest.mark.parametrize("window,prompt", [(None, 24), (16, 24)])
def test_prefill_and_greedy_decode_match_reference(window, prompt):
    """Prefill logits and cache, then 8 greedy decode steps; the windowed
    variant's ring buffer is already wrapped after prefill (24 > 16) and
    keeps wrapping while decoding."""
    ref_cfg, cfg, ref_params, params = _setup(window)
    B, n = 2, 8
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (B, prompt)).astype(np.int32)
    ref_logits, ref_cache = ref_tf.prefill(ref_params, ref_cfg,
                                           jnp.asarray(tokens),
                                           max_len=prompt + n)
    with torch.inference_mode():
        logits, cache = tf.prefill(params, cfg, torch.from_numpy(tokens),
                                   max_len=prompt + n)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=ATOL, rtol=0)
    _compare_cache(cache, ref_cache)

    ref_toks, ref_last, ref_cache = jax.jit(
        lambda p, c, lg: ref_tf.decode_loop(p, ref_cfg, c, lg, None, n,
                                            temperature=0.0, unroll=1))(
        ref_params, ref_cache, ref_logits[:, -1])
    with torch.inference_mode():
        toks, last, cache = tf.decode_loop(params, cfg, cache, logits[:, -1],
                                           None, n, temperature=0.0)
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (B, n)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last),
                               atol=ATOL, rtol=0)
    _compare_cache(cache, ref_cache)


def test_decode_step_matches_reference_from_empty_cache():
    ref_cfg, cfg, ref_params, params = _setup(window=4)
    ref_cache = ref_tf.init_cache(ref_cfg, 2, 12, window=4)
    cache = tf.init_cache(cfg, 2, 12, window=4, device="cpu")
    ref_step = jax.jit(lambda p, c, t: ref_tf.decode_step(p, ref_cfg, c, t))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (6, 2, 1))
    for t in toks.astype(np.int32):
        ref_lg, ref_cache = ref_step(ref_params, ref_cache, jnp.asarray(t))
        with torch.inference_mode():
            lg, cache = tf.decode_step(params, cfg, cache,
                                       torch.from_numpy(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), atol=ATOL,
                                   rtol=0)
    _compare_cache(cache, ref_cache)


def test_sampled_decode_shapes_and_determinism():
    _, cfg, _, params = _setup()
    tokens = torch.zeros((2, 5), dtype=torch.int32)
    outs = []
    for _ in range(2):
        with torch.inference_mode():
            logits, cache = tf.prefill(params, cfg, tokens, max_len=9)
            gen = torch.Generator().manual_seed(3)
            toks, _, _ = tf.decode_loop(params, cfg, cache, logits[:, -1],
                                        gen, 4, temperature=0.8)
        outs.append(toks)
    assert outs[0].dtype == torch.int32 and tuple(outs[0].shape) == (2, 4)
    assert torch.equal(outs[0], outs[1])
    assert int(outs[0].min()) >= 0 and int(outs[0].max()) < cfg.vocab_size


def test_stacked_conversion_checks_agent_axis():
    tree = {"a": np.zeros((3, 2), np.float32), "b": np.zeros((3,), np.int32)}
    out = stacked_params_from_jax(tree, 3, device="cpu")
    assert out["b"].dtype == torch.int32
    with pytest.raises(ValueError, match="agent axis"):
        stacked_params_from_jax(tree, 4, device="cpu")


def test_unported_block_types_raise():
    cfg = dataclasses.replace(get_config("smollm-360m").smoke, family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.init_params(torch.Generator(), cfg)
