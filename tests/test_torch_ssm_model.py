"""Port parity for the SSM architectures: mamba2-smoke (``mamba`` segments)
and zamba2-smoke (``mamba`` and ``shared_attn`` segments) against the
reference, with the reference's weights carried across by
``params_from_jax``: parameters and specs, the forward with and without
the kernels, training gradients, prefill and decode, conversion and
checkpoints, and Algorithm 1's block step in replay parity."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import load_checkpoint as ref_load  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import diffusion as ref_diff  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch.checkpoint import (load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import diffusion as diff  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.tree import (tree_flatten_with_path,  # noqa: E402
                              tree_leaves, tree_map, tree_unflatten)

ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
# float32 sums of two frameworks through a 2-layer smoke model
ATOL = 1e-4


def _weights(ref_cfg, lead=(), seed=0):
    """Seeded numpy weights at the reference's init scales, in its tree
    layout (``lead`` prepends an agent axis)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        shape = lead + s.shape
        if "scale" in name:
            w = 1.0 + 0.1 * rng.standard_normal(shape)
        elif "embed" in name:
            w = 0.02 * rng.standard_normal(shape)
        elif "A_log" in name:
            w = np.log(np.arange(1, shape[-1] + 1)) + 0.1 * rng.random(shape)
        elif "dt_bias" in name:
            w = rng.uniform(-4.0, -2.0, shape)
        elif "['D']" in name:
            w = 1.0 + 0.1 * rng.standard_normal(shape)
        elif "conv" in name:
            w = 0.1 * rng.standard_normal(shape)
        else:
            w = rng.standard_normal(shape) / np.sqrt(s.shape[-2])
        return jnp.asarray(w, s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, ref_tf.param_specs(ref_cfg))


def _setup(arch, use_kernels=False):
    ref_cfg = ref_get_config(arch).smoke
    cfg = get_config(arch).smoke
    if use_kernels:
        ref_cfg = dataclasses.replace(ref_cfg, use_kernels=True)
        cfg = dataclasses.replace(cfg, use_kernels=True)
    ref_params = _weights(ref_cfg)
    params = params_from_jax(jax.device_get(ref_params), device="cpu")
    return ref_cfg, cfg, ref_params, params


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _paths(tree, is_ref):
    if is_ref:
        return [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in
                jax.tree_util.tree_flatten_with_path(tree)[0]]
    return [("".join(f"[{k!r}]" for k in p), tuple(x.shape))
            for p, x in tree_flatten_with_path(tree)]


def _seg_keys(tree):
    return sorted(tree["segments"]), sorted(k for k in tree
                                            if k != "segments")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch):
    ref, port = ref_get_config(arch), get_config(arch)
    for a, b in ((ref.model, port.model), (ref.smoke, port.smoke)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.segments() == b.segments()
        assert a.block_types() == b.block_types()
    assert dataclasses.asdict(ref.parallel) == dataclasses.asdict(
        port.parallel)
    assert ref.citation == port.citation


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_specs_match_reference(arch):
    ref_cfg, cfg = ref_get_config(arch).smoke, get_config(arch).smoke
    ref_specs = ref_tf.param_specs(ref_cfg)
    got = tf.init_params(torch.Generator().manual_seed(0), cfg)
    specs = tf.param_specs(cfg)
    want = _paths(ref_specs, True)
    assert _paths(got, False) == want
    assert _paths(specs, False) == want
    # the empty shared-attention segments and the top-level subtree
    assert _seg_keys(got) == _seg_keys(ref_specs) == _seg_keys(specs)
    for key, seg in ref_specs["segments"].items():
        if ".shared_attn." in key:
            assert seg == {} and got["segments"][key] == {}
            assert specs["segments"][key] == {}
    dtypes = [str(x.dtype) for x in jax.tree.leaves(ref_specs)]
    assert [str(t.dtype).removeprefix("torch.")
            for t in tree_leaves(got)] == dtypes
    assert all(t.device.type == "meta" for t in tree_leaves(specs))
    stacked = tf.param_specs(cfg, num_agents=3)
    assert all(t.shape[0] == 3 for t in tree_leaves(stacked))
    # full width: the reference's parameter count, without allocating
    full_ref = ref_tf.param_specs(ref_get_config(arch).model)
    full = tf.param_specs(get_config(arch).model)
    assert (sum(t.numel() for t in tree_leaves(full))
            == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(full_ref)))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, use_kernels):
    """Logits of 48 tokens (chunk 32 pads them), the kernels on or off on
    both sides (the reference's in interpret mode), at the gate of the
    reference's kernel-integration test."""
    ref_cfg, cfg, ref_params, params = _setup(arch, use_kernels)
    toks = _tokens(cfg, (2, 48))
    want, _, _ = jax.jit(lambda p, t: ref_tf.forward(p, ref_cfg, t,
                                                     remat=False))(
        ref_params, jnp.asarray(toks))
    got, aux, n_prefix = tf.forward(params, cfg, torch.from_numpy(toks),
                                    remat=False)
    assert float(aux) == 0.0 and n_prefix == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_gradients_match_reference(arch):
    """Loss and gradients with the kernels on (the training path), with
    remat, against the reference's at 1e-4."""
    ref_cfg, cfg, ref_params, params = _setup(arch, use_kernels=True)
    toks = _tokens(cfg, (2, 40))
    lab = np.concatenate([toks[:, 1:], np.zeros_like(toks[:, :1])], -1)
    loss_r, g_r = jax.jit(jax.value_and_grad(lambda p: ref_tf.train_loss(
        p, ref_cfg, {"tokens": jnp.asarray(toks),
                     "labels": jnp.asarray(lab)})))(ref_params)
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
    loss = tf.train_loss(tree_unflatten(params, leaves), cfg,
                         {"tokens": torch.from_numpy(toks),
                          "labels": torch.from_numpy(lab)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_r), rtol=1e-5)
    for g, w in zip(leaves, jax.tree.leaves(g_r)):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_and_forward(arch):
    """Prefill 40 tokens, then 3 decode steps: logits and caches against
    the reference's, and the logits against the full forward (the gates of
    the reference's decode-vs-forward test)."""
    ref_cfg, cfg, ref_params, params = _setup(arch)
    S, n = 40, 3
    toks = _tokens(cfg, (2, S + n), seed=2)
    full, _, _ = tf.forward(params, cfg, torch.from_numpy(toks), remat=False)
    ref_lg, ref_cache = ref_tf.prefill(ref_params, ref_cfg,
                                       jnp.asarray(toks[:, :S]),
                                       max_len=S + n)
    ref_step = jax.jit(lambda p, c, t: ref_tf.decode_step(p, ref_cfg, c, t))
    with torch.inference_mode():
        lg, cache = tf.prefill(params, cfg, torch.from_numpy(toks[:, :S]),
                               max_len=S + n)
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), atol=ATOL,
                                   rtol=0)
        torch.testing.assert_close(lg[:, -1], full[:, S - 1], atol=2e-3,
                                   rtol=2e-3)
        for t in range(n):
            step = toks[:, S + t:S + t + 1]
            lg, cache = tf.decode_step(params, cfg, cache,
                                       torch.from_numpy(step))
            ref_lg, ref_cache = ref_step(ref_params, ref_cache,
                                         jnp.asarray(step))
            np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg),
                                       atol=ATOL, rtol=0)
            torch.testing.assert_close(lg[:, 0], full[:, S + t], atol=5e-3,
                                       rtol=5e-3)
    assert cache.pos == int(ref_cache.pos) == S + n
    np.testing.assert_array_equal(cache.slot_pos.numpy(),
                                  np.asarray(ref_cache.slot_pos))
    for seg, ref_seg in zip(cache.segments, ref_cache.segments):
        assert sorted(seg) == sorted(ref_seg)
        for name in seg:
            assert str(seg[name].dtype).removeprefix("torch.") == str(
                ref_seg[name].dtype)
            np.testing.assert_allclose(seg[name].numpy(),
                                       np.asarray(ref_seg[name]), atol=ATOL,
                                       rtol=0)
    # an empty cache has the reference's layout
    empty = tf.init_cache(cfg, 2, S + n, device="cpu")
    ref_empty = ref_tf.init_cache(ref_cfg, 2, S + n)
    for seg, ref_seg in zip(empty.segments, ref_empty.segments):
        assert {k: tuple(v.shape) for k, v in seg.items()} == {
            k: tuple(v.shape) for k, v in ref_seg.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_conversion_and_checkpoint_keep_empty_segments(arch, tmp_path):
    """``params_from_jax``, ``init_stacked``-style stacking, the mixer's
    flatten and unflatten, and a checkpoint round trip through both
    packages keep the empty shared-attention segments and the top-level
    ``shared_attn`` subtree."""
    from repro_torch.core.mixing import make_mixer
    from repro_torch.launch.train import init_stacked

    ref_cfg, cfg, ref_params, params = _setup(arch)
    assert _seg_keys(params) == _seg_keys(ref_params)
    K = 2
    stack = init_stacked(torch.Generator().manual_seed(0), cfg, K,
                         torch.device("cpu"))
    assert _seg_keys(stack) == _seg_keys(ref_params)
    mixed = make_mixer("pallas", num_agents=K, device="cpu")(
        stack, torch.ones(K), torch.full((K, K), 1.0 / K))
    assert _seg_keys(mixed) == _seg_keys(stack)
    for m, s in zip(tree_leaves(mixed), tree_leaves(stack)):
        torch.testing.assert_close(m, s.float().mean(0, keepdim=True)
                                   .expand_as(s).to(s.dtype))
    path = str(tmp_path / "stack.npz")
    save_checkpoint(path, stack, step=2)
    got, meta = load_checkpoint(path, tf.param_specs(cfg, num_agents=K),
                                device="cpu")
    assert meta["step"] == 2 and _seg_keys(got) == _seg_keys(stack)
    for a, b in zip(tree_leaves(got), tree_leaves(stack)):
        assert torch.equal(a, b)
    like = jax.tree.map(lambda s: jnp.zeros((K,) + s.shape, s.dtype),
                        ref_tf.param_specs(ref_cfg))
    ref_got, _ = ref_load(path, like)
    assert jax.tree.structure(ref_got) == jax.tree.structure(like)
    for a, b in zip(jax.tree.leaves(ref_got), tree_leaves(stack)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_fused_mixer_outputs_own_their_storage():
    """The SSM keeps float32 leaves (A_log, D, dt_bias) beside bf16 ones:
    each mixed leaf owns its storage, so the mixer's (K, M) float32 output
    is freed when the mix returns instead of living on inside them."""
    from repro_torch.core.mixing import make_mixer
    from repro_torch.launch.train import init_stacked

    cfg = dataclasses.replace(get_config("mamba2-2.7b").smoke,
                              dtype="bfloat16")
    K = 2
    stack = init_stacked(torch.Generator().manual_seed(0), cfg, K,
                         torch.device("cpu"))
    mixed = make_mixer("pallas", num_agents=K, device="cpu")(
        stack, torch.ones(K), torch.full((K, K), 1.0 / K))
    dtypes = set()
    for m, s in zip(tree_leaves(mixed), tree_leaves(stack)):
        assert m.dtype == s.dtype
        assert m.untyped_storage().nbytes() == m.numel() * m.element_size()
        dtypes.add(m.dtype)
    assert dtypes == {torch.float32, torch.bfloat16}


# ---------------------------------------------------------------------------
# replay parity of DiffusionEngine.step on mamba2-smoke
# ---------------------------------------------------------------------------

K, T, B, S = 4, 2, 1, 40
_MU = {"sgd": 0.1, "adam": 1e-3}


def _blocks(n, vocab, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, vocab, (T, K, B, S)).astype(np.int32)
        lab = np.concatenate([tok[..., 1:], np.zeros_like(tok[..., :1])], -1)
        out.append({"tokens": tok, "labels": lab})
    return out


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_engine_step_replay_parity_mamba2(optimizer):
    """Algorithm 1 on mamba2-smoke, K = 4 on a ring, q = 0.9, T = 2: the
    reference's engine (dense mix, plain SSD) realizes the masks; the port
    replays them with the fused mix and the SSD kernel path."""
    ref_cfg = ref_get_config("mamba2-2.7b").smoke
    cfg = dataclasses.replace(get_config("mamba2-2.7b").smoke,
                              use_kernels=True)
    dcfg = diff.DiffusionConfig(num_agents=K, local_steps=T,
                                step_size=_MU[optimizer], topology="ring",
                                participation=0.9, mix="dense")
    blocks = _blocks(2, cfg.vocab_size)
    ref_t, t = getattr(ref_opt, optimizer)(), getattr(opt, optimizer)()
    ref_eng = ref_diff.DiffusionEngine(
        ref_diff.DiffusionConfig(**dataclasses.asdict(dcfg)),
        lambda p, b: ref_tf.train_loss(p, ref_cfg, b, remat=False),
        None if optimizer == "sgd" else ref_t.update)
    params = _weights(ref_cfg, lead=(K,))
    ref_state = ref_eng.init_state(params, ref_t.init(params))
    masks = []
    for i, blk in enumerate(blocks):
        ref_state, metrics = ref_eng.step(
            ref_state, jax.tree.map(jnp.asarray, blk),
            jax.random.PRNGKey(100 + i))
        masks.append(np.array(metrics["active"]))
    want = jax.device_get(ref_state.params)

    eng = diff.DiffusionEngine(
        dataclasses.replace(dcfg, mix="pallas"),
        lambda p, b: tf.train_loss(p, cfg, b, remat=False),
        None if optimizer == "sgd" else t.update, device="cpu")
    p = params_from_jax(jax.device_get(params), device="cpu")
    state = eng.init_state(p, t.init(p))
    gen = torch.Generator().manual_seed(0)
    for blk, m in zip(blocks, masks):
        state, metrics = eng.step(state, tree_map(torch.from_numpy, blk), gen,
                                  active=m)
        np.testing.assert_array_equal(metrics["active"].numpy(), m)
    if optimizer == "sgd":
        for g, w in zip(tree_leaves(state.params), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        return
    # Adam's update is about +-1 wherever |g| >> eps, so float32 noise in a
    # near-zero gradient can move a weight by up to 2 mu per step: all
    # within 2 mu T blocks, 99.9 % within 1e-5 relative
    bound = 2 * _MU["adam"] * T * len(blocks)
    n_far = n = 0
    for g, w in zip(tree_leaves(state.params), jax.tree.leaves(want)):
        d = np.abs(g.numpy() - np.asarray(w))
        assert d.max() <= bound
        n_far += int((d > 1e-5 * (1 + np.abs(np.asarray(w)))).sum())
        n += d.size
    assert n_far <= 1e-3 * n, (n_far, n)
