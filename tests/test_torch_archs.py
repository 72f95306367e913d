"""Port parity: the five text archs (chatglm3, qwen3, starcoder2,
granite-moe, kimi-k2) at their smoke configs, ``repro_torch`` against
``repro`` with the reference's weights carried across by
``params_from_jax``: the forward's logits and load-balance loss, the
training loss and its gradients, the parameter specs against init,
granite's prefill and decode against its forward, and one stacked-engine
block of granite at K = 4 with the reference's activation uniforms
replayed as ``part_u``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import diffusion as ref_diff  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import diffusion as diff  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.tree import (tree_flatten_with_path,  # noqa: E402
                              tree_leaves, tree_map)

ARCHS = ("chatglm3-6b", "qwen3-32b", "starcoder2-15b",
         "granite-moe-1b-a400m", "kimi-k2-1t-a32b")
LOGIT_TOL = 2e-3          # ROADMAP's gates: logits
GRAD_TOL = 1e-4           # and gradients
B, S = 2, 24


def _weights(ref_cfg, lead=(), seed=0):
    """Seeded numpy weights at the reference's init scales, in its tree
    layout (``lead`` adds leading axes)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        shape = lead + s.shape
        if "scale" in name:
            w = 1.0 + 0.1 * rng.standard_normal(shape)
        elif "embed" in name:
            w = 0.02 * rng.standard_normal(shape)
        else:
            w = rng.standard_normal(shape) / np.sqrt(s.shape[-2])
        return jnp.asarray(w, s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, ref_tf.param_specs(ref_cfg))


def _configs(arch, **changes):
    ref_cfg = dataclasses.replace(ref_get_config(arch).smoke, **changes)
    cfg = dataclasses.replace(get_config(arch).smoke, **changes)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    return ref_cfg, cfg


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    """A window below S for starcoder2 (its smoke window, 64, cut to 16)
    so the sliding window bites."""
    changes = {"attention_window": 16} if "starcoder" in arch else {}
    ref_cfg, cfg = _configs(arch, **changes)
    ref_p = _weights(ref_cfg)
    p = params_from_jax(jax.device_get(ref_p), device="cpu")
    toks = _tokens(cfg, (B, S))
    labels = _tokens(cfg, (B, S), seed=2)
    batch = {"tokens": toks, "labels": labels}

    ref_logits, ref_aux, _ = jax.jit(
        lambda p, t: ref_tf.forward(p, ref_cfg, t, remat=False))(
        ref_p, jnp.asarray(toks))
    with torch.no_grad():
        logits, aux, n_prefix = tf.forward(p, cfg, torch.from_numpy(toks),
                                           remat=False)
    assert n_prefix == 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=1e-5,
                               rtol=1e-5)
    if cfg.num_experts:
        assert float(aux) > 0

    ref_loss, ref_g = jax.jit(jax.value_and_grad(
        lambda p: ref_tf.train_loss(p, ref_cfg, jax.tree.map(jnp.asarray,
                                                             batch),
                                    remat=True)))(ref_p)
    loss = tf.train_loss(tree_map(lambda x: x.requires_grad_(), p), cfg,
                         tree_map(torch.from_numpy, batch), remat=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               atol=1e-5, rtol=1e-5)
    ref_g = dict(jax.tree_util.tree_flatten_with_path(ref_g)[0])
    for path, leaf in tree_flatten_with_path(p):
        want = np.asarray(
            ref_g[tuple(jax.tree_util.DictKey(k) for k in path)])
        np.testing.assert_allclose(leaf.grad.numpy(), want, atol=GRAD_TOL,
                                   rtol=0, err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_specs_match_reference(arch):
    ref_cfg, cfg = _configs(arch)
    ref_paths = [(jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype))
                 for p, s in jax.tree_util.tree_flatten_with_path(
                     ref_tf.param_specs(ref_cfg))[0]]
    got = tf.init_params(torch.Generator().manual_seed(0), cfg)
    port_paths = [("".join(f"[{k!r}]" for k in p), tuple(t.shape),
                   str(t.dtype).replace("torch.", ""))
                  for p, t in tree_flatten_with_path(got)]
    assert port_paths == ref_paths
    specs = tf.param_specs(cfg, num_agents=2)
    assert [(2,) + s for _, s, _ in port_paths] == [
        tuple(t.shape) for t in tree_leaves(specs)]
    assert all(t.device.type == "meta" for t in tree_leaves(specs))
    # bf16 models keep the router in float32, as the reference does
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    dtypes = {"/".join(map(str, p)): t.dtype
              for p, t in tree_flatten_with_path(tf.param_specs(bf))}
    for name, dt in dtypes.items():
        assert dt == (torch.float32 if name.endswith("router")
                      else torch.bfloat16), name


def test_granite_decode_matches_forward():
    """tests/test_arch_smoke.py's check, with capacity factor E so no
    assignment is dropped at any token count: prefill's last logits and
    three decode steps against the full forward."""
    ref_cfg, cfg = _configs("granite-moe-1b-a400m", capacity_factor=4.0)
    p = params_from_jax(jax.device_get(_weights(ref_cfg)), device="cpu")
    n_dec, s = 3, 16
    toks = torch.from_numpy(_tokens(cfg, (B, s + n_dec)))
    with torch.no_grad():
        full, _, _ = tf.forward(p, cfg, toks, remat=False)
        lg, cache = tf.prefill(p, cfg, toks[:, :s], max_len=s + n_dec)
        np.testing.assert_allclose(lg[:, -1].numpy(),
                                   full[:, s - 1].numpy(), atol=2e-3,
                                   rtol=2e-3)
        for t in range(n_dec):
            lg_t, cache = tf.decode_step(p, cfg, cache,
                                         toks[:, s + t:s + t + 1])
            np.testing.assert_allclose(lg_t[:, 0].numpy(),
                                       full[:, s + t].numpy(), atol=5e-3,
                                       rtol=5e-3)


def test_granite_prefill_and_decode_match_reference():
    """Prefill and greedy decode at the config's capacity factor: decode's
    capacity comes from its B tokens, prefill's from B S, in both."""
    ref_cfg, cfg = _configs("granite-moe-1b-a400m")
    ref_p = _weights(ref_cfg)
    p = params_from_jax(jax.device_get(ref_p), device="cpu")
    toks = _tokens(cfg, (B, 16))
    n = 4
    ref_lg, ref_cache = ref_tf.prefill(ref_p, ref_cfg, jnp.asarray(toks),
                                       max_len=16 + n)
    ref_toks, ref_last, _ = jax.jit(
        lambda p, c, lg: ref_tf.decode_loop(p, ref_cfg, c, lg, None, n,
                                            temperature=0.0, unroll=1))(
        ref_p, ref_cache, ref_lg[:, -1])
    with torch.no_grad():
        lg, cache = tf.prefill(p, cfg, torch.from_numpy(toks),
                               max_len=16 + n)
        got_toks, last, _ = tf.decode_loop(p, cfg, cache, lg[:, -1], None,
                                           n, temperature=0.0)
    np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last),
                               atol=LOGIT_TOL, rtol=0)


def test_granite_engine_block_matches_reference():
    """One block of the stacked engine at K = 4 (ring, T = 2, SGD 0.05, q
    0.9, dense mixer), the reference's activation uniforms replayed."""
    K, T, arch = 4, 2, "granite-moe-1b-a400m"
    ref_cfg, cfg = _configs(arch)
    dcfg = dict(num_agents=K, local_steps=T, step_size=0.05, topology="ring",
                participation=0.9, mix="dense")
    ref_eng = ref_diff.DiffusionEngine(
        ref_diff.DiffusionConfig(**dcfg),
        lambda p, b: ref_tf.train_loss(p, ref_cfg, b, remat=False))
    params = _weights(ref_cfg, lead=(K,))
    tok = _tokens(cfg, (T, K, 1, 16), seed=3)
    lab = np.concatenate([tok[..., 1:], np.zeros_like(tok[..., :1])], -1)
    batch = {"tokens": tok, "labels": lab}
    key = jax.random.PRNGKey(42)
    ref_state, ref_m = ref_eng.step(ref_eng.init_state(params),
                                    jax.tree.map(jnp.asarray, batch), key)

    eng = diff.DiffusionEngine(
        diff.DiffusionConfig(**dcfg),
        lambda p, b: tf.train_loss(p, cfg, b, remat=False), device="cpu")
    u = np.asarray(jax.random.uniform(jax.random.split(key)[0], (K,)))
    state, m = eng.step(
        eng.init_state(params_from_jax(jax.device_get(params),
                                       device="cpu")),
        tree_map(torch.from_numpy, batch), None, part_u=u)
    np.testing.assert_array_equal(m["active"].numpy(),
                                  np.asarray(ref_m["active"]))
    for g, w in zip(tree_leaves(state.params),
                    jax.tree.leaves(ref_state.params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def _router_is_float32_and_unrounded(tree):
    """Every router leaf of ``tree`` is float32 and holds values that bf16
    cannot (a router rounded to bf16 on the way would not)."""
    routers = [t for p, t in tree_flatten_with_path(tree)
               if p[-1] == "router"]
    assert routers
    for t in routers:
        assert t.dtype == torch.float32
        assert bool((t != t.bfloat16().float()).any())


@pytest.mark.parametrize("engine", ["sharded", "stacked"])
def test_router_leaf_stays_float32_along_the_path(engine, tmp_path):
    """A bf16 granite tree carries a float32 router through the tiled
    flatten of the kernel mixer, the fused int8 path and its error-feedback
    residual, a checkpoint and the numpy conversion."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.sharded import make_block_step
    from repro_torch.models.convert import from_numpy, to_numpy

    K, T = 4, 2
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").smoke,
                              dtype="bfloat16")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    stack = tree_map(lambda x: torch.stack([x] * K).clone(), params)
    tok = torch.from_numpy(_tokens(cfg, (T, K, 1, 16), seed=4))
    batch = {"tokens": tok, "labels": tok}
    dcfg = diff.DiffusionConfig(num_agents=K, local_steps=T, step_size=0.05,
                                topology="fedavg", participation=0.9,
                                mix="pallas")
    if engine == "sharded":
        step = make_block_step(
            lambda p, b, rng: tf.train_loss(p, cfg, b, remat=False), dcfg,
            topology=dcfg.make_topology(), compress="int8",
            error_feedback=True, device="cpu")
        state, _ = step(step.init_state(stack), batch,
                        torch.Generator().manual_seed(1))
        _router_is_float32_and_unrounded(state.comm_state)
    else:
        eng = diff.DiffusionEngine(
            dcfg, lambda p, b: tf.train_loss(p, cfg, b, remat=False),
            device="cpu")
        state, _ = eng.step(eng.init_state(stack), batch, None,
                            active=np.ones(K, bool))
    _router_is_float32_and_unrounded(state.params)
    path = str(tmp_path / "granite.npz")
    save_checkpoint(path, state.params)
    back, _ = load_checkpoint(path, tf.param_specs(cfg, num_agents=K),
                              device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(state.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for t in tree_leaves(state.params):
        rt = from_numpy(to_numpy(t), torch.device("cpu"))
        if t.dtype == torch.bfloat16:
            rt = rt.view(torch.bfloat16)
        assert rt.dtype == t.dtype and torch.equal(rt, t)
