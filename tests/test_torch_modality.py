"""Port parity: llava's image prefix and musicgen's codebooks.

``repro_torch`` against ``repro`` at both smoke configs, with the
reference's weights carried across by ``params_from_jax`` and the same
numpy-seeded inputs: the forward's logits and ``n_prefix``, the loss and
every gradient leaf, prefill and decode against the uncached forward and
against the reference's, greedy fused against py tokens, one block of the
stacked, sharded (world 1) and async engines on the reference's realized
block, both drivers on the CPU, the projector's float32 promotion, the
codebook label layout of the ``iid`` stream, and serve's cache sized for
the image prefix (the reference's evicts it)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api.build import (  # noqa: E402
    make_block_provider as ref_make_provider)
from repro.api.spec import AsyncSpec as RefAsyncSpec  # noqa: E402
from repro.api.spec import (ExperimentSpec as RefSpec,  # noqa: E402
                            ModelSpec as RefModelSpec, RunSpec as RefRunSpec)
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import diffusion as ref_diff  # noqa: E402
from repro.core.async_engine import AsyncEngine as RefAsyncEngine  # noqa: E402
from repro.core.sharded import make_block_step as ref_block_step  # noqa: E402
from repro.core.topology import make_topology as ref_make_topology  # noqa: E402
from repro.data.synthetic import lm_token_batch as ref_lm_batch  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.api.spec import AsyncSpec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import diffusion as diff  # noqa: E402
from repro_torch.core.async_engine import AsyncEngine  # noqa: E402
from repro_torch.core.sharded import make_block_step  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.tree import (tree_flatten_with_path,  # noqa: E402
                              tree_leaves, tree_map)

ARCHS = ("llava-next-mistral-7b", "musicgen-medium")
LOGIT_TOL = 2e-3          # ROADMAP's gates: logits
GRAD_TOL = 1e-4           # gradients
DECODE_TOL = 5e-3         # tests/test_arch_smoke.py's decode gate
B, S = 2, 12
#: the engines' graph and tick keys are folds of the block key
GRAPH_FOLD, TICK_FOLD = 0x9A, 0xA5


def _configs(arch, **changes):
    ref_cfg = dataclasses.replace(ref_get_config(arch).smoke, **changes)
    cfg = dataclasses.replace(get_config(arch).smoke, **changes)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    return ref_cfg, cfg


def _params(ref_cfg, seed=0):
    ref_p = ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref_p, params_from_jax(jax.device_get(ref_p), device="cpu")


def _inputs(cfg, b=B, s=S, seed=1):
    """Seeded numpy tokens (B, S[, nq]) and, for llava, an image prefix."""
    rng = np.random.default_rng(seed)
    shape = (b, s) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    img = None
    if cfg.img_tokens:
        img = (0.02 * rng.standard_normal(
            (b, cfg.img_tokens, tf.VISION_DIM))).astype(np.float32)
    return toks, img


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    ref_cfg, cfg = _configs(arch)
    ref_p, p = _params(ref_cfg)
    toks, img = _inputs(cfg)
    ref_logits, _, ref_n = ref_tf.forward(ref_p, ref_cfg, _j(toks),
                                          img_embeds=_j(img), remat=False)
    with torch.no_grad():
        logits, aux, n_prefix = tf.forward(p, cfg, _t(toks),
                                           img_embeds=_t(img), remat=False)
    assert n_prefix == ref_n == cfg.img_tokens
    want = (B, S + cfg.img_tokens) + (
        (cfg.num_codebooks,) if cfg.num_codebooks else ()) + (
        cfg.vocab_size,)
    assert tuple(logits.shape) == want == tuple(ref_logits.shape)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=LOGIT_TOL, rtol=0)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """Every gradient leaf (the codebook embedding and head, the projector
    included) within 1e-4; the loss drops the prefix's logits."""
    ref_cfg, cfg = _configs(arch)
    ref_p, p = _params(ref_cfg)
    toks, img = _inputs(cfg)
    labels, _ = _inputs(cfg, seed=2)
    batch = {"tokens": toks, "labels": labels}
    if img is not None:
        batch["img_embeds"] = img
    ref_loss, ref_g = jax.jit(jax.value_and_grad(
        lambda q: ref_tf.train_loss(q, ref_cfg, jax.tree.map(jnp.asarray,
                                                             batch),
                                    remat=True)))(ref_p)
    p = tree_map(lambda x: x.requires_grad_(), p)
    loss = tf.train_loss(p, cfg, tree_map(torch.from_numpy, batch),
                         remat=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               atol=1e-5, rtol=1e-5)
    ref_g = dict(jax.tree_util.tree_flatten_with_path(ref_g)[0])
    names = set()
    for path, leaf in tree_flatten_with_path(p):
        names.add(path[0])
        want = np.asarray(
            ref_g[tuple(jax.tree_util.DictKey(k) for k in path)])
        np.testing.assert_allclose(leaf.grad.numpy(), want, atol=GRAD_TOL,
                                   rtol=0, err_msg=str(path))
        assert float(leaf.grad.abs().max()) > 0, path
    assert ("projector" in names) == bool(cfg.img_tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_and_conversion_carry_the_new_leaves(arch, tmp_path):
    """bf16 codebook and projector leaves (a K = 2 stack) cross unchanged:
    the reference's checkpoint loads into the port bit for bit (equal to
    ``params_from_jax``), and the port's loads into the reference."""
    from repro.checkpoint import load_checkpoint as ref_load
    from repro.checkpoint import save_checkpoint as ref_save
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    ref_cfg, cfg = _configs(arch, dtype="bfloat16")
    ref_p = jax.tree.map(lambda x: jnp.stack([x, -x]),
                         ref_tf.init_params(jax.random.PRNGKey(3), ref_cfg))
    path = str(tmp_path / "ref.npz")
    ref_save(path, ref_p, step=1)
    got, _ = load_checkpoint(path, tf.param_specs(cfg, num_agents=2),
                             device="cpu")
    want = params_from_jax(jax.device_get(ref_p), device="cpu")
    names = {q[0] for q, _ in tree_flatten_with_path(got)}
    assert ("projector" in names) == bool(cfg.img_tokens)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, got, step=2)
    back, meta = ref_load(path, ref_p)
    assert meta["step"] == 2
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_p)):
        assert a.dtype == b.dtype and bool((a == b).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_specs_match_reference(arch):
    """Tree paths, shapes and dtypes of init and of the meta specs equal
    the reference's: (nq, V, D) / (nq, D, V) for the codebooks, the
    projector's (VISION_DIM, D) and (D,)."""
    ref_cfg, cfg = _configs(arch)
    ref_paths = [(jax.tree_util.keystr(q), tuple(s.shape), str(s.dtype))
                 for q, s in jax.tree_util.tree_flatten_with_path(
                     ref_tf.param_specs(ref_cfg))[0]]
    got = tf.init_params(torch.Generator().manual_seed(0), cfg)
    port_paths = [("".join(f"[{k!r}]" for k in q), tuple(t.shape),
                   str(t.dtype).replace("torch.", ""))
                  for q, t in tree_flatten_with_path(got)]
    assert port_paths == ref_paths
    specs = tf.param_specs(cfg, num_agents=3)
    assert [(3,) + s for _, s, _ in port_paths] == [
        tuple(t.shape) for t in tree_leaves(specs)]
    full = tf.param_specs(get_config(arch).model)
    ref_full = ref_tf.param_specs(ref_get_config(arch).model)
    assert [tuple(t.shape) for t in tree_leaves(full)] == [
        tuple(s.shape) for s in jax.tree.leaves(ref_full)]


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_track_the_uncached_forward(arch):
    """tests/test_arch_smoke.py's gate over 8 decoded positions: prefill's
    last logits within 2e-3 of the forward, each decode step within 5e-3,
    the cache sized for the whole context (prefix + prompt + decode)."""
    _, cfg = _configs(arch)
    p = tf.init_params(torch.Generator().manual_seed(4), cfg)
    n_dec, s = 8, 16
    toks, img = _inputs(cfg, s=s + n_dec, seed=5)
    toks, img = _t(toks), _t(img)
    P = cfg.img_tokens
    with torch.no_grad():
        full, _, n_prefix = tf.forward(p, cfg, toks, img_embeds=img,
                                       remat=False)
        lg, cache = tf.prefill(p, cfg, toks[:, :s], img_embeds=img,
                               max_len=P + s + n_dec)
        assert n_prefix == P and cache.pos == P + s
        np.testing.assert_allclose(lg[:, -1].numpy(),
                                   full[:, P + s - 1].numpy(), atol=2e-3,
                                   rtol=2e-3)
        for t in range(n_dec):
            lg_t, cache = tf.decode_step(p, cfg, cache,
                                         toks[:, s + t:s + t + 1])
            np.testing.assert_allclose(lg_t[:, 0].numpy(),
                                       full[:, P + s + t].numpy(),
                                       atol=DECODE_TOL, rtol=DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch):
    ref_cfg, cfg = _configs(arch)
    ref_p, p = _params(ref_cfg)
    toks, img = _inputs(cfg)
    n = 6
    max_len = cfg.img_tokens + S + n
    ref_lg, ref_cache = ref_tf.prefill(ref_p, ref_cfg, _j(toks),
                                       img_embeds=_j(img), max_len=max_len)
    ref_toks, ref_last, _ = jax.jit(
        lambda q, c, lg: ref_tf.decode_loop(q, ref_cfg, c, lg, None, n,
                                            temperature=0.0, unroll=1))(
        ref_p, ref_cache, ref_lg[:, -1])
    with torch.no_grad():
        lg, cache = tf.prefill(p, cfg, _t(toks), img_embeds=_t(img),
                               max_len=max_len)
        got, last, _ = tf.decode_loop(p, cfg, cache, lg[:, -1], None, n,
                                      temperature=0.0)
    np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg),
                               atol=LOGIT_TOL, rtol=0)
    assert tuple(got.shape) == tuple(ref_toks.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_toks))
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last),
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_and_py_greedy_tokens_agree(arch):
    """tests/test_serving.py's fused/py parity, and sampled decoding's
    shape and determinism under one generator seed."""
    _, cfg = _configs(arch)
    p = tf.init_params(torch.Generator().manual_seed(6), cfg)
    toks, img = _inputs(cfg, seed=7)
    n = 8
    max_len = cfg.img_tokens + S + n

    def prefill():
        return tf.prefill(p, cfg, _t(toks), img_embeds=_t(img),
                          max_len=max_len)

    with torch.no_grad():
        lg, cache = prefill()
        fused, _, _ = tf.decode_loop(p, cfg, cache, lg[:, -1], None, n,
                                     temperature=0.0)
        lg, cache = prefill()
        logits, py = lg[:, -1], []
        for _ in range(n):
            nxt = tf.sample_logits(logits, None, 0.0)
            py.append(nxt)
            lg_t, cache = tf.decode_step(p, cfg, cache, nxt[:, None])
            logits = lg_t[:, 0]
        sampled = []
        for _ in range(2):
            lg, cache = prefill()
            sampled.append(tf.decode_loop(
                p, cfg, cache, lg[:, -1],
                torch.Generator().manual_seed(3), n, temperature=0.8)[0])
    assert torch.equal(fused, torch.stack(py, dim=1))
    want = (B, n) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    assert tuple(fused.shape) == want and fused.dtype == torch.int32
    assert torch.equal(sampled[0], sampled[1])
    assert int(sampled[0].min()) >= 0
    assert int(sampled[0].max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# the engines on the reference's realized block
# ---------------------------------------------------------------------------

def _ref_block(arch, K, T):
    """Block 0 of the reference's ``iid`` provider (tokens, labels and, for
    llava, the image stream of ``split(key)``), as numpy."""
    spec = RefSpec(model=RefModelSpec(kind="transformer", arch=arch,
                                      smoke=True),
                   run=RefRunSpec(num_agents=K, local_steps=T, batch=1,
                                  seq=8))
    ref_cfg = ref_get_config(arch).smoke
    provider = ref_make_provider(spec, ref_cfg)
    return jax.device_get(provider(0, jax.random.PRNGKey(11)))


@pytest.mark.parametrize("engine", ["stacked", "sharded", "async"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_block_matches_reference(arch, engine):
    """One block at K = 4 (ring, T = 2, SGD 0.05, q 0.9, dense mixer) on
    the reference's realized block, its activation (and async tick)
    uniforms replayed: the masks equal, the parameters within 1e-5.  Every
    leaf of the block, the float32 image stream included, is sliced per
    local step and agent."""
    K, T = 4, 2
    ref_cfg, cfg = _configs(arch)
    dcfg = dict(num_agents=K, local_steps=T, step_size=0.05, topology="ring",
                participation=0.9, mix="dense")
    block = _ref_block(arch, K, T)
    assert set(block) == ({"tokens", "labels", "img_embeds"}
                          if cfg.img_tokens else {"tokens", "labels"})
    params = jax.tree.map(
        lambda x: jnp.stack([x] * K) * (1.0 + 0.01 * jnp.arange(K).reshape(
            (K,) + (1,) * x.ndim)).astype(x.dtype),
        ref_tf.init_params(jax.random.PRNGKey(2), ref_cfg))
    key = jax.random.PRNGKey(42)

    def ref_loss(q, b, *rng):
        return ref_tf.train_loss(q, ref_cfg, b, remat=False)

    def loss(q, b, *rng):
        return tf.train_loss(q, cfg, b, remat=False)

    port_params = params_from_jax(jax.device_get(params), device="cpu")
    batch = tree_map(lambda x: torch.from_numpy(np.array(x)), block)
    jblock = jax.tree.map(jnp.asarray, block)
    u = np.asarray(jax.random.uniform(jax.random.split(key)[0], (K,)))
    if engine == "stacked":
        ref = ref_diff.DiffusionEngine(ref_diff.DiffusionConfig(**dcfg),
                                       ref_loss)
        ref_state, ref_m = ref.step(ref.init_state(params), jblock, key)
        eng = diff.DiffusionEngine(diff.DiffusionConfig(**dcfg), loss,
                                   device="cpu")
        state, m = eng.step(eng.init_state(port_params), batch, None,
                            part_u=u)
    elif engine == "sharded":
        ref_step = ref_block_step(ref_loss, ref_diff.DiffusionConfig(**dcfg),
                                  topology=ref_make_topology("ring", K))
        ref_state, ref_m = jax.jit(ref_step)(
            ref_step.init_state(params, key=jax.random.PRNGKey(1)), jblock,
            key)
        step = make_block_step(loss, diff.DiffusionConfig(**dcfg),
                               topology=make_topology("ring", K),
                               device="cpu")
        state, m = step(step.init_state(port_params), batch, None,
                        part_u=u)
    else:
        spec_kw = dict(enabled=True, rate_dist="lognormal", rate_sigma=0.5,
                       rate_seed=1, tau_max=2)
        ref = RefAsyncEngine(ref_diff.DiffusionConfig(**dcfg), ref_loss,
                             async_spec=RefAsyncSpec(**spec_kw))
        ref_state, ref_m = ref.step(
            ref.init_state(params, key=jax.random.PRNGKey(3)), jblock, key)
        eng = AsyncEngine(diff.DiffusionConfig(**dcfg), loss,
                          async_spec=AsyncSpec(**spec_kw), device="cpu")
        state, m = eng.step(
            eng.init_state(port_params), batch, None, part_u=u,
            graph_u=np.asarray(jax.random.uniform(
                jax.random.fold_in(key, GRAPH_FOLD), (K, K))),
            tick_u=np.asarray(jax.random.uniform(
                jax.random.fold_in(key, TICK_FOLD), (K,))))
    np.testing.assert_array_equal(m["active"].numpy(),
                                  np.asarray(ref_m["active"]))
    for g, w in zip(tree_leaves(state.params),
                    jax.tree.leaves(ref_state.params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_and_serve_drivers_on_the_cpu(arch, tmp_path):
    """``train.main`` (the default sharded engine, ``--mix pallas``) writes
    a spec checkpoint; ``serve.main`` serves it with no other spec flag
    (codebook prompts (B, P, nq) and tokens (B, n, nq); llava's image
    prefix from the prompts' stream, the cache sized for it)."""
    path = str(tmp_path / "ckpt.npz")
    out = train.main(["--device", "cpu", "--arch", arch, "--smoke",
                      "--blocks", "2", "--seq", "16", "--mix", "pallas",
                      "--checkpoint", path])
    cfg = out["cfg"]
    assert np.isfinite(out["losses"]).all()
    batch = out["provider"](0, torch.Generator().manual_seed(0))
    if cfg.img_tokens:
        run = out["spec"].run
        assert tuple(batch["img_embeds"].shape) == (
            run.local_steps, run.num_agents, run.batch, cfg.img_tokens,
            tf.VISION_DIM)
        assert batch["img_embeds"].dtype == torch.float32
    served = serve.main(["--device", "cpu", "--checkpoint", path, "--batch",
                         "2", "--prompt-len", "8", "--decode", "4",
                         "--temperature", "0"])
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    assert tuple(served["prompts"].shape) == (2, 8) + cb
    assert tuple(served["tokens"].shape) == (2, 4) + cb
    assert served["max_len"] == cfg.img_tokens + 8 + 4
    assert (served["img_embeds"] is None) == (not cfg.img_tokens)
    again = serve.main(["--device", "cpu", "--checkpoint", path, "--batch",
                        "2", "--prompt-len", "8", "--decode", "4",
                        "--temperature", "0", "--decode-loop", "py"])
    assert torch.equal(served["tokens"], again["tokens"])


def test_serve_at_the_training_depth_cut(tmp_path):
    """A checkpoint trained with ``train.main(..., num_layers=1)`` serves
    through ``serve.main(..., num_layers=1)`` (the same knob), its
    consensus the mean of the stored one-layer stack."""
    path = str(tmp_path / "cut.npz")
    argv = ["--device", "cpu", "--arch", "llava-next-mistral-7b", "--smoke"]
    out = train.main(argv + ["--blocks", "1", "--seq", "8", "--mix",
                             "pallas", "--checkpoint", path], num_layers=1)
    assert out["cfg"].num_layers == 1
    served = serve.main(["--device", "cpu", "--checkpoint", path, "--batch",
                         "1", "--prompt-len", "4", "--decode", "2",
                         "--temperature", "0"], num_layers=1)
    assert served["cfg"].num_layers == 1
    for got, x in zip(tree_leaves(served["params"]),
                      tree_leaves(out["state"].params)):
        torch.testing.assert_close(got, x.mean(0), atol=1e-6, rtol=1e-6)
    with pytest.raises(KeyError):              # the full depth's leaves
        serve.main(["--device", "cpu", "--checkpoint", path])


# ---------------------------------------------------------------------------
# the projector's promotion, the codebook labels, the prefix-sized cache
# ---------------------------------------------------------------------------

def test_projector_promotes_to_float32_as_jax_does():
    """bf16 weights: JAX promotes float32 ``img_embeds @ w`` (and ``+ b``)
    to float32, then casts to bf16.  The port computes the same in float32
    with the weights upcast: equal to that product cast to bf16, within
    one bf16 ulp of the reference's, and not the product of embeddings
    first cast down to bf16."""
    ref_cfg, cfg = _configs("llava-next-mistral-7b", dtype="bfloat16")
    ref_p, p = _params(ref_cfg)
    toks, img = _inputs(cfg)
    ref_x, ref_n = ref_tf._embed_inputs(ref_p, ref_cfg, _j(toks), _j(img))
    x, n = tf._embed_inputs(p, cfg, _t(toks), _t(img))
    assert n == ref_n == cfg.img_tokens and x.dtype == torch.bfloat16
    pj = p["projector"]
    img_t = _t(img)
    want = (img_t @ pj["w"].float() + pj["b"].float()).to(torch.bfloat16)
    assert torch.equal(x[:, :n], want)
    got = x[:, :n].float().numpy()
    ref = np.asarray(ref_x[:, :n].astype(jnp.float32))
    ulp = np.abs(ref) * 2.0 ** -7 + 1e-30
    assert (np.abs(got - ref) <= ulp).all()
    down = (img_t.to(torch.bfloat16) @ pj["w"] + pj["b"]).float()
    assert not torch.equal(down, x[:, :n].float())


def test_iid_codebook_labels_shift_along_the_codebook_axis():
    """The reference's finding, kept: for a (T, K, B, S, nq) block the
    ``iid`` stream shifts labels along the last axis, the codebook axis
    (``labels[..., s, q] = tokens[..., s, q + 1]``, the last codebook
    always 0), not along the sequence.  The port's block means the same
    as the reference's (ROADMAP.md queue 3)."""
    cfg = get_config("musicgen-medium").smoke
    nq = cfg.num_codebooks
    provider = pipe.make_block_provider("iid", cfg, num_agents=2,
                                        local_steps=2, batch=1, seq=6,
                                        device="cpu")
    blk = provider(0, torch.Generator().manual_seed(0))
    tok, lab = blk["tokens"], blk["labels"]
    assert tuple(tok.shape) == (2, 2, 1, 6, nq)
    assert torch.equal(lab[..., :-1], tok[..., 1:])
    assert bool((lab[..., -1] == 0).all())
    assert not torch.equal(lab[..., :-1, :], tok[..., 1:, :])
    ref = jax.device_get(ref_lm_batch(jax.random.PRNGKey(0), (2, 2, 1, 6, nq),
                                      cfg.vocab_size))
    np.testing.assert_array_equal(ref["labels"][..., :-1],
                                  ref["tokens"][..., 1:])
    assert (ref["labels"][..., -1] == 0).all()


def test_serve_cache_holds_the_image_prefix():
    """The reference's serve sizes the cache ``prompt_len + decode``
    (``repro/launch/serve.py:207``): prefill then makes a ring of exactly
    ``img_tokens + prompt_len`` slots, each decoded token overwrites the
    oldest image position, and decode drifts from the uncached forward.
    The port's serve sizes it ``img_tokens + prompt_len + decode``, and
    decode stays within the 5e-3 gate."""
    ref_cfg, cfg = _configs("llava-next-mistral-7b")
    ref_p, p = _params(ref_cfg)
    n_dec, s = 8, 16
    toks, img = _inputs(cfg, s=s + n_dec, seed=9)
    P = cfg.img_tokens
    full, _, _ = ref_tf.forward(ref_p, ref_cfg, _j(toks), img_embeds=_j(img),
                                remat=False)
    full = np.asarray(full)

    def ref_drift(max_len):
        _, cache = ref_tf.prefill(ref_p, ref_cfg, _j(toks[:, :s]),
                                  img_embeds=_j(img), max_len=max_len)
        worst = 0.0
        for t in range(n_dec):
            lg, cache = ref_tf.decode_step(ref_p, ref_cfg, cache,
                                           _j(toks[:, s + t:s + t + 1]))
            worst = max(worst, float(np.abs(np.asarray(lg[:, 0])
                                            - full[:, P + s + t]).max()))
        return worst

    assert ref_drift(s + n_dec) > 0.1                  # the reference's
    assert ref_drift(P + s + n_dec) <= DECODE_TOL      # sized for the prefix
    argv = ["--device", "cpu", "--arch", "llava-next-mistral-7b", "--smoke",
            "--batch", "2", "--prompt-len", str(s), "--decode",
            str(n_dec), "--temperature", "0"]
    out = serve.main(argv)
    assert out["max_len"] == P + s + n_dec
    with torch.no_grad():
        _, cache = tf.prefill(p, cfg, _t(toks[:, :s]), img_embeds=_t(img),
                              max_len=out["max_len"])
        assert cache.slot_pos.shape[0] == P + s + n_dec
        for t in range(n_dec):
            lg, cache = tf.decode_step(p, cfg, cache,
                                       _t(toks[:, s + t:s + t + 1]))
            np.testing.assert_allclose(lg[:, 0].numpy(), full[:, P + s + t],
                                       atol=DECODE_TOL, rtol=DECODE_TOL)
