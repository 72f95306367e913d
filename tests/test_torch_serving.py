"""Port parity: the continuous-batching ServeLoop and the per-slot cache.

``repro_torch.launch.serving`` against ``repro.launch.serving`` and
``tests/test_serving.py``'s gates: the loop emits, for every request, the
tokens single-request serving gives (``fused`` and ``py``; smollm and
musicgen's codebooks), the tokens the reference's loop emits on the same
weights, every completion replays under its recorded generations through
swaps under load, the per-slot cache and its decode equal the reference's
``init_cache(per_slot=True)`` on attention, mamba, MoE and sliding-window
segments, and ``serve --watch`` serves over a directory of checkpoints."""
import dataclasses
import shutil

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import serving as ref_serving  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve, serving, train  # noqa: E402
from repro_torch.launch.serving import (Completion, Request,  # noqa: E402
                                        ServeLoop, replay_completion)
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

DECODE_TOL = 5e-3


def _configs(arch, **changes):
    ref_cfg = dataclasses.replace(ref_get_config(arch).smoke, **changes)
    cfg = dataclasses.replace(get_config(arch).smoke, **changes)
    return ref_cfg, cfg


def _params(ref_cfg, seed=0):
    ref_p = ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref_p, params_from_jax(jax.device_get(ref_p), device="cpu")


def _requests(cfg, n, *, lengths, new, seed):
    rng = np.random.default_rng(seed)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    return [Request(uid=i, max_new_tokens=new(i),
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=(lengths(i),) + cb
                                        ).astype(np.int32))
            for i in range(n)]


def _drain(loop, reqs):
    for r in reqs:
        loop.submit(r)
    done = []
    while loop._queue or loop.active:
        done.extend(loop.step())
    assert sorted(c.uid for c in done) == [r.uid for r in reqs]
    return sorted(done, key=lambda c: c.uid)


def _single_request(cfg, params, prompt, n, max_len):
    with torch.no_grad():
        logits, cache = tf.prefill(params, cfg,
                                   torch.from_numpy(prompt)[None],
                                   max_len=max_len)
        toks, _, _ = tf.decode_loop(params, cfg, cache, logits[:, -1], None,
                                    n, temperature=0.0)
    return toks[0].numpy()


@pytest.mark.parametrize("decode_loop", ["fused", "py"])
@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-medium"])
def test_serveloop_matches_single_request(arch, decode_loop):
    """tests/test_serving.py's gate: more requests than slots, ragged
    prompt lengths, slot reuse after retirement; every request gets exactly
    the tokens it would get served alone."""
    _, cfg = _configs(arch)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    max_len = 48
    loop = ServeLoop(cfg, params, slots=2, max_len=max_len,
                     decode_loop=decode_loop, chunk=3)
    reqs = _requests(cfg, 5, lengths=lambda i: 7 + 2 * i,
                     new=lambda i: 6 + (i % 3), seed=5)
    for c in _drain(loop, reqs):
        want = _single_request(cfg, params, reqs[c.uid].prompt,
                               reqs[c.uid].max_new_tokens, max_len)
        np.testing.assert_array_equal(np.asarray(c.tokens), want)
        assert c.generations == [0] * len(c.tokens)


@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-medium"])
def test_serveloop_matches_the_reference_loop(arch):
    """The reference's ServeLoop and the port's on the same weights and
    requests (3 slots, chunk 4): the same completions, token for token."""
    ref_cfg, cfg = _configs(arch)
    ref_p, p = _params(ref_cfg, seed=1)
    reqs = _requests(cfg, 5, lengths=lambda i: 5 + 3 * i,
                     new=lambda i: 5 + (i % 4), seed=8)
    ref_loop = ref_serving.ServeLoop(ref_cfg, ref_p, slots=3, max_len=40,
                                     chunk=4)
    ref_done = []
    for r in reqs:
        ref_loop.submit(ref_serving.Request(r.uid, r.prompt,
                                            r.max_new_tokens))
    while ref_loop._queue or ref_loop.active:
        ref_done.extend(ref_loop.step())
    loop = ServeLoop(cfg, p, slots=3, max_len=40, chunk=4)
    got = _drain(loop, reqs)
    ref_done = sorted(ref_done, key=lambda c: c.uid)
    for a, b in zip(got, ref_done):
        np.testing.assert_array_equal(np.asarray(a.tokens),
                                      np.asarray(b.tokens))
        assert a.generations == list(b.generations)


@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-medium"])
def test_serveloop_swap_under_load_replay(arch):
    """>= 8 double-buffered swaps while decodes are in flight: every
    emitted token replays exactly under its recorded generation (no torn
    update), and completions span generations."""
    _, cfg = _configs(arch)
    params = tf.init_params(torch.Generator().manual_seed(1), cfg)
    loop = ServeLoop(cfg, params, slots=2, max_len=48, chunk=2)
    reqs = _requests(cfg, 4, lengths=lambda i: 8 + i, new=lambda i: 10,
                     seed=6)
    for r in reqs:
        loop.submit(r)
    params_by_gen, done = {0: params}, []
    while loop._queue or loop.active:
        done.extend(loop.step())
        g = loop.store.generation + 1
        newp = tree_map(lambda x, s=g: x * (1.0 + 0.03 * s), params)
        params_by_gen[loop.store.swap(newp)] = newp
    assert loop.store.generation >= 8
    assert len(done) == len(reqs)
    spans = [replay_completion(cfg, params_by_gen, c, max_len=48)
             for c in done]
    assert max(spans) > 1                       # swaps landed mid-request
    # at the loop's width: the request in every row of a 2-row cache
    for c in done:
        replay_completion(cfg, params_by_gen, c, max_len=48, slots=2)


def test_replay_catches_a_mis_tagged_generation():
    """A completion tagged with the wrong generation (or a wrong token)
    fails the replay."""
    _, cfg = _configs("smollm-360m")
    params = tf.init_params(torch.Generator().manual_seed(2), cfg)
    other = tree_map(lambda x: x * 1.5, params)
    prompt = np.arange(6, dtype=np.int32)
    toks = _single_request(cfg, params, prompt, 5, 16).tolist()
    good = Completion(0, prompt, toks, [0] * 5)
    assert replay_completion(cfg, {0: params, 1: other}, good,
                             max_len=16) == 1
    bad = Completion(0, prompt, toks, [1] * 5)
    with pytest.raises(AssertionError, match="torn or mis-tagged"):
        replay_completion(cfg, {0: params, 1: other}, bad, max_len=16)


def test_sampled_fused_and_py_agree_under_one_seed():
    """At temperature 0.8 both chunk loops draw from the loop's one
    generator in the same order: the same tokens for the same seed, and
    a different seed gives others."""
    _, cfg = _configs("musicgen-medium")
    params = tf.init_params(torch.Generator().manual_seed(3), cfg)
    reqs = _requests(cfg, 3, lengths=lambda i: 6 + i, new=lambda i: 7,
                     seed=9)
    runs = [_drain(ServeLoop(cfg, params, slots=2, max_len=32, chunk=3,
                             decode_loop=mode, temperature=0.8, seed=seed),
                   reqs)
            for mode, seed in (("fused", 4), ("py", 4), ("fused", 5))]
    for a, b in zip(runs[0], runs[1]):
        assert a.tokens == b.tokens
    assert [c.tokens for c in runs[0]] != [c.tokens for c in runs[2]]


def test_serveloop_guards():
    _, cfg = _configs("smollm-360m")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="decode_loop"):
        ServeLoop(cfg, params, decode_loop="scan")
    loop = ServeLoop(cfg, params, slots=2, max_len=16)
    with pytest.raises(ValueError, match="max_len=16"):
        loop.submit(Request(0, np.zeros(10, np.int32), 7))
    assert loop.step() == [] and loop.run() == []


# ---------------------------------------------------------------------------
# the per-slot cache
# ---------------------------------------------------------------------------

_PER_SLOT = [("smollm-360m", {}), ("zamba2-1.2b", {}),
             ("granite-moe-1b-a400m", {"capacity_factor": 4.0}),
             ("starcoder2-15b", {"attention_window": 8}),
             ("musicgen-medium", {})]


@pytest.mark.parametrize("arch,changes", _PER_SLOT,
                         ids=[a for a, _ in _PER_SLOT])
def test_per_slot_cache_matches_the_reference(arch, changes):
    """Three rows at their own positions (batch-1 prefills of lengths 5,
    9, 12 written into their slots), then 6 decode steps of the whole
    batch: the per-slot ``pos``/``slot_pos`` and every step's logits equal
    the reference's ``init_cache(per_slot=True)`` and ``decode_step``
    (attention and mamba segments, a MoE block, a sliding window that
    wraps the ring), and each row tracks the uncached forward of its own
    sequence."""
    ref_cfg, cfg = _configs(arch, **changes)
    ref_p, p = _params(ref_cfg, seed=4)
    lengths, n_dec, max_len = (5, 9, 12), 6, 20
    rng = np.random.default_rng(12)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    seqs = [rng.integers(0, cfg.vocab_size, (n + n_dec,) + cb).astype(
        np.int32) for n in lengths]
    ref_big = ref_tf.init_cache(ref_cfg, len(lengths), max_len,
                                per_slot=True)
    big = tf.init_cache(cfg, len(lengths), max_len, per_slot=True,
                        device="cpu")
    assert big.per_slot and tuple(big.pos.shape) == (3,)
    assert tuple(big.slot_pos.shape) == tuple(ref_big.slot_pos.shape)
    with torch.no_grad():
        for s, (n, seq) in enumerate(zip(lengths, seqs)):
            _, small = ref_tf.prefill(ref_p, ref_cfg, jnp.asarray(seq[:n])[None],
                                      max_len=max_len)
            ref_big = ref_serving._write_slot(ref_big, small, s)
            _, small = tf.prefill(p, cfg, torch.from_numpy(seq[:n])[None],
                                  max_len=max_len)
            serving._write_slot(big, small, s)
        for t in range(n_dec):
            col = np.stack([seq[n + t] for n, seq in zip(lengths, seqs)])
            ref_lg, ref_big = ref_tf.decode_step(ref_p, ref_cfg, ref_big,
                                                 jnp.asarray(col)[:, None])
            lg, big = tf.decode_step(p, cfg, big,
                                     torch.from_numpy(col)[:, None])
            np.testing.assert_array_equal(big.pos.numpy(),
                                          np.asarray(ref_big.pos))
            np.testing.assert_array_equal(big.slot_pos.numpy(),
                                          np.asarray(ref_big.slot_pos))
            np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg),
                                       atol=2e-3, rtol=0)
            for r, (n, seq) in enumerate(zip(lengths, seqs)):
                if cfg.num_experts:
                    continue    # capacity comes from the batch's tokens
                full, _, _ = tf.forward(
                    p, cfg, torch.from_numpy(seq[:n + t + 1])[None],
                    remat=False)
                np.testing.assert_allclose(lg[r, 0].numpy(),
                                           full[0, -1].numpy(),
                                           atol=DECODE_TOL, rtol=DECODE_TOL)


def test_whole_batch_cache_is_unchanged():
    """The whole-batch layout every earlier path runs: ``pos`` an int,
    ``slot_pos`` (C,), one position for every row."""
    _, cfg = _configs("smollm-360m")
    cache = tf.init_cache(cfg, 2, 10, device="cpu")
    assert cache.pos == 0 and not cache.per_slot
    assert tuple(cache.slot_pos.shape) == (10,)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        _, cache = tf.prefill(params, cfg, torch.zeros((2, 4), dtype=torch.int32),
                              max_len=10)
        _, cache = tf.decode_step(params, cfg, cache,
                                  torch.zeros((2, 1), dtype=torch.int32))
    assert cache.pos == 5 and isinstance(cache.pos, int)
    assert cache.slot_pos.tolist() == [0, 1, 2, 3, 4, -1, -1, -1, -1, -1]


# ---------------------------------------------------------------------------
# watch mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_checkpoints(tmp_path_factory):
    """Two spec checkpoints of musicgen smoke training (1 and 2 blocks)."""
    root = tmp_path_factory.mktemp("watch")
    paths = []
    for blocks in (1, 2):
        path = str(root / f"train{blocks}.npz")
        train.main(["--device", "cpu", "--arch", "musicgen-medium",
                    "--smoke", "--blocks", str(blocks), "--seq", "16",
                    "--mix", "pallas", "--checkpoint", path])
        paths.append(path)
    return paths


def test_serve_watch_over_two_checkpoints(two_checkpoints, tmp_path, capsys):
    """``serve --watch DIR``: both checkpoints ingested (generations 1 and
    2), every request completed under them, and each completion replays
    under the generations it recorded."""
    for p in two_checkpoints:
        shutil.copy(p, tmp_path)
    out = serve.main(["--device", "cpu", "--arch", "musicgen-medium",
                      "--smoke", "--watch", str(tmp_path), "--watch-ticks",
                      "6", "--watch-poll", "0", "--batch", "2",
                      "--prompt-len", "8", "--decode", "6",
                      "--temperature", "0"])
    printed = capsys.readouterr().out
    assert "train1.npz -> generation 1" in printed
    assert "train2.npz -> generation 2" in printed
    loop, done = out["loop"], out["completions"]
    assert loop.store.generation == 2
    assert sorted(c.uid for c in done) == [0, 1]
    assert all(len(c.tokens) == 6 and len(c.tokens[0]) == 4 for c in done)
    params_by_gen = {g: serving.load_consensus(p, device="cpu")[0]
                     for g, p in enumerate(two_checkpoints, start=1)}
    for c in done:
        assert set(c.generations) <= {1, 2}
        replay_completion(out["cfg"], params_by_gen, c,
                          max_len=loop.max_len)


def test_load_consensus_refuses_spec_less_and_external(two_checkpoints,
                                                       tmp_path):
    params, cfg, meta = serving.load_consensus(two_checkpoints[1],
                                               device="cpu")
    assert cfg.name == "musicgen-smoke" and meta["step"] == 2
    assert tuple(params["embed"].shape) == (4, 128, 128)
    plain = str(tmp_path / "plain.npz")
    save_checkpoint(plain, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="not a spec-embedding"):
        serving.load_consensus(plain, device="cpu")
    ext = str(tmp_path / "ext.npz")
    from repro_torch.api.spec import ExperimentSpec
    save_checkpoint(ext, {"w": torch.zeros(2)},
                    metadata={"spec": ExperimentSpec().to_json()})
    with pytest.raises(ValueError, match="external"):
        serving.load_consensus(ext, device="cpu")
