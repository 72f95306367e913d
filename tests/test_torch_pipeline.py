"""Port parity: the partitioned data pipeline (``repro_torch.data.pipeline``
against ``repro.data.pipeline`` and the block providers of
``repro.api.build``), ``partition_regression_data``, and the train
driver's data flags.

Everything but the last step is host numpy drawn in the reference's order,
so partitions, corpora and blocks are held bit-equal, including a block
re-derived from its index after a "resume".  The iid provider draws from
the port's own host generator and is held by law."""
import argparse
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.api.build import (  # noqa: E402
    make_block_provider as ref_make_block_provider,
    train_block_struct as ref_train_block_struct)
from repro.api.spec import DataSpec, ExperimentSpec, RunSpec  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import pipeline as ref_pipe  # noqa: E402
from repro.data import synthetic as ref_syn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.launch import train  # noqa: E402


def _equal_parts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("K,alpha,seed,n,classes", [
    (4, 1.0, 0, 200, 4), (8, 0.3, 1, 63, 4), (5, 100.0, 2, 500, 10),
    (12, 0.05, 3, 40, 2), (3, 0.5, 7, 1000, 1)])
def test_dirichlet_partition_equals_the_reference(K, alpha, seed, n,
                                                  classes):
    labels = (np.arange(n) * classes) // n
    _equal_parts(pipe.dirichlet_partition(labels, K, alpha, seed=seed),
                 ref_pipe.dirichlet_partition(labels, K, alpha, seed=seed))


@pytest.mark.parametrize("min_per_agent", [1, 3, 6])
def test_dirichlet_min_per_agent_steals_as_the_reference(min_per_agent):
    """A tiny alpha leaves agents empty; each in turn then takes the last
    index of the largest until it holds ``min_per_agent`` (a later turn
    may take from an earlier agent, as in the reference)."""
    labels = np.repeat(np.arange(3), 10)
    got = pipe.dirichlet_partition(labels, 6, 0.01, seed=5,
                                   min_per_agent=min_per_agent)
    _equal_parts(got, ref_pipe.dirichlet_partition(
        labels, 6, 0.01, seed=5, min_per_agent=min_per_agent))
    assert len(got[-1]) >= min_per_agent and min(len(p) for p in got) > 0
    assert sorted(np.concatenate(got).tolist()) == list(range(30))


@pytest.mark.parametrize("n,K", [(10, 3), (63, 8), (7, 7), (1000, 16)])
def test_contiguous_partition_equals_the_reference(n, K):
    _equal_parts(pipe.contiguous_partition(n, K),
                 ref_pipe.contiguous_partition(n, K))


@pytest.mark.parametrize("vocab,n,seq,seed", [
    (49152, 65536, 1024, 0), (512, 4096, 64, 3), (100, 1000, 7, 1)])
def test_token_dataset_synthetic_equals_the_reference(vocab, n, seq, seed):
    ds = pipe.TokenDataset.synthetic(vocab, n, seq, seed=seed)
    ref = ref_pipe.TokenDataset.synthetic(vocab, n, seq, seed=seed)
    assert ds.tokens.dtype == np.int32 and ds.seq_len == ref.seq_len
    np.testing.assert_array_equal(ds.tokens, ref.tokens)
    assert ds.num_windows == ref.num_windows
    for i in (0, ds.num_windows // 2, ds.num_windows - 1):
        for a, b in zip(ds.window(i), ref.window(i)):
            np.testing.assert_array_equal(a, b)


def _iterators(T, B, seed, K=5, seq=32):
    ds = pipe.TokenDataset.synthetic(1000, 20000, seq, seed=seed)
    ref_ds = ref_pipe.TokenDataset.synthetic(1000, 20000, seq, seed=seed)
    labels = (np.arange(ds.num_windows) * 3) // ds.num_windows
    parts = pipe.dirichlet_partition(labels, K, 0.5, seed=seed)
    port = pipe.BlockIterator(ds, parts, local_steps=T, per_agent_batch=B,
                              seed=seed, device="cpu")
    ref = ref_pipe.BlockIterator(ref_ds, parts, local_steps=T,
                                 per_agent_batch=B, seed=seed)
    return port, ref


@pytest.mark.parametrize("T,B,seed", [(1, 1, 0), (2, 3, 4), (3, 2, 9)])
def test_block_iterator_equals_the_reference(T, B, seed):
    port, ref = _iterators(T, B, seed)
    assert port.num_agents == ref.num_agents
    for i in (0, 1, 17, 10_000):
        got, want = port.block(i), ref.block(i)
        for name in ("tokens", "labels"):
            assert got[name].dtype == torch.int32
            assert got[name].device.type == "cpu"
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
        draw = port.windows(i)                 # (K, T, B) window indices
        for k, part in enumerate(port.parts):
            assert np.isin(draw[k], part).all()


def test_block_iterator_replays_a_block_after_resume():
    """Iteration from 0, then a fresh iterator (a resume) asked for block
    3 alone: bit-equal, and equal to the reference's 4th block."""
    port, ref = _iterators(2, 2, 1)
    it = iter(port)
    first = [next(it) for _ in range(4)]
    again, _ = _iterators(2, 2, 1)
    resumed = again.block(3)
    ref_it = iter(ref)
    ref_blocks = [next(ref_it) for _ in range(4)]
    for name in ("tokens", "labels"):
        assert torch.equal(resumed[name], first[3][name])
        np.testing.assert_array_equal(resumed[name].numpy(),
                                      np.asarray(ref_blocks[3][name]))
    assert not torch.equal(first[2]["tokens"], first[3]["tokens"])


def test_block_iterator_guards_and_device():
    ds = pipe.TokenDataset.synthetic(100, 1000, 8)
    with pytest.raises(ValueError, match="at least one window"):
        pipe.BlockIterator(ds, [np.arange(3), np.array([], np.int64)],
                           local_steps=1, per_agent_batch=1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipe.BlockIterator(ds, [np.arange(3)], local_steps=1,
                               per_agent_batch=1)


@pytest.mark.parametrize("kind,kw", [
    ("dirichlet", {"alpha": 0.3}), ("dirichlet", {"alpha": 50.0}),
    ("shards", {"shards_per_agent": 1}), ("shards", {"shards_per_agent": 3}),
    ("iid", {}), ("iid", {"samples_per_agent": 37})])
def test_partition_regression_data_equals_the_reference(kind, kw):
    data = syn.make_regression_problem(K=6, N=30, M=3, seed=2,
                                       w_star_spread=0.5)
    ref_data = ref_syn.make_regression_problem(K=6, N=30, M=3, seed=2,
                                               w_star_spread=0.5)
    got = syn.partition_regression_data(data, 8, kind=kind, seed=4, **kw)
    want = ref_syn.partition_regression_data(ref_data, 8, kind=kind, seed=4,
                                             **kw)
    for name in ("U", "d", "w_star", "noise_std"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))
    assert got.rho == want.rho and got.num_agents == 8
    with pytest.raises(ValueError, match="unknown data kind"):
        syn.partition_regression_data(data, 8, kind="zipf")


# ---------------------------------------------------------------------------
# the block providers
# ---------------------------------------------------------------------------

def _ref_provider(kind, K, T, B, S, **dkw):
    spec = ExperimentSpec(
        data=DataSpec(kind=kind, **dkw),
        run=RunSpec(num_agents=K, local_steps=T, batch=B, seq=S))
    cfg = ref_get_config("smollm-360m").smoke
    return ref_make_block_provider(spec, cfg)


@pytest.mark.parametrize("kind,dkw", [
    ("dirichlet", dict(alpha=0.3, clusters=4, seed=0)),
    ("dirichlet", dict(alpha=2.0, clusters=7, seed=5,
                       corpus_tokens=20000)),
    ("shards", dict(shards_per_agent=2, seed=0)),
    ("shards", dict(shards_per_agent=1, seed=3, corpus_tokens=9000))])
def test_partitioned_providers_equal_the_reference(kind, dkw):
    K, T, B, S = 6, 2, 2, 64
    ref = _ref_provider(kind, K, T, B, S, **dkw)
    port = pipe.make_block_provider(
        kind, get_config("smollm-360m").smoke, num_agents=K, local_steps=T,
        batch=B, seq=S, device="cpu", **dkw)
    _equal_parts(port.partitions, ref.partitions)
    for i in (0, 3, 250):
        got, want = port(i, None), ref(i, jax.random.PRNGKey(i))
        assert set(got) == set(want) == {"tokens", "labels"}
        for name in got:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))


def test_iid_provider_by_law():
    """Fresh uniform tokens from the host generator each block (the index
    is ignored), labels shifted by one: the reference's stream follows
    JAX keys, so this is held by law."""
    cfg = dataclasses.replace(get_config("smollm-360m").smoke,
                              vocab_size=50)
    prov = pipe.make_block_provider("iid", cfg, num_agents=4, local_steps=2,
                                    batch=8, seq=256, device="cpu")
    key = torch.Generator().manual_seed(0)
    a, b = prov(0, key), prov(0, key)
    assert a["tokens"].shape == (2, 4, 8, 256)
    assert a["tokens"].dtype == torch.int32
    assert not torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"][..., :-1], a["tokens"][..., 1:])
    assert not a["labels"][..., -1].any()
    counts = torch.bincount(torch.cat([a["tokens"], b["tokens"]]).reshape(-1)
                            .long(), minlength=50).double()
    expected = counts.sum() / 50
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert counts.numel() == 50 and chi2 < 49 + 6 * np.sqrt(2 * 49)
    again = pipe.make_block_provider("iid", cfg, num_agents=4,
                                     local_steps=2, batch=8, seq=256,
                                     device="cpu")
    assert torch.equal(again(5, torch.Generator().manual_seed(0))["tokens"],
                       a["tokens"])


def test_train_block_struct_matches_the_reference():
    for arch in ("smollm-360m", "mamba2-2.7b"):
        cfg = get_config(arch).smoke
        ref_cfg = ref_get_config(arch).smoke
        got = pipe.train_block_struct(cfg, T=2, K=3, batch=4, seq=16)
        want = ref_train_block_struct(ref_cfg, T=2, K=3, batch=4,
                                            seq=16)
        assert set(got) == set(want)
        for name, (shape, dtype) in got.items():
            assert shape == want[name].shape and dtype == torch.int32
    cfg = dataclasses.replace(get_config("smollm-360m").smoke,
                              num_codebooks=4, img_tokens=3)
    got = pipe.train_block_struct(cfg, T=1, K=2, batch=1, seq=8)
    assert got["tokens"][0] == (1, 2, 1, 8, 4)
    assert got["img_embeds"][0] == (1, 2, 1, 3, pipe.VISION_DIM)
    # the image-prefix archs are not ported: their providers say so
    img = dataclasses.replace(get_config("smollm-360m").smoke, img_tokens=3)
    for kind in pipe.DATA_KINDS:
        with pytest.raises(NotImplementedError, match="item 17"):
            pipe.make_block_provider(kind, img, num_agents=4, local_steps=1,
                                     batch=1, seq=64, device="cpu")


@pytest.mark.parametrize("kind,kw,match", [
    ("dirichlet", dict(corpus_tokens=200), "cannot cover"),
    ("shards", dict(corpus_tokens=200, shards_per_agent=2), "cannot cover"),
    ("shards", dict(shards_per_agent=1, corpus_tokens=65536,
                    codebooks=4), "codebook"),
    ("dirichlet", dict(codebooks=2), "codebook"),
    ("zipf", {}, "unknown data kind")])
def test_provider_guards(kind, kw, match):
    cfg = get_config("smollm-360m").smoke
    codebooks = kw.pop("codebooks", 0)
    if codebooks:
        cfg = dataclasses.replace(cfg, num_codebooks=codebooks)
    with pytest.raises(ValueError, match=match):
        pipe.make_block_provider(kind, cfg, num_agents=8, local_steps=1,
                                 batch=1, seq=64, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the train driver's data flags
# ---------------------------------------------------------------------------

_ARGV = ["--device", "cpu", "--agents", "4", "--blocks", "2", "--batch", "1",
         "--seq", "16", "--optimizer", "sgd", "--step-size", "0.05"]


@pytest.mark.parametrize("flags,kind", [
    (["--data-alpha", "0.5"], "iid"), (["--data-clusters", "3"], "shards"),
    (["--data-shards", "2"], "dirichlet"),
    (["--data-corpus-tokens", "5000"], "iid")])
def test_data_subflags_with_the_wrong_kind_raise(flags, kind):
    with pytest.raises(ValueError, match="only applies to --data"):
        train.main(_ARGV + ["--data", kind] + flags)


@pytest.mark.parametrize("flags", [
    ["--data", "dirichlet", "--data-alpha", "0.3", "--data-clusters", "4",
     "--data-seed", "2", "--data-corpus-tokens", "8192"],
    ["--data", "shards", "--data-shards", "2", "--data-seed", "1"]])
def test_train_feeds_the_partitioned_blocks(flags, capsys):
    out = train.main(_ARGV + flags)
    assert f"data: {flags[1]} partition over 4 agents" in \
        capsys.readouterr().out
    prov = out["provider"]
    ref_kind = flags[1]
    dkw = ({"alpha": 0.3, "clusters": 4, "seed": 2, "corpus_tokens": 8192}
           if ref_kind == "dirichlet" else {"shards_per_agent": 2,
                                            "seed": 1})
    ref = _ref_provider(ref_kind, 4, 2, 1, 16, **dkw)
    for i in range(out["blocks_done"]):
        np.testing.assert_array_equal(
            prov(i, None)["tokens"].numpy(),
            np.asarray(ref(i, jax.random.PRNGKey(0))["tokens"]))
    _equal_parts(prov.partitions, ref.partitions)
    assert out["blocks_done"] == 2
    assert all(np.isfinite(x) for row in out["losses"] for x in row)


def test_data_flags_parse_as_the_reference():
    from repro.api.cli import add_spec_args
    ap = argparse.ArgumentParser()
    add_spec_args(ap)
    ref = vars(ap.parse_args([]))
    args = train._parser().parse_args([])
    train.check_data_flags(args)
    for dest in list(train._DATA_FLAGS) + ["data", "data_seed"]:
        assert getattr(args, dest) == ref[dest], dest
    assert tuple(pipe.DATA_KINDS) == ("iid", "dirichlet", "shards")
