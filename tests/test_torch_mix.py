"""Port parity: the eq.-20 mix kernel's plain version, the mixers and the
consensus extraction (``repro_torch`` against ``repro``), plus the compiled
kernel against its plain version where a CUDA card is present."""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import make_topology as ref_make_topology  # noqa: E402
from repro.core.mixing import PallasFusedMixer as RefPallasMixer  # noqa: E402
from repro.core.mixing import make_mixer as ref_make_mixer  # noqa: E402
from repro.core.serving import consensus_from_stacked as ref_consensus  # noqa: E402
from repro.kernels.diffusion_mix import diffusion_mix as ref_diffusion_mix  # noqa: E402
from repro.kernels.ops import mix_op as ref_mix_op  # noqa: E402
from repro_torch.core import mixing  # noqa: E402
from repro_torch.core.serving import ParamStore, consensus_from_stacked  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.kernels import diffusion_mix as dm  # noqa: E402
from repro_torch.kernels.ops import mix_op  # noqa: E402
from repro_torch.kernels.ref import mix_ref  # noqa: E402
from repro_torch.models.convert import to_numpy  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

BF16_RTOL = 2.0 ** -7     # one bf16 ulp, relative


def _mask(rng, K):
    return (rng.random(K) < 0.6).astype(np.float32)


@pytest.mark.parametrize("K", [4, 12, 20])
def test_mix_ref_matches_pallas_kernel(K):
    rng = np.random.default_rng(K)
    A = ref_make_topology("ring", K).A.astype(np.float32)
    for m in (np.zeros(K, np.float32), np.ones(K, np.float32), _mask(rng, K)):
        W = rng.standard_normal((K, 256)).astype(np.float32)
        want = np.asarray(ref_diffusion_mix(jnp.asarray(A), jnp.asarray(m),
                                            jnp.asarray(W), tile_m=128,
                                            interpret=True))
        got = mix_ref(torch.from_numpy(A), torch.from_numpy(m),
                      torch.from_numpy(W))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        # a CPU tensor takes the plain version through the wrapper
        cpu = dm.diffusion_mix(torch.from_numpy(A), torch.from_numpy(m),
                               torch.from_numpy(W))
        np.testing.assert_array_equal(cpu.numpy(), got.numpy())


@pytest.mark.parametrize("K,topo", [(6, "ring"), (8, "erdos")])
def test_mix_op_matches_dense_and_the_reference(monkeypatch, K, topo):
    """``mix_op`` over a tree of mixed dtypes, tiles splitting leaves:
    the dense mixer on the eq.-20 matrix, and the reference's ``mix_op``
    (its Pallas kernel in interpret mode), within one float32 summation
    bound and one bf16 ulp; inactive agents bit-equal; one plain-version
    call a tile and never a kernel launch on the CPU."""
    rng = np.random.default_rng(K)
    A = ref_make_topology(topo, K).A.astype(np.float32)
    m = np.array([1, 0] * (K // 2), np.float32)
    tree = {"a": rng.standard_normal((K, 5, 7)).astype(np.float32),
            "b": rng.standard_normal((K, 33)).astype(np.float32),
            "c": rng.standard_normal((K, 3, 3)).astype(np.float32)}
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": torch.from_numpy(tree["b"]).to(torch.bfloat16),
             "c": torch.from_numpy(tree["c"]).double()}
    jtree = {"a": jnp.asarray(tree["a"]),
             "b": jnp.asarray(tree["b"]).astype(jnp.bfloat16),
             "c": jnp.asarray(tree["c"], jnp.float32)}
    monkeypatch.setattr(mixing, "TILE_ELEMS", K * 16)   # 16-column tiles
    calls = []
    monkeypatch.setattr(dm, "mix_ref", lambda *a: calls.append(1)
                        or mix_ref(*a))
    before = dm.diffusion_mix.launches
    got = mix_op(torch.from_numpy(A), torch.from_numpy(m), ttree)
    assert dm.diffusion_mix.launches == before
    assert len(calls) == mixing.num_tiles(K, 35 + 33 + 9) > 1
    want = ref_mix_op(jnp.asarray(A), jnp.asarray(m), jtree, tile_m=128,
                      interpret=True)
    dense = mixing.DenseMixer()(
        {k: v.double() for k, v in ttree.items()}, torch.from_numpy(m),
        torch.from_numpy(A).double())
    for k in tree:
        assert got[k].dtype == ttree[k].dtype and got[k].shape == \
            ttree[k].shape
        g = got[k].double().numpy()
        if k == "b":           # rounded to bf16 once: one bf16 ulp
            rtol, atol = BF16_RTOL, 1e-6
        else:
            rtol, atol = 0, 1e-6
        np.testing.assert_allclose(g, dense[k].numpy(), rtol=rtol, atol=atol)
        np.testing.assert_allclose(g, np.asarray(want[k], np.float64),
                                   rtol=rtol, atol=atol)
        assert torch.equal(got[k][m == 0], ttree[k][m == 0])


def test_kernel_operand_checks():
    K = 4
    A, m = torch.eye(K), torch.ones(K)
    dm.check_operands(A, m, torch.zeros(K, 7))
    with pytest.raises(ValueError, match="limit"):
        big = dm.MAX_AGENTS + 1
        dm.check_operands(torch.eye(big), torch.ones(big),
                          torch.zeros(big, 3))
    with pytest.raises(ValueError, match="float32"):
        dm.check_operands(A, m, torch.zeros(K, 7, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        dm.check_operands(A, m, torch.zeros(7, K).T)
    with pytest.raises(ValueError, match="must be"):
        dm.check_operands(torch.eye(K + 1), m, torch.zeros(K, 7))
    assert dm.MAX_AGENTS >= 64
    assert (dm.MAX_AGENTS ** 2 + dm.MAX_AGENTS) * 4 <= 232_448


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler, no kernel: the build raises instead of falling back."""
    from pathlib import Path

    from repro_torch.kernels import build
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has nvcc at its default path")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert (build.CSRC / "diffusion_mix.cu").is_file()


def _mixed_tree(rng, K):
    """Mixed-shape tree with float32 and bfloat16 leaves (numpy, jax)."""
    shapes = {"w": ((7, 3), jnp.float32), "b": ((5,), jnp.bfloat16),
              "s": ((2, 2, 2), jnp.float32), "e": ((33,), jnp.bfloat16)}
    tree = {k: jnp.asarray(rng.standard_normal((K,) + s), dt)
            for k, (s, dt) in shapes.items()}
    return tree


def _to_torch(tree):
    from repro_torch.models.convert import params_from_jax
    return params_from_jax(jax.device_get(tree), device="cpu")


def _assert_tree_close(got, want):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(g.float().numpy(),
                                       w.astype(np.float32),
                                       rtol=BF16_RTOL, atol=1e-6)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind,K", [("grid", 12)])
def test_mixers_match_reference_mixers(kind, K):
    """The port's pallas mixer (plain version on the CPU) against the
    reference's PallasFusedMixer in interpret mode, and dense against
    dense, on a mixed-shape tree with float32 and bfloat16 leaves."""
    rng = np.random.default_rng(K)
    A = jnp.asarray(ref_make_topology(kind, K).A, jnp.float32)
    pairs = {"pallas": RefPallasMixer(tile_m=128, interpret=True),
             "dense": ref_make_mixer("dense", num_agents=K)}
    for _ in range(2):
        tree = _mixed_tree(rng, K)
        m = _mask(rng, K)
        for name, ref_mixer in pairs.items():
            want = ref_mixer(tree, jnp.asarray(m), A)
            mixer = mixing.make_mixer(name, num_agents=K)
            assert mixer.name == name
            got = mixer(_to_torch(tree), torch.from_numpy(m),
                        torch.from_numpy(np.array(A)))
            _assert_tree_close(got, want)


def test_make_mixer_policy():
    topo = make_topology("fedavg", 8)
    assert isinstance(mixing.make_mixer("auto", topo, device="cpu"),
                      mixing.DenseMixer)
    assert isinstance(mixing.make_mixer("auto", topo, device="cuda"),
                      mixing.PallasFusedMixer)
    assert isinstance(mixing.make_mixer("dense", topo, num_agents=1),
                      mixing.NullMixer)
    assert isinstance(mixing.make_mixer("none", topo), mixing.NullMixer)
    # the reference picks the same non-TPU backend for fedavg
    assert type(ref_make_mixer("auto", ref_make_topology("fedavg", 8))
                ).__name__ == "DenseMixer"
    # every mixer kind of the reference builds, as the reference's does
    ring, ref_ring = make_topology("ring", 8), ref_make_topology("ring", 8)
    for name in ("sparse", "gather", "trimmed_mean", "median",
                 "adaptive_trim"):
        got = mixing.make_mixer(name, ring, device="cpu")
        assert type(got).__name__ == type(ref_make_mixer(name,
                                                         ref_ring)).__name__
    # auto on a sparse ring off CUDA resolves to sparse, as the reference's
    # non-TPU policy does
    assert isinstance(mixing.make_mixer("auto", ring, device="cpu"),
                      mixing.SparseCirculantMixer)
    with pytest.raises(ValueError, match="unknown mixer"):
        mixing.make_mixer("bogus", topo)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mix", ["dense", "pallas", "none", "auto"])
def test_consensus_matches_reference(mix, weighted):
    K = 4
    rng = np.random.default_rng(7)
    tree = {"a": jnp.asarray(rng.standard_normal((K, 6, 5)), jnp.float32),
            "n": {"b": jnp.asarray(rng.standard_normal((K, 11)),
                                   jnp.float32)}}
    weights = np.array([0.5, 0.0, 2.0, 1.0], np.float32) if weighted else None
    want = ref_consensus(tree, K, mix, weights=weights)
    got = consensus_from_stacked(_to_torch(tree), K, mix, weights=weights)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


def test_consensus_over_explicit_topology_and_state_dict():
    K = 6
    rng = np.random.default_rng(8)
    tree = {"a": jnp.asarray(rng.standard_normal((K, 9)), jnp.float32)}
    topo_ref = ref_make_topology("ring", K)
    want = ref_consensus(tree, K, "dense", topology=topo_ref)
    port = _to_torch(tree)
    got = consensus_from_stacked({"params": port, "opt_state": None}, K,
                                 "pallas", topology=make_topology("ring", K))
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               atol=1e-6, rtol=0)
    zero = consensus_from_stacked(port, K, "dense", weights=np.zeros(K))
    np.testing.assert_allclose(zero["a"].numpy(),
                               port["a"].mean(0).numpy(), atol=1e-6)


def _ring_stack(K, seed):
    rng = np.random.default_rng(seed)
    return {"a": jnp.asarray(rng.standard_normal((K, 6, 5)), jnp.float32),
            "b": jnp.asarray(rng.standard_normal((K, 11)), jnp.float32)}


@pytest.mark.parametrize("mix,scope", [("sparse", "global"),
                                       ("trimmed_mean", "neighborhood"),
                                       ("median", "neighborhood"),
                                       ("median", "global"),
                                       ("adaptive_trim", "neighborhood")])
def test_consensus_support_bound_and_robust_match_reference(mix, scope):
    """Over an explicit ring the sparse and neighborhood-robust mixers
    iterate the base matrix for the reference's number of rounds; the
    global robust ones apply once."""
    K = 6
    tree = _ring_stack(K, 11)
    want = ref_consensus(tree, K, mix, trim=1, scope=scope,
                         topology=ref_make_topology("ring", K))
    got = consensus_from_stacked(_to_torch(tree), K, mix, trim=1,
                                 scope=scope,
                                 topology=make_topology("ring", K))
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_consensus_rounds_follow_the_reference():
    from repro_torch.core.serving import consensus_rounds
    from repro_torch.core.topology import spectral_gap

    ring = make_topology("ring", 8)
    gap = spectral_gap(ring.A)
    needed = int(np.ceil(np.log(1e-7) / np.log(1.0 - gap)))
    nb = dict(trim=1, scope="neighborhood", device="cpu")
    for name, kw, want in (("dense", {}, 0), ("pallas", {}, 0),
                           ("sparse", {}, needed), ("gather", {}, needed),
                           ("trimmed_mean", nb, needed),
                           ("trimmed_mean", {"scope": "global"}, 1),
                           ("none", {}, 1)):
        assert consensus_rounds(mixing.make_mixer(name, ring, **kw),
                                gap) == want, name
    assert consensus_rounds(mixing.make_mixer("gather", ring), 1.0) == 1
    big = make_topology("ring", 1024)
    with pytest.warns(UserWarning, match="capped at 512"):
        assert consensus_rounds(mixing.make_mixer("sparse", big),
                                spectral_gap(big.A)) == 512


def test_gather_consensus_on_a_ring_is_the_mean():
    """The port's gather consensus iterates the base matrix and reaches the
    exact mean (what the reference's docstring promises).  The reference
    sends the gather mixer down its one-step averaging branch, which lies
    off the gather table's support: the value it returns is recorded here
    (ROADMAP.md queue 3)."""
    K = 8
    w = np.arange(24, dtype=np.float32).reshape(K, 3)
    tree = {"w": jnp.asarray(w)}
    ring, ref_ring = make_topology("ring", K), ref_make_topology("ring", K)
    mean = np.asarray(ref_consensus(tree, K, "dense",
                                    topology=ref_ring)["w"])
    np.testing.assert_allclose(mean, [10.5, 11.5, 12.5], atol=1e-6)
    got = consensus_from_stacked(_to_torch(tree), K, "gather",
                                 topology=ring)["w"]
    np.testing.assert_allclose(got.numpy(), mean, atol=1e-5, rtol=0)
    ref_gather = np.asarray(ref_consensus(tree, K, "gather",
                                          topology=ref_ring)["w"])
    np.testing.assert_allclose(ref_gather, [3.0, 3.375, 3.75], atol=1e-6)


def test_consensus_pending_paths_raise():
    port = {"a": torch.zeros(4, 3)}
    # int8 extraction is ported (tests/test_torch_compression.py); an
    # unknown quantize value is refused, as by the reference
    with pytest.raises(ValueError, match="quantize"):
        consensus_from_stacked(port, 4, "dense", quantize="fp8")
    with pytest.raises(ValueError, match="quantize"):
        ref_consensus({"a": jnp.zeros((4, 3))}, 4, "dense", quantize="fp8")
    # a robust aggregate is not a weighted mean (the reference's guard)
    with pytest.raises(ValueError, match="order statistic"):
        consensus_from_stacked(port, 4, "trimmed_mean", weights=np.ones(4))
    with pytest.raises(ValueError, match="order statistic"):
        ref_consensus({"a": jnp.zeros((4, 3))}, 4, "trimmed_mean",
                      weights=np.ones(4))
    with pytest.raises(ValueError):
        consensus_from_stacked(port, 4, "dense", quantize="int4")
    with pytest.raises(ValueError, match="weights shape"):
        consensus_from_stacked(port, 4, "dense", weights=np.ones(3))


def test_param_store_generations():
    store = ParamStore({"w": torch.zeros(2)})
    params, gen = store.snapshot()
    assert gen == 0 and store.generation == 0
    assert store.swap({"w": torch.ones(2)}) == 1
    params, gen = store.snapshot()
    assert gen == 1 and float(params["w"][0]) == 1.0


def test_bf16_consensus_rounds_like_reference():
    """The fused mixer on bf16 leaves: f32 mix, then one rounding."""
    K = 8
    rng = np.random.default_rng(9)
    tree = {"e": jnp.asarray(rng.standard_normal((K, 300)), jnp.bfloat16)}
    want = ref_consensus(tree, K, "pallas")
    got = consensus_from_stacked(_to_torch(tree), K, "pallas")
    np.testing.assert_allclose(got["e"].float().numpy(),
                               np.asarray(want["e"]).astype(np.float32),
                               rtol=BF16_RTOL, atol=1e-6)
    assert to_numpy(got["e"]).dtype == np.int16
