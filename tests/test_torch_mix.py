"""Port parity: the eq.-20 mix kernel's plain version, the mixers and the
consensus extraction (``repro_torch`` against ``repro``), plus the compiled
kernel against its plain version where a CUDA card is present."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import make_topology as ref_make_topology  # noqa: E402
from repro.core.mixing import PallasFusedMixer as RefPallasMixer  # noqa: E402
from repro.core.mixing import make_mixer as ref_make_mixer  # noqa: E402
from repro.core.serving import consensus_from_stacked as ref_consensus  # noqa: E402
from repro.kernels.diffusion_mix import diffusion_mix as ref_diffusion_mix  # noqa: E402
from repro_torch.core import mixing  # noqa: E402
from repro_torch.core.serving import ParamStore, consensus_from_stacked  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.kernels import diffusion_mix as dm  # noqa: E402
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
    for name in ("sparse", "gather", "trimmed_mean", "median",
                 "adaptive_trim"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mixing.make_mixer(name, make_topology("ring", 8))
    # auto on a sparse ring off CUDA resolves to sparse, as the reference's
    # non-TPU policy does, and that backend is not ported yet
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mixing.make_mixer("auto", make_topology("ring", 8), device="cpu")
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


def test_consensus_pending_paths_raise():
    port = {"a": torch.zeros(4, 3)}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        consensus_from_stacked(port, 4, "dense", quantize="int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        consensus_from_stacked(port, 4, "trimmed_mean")
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


@pytest.mark.cuda
def test_cuda_kernel_matches_mix_ref():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the compiled kernel runs only there")
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
