"""Port parity: the sparse, gather and robust mixers, the plain versions of
the two gather kernels, the column-tiled flatten and the support rules
(``repro_torch`` against ``repro``).

Inputs are seeded numpy arrays given to both packages; the realized
matrices come from the reference's graph processes (link dropout on the
base support), handed over as numpy arrays.  The reference runs its gather
kernels in interpret mode.  Tolerance: atol 1e-5, the reference's
(``tests/test_scale.py``); inactive rows are bit-equal.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import graphs as ref_graphs  # noqa: E402
from repro.core import mixing as ref_mixing  # noqa: E402
from repro.core import make_topology as ref_make_topology  # noqa: E402
from repro.kernels import diffusion_mix as ref_kernels  # noqa: E402
from repro_torch.core import graphs, mixing  # noqa: E402
from repro_torch.core.participation import masked_combination  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.kernels import gather_mix as gm  # noqa: E402
from repro_torch.kernels import gather_robust_mix as grm  # noqa: E402
from repro_torch.kernels.ref import (gather_mix_ref,  # noqa: E402
                                     gather_robust_mix_ref)
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ATOL = 1e-5
BF16_RTOL = 2.0 ** -7     # one bf16 ulp, relative

# one ulp of each leaf dtype, relative
ULP = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7,
       torch.float16: 2.0 ** -10}

TOPOLOGIES = [("ring", 8, {"hops": 2}), ("grid", 12, {}), ("ring", 12, {})]


def _draws(kind, K, kw, n, seed):
    """``n`` (mask, realized A_t) pairs: masks from numpy, matrices from
    the reference's link-dropout process on the base topology."""
    topo = ref_make_topology(kind, K, **kw)
    proc = ref_graphs.LinkDropout(topo, drop=0.4)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), i)
        A_t, _ = proc.sample(proc.init_state(key), key)
        out.append(((rng.random(K) < 0.6).astype(np.float32),
                    np.array(A_t, np.float32)))
    return out


def _tree(K, seed, bf16=False):
    """A mixed-shape tree (numpy float32 values), one leaf bf16 if asked."""
    rng = np.random.default_rng(seed)
    tree = {"w": jnp.asarray(rng.standard_normal((K, 5, 3)), jnp.float32),
            "b": jnp.asarray(rng.standard_normal((K, 131)), jnp.float32)}
    if bf16:
        tree["e"] = jnp.asarray(rng.standard_normal((K, 33)), jnp.bfloat16)
    return tree


def _port(tree):
    return params_from_jax(jax.device_get(tree), device="cpu")


def _check(got, want, tree, mask, atol=ATOL):
    dead = mask == 0
    for g, w, x in zip(tree_leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(tree)):
        w, x = np.asarray(w), np.asarray(x)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(g.float().numpy(),
                                       w.astype(np.float32),
                                       rtol=BF16_RTOL, atol=atol)
            np.testing.assert_array_equal(g.float().numpy()[dead],
                                          x.astype(np.float32)[dead])
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=0)
            np.testing.assert_array_equal(g.numpy()[dead], x[dead])


# ---------------------------------------------------------------------------
# the plain versions of the two gather kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,K,kw", TOPOLOGIES)
def test_gather_refs_match_reference_kernels(kind, K, kw):
    idx, valid = ref_make_topology(kind, K, **kw).neighbor_table()
    D = idx.shape[1]
    rng = np.random.default_rng(K)
    for mask, A_t in _draws(kind, K, kw, 2, K):
        W = rng.standard_normal((K, 256)).astype(np.float32)
        A_eff = np.asarray(masked_combination(torch.from_numpy(A_t),
                                              torch.from_numpy(mask)))
        gw = (A_eff[idx, np.arange(K)[:, None]] * valid).astype(np.float32)
        want = ref_kernels.gather_mix(jnp.asarray(idx), jnp.asarray(gw),
                                      jnp.asarray(W), tile_m=128,
                                      interpret=True)
        got = gather_mix_ref(torch.from_numpy(idx), torch.from_numpy(gw),
                             torch.from_numpy(W))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        # a CPU tensor takes the plain version through the wrapper
        assert torch.equal(gm.gather_mix(torch.from_numpy(idx),
                                         torch.from_numpy(gw),
                                         torch.from_numpy(W)), got)
        # trimmed-mean (trim 1) slot weights, as the reference's mixer
        member = gw != 0
        member[:, 0] = True
        S = member.sum(1).astype(np.float32)
        b = np.clip(np.minimum(1.0, np.floor((S - 1) / 2)), 0, None)
        slots = np.arange(D, dtype=np.float32)
        keep = ((slots >= b[:, None]) & (slots < (S - b)[:, None]))
        wslot = (keep / np.maximum(keep.sum(1, keepdims=True), 1)
                 ).astype(np.float32)
        want = ref_kernels.gather_robust_mix(
            jnp.asarray(idx), jnp.asarray(member, jnp.float32),
            jnp.asarray(wslot), jnp.asarray(mask), jnp.asarray(W),
            tile_m=128, interpret=True)
        args = (torch.from_numpy(idx), torch.from_numpy(member).float(),
                torch.from_numpy(wslot), torch.from_numpy(mask),
                torch.from_numpy(W))
        got = gather_robust_mix_ref(*args)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(got.numpy()[mask == 0],
                                      W[mask == 0])
        assert torch.equal(grm.gather_robust_mix(*args), got)


# ---------------------------------------------------------------------------
# the mixers against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("kind,K,kw", TOPOLOGIES)
def test_neighbor_gather_mixer_matches_reference(kind, K, kw, fused):
    """NeighborGatherMixer, fused (the tiled flatten with the kernel's
    plain version) against the reference's kernel in interpret mode, and
    unfused against its per-leaf einsum; both against mix_dense."""
    ref = ref_mixing.NeighborGatherMixer(ref_make_topology(kind, K, **kw),
                                         tile_m=128, interpret=True,
                                         fused=fused)
    port = mixing.NeighborGatherMixer(make_topology(kind, K, **kw),
                                      fused=fused)
    tree = _tree(K, 1, bf16=True)
    for mask, A_t in _draws(kind, K, kw, 2, 5):
        want = ref(tree, jnp.asarray(mask), jnp.asarray(A_t))
        got = port(_port(tree), torch.from_numpy(mask),
                   torch.from_numpy(A_t))
        _check(got, want, tree, mask)
        dense = ref_mixing.mix_dense(
            ref_mixing.part.masked_combination(jnp.asarray(A_t),
                                               jnp.asarray(mask)),
            {k: v for k, v in tree.items() if k != "e"})
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(dense[k]),
                                       atol=ATOL, rtol=0)


@pytest.mark.parametrize("gather", ["off", "table", "fused"])
@pytest.mark.parametrize("scope", ["global", "neighborhood"])
@pytest.mark.parametrize("robust", ["trimmed_mean", "median"])
def test_robust_mixers_match_reference(robust, scope, gather):
    kind, K, kw = "ring", 8, {"hops": 2}
    ref = ref_mixing.make_mixer(robust, ref_make_topology(kind, K, **kw),
                                trim=1, scope=scope, gather=gather,
                                interpret=True)
    if isinstance(ref, ref_mixing.FusedNeighborhoodMixer):
        ref.use_kernel = True          # force the kernel path off-TPU
    port = mixing.make_mixer(robust, make_topology(kind, K, **kw), trim=1,
                             scope=scope, gather=gather, device="cpu")
    assert type(port).__name__ == type(ref).__name__
    tree = _tree(K, 2, bf16=True)
    for mask, A_t in _draws(kind, K, kw, 3, 13):
        want = ref(tree, jnp.asarray(mask), jnp.asarray(A_t))
        got = port(_port(tree), torch.from_numpy(mask),
                   torch.from_numpy(A_t))
        _check(got, want, tree, mask)


@pytest.mark.parametrize("gather", ["off", "table"])
@pytest.mark.parametrize("scope", ["global", "neighborhood"])
def test_adaptive_trim_matches_reference(scope, gather):
    kind, K, kw = "grid", 12, {}
    ref = ref_mixing.make_mixer("adaptive_trim",
                                ref_make_topology(kind, K, **kw), trim=1,
                                scope=scope, gather=gather)
    port = mixing.make_mixer("adaptive_trim", make_topology(kind, K, **kw),
                             trim=1, scope=scope, gather=gather,
                             device="cpu")
    tree = _tree(K, 3)
    # one outlier agent, so the MAD fence flags something
    tree["b"] = tree["b"].at[4].multiply(25.0)
    for mask, A_t in _draws(kind, K, kw, 3, 17):
        want = ref(tree, jnp.asarray(mask), jnp.asarray(A_t))
        got = port(_port(tree), torch.from_numpy(mask),
                   torch.from_numpy(A_t))
        _check(got, want, tree, mask)


@pytest.mark.parametrize("skip_dead", [False, True])
def test_sparse_mixer_and_live_offsets_match_reference(skip_dead):
    kind, K, kw = "ring", 12, {"hops": 2}
    rt, pt = ref_make_topology(kind, K, **kw), make_topology(kind, K, **kw)
    assert pt.neighbor_offsets_ring() == rt.neighbor_offsets_ring()
    ref = ref_mixing.SparseCirculantMixer(rt.neighbor_offsets_ring(),
                                          skip_dead=skip_dead)
    port = mixing.SparseCirculantMixer(pt.neighbor_offsets_ring(),
                                       skip_dead=skip_dead)
    tree = _tree(K, 4, bf16=True)
    for mask, A_t in _draws(kind, K, kw, 3, 19):
        want = ref(tree, jnp.asarray(mask), jnp.asarray(A_t))
        got = port(_port(tree), torch.from_numpy(mask),
                   torch.from_numpy(A_t))
        _check(got, want, tree, mask)
        assert (int(port.live_offsets(torch.from_numpy(mask),
                                      torch.from_numpy(A_t)))
                == int(ref.live_offsets(jnp.asarray(mask),
                                        jnp.asarray(A_t))))
    # a dead offset: every link at +-2 down
    A = torch.as_tensor(pt.A, dtype=torch.float32)
    K_idx = torch.arange(K)
    for o in (2, -2):
        A[(K_idx + o) % K, K_idx] = 0.0
    A += torch.diag(1.0 - A.sum(0))
    ones = torch.ones(K)
    assert int(mixing.count_live_offsets(masked_combination(A, ones),
                                         port.offsets)) == 2
    want = ref_mixing.count_live_offsets(
        ref_mixing.part.masked_combination(jnp.asarray(A.numpy()),
                                           jnp.ones(K)), rt.neighbor_offsets_ring())
    assert int(want) == 2


# ---------------------------------------------------------------------------
# the column-tiled flatten
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_tiled_flatten_is_bit_identical_to_one_tile(monkeypatch, dtype):
    """Tiles that split leaves (and skip an empty one) give the result of
    one whole-stack tile, bit for bit.

    The flatten itself is held with a column-wise function.  Of the mixers
    on the CPU, the robust gather-sort path is column-wise too and must be
    bit-identical; the linear ones run their plain versions through BLAS,
    whose summation order may follow the tile's width, so they are held
    within float32 rounding here (the CUDA kernels are column-wise, and
    ``tests/test_torch_cuda.py`` holds them bit-identical on the card)."""
    K = 12
    topo = make_topology("ring", K)
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn((K, 7, 9), generator=gen).to(dtype),
            "b": torch.randn((K, 0, 3), generator=gen).to(dtype),
            "c": torch.randn((K, 50), generator=gen).to(dtype),
            "d": torch.randn((K, 1), generator=gen).to(dtype)}
    M = 7 * 9 + 50 + 1
    m = torch.tensor([1.0, 0.0, 1.0] * 4)
    A = torch.as_tensor(topo.A, dtype=torch.float32)
    scale = torch.linspace(0.5, 2.0, K)[:, None]

    def colwise(t):
        return t * scale + t.square().flip(0)

    exact = [lambda tr: mixing.tree_unflatten(
                 tr, mixing.tiled_apply(tree_leaves(tr), colwise)),
             mixing.make_mixer("trimmed_mean", topo, trim=1,
                               scope="neighborhood", gather="fused",
                               device="cpu"),
             mixing.make_mixer("median", topo, scope="neighborhood",
                               gather="fused", device="cpu")]
    close = [mixing.PallasFusedMixer(),
             mixing.NeighborGatherMixer(topo, fused=True)]
    whole = [mx(tree, m, A) if isinstance(mx, mixing.Mixer) else mx(tree)
             for mx in exact + close]
    calls = []
    real = mixing.tiled_apply

    def counting(leaves, fn):
        return real(leaves, lambda t: calls.append(t.shape) or fn(t))

    monkeypatch.setattr(mixing, "tiled_apply", counting)
    for cols in (1, 5, 17, 63, 64):
        monkeypatch.setattr(mixing, "TILE_ELEMS", K * cols)
        assert mixing.tile_columns(K) == cols
        for i, (mx, want) in enumerate(zip(exact + close, whole)):
            calls.clear()
            got = (mx(tree, m, A) if isinstance(mx, mixing.Mixer)
                   else mx(tree))
            assert len(calls) == mixing.num_tiles(K, M) == -(-M // cols)
            assert all(s[0] == K and s[1] <= cols for s in calls)
            for k in tree:
                assert got[k].dtype == dtype and got[k].shape == tree[k].shape
                if i < len(exact):
                    assert torch.equal(got[k], want[k]), (i, cols, k)
                else:
                    # float32 sums in another order, then one rounding to
                    # the leaf's dtype: within one ulp of it
                    torch.testing.assert_close(got[k], want[k], atol=1e-6,
                                               rtol=ULP[dtype])
                if i:
                    assert torch.equal(got[k][m == 0], tree[k][m == 0])


def test_tile_counts_of_the_paths():
    """One launch per tile: the counts the on-card phases print."""
    M = 361_821_120                       # smollm-360m
    assert mixing.num_tiles(4, M) == 6
    assert mixing.num_tiles(8, M) == 11
    assert mixing.num_tiles(12, M) == 17
    assert mixing.num_tiles(2, 2_702_579_200) == 21     # mamba2-2.7b


# ---------------------------------------------------------------------------
# the factory and the support rules
# ---------------------------------------------------------------------------

def test_make_mixer_robust_and_gather_policy():
    topo = make_topology("ring", 8)
    nb = dict(trim=1, scope="neighborhood")
    cuda = mixing.make_mixer("trimmed_mean", topo, device="cuda", **nb)
    assert isinstance(cuda, mixing.FusedNeighborhoodMixer)
    cpu = mixing.make_mixer("trimmed_mean", topo, device="cpu", **nb)
    assert isinstance(cpu, mixing.TrimmedMeanMixer)
    assert cpu._table is not None and cpu._gather_mode == "auto"
    off = mixing.make_mixer("median", topo, scope="neighborhood",
                            gather="off", device="cpu")
    assert off._table is None and off._gather_mode == "off"
    glob = mixing.make_mixer("median", topo, device="cuda")
    assert isinstance(glob, mixing.CoordinateMedianMixer)
    assert not glob.uses_matrix and not glob.linear
    with pytest.raises(ValueError, match="adaptive_trim"):
        mixing.make_mixer("adaptive_trim", topo, gather="fused", **nb)
    assert isinstance(mixing.make_mixer("adaptive_trim", topo, device="cuda",
                                        **nb), mixing.AdaptiveTrimMixer)
    with pytest.raises(ValueError, match="topology"):
        mixing.make_mixer("trimmed_mean", num_agents=8, gather="table", **nb)
    with pytest.raises(ValueError, match="gather="):
        mixing.make_mixer("trimmed_mean", topo, gather="bogus", **nb)
    with pytest.raises(ValueError, match="scope"):
        mixing.make_mixer("trimmed_mean", topo, scope="bogus")
    with pytest.raises(ValueError, match="trim"):
        mixing.make_mixer("trimmed_mean", topo, trim=8)
    with pytest.raises(ValueError, match="topology"):
        mixing.make_mixer("gather", num_agents=8)
    assert isinstance(mixing.make_mixer("gather", topo),
                      mixing.NeighborGatherMixer)
    assert mixing.make_mixer("sparse", topo).offsets == (-1, 1)
    # the reference's non-TPU "auto" policy, off CUDA
    for kind, K, want in (("ring", 8, "sparse"), ("erdos", 40, "gather"),
                          ("fedavg", 8, "dense")):
        got = mixing.make_mixer("auto", make_topology(kind, K), device="cpu")
        ref = ref_mixing.make_mixer("auto", ref_make_topology(kind, K))
        assert got.name == ref.name == want


class _OffSupport(graphs.GraphProcess):
    """A graph process that realizes edges off the base support (as
    tv_erdos does), for the support rules."""

    name = "off_support"
    within_base_support = False

    def __init__(self, topology):
        self.topology = topology


def test_check_mixer_support_rules():
    topo = make_topology("ring", 8)
    static = graphs.make_graph_process("static", topo)
    off = _OffSupport(topo)
    nb = dict(trim=1, scope="neighborhood")
    for name in ("sparse", "gather"):
        mixer = mixing.make_mixer(name, topo, device="cpu")
        graphs.check_mixer_support(mixer, static)
        with pytest.raises(ValueError, match="outside that support"):
            graphs.check_mixer_support(mixer, off)
    sparse = mixing.make_mixer("sparse", topo)
    graphs.check_mixer_support(sparse, static)
    assert sparse.skip_dead is False
    for name in ("dense", "pallas", "none"):
        graphs.check_mixer_support(mixing.make_mixer(name, topo), off)
    # auto table: detached off support, attached again on it
    auto = mixing.make_mixer("trimmed_mean", topo, device="cpu", **nb)
    graphs.check_mixer_support(auto, off)
    assert auto._table is None
    graphs.check_mixer_support(auto, static)
    assert auto._table is not None
    table = mixing.make_mixer("trimmed_mean", topo, gather="table",
                              device="cpu", **nb)
    with pytest.raises(ValueError, match="gather='table'"):
        graphs.check_mixer_support(table, off)
    fused = mixing.make_mixer("median", topo, gather="fused", **nb)
    graphs.check_mixer_support(fused, off)
    assert fused.use_kernel is False and fused.inner._table is None
    graphs.check_mixer_support(fused, static)
    assert fused.use_kernel is None and fused.inner._table is not None
    fused.use_kernel, fused._use_kernel_auto = True, False
    with pytest.raises(ValueError, match="use_kernel=True"):
        graphs.check_mixer_support(fused, off)
    # the reference's rules agree on the static graph
    ref_fused = ref_mixing.make_mixer("median", ref_make_topology("ring", 8),
                                      gather="fused", **nb)
    ref_graphs.check_mixer_support(
        ref_fused, ref_graphs.make_graph_process(
            "static", ref_make_topology("ring", 8)))
    assert ref_fused.use_kernel is None


def test_all_slots_neighborhood_warns_once_above_512_agents():
    K = 520
    topo = make_topology("ring", K)
    mixer = mixing.make_mixer("median", topo, scope="neighborhood",
                              gather="off", device="cpu")
    tree = {"w": torch.randn((K, 2), generator=torch.Generator()
                             .manual_seed(0))}
    A = torch.as_tensor(topo.A, dtype=torch.float32)
    with pytest.warns(UserWarning, match="all-slots sort"):
        out = mixer(tree, torch.ones(K), A)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mixer(tree, torch.ones(K), A)
    table = mixing.make_mixer("median", topo, scope="neighborhood",
                              gather="table", device="cpu")
    torch.testing.assert_close(table(tree, torch.ones(K), A)["w"],
                               out["w"], atol=ATOL, rtol=0)
