"""Port parity: the paper's §VII regression and Theorem 5's MSD
(``repro_torch`` against ``repro``).

The dataset and the indexed batches are bit-equal to the reference's, the
closed-form MSD and learning curve equal the reference's to 1e-12
relative, the engine replays the reference on the paper's configuration,
and the port's own simulations land on its Theorem 5 within the
reference's bands (``tests/test_msd_theory.py``)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import paper_regression as ref_paper  # noqa: E402
from repro.core import diffusion as ref_diff  # noqa: E402
from repro.core import graphs as ref_graphs  # noqa: E402
from repro.core import msd as ref_msd  # noqa: E402
from repro.core.topology import make_topology as ref_make_topology  # noqa: E402
from repro.data import synthetic as ref_syn  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import paper_regression as paper  # noqa: E402
from repro_torch.core import diffusion as diff  # noqa: E402
from repro_torch.core import graphs, msd  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402

THEORY_RTOL = 1e-12
REPLAY_TOL = 1e-5          # per entry, times (1 + |w|)


@pytest.mark.parametrize("kw", [{}, {"K": 7, "N": 30, "M": 3, "seed": 4},
                                {"K": 6, "w_star_spread": 0.5, "seed": 2}])
def test_regression_data_is_bit_equal(kw):
    got, want = syn.make_regression_problem(**kw), \
        ref_syn.make_regression_problem(**kw)
    for name in ("U", "d", "w_star", "noise_std"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert got.rho == want.rho and got.num_agents == want.num_agents
    p, q = got.problem(), want.problem()
    for k in range(got.num_agents):
        np.testing.assert_array_equal(p.hessian(k), q.hessian(k))
        np.testing.assert_array_equal(p.r_du(k), q.r_du(k))
    np.testing.assert_array_equal(p.w_opt(), q.w_opt())


def test_indexed_batches_are_bit_equal():
    data = syn.make_regression_problem(K=9, N=50, M=2, seed=1)
    ref_data = ref_syn.make_regression_problem(K=9, N=50, M=2, seed=1)
    got = syn.make_indexed_block_sampler(data, T=5, batch=3, seed=7,
                                         device="cpu")
    want = ref_syn.make_indexed_block_sampler(ref_data, T=5, batch=3, seed=7)
    for i in (0, 1, 17, 4000):
        for g, w in zip(got(i), want(i)):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_block_sampler_draws_rows_of_each_agent():
    data = syn.make_regression_problem(K=4, N=10, M=2, seed=0)
    sampler = syn.make_block_sampler(data, T=3, batch=2, device="cpu")
    u, d = sampler(torch.Generator().manual_seed(0))
    assert u.shape == (3, 4, 2, 2) and d.shape == (3, 4, 2)
    U = data.U.astype(np.float32)
    for t in range(3):
        for k in range(4):
            for b in range(2):
                row = np.nonzero((U[k] == u[t, k, b].numpy()).all(-1))[0]
                assert len(row) >= 1
                assert d[t, k, b] == np.float32(data.d[k, row[0]])


def test_loss_and_closed_form_gradient_match_the_reference():
    data = syn.make_regression_problem(K=5, N=20, M=3, seed=3)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    u = rng.standard_normal((5, 4, 3)).astype(np.float32)
    d = rng.standard_normal((5, 4)).astype(np.float32)
    ref_loss = ref_syn.make_regression_problem(K=5, N=20, M=3,
                                               seed=3).loss_fn()
    want = jax.vmap(jax.grad(ref_loss))(jnp.asarray(w),
                                        (jnp.asarray(u), jnp.asarray(d)))
    got = data.grad_fn()(torch.from_numpy(w),
                         (torch.from_numpy(u), torch.from_numpy(d)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    auto = diff.stacked_grad(data.loss_fn())(
        torch.from_numpy(w), (torch.from_numpy(u), torch.from_numpy(d)))
    np.testing.assert_allclose(got.numpy(), auto.numpy(), rtol=1e-5,
                               atol=1e-6)
    for k in range(5):
        np.testing.assert_allclose(
            float(data.loss_fn()(torch.from_numpy(w[k]),
                                 (torch.from_numpy(u[k]),
                                  torch.from_numpy(d[k])))),
            float(ref_loss(jnp.asarray(w[k]), (jnp.asarray(u[k]),
                                               jnp.asarray(d[k])))),
            rtol=1e-6)


def test_paper_config_matches_the_reference():
    for name in ("K", "N", "M", "MU", "RHO", "T", "CITATION"):
        assert getattr(paper, name) == getattr(ref_paper, name)
    for kw in ({}, {"T": 1, "participation": 0.5, "topology": "ring"}):
        assert (dataclasses.asdict(paper.diffusion_config(**kw))
                == dataclasses.asdict(ref_paper.diffusion_config(**kw)))
    assert "paper_regression" not in ARCH_IDS


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _theory_pair(problem, ref_problem, **kw):
    graph_kind = kw.pop("graph", None)
    K = problem.num_agents
    if graph_kind is None:
        return (msd.theoretical_msd(problem, **kw),
                ref_msd.theoretical_msd(ref_problem, **kw))
    kind, gkw, base = graph_kind
    g = graphs.make_graph_process(kind, make_topology(base, K), **gkw)
    rg = ref_graphs.make_graph_process(kind, ref_make_topology(base, K),
                                       **gkw)
    return (msd.theoretical_msd(problem, graph=g, **kw),
            ref_msd.theoretical_msd(ref_problem, graph=rg, **kw))


_THEORY = [
    ("static", dict(K=6, q=0.8, T=2, mu=0.01)),
    ("static_drift", dict(K=5, q=(0.3, 0.5, 0.9, 0.7, 0.6), T=3, mu=0.02,
                          drift_correction=True, injected_variance=0.01,
                          batch=2)),
    ("link_dropout", dict(K=6, q=0.9, T=2, mu=0.01,
                          graph=("link_dropout", {"drop": 0.3}, "ring"))),
    ("link_dropout_corr", dict(K=5, q=0.7, T=1, mu=0.01,
                               graph=("link_dropout",
                                      {"drop": 0.5, "corr": 0.4}, "ring"))),
    ("paper_mc_masks", dict(K=20, q=0.9, T=5, mu=0.01,
                            num_mask_samples=6)),
]


@pytest.mark.parametrize("name,kw", _THEORY)
def test_theoretical_msd_and_curve_equal_the_reference(name, kw):
    kw = dict(kw)
    K = kw.pop("K")
    q = np.broadcast_to(np.asarray(kw.pop("q"), np.float64), (K,)).copy()
    data = syn.make_regression_problem(K=K, N=40, M=2, seed=K)
    ref_data = ref_syn.make_regression_problem(K=K, N=40, M=2, seed=K)
    if "graph" not in kw:
        kw["A"] = make_topology("erdos" if K == 20 else "ring", K).A
    got, want = _theory_pair(data.problem(), ref_data.problem(), q=q, **kw)
    assert abs(got["msd"] - want["msd"]) <= THEORY_RTOL * abs(want["msd"])
    for key in ("w_opt", "m_inf", "S_inf"):
        assert _rel(got[key], want[key]) <= THEORY_RTOL, key
    for key in ("EF", "EG", "EFF", "ENN"):
        assert _rel(got["ops"][key], want["ops"][key]) <= THEORY_RTOL, key
    if K * 2 <= 60:
        assert abs(got["rho_EFF"] - want["rho_EFF"]) <= 1e-9
    w0 = np.array([0.3, -0.2])
    np.testing.assert_allclose(msd.theoretical_curve(got, w0, 50),
                               ref_msd.theoretical_curve(want, w0, 50),
                               rtol=THEORY_RTOL, atol=0)


def test_graph_matrix_law_equals_the_reference():
    topo, ref_topo = make_topology("ring", 6), ref_make_topology("ring", 6)
    for drop in (0.0, 0.3):
        got = msd.graph_matrix_law(graphs.LinkDropout(topo, drop))
        want = ref_msd.graph_matrix_law(ref_graphs.LinkDropout(ref_topo,
                                                               drop))
        assert len(got) == len(want)
        for (wg, Ag), (ww, Aw) in zip(got, want):
            assert wg == ww
            np.testing.assert_array_equal(Ag, Aw)
    with pytest.raises(ValueError, match="max_edges"):
        msd.graph_matrix_law(graphs.LinkDropout(topo, 0.3), max_edges=3)
    static = msd.graph_matrix_law(graphs.StaticGraph(topo))
    assert len(static) == 1
    np.testing.assert_allclose(static[0][1], topo.A, atol=1e-7)
    with pytest.raises(ValueError):
        msd.theoretical_msd(syn.make_regression_problem(K=6).problem(),
                            q=np.full(6, 0.8), mu=0.01, T=1)


def test_graph_matrix_law_monte_carlo_fallback():
    """Processes without an exact law: deduplicated draws through the
    port process's own ``sample``, a probability law over doubly
    stochastic atoms whose mean matches the reference's to MC error."""
    topo, ref_topo = make_topology("ring", 6), ref_make_topology("ring", 6)
    for port, ref in ((graphs.GossipMatching(topo),
                       ref_graphs.GossipMatching(ref_topo)),
                      (graphs.TimeVaryingErdos(5, p=0.5),
                       ref_graphs.TimeVaryingErdos(5, p=0.5))):
        law = msd.graph_matrix_law(port, num_samples=400, seed=3)
        again = msd.graph_matrix_law(port, num_samples=400, seed=3)
        assert [w for w, _ in law] == [w for w, _ in again]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(law,
                                                                  again))
        np.testing.assert_allclose(sum(w for w, _ in law), 1.0, atol=1e-12)
        for _, A in law:
            np.testing.assert_allclose(A.sum(axis=0), 1.0, atol=1e-6)
            np.testing.assert_allclose(A, A.T, atol=1e-9)
        mean = sum(w * A for w, A in law)
        ref_mean = sum(w * A for w, A in ref_msd.graph_matrix_law(
            ref, num_samples=400, seed=3))
        np.testing.assert_allclose(mean, ref_mean, atol=0.06)


@pytest.mark.parametrize("mix", ["dense", "pallas"])
def test_engine_replays_the_reference_on_the_paper_config(mix):
    """The paper's configuration (K = 20, T = 5, erdos, q = 0.9) for 100
    blocks: the reference's masks injected, the same numpy batches, the
    parameters within 1e-5 (1 + |w|) each block."""
    blocks = 100
    data = syn.make_regression_problem(K=paper.K, N=paper.N, M=paper.M,
                                       rho=paper.RHO, seed=0)
    ref_data = ref_syn.make_regression_problem(K=paper.K, N=paper.N,
                                               M=paper.M, rho=paper.RHO,
                                               seed=0)
    cfg = dataclasses.replace(paper.diffusion_config(), mix=mix)
    eng = diff.DiffusionEngine(cfg, data.loss_fn(), device="cpu",
                               grad_fn=data.grad_fn())
    ref_eng = ref_diff.DiffusionEngine(ref_paper.diffusion_config(),
                                       ref_data.loss_fn())
    sampler = syn.make_indexed_block_sampler(data, T=paper.T, device="cpu")
    ref_sampler = ref_syn.make_indexed_block_sampler(ref_data, T=paper.T)
    state = eng.init_state(torch.zeros(paper.K, paper.M))
    ref_state = ref_eng.init_state(jnp.zeros((paper.K, paper.M)))
    key = jax.random.PRNGKey(11)
    for i in range(blocks):
        k = jax.random.fold_in(key, i)
        ref_state, ref_m = ref_eng.step(ref_state, ref_sampler(i), k)
        state, m = eng.step(state, sampler(i), None,
                            active=np.array(ref_m["active"]))
        want = np.asarray(ref_state.params)
        assert (np.abs(state.params.numpy() - want)
                <= REPLAY_TOL * (1 + np.abs(want))).all(), i
    assert 0 < float(np.mean(np.asarray(ref_m["active"]))) <= 1


# ---------------------------------------------------------------------------
# Remark 1 and Theorem 1, on the port's Theorem 5
# ---------------------------------------------------------------------------

def test_msd_monotone_in_T():
    """Remark 1: larger T => larger steady-state MSD (all else fixed)."""
    data = syn.make_regression_problem(K=6, N=80, M=2, rho=0.1, seed=3)
    A = make_topology("ring", 6).A
    msds = [msd.theoretical_msd(data.problem(), A=A, q=np.full(6, 0.8),
                                mu=0.01, T=T)["msd"] for T in (1, 4, 10)]
    assert msds[0] < msds[1] < msds[2]


def test_msd_monotone_in_q():
    """Remark 1: higher activation probability => smaller MSD (T = 1)."""
    data = syn.make_regression_problem(K=6, N=80, M=2, rho=0.1, seed=4)
    A = make_topology("ring", 6).A
    msds = [msd.theoretical_msd(data.problem(), A=A, q=np.full(6, qv),
                                mu=0.01, T=1)["msd"] for qv in (0.2, 0.5,
                                                                0.9)]
    assert msds[0] > msds[1] > msds[2]


def test_msd_scales_with_mu():
    """Theorem 1: the steady-state error is O(mu)."""
    data = syn.make_regression_problem(K=5, N=80, M=2, rho=0.1, seed=5)
    A = make_topology("ring", 5).A
    q = np.full(5, 0.7)
    m1 = msd.theoretical_msd(data.problem(), A=A, q=q, mu=0.005, T=2)["msd"]
    m2 = msd.theoretical_msd(data.problem(), A=A, q=q, mu=0.02, T=2)["msd"]
    assert 2.0 < m2 / m1 < 8.0


def test_graph_law_drop_zero_degenerates_to_static():
    K = 6
    topo = make_topology("ring", K)
    g = graphs.make_graph_process("link_dropout", topo, drop=0.0)
    data = syn.make_regression_problem(K=K, N=80, M=2, rho=0.1, seed=3)
    q = np.full(K, 0.8)
    static = msd.theoretical_msd(data.problem(), A=topo.A, q=q, mu=0.01,
                                 T=2)
    dynamic = msd.theoretical_msd(data.problem(), graph=g, q=q, mu=0.01,
                                  T=2)
    assert dynamic["msd"] == static["msd"]


def test_injected_variance_surrogates_equal_the_reference():
    assert msd.dp_injected_variance(1.5, 0.7) == \
        ref_msd.dp_injected_variance(1.5, 0.7)
    for kind, kw in (("randk", {"ratio": 0.25}),
                     ("gauss", {"ratio": 0.5, "sigma": 0.3,
                                "signal_power": 2.0, "q": 0.8})):
        np.testing.assert_array_equal(
            msd.compressor_injected_variance(kind, **kw),
            ref_msd.compressor_injected_variance(kind, **kw))
    with pytest.raises(ValueError, match="surrogate"):
        msd.compressor_injected_variance("topk")


# ---------------------------------------------------------------------------
# simulation against theory (the reference's bands)
# ---------------------------------------------------------------------------

def _simulate(cfg, data, w_opt, blocks, reps, T, tail=None):
    eng = diff.DiffusionEngine(cfg, data.loss_fn(), device="cpu",
                               grad_fn=data.grad_fn())
    sampler = syn.make_block_sampler(data, T=T, batch=1, device="cpu")
    w_star = torch.as_tensor(w_opt, dtype=torch.float32)
    hists = []
    for rep in range(reps):
        _, _, hist = eng.run(torch.zeros(cfg.num_agents, 2), sampler,
                             blocks, seed=rep, w_star=w_star)
        hists.append(hist)
    if tail is None:
        return np.mean(hists, axis=0)
    return float(np.mean([np.mean(h[-tail:]) for h in hists]))


@pytest.mark.slow
def test_msd_matches_simulation():
    K, T, mu = 10, 5, 0.01
    data = syn.make_regression_problem(K=K, N=100, M=2, rho=0.1, seed=0)
    q = np.random.default_rng(1).uniform(0.3, 0.9, size=K)
    cfg = diff.DiffusionConfig(num_agents=K, local_steps=T, step_size=mu,
                               topology="ring", participation=tuple(q))
    theory = msd.theoretical_msd(data.problem(), A=cfg.make_topology().A,
                                 q=q, mu=mu, T=T)
    assert theory["rho_EFF"] < 1.0
    sim = _simulate(cfg, data, theory["w_opt"], 2500, 3, T, tail=600)
    # Theorem 5 is exact up to O(mu^{3/2}); the reference's 20 % band
    assert abs(sim - theory["msd"]) / theory["msd"] < 0.20, (sim,
                                                              theory["msd"])


@pytest.mark.slow
def test_dynamic_graph_msd_matches_simulation():
    K, T, mu, drop = 6, 2, 0.01, 0.3
    data = syn.make_regression_problem(K=K, N=80, M=2, rho=0.1, seed=7)
    q = np.full(K, 0.9)
    cfg = diff.DiffusionConfig(num_agents=K, local_steps=T, step_size=mu,
                               topology="ring", participation=0.9,
                               graph="link_dropout",
                               graph_kwargs=(("drop", drop),))
    topo = cfg.make_topology()
    g = graphs.make_graph_process("link_dropout", topo, drop=drop)
    th_dyn = msd.theoretical_msd(data.problem(), graph=g, q=q, mu=mu, T=T)
    th_sta = msd.theoretical_msd(data.problem(), A=topo.A, q=q, mu=mu, T=T)
    assert th_dyn["msd"] > th_sta["msd"]
    sim = _simulate(cfg, data, th_dyn["w_opt"], 2500, 3, T, tail=600)
    rel_dyn = abs(sim - th_dyn["msd"]) / sim
    rel_sta = abs(sim - th_sta["msd"]) / sim
    assert rel_dyn < 0.15, (sim, th_dyn["msd"])
    assert rel_dyn < rel_sta


@pytest.mark.slow
def test_transient_curve_tracks_simulation():
    K, T, mu = 6, 3, 0.01
    data = syn.make_regression_problem(K=K, N=80, M=2, rho=0.1, seed=6)
    q = np.full(K, 0.7)
    cfg = diff.DiffusionConfig(num_agents=K, local_steps=T, step_size=mu,
                               topology="ring", participation=0.7)
    th = msd.theoretical_msd(data.problem(), A=cfg.make_topology().A, q=q,
                             mu=mu, T=T)
    curve = msd.theoretical_curve(th, np.zeros(2), 600)
    sim = _simulate(cfg, data, th["w_opt"], 600, 4, T)
    for i in (5, 30, 150, 500):
        assert 0.5 < sim[i - 1] / curve[i] < 1.6, (i, sim[i - 1], curve[i])
    assert curve[1] > curve[50] > curve[500] * 0.9
