"""Port parity: the time-varying graphs and the stateful participation
processes (``repro_torch`` against ``repro``).

Each process is fed the reference's own uniforms (what it draws with
``jax.random.uniform``) and must realize the reference's matrices, masks
and states; the laws are held to the reference's property gates; and the
engine replays the reference's block steps under every graph kind and
process with the realized draws injected."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import diffusion as ref_diff  # noqa: E402
from repro.core import graphs as ref_graphs  # noqa: E402
from repro.core import schedules as ref_sched  # noqa: E402
from repro.core.topology import make_topology as ref_make_topology  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    make_indexed_block_sampler as ref_indexed_sampler,
    make_regression_problem as ref_make_problem)
from repro_torch.core import diffusion as diff  # noqa: E402
from repro_torch.core import graphs, mixing, schedules  # noqa: E402
from repro_torch.core import topology as topo_lib  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    make_indexed_block_sampler, make_regression_problem)
from repro_torch.launch import train  # noqa: E402

KEY = jax.random.PRNGKey(0)
#: the engine's graph key is ``fold_in(block key, 0x9A)``
GRAPH_FOLD = 0x9A
#: self weights are column sums in float32: torch may add in another
#: order than XLA, so they may differ by a few ulps of 1.0 (2^-23 each);
#: the off-diagonal weights must be bit-equal
SELF_WEIGHT_ULPS = 4
REPLAY_TOL = 1e-5          # per entry, times (1 + |w|)


def _pair(kind, topo_kind, n, **kw):
    """(reference process, port process) of one kind over one base."""
    ref_topo, topo = ref_make_topology(topo_kind, n), make_topology(
        topo_kind, n)
    return (ref_graphs.make_graph_process(kind, ref_topo, num_agents=n,
                                          **kw),
            graphs.make_graph_process(kind, topo, num_agents=n,
                                      device="cpu", **kw))


def _graph_u(key, K):
    return np.asarray(jax.random.uniform(jax.random.fold_in(key, GRAPH_FOLD),
                                         (K, K)))


def _assert_matrix_equal(got, want):
    got, want = got.numpy(), np.asarray(want)
    K = want.shape[0]
    off = ~np.eye(K, dtype=bool)
    np.testing.assert_array_equal(got[off], want[off])
    np.testing.assert_allclose(np.diag(got), np.diag(want), rtol=0,
                               atol=SELF_WEIGHT_ULPS * 2.0 ** -23)


_KINDS = [("link_dropout", {"drop": 0.0}), ("link_dropout", {"drop": 0.3}),
          ("link_dropout", {"drop": 0.7, "corr": 0.6}),
          ("link_dropout", {"drop": 0.3, "corr": 0.9}),
          ("gossip", {}), ("tv_erdos", {"p": 0.3}), ("tv_erdos", {"p": 1.0})]


@pytest.mark.parametrize("topo_kind,n", [("ring", 8), ("grid", 12),
                                         ("erdos", 10)])
@pytest.mark.parametrize("kind,kw", _KINDS)
def test_realized_matrices_equal_the_reference_under_its_uniforms(
        topo_kind, n, kind, kw):
    ref, port = _pair(kind, topo_kind, n, **kw)
    assert (port.stateful, port.within_base_support) == (
        ref.stateful, ref.within_base_support)
    k0 = jax.random.fold_in(KEY, 7)
    ref_state = ref.init_state(k0)
    state = port.init_state(None, u=np.asarray(jax.random.uniform(k0,
                                                                  (n, n))))
    if port.stateful:
        np.testing.assert_array_equal(state.numpy(), np.asarray(ref_state))
    for i in range(12):
        key = jax.random.fold_in(KEY, i)
        A_ref, ref_state = ref.sample(ref_state,
                                      jax.random.fold_in(key, GRAPH_FOLD))
        A_t, state = port.sample(state, None, u=_graph_u(key, n))
        assert A_t.dtype == torch.float32 and A_t.device.type == "cpu"
        _assert_matrix_equal(A_t, A_ref)
        if port.stateful:       # the corr > 0 link chain, bit-equal
            np.testing.assert_array_equal(state.numpy(),
                                          np.asarray(ref_state))
    np.testing.assert_array_equal(port.base_matrix().numpy(),
                                  np.asarray(ref.base_matrix()))


def test_metropolis_weights_equal_the_reference():
    rng = np.random.default_rng(0)
    for K in (1, 2, 7, 16, 33):
        up = np.triu(rng.random((K, K)) < 0.4, 1)
        off = (up | up.T).astype(np.float32)
        _assert_matrix_equal(
            graphs.metropolis_weights_torch(torch.from_numpy(off)),
            ref_graphs.metropolis_weights_jnp(jnp.asarray(off)))
        np.testing.assert_allclose(
            graphs.metropolis_weights_torch(torch.from_numpy(off)).numpy(),
            topo_lib.metropolis_weights(off > 0), atol=1e-6)


def _around(t: float) -> list:
    """The float32 rounding of ``t`` and its two float32 neighbours."""
    t32 = np.float32(t)
    return [np.nextafter(t32, np.float32(0)), t32,
            np.nextafter(t32, np.float32(2))]


def test_thresholds_select_as_the_reference_at_the_boundary():
    """A uniform equal to a threshold, or one float32 step either side,
    selects as the reference's comparison of a float32 array with a
    Python float does (the float rounded to float32 once)."""
    K = 6
    topo = make_topology("ring", K)
    off = topo.adjacency & ~np.eye(K, dtype=bool)
    base = torch.as_tensor(off, dtype=torch.float32)
    for drop, corr in ((0.3, 0.0), (0.7, 0.6), (0.1, 0.3)):
        g = graphs.LinkDropout(topo, drop, corr)
        up = 1.0 - drop
        # (link state, the threshold the reference compares with)
        cases = ([((), up)] if corr == 0 else
                 [(base, up + corr * drop), (0 * base, (1.0 - corr) * up)])
        for state, t in cases:
            for u0 in _around(t):
                u = np.full((K, K), u0, np.float32)
                A_t, _ = g.sample(state, None, u=u)
                want = np.asarray(jnp.asarray(u) < t) & off
                np.testing.assert_array_equal((A_t.numpy() > 0) & off, want)
    for p in (0.3, 0.1, 0.7):
        g = graphs.TimeVaryingErdos(K, p)
        for u0 in _around(p):
            A_t, _ = g.sample((), None, u=np.full((K, K), u0, np.float32))
            want = bool(np.asarray(jnp.asarray(u0) < p))
            assert bool((A_t.numpy()[0, 1:] > 0).all()) == want
    q = np.array([0.3, 0.7, 0.9, 0.1])
    for corr in (0.0, 0.5, 0.8):
        ref = ref_sched.MarkovAvailability(q, corr)
        port = schedules.MarkovAvailability(q, corr)
        np.testing.assert_array_equal(port._p_stay_active.numpy(),
                                      np.asarray(ref._p_stay_active))
        np.testing.assert_array_equal(
            port._p_wake.numpy(), np.asarray(1.0 - ref._p_stay_inactive))
        for s0 in (np.ones(4, np.float32), np.zeros(4, np.float32)):
            t = port._p_stay_active if s0[0] else port._p_wake
            for step in (0.0, 1.0, None):
                u = (t.numpy() if step is None
                     else np.nextafter(t.numpy(), np.float32(step)))
                got, _ = port.sample(torch.from_numpy(s0), None, u=u)
                want = np.where(
                    s0 > 0.5,
                    np.asarray(jnp.asarray(u) < ref._p_stay_active),
                    np.asarray(jnp.asarray(u) < 1.0 - ref._p_stay_inactive))
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("corr", [0.0, 0.5, 0.9])
def test_markov_masks_and_states_equal_the_reference(corr):
    K = 9
    q = np.linspace(0.15, 0.95, K)
    ref = ref_sched.MarkovAvailability(q, corr, num_agents=K)
    port = schedules.MarkovAvailability(q, corr, num_agents=K)
    assert port.stateful and ref.stateful
    np.testing.assert_array_equal(port.q_vector(), ref.q_vector())
    k0 = jax.random.fold_in(KEY, 3)
    ref_state = ref.init_state(k0)
    state = port.init_state(None, u=np.asarray(jax.random.uniform(k0, (K,))))
    np.testing.assert_array_equal(state.numpy(), np.asarray(ref_state))
    for i in range(40):
        key = jax.random.fold_in(KEY, 100 + i)
        want, ref_state = ref.sample(ref_state, key)
        got, state = port.sample(state, None,
                                 u=np.asarray(jax.random.uniform(key, (K,))))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(state.numpy(), np.asarray(ref_state))
        # an injected mask advances the state as the draw would have
        np.testing.assert_array_equal(port.advance(None, got).numpy(),
                                      np.asarray(ref_state))


@pytest.mark.parametrize("K,G", [(8, 4), (8, 2), (5, 5), (7, 1)])
def test_cyclic_masks_and_states_equal_the_reference(K, G):
    ref, port = ref_sched.CyclicGroups(K, G), schedules.CyclicGroups(K, G)
    ref_state, state = ref.init_state(None), port.init_state(None)
    for _ in range(3 * G + 1):
        want, ref_state = ref.sample(ref_state, None)
        before = state
        got, state = port.sample(state, None)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(state) == int(ref_state)
        assert int(port.advance(before, got)) == int(ref_state)
    np.testing.assert_array_equal(port.q_vector(), ref.q_vector())


def test_iid_injected_uniforms_equal_the_reference_draw():
    q = np.linspace(0.1, 0.9, 7)
    port = schedules.IIDBernoulli(q)
    for i in range(10):
        key = jax.random.fold_in(KEY, i)
        want, _ = ref_sched.IIDBernoulli(q).sample((), key)
        got, st = port.sample((), None,
                              u=np.asarray(jax.random.uniform(key, (7,))))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert st == () and port.advance((), got) == ()


# ---------------------------------------------------------------------------
# the laws: the reference's property gates (tests/test_graphs.py,
# tests/test_mixing.py) on the port's own draws
# ---------------------------------------------------------------------------

def _processes(topo):
    K = topo.num_agents
    return [graphs.StaticGraph(topo), graphs.LinkDropout(topo, drop=0.0),
            graphs.LinkDropout(topo, drop=0.3),
            graphs.LinkDropout(topo, drop=0.7, corr=0.6),
            graphs.GossipMatching(topo), graphs.TimeVaryingErdos(K, p=0.3)]


@pytest.mark.parametrize("kind,n", [("ring", 8), ("grid", 12),
                                    ("erdos", 10)])
def test_realized_matrices_symmetric_doubly_stochastic(kind, n):
    topo = make_topology(kind, n)
    for proc in _processes(topo):
        key = torch.Generator().manual_seed(7)
        state = proc.init_state(key)
        for _ in range(12):
            A_t, state = proc.sample(state, key)
            A = A_t.double().numpy()
            assert topo_lib.is_symmetric(A, tol=1e-5), proc
            assert topo_lib.is_doubly_stochastic(A, tol=1e-5), proc
            assert (A >= -1e-6).all(), proc


@pytest.mark.parametrize("kind,n", [("ring", 8), ("grid", 12)])
def test_dynamic_support_stays_on_base_adjacency(kind, n):
    topo = make_topology(kind, n)
    non_edge = ~np.asarray(topo.adjacency)
    for proc in (graphs.LinkDropout(topo, drop=0.4),
                 graphs.LinkDropout(topo, drop=0.4, corr=0.5),
                 graphs.GossipMatching(topo)):
        assert proc.within_base_support
        key = torch.Generator().manual_seed(3)
        state = proc.init_state(key)
        for _ in range(10):
            A_t, state = proc.sample(state, key)
            assert np.abs(A_t.numpy()[non_edge]).max() == 0.0, proc


def test_link_dropout_zero_drop_is_static_metropolis():
    topo = make_topology("ring", 8)
    proc = graphs.LinkDropout(topo, drop=0.0)
    key = torch.Generator().manual_seed(0)
    for _ in range(4):
        A_t, _ = proc.sample((), key)
        np.testing.assert_allclose(A_t.numpy(), topo.A.astype(np.float32),
                                   atol=1e-6)


def test_link_dropout_stationary_up_frequency():
    topo = make_topology("ring", 8)
    base_off = np.asarray(topo.adjacency & ~np.eye(8, dtype=bool))
    for corr in (0.0, 0.6):
        proc = graphs.LinkDropout(topo, drop=0.3, corr=corr)
        key = torch.Generator().manual_seed(1)
        state = proc.init_state(key)
        up_counts = np.zeros((8, 8))
        steps = 1500
        for _ in range(steps):
            A_t, state = proc.sample(state, key)
            up_counts += A_t.numpy() > 0
        freq = up_counts[base_off] / steps
        np.testing.assert_allclose(freq, 0.7, atol=0.06,
                                   err_msg=f"corr={corr}")


def test_gossip_matching_is_a_matching():
    proc = graphs.GossipMatching(make_topology("ring", 9))
    key = torch.Generator().manual_seed(0)
    matched_any = False
    for _ in range(20):
        A = proc.sample((), key)[0].numpy()
        off_deg = (A > 0).sum(axis=1) - 1
        assert off_deg.max() <= 1
        if off_deg.max() == 1:
            matched_any = True
            np.testing.assert_allclose(np.diag(A)[off_deg == 1], 0.5,
                                       atol=1e-6)
            np.testing.assert_allclose(np.diag(A)[off_deg == 0], 1.0,
                                       atol=1e-6)
    assert matched_any


def test_tv_erdos_edge_frequency_and_base_matrix():
    K, p, steps = 7, 0.3, 800
    proc = graphs.TimeVaryingErdos(K, p=p)
    key = torch.Generator().manual_seed(2)
    counts = np.zeros((K, K))
    for _ in range(steps):
        counts += proc.sample((), key)[0].numpy() > 0
    off = ~np.eye(K, dtype=bool)
    np.testing.assert_allclose(counts[off] / steps, p, atol=0.06)
    np.testing.assert_array_equal(
        proc.base_matrix().numpy(),
        make_topology("full", K).A.astype(np.float32))


def test_make_graph_process_factory_and_validation():
    topo = make_topology("ring", 6)
    assert isinstance(graphs.make_graph_process("static", topo),
                      graphs.StaticGraph)
    proc = graphs.make_graph_process("link_dropout", topo, drop=0.2,
                                     corr=0.1)
    assert isinstance(proc, graphs.LinkDropout) and proc.stateful
    assert (proc.drop, proc.corr) == (0.2, 0.1)
    assert not graphs.make_graph_process("link_dropout", topo,
                                         drop=0.2).stateful
    d = graphs.make_graph_process("link_dropout", topo)
    assert (d.drop, d.corr) == (0.3, 0.0)          # the reference's defaults
    assert isinstance(graphs.make_graph_process("gossip", topo),
                      graphs.GossipMatching)
    tv = graphs.make_graph_process("tv_erdos", None, num_agents=6)
    assert isinstance(tv, graphs.TimeVaryingErdos) and tv.p == 0.3
    assert not tv.within_base_support and not tv.stateful
    assert graphs.make_graph_process(proc) is proc          # passthrough
    for kind, kw, match in (("nope", {}, "unknown graph kind"),
                            ("gossip", {}, "base topology"),
                            ("link_dropout", {}, "base topology"),
                            ("tv_erdos", {}, "num_agents")):
        with pytest.raises(ValueError, match=match):
            graphs.make_graph_process(kind, topo if kind == "nope" else None,
                                      **kw)
    with pytest.raises(ValueError):
        graphs.LinkDropout(topo, drop=1.0)
    with pytest.raises(ValueError):
        graphs.LinkDropout(topo, drop=0.1, corr=1.0)
    with pytest.raises(ValueError):
        graphs.TimeVaryingErdos(6, p=0.0)
    with pytest.raises(ValueError, match="Generator"):
        tv.sample((), None)
    with pytest.raises(ValueError, match="shape"):
        tv.sample((), None, u=np.zeros((5, 5), np.float32))


def test_markov_empirical_frequency_matches_stationary_q():
    K, steps = 8, 6000
    q = np.linspace(0.2, 0.9, K)
    for corr in (0.0, 0.6):
        proc = schedules.MarkovAvailability(q, corr, num_agents=K)
        key = torch.Generator().manual_seed(1)
        state = proc.init_state(key)
        total = torch.zeros(K)
        for _ in range(steps):
            active, state = proc.sample(state, key)
            total += active
        np.testing.assert_allclose((total / steps).numpy(), q, atol=0.05,
                                   err_msg=f"corr={corr}")
    with pytest.raises(ValueError):
        schedules.MarkovAvailability(q, 1.0)


def test_markov_zero_corr_is_iid():
    proc = schedules.MarkovAvailability(0.7, 0.0, num_agents=4)
    from_active, _ = proc.sample(torch.ones(4),
                                 torch.Generator().manual_seed(5))
    from_inactive, _ = proc.sample(torch.zeros(4),
                                   torch.Generator().manual_seed(5))
    assert torch.equal(from_active, from_inactive)


def test_cyclic_groups_round_robin():
    K, G = 8, 4
    proc = schedules.CyclicGroups(K, G)
    state = proc.init_state(None)
    seen = []
    for _ in range(2 * G):
        active, state = proc.sample(state, None)
        assert active.sum() == K // G
        seen.append(active.numpy())
    np.testing.assert_array_equal(np.stack(seen).sum(0), np.full(K, 2.0))
    np.testing.assert_allclose(proc.q_vector(), np.full(K, 1.0 / G))
    with pytest.raises(ValueError):
        schedules.CyclicGroups(4, 5)


def test_mixer_support_rules_for_the_off_support_graph():
    """tv_erdos realizes edges off the base support: the support-bound
    mixers are rejected, ``auto`` falls back to dense on the CPU, and a
    robust mixer's auto gather table detaches (an explicit one raises)."""
    data = make_regression_problem(K=8, N=20)
    cfg = diff.DiffusionConfig(num_agents=8, topology="ring",
                               graph="tv_erdos", graph_kwargs=(("p", 0.4),),
                               mix="sparse")
    for mix, match in (("sparse", "circulant"), ("gather", "neighbor rows")):
        with pytest.raises(ValueError, match=match):
            diff.DiffusionEngine(dataclasses.replace(cfg, mix=mix),
                                 data.loss_fn(), device="cpu")
    eng = diff.DiffusionEngine(dataclasses.replace(cfg, mix="auto"),
                               data.loss_fn(), device="cpu",
                               grad_fn=data.grad_fn())
    assert isinstance(eng.mixer, mixing.DenseMixer)
    st = eng.init_state(torch.zeros(8, 2))
    sampler = make_indexed_block_sampler(data, T=1, device="cpu")
    st, m = eng.step(st, sampler(0), torch.Generator().manual_seed(1))
    assert torch.isfinite(st.params).all() and m["A_t"].shape == (8, 8)
    robust = dataclasses.replace(cfg, mix="trimmed_mean")
    eng = diff.DiffusionEngine(robust, data.loss_fn(), device="cpu",
                               scope="neighborhood")
    assert eng.mixer._table is None
    with pytest.raises(ValueError, match="gather='table'"):
        diff.DiffusionEngine(robust, data.loss_fn(), device="cpu",
                             scope="neighborhood", gather="table")
    # on support, the auto table stays and sparse turns skip_dead on
    on = dataclasses.replace(cfg, graph="link_dropout",
                             graph_kwargs=(("drop", 0.3),))
    eng = diff.DiffusionEngine(dataclasses.replace(on, mix="trimmed_mean"),
                               data.loss_fn(), device="cpu",
                               scope="neighborhood")
    assert eng.mixer._table is not None
    eng = diff.DiffusionEngine(on, data.loss_fn(), device="cpu")
    assert eng.mixer.skip_dead


# ---------------------------------------------------------------------------
# the engine replays the reference's block steps
# ---------------------------------------------------------------------------

_REPLAY = [
    ("link_dropout", (("drop", 0.3),), "sparse", "iid"),
    ("link_dropout", (("corr", 0.6), ("drop", 0.4)), "dense", "iid"),
    ("gossip", (), "dense", "iid"),
    ("tv_erdos", (("p", 0.3),), "dense", "iid"),
    ("link_dropout", (("drop", 0.3),), "pallas", "markov"),
    ("static", (), "dense", "markov_active"),
    ("gossip", (), "sparse", "cyclic"),
]


def _ref_process(kind, K):
    if kind.startswith("markov"):
        return ref_sched.MarkovAvailability(0.7, 0.5, num_agents=K)
    if kind == "cyclic":
        return ref_sched.CyclicGroups(K, 3)
    return None


def _port_process(kind, K):
    if kind.startswith("markov"):
        return schedules.MarkovAvailability(0.7, 0.5, num_agents=K)
    if kind == "cyclic":
        return schedules.CyclicGroups(K, 3)
    return None


@pytest.mark.parametrize("graph,graph_kwargs,mix,proc", _REPLAY)
def test_engine_replays_the_reference(graph, graph_kwargs, mix, proc):
    """>= 20 blocks of the reference's engine, the port fed its realized
    draws (the participation uniforms or mask, the graph uniforms) and the
    same numpy batches: parameters within 1e-5 (1 + |w|), masks, realized
    matrices and process/graph states as the reference's."""
    K, T, blocks = 8, 2, 24
    data = make_regression_problem(K=K, N=40, M=3, rho=0.1, seed=2)
    ref_data = ref_make_problem(K=K, N=40, M=3, rho=0.1, seed=2)
    cfg = dict(num_agents=K, local_steps=T, step_size=0.02, topology="ring",
               participation=0.7, graph=graph, graph_kwargs=graph_kwargs,
               mix=mix)
    ref_eng = ref_diff.DiffusionEngine(
        ref_diff.DiffusionConfig(**{**cfg, "mix": "dense"}),
        ref_data.loss_fn(), participation=_ref_process(proc, K))
    eng = diff.DiffusionEngine(diff.DiffusionConfig(**cfg), data.loss_fn(),
                               participation=_port_process(proc, K),
                               device="cpu", grad_fn=data.grad_fn())
    ref_sampler = ref_indexed_sampler(ref_data, T=T, seed=4)
    sampler = make_indexed_block_sampler(data, T=T, seed=4, device="cpu")
    w0 = np.random.default_rng(0).standard_normal((K, 3)).astype(np.float32)
    k0 = jax.random.fold_in(KEY, 0x5EED)
    ref_state = ref_eng.init_state(jnp.asarray(w0), key=k0)
    state = eng.init_state(torch.from_numpy(w0))
    if eng.process.stateful:
        state = state.replace(part_state=eng.process.init_state(
            None, u=np.asarray(jax.random.uniform(k0, (K,)))))
    if eng.graph.stateful:
        state = state.replace(graph_state=eng.graph.init_state(
            None, u=_graph_u(k0, K)))
    for i in range(blocks):
        key = jax.random.fold_in(KEY, i)
        u_ref, d_ref = ref_sampler(i)
        u, d = sampler(i)
        np.testing.assert_array_equal(u.numpy(), np.asarray(u_ref))
        A_ref, _ = ref_eng.graph.sample(ref_state.graph_state,
                                        jax.random.fold_in(key, GRAPH_FOLD))
        ref_state, ref_m = ref_eng.step(ref_state, (u_ref, d_ref), key)
        inject = {"graph_u": _graph_u(key, K)}
        if proc == "markov_active":
            inject["active"] = np.array(ref_m["active"])
        elif proc != "cyclic":
            inject["part_u"] = np.asarray(jax.random.uniform(
                jax.random.split(key)[0], (K,)))
        state, m = eng.step(state, (u, d), None, **inject)
        np.testing.assert_array_equal(m["active"].numpy(),
                                      np.asarray(ref_m["active"]))
        _assert_matrix_equal(m["A_t"], A_ref)
        want = np.asarray(ref_state.params)
        assert (np.abs(state.params.numpy() - want)
                <= REPLAY_TOL * (1 + np.abs(want))).all(), i
        for mine, theirs in ((state.part_state, ref_state.part_state),
                             (state.graph_state, ref_state.graph_state)):
            if theirs is None or isinstance(theirs, tuple):
                assert mine is None or mine == () == theirs
            else:
                np.testing.assert_array_equal(
                    torch.as_tensor(mine).numpy(), np.asarray(theirs))


# ---------------------------------------------------------------------------
# the training driver's graph and participation flags
# ---------------------------------------------------------------------------

_ARGV = ["--device", "cpu", "--agents", "4", "--blocks", "3", "--batch", "1",
         "--seq", "16", "--optimizer", "sgd", "--step-size", "0.05"]


def test_train_link_dropout_under_markov_availability():
    out = train.main(_ARGV + ["--mix", "pallas", "--graph", "link_dropout",
                              "--link-drop", "0.5", "--graph-corr", "0.5",
                              "--participation-process", "markov",
                              "--markov-corr", "0.5"])
    base = make_topology("ring", 4)
    non_edge = ~base.adjacency
    assert len(out["graphs"]) == 3 and len(out["active"]) == 3
    for A in out["graphs"]:
        A = A.double().numpy()
        assert topo_lib.is_symmetric(A, tol=1e-6)
        assert topo_lib.is_doubly_stochastic(A, tol=1e-6)
        assert np.abs(A[non_edge]).max() == 0.0
    state = out["state"]
    assert state.graph_state is not None and state.part_state is not None
    np.testing.assert_array_equal(state.part_state.numpy(),
                                  np.asarray(out["active"][-1], np.float32))
    again = train.main(_ARGV + ["--mix", "dense", "--graph", "link_dropout",
                                "--link-drop", "0.5", "--graph-corr", "0.5",
                                "--participation-process", "markov",
                                "--markov-corr", "0.5"])
    assert again["active"] == out["active"]
    for a, b in zip(again["graphs"], out["graphs"]):
        assert torch.equal(a, b)


def test_train_tv_erdos_under_cyclic_groups():
    out = train.main(_ARGV + ["--mix", "auto", "--graph", "tv_erdos",
                              "--graph-p", "0.5", "--participation-process",
                              "cyclic", "--num-groups", "2"])
    assert out["active"] == [[1.0, 0.0, 1.0, 0.0], [0.0, 1.0, 0.0, 1.0],
                             [1.0, 0.0, 1.0, 0.0]]
    assert int(out["state"].part_state) == 3
    for A in out["graphs"]:
        assert topo_lib.is_doubly_stochastic(A.double().numpy(), tol=1e-6)


@pytest.mark.parametrize("flags,match", [
    (["--graph", "gossip", "--link-drop", "0.2"], "--link-drop"),
    (["--graph-corr", "0.2"], "--graph-corr"),
    (["--graph", "link_dropout", "--graph-p", "0.2"], "--graph-p"),
    (["--graph", "tv_erdos", "--mix", "sparse"], "circulant"),
    (["--graph", "nope"], "unknown graph kind"),
])
def test_train_graph_flag_guards_raise(flags, match):
    with pytest.raises(ValueError, match=match):
        train.main(["--device", "cpu", "--blocks", "1"] + flags)
