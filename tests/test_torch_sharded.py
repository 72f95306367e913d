"""Port parity: the agent-sharded engine (``repro_torch.core.sharded``),
its mixer and pipeline hooks, the EF host offload, and ``build``'s
default engine.

Three kinds of gate:

* the reference's own sharded tests, mirrored and held against
  ``repro.core.sharded.make_block_step`` with the reference's realized
  draws injected: the activation uniforms of ``split(key)[0]``, the graph
  uniforms of ``fold_in(key, 0x9A)`` and the compression draws of
  ``fold_in(key, 0xC0)`` (not ``split(key)[1]`` as for the stacked
  engine), at the reference tests' tolerances;
* what the reference's three reds in this area mean (they fail on the
  installed JAX version's text, not on the algorithm), tested the port's
  way: the graph state threads through the step, only int8 codes and
  float32 scales cross the int8 wire, the offload changes no bit;
* world W against world 1: spawned gloo groups of 2 and 4 processes
  (``tests/_sharded_cases.py``), bit-equal after 2 blocks on every mixer
  and pipeline, and a world-2 checkpoint equal to world 1's.
"""
import time

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _sharded_cases as cases  # noqa: E402
from repro.core import graphs as ref_graphs  # noqa: E402
from repro.core.diffusion import DiffusionConfig as RefConfig  # noqa: E402
from repro.core.sharded import make_block_step as ref_block_step  # noqa: E402
from repro.core.topology import make_topology as ref_make_topology  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    make_block_sampler as ref_make_sampler,
    make_regression_problem as ref_make_problem)
from repro_torch import api  # noqa: E402
from repro_torch.core import compression as comp  # noqa: E402
from repro_torch.core import graphs, mixing  # noqa: E402
from repro_torch.core.attacks import byzantine_indices, make_attack  # noqa: E402
from repro_torch.core.diffusion import (DiffusionConfig,  # noqa: E402
                                        DiffusionEngine, local_update_scan,
                                        stacked_grad)
from repro_torch.core.schedules import CyclicGroups  # noqa: E402
from repro_torch.core.sharded import (ShardedEngine,  # noqa: E402
                                      ef_host_sharding, fetch_comm_state,
                                      make_block_step, offload_comm_state)
from repro_torch.core.state import EngineState  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    make_indexed_block_sampler, make_regression_problem)
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

KEY = jax.random.PRNGKey(0)
#: the sharded step's graph and compression keys
GRAPH_FOLD, COMM_FOLD = 0x9A, 0xC0
#: the reference tests' parity tolerance (tests/test_api.py:247)
RTOL, ATOL = 1e-5, 1e-6


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _batch(b):
    return tuple(_t(x) for x in b)


def _act_u(key, K):
    """The reference's activation uniforms: ``key_act = split(key)[0]``."""
    return np.asarray(jax.random.uniform(jax.random.split(key)[0], (K,)))


def _graph_u(key, K):
    return np.asarray(jax.random.uniform(jax.random.fold_in(key, GRAPH_FOLD),
                                         (K, K)))


def _leaf_draws(key, shapes) -> comp.Draws:
    """The reference's per-leaf compression uniforms for ``key``."""
    keys = jax.random.split(key, len(shapes))
    return comp.Draws(u=[_t(jax.random.uniform(k, s))
                         for k, s in zip(keys, shapes)])


def _flat_draws(key, K, M) -> comp.Draws:
    """The reference's fused int8 draw over the padded layout."""
    tile, width, _ = mixing.int8_layout(K, M)
    u = np.array(jax.random.uniform(key, (K, width // tile, tile)))
    return comp.Draws(u=torch.from_numpy(u.reshape(K, width)))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _pair(K=6, seed=3, N=40, M=2):
    return (make_regression_problem(K=K, N=N, M=M, rho=0.1, seed=seed),
            ref_make_problem(K=K, N=N, M=M, rho=0.1, seed=seed))


# ---------------------------------------------------------------------------
# the reference's sharded tests, mirrored
# ---------------------------------------------------------------------------

def test_build_sharded_engine_contract_matches_stacked():
    """tests/test_api.py:247: build(spec, engine="sharded") exposes the
    stacked engine's init_state/step surface and agrees with it on an
    rng-free loss (same masks from one generator), and with the
    reference's sharded step under its draws."""
    from repro.api import build as ref_build
    from repro.core import variants as ref_variants
    from repro_torch.core import variants

    K = 6
    data, ref_data = _pair(K, seed=2)
    spec = variants.decentralized_fedavg(K, T=2, mu=0.02)
    stacked = api.build(spec, data.loss_fn(), engine="stacked", device="cpu")
    sharded = api.build(spec, lambda p, b, rng: data.loss_fn()(p, b),
                        engine="sharded", device="cpu")
    assert isinstance(sharded, ShardedEngine)
    assert sharded.engine_kind == "sharded" and sharded.shard is None
    ref_eng = ref_build(ref_variants.decentralized_fedavg(K, T=2, mu=0.02),
                        lambda p, b, rng: ref_data.loss_fn()(p, b),
                        engine="sharded")
    batch = ref_make_sampler(ref_data, T=2, batch=2)(jax.random.PRNGKey(7))
    params = jax.random.normal(jax.random.PRNGKey(0), (K, 2))
    key = jax.random.PRNGKey(42)
    ref_s, ref_m = jax.jit(ref_eng.step)(ref_eng.init_state(params), batch,
                                         key)
    gen = torch.Generator().manual_seed(5)
    s1, m1 = stacked.step(stacked.init_state(_t(params)), _batch(batch), gen)
    gen = torch.Generator().manual_seed(5)
    s2, m2 = sharded.step(sharded.init_state(_t(params)), _batch(batch), gen)
    assert torch.equal(m1["active"], m2["active"])
    np.testing.assert_allclose(s1.params.numpy(), s2.params.numpy(),
                               rtol=RTOL, atol=ATOL)
    s3, m3 = sharded.step(sharded.init_state(_t(params)), _batch(batch),
                          None, part_u=_act_u(key, K))
    np.testing.assert_array_equal(m3["active"].numpy(),
                                  np.asarray(ref_m["active"]))
    _close(s3.params, ref_s.params)


def test_sharded_unified_state_contract():
    """tests/test_compression.py:296: every process/compressor combination
    flows through the same (state, batch, key) signature; stateful
    components live in EngineState, absent ones stay None."""
    K = 6
    data, _ = _pair(K)
    cfg = DiffusionConfig(num_agents=K, local_steps=2, step_size=0.02,
                          topology="ring", participation=0.5)
    topo = cfg.make_topology()
    loss3 = lambda p, b, rng: data.loss_fn()(p, b)  # noqa: E731
    batch = make_indexed_block_sampler(data, T=2, seed=7, device="cpu")(0)
    p0 = torch.zeros((K, 2))
    proc = CyclicGroups(K, 3)
    key = torch.Generator().manual_seed(0)

    s = make_block_step(loss3, cfg, topology=topo, device="cpu")
    assert not s.pipeline.stateful
    st, m = s(s.init_state(p0), batch, key)
    assert st.part_state is None and st.comm_state is None

    s = make_block_step(loss3, cfg, topology=topo, compress="int8",
                        error_feedback=True, device="cpu")
    assert s.pipeline.stateful
    st, m = s(s.init_state(p0), batch, key)
    assert st.comm_state.shape == p0.shape and st.part_state is None

    s = make_block_step(loss3, cfg, topology=topo, compress="randk",
                        compress_ratio=0.5, device="cpu")
    assert s.pipeline.stateful and s.pipeline.mode == "diff"
    st, m = s(s.init_state(p0), batch, key)
    assert st.comm_state["ref"].shape == p0.shape

    s = make_block_step(loss3, cfg, topology=topo, participation=proc,
                        compress="int8", device="cpu")
    assert not s.pipeline.stateful
    st, m = s(s.init_state(p0), batch, key)
    assert st.part_state is not None and st.comm_state is None

    s = make_block_step(loss3, cfg, topology=topo, participation=proc,
                        compress="topk", compress_ratio=0.5,
                        error_feedback=True, device="cpu")
    st = s.init_state(p0)
    masks = []
    for i in range(3):
        st, m = s(st, batch, torch.Generator().manual_seed(i))
        masks.append(m["active"].numpy())
    assert int(st.part_state) == 3
    np.testing.assert_array_equal(np.stack(masks).sum(0), np.ones(K))
    with pytest.raises(ValueError, match="init_state"):
        s(EngineState(p0, part_state=proc.init_state(None)), batch, key)


def test_sharded_compress_none_bit_identical():
    """tests/test_compression.py:354: compress="none" is bit-identical to
    the step built without compression arguments."""
    K = 6
    data, _ = _pair(K)
    cfg = DiffusionConfig(num_agents=K, local_steps=2, step_size=0.02,
                          topology="ring", participation=0.5)
    topo = cfg.make_topology()
    loss3 = lambda p, b, rng: data.loss_fn()(p, b)  # noqa: E731
    batch = make_indexed_block_sampler(data, T=2, seed=7, device="cpu")(0)
    p0 = torch.zeros((K, 2))
    sa = make_block_step(loss3, cfg, topology=topo, device="cpu")
    sb = make_block_step(loss3, cfg, topology=topo, compress="none",
                         device="cpu")
    sta, ma = sa(sa.init_state(p0), batch, torch.Generator().manual_seed(3))
    stb, mb = sb(sb.init_state(p0), batch, torch.Generator().manual_seed(3))
    assert torch.equal(sta.params, stb.params)
    assert torch.equal(ma["active"], mb["active"])


def test_degree_mode_sharded_matches_stacked():
    """tests/test_heterogeneity.py:363: the degree-aware freeze mask on the
    sharded step equals the stacked engine, and the reference's sharded
    step under its draws (participation 1: no activation draw)."""
    data, ref_data = _pair(12, seed=6)
    kw = dict(num_agents=12, local_steps=3, step_size=0.03,
              topology="scale_free", participation=1.0,
              local_steps_mode="degree")
    cfg = DiffusionConfig(**kw)
    topo = cfg.make_topology()
    stacked = DiffusionEngine(cfg, data.loss_fn(), device="cpu")
    step = make_block_step(lambda p, b, r: data.loss_fn()(p, b), cfg,
                           torch.as_tensor(topo.A, dtype=torch.float32),
                           topology=topo, device="cpu")
    assert step.step_mask is not None
    ref_cfg = RefConfig(**kw)
    ref_topo = ref_cfg.make_topology()
    ref_step = ref_block_step(lambda p, b, r: ref_data.loss_fn()(p, b),
                              ref_cfg, jnp.asarray(ref_topo.A, jnp.float32),
                              topology=ref_topo)
    params = jax.random.normal(jax.random.PRNGKey(1), (12, 2))
    batch = ref_make_sampler(ref_data, T=3, batch=2)(jax.random.PRNGKey(8))
    key = jax.random.PRNGKey(21)
    ref_s, _ = jax.jit(ref_step)(ref_step.init_state(params), batch, key)
    gen = torch.Generator().manual_seed(0)
    s1, _ = stacked.step(stacked.init_state(_t(params)), _batch(batch), gen)
    gen = torch.Generator().manual_seed(0)
    s2, _ = step(step.init_state(_t(params)), _batch(batch), gen)
    np.testing.assert_allclose(s1.params.numpy(), s2.params.numpy(),
                               rtol=RTOL, atol=ATOL)
    _close(s2.params, ref_s.params)


def test_degree_mode_sharded_requires_topology_for_raw_A():
    """tests/test_heterogeneity.py:385."""
    cfg = DiffusionConfig(num_agents=4, local_steps=2, step_size=0.1,
                          local_steps_mode="degree")
    proc = graphs.make_graph_process("static", make_topology("ring", 4),
                                     num_agents=4, device="cpu")
    with pytest.raises(ValueError, match="degree"):
        make_block_step(lambda p, b, r: (p ** 2).sum(), cfg, A=None,
                        graph=proc, device="cpu")


def test_poisoned_gradient_sharded_path():
    """tests/test_attacks.py:256: make_block_step threads trim,
    robust_scope and the attack transform as the stacked engine does; the
    honest agents converge under 3 sign-flip adversaries."""
    K = 9
    data, _ = _pair(K)
    cfg = DiffusionConfig(num_agents=K, local_steps=2, step_size=0.03,
                          topology="ring", participation=1.0,
                          mix="trimmed_mean")
    topo = cfg.make_topology()
    atk = make_attack("sign_flip", K, num_byzantine=3, scale=2.0)
    step = make_block_step(lambda p, b, rng: data.loss_fn()(p, b), cfg,
                           topology=topo, trim=1,
                           robust_scope="neighborhood",
                           grad_transform=atk.update, device="cpu")
    assert step.pipeline.mixer.scope == "neighborhood"
    assert step.pipeline.mixer.uses_matrix
    state = step.init_state(torch.zeros((K, 2)))
    sampler = make_indexed_block_sampler(data, T=2, batch=2, seed=0,
                                         device="cpu")
    key = torch.Generator().manual_seed(0)
    for i in range(150):
        state, _ = step(state, sampler(i), key)
    w_o = data.problem().w_opt(None)
    honest = [k for k in range(K) if k not in byzantine_indices(K, 3)]
    msd = float(np.mean(np.sum((state.params.numpy()[honest]
                                - np.asarray(w_o)[None]) ** 2, axis=1)))
    assert msd < 0.5


def test_sharded_step_with_cyclic_process():
    """tests/test_mixing.py:242: a stateful process threads its state
    through EngineState.part_state."""
    K = 6
    data, _ = _pair(K)
    cfg = DiffusionConfig(num_agents=K, local_steps=2, step_size=0.02,
                          topology="ring", participation=0.5)
    step = make_block_step(lambda p, b, rng: data.loss_fn()(p, b), cfg,
                           topology=cfg.make_topology(), mix="sparse",
                           participation=CyclicGroups(K, 3), device="cpu")
    sampler = make_indexed_block_sampler(data, T=2, seed=10, device="cpu")
    state = step.init_state(torch.zeros((K, 2)))
    masks = []
    for i in range(3):
        state, m = step(state, sampler(i), torch.Generator().manual_seed(i))
        masks.append(m["active"].numpy())
    assert int(state.part_state) == 3
    np.testing.assert_array_equal(np.stack(masks).sum(0), np.ones(K))


def test_sharded_builder_without_topology_fails_loudly():
    """tests/test_graphs.py:146: no topology fails loudly for a
    matrix-consuming mixer; robust / none mixers build against an inert
    identity."""
    loss3 = lambda p, b, rng: 0.0  # noqa: E731
    with pytest.raises(ValueError, match="topology"):
        make_block_step(loss3, DiffusionConfig(num_agents=8), device="cpu")
    s = make_block_step(loss3, DiffusionConfig(num_agents=8,
                                               mix="trimmed_mean"),
                        device="cpu")
    assert s.graph.num_agents == 8
    s = make_block_step(loss3, DiffusionConfig(num_agents=1, mix="none"),
                        device="cpu")
    assert s.graph.num_agents == 1


def test_adaptive_gamma_through_sharded_engine():
    """tests/test_graphs.py:411: comm_gamma="auto" reaches the pipeline
    through the sharded builder and threads its delta EMA."""
    n = 6
    data, _ = _pair(n, seed=2)
    cfg = DiffusionConfig(num_agents=n, local_steps=2, step_size=0.02,
                          topology="ring", participation=0.9,
                          compress="topk", compress_ratio=0.25,
                          comm_gamma="auto")
    step = make_block_step(lambda p, b, rng: data.loss_fn()(p, b), cfg,
                           topology=cfg.make_topology(), device="cpu")
    assert step.pipeline.adaptive
    sampler = make_indexed_block_sampler(data, T=2, seed=10, device="cpu")
    state = step.init_state(torch.zeros((n, 2)))
    d0 = float(state.comm_state["delta"])
    for i in range(5):
        state, _ = step(state, sampler(i), torch.Generator().manual_seed(i))
    assert float(state.comm_state["delta"]) != d0
    assert torch.isfinite(state.params).all()


_REPLAY = [
    # (mix, topology, compression kwargs, graph, graph kwargs)
    ("dense", "ring", {}, "static", ()),
    ("pallas", "fedavg", dict(compress="int8", error_feedback=True),
     "static", ()),
    ("dense", "ring", dict(compress="int8"), "static", ()),
    ("sparse", "ring", dict(compress="randk", compress_ratio=0.5),
     "static", ()),
    ("gather", "ring", {}, "link_dropout", (("corr", 0.5), ("drop", 0.3))),
    ("trimmed_mean", "ring", dict(robust_scope="neighborhood", trim=1),
     "static", ()),
]


@pytest.mark.parametrize("mix,topo_kind,ckw,graph,gkw", _REPLAY)
def test_sharded_step_replays_the_reference(mix, topo_kind, ckw, graph, gkw):
    """4 blocks of the reference's sharded step against the port's, fed
    its realized draws: activation uniforms, graph uniforms, and the
    compression draws of ``fold_in(key, 0xC0)``.  Masks equal, parameters
    and pipeline memory within the reference's 1e-5."""
    K, M, T = 8, 3, 2
    data, ref_data = _pair(K, seed=2, M=M)
    kw = dict(num_agents=K, local_steps=T, step_size=0.02,
              topology=topo_kind, participation=0.7, graph=graph,
              graph_kwargs=gkw)
    cfg, ref_cfg = DiffusionConfig(**kw), RefConfig(**kw)
    ref_step = jax.jit(ref_block_step(
        lambda p, b, r: ref_data.loss_fn()(p, b), ref_cfg,
        topology=ref_make_topology(topo_kind, K), mix=mix, **ckw))
    ref_init = ref_block_step(lambda p, b, r: ref_data.loss_fn()(p, b),
                              ref_cfg, topology=ref_make_topology(topo_kind,
                                                                  K),
                              mix=mix, **ckw).init_state
    step = make_block_step(lambda p, b, r: data.loss_fn()(p, b), cfg,
                           topology=make_topology(topo_kind, K), mix=mix,
                           device="cpu", **ckw)
    w0 = np.random.default_rng(0).standard_normal((K, M)).astype(np.float32)
    k0 = jax.random.fold_in(KEY, 0x5EED)
    ref_state = ref_init(jnp.asarray(w0), key=k0)
    state = step.init_state(torch.from_numpy(w0))
    if step.graph.stateful:
        state = state.replace(graph_state=step.graph.init_state(
            None, u=_graph_u(k0, K)))
    sampler = ref_make_sampler(ref_data, T=T, batch=2)
    fused = mix == "pallas" and ckw.get("compress") == "int8"
    for i in range(4):
        key = jax.random.fold_in(KEY, i)
        batch = sampler(jax.random.fold_in(key, 7))
        ref_state, ref_m = ref_step(ref_state, batch, key)
        kc = jax.random.fold_in(key, COMM_FOLD)
        comm_key = (_flat_draws(kc, K, M) if fused else
                    _leaf_draws(kc, [(K, M)]) if ckw.get("compress")
                    else None)
        state, m = step(state, _batch(batch), None, part_u=_act_u(key, K),
                        graph_u=_graph_u(key, K), comm_key=comm_key)
        np.testing.assert_array_equal(m["active"].numpy(),
                                      np.asarray(ref_m["active"]))
        _close(state.params, ref_state.params)
        for mine, theirs in zip(tree_leaves(state.comm_state),
                                jax.tree.leaves(ref_state.comm_state)):
            _close(mine, theirs)
        if step.graph.stateful:
            np.testing.assert_array_equal(state.graph_state.numpy(),
                                          np.asarray(ref_state.graph_state))


# ---------------------------------------------------------------------------
# the reference's three reds in this area, by intent
# ---------------------------------------------------------------------------

#: blocks of the graph-state test.  The reference's red runs 3: under its
#: keys PRNGKey(0..2) (and init key 4) the installed JAX realizes no link
#: flip in 3 blocks, which is the assert that red fails on; the same draws
#: flip links within 8
BLOCKS_TO_CHURN = 8


def test_sharded_step_threads_graph_state():
    """The intent of tests/test_graphs.py::test_sharded_step_threads_graph_
    state: a correlated link-dropout graph carries its link mask through
    the sharded step, the realized masks are the reference's graph
    process's under its uniforms block for block, the links churn, and a
    stateful graph fed graph_state=None fails loudly."""
    n = 6
    data, _ = _pair(n)
    cfg = DiffusionConfig(num_agents=n, local_steps=2, step_size=0.02,
                          topology="ring", participation=0.9,
                          graph="link_dropout",
                          graph_kwargs=(("corr", 0.5), ("drop", 0.3)))
    step = make_block_step(lambda p, b, r: data.loss_fn()(p, b), cfg,
                           topology=cfg.make_topology(), device="cpu")
    ref_proc = ref_graphs.make_graph_process(
        "link_dropout", ref_make_topology("ring", n), num_agents=n,
        corr=0.5, drop=0.3)
    sampler = make_indexed_block_sampler(data, T=2, seed=10, device="cpu")
    k0 = jax.random.PRNGKey(4)
    state = step.init_state(torch.zeros((n, 2)))
    state = state.replace(graph_state=step.graph.init_state(
        None, u=_graph_u(k0, n)))
    ref_gs = ref_proc.init_state(jax.random.fold_in(k0, GRAPH_FOLD))
    assert state.graph_state is not None
    masks = []
    for i in range(BLOCKS_TO_CHURN):
        key = jax.random.PRNGKey(i)
        ref_A, ref_gs = ref_proc.sample(ref_gs,
                                        jax.random.fold_in(key, GRAPH_FOLD))
        state, m = step(state, sampler(i), torch.Generator().manual_seed(i),
                        graph_u=_graph_u(key, n))
        np.testing.assert_array_equal(state.graph_state.numpy(),
                                      np.asarray(ref_gs))
        masks.append(state.graph_state.numpy())
    assert any(not np.array_equal(a, b) for a, b in zip(masks, masks[1:]))
    with pytest.raises(ValueError, match="init_state"):
        step(EngineState(torch.zeros((n, 2))), sampler(0),
             torch.Generator().manual_seed(0))


def test_ef_host_offload_on_and_off_bit_equal_on_the_cpu():
    """The intent of tests/test_heterogeneity.py::test_ef_host_offload_
    roundtrip_parity: the offload changes no bit.  On the CPU there is no
    pinned space of its own, so the helpers are the identity (the card's
    pinned round trip: tests/test_torch_cuda.py)."""
    argv = ["--device", "cpu", "--agents", "4", "--blocks", "3", "--batch",
            "1", "--seq", "16", "--optimizer", "sgd", "--step-size", "0.05",
            "--topology", "fedavg", "--mix", "pallas", "--compress", "int8",
            "--error-feedback", "--engine", "sharded"]
    off = train.main(argv)
    on = train.main(argv + ["--ef-host-offload"])
    assert on["engine"].ef_host_offload and not off["engine"].ef_host_offload
    for a, b in zip(tree_leaves((off["state"].params,
                                 off["state"].comm_state)),
                    tree_leaves((on["state"].params,
                                 on["state"].comm_state))):
        assert torch.equal(a, b)
    assert any(bool(x.any()) for x in tree_leaves(on["state"].comm_state))


def test_offload_helpers_pass_none_and_empty_and_cpu_leaves():
    assert ef_host_sharding("cpu") is None
    if not torch.cuda.is_available():
        assert ef_host_sharding() is None
    for empty in (None, ()):
        assert offload_comm_state(empty) is empty
        assert fetch_comm_state(empty) is empty
    tree = {"e": torch.arange(6.0).reshape(2, 3), "t": torch.zeros(())}
    out = offload_comm_state(tree)
    assert all(a is b for a, b in zip(tree_leaves(out), tree_leaves(tree)))
    back = fetch_comm_state(out)
    assert all(a is b for a, b in zip(tree_leaves(back), tree_leaves(tree)))


# ---------------------------------------------------------------------------
# the 3-arg loss: one generator per (local step, agent)
# ---------------------------------------------------------------------------

def test_loss_generators_per_local_step_and_agent():
    """With ``loss_key`` the scan hands agent k at local step t the
    generator ``seeded_generator(device, loss_key, t, k)``: a stochastic
    loss sees one stream per (t, k), and a stack of the agents' rows
    (``agents=``) sees the rows' global streams."""
    K, T = 4, 3
    seen = {}

    def loss3(p, b, rng):
        z = torch.rand((), generator=rng)
        seen.setdefault(float(b), []).append(float(z))
        return (p * z).sum()

    grad = stacked_grad(loss3)
    params = torch.ones((K, 2))
    batch = torch.arange(T * K, dtype=torch.float32).reshape(T, K)
    p, _ = local_update_scan(grad, params, None, torch.full((K,), 0.1),
                             batch, local_steps=T, loss_key=99)
    for t in range(T):
        for k in range(K):
            want = torch.rand((), generator=comp.seeded_generator(
                "cpu", 99, t, k))
            assert seen[float(batch[t, k])] == [float(want)]
    seen.clear()
    rows = local_update_scan(grad, params[2:], None, torch.full((2,), 0.1),
                             batch[:, 2:], local_steps=T, loss_key=99,
                             agents=range(2, 4))[0]
    assert torch.equal(rows, p[2:])


# ---------------------------------------------------------------------------
# world W against world 1: spawned gloo groups
# ---------------------------------------------------------------------------

GROUP_TIMEOUT_S = 60


def _spawn(world: int, tmp_path, names, checkpoint_argv=None) -> dict:
    """Run ``_sharded_cases.worker`` on ``world`` spawned ranks of a gloo
    group (``file://`` rendezvous in ``tmp_path``); kill every rank on a
    timeout."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        cases.worker, args=(world, str(tmp_path / "store"), str(tmp_path),
                            list(names), checkpoint_argv),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the gloo group of {world} did not "
                                   f"finish in {GROUP_TIMEOUT_S}s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    return torch.load(tmp_path / "results.pt", weights_only=False)


def _assert_world_equals_world_1(results: dict, world: int) -> None:
    for name, got in results.items():
        if name not in cases.CASES:
            continue
        want = cases.run_case(name)
        K = cases.CASES[name]["K"]
        assert got["sharded"] == (K % world == 0), name
        np.testing.assert_array_equal(got["active"], want["active"])
        assert got["params"].tobytes() == want["params"].tobytes(), name
        assert len(got["comm"]) == len(want["comm"]), name
        for a, b in zip(got["comm"], want["comm"]):
            assert a.tobytes() == b.tobytes(), name
        if not got["sharded"]:
            assert got["wire"] == [], name       # replicated: no gather


def _assert_int8_wire(results: dict, world: int) -> None:
    """Only the int8 codes and their float32 scales cross the int8 wire:
    every float32 gather is a (rows, tiles) scale block, never a
    dequantized stack."""
    for name in ("int8_ef", "int8_ef_generic"):
        wire = results[name]["wire"]
        rows = cases.CASES[name]["K"] // world
        assert {d for d, _ in wire} == {"int8", "float32"}, wire
        for dtype, shape in wire:
            assert shape[0] == rows, wire
            if dtype == "float32":
                assert shape == (rows, 1), wire
    # the uncompressed combination gathers the float32 stack itself
    assert {d for d, _ in results["pallas"]["wire"]} == {"float32"}


def _train_argv(path, *extra):
    return ["--device", "cpu", "--agents", "4", "--blocks", "2", "--batch",
            "1", "--seq", "16", "--optimizer", "adam", "--step-size",
            "1e-3", "--topology", "fedavg", "--mix", "pallas", "--compress",
            "int8", "--error-feedback", "--engine", "sharded",
            "--checkpoint", str(path), *extra]


def test_world_2_is_bit_equal_to_world_1_and_checkpoints_equal(tmp_path):
    """A spawned gloo group of 2: every case of ``_sharded_cases`` (the
    dense/pallas, gather and neighborhood trimmed-mean mixers, int8 + EF on
    the fused and generic paths, top-k diff mode, the secure-agg masks
    with private noise, the noise attack, Markov availability under link
    dropout, and a K = 5 that 2 does not divide) equals world 1 bit for
    bit after 2 blocks; the int8 wire carries codes and scales only; the
    train driver's world-2 checkpoint (Adam, int8 + EF) holds the arrays
    and the metadata of world 1's, and serve reads it unchanged."""
    (tmp_path / "w2").mkdir()
    results = _spawn(2, tmp_path / "w2", cases.CASES,
                     _train_argv(tmp_path / "w2.npz"))
    _assert_world_equals_world_1(results, 2)
    _assert_int8_wire(results, 2)
    assert {d for d, _ in results["train_wire"]} == {"int8", "float32"}
    train.main(_train_argv(tmp_path / "w1.npz"))
    w1, w2 = np.load(tmp_path / "w1.npz"), np.load(tmp_path / "w2.npz")
    assert sorted(w1.files) == sorted(w2.files)
    assert any("opt_state" in f for f in w1.files)
    assert any("comm_state" in f for f in w1.files)
    for f in w1.files:
        assert w1[f].tobytes() == w2[f].tobytes(), f
    out = serve.main(["--device", "cpu", "--checkpoint",
                      str(tmp_path / "w2.npz"), "--batch", "1",
                      "--prompt-len", "8", "--decode", "2",
                      "--temperature", "0"])
    ref = serve.main(["--device", "cpu", "--checkpoint",
                      str(tmp_path / "w1.npz"), "--batch", "1",
                      "--prompt-len", "8", "--decode", "2",
                      "--temperature", "0"])
    assert torch.equal(out["tokens"], ref["tokens"])


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b",
                                  "musicgen-medium"])
def test_world_2_slices_the_image_stream_and_codebooks(arch, tmp_path):
    """The sharded engine's row split of the block reaches each rank's
    agents with llava's float32 image stream and musicgen's (T, K, B, S,
    4) tokens as at world 1: the world-2 train driver's checkpoint (K = 4,
    two agents a rank) equals world 1's byte for byte."""
    def argv(path):
        return ["--device", "cpu", "--arch", arch, "--smoke", "--agents",
                "4", "--blocks", "2", "--batch", "1", "--seq", "8", "--mix",
                "pallas", "--engine", "sharded", "--checkpoint", str(path)]

    (tmp_path / "w2").mkdir()
    _spawn(2, tmp_path / "w2", [], argv(tmp_path / "w2.npz"))
    train.main(argv(tmp_path / "w1.npz"))
    w1, w2 = np.load(tmp_path / "w1.npz"), np.load(tmp_path / "w2.npz")
    assert sorted(w1.files) == sorted(w2.files)
    for f in w1.files:
        assert w1[f].tobytes() == w2[f].tobytes(), f


def test_world_4_is_bit_equal_to_world_1(tmp_path):
    """A spawned gloo group of 4: two agent rows a rank at K = 8, and
    K = 5 replicated."""
    results = _spawn(4, tmp_path, cases.CASES)
    _assert_world_equals_world_1(results, 4)
    _assert_int8_wire(results, 4)


def test_mesh_is_none_at_world_1_without_a_group():
    """World 1 without torchrun's environment creates no process group."""
    import torch.distributed as dist

    assert mesh_lib.init_agent_group() is None
    assert not dist.is_initialized()
    assert mesh_lib.make_production_mesh() is None
    with pytest.raises(ValueError, match="process group"):
        mesh_lib.make_production_mesh(2)
