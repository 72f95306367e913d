"""Port parity: the event-driven engine (``repro_torch.core.async_engine``)
against the reference's (``repro.core.async_engine``).

``resolve_rates`` is numpy in both, so bit-equal; at ``tau_max = 0``,
uniform rates and no discount the engine reduces to the port's
synchronous engine step for step (and over a stationary run of the
paper's preset); fed the reference's realized draws (participation, graph
and clock-tick uniforms) it replays the reference's fire masks, ages,
clocks, buffer and parameters under every discount law; the invariants
(non-fired agents bit-exact, clocks advance only on fire), checkpoint
continuation, the privacy accountant on the fire mask, and every guard."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api.spec import AsyncSpec as RefAsyncSpec  # noqa: E402
from repro.core.async_engine import (  # noqa: E402
    AsyncEngine as RefAsyncEngine, resolve_rates as ref_resolve_rates)
from repro.core.diffusion import DiffusionConfig as RefConfig  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    make_indexed_block_sampler as ref_indexed_sampler,
    make_regression_problem as ref_make_problem)
from repro_torch import api  # noqa: E402
from repro_torch.api.spec import AsyncSpec, PrivacySpec  # noqa: E402
from repro_torch.checkpoint import (load_experiment,  # noqa: E402
                                    save_experiment)
from repro_torch.configs import paper_regression as paper  # noqa: E402
from repro_torch.core import privacy as priv  # noqa: E402
from repro_torch.core import variants  # noqa: E402
from repro_torch.core.async_engine import (AsyncEngine,  # noqa: E402
                                           resolve_rates)
from repro_torch.core.diffusion import (DiffusionConfig,  # noqa: E402
                                        DiffusionEngine)
from repro_torch.data.synthetic import (  # noqa: E402
    make_block_sampler, make_indexed_block_sampler, make_regression_problem)
from repro_torch.launch import train  # noqa: E402

SYNC_REDUCTION = AsyncSpec(enabled=True, tau_max=0, discount="none")
#: the engine's graph and tick keys are folds of the block key
GRAPH_FOLD, TICK_FOLD = 0x9A, 0xA5


def _async(cfg, data, spec=None, **kw):
    return AsyncEngine(cfg, data.loss_fn(), async_spec=spec, device="cpu",
                       grad_fn=data.grad_fn(), **kw)


# ---------------------------------------------------------------------------
# rates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,K", [
    (dict(rates=2.0), 4), (dict(rates=(1.0, 0.5, 2.0)), 3),
    (dict(rate_dist="lognormal", rate_sigma=1.0, rate_seed=9), 8),
    (dict(rate_dist="lognormal", rate_sigma=0.5, rate_seed=0), 8),
    (dict(rate_dist="lognormal", rate_sigma=0.0), 5)])
def test_resolve_rates_bit_equal_to_the_reference(kw, K):
    got = resolve_rates(AsyncSpec(**kw), K)
    want = ref_resolve_rates(RefAsyncSpec(**kw), K)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(rates=0.0), dict(rate_dist="beta"),
                                dict(rates=(1.0, 2.0))])
def test_resolve_rates_guards(kw):
    with pytest.raises(ValueError) as a:
        resolve_rates(AsyncSpec(**kw), 4)
    with pytest.raises(ValueError) as b:
        ref_resolve_rates(RefAsyncSpec(**kw), 4)
    assert str(a.value) == str(b.value)


# ---------------------------------------------------------------------------
# reduction to the synchronous engine
# ---------------------------------------------------------------------------

def test_step_parity_with_the_sync_engine():
    """tau_max = 0 with uniform rates: the tick is surely 1 (not drawn), so
    both engines realize the same masks from one generator, and every step
    matches the synchronous engine (atol 1e-6, the reference's gate)."""
    K, T = 8, 3
    data = make_regression_problem(K=K, N=60, M=2, rho=0.1, seed=0)
    cfg = DiffusionConfig(num_agents=K, local_steps=T, step_size=0.01,
                          topology="ring", participation=0.8)
    sync = DiffusionEngine(cfg, data.loss_fn(), device="cpu",
                           grad_fn=data.grad_fn())
    asyn = _async(cfg, data, SYNC_REDUCTION)
    sampler = make_indexed_block_sampler(data, T=T, device="cpu")
    ks, ka = (torch.Generator().manual_seed(0) for _ in range(2))
    ss = sync.init_state(torch.zeros((K, 2)), key=ks)
    sa = asyn.init_state(torch.zeros((K, 2)), key=ka)
    for i in range(5):
        batch = sampler(i)
        ss, ms = sync.step(ss, batch, ks)
        sa, ma = asyn.step(sa, batch, ka)
        assert torch.equal(ms["active"], ma["active"]), i
        torch.testing.assert_close(sa.params, ss.params, rtol=0, atol=1e-6)


def test_stationary_msd_parity_paper_preset():
    """The reduction over a full run at the paper's setting (K = 20, T = 5,
    erdos, q = 0.9): the async trajectory tracks the synchronous one block
    by block (rtol 5e-3, the reference's gate)."""
    cfg = paper.diffusion_config()
    data = make_regression_problem(K=paper.K, N=paper.N, M=paper.M,
                                   rho=paper.RHO, seed=0)
    w_o = torch.as_tensor(data.problem().w_opt(np.full(paper.K, 0.9)),
                          dtype=torch.float32)
    sampler = make_block_sampler(data, T=paper.T, batch=1, device="cpu")
    sync = DiffusionEngine(cfg, data.loss_fn(), device="cpu",
                           grad_fn=data.grad_fn())
    asyn = _async(cfg, data, SYNC_REDUCTION)
    w0 = torch.zeros((paper.K, paper.M))
    _, _, hs = sync.run(w0, sampler, 400, seed=0, w_star=w_o)
    _, _, ha = asyn.run(w0, sampler, 400, seed=0, w_star=w_o)
    np.testing.assert_allclose(np.asarray(ha), np.asarray(hs), rtol=5e-3)


# ---------------------------------------------------------------------------
# replay parity against the reference
# ---------------------------------------------------------------------------

_LAWS = [("exp", 0.2, 3), ("poly", 0.5, 2), ("none", 0.1, 1)]


@pytest.mark.parametrize("graph", ["static", "link_dropout"])
@pytest.mark.parametrize("discount,rate,tau_max", _LAWS)
def test_replays_the_reference(discount, rate, tau_max, graph):
    """6 blocks of the reference's AsyncEngine under lognormal rates; the
    port fed its participation, graph and tick uniforms and the same numpy
    batches: fire masks and ages exactly, t_local at rtol 1e-5, buffer and
    parameters at atol 1e-6."""
    K, T, M = 8, 2, 3
    data = make_regression_problem(K=K, N=40, M=M, rho=0.1, seed=2)
    ref_data = ref_make_problem(K=K, N=40, M=M, rho=0.1, seed=2)
    kw = dict(num_agents=K, local_steps=T, step_size=0.02, topology="ring",
              participation=0.7, graph=graph,
              graph_kwargs=(("corr", 0.0), ("drop", 0.3))
              if graph == "link_dropout" else ())
    spec_kw = dict(enabled=True, rate_dist="lognormal", rate_sigma=0.8,
                   rate_seed=1, tau_max=tau_max, discount=discount,
                   discount_rate=rate)
    ref = RefAsyncEngine(RefConfig(**kw), ref_data.loss_fn(),
                         async_spec=RefAsyncSpec(**spec_kw))
    eng = _async(DiffusionConfig(**kw), data, AsyncSpec(**spec_kw))
    ref_sampler = ref_indexed_sampler(ref_data, T=T, seed=4)
    sampler = make_indexed_block_sampler(data, T=T, seed=4, device="cpu")
    w0 = np.random.default_rng(0).standard_normal((K, M)).astype(np.float32)
    ref_state = ref.init_state(jnp.asarray(w0), key=jax.random.PRNGKey(3))
    state = eng.init_state(torch.from_numpy(w0))
    mixed = 0
    for i in range(6):
        key = jax.random.fold_in(jax.random.PRNGKey(5), i)
        ref_state, ref_m = ref.step(ref_state, ref_sampler(i), key)
        state, m = eng.step(
            state, sampler(i), None,
            part_u=np.asarray(jax.random.uniform(jax.random.split(key)[0],
                                                 (K,))),
            graph_u=np.asarray(jax.random.uniform(
                jax.random.fold_in(key, GRAPH_FOLD), (K, K))),
            tick_u=np.asarray(jax.random.uniform(
                jax.random.fold_in(key, TICK_FOLD), (K,))))
        fire = np.asarray(ref_m["active"])
        mixed += 0 < fire.sum() < K
        np.testing.assert_array_equal(m["active"].numpy(), fire)
        a, ra = state.async_state, ref_state.async_state
        np.testing.assert_array_equal(a["ages"].numpy(),
                                      np.asarray(ra["ages"]))
        np.testing.assert_allclose(a["t_local"].numpy(),
                                   np.asarray(ra["t_local"]), rtol=1e-5)
        np.testing.assert_allclose(a["buffer"].numpy(),
                                   np.asarray(ra["buffer"]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(state.params.numpy(),
                                   np.asarray(ref_state.params), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(m["weights"].sum(1).numpy(), 1.0,
                                   rtol=0, atol=1e-6)
        assert float(m["t_wall"]) == pytest.approx(
            float(ref_m["t_wall"]), rel=1e-5)
    assert mixed > 0


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------

def test_nonfired_agents_keep_iterate_bit_exactly():
    K = 6
    data = make_regression_problem(K=K, N=40, M=2, rho=0.1, seed=2)
    cfg = DiffusionConfig(num_agents=K, local_steps=1, step_size=0.01,
                          topology="ring", participation=0.5)
    eng = _async(cfg, data, AsyncSpec(enabled=True, rate_dist="lognormal",
                                      rate_sigma=1.0))
    sampler = make_indexed_block_sampler(data, T=1, device="cpu")
    state = eng.init_state(torch.randn(
        (K, 2), generator=torch.Generator().manual_seed(3)))
    key = torch.Generator().manual_seed(5)
    seen_mixed = False
    for i in range(6):
        before = state.params.clone()
        state, m = eng.step(state, sampler(i), key)
        fire = m["active"].bool()
        assert torch.equal(state.params[~fire], before[~fire])
        if 0 < int(fire.sum()) < K:
            seen_mixed = True
            assert not torch.equal(state.params[fire], before[fire])
    assert seen_mixed


def test_clocks_and_ages_advance_only_on_fire():
    K = 6
    data = make_regression_problem(K=K, N=40, M=2, rho=0.1, seed=2)
    cfg = DiffusionConfig(num_agents=K, local_steps=1, step_size=0.01,
                          topology="ring", participation=0.7)
    eng = _async(cfg, data, AsyncSpec(enabled=True, rate_dist="lognormal",
                                      rate_sigma=0.8, rate_seed=1))
    sampler = make_indexed_block_sampler(data, T=1, device="cpu")
    state = eng.init_state(torch.zeros((K, 2)))
    fires = np.zeros(K)
    key = torch.Generator().manual_seed(0)
    idx = eng._idx.numpy()
    for i in range(20):
        ages = state.async_state["ages"].numpy().copy()
        state, m = eng.step(state, sampler(i), key)
        fire = m["active"].numpy()
        fires += fire
        src_fired = fire[idx] > 0
        np.testing.assert_array_equal(state.async_state["ages"].numpy(),
                                      np.where(src_fired, 0, ages + 1))
    t_local = state.async_state["t_local"].numpy().astype(np.float64)
    np.testing.assert_allclose(t_local, fires * eng.delays, rtol=1e-5)


def test_checkpoint_roundtrip_bit_identical_continuation(tmp_path):
    """Save mid-run (clocks, ages and staleness buffer included), restore
    into a fresh engine built from the stored spec, continue: every leaf
    of the restored state and of the 3-block continuation is bit-equal."""
    K = 6
    data = make_regression_problem(K=K, N=40, M=2, rho=0.1, seed=5)
    aspec = AsyncSpec(enabled=True, rate_dist="lognormal", rate_sigma=1.0,
                      tau_max=8, discount="exp", discount_rate=0.2)
    spec = variants.asynchronous_diffusion(K, mu=0.01, q=0.8).replace(
        asynchrony=aspec)
    eng = api.build(spec, data.loss_fn(), device="cpu")
    assert isinstance(eng, AsyncEngine) and eng.engine_kind == "async"
    sampler = make_indexed_block_sampler(data, T=1, device="cpu")
    state = eng.init_state(torch.zeros((K, 2)))
    key = torch.Generator().manual_seed(0)
    for i in range(5):
        state, _ = eng.step(state, sampler(i), key)
    path = str(tmp_path / "async_mid.npz")
    save_experiment(path, state, spec=spec, step=5)
    eng2 = api.build(api.ExperimentSpec.from_json(spec.to_json()),
                     data.loss_fn(), device="cpu")
    like = eng2.init_state(torch.zeros((K, 2)))
    restored, meta = load_experiment(path, like, device="cpu")
    assert meta["step"] == 5
    for name in ("t_local", "ages", "buffer"):
        assert torch.equal(restored.async_state[name],
                           state.async_state[name])
    assert torch.equal(restored.params, state.params)
    key_a = torch.Generator().manual_seed(9)
    key_b = torch.Generator().manual_seed(9)
    a, b = state, restored
    for i in range(5, 8):
        a, _ = eng.step(a, sampler(i), key_a)
        b, _ = eng2.step(b, sampler(i), key_b)
    assert torch.equal(a.params, b.params)
    for name in ("t_local", "ages", "buffer"):
        assert torch.equal(a.async_state[name], b.async_state[name])


def test_privacy_accountant_advances_on_the_fire_mask():
    """The accountant advances at the realized fired rate, times T; its
    epsilon matches the numpy twins over the fire masks."""
    K, T = 6, 2
    data = make_regression_problem(K=K, N=40, M=2, rho=0.1, seed=1)
    spec = variants.asynchronous_diffusion(K, mu=0.01, q=0.8).replace(
        asynchrony=AsyncSpec(enabled=True, rate_dist="lognormal",
                             rate_sigma=1.0),
        privacy=PrivacySpec(enabled=True, noise_multiplier=1.5),
        run=api.RunSpec(num_agents=K, local_steps=T, step_size=0.01,
                        blocks=6))
    eng = api.build(spec, data.loss_fn(), device="cpu")
    params = torch.zeros((K, 2))
    state = eng.init_state(params, eng.optimizer.init(params))
    sampler = make_indexed_block_sampler(data, T=T, device="cpu")
    key = torch.Generator().manual_seed(2)
    rdp = np.zeros(len(eng.privacy.orders))
    partial = False
    for i in range(6):
        state, m = eng.step(state, sampler(i), key)
        rate = float(m["active"].mean())
        partial |= 0 < rate < 1
        rdp += T * priv.rdp_increment_np(rate, 1.5)
        want = priv.epsilon_from_rdp_np(rdp, 1e-5)
        assert float(m["epsilon"]) == pytest.approx(want, rel=2e-4, abs=1e-6)
        assert eng.privacy.epsilon_np(state.privacy_state) == pytest.approx(
            want, rel=2e-4)
    assert partial and int(state.privacy_state["steps"]) == 6


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_every_guard_raises():
    K = 6
    data = make_regression_problem(K=K, N=40, M=2, rho=0.1, seed=1)
    base = DiffusionConfig(num_agents=K, local_steps=1, step_size=0.01,
                           topology="ring")
    for change, match in ((dict(compress="topk"), "compress"),
                          (dict(mix="sparse"), "mix"),
                          (dict(mix="trimmed_mean"), "mix"),
                          (dict(graph="tv_erdos"), "support"),
                          (dict(num_agents=1), "num_agents")):
        with pytest.raises(ValueError, match=match):
            _async(dataclasses.replace(base, **change), data)
    for aspec, match in ((AsyncSpec(enabled=True, tau_max=-1), "tau_max"),
                         (AsyncSpec(enabled=True, discount="hyper"),
                          "discount")):
        with pytest.raises(ValueError, match=match):
            _async(base, data, aspec)
    # the hub-degree cap max(K // 2, 8): degree 15 on a full K = 16 graph
    hub = dataclasses.replace(base, num_agents=16, topology="full")
    with pytest.raises(ValueError, match="cap"):
        _async(hub, make_regression_problem(K=16, N=20, seed=1))
    # secure-agg: refused by the engine and by build
    p = priv.compile_privacy(K, np.full(K, 1.0), blocks=4, local_steps=1,
                             noise_multiplier=1.0, secure_agg=True)
    with pytest.raises(ValueError, match="secure-agg"):
        _async(base, data, privacy=p)
    spec = variants.private_diffusion(K, 0.01).replace(
        asynchrony=AsyncSpec(enabled=True))
    with pytest.raises(ValueError, match="secure-agg"):
        api.build(spec, data.loss_fn(), device="cpu")
    # an enabled AsyncSpec on a synchronous engine is a contradiction
    with pytest.raises(ValueError, match="asynchrony"):
        api.build(spec, data.loss_fn(), engine="stacked", device="cpu")
    # a state without the async component
    eng = _async(base, data)
    with pytest.raises(ValueError, match="async_state"):
        eng.step(api.EngineState(torch.zeros((K, 2))), None, None)


def test_discount_laws_match_the_reference():
    ages = np.array([[0, 1, 2], [3, 5, 8]], np.int32)
    t = np.array([0.0, 0.4, 2.5, 7.9], np.float32)
    K = 6
    data = make_regression_problem(K=K, N=20, seed=0)
    ref_data = ref_make_problem(K=K, N=20, seed=0)
    cfg = dict(num_agents=K, local_steps=1, step_size=0.01, topology="ring")
    for law, rate, tau in (("exp", 0.3, 5), ("poly", 0.7, 3),
                           ("none", 0.1, 2)):
        kw = dict(enabled=True, discount=law, discount_rate=rate,
                  tau_max=tau)
        eng = _async(DiffusionConfig(**cfg), data, AsyncSpec(**kw))
        ref = RefAsyncEngine(RefConfig(**cfg), ref_data.loss_fn(),
                             async_spec=RefAsyncSpec(**kw))
        for a in (ages, t):
            np.testing.assert_allclose(
                eng._discount(torch.from_numpy(a)).numpy(),
                np.asarray(ref._discount(jnp.asarray(a))), rtol=1e-6)


def test_train_driver_runs_the_async_engine(tmp_path, capsys):
    out = train.main(["--device", "cpu", "--agents", "6", "--blocks", "3",
                      "--batch", "1", "--seq", "16", "--optimizer", "sgd",
                      "--step-size", "0.05", "--engine", "async",
                      "--async-rate-dist", "lognormal",
                      "--async-rate-sigma", "0.5", "--async-tau-max", "4",
                      "--checkpoint", str(tmp_path / "a.npz")])
    printed = capsys.readouterr().out
    assert "async: lognormal rates" in printed and "sim_wall=" in printed
    eng = out["engine"]
    assert isinstance(eng, AsyncEngine) and eng.engine_kind == "async"
    assert len(out["t_wall"]) == 3 and out["t_wall"] == sorted(out["t_wall"])
    fires = np.sum(out["active"], axis=0)
    np.testing.assert_allclose(
        out["state"].async_state["t_local"].numpy(), fires * eng.delays,
        rtol=1e-5)
    assert "saved" in printed


@pytest.mark.parametrize("chunk", [7, 1 << 26])
def test_combine_buffer_in_chunks_equals_one_product(monkeypatch, chunk):
    """The buffer's combination in column chunks (as at full width) equals
    one float32 einsum over the whole (K, D, ...) leaf, bf16 leaves
    widened first."""
    from repro_torch.core import async_engine
    monkeypatch.setattr(async_engine, "COMBINE_CHUNK_ELEMS", chunk)
    gen = torch.Generator().manual_seed(0)
    gw = torch.rand((5, 3), generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.randn((5, 3, 4, 9), generator=gen).to(dtype)
        got = async_engine.combine_buffer(gw, buf)
        want = torch.einsum("kd,kd...->k...", gw, buf.float())
        assert got.dtype == torch.float32 and got.shape == (5, 4, 9)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
