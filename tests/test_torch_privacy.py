"""Port parity: the privacy tier (``repro_torch.core.privacy`` against
``repro.core.privacy``), its engine and pipeline threading, and the train
driver's privacy flags.

The numpy accountant is the reference's verbatim and is held at 1e-12
relative; the float32 accountant at the reference's own gate (rtol 2e-4,
atol 1e-6).  torch cannot replay JAX's threefry keys, so the gradient
noise and the secure-agg masks are held two ways: with the reference's
realized normals injected (replay), and by law (the noise's std, the
masks' cancellation)."""
import argparse

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import diffusion as ref_diff  # noqa: E402
from repro.core import privacy as ref_priv  # noqa: E402
from repro.core.participation import masked_combination_np  # noqa: E402
from repro.core.topology import make_topology as ref_make_topology  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    make_indexed_block_sampler as ref_indexed_sampler,
    make_regression_problem as ref_make_problem)
from repro_torch.core import diffusion as diff  # noqa: E402
from repro_torch.core import mixing  # noqa: E402
from repro_torch.core import privacy as priv  # noqa: E402
from repro_torch.core.compression import Draws, Int8Stochastic  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    make_indexed_block_sampler, make_regression_problem)
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

KEY = jax.random.PRNGKey(0)
GRAPH_FOLD = 0x9A                 # the engine's graph key: fold_in(key, 0x9A)
REPLAY_TOL = 1e-5                 # per entry, times (1 + |w|)
MASK_TOL = 5e-5                   # the reference's mask-exactness gate


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))


# ---------------------------------------------------------------------------
# the accountant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", [0.7, 2.0, 11.0])
@pytest.mark.parametrize("q", [0.0, 0.3, 1.0])
def test_numpy_twins_equal_the_reference(q, sigma):
    for alpha in (2, 17, 512):
        assert _rel(priv._order_constants(alpha, sigma),
                    ref_priv._order_constants(alpha, sigma)) <= 1e-12
    inc = priv.rdp_increment_np(q, sigma)
    ref = ref_priv.rdp_increment_np(q, sigma)
    np.testing.assert_allclose(inc, ref, rtol=1e-12, atol=0)
    for steps in (1, 40, 4000):
        assert abs(priv.epsilon_from_rdp_np(steps * inc, 1e-5)
                   - ref_priv.epsilon_from_rdp_np(steps * ref, 1e-5)) <= (
            1e-12 * max(ref_priv.epsilon_from_rdp_np(steps * ref, 1e-5),
                        1e-300))
    if q == 1.0:    # the plain Gaussian RDP alpha / (2 sigma^2)
        want = np.asarray(priv.DEFAULT_ORDERS, np.float64) / (2 * sigma ** 2)
        np.testing.assert_allclose(inc, want, rtol=1e-10)
    if q == 0.0:
        assert not inc.any()


@pytest.mark.parametrize("eps,q,steps", [(5.0, 0.5, 300), (8.0, 0.9, 6)])
def test_calibration_equals_the_reference(eps, q, steps):
    sigma = priv.calibrate_noise_multiplier(eps, 1e-5, q, steps)
    assert abs(sigma - ref_priv.calibrate_noise_multiplier(eps, 1e-5, q,
                                                           steps)) <= (
        1e-12 * sigma)
    spent = priv.epsilon_from_rdp_np(
        steps * priv.rdp_increment_np(q, sigma), 1e-5)
    assert spent <= eps + 1e-6
    with pytest.raises(ValueError, match="must be > 0"):
        priv.calibrate_noise_multiplier(0.0, 1e-5, q, steps)


@pytest.mark.parametrize("steps_per_block", [1, 3])
def test_advance_and_epsilon_match_the_reference(steps_per_block):
    K, sigma = 5, 1.3
    kw = dict(num_agents=K, clip=1.0, noise_multiplier=sigma, delta=1e-5,
              steps_per_block=steps_per_block)
    ref, port = ref_priv.Privacy(**kw), priv.Privacy(**kw)
    # the reference's accountant is jit-traced (eager, its 71 orders take
    # tens of seconds on the CPU)
    ref_advance, ref_epsilon = jax.jit(ref.advance), jax.jit(ref.epsilon)
    rs, ps = ref.init_state(), port.init_state("cpu")
    rng = np.random.default_rng(2)
    for _ in range(7):
        active = (rng.random(K) < 0.7).astype(np.float32)
        rs = ref_advance(rs, jnp.asarray(active))
        ps = port.advance(ps, torch.from_numpy(active))
        np.testing.assert_allclose(ps["rdp"].numpy(), np.asarray(rs["rdp"]),
                                   rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(float(port.epsilon(ps)),
                                   float(ref_epsilon(rs)), rtol=2e-4,
                                   atol=1e-6)
    assert ps["rdp"].dtype == torch.float32 and int(ps["steps"]) == 7
    assert abs(port.epsilon_np(ps) - ref.epsilon_np(rs)) <= 1e-3


def test_accountant_zero_participation_is_free_and_scales_with_t():
    kw = dict(num_agents=4, clip=1.0, noise_multiplier=1.2, delta=1e-5)
    p1, p3 = priv.Privacy(**kw), priv.Privacy(steps_per_block=3, **kw)
    s = p1.advance(p1.init_state("cpu"), torch.zeros(4))
    assert not s["rdp"].any()
    floor = priv.epsilon_from_rdp_np(np.zeros(len(priv.DEFAULT_ORDERS)),
                                     1e-5)
    assert float(p1.epsilon(s)) == pytest.approx(floor, abs=1e-4)
    active = torch.tensor([1.0, 0.0, 1.0, 1.0])
    s1 = p1.advance(p1.init_state("cpu"), active)
    s3 = p3.advance(p3.init_state("cpu"), active)
    np.testing.assert_allclose(s3["rdp"].numpy(), 3.0 * s1["rdp"].numpy(),
                               rtol=1e-6)
    assert float(p3.epsilon(s3)) > float(p1.epsilon(s1))


def test_privacy_ctor_validation():
    kw = dict(num_agents=4, delta=1e-5)
    with pytest.raises(ValueError, match="clip"):
        priv.Privacy(clip=0.0, noise_multiplier=1.0, **kw)
    with pytest.raises(ValueError, match="noise_multiplier"):
        priv.Privacy(clip=1.0, noise_multiplier=0.0, **kw)
    with pytest.raises(ValueError, match="delta"):
        priv.Privacy(num_agents=4, clip=1.0, noise_multiplier=1.0, delta=1.0)
    with pytest.raises(ValueError, match="steps_per_block"):
        priv.Privacy(clip=1.0, noise_multiplier=1.0, steps_per_block=0, **kw)


# ---------------------------------------------------------------------------
# compile_privacy
# ---------------------------------------------------------------------------

def _ref_spec(K, q, blocks, local_steps, **pkw):
    from repro.api.spec import (ExperimentSpec, ParticipationSpec,
                                PrivacySpec, RunSpec)
    return ExperimentSpec(
        participation=ParticipationSpec(kind="iid", q=q),
        privacy=PrivacySpec(enabled=True, **pkw),
        run=RunSpec(num_agents=K, local_steps=local_steps, step_size=0.05,
                    blocks=blocks))


@pytest.mark.parametrize("pkw", [
    dict(noise_multiplier=1.5), dict(epsilon=6.0),
    dict(epsilon=6.0, delta=1e-6, clip=0.5, secure_agg=True, seed=3),
    dict(noise_multiplier=0.9, epsilon=4.0, mask_scale=2.0)])
def test_compile_privacy_equals_the_reference(pkw):
    K, q, blocks, T = 4, 0.8, 4, 2
    ref = ref_priv.compile_privacy(_ref_spec(K, q, blocks, T, **pkw))
    port = priv.compile_privacy(K, np.full(K, q), blocks=blocks,
                                local_steps=T, **pkw)
    for name in ("num_agents", "clip", "delta", "epsilon_budget", "seed",
                 "secure_agg", "mask_scale", "steps_per_block", "orders"):
        assert getattr(port, name) == getattr(ref, name), name
    assert abs(port.noise_multiplier - ref.noise_multiplier) <= (
        1e-12 * ref.noise_multiplier)


def test_compile_privacy_guards():
    assert priv.compile_privacy(4, [0.8] * 4, blocks=4, local_steps=1,
                                enabled=False) is None
    with pytest.raises(ValueError, match="homogeneous participation"):
        priv.compile_privacy(4, [1.0, 0.6, 0.8, 0.8], blocks=4,
                             local_steps=1, noise_multiplier=1.0)
    with pytest.raises(ValueError, match="neither noise_multiplier nor "
                                         "epsilon"):
        priv.compile_privacy(4, [0.8] * 4, blocks=4, local_steps=1)
    # the calibration composes blocks x local steps invocations
    p2 = priv.compile_privacy(4, [0.8] * 4, blocks=4, local_steps=2,
                              epsilon=6.0)
    p1 = priv.compile_privacy(4, [0.8] * 4, blocks=4, local_steps=1,
                              epsilon=6.0)
    assert p2.steps_per_block == 2 and p2.noise_multiplier > \
        p1.noise_multiplier
    spent = priv.epsilon_from_rdp_np(
        8 * priv.rdp_increment_np(0.8, p2.noise_multiplier), 1e-5)
    assert spent <= 6.0 + 1e-6


# ---------------------------------------------------------------------------
# clip-and-noise
# ---------------------------------------------------------------------------

def _grads(seed, dtype=np.float32, K=3):
    rng = np.random.default_rng(seed)
    return {"a": (3.0 * rng.standard_normal((K, 4, 5))).astype(dtype),
            "b": rng.standard_normal((K, 7)).astype(dtype),
            "c": (0.01 * rng.standard_normal((K, 2))).astype(dtype)}


def _ref_noise(key, leaves):
    return [np.array(jax.random.normal(jax.random.fold_in(key, i),
                                       np.shape(l), jnp.float32))
            for i, l in enumerate(leaves)]


@pytest.mark.parametrize("clip", [0.5, 4.0, 100.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_and_noise_at_noise_zero_equals_the_reference(dtype, clip):
    g = _grads(1)
    ref_g = {k: jnp.asarray(v, dtype) for k, v in g.items()}
    port_g = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        getattr(torch, dtype)) for k, v in ref_g.items()}
    ref = ref_priv.clip_and_noise(ref_g, KEY, clip=clip, noise_multiplier=0.0)
    out = priv.clip_and_noise(port_g, None, clip=clip, noise_multiplier=0.0)
    for k in g:
        want = np.asarray(ref[k].astype(jnp.float32))
        got = out[k].float().numpy()
        assert out[k].dtype == port_g[k].dtype
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("noise_multiplier", [0.3, 2.0])
def test_clip_and_noise_with_the_reference_draws(noise_multiplier):
    g = _grads(2)
    key = jax.random.PRNGKey(7)
    ref = ref_priv.clip_and_noise({k: jnp.asarray(v) for k, v in g.items()},
                                  key, clip=1.0,
                                  noise_multiplier=noise_multiplier)
    leaves = [g[k] for k in sorted(g)]
    draws = Draws(noise=[torch.from_numpy(n)
                         for n in _ref_noise(key, leaves)])
    out = priv.clip_and_noise({k: torch.from_numpy(v) for k, v in g.items()},
                              draws, clip=1.0,
                              noise_multiplier=noise_multiplier)
    for k in g:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6)


def test_clip_bounds_the_per_agent_norm_and_keeps_direction():
    g = {"a": torch.full((3, 2), 10.0), "b": torch.full((3, 4), 10.0)}
    out = priv.clip_and_noise(g, None, clip=1.0, noise_multiplier=0.0)
    norm = (out["a"] ** 2).sum(1) + (out["b"] ** 2).sum(1)
    np.testing.assert_allclose(norm.sqrt().numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose((out["a"] / out["b"][:, :2]).numpy(), 1.0,
                               rtol=1e-5)
    small = {"a": torch.tensor([[0.1, 0.2]])}
    assert torch.equal(priv.clip_and_noise(small, None, clip=1.0,
                                           noise_multiplier=0.0)["a"],
                       small["a"])


def test_noise_std_by_law():
    """Zero gradients: the output is the noise alone, N(0, (sigma clip)^2)
    per coordinate, independent across agents and leaves."""
    K, n = 4, 50_000
    g = {"a": torch.zeros(K, n), "b": torch.zeros(K, n // 2)}
    gen = torch.Generator().manual_seed(3)
    out = priv.clip_and_noise(g, gen, clip=0.5, noise_multiplier=1.6)
    x = torch.cat([out["a"].reshape(-1), out["b"].reshape(-1)]).double()
    se = 0.8 / np.sqrt(x.numel())
    assert abs(x.mean().item()) < 5 * se
    assert abs(x.std().item() / 0.8 - 1.0) < 5 / np.sqrt(2 * x.numel())
    c = np.corrcoef(out["a"][0].numpy(), out["a"][1].numpy())[0, 1]
    assert abs(c) < 5 / np.sqrt(n)


def test_private_gradients_counter_and_stream():
    t = priv.PrivateGradients(1.0, 0.5, seed=4)
    with pytest.raises(ValueError, match="engine.optimizer.init"):
        t.update({"w": torch.ones(2, 3)}, None, None)
    g = {"w": torch.zeros(2, 3)}
    state = t.init(g)
    assert state["t"].device.type == "cpu" and state["inner"] is None
    u0, state = t.update(g, state, g)
    u1, state = t.update(g, state, g)
    assert int(state["t"]) == 2 and not torch.equal(u0["w"], u1["w"])
    again = priv.PrivateGradients(1.0, 0.5, seed=4)
    v0, _ = again.update(g, again.init(g), g)
    assert torch.equal(u0["w"], v0["w"])
    with pytest.raises(ValueError, match="clip"):
        priv.PrivateGradients(0.0, 1.0)
    with pytest.raises(ValueError, match="noise_multiplier"):
        priv.PrivateGradients(1.0, -1.0)


# ---------------------------------------------------------------------------
# secure-agg wire masks
# ---------------------------------------------------------------------------

def _ref_prev(live):
    """The reference's predecessor expression (repro.core.privacy's
    stage), on a given live set."""
    K = live.shape[0]
    idx = jnp.arange(K)
    dist = (idx[:, None] - idx[None, :]) % K
    dist = jnp.where(dist == 0, K, dist)
    dd = jnp.where(jnp.asarray(live)[:, None, :], dist[None, :, :], K + 1)
    return np.asarray(jnp.argmin(dd, axis=-1))


@pytest.mark.parametrize("K", [2, 3, 8, 13])
def test_predecessors_equal_the_reference(K):
    rng = np.random.default_rng(K)
    sets = [np.zeros((K, K), bool), ~np.eye(K, dtype=bool)]
    single = np.zeros((K, K), bool)
    single[np.arange(K), (np.arange(K) + 1) % K] = True
    sets.append(single)
    sets += [(rng.random((K, K)) < p) & ~np.eye(K, dtype=bool)
             for p in (0.2, 0.5, 0.8) for _ in range(4)]
    for live in sets:
        prev = priv.predecessors(live)
        np.testing.assert_array_equal(prev, _ref_prev(live))
        for k in range(K):        # a bijection on each live set
            members = np.flatnonzero(live[k])
            assert sorted(prev[k, members]) == list(members)


def _stack(K, seed):
    rng = np.random.default_rng(seed)
    return {"u": rng.standard_normal((K, 5)).astype(np.float32),
            "v": rng.standard_normal((K, 2, 3)).astype(np.float32)}


def _ref_eta(seed, t, X, K):
    """The reference stage's standard normals, flattened across leaves."""
    key_t = jax.random.fold_in(jax.random.PRNGKey(seed), t)
    leaves = [X[k] for k in sorted(X)]
    return np.concatenate([np.array(jax.random.normal(
        jax.random.fold_in(key_t, i), (K, K, leaf[0].size), jnp.float32))
        for i, leaf in enumerate(leaves)], axis=-1)


_MASKS = ([1.0] * 6, [1, 0, 1, 1, 0, 1], [0.0] * 6, [1, 1, 0, 0, 0, 0],
          [0, 1, 0, 0, 0, 0])


@pytest.mark.parametrize("tile_elems", [None, 36 * 2])
@pytest.mark.parametrize("active", _MASKS)
def test_secure_agg_with_the_reference_masks(active, tile_elems,
                                             monkeypatch):
    """The reference's eta injected: the port's stage within 1e-6 of the
    reference's, also when the column tiles cut through leaves."""
    if tile_elems is not None:
        monkeypatch.setattr(priv, "MASK_TILE_ELEMS", tile_elems)
    K, seed, t = 6, 11, 2
    A = ref_make_topology("ring", K).A.astype(np.float32)
    X = _stack(K, 0)
    act = np.asarray(active, np.float32)
    ref = ref_priv.make_secure_agg(K, seed=seed, mask_scale=3.0)(
        {k: jnp.asarray(v) for k, v in X.items()}, jnp.asarray(act),
        jnp.asarray(A), jnp.uint32(t))
    stage = priv.make_secure_agg(K, seed=seed, mask_scale=3.0)
    out = stage({k: torch.from_numpy(v) for k, v in X.items()},
                torch.from_numpy(act), torch.from_numpy(A), t,
                eta=torch.from_numpy(_ref_eta(seed, t, X, K)))
    for k in X:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("tile_elems", [None, 36 * 3])
@pytest.mark.parametrize("active", _MASKS)
def test_secure_agg_own_masks_cancel(active, tile_elems, monkeypatch):
    """The port's own masks telescope to zero (5e-5, the reference's
    gate), inactive receivers keep their rows bit-exactly, a receiver with
    one live sender gets it in the clear."""
    if tile_elems is not None:
        monkeypatch.setattr(priv, "MASK_TILE_ELEMS", tile_elems)
    K = 6
    A = make_topology("ring", K).A.astype(np.float32)
    X = _stack(K, 1)
    act = np.asarray(active, np.float32)
    stage = priv.make_secure_agg(K, seed=11, mask_scale=3.0)
    out = stage({k: torch.from_numpy(v) for k, v in X.items()},
                torch.from_numpy(act), torch.from_numpy(A), 2)
    W = masked_combination_np(A, act).T
    for k in X:
        want = W @ X[k].reshape(K, -1)
        got = out[k].numpy().reshape(K, -1)
        np.testing.assert_allclose(got, want, atol=MASK_TOL)
        for j, a in enumerate(act):
            if not a:
                np.testing.assert_array_equal(got[j], X[k].reshape(K, -1)[j])


def test_secure_agg_mask_stream_varies_by_block():
    K = 4
    A = torch.from_numpy(make_topology("ring", K).A.astype(np.float32))
    X = torch.from_numpy(_stack(K, 2)["u"])
    stage = priv.make_secure_agg(K, seed=3)
    want = A.T @ X
    for t in (0, 1, 17):
        torch.testing.assert_close(stage(X, torch.ones(K), A, t), want,
                                   atol=MASK_TOL, rtol=0)
    e0 = torch.randn(4, generator=priv.mask_generator(3, 0, "cpu"))
    e1 = torch.randn(4, generator=priv.mask_generator(3, 1, "cpu"))
    assert not torch.equal(e0, e1)


def test_secure_agg_rejects_single_agent_and_counts_tiles():
    with pytest.raises(ValueError, match="num_agents >= 2"):
        priv.make_secure_agg(1)
    assert priv.mask_tiles(8, 361_821_120) == 346
    assert priv.mask_tiles(2, 10) == 1


def test_pipeline_secure_agg_guards():
    topo = make_topology("ring", 4)
    stage = priv.make_secure_agg(4)
    dense = mixing.make_mixer("dense", topo, num_agents=4, device="cpu")
    with pytest.raises(ValueError, match="identity-mode"):
        mixing.CommPipeline(dense, Int8Stochastic(), secure_agg=stage)
    with pytest.raises(ValueError, match="no wire to mask"):
        mixing.CommPipeline(mixing.make_mixer("none", topo, num_agents=4,
                                              device="cpu"),
                            secure_agg=stage)
    with pytest.raises(ValueError, match="linear"):
        mixing.CommPipeline(mixing.make_mixer("trimmed_mean", topo,
                                              num_agents=4, device="cpu"),
                            secure_agg=stage)
    pipe = mixing.CommPipeline(dense, secure_agg=stage)
    assert pipe.stateful
    state = pipe.init_state(torch.zeros(4, 2))
    assert int(state["t"]) == 0
    A = torch.from_numpy(topo.A.astype(np.float32))
    out, state = pipe(torch.eye(4)[:, :2].contiguous(), torch.ones(4), A,
                      state)
    assert int(state["t"]) == 1
    torch.testing.assert_close(out, A.T @ torch.eye(4)[:, :2], atol=MASK_TOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _port_engine(K, T, graph=("static", ()), secure_agg=False, nm=0.7,
                 seed=0, noise=None, mix="dense", mode="uniform",
                 topology="ring", data=None):
    data = data or make_regression_problem(K=K, N=20, M=2, rho=0.1, seed=1)
    privacy = priv.Privacy(num_agents=K, clip=1.0, noise_multiplier=nm,
                           delta=1e-5, secure_agg=secure_agg, seed=seed,
                           steps_per_block=T)
    transform = priv.PrivateGradients(1.0, nm, seed=seed, noise=noise)
    eng = diff.DiffusionEngine(
        diff.DiffusionConfig(num_agents=K, local_steps=T, step_size=0.05,
                             topology=topology, participation=0.8,
                             graph=graph[0], graph_kwargs=graph[1], mix=mix,
                             local_steps_mode=mode),
        data.loss_fn(), transform.update, device="cpu", privacy=privacy,
        grad_fn=data.grad_fn())
    return eng, transform, data


def test_engine_threads_the_accountant_and_guards_its_state():
    K, T = 4, 2
    eng, transform, data = _port_engine(K, T)
    w = torch.zeros(K, 2)
    state = eng.init_state(w, transform.init(w))
    assert state.privacy_state["rdp"].shape == (len(priv.DEFAULT_ORDERS),)
    sampler = make_indexed_block_sampler(data, T=T, seed=0, device="cpu")
    rdp = np.zeros(len(priv.DEFAULT_ORDERS))
    key = torch.Generator().manual_seed(0)
    for i in range(3):
        state, m = eng.step(state, sampler(i), key)
        rdp += T * priv.rdp_increment_np(float(m["active"].mean()), 0.7)
        np.testing.assert_allclose(state.privacy_state["rdp"].numpy(), rdp,
                                   rtol=2e-4, atol=1e-6)
        assert float(m["epsilon"]) == pytest.approx(
            priv.epsilon_from_rdp_np(rdp, 1e-5), rel=2e-3)
    assert int(state.privacy_state["steps"]) == 3
    assert int(state.opt_state["t"]) == 3 * T
    with pytest.raises(ValueError, match="privacy_state is None"):
        eng.step(state.replace(privacy_state=None), sampler(3), key)


@pytest.mark.parametrize("graph", [("static", ()),
                                   ("link_dropout", (("drop", 0.3),))],
                         ids=["static", "link_dropout"])
def test_masked_and_unmasked_trajectories_agree(graph):
    """The same private run with and without the wire masks (the same
    noise stream): within the reference's 5e-5."""
    K, T = 6, 2
    finals = []
    for sa in (False, True):
        eng, transform, data = _port_engine(K, T, graph=graph,
                                            secure_agg=sa)
        w = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (K, 2)).astype(np.float32))
        state = eng.init_state(w, transform.init(w))
        sampler = make_indexed_block_sampler(data, T=T, seed=0,
                                             device="cpu")
        key = torch.Generator().manual_seed(5)
        for i in range(5):
            state, _ = eng.step(state, sampler(i), key)
        if sa:
            assert int(state.comm_state["t"]) == 5
        finals.append(state.params)
    torch.testing.assert_close(finals[1], finals[0], atol=MASK_TOL, rtol=0)


_STATIC, _DROP = ("static", ()), ("link_dropout", (("drop", 0.3),))


@pytest.mark.parametrize("graph,secure_agg,topology,mode", [
    (_STATIC, False, "ring", "uniform"), (_DROP, False, "ring", "uniform"),
    (_STATIC, True, "ring", "uniform"), (_DROP, True, "ring", "uniform"),
    (_STATIC, False, "scale_free", "degree"),
    (_STATIC, True, "scale_free", "degree")])
def test_engine_replays_the_reference(graph, secure_agg, topology, mode):
    """Three blocks of the reference's private engine, the port fed its
    realized draws: the participation and graph uniforms, the gradient
    noise ``normal(fold_in(fold_in(PRNGKey(seed), t), leaf))`` of every
    local step, and the masks of every block.  With
    ``local_steps_mode="degree"`` some agents freeze early while the
    noise counter, which has no agent axis, advances every local step."""
    K, T, M, seed, nm = 6, 2 if mode == "uniform" else 4, 2, 4, 0.7
    kw = dict(num_agents=K, local_steps=T, step_size=0.05,
              topology=topology, participation=0.8, graph=graph[0],
              graph_kwargs=graph[1], local_steps_mode=mode)
    ref_data = ref_make_problem(K=K, N=20, M=M, rho=0.1, seed=1)
    pkw = dict(num_agents=K, clip=1.0, noise_multiplier=nm, delta=1e-5,
               secure_agg=secure_agg, seed=seed, steps_per_block=T)
    ref_transform = ref_priv.PrivateGradients(1.0, nm, seed=seed)
    ref_eng = ref_diff.DiffusionEngine(
        ref_diff.DiffusionConfig(**kw), ref_data.loss_fn(),
        ref_transform.update, privacy=ref_priv.Privacy(**pkw))

    def noise(t):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        return Draws(noise=[torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(k, 0), (K, M), jnp.float32)))])

    eng, transform, data = _port_engine(K, T, graph=graph,
                                        secure_agg=secure_agg, nm=nm,
                                        seed=seed, noise=noise,
                                        topology=topology, mode=mode)
    assert (eng.step_mask is None) == (mode == "uniform")
    w0 = np.random.default_rng(0).standard_normal((K, M)).astype(np.float32)
    k0 = jax.random.fold_in(KEY, 0x5EED)
    ref_state = ref_eng.init_state(jnp.asarray(w0),
                                   ref_transform.init(jnp.asarray(w0)),
                                   key=k0)
    state = eng.init_state(torch.from_numpy(w0),
                           transform.init(torch.from_numpy(w0)))
    ref_sampler = ref_indexed_sampler(ref_data, T=T, seed=4)
    sampler = make_indexed_block_sampler(data, T=T, seed=4, device="cpu")
    for i in range(3):
        key = jax.random.fold_in(KEY, i)
        ref_state, ref_m = ref_eng.step(ref_state, ref_sampler(i), key)
        inject = {"graph_u": np.asarray(jax.random.uniform(
            jax.random.fold_in(key, GRAPH_FOLD), (K, K))),
            "part_u": np.asarray(jax.random.uniform(jax.random.split(key)[0],
                                                    (K,)))}
        if secure_agg:
            inject["comm_key"] = Draws(noise=torch.from_numpy(_ref_eta(
                seed, i, {"w": w0}, K)))
        state, m = eng.step(state, sampler(i), None, **inject)
        np.testing.assert_array_equal(m["active"].numpy(),
                                      np.asarray(ref_m["active"]))
        want = np.asarray(ref_state.params)
        assert (np.abs(state.params.numpy() - want)
                <= REPLAY_TOL * (1 + np.abs(want))).all(), i
        np.testing.assert_allclose(state.privacy_state["rdp"].numpy(),
                                   np.asarray(ref_state.privacy_state["rdp"]),
                                   rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(float(m["epsilon"]),
                                   float(ref_m["epsilon"]), rtol=2e-4,
                                   atol=1e-6)
        assert int(state.opt_state["t"]) == int(ref_state.opt_state["t"])


def test_degree_mode_with_privacy_freezes_agents_not_the_counter():
    """A hub-graph block in ``local_steps_mode="degree"``: the noise
    counter advances T times, and an agent frozen after T_k < T steps
    ends where a run of its own T_k steps does."""
    K, T = 6, 4
    eng, transform, data = _port_engine(K, T, topology="scale_free",
                                        mode="degree", nm=1e-3)
    t_k = eng.step_mask.sum(0).long()
    assert int(t_k.min()) < T
    sampler = make_indexed_block_sampler(data, T=T, seed=0, device="cpu")
    batch = sampler(0)
    w = torch.zeros(K, 2)
    state = eng.init_state(w, transform.init(w))
    state, _ = eng.step(state, batch, None, active=np.ones(K),
                        comm_key=None)
    assert int(state.opt_state["t"]) == T
    # the local updates alone, each agent for its own T_k steps, with the
    # same noise stream (one generator per local step, as the transform)
    grad = data.grad_fn()
    p = torch.zeros(K, 2)
    for t in range(T):
        g = priv.clip_and_noise(
            grad(p, tuple(x[t] for x in batch)),
            priv.noise_generator(0, t, "cpu"), clip=1.0,
            noise_multiplier=1e-3)
        p = p - 0.05 * (t < t_k).float()[:, None] * g
    A_eff = torch.as_tensor(eng.topology.A, dtype=torch.float32)
    torch.testing.assert_close(state.params, A_eff.T @ p, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the train driver's privacy flags
# ---------------------------------------------------------------------------

_ARGV = ["--device", "cpu", "--agents", "4", "--blocks", "3", "--batch", "1",
         "--seq", "16", "--optimizer", "sgd", "--step-size", "0.05"]


@pytest.mark.parametrize("flag", [
    ["--privacy-epsilon", "4"], ["--privacy-delta", "1e-6"],
    ["--privacy-clip", "2"], ["--privacy-noise", "1"],
    ["--privacy-secure-agg"], ["--privacy-allow-gauss"]])
def test_privacy_subflags_need_privacy(flag):
    with pytest.raises(ValueError, match="--privacy"):
        train.main(_ARGV + flag)


def test_privacy_refuses_gauss_without_the_opt_in():
    argv = _ARGV + ["--privacy", "--privacy-noise", "1.0", "--compress",
                    "gauss", "--compress-sigma", "0.1", "--blocks", "1"]
    with pytest.raises(ValueError, match="allow_gauss"):
        train.main(argv)
    out = train.main(argv + ["--privacy-allow-gauss"])
    assert out["blocks_done"] == 1


def test_budget_halt_fires_before_the_crossing_block(capsys):
    """A given noise multiplier with an epsilon budget (the budget then
    only halts): the run stops at the first block whose projection (the
    stationary rate's increment on the spend so far) passes the budget,
    after every block it ran was projected within it; the logged epsilon
    equals the numpy twins over the realized masks and never falls."""
    out = train.main(_ARGV + ["--privacy", "--privacy-noise", "1.5",
                              "--privacy-epsilon", "8", "--blocks", "40",
                              "--participation", "0.5"])
    p = out["privacy"]
    assert p.epsilon_budget == 8.0 and p.noise_multiplier == 1.5
    assert 0 < out["blocks_done"] < 40
    assert "privacy budget" in capsys.readouterr().out
    rdp = np.zeros(len(p.orders))
    inc_bar = 2 * priv.rdp_increment_np(0.5, 1.5)
    for active, eps in zip(out["active"], out["epsilon"]):
        assert priv.epsilon_from_rdp_np(rdp + inc_bar, 1e-5) <= 8.0
        rdp += 2 * priv.rdp_increment_np(float(np.mean(active)), 1.5)
        assert eps == pytest.approx(priv.epsilon_from_rdp_np(rdp, 1e-5),
                                    rel=2e-3)
    assert (priv.epsilon_from_rdp_np(rdp + inc_bar, 1e-5) > 8.0
            or out["epsilon"][-1] >= 8.0)
    assert out["epsilon"] == sorted(out["epsilon"])
    assert len(out["epsilon"]) == out["blocks_done"]


@pytest.mark.parametrize("extra", [[], ["--privacy-secure-agg", "--mix",
                                        "pallas"],
                                   ["--attack", "sign_flip"]])
def test_private_training_logs_epsilon(extra, capsys):
    out = train.main(_ARGV + ["--privacy", "--privacy-noise", "1.0"]
                     + extra)
    printed = capsys.readouterr().out
    assert "privacy: clip=1" in printed and "epsilon=" in printed
    assert len(out["epsilon"]) == 3 and out["privacy"] is not None
    assert out["epsilon"] == sorted(out["epsilon"])
    assert int(out["state"].opt_state["t"]) == 6      # T x blocks steps
    assert all(np.isfinite(x) for row in out["losses"] for x in row)
    assert ("secure-agg wire masks on" in printed) == bool(extra[:1] == [
        "--privacy-secure-agg"])


def test_privacy_flags_parse_as_the_reference():
    from repro.api.cli import add_spec_args
    ap = argparse.ArgumentParser()
    add_spec_args(ap)
    ref = vars(ap.parse_args([]))
    args = train._parser().parse_args([])
    train.check_privacy_flags(args)
    for dest in train._PRIVACY_FLAGS:
        assert getattr(args, dest) == ref[dest], dest
    assert args.privacy is ref["privacy"] is False
