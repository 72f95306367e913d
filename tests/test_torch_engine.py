"""Port parity: Algorithm 1's training path.

The optimizers, participation, schedules, state, static graph, identity
pipeline and synthetic data of ``repro_torch`` against ``repro``, and the
stacked engine's block step in replay parity: the port is fed the
reference's realized activation masks and the same numpy batches and
weights, and must reach the same parameters."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import attacks as ref_attacks  # noqa: E402
from repro.core import diffusion as ref_diff  # noqa: E402
from repro.core import participation as ref_part  # noqa: E402
from repro.core.state import EngineState as RefEngineState  # noqa: E402
from repro.data.synthetic import lm_token_batch as ref_lm_batch  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import diffusion as diff  # noqa: E402
from repro_torch.core.attacks import make_attack  # noqa: E402
from repro_torch.core.compression import TopK  # noqa: E402
from repro_torch.core import graphs, mixing, schedules  # noqa: E402
from repro_torch.core import participation as part  # noqa: E402
from repro_torch.core.state import EngineState  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.data.synthetic import lm_token_batch  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

K, T, B, S = 4, 2, 2, 32


def _to_torch(tree):
    return params_from_jax(jax.device_get(tree), device="cpu")


def _assert_tree_close(got, want, atol, rtol=0.0):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizer_steps_match_reference(name):
    rng = np.random.default_rng(0)
    params = {"w": jnp.asarray(rng.standard_normal((K, 5, 3)), jnp.float32),
              "b": jnp.asarray(rng.standard_normal((K, 7)), jnp.bfloat16)}
    ref_t, t = getattr(ref_opt, name)(), getattr(opt, name)()
    ref_s, s = ref_t.init(params), t.init(_to_torch(params))
    for step in range(3):
        grads = {k: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
                 for k, v in params.items()}
        ref_u, ref_s = ref_t.update(grads, ref_s, params)
        u, s = t.update(_to_torch(grads), s, _to_torch(params))
        for a, b in zip(tree_leaves(u), jax.tree.leaves(ref_u)):
            assert str(a.dtype).removeprefix("torch.") == b.dtype.name
            # bf16 updates: one bf16 ulp of |u| <= 1 apart at most
            tol = 1e-6 if a.dtype == torch.float32 else 2 ** -8
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       atol=tol, rtol=tol)
        if name != "sgd":
            for a, b in zip(tree_leaves(s), jax.tree.leaves(ref_s)):
                np.testing.assert_allclose(a.float().numpy(),
                                           np.asarray(b, np.float32),
                                           atol=1e-6, rtol=1e-6)
    if name == "adam":
        assert s["t"].dtype == torch.int32 and int(s["t"]) == 3
        assert all(x.dtype == torch.float32 for x in tree_leaves(s["m"]))


@pytest.mark.parametrize("name", ["momentum", "adam"])
def test_optimizer_update_advances_state_in_place(name):
    """One set of optimizer state per run: ``update`` writes the new state
    into the tensors it was given and returns them."""
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(K, 5, 3, generator=gen),
              "b": torch.randn(K, 7, generator=gen).bfloat16()}
    t = getattr(opt, name)()
    s = t.init(params)
    before = [x.clone() for x in tree_leaves(s)]
    grads = tree_map(lambda x: torch.randn(x.shape, generator=gen).to(
        x.dtype), params)
    _, s_new = t.update(grads, s, params)
    assert s_new is s
    assert ([x.data_ptr() for x in tree_leaves(s_new)]
            == [x.data_ptr() for x in tree_leaves(s)])
    assert all(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(s)))


def test_local_update_scan_keeps_frozen_agents_adam_state():
    """A frozen agent keeps its parameters and its Adam moments through the
    in-place update; the others take the reference's Adam step."""
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((K, 6)).astype(np.float32)
    xs = rng.standard_normal((T, K, 6)).astype(np.float32)
    step_mask = np.array([[1, 1, 1, 1], [1, 0, 1, 0]], np.float32)
    mus = np.array([0.1, 0.1, 0.0, 0.1], np.float32)

    def loss(p, b):
        return ((p["w"] - b["x"]) ** 2).sum()

    ref_t = ref_opt.adam()
    ref_p, ref_s = ref_diff.local_update_scan(
        jax.vmap(jax.grad(loss)), {"w": jnp.asarray(w0)},
        ref_t.init({"w": jnp.asarray(w0)}), jnp.asarray(mus),
        {"x": jnp.asarray(xs)}, local_steps=T, grad_transform=ref_t.update,
        step_mask=jnp.asarray(step_mask))
    t = opt.adam()

    def port(steps):
        p0 = {"w": torch.from_numpy(w0)}
        s0 = t.init(p0)
        p, s = diff.local_update_scan(
            diff.stacked_grad(loss), p0, s0, torch.from_numpy(mus),
            {"x": torch.from_numpy(xs[:steps])}, local_steps=steps,
            grad_transform=t.update,
            step_mask=torch.from_numpy(step_mask[:steps]))
        assert s is s0
        return p, s

    p, s = port(T)
    # float32 sums of two frameworks
    _assert_tree_close(p, ref_p, atol=1e-6)
    for key in ("m", "v"):
        _assert_tree_close(s[key], ref_s[key], atol=1e-6, rtol=1e-6)
    assert int(s["t"]) == int(ref_s["t"]) == T
    # agents 1 and 3, frozen at step 1, hold exactly their step-0 values
    p1, s1 = port(1)
    frozen = [1, 3]
    for a, b in ((p["w"], p1["w"]), (s["m"]["w"], s1["m"]["w"]),
                 (s["v"]["w"], s1["v"]["w"])):
        assert torch.equal(a[frozen], b[frozen])
        assert not torch.equal(a[[0, 2]], b[[0, 2]])


# ---------------------------------------------------------------------------
# participation, schedules, state, graphs, pipeline, data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drift", [False, True])
def test_step_size_matrix_matches_reference(drift):
    q = np.array([0.9, 0.5, 0.25, 1.0], np.float32)
    active = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    want = ref_part.step_size_matrix(0.3, jnp.asarray(active), jnp.asarray(q),
                                     drift)
    got = part.step_size_matrix(0.3, torch.from_numpy(active),
                                torch.from_numpy(q), drift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if drift:
        with pytest.raises(ValueError, match="requires q"):
            part.step_size_matrix(0.3, torch.from_numpy(active), None, True)


def test_sample_active_law_and_closed_forms():
    """Law parity: both samplers' activation frequencies sit within 5 sigma
    of q; every realized matrix is doubly stochastic; the Lemma-1 closed
    forms equal the reference's."""
    q = np.array([0.9, 0.5, 0.25, 0.7, 0.05, 1.0])
    n = 4000
    gen = torch.Generator().manual_seed(0)
    masks = part.sample_active(gen, torch.from_numpy(np.tile(q, (n, 1))))
    masks = masks.numpy()
    ref_masks = np.asarray(jax.vmap(lambda k: ref_part.sample_active(
        k, jnp.asarray(q, jnp.float32)))(jax.random.split(
            jax.random.PRNGKey(0), n)))
    sigma = np.sqrt(q * (1 - q) / n)
    for m in (masks, ref_masks):
        assert set(np.unique(m)) <= {0.0, 1.0}
        assert (np.abs(m.mean(0) - q) <= 5 * sigma + 1e-12).all()
    A = torch.as_tensor(make_topology("erdos", 6, seed=1).A)
    for m in masks[:200]:
        Am = part.masked_combination(A, torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(Am.sum(0), 1.0, atol=1e-12)
        np.testing.assert_allclose(Am.sum(1), 1.0, atol=1e-12)
    A_np = A.numpy()
    np.testing.assert_allclose(part.expected_combination(A_np, q),
                               ref_part.expected_combination(A_np, q))
    np.testing.assert_allclose(part.expected_step_sizes(0.1, q),
                               ref_part.expected_step_sizes(0.1, q))
    np.testing.assert_allclose(part.expected_A_M(A_np, q, 0.1),
                               ref_part.expected_A_M(A_np, q, 0.1))


def test_schedules_state_graphs_and_pipeline():
    cfg = diff.DiffusionConfig(num_agents=K, participation=0.7)
    proc, q = schedules.resolve(cfg, None)
    assert isinstance(proc, schedules.IIDBernoulli) and not proc.stateful
    np.testing.assert_array_equal(q, np.full(K, 0.7))
    with pytest.raises(ValueError, match="agents"):
        schedules.resolve(cfg, schedules.IIDBernoulli(0.5, num_agents=3))
    # the stateful processes (tests/test_torch_graphs.py holds them
    # against the reference)
    markov = schedules.MarkovAvailability(0.5, 0.3, num_agents=K)
    cyclic = schedules.CyclicGroups(K, 2)
    for proc in (markov, cyclic):
        assert proc.stateful
        assert schedules.resolve(cfg, proc)[0] is proc
    # the same seven fields in the reference's order
    assert ([f.name for f in dataclasses.fields(EngineState)]
            == [f.name for f in dataclasses.fields(RefEngineState)])
    topo = make_topology("ring", K)
    g = graphs.make_graph_process("static", topo, device="cpu")
    A_t, st = g.sample((), None)
    np.testing.assert_array_equal(A_t.numpy(), topo.A.astype(np.float32))
    for kind, stateful, on_support, kw in (
            ("link_dropout", False, True, {}),
            ("link_dropout", True, True, {"corr": 0.5}),
            ("gossip", False, True, {}), ("tv_erdos", False, False, {})):
        proc = graphs.make_graph_process(kind, topo, **kw)
        assert (proc.stateful, proc.within_base_support) == (stateful,
                                                             on_support)
    mixer = mixing.make_mixer("dense", topo)
    pipe = mixing.CommPipeline(mixer)
    assert pipe.mode == "identity" and not pipe.stateful
    tree = {"w": torch.randn(K, 3, generator=torch.Generator().manual_seed(0))}
    active = torch.tensor([1.0, 0.0, 1.0, 1.0])
    got, cs = pipe(tree, active, A_t, ())
    torch.testing.assert_close(got["w"], mixer(tree, active, A_t)["w"],
                               rtol=0, atol=0)
    assert cs == ()
    # the compressed modes (tests/test_torch_compression.py holds them
    # against the reference): a sparsifier resolves to diff mode, and the
    # Identity compressor forced into diff or direct mode still equals the
    # plain mixer
    pipe = mixing.CommPipeline(mixer, TopK(0.1))
    assert pipe.mode == "diff" and pipe.stateful and pipe.gamma == 0.5
    for mode in ("diff", "direct"):
        pipe = mixing.CommPipeline(mixer, mode=mode)
        assert pipe.mode == mode
        got, _ = pipe(tree, active, A_t, pipe.init_state(tree))
        torch.testing.assert_close(got["w"], mixer(tree, active, A_t)["w"],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("changes", [{"compress": "topk"},
                                     {"error_feedback": True}])
def test_engine_refuses_unported_compression(changes):
    """Compression is ported: the engine builds with these settings, as
    the reference's does, and its state carries what the pipeline needs
    (top-k: the diff-mode reference copy; error feedback alone wraps
    nothing, since Identity is never wrapped, so no state)."""
    from repro.core import DiffusionEngine as RefEngine
    from repro.core import DiffusionConfig as RefConfig

    cfg = diff.DiffusionConfig(num_agents=K, **changes)
    eng = diff.DiffusionEngine(cfg, lambda p, b: 0.0, device="cpu")
    ref = RefEngine(RefConfig(**dataclasses.asdict(cfg)), lambda p, b: 0.0)
    assert eng.pipeline.mode == ref.pipeline.mode
    assert eng.pipeline.stateful == ref.pipeline.stateful
    params = {"w": torch.zeros(K, 3)}
    state = eng.init_state(params)
    ref_state = ref.init_state({"w": jnp.zeros((K, 3))})
    if ref.pipeline.stateful:
        assert tuple(state.comm_state["ref"]["w"].shape) == (K, 3)
        assert ref_state.comm_state["ref"]["w"].shape == (K, 3)
    else:
        assert state.comm_state is None and ref_state.comm_state is None


def test_lm_token_batch_layout_matches_reference():
    ref = ref_lm_batch(jax.random.PRNGKey(0), (T, K, B, S), 512)
    got = lm_token_batch(torch.Generator().manual_seed(0), (T, K, B, S), 512)
    for name in ("tokens", "labels"):
        assert tuple(got[name].shape) == ref[name].shape
        assert got[name].dtype == torch.int32
    toks = got["tokens"]
    assert 0 <= int(toks.min()) and int(toks.max()) < 512
    np.testing.assert_array_equal(got["labels"][..., :-1], toks[..., 1:])
    assert (got["labels"][..., -1] == 0).all()


def test_degree_step_mask_matches_reference():
    cfg = diff.DiffusionConfig(num_agents=8, local_steps=4, topology="erdos",
                               topology_kwargs=(("p", 0.35), ("seed", 2)),
                               local_steps_mode="degree")
    ref_cfg = ref_diff.DiffusionConfig(**dataclasses.asdict(cfg))
    want = ref_diff.resolve_step_mask(ref_cfg, ref_cfg.make_topology())
    got = diff.resolve_step_mask(cfg, cfg.make_topology())
    assert want is not None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    regular = dataclasses.replace(cfg, topology="ring", topology_kwargs=())
    assert diff.resolve_step_mask(regular, regular.make_topology()) is None


# ---------------------------------------------------------------------------
# replay parity of DiffusionEngine.step
# ---------------------------------------------------------------------------

def _stacked_weights(ref_cfg, num_agents, seed=0):
    """Seeded numpy weights at the reference's init scales, stacked."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        shape = (num_agents,) + s.shape
        if "scale" in name:
            w = 1.0 + 0.1 * rng.standard_normal(shape)
        elif "embed" in name:
            w = 0.02 * rng.standard_normal(shape)
        else:
            w = rng.standard_normal(shape) / np.sqrt(s.shape[-2])
        return jnp.asarray(w, s.dtype)

    return jax.tree_util.tree_map_with_path(leaf,
                                            ref_tf.param_specs(ref_cfg))


def _blocks(n, num_agents, local_steps, vocab, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, vocab, (local_steps, num_agents, B, S)
                           ).astype(np.int32)
        lab = np.concatenate([tok[..., 1:], np.zeros_like(tok[..., :1])], -1)
        out.append({"tokens": tok, "labels": lab})
    return out


def _reference_run(dcfg, optimizer, blocks, num_agents, mixer=None,
                   attack=None):
    """The reference's stacked engine (use_kernels=False; the config's
    mixer unless ``mixer`` is given; ``attack`` a dict of make_attack
    arguments wrapping the optimizer): returns the realized masks per
    block and the final params."""
    cfg = ref_get_config("smollm-360m").smoke
    t = getattr(ref_opt, optimizer)()
    if attack is not None:
        t = ref_attacks.make_attack(num_agents=num_agents, inner=t, **attack)
    plain_sgd = optimizer == "sgd" and attack is None
    eng = ref_diff.DiffusionEngine(
        ref_diff.DiffusionConfig(**dataclasses.asdict(dcfg)),
        lambda p, b: ref_tf.train_loss(p, cfg, b, remat=False),
        None if plain_sgd else t.update, mixer=mixer)
    params = _stacked_weights(cfg, num_agents)
    state = eng.init_state(params, t.init(params))
    masks = []
    for i, blk in enumerate(blocks):
        state, metrics = eng.step(state, jax.tree.map(jnp.asarray, blk),
                                  jax.random.PRNGKey(100 + i))
        masks.append(np.array(metrics["active"]))
    return params, masks, jax.device_get(state.params)


def _port_run(dcfg, optimizer, blocks, masks, params, use_kernels,
              attack=None, **engine_kwargs):
    cfg = get_config("smollm-360m").smoke
    cfg = dataclasses.replace(cfg, use_kernels=use_kernels)
    t = getattr(opt, optimizer)()
    if attack is not None:
        t = make_attack(num_agents=dcfg.num_agents, inner=t, **attack)
    plain_sgd = optimizer == "sgd" and attack is None
    eng = diff.DiffusionEngine(
        dcfg, lambda p, b: tf.train_loss(p, cfg, b, remat=False),
        None if plain_sgd else t.update, device="cpu", **engine_kwargs)
    p = _to_torch(params)
    state = eng.init_state(p, t.init(p))
    gen = torch.Generator().manual_seed(0)
    for blk, m in zip(blocks, masks):
        batch = tree_map(torch.from_numpy, blk)
        state, metrics = eng.step(state, batch, gen, active=m)
        np.testing.assert_array_equal(metrics["active"].numpy(), m)
    return eng, state


# sgd: the float32 sums of two frameworks, through 6 local steps.  Adam:
# its update m / (sqrt(v) + eps) is about +-1 for any gradient far above
# eps, so float32 noise in a near-zero gradient can move a weight by up to
# 2 mu in one step; the gate is 2 mu T blocks at such elements and 1e-5
# relative elsewhere (checked as: 99.9 % of weights within 1e-5)
_MU = {"sgd": 0.1, "adam": 1e-3}


@pytest.fixture(scope="module")
def reference_runs():
    runs = {}
    for name in ("sgd", "adam"):
        dcfg = diff.DiffusionConfig(num_agents=K, local_steps=T,
                                    step_size=_MU[name], topology="ring",
                                    participation=0.9, mix="dense")
        blocks = _blocks(3, K, T, 512)
        runs[name] = (dcfg, blocks) + _reference_run(dcfg, name, blocks, K)
    return runs


def _assert_replay(optimizer, state, want, n_blocks):
    """The gates above: sgd within 1e-5; Adam within 2 mu T blocks, 99.9 %
    of weights within 1e-5."""
    if optimizer == "sgd":
        _assert_tree_close(state.params, want, atol=1e-5)
        return
    bound = 2 * _MU["adam"] * T * n_blocks
    n_far = n = 0
    for g, w in zip(tree_leaves(state.params), jax.tree.leaves(want)):
        d = np.abs(g.numpy() - np.asarray(w))
        assert d.max() <= bound
        n_far += int((d > 1e-5 * (1 + np.abs(np.asarray(w)))).sum())
        n += d.size
    assert n_far <= 1e-3 * n, (n_far, n)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("mix", ["dense", "pallas"])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_engine_step_replay_parity(reference_runs, optimizer, mix,
                                   use_kernels):
    dcfg, blocks, params, masks, want = reference_runs[optimizer]
    eng, state = _port_run(dataclasses.replace(dcfg, mix=mix), optimizer,
                           blocks, masks, params, use_kernels)
    assert type(eng.mixer).__name__ == {"dense": "DenseMixer",
                                        "pallas": "PallasFusedMixer"}[mix]
    _assert_replay(optimizer, state, want, len(blocks))


# the reference's byzantine_robust_diffusion preset at K = 12: 3 evenly
# spaced sign-flip adversaries of scale 3, per-neighborhood trimmed mean
_KB = 12
_ATTACK = {"kind": "sign_flip", "num_byzantine": 3, "scale": 3.0}


@pytest.fixture(scope="module")
def byzantine_runs():
    """The reference's engine on its gather-table paths: the robust preset
    (trimmed mean, neighborhood scope, gather table, sign-flip attack) and
    the honest gather mixer, with SGD and with Adam, 2 blocks."""
    from repro.core import make_topology as ref_make_topology
    from repro.core import mixing as ref_mixing

    topo = ref_make_topology("ring", _KB)
    runs = {}
    for mix, attack in (("trimmed_mean", _ATTACK), ("gather", None)):
        for name in ("sgd", "adam"):
            dcfg = diff.DiffusionConfig(num_agents=_KB, local_steps=T,
                                        step_size=_MU[name], topology="ring",
                                        participation=0.9, mix=mix)
            mixer = (ref_mixing.make_mixer(mix, topo, trim=1,
                                           scope="neighborhood",
                                           gather="table")
                     if mix == "trimmed_mean" else
                     ref_mixing.make_mixer(mix, topo))
            blocks = _blocks(2, _KB, T, 512, seed=4)
            runs[mix, name] = (dcfg, blocks) + _reference_run(
                dcfg, name, blocks, _KB, mixer=mixer, attack=attack)
    return runs


@pytest.mark.parametrize("mix,gather,optimizer", [
    ("trimmed_mean", "table", "sgd"), ("trimmed_mean", "fused", "sgd"),
    ("trimmed_mean", "fused", "adam"), ("gather", None, "sgd"),
    ("gather", None, "adam")])
def test_engine_byzantine_and_gather_replay_parity(byzantine_runs, mix,
                                                   gather, optimizer):
    """The port's engine against the reference's on smollm-smoke at K = 12:
    the Byzantine preset (the port's gather table and the fused kernel's
    plain version against the reference's gather table) and the gather
    mixer, replaying the reference's masks and batches."""
    dcfg, blocks, params, masks, want = byzantine_runs[mix, optimizer]
    kwargs = ({"trim": 1, "scope": "neighborhood", "gather": gather,
               "attack": _ATTACK} if mix == "trimmed_mean" else {})
    eng, state = _port_run(dcfg, optimizer, blocks, masks, params, False,
                           **kwargs)
    assert type(eng.mixer).__name__ == {
        "table": "TrimmedMeanMixer", "fused": "FusedNeighborhoodMixer",
        None: "NeighborGatherMixer"}[gather]
    _assert_replay(optimizer, state, want, len(blocks))


def test_engine_degree_step_mask_replay_parity():
    """local_steps_mode="degree" on an erdos graph: frozen agents keep their
    parameters and momentum buffers."""
    dcfg = diff.DiffusionConfig(num_agents=6, local_steps=2, step_size=0.1,
                                topology="erdos",
                                topology_kwargs=(("p", 0.35), ("seed", 2)),
                                participation=0.9, mix="dense",
                                local_steps_mode="degree")
    blocks = _blocks(2, 6, 2, 512, seed=2)
    params, masks, want = _reference_run(dcfg, "momentum", blocks, 6)
    eng, state = _port_run(dcfg, "momentum", blocks, masks, params, False)
    assert eng.step_mask is not None and (eng.step_mask == 0).any()
    _assert_tree_close(state.params, want, atol=1e-5)


def test_network_msd_and_run():
    cfg = diff.DiffusionConfig(num_agents=3, local_steps=2, step_size=0.2,
                               participation=1.0, topology="full")
    w_star = torch.tensor([1.0, -2.0])

    def loss(p, b):
        return ((p["w"] - b["x"]) ** 2).sum()

    eng = diff.DiffusionEngine(cfg, loss, device="cpu")
    params = {"w": torch.zeros(3, 2)}
    np.testing.assert_allclose(
        float(diff.network_msd(params, {"w": w_star})),
        float(ref_diff.network_msd({"w": jnp.zeros((3, 2))},
                                   {"w": jnp.asarray([1.0, -2.0])})))

    def sampler(key):
        return {"x": w_star.expand(2, 3, 2).clone()}

    final, _, hist = eng.run(params, sampler, 20, w_star={"w": w_star})
    assert hist[-1] < hist[0] < float(diff.network_msd(params,
                                                       {"w": w_star}))
    torch.testing.assert_close(final["w"], w_star.expand(3, 2), atol=1e-3,
                               rtol=0)
