"""Port parity: the experiment API (``repro_torch.api``) against the
reference's (``repro.api``).

Spec JSON is byte-equal per preset and for exotic fields; unknown registry
keys and JSON fields raise the reference's messages; ``build(spec)`` is
bit-equal to the engine built by hand, per preset, and replays the
reference's ``build(spec)`` block for block on the §VII regression with
the reference's realized draws injected; the shared CLI maps the same argv
to byte-equal spec JSON in both packages; the ``auto`` engine builds the
stacked engine in the sharded one's place; spec checkpoints round-trip
across both packages."""
import argparse
import dataclasses
import importlib
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.api import cli as ref_cli  # noqa: E402
from repro.checkpoint import store as ref_store  # noqa: E402
from repro.core import variants as ref_variants  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    make_indexed_block_sampler as ref_indexed_sampler,
    make_regression_problem as ref_make_problem)
from repro_torch import api  # noqa: E402
from repro_torch.api import cli  # noqa: E402
from repro_torch.api.spec import (  # noqa: E402
    CompressionSpec, ExperimentSpec, MixerSpec, ModelSpec, OptimizerSpec,
    ParticipationSpec, Registry, RunSpec, TopologySpec)
from repro_torch.checkpoint import (load_experiment, load_spec,  # noqa: E402
                                    save_checkpoint, save_experiment)
from repro_torch.core import compression as comp  # noqa: E402
from repro_torch.core import variants  # noqa: E402
from repro_torch.core.attacks import make_attack  # noqa: E402
from repro_torch.core.diffusion import (DiffusionConfig,  # noqa: E402
                                        DiffusionEngine)
from repro_torch.core.mixing import TrimmedMeanMixer  # noqa: E402
from repro_torch.core.sharded import ShardedEngine  # noqa: E402
from repro_torch.core.schedules import (CyclicGroups,  # noqa: E402
                                        MarkovAvailability)
from repro_torch.core.state import EngineState  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    make_indexed_block_sampler, make_regression_problem)
from repro_torch.launch import train  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

K = 6
#: the engine's graph key is ``fold_in(block key, 0x9A)``
GRAPH_FOLD = 0x9A
#: port against reference, per entry, times (1 + |w|): float32 summation
#: order (tests/test_torch_graphs.py's replay gate)
REPLAY_TOL = 1e-5


def _factories(pkg):
    """Every Section-IV preset of ``pkg`` (``variants`` of either
    package), parameterized as the reference's tests/test_api.py does."""
    v = pkg
    return {
        "fedavg_full": lambda: v.fedavg_full(K, T=3, mu=0.02),
        "fedavg_partial_uniform":
            lambda: v.fedavg_partial_uniform(K, T=2, mu=0.05, q=0.6),
        "vanilla_diffusion": lambda: v.vanilla_diffusion(K, mu=0.05),
        "asynchronous_diffusion":
            lambda: v.asynchronous_diffusion(K, mu=0.03, q=0.6),
        "decentralized_fedavg":
            lambda: v.decentralized_fedavg(K, T=4, mu=0.02),
        "cyclic_fedavg":
            lambda: v.cyclic_fedavg(K, T=2, mu=0.02, num_groups=3),
        "markov_asynchronous_diffusion":
            lambda: v.markov_asynchronous_diffusion(K, mu=0.02, q=0.6,
                                                    corr=0.5),
        "link_dropout_diffusion":
            lambda: v.link_dropout_diffusion(K, mu=0.02, drop=0.3, corr=0.5,
                                             q=0.8),
        "compressed_diffusion":
            lambda: v.compressed_diffusion(K, mu=0.02, T=2, q=0.8,
                                           compress="topk", ratio=0.5),
        "compressed_fedavg":
            lambda: v.compressed_fedavg(K, T=2, mu=0.02, q=0.8),
        "byzantine_robust_diffusion":
            lambda: v.byzantine_robust_diffusion(K, mu=0.02, q=0.9,
                                                 num_byzantine=2, scale=3.0),
        "private_diffusion": lambda: v.private_diffusion(K, 0.02, T=1, q=0.8),
        "heterogeneous_diffusion":
            lambda: v.heterogeneous_diffusion(K, 0.02, T=2, q=0.8),
    }


PORT = _factories(variants)
REF = _factories(ref_variants)
PRESETS = sorted(PORT)


# ---------------------------------------------------------------------------
# spec JSON: byte-equal, round trips, unknown keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PRESETS)
def test_reference_preset_json_loads_and_reserializes_byte_equal(name):
    text = REF[name]().to_json()
    spec = ExperimentSpec.from_json(text)
    assert spec.to_json() == text
    assert spec.to_json(indent=None) == REF[name]().to_json(indent=None)
    assert ExperimentSpec.from_dict(json.loads(text)) == spec
    assert spec == PORT[name]()


def test_spec_roundtrip_exotic_fields():
    """Tuples (vector q, topology kwargs) and None-able fields survive, and
    the JSON is the reference's."""
    kw = dict(
        topology=("erdos", (("p", 0.3), ("seed", 5))),
        q=(0.2, 0.9, 0.5, 1.0), mixer=("trimmed_mean", 2),
        comp=("randk", 0.25, 0.7))

    def make(m):
        return m.ExperimentSpec(
            topology=m.TopologySpec(kind=kw["topology"][0],
                                    kwargs=kw["topology"][1]),
            participation=m.ParticipationSpec(kind="iid", q=kw["q"]),
            mixer=m.MixerSpec(kind=kw["mixer"][0], trim=kw["mixer"][1]),
            compression=m.CompressionSpec(kind=kw["comp"][0],
                                          ratio=kw["comp"][1],
                                          gamma=kw["comp"][2]),
            asynchrony=m.AsyncSpec(enabled=True, rates=(1.0, 2.0, 0.5, 1.0),
                                   discount="poly"),
            privacy=m.PrivacySpec(enabled=True, epsilon=4.0),
            run=m.RunSpec(num_agents=4, local_steps=3, step_size=0.01,
                          drift_correction=True))

    spec = make(api)
    back = ExperimentSpec.from_json(spec.to_json())
    assert back == spec and spec.to_json() == make(ref_api.spec).to_json()
    assert back.participation.q == (0.2, 0.9, 0.5, 1.0)
    assert dict(back.topology.kwargs) == {"p": 0.3, "seed": 5}
    auto = spec.replace(compression=CompressionSpec(gamma="auto"))
    assert ExperimentSpec.from_json(auto.to_json()).compression.gamma == \
        "auto"
    assert spec.to_diffusion_config().q_vector().tolist() == \
        make(ref_api.spec).q_vector().tolist()


def _raises(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


def test_unknown_registry_keys_give_the_reference_messages():
    port_data = make_regression_problem(K=4, N=20)
    ref_data = ref_make_problem(K=4, N=20)
    for sub, field in (("mixer", "nope"), ("topology", "hypercube"),
                       ("participation", "poisson"), ("compression", "zip"),
                       ("optimizer", "lion"), ("model", "diffusion_unet"),
                       ("graph", "wormhole")):
        specs = []
        for m in (api, ref_api.spec):
            base = m.ExperimentSpec(run=m.RunSpec(num_agents=4))
            specs.append(base.replace(**{sub: dataclasses.replace(
                getattr(base, sub), kind=field)}))
        got = _raises(lambda: api.build(specs[0], port_data.loss_fn(),
                                        device="cpu"))
        want = _raises(lambda: ref_api.build(specs[1], ref_data.loss_fn()))
        assert got == want and "registered" in got, (got, want)
    assert (_raises(lambda: cli.get_preset("nope"))
            == _raises(lambda: ref_cli.get_preset("nope")))
    assert cli.preset_names() == ref_cli.preset_names()


def test_unknown_spec_json_field_rejected_with_the_reference_message():
    bad = json.loads(ExperimentSpec().to_json())
    bad["mixer"]["tile"] = 256               # typo for tile_m
    got = _raises(lambda: ExperimentSpec.from_dict(bad))
    want = _raises(lambda: ref_api.ExperimentSpec.from_dict(bad))
    assert got == want and "tile" in got
    bad = json.loads(ExperimentSpec().to_json())
    bad["asynchrony"] = [1, 2]
    assert (_raises(lambda: ExperimentSpec.from_dict(bad))
            == _raises(lambda: ref_api.ExperimentSpec.from_dict(bad)))


def test_registry_duplicate_and_register_decorator():
    reg = Registry("thing")

    @reg.register("a")
    def _a():
        return "a"

    assert reg.get("a") is _a and "a" in reg and reg.names() == ("a",)
    with pytest.raises(ValueError, match="already registered"):
        reg.register("a")(lambda: None)
    assert _raises(lambda: reg.get("b")) == \
        "unknown thing kind 'b' — registered thing kinds: ['a']"
    # a third-party mixer kind reaches build through the registry
    seen = []

    @api.MIXERS.register("test_custom_dense")
    def _custom(spec, topology, K, device=None):
        seen.append(spec.kind)
        return api.MIXERS.get("dense")(spec, topology, K, device)

    try:
        data = make_regression_problem(K=4, N=20)
        eng = api.build(ExperimentSpec(
            run=RunSpec(num_agents=4),
            mixer=MixerSpec(kind="test_custom_dense")), data.loss_fn(),
            device="cpu")
        assert seen == ["test_custom_dense"] and eng.mixer.name == "dense"
    finally:
        api.MIXERS._entries.pop("test_custom_dense")


# ---------------------------------------------------------------------------
# build(spec): bit-equal to the hand-built engine, per preset
# ---------------------------------------------------------------------------

def _hand_built(name, loss):
    """The engine each preset denotes, built by hand from a
    DiffusionConfig and explicit components."""
    cfg = DiffusionConfig
    if name == "fedavg_full":
        return DiffusionEngine(cfg(num_agents=K, local_steps=3,
                                   step_size=0.02, topology="fedavg",
                                   participation=1.0), loss, device="cpu")
    if name == "fedavg_partial_uniform":
        return DiffusionEngine(cfg(num_agents=K, local_steps=2,
                                   step_size=0.05, topology="fedavg",
                                   participation=0.6), loss, device="cpu")
    if name == "vanilla_diffusion":
        return DiffusionEngine(cfg(num_agents=K, local_steps=1,
                                   step_size=0.05, topology="ring",
                                   participation=1.0), loss, device="cpu")
    if name == "asynchronous_diffusion":
        return DiffusionEngine(cfg(num_agents=K, local_steps=1,
                                   step_size=0.03, topology="ring",
                                   participation=0.6), loss, device="cpu")
    if name == "decentralized_fedavg":
        return DiffusionEngine(cfg(num_agents=K, local_steps=4,
                                   step_size=0.02, topology="ring",
                                   participation=1.0), loss, device="cpu")
    if name == "cyclic_fedavg":
        return DiffusionEngine(cfg(num_agents=K, local_steps=2,
                                   step_size=0.02, topology="fedavg",
                                   participation=1.0 / 3), loss,
                               participation=CyclicGroups(K, 3),
                               device="cpu")
    if name == "markov_asynchronous_diffusion":
        return DiffusionEngine(cfg(num_agents=K, local_steps=1,
                                   step_size=0.02, topology="ring",
                                   participation=0.6), loss,
                               participation=MarkovAvailability(
                                   0.6, 0.5, num_agents=K), device="cpu")
    if name == "link_dropout_diffusion":
        return DiffusionEngine(cfg(num_agents=K, local_steps=1,
                                   step_size=0.02, topology="ring",
                                   graph="link_dropout",
                                   graph_kwargs=(("corr", 0.5),
                                                 ("drop", 0.3)),
                                   participation=0.8), loss, device="cpu")
    if name == "compressed_diffusion":
        return DiffusionEngine(cfg(num_agents=K, local_steps=2,
                                   step_size=0.02, topology="ring",
                                   participation=0.8, compress="topk",
                                   compress_ratio=0.5, error_feedback=True),
                               loss, device="cpu")
    if name == "compressed_fedavg":
        return DiffusionEngine(cfg(num_agents=K, local_steps=2,
                                   step_size=0.02, topology="fedavg",
                                   participation=0.8, compress="int8",
                                   compress_ratio=1.0, error_feedback=True),
                               loss, device="cpu")
    if name == "byzantine_robust_diffusion":
        atk = make_attack("sign_flip", K, num_byzantine=2, scale=3.0)
        return DiffusionEngine(cfg(num_agents=K, local_steps=1,
                                   step_size=0.02, topology="ring",
                                   participation=0.9, mix="trimmed_mean"),
                               loss, grad_transform=atk.update,
                               mixer=TrimmedMeanMixer(K, trim=1,
                                                      scope="neighborhood"),
                               device="cpu")
    if name == "private_diffusion":
        from repro_torch.core.privacy import compile_privacy
        from repro_torch.optim import sgd
        p = compile_privacy(K, np.full(K, 0.8), blocks=20, local_steps=1,
                            epsilon=8.0, secure_agg=True)
        return DiffusionEngine(cfg(num_agents=K, local_steps=1,
                                   step_size=0.02, topology="ring",
                                   participation=0.8), loss,
                               grad_transform=p.wrap(sgd()).update,
                               privacy=p, device="cpu")
    if name == "heterogeneous_diffusion":
        return DiffusionEngine(cfg(num_agents=K, local_steps=2,
                                   step_size=0.02, topology="scale_free",
                                   participation=0.8,
                                   local_steps_mode="degree"), loss,
                               device="cpu")
    raise AssertionError(name)


@pytest.mark.parametrize("name", PRESETS)
def test_build_bit_equal_to_the_hand_built_engine(name):
    """Every preset through build(spec) + engine.step is bit-equal to the
    engine built by hand, over 4 blocks from one generator seed each."""
    data = make_regression_problem(K=K, N=40, M=2, rho=0.1, seed=1)
    spec = PORT[name]()
    new = api.build(spec, data.loss_fn(), device="cpu")
    old = _hand_built(name, data.loss_fn())
    assert spec.to_diffusion_config() == old.config
    assert new.engine_kind == "stacked" and isinstance(new, DiffusionEngine)
    sampler = make_indexed_block_sampler(data, T=spec.run.local_steps,
                                         seed=3, device="cpu")
    w0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (K, 2)).astype(np.float32))
    opt0 = new.optimizer.init(w0) if name == "private_diffusion" else None
    opt1 = new.optimizer.init(w0) if name == "private_diffusion" else None
    s_new = new.init_state(w0, opt0, key=torch.Generator().manual_seed(3))
    s_old = old.init_state(w0, opt1, key=torch.Generator().manual_seed(3))
    for i in range(4):
        batch = sampler(i)
        s_new, m_new = new.step(s_new, batch,
                                torch.Generator().manual_seed(200 + i))
        s_old, m_old = old.step(s_old, batch,
                                torch.Generator().manual_seed(200 + i))
        assert torch.equal(m_new["active"], m_old["active"])
        assert torch.equal(s_new.params, s_old.params), (name, i)


# ---------------------------------------------------------------------------
# build(spec): replay parity against the reference's build(spec)
# ---------------------------------------------------------------------------

def _ref_comm_draws(eng, key, K, M):
    """The reference pipeline's realized draws for block key ``key``: its
    compressor draws leaf i from ``split(split(key)[1], leaves)[i]``."""
    base = eng.pipeline._base()
    if isinstance(base, comp.Identity) or not eng.pipeline.needs_key:
        return None
    (leaf_key,) = jax.random.split(jax.random.split(key)[1], 1)
    return comp.Draws(u=[torch.from_numpy(np.array(
        jax.random.uniform(leaf_key, (K, M))))])


#: the presets replayed against the reference: every one but
#: private_diffusion, whose noise and wire masks are replayed in
#: tests/test_torch_privacy.py
REPLAYED = [n for n in PRESETS if n != "private_diffusion"]


@pytest.mark.parametrize("name", REPLAYED)
def test_build_replays_the_reference_build(name):
    """5 blocks of the reference's build(spec) engine; the port's
    build(spec) engine fed its realized draws (participation uniforms,
    graph uniforms, compression uniforms) and the same numpy batches:
    masks equal, parameters within 1e-5 (1 + |w|)."""
    M = 2
    data = make_regression_problem(K=K, N=40, M=M, rho=0.1, seed=2)
    ref_data = ref_make_problem(K=K, N=40, M=M, rho=0.1, seed=2)
    ref_eng = ref_api.build(REF[name](), ref_data.loss_fn())
    eng = api.build(PORT[name](), data.loss_fn(), device="cpu")
    T = eng.config.local_steps
    ref_sampler = ref_indexed_sampler(ref_data, T=T, seed=4)
    sampler = make_indexed_block_sampler(data, T=T, seed=4, device="cpu")
    w0 = np.random.default_rng(0).standard_normal((K, M)).astype(np.float32)
    k0 = jax.random.PRNGKey(7)
    ref_state = ref_eng.init_state(jnp.asarray(w0), key=k0)
    state = eng.init_state(torch.from_numpy(w0))
    if eng.process.stateful and name != "cyclic_fedavg":
        state = state.replace(part_state=eng.process.init_state(
            None, u=np.asarray(jax.random.uniform(k0, (K,)))))
    if eng.graph.stateful:
        state = state.replace(graph_state=eng.graph.init_state(
            None, u=np.asarray(jax.random.uniform(
                jax.random.fold_in(k0, GRAPH_FOLD), (K, K)))))
    for i in range(5):
        key = jax.random.fold_in(jax.random.PRNGKey(11), i)
        u_ref, d_ref = ref_sampler(i)
        ref_state, ref_m = ref_eng.step(ref_state, (u_ref, d_ref), key)
        inject = {"graph_u": np.asarray(jax.random.uniform(
            jax.random.fold_in(key, GRAPH_FOLD), (K, K)))}
        if name != "cyclic_fedavg":
            inject["part_u"] = np.asarray(jax.random.uniform(
                jax.random.split(key)[0], (K,)))
        state, m = eng.step(state, sampler(i), None,
                            comm_key=_ref_comm_draws(eng, key, K, M),
                            **inject)
        np.testing.assert_array_equal(m["active"].numpy(),
                                      np.asarray(ref_m["active"]))
        want = np.asarray(ref_state.params)
        got = state.params.numpy()
        assert (np.abs(got - want) <= REPLAY_TOL * (1 + np.abs(want))).all(), (
            name, i, np.abs(got - want).max())


# ---------------------------------------------------------------------------
# the shared CLI: the same argv, byte-equal spec JSON in both packages
# ---------------------------------------------------------------------------

def _parser(mod, driver: str) -> argparse.ArgumentParser:
    """A launcher's parser on ``mod``'s shared front end (the driver
    extras of the reference's tests/test_api.py)."""
    ap = argparse.ArgumentParser(prog=driver)
    mod.add_spec_args(ap)
    ap.add_argument("--checkpoint", default=None)
    if driver == "train":
        ap.add_argument("--log-every", type=int, default=1)
    else:
        ap.add_argument("--prompt-len", type=int, default=64)
        ap.add_argument("--decode", type=int, default=32)
        ap.add_argument("--temperature", type=float, default=1.0)
        ap.set_defaults(agents=1)
    return ap


def _spec(mod, driver, flags):
    return mod.spec_from_args(_parser(mod, driver).parse_args(flags))


FLAG_SETS = [
    [],
    ["--mix", "pallas", "--compress", "int8", "--error-feedback"],
    ["--agents", "8", "--local-steps", "3", "--step-size", "0.01",
     "--topology", "grid", "--participation", "0.5",
     "--participation-process", "markov", "--markov-corr", "0.7",
     "--compress", "randk", "--compress-ratio", "0.25",
     "--comm-gamma", "0.3", "--optimizer", "momentum",
     "--mix", "sparse", "--arch", "smollm-360m"],
    ["--mix", "trimmed_mean", "--trim", "2"],
    ["--mix", "trimmed_mean", "--robust-scope", "neighborhood",
     "--attack", "sign_flip", "--attack-num", "2", "--attack-scale", "4.0"],
    ["--graph", "link_dropout", "--link-drop", "0.4", "--graph-corr",
     "0.2", "--topology-hops", "2", "--compress", "topk",
     "--comm-gamma", "auto"],
    ["--engine", "async", "--async-rate-dist", "lognormal",
     "--async-rate-sigma", "0.5", "--async-rate-seed", "3",
     "--async-tau-max", "4", "--async-discount", "poly",
     "--async-discount-rate", "0.5", "--agents", "8"],
    ["--topology", "erdos", "--topology-p", "0.4", "--topology-seed", "7",
     "--full", "--blocks", "3", "--batch", "1", "--seq", "1024"],
    ["--privacy", "--privacy-epsilon", "8", "--privacy-secure-agg",
     "--data", "dirichlet", "--data-alpha", "0.3", "--data-clusters", "3"],
    ["--preset", "compressed_fedavg", "--agents", "8", "--mix", "pallas",
     "--compress-ratio", "0.5"],
    ["--preset", "byzantine_robust_diffusion", "--agents", "9",
     "--robust-scope", "global", "--attack", "shift"],
    ["--preset", "link_dropout_diffusion", "--agents", "8",
     "--link-drop", "0.6", "--topology-hops", "2", "--engine", "async"],
    ["--preset", "heterogeneous_diffusion", "--agents", "8",
     "--participation-process", "cyclic", "--num-groups", "4"],
    ["--preset", "private_diffusion", "--agents", "8",
     "--privacy-epsilon", "2", "--drift-correction"],
    ["--graph", "tv_erdos", "--graph-p", "0.4", "--local-steps-mode",
     "degree", "--ef-host-offload", "--engine", "sharded"],
]


@pytest.mark.parametrize("flags", FLAG_SETS,
                         ids=[" ".join(f) or "<defaults>" for f in FLAG_SETS])
def test_cli_same_argv_gives_byte_equal_spec_json(flags):
    for driver in ("train", "serve"):
        argv = flags + (["--agents", "4"] if driver == "serve"
                        and "--agents" not in flags else [])
        got = _spec(cli, driver, argv)
        want = _spec(ref_cli, driver, argv)
        assert got.to_json() == want.to_json(), driver
        assert ExperimentSpec.from_json(want.to_json()) == got


def test_cli_spec_file_and_every_preset(tmp_path):
    spec = variants.compressed_fedavg(8, T=2, mu=0.01, q=0.7)
    path = tmp_path / "exp.json"
    path.write_text(spec.to_json())
    assert _spec(cli, "train", ["--spec", str(path)]) == spec
    for name in cli.preset_names():
        argv = ["--preset", name, "--agents", "8", "--local-steps", "2",
                "--step-size", "0.01", "--participation", "0.7",
                "--blocks", "5"]
        assert (_spec(cli, "train", argv).to_json()
                == _spec(ref_cli, "train", argv).to_json()), name


def test_cli_preset_overlays_explicit_flags_only():
    got = _spec(cli, "train", ["--preset", "compressed_fedavg", "--agents",
                               "8", "--mix", "pallas", "--compress-ratio",
                               "0.5"])
    assert got.mixer.kind == "pallas"          # explicit: overlaid
    assert got.compression.ratio == 0.5        # explicit: overlaid
    assert got.compression.kind == "int8"      # default flag: preset wins
    assert got.compression.error_feedback      # the preset's EF kept
    bare = _spec(cli, "train", ["--preset", "compressed_fedavg", "--agents",
                                "8"])
    assert bare.mixer.kind == "dense" and bare.compression.kind == "int8"
    assert bare.compression.ratio == 1.0       # the factory's, not 0.1
    assert bare.model == ModelSpec(kind="transformer")
    # serve's --agents shim: --preset needs an explicit --agents there
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--preset", "fedavg_full"])


def test_cli_flags_reach_the_spec():
    got = _spec(cli, "train", ["--topology", "erdos", "--topology-p", "0.4",
                               "--topology-seed", "7"])
    assert dict(got.topology.kwargs) == {"p": 0.4, "seed": 7}
    got = _spec(cli, "train", ["--topology", "ring", "--topology-hops",
                               "3"])
    data = make_regression_problem(K=8, N=20)
    eng = api.build(got.replace(model=ModelSpec(kind="external"),
                                run=RunSpec(num_agents=8)), data.loss_fn(),
                    device="cpu")
    assert set(eng.topology.neighbor_offsets_ring()) == {-3, -2, -1, 1, 2, 3}
    got = _spec(cli, "train", ["--graph", "link_dropout", "--link-drop",
                               "0.4", "--graph-corr", "0.25"])
    assert (got.graph.kind, got.graph.drop, got.graph.corr) == (
        "link_dropout", 0.4, 0.25)
    got = _spec(cli, "train", ["--mix", "median", "--robust-scope",
                               "neighborhood", "--attack", "noise",
                               "--attack-num", "3", "--attack-scale", "2.5"])
    assert (got.mixer.kind, got.mixer.scope) == ("median", "neighborhood")
    assert (got.attack.kind, got.attack.num_byzantine, got.attack.scale) == (
        "noise", 3, 2.5)
    got = _spec(cli, "train", ["--engine", "async", "--async-rate-dist",
                               "lognormal", "--async-rate-sigma", "1.5",
                               "--async-tau-max", "4", "--async-discount",
                               "poly"])
    a = got.asynchrony
    assert a.enabled and a.rate_dist == "lognormal" and a.rate_sigma == 1.5
    assert a.tau_max == 4 and a.discount == "poly"


@pytest.mark.parametrize("flags,match", [
    (["--async-rate-sigma", "1.5"], "engine async"),
    (["--trim", "2"], "robust"),
    (["--mix", "gather", "--robust-gather", "table"], "robust"),
    (["--attack-scale", "5.0"], "attack"),
    (["--graph", "gossip", "--link-drop", "0.5"], "graph"),
    (["--privacy-clip", "2"], "privacy"),
    (["--data", "shards", "--data-alpha", "0.5"], "data"),
])
def test_cli_guards_raise(flags, match):
    """The reference's guards; ``--mix gather`` with a robust flag is the
    port's one stricter case (the gather mixer reads none of them)."""
    with pytest.raises(ValueError, match=match):
        _spec(cli, "train", flags)
    if flags[:2] != ["--mix", "gather"]:
        with pytest.raises(ValueError, match=match):
            _spec(ref_cli, "train", flags)


# ---------------------------------------------------------------------------
# engine selection: auto -> sharded for a transformer spec
# ---------------------------------------------------------------------------

def test_auto_builds_sharded_for_a_transformer_spec_and_guards_offload(
        capsys):
    """The reference's rule (repro/api/build.py:431-437): auto builds the
    sharded engine for a self-contained model and the stacked one for an
    external loss; ef_host_offload is the sharded engine's only, and an
    external model needs a 3-arg loss for it."""
    spec = _spec(cli, "train", ["--agents", "2", "--blocks", "1"])
    eng = api.build(spec, device="cpu")
    assert isinstance(eng, ShardedEngine) and eng.engine_kind == "sharded"
    assert not hasattr(eng, "auto_substituted") and eng.shard is None
    assert api.build(spec, engine="sharded", device="cpu").engine_kind \
        == "sharded"
    stacked = api.build(spec, engine="stacked", device="cpu")
    assert isinstance(stacked, DiffusionEngine)
    offload = spec.replace(compression=dataclasses.replace(
        spec.compression, kind="int8", error_feedback=True,
        ef_host_offload=True))
    assert api.build(offload, device="cpu").ef_host_offload
    for engine in ("stacked", "async"):
        with pytest.raises(ValueError, match="ef_host_offload"):
            api.build(offload, engine=engine, device="cpu")
    with pytest.raises(ValueError, match="stateful pipeline"):
        api.build(spec.replace(compression=dataclasses.replace(
            spec.compression, ef_host_offload=True)), device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        api.build(spec, engine="gspmd", device="cpu")
    # an external model resolves auto to stacked, as the reference does
    data = make_regression_problem(K=4, N=20)
    ext = api.build(ExperimentSpec(run=RunSpec(num_agents=4)),
                    data.loss_fn(), device="cpu")
    assert ext.engine_kind == "stacked"
    with pytest.raises(ValueError, match="loss_fn"):
        api.build(ExperimentSpec(run=RunSpec(num_agents=4)), device="cpu")
    with pytest.raises(ValueError, match="3-arg loss_fn"):
        api.build(ExperimentSpec(run=RunSpec(num_agents=4)),
                  engine="sharded", device="cpu")
    # the train driver trains through it, with no substitution banner
    out = train.main(["--device", "cpu", "--agents", "2", "--blocks", "1",
                      "--seq", "8", "--batch", "1"])
    assert "stacked engine" not in capsys.readouterr().out
    assert out["engine"].engine_kind == "sharded"
    out = train.main(["--device", "cpu", "--agents", "2", "--blocks", "1",
                      "--seq", "8", "--batch", "1", "--engine", "stacked"])
    assert out["engine"].engine_kind == "stacked"


def test_build_optimizer_spec_threads_grad_transform():
    data = make_regression_problem(K=4, N=20)
    spec = ExperimentSpec(run=RunSpec(num_agents=4),
                          optimizer=OptimizerSpec(kind="momentum"))
    eng = api.build(spec, data.loss_fn(), device="cpu")
    assert eng.grad_transform is not None
    params = torch.zeros((4, 2))
    state = eng.init_state(params, eng.optimizer.init(params))
    sampler = make_indexed_block_sampler(data, T=1, device="cpu")
    state, _ = eng.step(state, sampler(0), torch.Generator().manual_seed(1))
    assert tree_leaves(state.opt_state)[0].shape == (4, 2)


def test_build_model_bundle_and_provider():
    """A transformer spec: the bundle's loss, ``init_params`` stacking K
    agents from one generator, and the spec's block provider."""
    spec = _spec(cli, "train", ["--agents", "3", "--batch", "1", "--seq",
                                "8", "--data", "shards", "--data-shards",
                                "2"])
    eng = api.build(spec, device="cpu")
    cfg = eng.model.cfg
    params = eng.init_params(torch.Generator().manual_seed(0))
    assert params["embed"].shape[0] == 3
    again = train.init_stacked(torch.Generator().manual_seed(0), cfg, 3,
                               torch.device("cpu"))
    for a, b in zip(tree_leaves(params), tree_leaves(again)):
        assert torch.equal(a, b)
    block = eng.data(0, None)
    assert tuple(block["tokens"].shape) == (2, 3, 1, 8)
    build_mod = importlib.import_module("repro_torch.api.build")
    shapes = build_mod.train_block_struct(cfg, T=2, K=3, batch=1, seq=8)
    assert shapes["tokens"][0] == (2, 3, 1, 8)


# ---------------------------------------------------------------------------
# spec checkpoints
# ---------------------------------------------------------------------------

def _state_leaves(state) -> list:
    """An EngineState's leaves in field order, absent components
    skipped (the order JAX flattens the reference's in)."""
    return [x for f in dataclasses.fields(state)
            for x in tree_leaves(getattr(state, f.name))
            if x is not None]


def _compressed_cyclic_momentum(pkg):
    spec = pkg.compressed_diffusion(K, mu=0.02, T=2, q=0.8, compress="topk",
                                    ratio=0.5)
    m = ref_api.spec if pkg is ref_variants else api
    return spec.replace(
        participation=m.ParticipationSpec(kind="cyclic", q=0.5,
                                          num_groups=2),
        optimizer=m.OptimizerSpec(kind="momentum"))


def test_checkpoint_engine_state_and_spec_roundtrip(tmp_path):
    """save_experiment stores the whole EngineState (params, optimizer,
    participation and communication state) with the spec; load_spec +
    build + load_experiment rebuild the engine and state, which continue
    bit-equally."""
    data = make_regression_problem(K=K, N=40, M=2, rho=0.1, seed=0)
    spec = _compressed_cyclic_momentum(variants)
    eng = api.build(spec, data.loss_fn(), device="cpu")
    params = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (K, 2)).astype(np.float32))
    state = eng.init_state(params, eng.optimizer.init(params))
    sampler = make_indexed_block_sampler(data, T=2, device="cpu")
    for i in range(3):
        state, _ = eng.step(state, sampler(i),
                            torch.Generator().manual_seed(i))
    assert state.part_state is not None and state.comm_state is not None
    path = str(tmp_path / "exp_ckpt.npz")
    save_experiment(path, state, spec=spec, step=3,
                    metadata={"note": "roundtrip"})
    spec2 = load_spec(path)
    assert spec2 == spec
    eng2 = api.build(spec2, data.loss_fn(), device="cpu")
    like = eng2.init_state(torch.zeros_like(params),
                           eng2.optimizer.init(params))
    restored, meta = load_experiment(path, like, device="cpu")
    assert meta["step"] == 3 and meta["note"] == "roundtrip"
    got, want = _state_leaves(restored), _state_leaves(state)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    batch = sampler(9)
    s1, _ = eng.step(state, batch, torch.Generator().manual_seed(7))
    s2, _ = eng2.step(restored, batch, torch.Generator().manual_seed(7))
    assert torch.equal(s1.params, s2.params)


def test_checkpoint_partial_template_and_plain(tmp_path):
    spec = variants.fedavg_full(4, T=1, mu=0.01)
    params = torch.randn((4, 2), generator=torch.Generator().manual_seed(0))
    state = EngineState(params, opt_state={"m": torch.ones((4, 2))})
    path = str(tmp_path / "ck.npz")
    save_experiment(path, state, spec=spec, step=1)
    restored, _ = load_experiment(path, EngineState(torch.zeros((4, 2))),
                                  device="cpu")
    assert torch.equal(restored.params, params)
    assert restored.opt_state is None and load_spec(path) == spec
    plain = str(tmp_path / "plain.npz")
    save_checkpoint(plain, {"w": torch.zeros((2, 2))}, step=1)
    assert load_spec(plain) is None


def test_spec_checkpoints_cross_both_packages(tmp_path):
    """A reference experiment checkpoint loads into the port (spec, keys,
    values) and a port one into the reference."""
    data = ref_make_problem(K=K, N=40, M=2, rho=0.1, seed=0)
    spec = _compressed_cyclic_momentum(ref_variants)
    eng = ref_api.build(spec, data.loss_fn())
    params = jax.random.normal(jax.random.PRNGKey(0), (K, 2))
    state = eng.init_state(params, eng.optimizer.init(params),
                           key=jax.random.PRNGKey(1))
    sampler = ref_indexed_sampler(data, T=2, seed=0)
    for i in range(2):
        state, _ = eng.step(state, sampler(i), jax.random.PRNGKey(i))
    path = str(tmp_path / "ref.npz")
    ref_store.save_experiment(path, state, spec=spec, step=2)
    port_spec = load_spec(path)
    assert port_spec.to_json() == spec.to_json()
    port_eng = api.build(port_spec, make_regression_problem(
        K=K, N=40, M=2, rho=0.1, seed=0).loss_fn(), device="cpu")
    z = torch.zeros((K, 2))
    like = port_eng.init_state(z, port_eng.optimizer.init(z))
    restored, meta = load_experiment(path, like, device="cpu")
    assert meta["step"] == 2
    np.testing.assert_array_equal(restored.params.numpy(),
                                  np.asarray(state.params))
    np.testing.assert_array_equal(restored.opt_state.numpy(),
                                  np.asarray(state.opt_state))
    for name in ("ref", "delta"):
        if name in state.comm_state:
            np.testing.assert_array_equal(
                restored.comm_state[name].numpy(),
                np.asarray(state.comm_state[name]))
    back = str(tmp_path / "port.npz")
    save_experiment(back, restored, spec=port_spec, step=2)
    assert ref_store.load_spec(back) == spec
    again, _ = ref_store.load_experiment(back, state)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("graph,kw", [("static", ()),
                                      ("link_dropout", (("corr", 0.5),
                                                        ("drop", 0.3))),
                                      ("gossip", ()),
                                      ("tv_erdos", (("p", 0.4),))])
def test_diffusion_config_make_graph_matches_the_reference(graph, kw):
    from repro.core.diffusion import DiffusionConfig as RefConfig
    cfg = dict(num_agents=K, topology="ring", graph=graph, graph_kwargs=kw)
    got = DiffusionConfig(**cfg).make_graph(device="cpu")
    want = RefConfig(**cfg).make_graph()
    assert type(got).__name__ == type(want).__name__
    assert (got.stateful, got.within_base_support) == (
        want.stateful, want.within_base_support)
    np.testing.assert_array_equal(got.base_matrix().numpy(),
                                  np.asarray(want.base_matrix()))
