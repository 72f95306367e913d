"""Port parity: the §VII regression examples of ``repro_torch.examples``
(``quickstart``, ``federated_comparison``, ``custom_graph``) against the
reference's ``examples/``.

The reference's ``quickstart.py`` and ``federated_comparison.py`` do their
work when imported, so their values are recomputed here with the calls
they make; ``examples/custom_graph.py`` guards its ``main`` and is loaded
once for its ``RotatingHub``.  Both custom_graph modules register
"hub_rotate" when imported; their fixtures import them once and take the
kind out of both registries afterwards, so the registries that other test
modules of the process see are unchanged.  Theory, specs, wire bytes and realized
matrices are held equal; the runs' own checks (the fall of the MSD, the
hub's bound, ``bounded=``) hold on the port's draws, which are torch's,
not JAX's."""
import contextlib
import importlib
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import ExperimentSpec as RefSpec  # noqa: E402
from repro.api import build as ref_build  # noqa: E402
from repro.core import variants as ref_variants  # noqa: E402
from repro.core.diffusion import DiffusionConfig as RefConfig  # noqa: E402
from repro.core.msd import theoretical_msd as ref_theoretical_msd  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    make_regression_problem as ref_make_problem)
from repro_torch.api import ExperimentSpec, build  # noqa: E402
from repro_torch.examples import federated_comparison as fc  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _printed(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue().splitlines()


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_theory():
    """``examples/quickstart.py``'s steps 1-3 with the reference."""
    K, T, MU = 10, 5, 0.01
    data = ref_make_problem(K=K, N=100, M=2, rho=0.1, seed=0)
    q = np.random.default_rng(1).uniform(0.3, 0.9, K)
    cfg = RefConfig(num_agents=K, local_steps=T, step_size=MU,
                    topology="ring", participation=tuple(q))
    return ref_theoretical_msd(data.problem(), A=cfg.make_topology().A, q=q,
                               mu=MU, T=T)


def test_quickstart_theory_equals_the_reference_and_a_short_run_falls(
        ref_theory):
    assert (quickstart.K, quickstart.T, quickstart.MU, quickstart.BLOCKS,
            quickstart.TAIL) == (10, 5, 0.01, 3000, 800)
    want = ref_theory
    out, lines = _printed(quickstart.run, blocks=400, device="cpu")
    np.testing.assert_allclose(out["theory"], want["msd"], rtol=1e-6)
    np.testing.assert_allclose(out["w_opt"], want["w_opt"], rtol=1e-6)
    hist = np.asarray(out["history"])
    assert len(hist) == 400 and np.isfinite(hist).all()
    assert hist[-100:].mean() < hist[0] / 10
    assert lines[0] == f"theoretical MSD (eq. 77): {want['msd']:.4e}"
    assert out["params"].device.type == "cpu"


def test_quickstart_main_prints_the_reference_lines(ref_theory):
    out, lines = _printed(quickstart.main, ["--device", "cpu"])
    want = ref_theory
    hist = out["history"]
    assert lines == [
        f"theoretical MSD (eq. 77): {want['msd']:.4e}",
        f"simulated MSD:            {out['sim']:.4e}",
        f"sim / theory:             {out['sim'] / want['msd']:.3f}",
        "learning curve (every 300 blocks): "
        f"{[f'{hist[i]:.1e}' for i in range(0, 3000, 300)]}"]
    np.testing.assert_allclose(out["sim"], np.mean(hist[-800:]))
    # one seed's 800-block tail: the steady state, not a law gate (the
    # band over many seeds is chip_smoke.py's phase 25)
    assert 0.5 < out["ratio"] < 2.0


# ---------------------------------------------------------------------------
# federated_comparison
# ---------------------------------------------------------------------------

_K = 12


def _ref_algorithms():
    """``examples/federated_comparison.py``'s ALGOS with the reference."""
    v = ref_variants
    return {
        "fedavg_full(T=5)": v.fedavg_full(_K, T=5, mu=0.01),
        "fedavg_partial(q=0.5,T=5)": v.fedavg_partial_uniform(
            _K, T=5, mu=0.01, q=0.5),
        "vanilla_diffusion(ring)": v.vanilla_diffusion(_K, mu=0.01),
        "async_diffusion(q=0.5)": v.asynchronous_diffusion(_K, mu=0.01,
                                                           q=0.5),
        "decentralized_fedavg(T=5)": v.decentralized_fedavg(_K, T=5,
                                                            mu=0.01),
    }


_REF_SCHEMES = {
    "dense-f32": dict(compress="none", ratio=1.0, error_feedback=False),
    "int8+EF": dict(compress="int8", ratio=1.0, error_feedback=True),
    "topk0.1": dict(compress="topk", ratio=0.1, error_feedback=False),
    "randk0.25": dict(compress="randk", ratio=0.25, error_feedback=False),
}


def _ref_scheme(kw):
    return ref_variants.compressed_diffusion(
        _K, mu=0.01, topology="ring", T=1, q=0.7, compress=kw["compress"],
        ratio=kw["ratio"], error_feedback=kw["error_feedback"])


def test_federated_comparison_specs_q_and_w_opt_equal_the_reference():
    assert (fc.K, fc.ALGO_BLOCKS, fc.ALGO_TAIL, fc.M2, fc.BLOCKS,
            fc.CHECKPOINTS, fc.STEADY_TAIL, fc.Q) == (
        12, 1500, 300, 20, 2000, (100, 400, 1000, 2000), 400, 0.7)
    assert fc.SCHEMES == _REF_SCHEMES
    prob = fc.make_regression_problem(K=_K, N=100, M=2, rho=0.1,
                                      seed=0).problem()
    ref_prob = ref_make_problem(K=_K, N=100, M=2, rho=0.1,
                                seed=0).problem()
    np.testing.assert_array_equal(prob.w_opt(None), ref_prob.w_opt(None))
    ref_algos = _ref_algorithms()
    port_algos = fc.algorithms()
    assert list(port_algos) == list(ref_algos)
    pairs = [(port_algos[n], ref_algos[n]) for n in ref_algos]
    pairs += [(fc.scheme_spec(n), _ref_scheme(kw))
              for n, kw in _REF_SCHEMES.items()]
    prob2 = fc.make_regression_problem(K=_K, N=100, M=20, rho=0.1,
                                       seed=0).problem()
    ref_prob2 = ref_make_problem(K=_K, N=100, M=20, rho=0.1,
                                 seed=0).problem()
    for i, (spec, ref) in enumerate(pairs):
        assert spec.to_json() == ref.to_json()
        np.testing.assert_array_equal(spec.q_vector(), ref.q_vector())
        p, r = (prob, ref_prob) if i < len(ref_algos) else (prob2,
                                                             ref_prob2)
        np.testing.assert_allclose(p.w_opt(spec.q_vector()),
                                   r.w_opt(ref.q_vector()), rtol=1e-12)


def test_federated_comparison_wire_bytes_equal_the_reference():
    data = fc.make_regression_problem(K=_K, N=100, M=20, rho=0.1, seed=0)
    ref_data = ref_make_problem(K=_K, N=100, M=20, rho=0.1, seed=0)
    got = {}
    for name, kw in _REF_SCHEMES.items():
        eng = build(fc.scheme_spec(name), data.loss_fn(), device="cpu",
                    grad_fn=data.grad_fn())
        ref_eng = ref_build(_ref_scheme(kw), ref_data.loss_fn())
        got[name] = eng.pipeline.wire_bytes(torch.zeros((_K, 20)))
        assert got[name] == ref_eng.pipeline.wire_bytes(
            jnp.zeros((_K, 20)))
    assert got == {"dense-f32": 960, "int8+EF": 240, "topk0.1": 96,
                   "randk0.25": 240}


def test_federated_comparison_reduced_part2_cuts_its_checkpoints():
    out, lines = _printed(fc.part2, blocks=300, device="cpu")
    assert lines[3] == (f"{'scheme':12s} {'B/block':>8s}  "
                        + "  ".join(f"{'MSD@' + str(c):>16s}"
                                    for c in (100, 300))
                        + f"  {'steady MSD':>12s}")
    for row in out["schemes"].values():
        hist = np.asarray(row["history"])
        assert len(hist) == 300 and np.isfinite(hist).all()
        assert hist[-50:].mean() < hist[0]
        assert list(row["msd_at"]) == [100, 300]


def test_federated_comparison_main_prints_the_reference_lines():
    out, lines = _printed(fc.main, ["--device", "cpu"])
    p1, p2 = out["part1"], out["part2"]
    assert lines[0] == (f"{'algorithm':30s} {'steady MSD':>12s}  "
                        f"{'vs w_orig':>10s}")
    for line, (name, row) in zip(lines[1:6], p1.items()):
        assert line == (f"{name:30s} {row['msd']:12.4e}  "
                        f"{row['vs_w_orig']:10.4f}")
        hist = np.asarray(row["history"])
        assert len(hist) == 1500 and np.isfinite(hist).all()
        assert row["msd"] < hist[0] / 10
    assert lines[6:9] == [
        "", "MSD vs bytes-on-wire (async diffusion, ring, q=0.7; int8 uses "
        "the", "EF residual, the sparsifiers diff-mode implicit feedback):"]
    assert lines[9] == (f"{'scheme':12s} {'B/block':>8s}  "
                        + "  ".join(f"{'MSD@' + str(c):>16s}"
                                    for c in (100, 400, 1000, 2000))
                        + f"  {'steady MSD':>12s}")
    for line, (name, row) in zip(lines[10:14], p2["schemes"].items()):
        assert line.startswith(f"{name:12s} {row['bytes_per_block']:8d}  ")
        assert line.endswith(f"  {row['steady']:12.4e}")
        assert np.isfinite(row["history"]).all()
    degr = max(r["steady"] for r in p2["schemes"].values()) / p2[
        "schemes"]["dense-f32"]["steady"]
    assert lines[14:] == [
        "", f"max steady-MSD degradation vs dense: {degr:.2f}x "
        f"(bounded={degr < 10.0}) — compressed feedback schemes hold a "
        "near-dense error floor at 2-10x fewer bytes per combination step"]
    assert p2["bounded"] is True


# ---------------------------------------------------------------------------
# custom_graph
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def custom_graph():
    """The port's example, imported once: its import registers
    "hub_rotate" with the port's GRAPHS (a second registration would
    raise), and the kind leaves the registry with the module."""
    from repro_torch.api import GRAPHS

    mod = importlib.import_module("repro_torch.examples.custom_graph")
    yield mod
    GRAPHS._entries.pop("hub_rotate", None)
    sys.modules.pop("repro_torch.examples.custom_graph", None)


@pytest.fixture(scope="module")
def ref_custom_graph():
    """The reference's example, loaded once (its import registers
    "hub_rotate" with the reference's GRAPHS; a second load would raise);
    the kind leaves the registry afterwards."""
    from repro.api import GRAPHS as REF_GRAPHS

    spec = importlib.util.spec_from_file_location(
        "ref_examples_custom_graph", ROOT / "examples" / "custom_graph.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield mod
    REF_GRAPHS._entries.pop("hub_rotate", None)


def test_custom_graph_hub_realizes_the_reference_matrices(custom_graph,
                                                          ref_custom_graph):
    K = 8
    hub = custom_graph.RotatingHub(K, device="cpu")
    ref = ref_custom_graph.RotatingHub(K)
    assert (hub.name, hub.stateful, hub.within_base_support) == (
        ref.name, ref.stateful, ref.within_base_support)
    np.testing.assert_allclose(hub.base_matrix().numpy(),
                               np.asarray(ref.base_matrix()), atol=1e-7)
    st, ref_st = hub.init_state(None), ref.init_state(jax.random.PRNGKey(0))
    for _ in range(2 * K):
        A, st = hub.sample(st, None)
        ref_A, ref_st = ref.sample(ref_st, jax.random.PRNGKey(1))
        np.testing.assert_allclose(A.numpy(), np.asarray(ref_A), atol=1e-7)
        assert int(st) == int(ref_st)
        np.testing.assert_allclose(A.sum(0).numpy(), 1.0, atol=1e-6)
    assert int(st) == 2 * K


def test_custom_graph_json_spec_parses_as_the_reference(custom_graph,
                                                        ref_custom_graph):
    spec = ExperimentSpec.from_json(custom_graph.SPEC_JSON)
    ref = RefSpec.from_json(custom_graph.SPEC_JSON)
    assert spec.to_json() == ref.to_json()
    assert str(spec.graph) == str(ref.graph)
    assert json.loads(custom_graph.SPEC_JSON) == {
        "topology": {"kind": "ring"}, "graph": {"kind": "hub_rotate"},
        "participation": {"kind": "iid", "q": 0.9},
        "run": {"num_agents": 8, "local_steps": 2, "step_size": 0.02}}
    eng = build(spec, custom_graph.make_regression_problem(
        K=8, N=60).loss_fn(), device="cpu")
    assert isinstance(eng.graph, custom_graph.RotatingHub)


def test_custom_graph_main_counts_the_blocks_and_holds_its_bound(
        custom_graph):
    out, lines = _printed(custom_graph.main, ["--device", "cpu"])
    spec = ExperimentSpec.from_json(custom_graph.SPEC_JSON)
    steady = out["steady"]
    assert lines == [
        f"spec.graph: {spec.graph}",
        f"{'hub_rotate':12s} graph={'RotatingHub(K=8)':30s} "
        f"steady MSD={steady['hub_rotate']:.4e}",
        f"{'':12s} hub index after 400 blocks: 400",
        f"{'static ring':12s} graph={'StaticGraph(K=8)':30s} "
        f"steady MSD={steady['static ring']:.4e}",
        "CUSTOM_GRAPH_OK"]
    assert out["hub_index"] == 400
    assert steady["hub_rotate"] < 50 * steady["static ring"]
    for hist in out["history"].values():
        assert len(hist) == 400 and np.isfinite(hist).all()
        assert np.mean(hist[-100:]) < hist[0]


def test_examples_without_a_device_refuse_the_cpu(custom_graph):
    """Every example's entry point means CUDA by default and raises
    without a card instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    from repro_torch.examples import serve_lm, train_federated_text, train_lm
    calls = [lambda: quickstart.main([]), lambda: fc.main([]),
             lambda: custom_graph.main([]),
             lambda: train_lm.main(["--blocks", "1"]),
             lambda: train_federated_text.main(["--blocks", "1"]),
             lambda: serve_lm.main([])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_importing_an_example_runs_nothing():
    code = ("import contextlib, io, sys\n"
            "out = io.StringIO()\n"
            "with contextlib.redirect_stdout(out):\n"
            "    import repro_torch.examples.quickstart, "
            "repro_torch.examples.federated_comparison, "
            "repro_torch.examples.custom_graph, "
            "repro_torch.examples.train_lm, "
            "repro_torch.examples.train_federated_text, "
            "repro_torch.examples.serve_lm\n"
            "assert out.getvalue() == '', out.getvalue()\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"}, timeout=120)
    assert proc.returncode == 0, proc.stderr

