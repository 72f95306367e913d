"""Port parity: the Section-IV variants (``repro_torch.core.variants``)
against the reference's (``repro.core.variants``).

Every factory returns the reference's spec (byte-equal JSON) for several
parameterizations, directly and through the preset registry's uniform
adapters; ``ExactDiffusionEngine`` replays the reference's block for block
on the same numpy batches and, on the recipe of the reference's
``tests/test_extensions.py``, lands closer to w° than vanilla diffusion."""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import cli as ref_cli  # noqa: E402
from repro.core import variants as ref_variants  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    make_indexed_block_sampler as ref_indexed_sampler,
    make_regression_problem as ref_make_problem)
from repro_torch.api import cli  # noqa: E402
from repro_torch.core import variants  # noqa: E402
from repro_torch.core.diffusion import (DiffusionConfig,  # noqa: E402
                                        DiffusionEngine)
from repro_torch.data.synthetic import (  # noqa: E402
    make_block_sampler, make_indexed_block_sampler, make_regression_problem)

#: (factory, positional args, keyword args) of each variant, two
#: parameterizations each where the factory has knobs
CASES = [
    ("fedavg_full", (8, 3, 0.02), {}),
    ("fedavg_full", (4, 1, 0.5), {"mix": "pallas"}),
    ("fedavg_partial_uniform", (6, 2, 0.05, 0.6), {}),
    ("vanilla_diffusion", (6, 0.05), {}),
    ("vanilla_diffusion", (9, 0.01, "grid"), {"mix": "sparse"}),
    ("asynchronous_diffusion", (6, 0.03, 0.6), {}),
    ("asynchronous_diffusion", (4, 0.03, (0.2, 0.9, 0.5, 1.0)), {}),
    ("decentralized_fedavg", (6, 4, 0.02), {}),
    ("cyclic_fedavg", (6, 2, 0.02, 3), {}),
    ("markov_asynchronous_diffusion", (6, 0.02, 0.6, 0.5), {}),
    ("link_dropout_diffusion", (6, 0.02),
     {"drop": 0.3, "corr": 0.5, "q": 0.8}),
    ("link_dropout_diffusion", (8, 0.01), {"T": 2, "mix": "pallas"}),
    ("compressed_diffusion", (6, 0.02),
     {"T": 2, "q": 0.8, "compress": "topk", "ratio": 0.5}),
    ("compressed_diffusion", (6, 0.02),
     {"compress": "gauss", "sigma": 0.1, "gamma": 0.4}),
    ("compressed_fedavg", (6, 2, 0.02, 0.8), {}),
    ("compressed_fedavg", (8, 2, 0.02), {"mix": "pallas"}),
    ("byzantine_robust_diffusion", (12, 0.05),
     {"num_byzantine": 3, "scale": 3.0}),
    ("byzantine_robust_diffusion", (6, 0.02),
     {"q": 0.9, "mix": "median", "scope": "global"}),
    ("private_diffusion", (6, 0.02), {"T": 1, "q": 0.8}),
    ("private_diffusion", (8, 0.05),
     {"T": 2, "epsilon": 2.0, "secure_agg": False}),
    ("heterogeneous_diffusion", (6, 0.02), {"T": 2, "q": 0.8}),
    ("heterogeneous_diffusion", (8, 0.02),
     {"topology": "ring", "data_kind": "shards", "alpha": 0.5}),
]


@pytest.mark.parametrize("name,args,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_factory_spec_is_the_reference_spec(name, args, kw):
    got = getattr(variants, name)(*args, **kw)
    want = getattr(ref_variants, name)(*args, **kw)
    assert got.to_json() == want.to_json()
    assert got.to_diffusion_config().q_vector().tolist() == \
        want.to_diffusion_config().q_vector().tolist()


@pytest.mark.parametrize("name", sorted(ref_cli.preset_names()))
def test_preset_adapters_give_the_reference_specs(name):
    assert name in cli.preset_names()
    for K, T, mu, q, corr, groups in ((8, 2, 0.01, 0.7, 0.3, 2),
                                      (6, 1, 0.05, 1.0, 0.5, 3)):
        got = cli.get_preset(name)(K, T, mu, q=q, corr=corr,
                                   num_groups=groups)
        want = ref_cli.get_preset(name)(K, T, mu, q=q, corr=corr,
                                        num_groups=groups)
        assert got.to_json() == want.to_json()
    assert cli.get_preset(name).__name__ == name


def _exact_inputs(K=8, seed=5):
    kw = dict(K=K, N=100, M=2, rho=0.1, seed=seed, mean_scale=1.5,
              noise_low=0.01, noise_high=0.05, w_star_spread=0.5)
    return make_regression_problem(**kw), ref_make_problem(**kw)


def test_exact_diffusion_replays_the_reference():
    """The reference's ED-ATC step and the port's on the same numpy
    batches, 50 blocks: the iterate within 1e-5 (1 + |w|)."""
    K = 8
    data, ref_data = _exact_inputs(K)
    spec = variants.vanilla_diffusion(K, mu=0.01, topology="ring")
    ref = ref_variants.ExactDiffusionEngine(
        ref_variants.vanilla_diffusion(K, mu=0.01, topology="ring"),
        ref_data.loss_fn())
    eng = variants.ExactDiffusionEngine(spec, data.loss_fn(), device="cpu")
    np.testing.assert_array_equal(eng._A_bar.numpy(),
                                  np.asarray(ref._A_bar))
    ref_sampler = ref_indexed_sampler(ref_data, T=1, batch=4, seed=2)
    sampler = make_indexed_block_sampler(data, T=1, batch=4, seed=2,
                                         device="cpu")
    w0 = np.random.default_rng(1).standard_normal((K, 2)).astype(np.float32)
    rw, rpsi = jnp.asarray(w0), jnp.asarray(w0)
    w = psi = torch.from_numpy(w0)
    for i in range(50):
        rb = jax.tree.map(lambda x: x[0], ref_sampler(i))
        b = tuple(x[0] for x in sampler(i))
        rw, rpsi = ref._jit_step(rw, rpsi, rb)
        w, psi = eng.step(w, psi, b)
        want = np.asarray(rw)
        assert (np.abs(w.numpy() - want) <= 1e-5 * (1 + np.abs(want))).all()
        np.testing.assert_allclose(psi.numpy(), np.asarray(rpsi), rtol=0,
                                   atol=1e-5 * (1 + np.abs(want).max()))


def test_exact_diffusion_reduces_heterogeneity_bias():
    """The reference's gate on the port: the time-averaged network mean of
    exact diffusion lies closer to w° than vanilla diffusion's (K = 8
    ring, mu 0.01, 1,200 blocks, the mean over the last 600)."""
    K = 8
    data, _ = _exact_inputs(K)
    w_o = data.problem().w_opt(None)
    spec = variants.vanilla_diffusion(K, mu=0.01, topology="ring")
    sampler = make_block_sampler(data, T=1, batch=8, device="cpu")

    def run_std():
        eng = DiffusionEngine(spec.to_diffusion_config(), data.loss_fn(),
                              device="cpu", grad_fn=data.grad_fn())
        key = torch.Generator().manual_seed(0)
        state = eng.init_state(torch.zeros((K, 2)), key=key)
        acc, n = np.zeros(2), 0
        for i in range(1200):
            state, _ = eng.step(state, sampler(key), key)
            if i >= 600:
                acc += state.params.double().mean(0).numpy()
                n += 1
        return acc / n

    def run_exact():
        eng = variants.ExactDiffusionEngine(spec, data.loss_fn(),
                                            device="cpu",
                                            grad_fn=data.grad_fn())
        key = torch.Generator().manual_seed(0)
        w = psi = torch.zeros((K, 2))
        acc, n = np.zeros(2), 0
        for i in range(1200):
            w, psi = eng.step(w, psi, tuple(x[0] for x in sampler(key)))
            if i >= 600:
                acc += w.double().mean(0).numpy()
                n += 1
        return acc / n

    d_std = np.linalg.norm(run_std() - w_o)
    d_ed = np.linalg.norm(run_exact() - w_o)
    assert d_ed < d_std, (d_ed, d_std)


def test_exact_diffusion_run_and_guards():
    data = make_regression_problem(K=4, N=20)
    with pytest.raises(ValueError, match="T = 1"):
        variants.ExactDiffusionEngine(
            DiffusionConfig(num_agents=4, local_steps=3, step_size=0.01),
            data.loss_fn(), device="cpu")
    eng = variants.ExactDiffusionEngine(
        DiffusionConfig(num_agents=4, local_steps=1, step_size=0.01),
        data.loss_fn(), device="cpu")
    w_star = torch.as_tensor(data.problem().w_opt(None), dtype=torch.float32)
    w, hist = eng.run(torch.zeros((4, 2)),
                      make_block_sampler(data, T=1, batch=2, device="cpu"),
                      300, seed=0, w_star=w_star)
    assert len(hist) == 300 and hist[-1] < hist[0]
    assert torch.isfinite(w).all()
