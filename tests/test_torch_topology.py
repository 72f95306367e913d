"""Port parity: topologies and the eq.-20 realized matrix
(``repro_torch.core`` against ``repro.core``)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import participation as ref_part  # noqa: E402
from repro.core import topology as ref_topo  # noqa: E402
from repro_torch.core import participation as part  # noqa: E402
from repro_torch.core import topology as topo  # noqa: E402


def test_topology_kinds_match():
    assert topo.TOPOLOGY_KINDS == ref_topo.TOPOLOGY_KINDS


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ref_topo.TOPOLOGY_KINDS)
def test_topology_bit_equal(kind, seed):
    K = 12
    ref = ref_topo.make_topology(kind, K, seed=seed)
    got = topo.make_topology(kind, K, seed=seed)
    assert got.name == ref.name
    np.testing.assert_array_equal(got.A, ref.A)
    np.testing.assert_array_equal(got.adjacency, ref.adjacency)
    assert topo.spectral_gap(got.A) == ref_topo.spectral_gap(ref.A)
    for a, b in zip(got.neighbor_table(), ref.neighbor_table()):
        np.testing.assert_array_equal(a, b)


def test_weight_rules_bit_equal():
    rng = np.random.default_rng(3)
    adj = ref_topo.erdos_renyi_adjacency(9, 0.4, seed=5)
    np.testing.assert_array_equal(topo.metropolis_weights(adj),
                                  ref_topo.metropolis_weights(adj))
    np.testing.assert_array_equal(topo.averaging_matrix(7),
                                  ref_topo.averaging_matrix(7))
    adj = rng.random((6, 6)) < 0.5
    A = topo.metropolis_weights(adj | adj.T)
    assert topo.is_doubly_stochastic(A)


@pytest.mark.parametrize("kind,K", [("ring", 4), ("erdos", 12),
                                    ("grid", 20), ("fedavg", 8)])
def test_masked_combination_matches_reference(kind, K):
    rng = np.random.default_rng(K)
    A = ref_topo.make_topology(kind, K).A.astype(np.float32)
    masks = [np.zeros(K), np.ones(K)] + [
        (rng.random(K) < 0.6).astype(np.float32) for _ in range(10)]
    for m in masks:
        m = np.asarray(m, np.float32)
        want = np.asarray(ref_part.masked_combination(jnp.asarray(A),
                                                      jnp.asarray(m)))
        got = part.masked_combination(torch.from_numpy(A),
                                      torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
        np.testing.assert_array_equal(part.masked_combination_np(A, m),
                                      ref_part.masked_combination_np(A, m))
        assert topo.is_doubly_stochastic(got.astype(np.float64), tol=1e-6)
