"""Port parity: the Byzantine gradient attacks (``repro_torch.core.attacks``
against ``repro.core.attacks``), the reference's ``tests/test_attacks.py``
cases mirrored on the port, and the neighborhood-trim tolerance property on
the port's mixers (plain and the fused kernel's plain version).

Inputs are seeded numpy arrays given to both packages.  The ``noise``
adversary draws from torch's generator, not JAX's, so it is held by law:
its mean, spread, freshness per step and untouched honest rows.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import attacks as ref_attacks  # noqa: E402
from repro.optim import momentum as ref_momentum  # noqa: E402
from repro_torch.core import mixing  # noqa: E402
from repro_torch.core.attacks import (ATTACK_KINDS,  # noqa: E402
                                      byzantine_indices, byzantine_mask,
                                      make_attack)
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.optim import adam, momentum, sgd  # noqa: E402


def _grads(K, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    g = {"w": rng.standard_normal((K, 4)).astype(np.float32),
         "b": rng.standard_normal((K,)).astype(np.float32)}
    return g, {k: torch.from_numpy(v).to(dtype) for k, v in g.items()}


def test_byzantine_placement():
    assert ATTACK_KINDS == ref_attacks.ATTACK_KINDS
    for K, n in ((12, 3), (8, 1), (8, 0), (15, 6), (7, 7)):
        assert byzantine_indices(K, n) == ref_attacks.byzantine_indices(K, n)
        np.testing.assert_array_equal(byzantine_mask(K, n),
                                      ref_attacks.byzantine_mask(K, n))
    assert byzantine_indices(12, 3) == (0, 4, 8)
    np.testing.assert_array_equal(np.where(byzantine_mask(
        12, agents=(0, 7, 9)) > 0)[0], [0, 7, 9])
    with pytest.raises(ValueError):
        byzantine_mask(4, agents=(5,))
    with pytest.raises(ValueError):
        byzantine_indices(4, 5)
    with pytest.raises(ValueError, match="unknown attack"):
        make_attack("nope", 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["sign_flip", "shift"])
def test_attacks_match_reference_and_touch_only_byzantine_rows(kind, dtype):
    K = 8
    np_g, g = _grads(K, 1, dtype)
    ref = ref_attacks.make_attack(kind, K, num_byzantine=2, scale=3.0)
    port = make_attack(kind, K, num_byzantine=2, scale=3.0)
    want, _ = ref.update({k: jnp.asarray(v, jnp.dtype(str(dtype)[6:]))
                          for k, v in np_g.items()}, None, None)
    state = port.init(g)
    got, state2 = port.update(g, state, None)
    assert state is None and state2 is None       # stateless on plain SGD
    byz = byzantine_indices(K, 2)
    for k in g:
        assert got[k].dtype == dtype
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))
        for a in range(K):
            if a not in byz:
                assert torch.equal(got[k][a], g[k][a])
    if kind == "sign_flip":
        torch.testing.assert_close(got["w"][list(byz)],
                                   -3.0 * g["w"][list(byz)])


def test_shift_attack_is_coordinated():
    """Every Byzantine agent pushes the same constant direction."""
    K = 6
    atk = make_attack("shift", K, num_byzantine=2, scale=5.0)
    upd, _ = atk.update({"w": torch.zeros((K, 3))}, None, None)
    byz = byzantine_indices(K, 2)
    for k in range(K):
        assert torch.equal(upd["w"][k],
                           torch.full((3,), 5.0 if k in byz else 0.0))


def test_noise_attack_by_law():
    """Fresh N(0, scale^2) noise per step on the Byzantine rows only, from
    a counter in the transform state, advanced in place; a missing state
    fails pointing at init."""
    K, n, scale = 6, 20_000, 2.0
    atk = make_attack("noise", K, num_byzantine=2, scale=scale, seed=3)
    grads = {"w": torch.ones((K, n))}
    state = atk.init(grads)
    assert int(state["t"]) == 0 and state["inner"] is None
    u1, s1 = atk.update(grads, state, None)
    u2, s2 = atk.update(grads, s1, None)
    assert s1 is state and s2 is state and int(state["t"]) == 2
    byz = list(byzantine_indices(K, 2))
    honest = [k for k in range(K) if k not in byz]
    for u in (u1, u2):
        x = u["w"][byz]
        assert abs(float(x.mean())) < 5 * scale / np.sqrt(x.numel())
        assert abs(float(x.std()) - scale) < 0.03 * scale
        assert torch.equal(u["w"][honest], grads["w"][honest])
    assert not torch.allclose(u1["w"][byz], u2["w"][byz])
    # the same seed and counter give the same draw
    again = make_attack("noise", K, num_byzantine=2, scale=scale, seed=3)
    u1b, _ = again.update(grads, again.init(grads), None)
    assert torch.equal(u1b["w"], u1["w"])
    with pytest.raises(ValueError, match="init"):
        atk.update(grads, None, None)


def test_attack_composes_with_inner_optimizer():
    """Corruption happens before the optimizer: a Byzantine agent's
    momentum buffer accumulates the flipped gradient, as in the
    reference."""
    K = 4
    g = {"w": torch.ones((K, 2))}
    atk = make_attack("sign_flip", K, num_byzantine=1, scale=1.0,
                      inner=momentum(beta=0.5))
    state = atk.init(g)
    upd, state = atk.update(g, state, None)
    ref = ref_attacks.make_attack("sign_flip", K, num_byzantine=1, scale=1.0,
                                  inner=ref_momentum(beta=0.5))
    want, _ = ref.update({"w": jnp.ones((K, 2))},
                         ref.init({"w": jnp.zeros((K, 2))}), None)
    np.testing.assert_array_equal(upd["w"].numpy(), np.asarray(want["w"]))
    torch.testing.assert_close(upd["w"][0], torch.full((2,), -1.0))
    assert state["w"].shape == (K, 2)              # the momentum buffer


def test_attack_composes_with_adam():
    """Adam sees the flipped gradient: the Byzantine agent's first moment
    and update have the opposite sign of the honest ones'."""
    K = 4
    g = {"w": torch.ones((K, 3))}
    atk = make_attack("sign_flip", K, num_byzantine=1, scale=2.0,
                      inner=adam())
    state = atk.init(g)
    upd, state = atk.update(g, state, g)
    assert int(state["t"]) == 1
    torch.testing.assert_close(state["m"]["w"][0], torch.full((3,), -0.2))
    torch.testing.assert_close(state["m"]["w"][1:], torch.full((3, 3), 0.1))
    assert bool((upd["w"][0] < 0).all()) and bool((upd["w"][1:] > 0).all())


def test_attack_none_is_inner_passthrough():
    inner = sgd()
    assert make_attack("none", 4, inner=inner) is inner
    assert make_attack(None, 4, inner=inner) is inner


#: per-trim ring placements (the reference's): neighborhoods of 2 trim + 1
#: members, at most `trim` adversaries in each, more than 2 trim in total
_TRIM_PLACEMENTS = {1: (12, (0, 4, 8)), 2: (15, (0, 1, 5, 6, 10, 11))}


@pytest.mark.parametrize("gather", ["off", "table", "fused"])
@pytest.mark.parametrize("trim", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_neighborhood_trim_tolerance_property(seed, trim, gather):
    """For any honest values in [-1, 1] and any Byzantine magnitudes and
    signs placed with at most `trim` per closed ring neighborhood, every
    honest agent's neighborhood-trimmed output stays within [-1, 1]; the
    global trimmed mean leaks (the reference's property, on every gather
    path of the port)."""
    rng = np.random.default_rng(seed)
    K, byz = _TRIM_PLACEMENTS[trim]
    topo = make_topology("ring", K, hops=trim)
    A = torch.as_tensor(topo.A, dtype=torch.float32)
    active = torch.ones(K)
    vals = rng.uniform(-1.0, 1.0, (K, 3)).astype(np.float32)
    mags = rng.uniform(10.0, 1e4, (len(byz), 3)).astype(np.float32)
    signs = rng.choice([-1.0, 1.0], (len(byz), 3)).astype(np.float32)
    for i, b in enumerate(byz):
        vals[b] = mags[i] * signs[i]
    for k in range(K):
        assert sum(1 for b in byz if topo.adjacency[b, k]) <= trim
    honest = [k for k in range(K) if k not in byz]
    params = {"w": torch.from_numpy(vals)}
    nbhd = mixing.make_mixer("trimmed_mean", topo, trim=trim,
                             scope="neighborhood", gather=gather,
                             device="cpu")
    out_n = nbhd(params, active, A)["w"]
    assert float(out_n[honest].abs().max()) <= 1.0 + 1e-5
    out_g = mixing.make_mixer("trimmed_mean", topo, trim=trim,
                              device="cpu")(params, active, A)["w"]
    assert float(out_g[honest].abs().max()) > 1.0
