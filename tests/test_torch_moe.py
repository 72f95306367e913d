"""Port parity: the MoE FFN (``repro_torch.models.moe`` against
``repro.models.moe``) on seeded numpy inputs in float32, both of the
reference's dispatch implementations: outputs, the load-balance loss and
the gradients (router included), the capacity formula, capacity drops,
the no-drop case against the dense per-token sum, and a router with exact
ties, where the port must route and drop exactly the reference's
assignments."""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = 1e-5
NAMES = ("router", "w_gate", "w_up", "w_down")


def _inputs(seed, B, S, D, F, E, router_scale=1.0):
    rng = np.random.default_rng(seed)
    p = {"router": router_scale * rng.standard_normal((D, E)) / np.sqrt(D),
         "w_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    r = rng.standard_normal((B, S, D)).astype(np.float32)
    return p, x, r


def _ref(p, x, r, impl, **kw):
    """The reference's (y, aux) and the gradients of sum(y r) + aux."""
    def f(p, x):
        y, aux = ref_moe.moe_forward(p, x, impl=impl, **kw)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, p),
                                          jnp.asarray(x))
    return (np.asarray(y), float(aux), {k: np.asarray(gp[k]) for k in NAMES},
            np.asarray(gx))


def _port(p, x, r, impl, **kw):
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = moe.moe_forward(tp, tx, impl=impl, **kw)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    return (y.detach().numpy(), float(aux.detach()),
            {k: tp[k].grad.numpy() for k in NAMES}, tx.grad.numpy())


def _close(got, want):
    y, aux, gp, gx = got
    ry, raux, rgp, rgx = want
    np.testing.assert_allclose(y, ry, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(aux, raux, atol=TOL, rtol=TOL)
    for k in NAMES:
        np.testing.assert_allclose(gp[k], rgp[k], atol=TOL, rtol=TOL,
                                   err_msg=k)
    np.testing.assert_allclose(gx, rgx, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("impl", ["gather", "scatter"])
@pytest.mark.parametrize("case", [
    # (B, S, D, F, E, k, capacity factor)
    (2, 16, 32, 48, 4, 2, 1.25),      # the smoke archs' shape of routing
    (1, 40, 24, 32, 8, 3, 0.25),      # most assignments dropped
    (2, 9, 16, 24, 6, 1, 1.0),        # top-1, odd token count
])
def test_moe_forward_matches_reference(impl, case):
    B, S, D, F, E, k, cf = case
    p, x, r = _inputs(sum(case[:6]), B, S, D, F, E)
    kw = dict(top_k=k, capacity_factor=cf)
    _close(_port(p, x, r, impl, **kw), _ref(p, x, r, impl, **kw))


def test_capacity_formula():
    assert moe.moe_capacity(100, 10, 2, 1.0) == 20
    assert moe.moe_capacity(100, 10, 2, 1.25) == 25
    assert moe.moe_capacity(4, 16, 2, 1.0) == 2      # floor at top_k
    for args in ((1024, 32, 8, 1.25), (1024, 384, 8, 1.25), (4, 32, 8, 1.25)):
        assert moe.moe_capacity(*args) == ref_moe.moe_capacity(*args)


def test_capacity_drops_tokens_as_the_reference():
    """At capacity factor 0.25 whole tokens get zero output, the same
    tokens as the reference's."""
    p, x, r = _inputs(7, 1, 32, 8, 16, 2)
    kw = dict(top_k=1, capacity_factor=0.25)
    got = _port(p, x, r, "gather", **kw)
    want = _ref(p, x, r, "scatter", **kw)
    _close(got, want)
    zero = np.abs(got[0].reshape(-1, 8)).sum(-1) == 0
    assert zero.sum() > 0
    np.testing.assert_array_equal(
        zero, np.abs(want[0].reshape(-1, 8)).sum(-1) == 0)


def _dense(tp, xf, ids):
    """The per-token sum over the experts ``ids`` (N, k), weighted by the
    router's renormalised probabilities of those experts."""
    w = torch.softmax(xf @ tp["router"], -1).gather(-1, ids)
    w = w / w.sum(-1, keepdim=True)
    dense = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(ids.shape[1]):
            e = int(ids[t, j])
            h = (torch.nn.functional.silu(xf[t] @ tp["w_gate"][e])
                 * (xf[t] @ tp["w_up"][e]))
            dense[t] += w[t, j] * (h @ tp["w_down"][e])
    return dense


def test_no_drop_equals_dense_sum():
    """With capacity factor E * 4 nothing is dropped: y is the dense
    per-token sum over the top-k experts."""
    B, S, D, F, E, k = 1, 12, 16, 24, 4, 2
    p, x, _ = _inputs(3, B, S, D, F, E)
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    xf = torch.from_numpy(x).reshape(-1, D)
    y, _ = moe.moe_forward(tp, torch.from_numpy(x), top_k=k,
                           capacity_factor=E * 4.0)
    probs = torch.softmax(xf @ tp["router"], -1)
    ids = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
    np.testing.assert_allclose(y.reshape(-1, D).numpy(),
                               _dense(tp, xf, ids).numpy(), atol=TOL,
                               rtol=TOL)


def test_routing_records_and_replays():
    """``Routing`` records each call's top-k experts; replaying its own
    record changes nothing, and replaying another router's record routes
    by those experts at this router's probabilities (the dense sum over
    them, nothing dropped) while still recording this router's choice."""
    B, S, D, F, E, k = 1, 12, 16, 24, 6, 2
    p, x, _ = _inputs(5, B, S, D, F, E)
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    other = dict(tp, router=torch.from_numpy(_inputs(6, B, S, D, F, E)[0]
                                             ["router"]))
    xt = torch.from_numpy(x)
    xf = xt.reshape(-1, D)
    kw = dict(top_k=k, capacity_factor=E * 4.0)
    with moe.Routing() as own:
        y, aux = moe.moe_forward(tp, xt, **kw)
        moe.moe_forward(tp, xt, **kw)
    assert moe.Routing.active is None and len(own.ids) == 2
    want = moe.top_k_ordered(torch.softmax(xf @ tp["router"], -1), k)[1]
    assert torch.equal(own.ids[0], want) and torch.equal(own.ids[1], want)
    with moe.Routing(replay=own.ids) as again:
        y2, aux2 = moe.moe_forward(tp, xt, **kw)
    assert torch.equal(y2, y) and torch.equal(aux2, aux)
    assert torch.equal(again.ids[0], want)
    with moe.Routing() as theirs:
        moe.moe_forward(other, xt, **kw)
    assert not torch.equal(theirs.ids[0], want)
    with moe.Routing(replay=theirs.ids) as replayed:
        y3, _ = moe.moe_forward(tp, xt, **kw)
    assert torch.equal(replayed.ids[0], want)
    np.testing.assert_allclose(y3.reshape(-1, D).numpy(),
                               _dense(tp, xf, theirs.ids[0]).numpy(),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("impl", ["gather", "scatter"])
def test_exact_tie_router_routes_and_drops_as_the_reference(impl):
    """A zero router gives every expert probability 1/E: top-k must take
    the k lowest expert indices for every token (jax.lax.top_k's tie
    rule), and the stable sort must keep exactly the first tokens of each
    expert up to capacity."""
    B, S, D, F, E, k = 2, 10, 16, 24, 4, 2
    p, x, r = _inputs(11, B, S, D, F, E, router_scale=0.0)
    kw = dict(top_k=k, capacity_factor=1.0)          # cap 10 of 20 tokens
    got, want = _port(p, x, r, impl, **kw), _ref(p, x, r, impl, **kw)
    _close(got, want)
    y = got[0].reshape(-1, D)
    kept = np.abs(y).sum(-1) != 0
    # experts 0 and 1 take every token; each keeps the first 10
    np.testing.assert_array_equal(kept, np.arange(B * S) < 10)
    np.testing.assert_array_equal(
        kept, np.abs(want[0].reshape(-1, D)).sum(-1) != 0)
    vals, ids = moe.top_k_ordered(torch.full((3, E), 1.0 / E), k)
    np.testing.assert_array_equal(ids.numpy(), [[0, 1]] * 3)


def test_init_and_specs():
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, 32, 48, 4, torch.bfloat16)
    s = moe.moe_specs(32, 48, 4, torch.bfloat16, lead=(3,))
    assert p["router"].dtype == torch.float32       # whatever the model dtype
    for n in NAMES:
        assert tuple(s[n].shape) == (3,) + tuple(p[n].shape)
        assert s[n].dtype == p[n].dtype and s[n].device.type == "meta"
    with pytest.raises(ValueError, match="impl"):
        moe.moe_forward(p, torch.zeros(1, 2, 32, dtype=torch.bfloat16),
                        top_k=2, impl="dense")
