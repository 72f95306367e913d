"""Port parity: the SSD oracles, the chunked SSD, ``ssd_op`` (forward and
gradients) and the Mamba2 mixer (``repro_torch.models.ssm``,
``repro_torch.kernels``) against the reference, on seeded numpy inputs.
On the CPU the SSD intra-chunk wrapper takes its plain version; the
reference's Pallas kernel runs in interpret mode."""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_intra_chunk as ref_intra  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.kernels.ops import ssd_op  # noqa: E402
from repro_torch.kernels.ref import ssd_intra_chunk_ref, ssd_ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

# float32 sums of two frameworks over one sequence
ATOL = 1e-4
# the reference's SSD gates (tests/test_kernels.py)
SSD_TOL = {"float32": 2e-3, "bfloat16": 5e-2}
_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(b, s, h, p, n, seed=0, init=False):
    """Seeded numpy SSD inputs: x, dt > 0, A < 0, B, C (+ a state)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.5
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    out = [x, dt, A, B, C]
    if init:
        out.append(rng.standard_normal((b, h, p, n)).astype(np.float32))
    return out


def _both(arrays, dtype="float32", cast=(0, 3, 4)):
    """The same arrays for both packages; ``cast`` indices (x, B, C) take
    ``dtype``, the rest stay float32."""
    td, jd = _DT[dtype]
    pt = [torch.from_numpy(a).to(td if i in cast else torch.float32)
          for i, a in enumerate(arrays)]
    jx = [jnp.asarray(a, jd if i in cast else jnp.float32)
          for i, a in enumerate(arrays)]
    return pt, jx


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------------------
# oracles and the chunked SSD against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init", [False, True])
def test_ssd_ref_matches_reference(init):
    pt, jx = _both(_inputs(2, 40, 3, 16, 8, init=init))
    kw_t = {"initial_state": pt[5]} if init else {}
    kw_j = {"initial_state": jx[5]} if init else {}
    y, fin = ssd_ref(*pt[:5], **kw_t)
    yr, finr = ref_ref.ssd_ref(*jx[:5], **kw_j)
    _close(y, yr)
    _close(fin, finr)


@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_reference(init):
    pt, jx = _both(_inputs(2, 128, 4, 32, 16, seed=1, init=init))
    kw_t = {"initial_state": pt[5]} if init else {}
    kw_j = {"initial_state": jx[5]} if init else {}
    y, fin = ssm.ssd_chunked(*pt[:5], chunk=32, **kw_t)
    yr, finr = ref_ssm.ssd_chunked(*jx[:5], chunk=32, **kw_j)
    assert y.dtype == torch.float32 and fin.dtype == torch.float32
    _close(y, yr)
    _close(fin, finr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_intra_chunk_ref_matches_reference_kernel(dtype):
    x, dt, A, B, C = _inputs(2, 128, 3, 16, 8, seed=2)
    xd = x * dt[..., None]
    dA = dt * A
    pt, jx = _both([xd, dA, B, C], dtype, cast=(2, 3))
    outs = ssd_intra_chunk_ref(*pt, chunk=64)
    refs = ref_intra(*jx, chunk=64, interpret=True)
    for got, want in zip(outs, refs):
        assert got.dtype == torch.float32
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want)
    # the wrapper takes the plain version for CPU tensors, and launches
    # nothing
    before = ssd_scan.ssd_intra_chunk.launches
    for got, want in zip(ssd_scan.ssd_intra_chunk(*pt, chunk=64), outs):
        assert torch.equal(got, want)
    assert ssd_scan.ssd_intra_chunk.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_op_forward_and_gradients_match_reference(dtype):
    """``ssd_op`` against the reference's ``ssd_op`` (interpret mode), and
    its gradients in x, dt, A, B, C against ``jax.vjp``; s = 100 pads."""
    arrays = _inputs(1, 100, 3, 16, 8, seed=3)
    pt, jx = _both(arrays, dtype)
    rng = np.random.default_rng(4)
    gy = rng.standard_normal((1, 100, 3, 16)).astype(np.float32)
    gf = rng.standard_normal((1, 3, 16, 8)).astype(np.float32)
    leaves = [t.clone().requires_grad_() for t in pt]
    y, fin = ssd_op(*leaves, chunk=32)
    (yr, finr), vjp = jax.vjp(jax.jit(
        lambda *a: ref_ops.ssd_op(*a, chunk=32, interpret=True)), *jx)
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert y.dtype == pt[0].dtype and fin.dtype == torch.float32
    _close(y, yr, atol=tol, rtol=tol)
    _close(fin, finr, atol=tol, rtol=tol)
    torch.autograd.backward(
        (y, fin), (torch.from_numpy(gy).to(y.dtype), torch.from_numpy(gf)))
    want = vjp((jnp.asarray(gy, yr.dtype), jnp.asarray(gf)))
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype
        scale = max(1.0, float(np.abs(np.asarray(w, np.float32)).max()))
        _close(leaf.grad, w, atol=tol * scale, rtol=tol)


# ---------------------------------------------------------------------------
# the reference's SSD tests (tests/test_kernels.py), mirrored on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 2, 16, 8, 32),
    (2, 128, 4, 32, 16, 64),
    (1, 100, 3, 64, 32, 32),   # padded seq
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_sweep(b, s, h, p, n, chunk, dtype):
    pt, _ = _both(_inputs(b, s, h, p, n, seed=5), dtype)
    y, fin = ssd_op(*pt, chunk=chunk)
    yr, finr = ssd_ref(*pt)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(fin, finr, atol=tol, rtol=tol)


def test_ssd_kernel_matches_model_chunked():
    pt, _ = _both(_inputs(2, 128, 4, 32, 16, seed=6))
    y1, f1 = ssd_op(*pt, chunk=32)
    y2, f2 = ssm.ssd_chunked(*pt, chunk=32)
    torch.testing.assert_close(y1, y2, atol=1e-4, rtol=0)
    torch.testing.assert_close(f1, f2, atol=1e-4, rtol=0)


def test_ssd_with_initial_state():
    pt, _ = _both(_inputs(1, 64, 2, 16, 8, seed=7, init=True))
    y, fin = ssd_op(*pt[:5], chunk=32, initial_state=pt[5])
    yr, finr = ssd_ref(*pt[:5], initial_state=pt[5])
    torch.testing.assert_close(y, yr, atol=2e-3, rtol=0)
    torch.testing.assert_close(fin, finr, atol=2e-3, rtol=0)


# ---------------------------------------------------------------------------
# the Mamba2 mixer
# ---------------------------------------------------------------------------

_KW = dict(expand=2, head_dim=16, state=8, conv_kernel=4)
D_MODEL = 64


def _mixer_params(seed=8):
    """Seeded numpy mixer weights at the reference's init scales."""
    rng = np.random.default_rng(seed)
    specs = ref_ssm.ssm_specs(D_MODEL, dtype=jnp.float32, **_KW)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            w = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif "A_log" in name:
            w = np.log(np.arange(1, s.shape[0] + 1))
        elif "dt_bias" in name:
            w = rng.uniform(-4.0, -2.0, s.shape)
        elif "conv" in name:
            w = 0.1 * rng.standard_normal(s.shape)
        else:
            w = rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
        return np.asarray(w, np.float32)

    np_params = jax.tree_util.tree_map_with_path(leaf, specs)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = jax.tree.map(torch.from_numpy, np_params)
    return tparams, jparams


def test_init_and_specs_match_reference():
    got = ssm.init_ssm(torch.Generator().manual_seed(0), D_MODEL, **_KW)
    specs = ssm.ssm_specs(D_MODEL, dtype=torch.float32, **_KW)
    ref = ref_ssm.ssm_specs(D_MODEL, dtype=jnp.float32, **_KW)
    for tree in (got, specs):
        assert jax.tree.structure(jax.tree.map(lambda t: 0, tree)) == \
            jax.tree.structure(jax.tree.map(lambda s: 0, ref))
        for t, s in zip(jax.tree.leaves(tree), jax.tree.leaves(ref)):
            assert tuple(t.shape) == tuple(s.shape)
            assert str(t.dtype).removeprefix("torch.") == str(s.dtype)
    ref_init = ref_ssm.init_ssm(jax.random.PRNGKey(0), D_MODEL, **_KW)
    for name in ("A_log", "D", "conv_b"):
        _close(got[name], ref_init[name], atol=1e-6)
    assert ssm.ssm_state_shapes(3, D_MODEL, **_KW) == \
        ref_ssm.ssm_state_shapes(3, D_MODEL, dtype=jnp.float32, **_KW)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_forward_matches_reference(use_kernel):
    """The mixer on 40 tokens (padded to 48 by chunk 16), with the states
    it returns, with and without the intra-chunk kernel."""
    tparams, jparams = _mixer_params()
    u = np.random.default_rng(9).standard_normal((2, 40, D_MODEL)).astype(
        np.float32)
    out, (st, cv) = ssm.ssm_forward(tparams, torch.from_numpy(u), chunk=16,
                                    return_state=True, use_kernel=use_kernel,
                                    **_KW)
    ref_out, (ref_st, ref_cv) = jax.jit(lambda p, x: ref_ssm.ssm_forward(
        p, x, chunk=16, return_state=True, use_kernel=use_kernel, **_KW))(
        jparams, jnp.asarray(u))
    _close(out, ref_out)
    _close(st, ref_st)
    _close(cv, ref_cv)
    # the gradient of the mixer's output, through ssd_op's backward
    leaves = {k: v.clone().requires_grad_() for k, v in tparams.items()
              if k != "norm"}
    leaves["norm"] = tparams["norm"]
    ssm.ssm_forward(leaves, torch.from_numpy(u), chunk=16,
                    use_kernel=use_kernel, **_KW).square().sum().backward()
    g = jax.jit(jax.grad(lambda p: jnp.sum(ref_ssm.ssm_forward(
        p, jnp.asarray(u), chunk=16, use_kernel=use_kernel, **_KW) ** 2)))(
        jparams)
    for name in ("in_proj", "conv_w", "A_log", "dt_bias", "out_proj"):
        w = np.asarray(g[name])
        _close(leaves[name].grad, w, atol=1e-4 * max(1.0, np.abs(w).max()),
               rtol=1e-4)


def test_ssm_decode_step_matches_reference():
    """Prefill the mixer on 20 tokens, then 4 recurrent steps, against the
    reference's; the steps continue the full forward."""
    tparams, jparams = _mixer_params(seed=10)
    u = np.random.default_rng(11).standard_normal((2, 24, D_MODEL)).astype(
        np.float32)
    _, (st, cv) = ssm.ssm_forward(tparams, torch.from_numpy(u[:, :20]),
                                  chunk=16, return_state=True, **_KW)
    _, (ref_st, ref_cv) = jax.jit(lambda p, x: ref_ssm.ssm_forward(
        p, x, chunk=16, return_state=True, **_KW))(jparams,
                                                   jnp.asarray(u[:, :20]))
    ref_step = jax.jit(lambda p, x, s, c: ref_ssm.ssm_decode_step(
        p, x, s, c, **_KW))
    full = ssm.ssm_forward(tparams, torch.from_numpy(u), chunk=16, **_KW)
    for t in range(20, 24):
        out, st, cv = ssm.ssm_decode_step(tparams,
                                          torch.from_numpy(u[:, t:t + 1]),
                                          st, cv, **_KW)
        ref_out, ref_st, ref_cv = ref_step(
            jparams, jnp.asarray(u[:, t:t + 1]), ref_st, ref_cv)
        _close(out, ref_out)
        _close(st, ref_st)
        _close(cv, ref_cv)
        torch.testing.assert_close(out[:, 0], full[:, t], atol=2e-4, rtol=0)
