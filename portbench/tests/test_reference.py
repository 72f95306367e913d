"""The plain reference against the port's plain path at smoke sizes, on
the CPU: one agent's loss and gradients, the ring's matrix and eq. 20's
realized matrix."""
import numpy as np
import pytest
import torch

from conftest import SMOKE, SMOKE_TRAFFIC
from portbench import harness, traffic
from portbench.kinds.train import _nested
from portbench.reference import common, family

CELLS = ("mamba2-2.7b.train.k4-q09", "mistral-7b.train.text4k")


def _smoke(name):
    cell = harness.load_cell(name)
    fam = cell["config"]["family"]
    model = dict(cell["config"]["model"], **SMOKE[fam], dtype="float32")
    return fam, model, dict(cell["traffic"], **SMOKE_TRAFFIC[fam])


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_loss_and_gradients_match_the_port(name, use_kernels):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_flatten_with_path

    fam, model, tr = _smoke(name)
    ref = family(fam)
    weights = traffic.draw_weights(ref.layout(model), 7, "cpu")
    block = traffic.block_batch(tr, model["vocab_size"], 7, 0, "cpu")
    batch = {n: v[0, 0] for n, v in block.items()}
    loss_r, grads_r = ref.loss_and_grad(weights, batch, model,
                                        common.Precision("stated"))

    params = _nested({p: w.clone().requires_grad_() for p, w in
                      weights.items()})
    cfg = ModelConfig(**model, use_kernels=use_kernels)
    loss_p = tf.train_loss(params, cfg, batch, remat=False)
    flat = tree_flatten_with_path(params)
    grads_p = torch.autograd.grad(loss_p, [x for _, x in flat])
    assert loss_r == pytest.approx(loss_p.item(), rel=1e-5)
    for (path, _), g in zip(flat, grads_p):
        r = grads_r["/".join(path)]
        err = (torch.linalg.vector_norm(g - r)
               / torch.linalg.vector_norm(r).clamp(min=1e-30)).item()
        assert err < 1e-4, ("/".join(path), err)


@pytest.mark.parametrize("K", [2, 3, 4, 8])
def test_ring_and_realized_matrix_match_the_port(K):
    from repro_torch.core.participation import masked_combination
    from repro_torch.core.topology import make_topology

    A = common.ring_matrix(K)
    np.testing.assert_allclose(A, make_topology("ring", K).A, atol=1e-15)
    rng = np.random.default_rng(K)
    for _ in range(5):
        active = (rng.random(K) < 0.6).astype(np.float64)
        want = masked_combination(torch.as_tensor(A), torch.as_tensor(
            active)).numpy()
        np.testing.assert_allclose(common.realized_matrix(A, active), want,
                                   atol=1e-15)


def test_fp8_rounding_keeps_eight_levels_an_octave():
    """The control's float8 e4m3 rounding: 3 mantissa bits, one scale per
    tensor (the largest magnitude maps to 448)."""
    x = torch.linspace(-3.0, 3.0, 1001)
    q = common._fp8(x, (0,))
    assert q.abs().max() == pytest.approx(3.0)
    rel = ((q - x).abs() / x.abs().clamp(min=1e-3))[x.abs() > 0.1]
    assert rel.max() <= 2 ** -4 + 1e-6
    assert common.Precision("stated").store(x, torch.bfloat16, False).dtype \
        == torch.bfloat16
