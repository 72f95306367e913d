"""A whole run with the timed path broken underneath comes out not
correct, for each fault a training cell can have: a step that returns
its state unchanged, half of the batch left out (the mean taken over the
rest), the exchange between agents left out.  The harness's look for a
card is skipped: the cells run at smoke size on the CPU, held to the
real cells' limits, and the unbroken run comes out correct."""
import pytest

from portbench import harness

CELLS = ("mamba2-2.7b.train.k4-q09.smoke",
         "mistral-7b.train.text4k.smoke")


def _line(root, name):
    run = harness.run_cell(name, 2 ** 31 + 11, 0.2, False, device="cpu",
                           t_start=0.0, root=root)
    return harness.result_line(run, False, root, device="cpu")


def _unchanged(monkeypatch):
    from repro_torch.core import mixing, sharded

    scan = sharded.local_update_scan

    def kept(grad_fn, params, opt_state, *args, **kwargs):
        scan(grad_fn, params, opt_state, *args, **kwargs)
        return params, opt_state

    monkeypatch.setattr(sharded, "local_update_scan", kept)
    monkeypatch.setattr(mixing.CommPipeline, "__call__",
                        lambda self, params, active, A_t, comm_state=(),
                        key=None: (params, comm_state))


def _half_batch(monkeypatch):
    from repro_torch.models import transformer as tf

    loss = tf.train_loss

    def half(params, cfg, batch, rng=None, **kwargs):
        S = batch["tokens"].shape[1]
        cut = dict(batch, tokens=batch["tokens"][:, :S // 2],
                   labels=batch["labels"][:, :S // 2])
        return loss(params, cfg, cut, rng, **kwargs)

    monkeypatch.setattr(tf, "train_loss", half)


def _no_exchange(monkeypatch):
    from repro_torch.core import mixing

    monkeypatch.setattr(mixing.CommPipeline, "__call__",
                        lambda self, params, active, A_t, comm_state=(),
                        key=None: (params, comm_state))


@pytest.mark.parametrize("name", CELLS)
def test_unbroken_run_is_correct(smoke, name):
    line = _line(smoke, name)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _no_exchange],
                         ids=["unchanged", "half_batch", "no_exchange"])
def test_broken_run_is_not_correct(smoke, monkeypatch, name, fault):
    fault(monkeypatch)
    line = _line(smoke, name)
    assert not line["correct"], line["checks"]
