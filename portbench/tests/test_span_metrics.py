"""The five readers of the port's program spans (``forward_s.train``,
``backward_s.train``, ``optimizer_s.train``, ``attention_backward_s.train``,
``ssd_backward_s.train``): host seconds a block traced with the device's
activity alone, from synthetic stores and from the smoke cells traced on
the CPU."""
import sys

import pytest

from portbench import harness, span_time

READERS = {"forward_s.train": "local.forward",
           "backward_s.train": "local.backward",
           "optimizer_s.train": "local.update",
           "attention_backward_s.train": "model.attention.backward",
           "ssd_backward_s.train": "model.ssm.backward"}
MS = 1_000_000


def _store(blocks: int, names, per_block: dict) -> list:
    """Spans of ``blocks`` engine blocks: each block 1 s long, holding one
    span of each name in ``names`` lasting ``per_block[name](block)`` ms,
    nested under a local.step."""
    from repro_torch.spans import Span

    recs, ids = [], iter(range(10 ** 6))
    for b in range(blocks):
        t0 = b * 1000 * MS
        blk = Span(next(ids), "engine.block", t0, t0 + 1000 * MS, None, 1, b)
        step = Span(next(ids), "local.step", t0 + MS, t0 + 900 * MS,
                    blk.id, 1, b)
        recs += [blk, step]
        for name in names:
            ms = per_block[name](b)
            recs.append(Span(next(ids), name, t0 + 2 * MS,
                             t0 + (2 + ms) * MS, step.id, 2, b))
    return recs


@pytest.fixture
def readers():
    mods = harness.readers()
    return {name: mods[name] for name in READERS}


def _with_store(monkeypatch, recs):
    from repro_torch import spans

    monkeypatch.setattr(spans, "records", lambda: list(recs))


def test_readers_read_the_device_traced_blocks_only(readers, monkeypatch):
    # blocks 0 and 1 traced with the device alone, block 2 with the host
    # too: block 2's spans (ten times as long) are left out
    per = {n: (lambda b, k=k: (k + 1) * (10 if b == 2 else b + 1))
           for k, n in enumerate(READERS.values())}
    _with_store(monkeypatch, _store(3, list(READERS.values()), per))
    run = {"trace": {"blocks": 2}}
    for k, (metric, mod) in enumerate(readers.items()):
        assert (mod.KIND, mod.UNIT) == ("per_layer", "s")
        want = (k + 1) * (1 + 2) / 2 / 1000
        assert mod.read(run) == pytest.approx(want), metric


def test_readers_are_none_untraced_or_where_the_layer_is_absent(
        readers, monkeypatch):
    names = ["local.forward", "local.backward", "local.update",
             "model.ssm.backward"]                   # a cell with no attention
    _with_store(monkeypatch, _store(3, names, dict.fromkeys(
        names, lambda b: 5)))
    for run in ({"trace": None}, {}):
        assert all(mod.read(run) is None for mod in readers.values())
    got = {m: mod.read({"trace": {"blocks": 2}})
           for m, mod in readers.items()}
    assert got["attention_backward_s.train"] is None
    assert got["ssd_backward_s.train"] == pytest.approx(0.005)
    # fewer engine blocks in the store than the run traced
    assert readers["forward_s.train"].read({"trace": {"blocks": 4}}) is None
    # a program without the span store (the parent of the spans)
    import repro_torch

    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    monkeypatch.delattr(repro_torch, "spans")
    assert readers["forward_s.train"].read({"trace": {"blocks": 2}}) is None


def test_a_span_counts_once_however_deep_it_lies():
    from repro_torch.spans import Span

    recs = [Span(0, "engine.block", 0, 100, None, 1, 0),
            Span(1, "model.layer.backward", 10, 50, 0, 1, 0),
            Span(2, "model.layer.backward", 20, 30, 1, 1, 0),
            Span(3, "model.layer.backward", 60, 70, 0, 2, 0)]
    assert span_time.block_seconds(recs, "model.layer.backward", 1) == \
        pytest.approx(50e-9)


@pytest.mark.parametrize("cell,absent", [
    ("mistral-7b.train.text4k.smoke", "ssd_backward_s.train"),
    ("mamba2-2.7b.train.k4-q09.smoke", "attention_backward_s.train")])
def test_a_traced_smoke_run_carries_the_span_metrics(smoke, cell, absent):
    from repro_torch import spans

    spans.reset()
    run = harness.run_cell(cell, 2 ** 33 + 5, 0.3, True, device="cpu",
                           t_start=0.0, root=smoke)
    line = harness.result_line(run, True, smoke, device="cpu")
    assert line["correct"]
    got = {m: line["metrics"].get(m, {}).get("value") for m in READERS}
    assert got.pop(absent) is None
    assert all(v > 0 for v in got.values()), got
    local = span_time.per_block(run, "engine.local_updates")
    three = sum(got[m] for m in ("forward_s.train", "backward_s.train",
                                 "optimizer_s.train"))
    assert 0.8 * local < three <= local
    spans.reset()
