"""Program spans (``repro_torch.spans``): on exactly while a profiler runs.

A smoke hybrid transformer (zamba2's: one Mamba2 layer, then one
attention layer with its MLP; the kernels' wrappers on, so attention and
the SSD take their custom backward) trains K = 2 agents, T = 2 local
steps, through ``build(..., engine="auto")`` (the sharded engine at
world 1).  Without a profiler nothing is stored and no range is entered;
under one the span tree has the counts the block implies, each child
inside its parent and the backward's spans under their ``local.backward``;
a traced block leaves the same parameters, optimizer state and gradients
as an untraced one; each stored start lies at its ``record_function``
event in the profile."""
import copy
import dataclasses
import threading
from collections import Counter, defaultdict

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.api import build  # noqa: E402
from repro_torch.api.spec import (ExperimentSpec, MixerSpec,  # noqa: E402
                                  ModelSpec, OptimizerSpec,
                                  ParticipationSpec, RunSpec, TopologySpec)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.diffusion import stacked_grad  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

K, T, SEQ = 2, 2, 32
CFG = dataclasses.replace(get_config("zamba2-1.2b").smoke, use_kernels=True)
LAYERS = CFG.num_layers
SUBLAYERS = {"model.embed": K * T, "model.ssm": K * T,
             "model.attention": K * T, "model.mlp": K * T,
             "model.head_loss": K * T,
             "model.layer.backward": LAYERS * K * T,
             "model.attention.backward": K * T,
             "model.ssm.backward": K * T}


def _loss(params, batch, rng=None):
    return tf.train_loss(params, CFG, batch, remat=False)


def _engine():
    spec = ExperimentSpec(
        topology=TopologySpec(kind="ring"),
        participation=ParticipationSpec(kind="iid", q=1.0),
        mixer=MixerSpec(kind="pallas"),
        optimizer=OptimizerSpec(kind="momentum"),
        model=ModelSpec(kind="transformer", arch="zamba2-1.2b", smoke=True),
        run=RunSpec(num_agents=K, local_steps=T, step_size=0.05, batch=1,
                    seq=SEQ, blocks=1))
    eng = build(spec, _loss, engine="auto", device="cpu")
    assert eng.engine_kind == "sharded"
    one = tf.init_params(torch.Generator().manual_seed(0), CFG)
    params = tree_map(lambda x: torch.stack([x] * K).clone(), one)
    state = eng.init_state(params, eng.optimizer.init(params),
                           key=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    batch = {n: torch.randint(0, CFG.vocab_size, (T, K, 1, SEQ), generator=g)
             for n in ("tokens", "labels")}
    return eng, state, batch


def _step(eng, state, batch, seed=3):
    return eng.step(state, batch, torch.Generator().manual_seed(seed))


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture
def store():
    spans.reset()
    yield
    spans.reset()


def test_no_profiler_no_record_no_range_no_node(store, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(spans._LayerMark, "apply", refuse)
    eng, state, batch = _engine()
    state, metrics = _step(eng, state, batch)
    assert metrics["local_s"] > 0 and metrics["combine_s"] > 0
    assert spans.records() == [] and spans.dropped() == 0
    assert spans.span("local.forward") is spans.span("local.update")
    x = torch.ones(3, requires_grad=True)
    assert spans.mark_layer_input(x) == (x, None)
    assert spans.mark_layer_output(x, None) is x


def _depth_ok(recs):
    by_id = {r.id: r for r in recs}
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, \
                (r.name, p.name)
    return by_id


def _ancestors(r, by_id):
    out = []
    while r.parent is not None:
        r = by_id[r.parent]
        out.append(r.name)
    return out


def test_span_tree_of_a_traced_block(store):
    eng, state, batch = _engine()
    _traced(lambda: _step(eng, state, batch))
    recs = spans.records()
    counts = Counter(r.name for r in recs)
    for name, n in {"engine.block": 1, "engine.prologue": 1,
                    "engine.local_updates": 1, "engine.combination": 1,
                    "local.step": T, "local.forward": K * T,
                    "local.backward": T, "local.update": T,
                    **SUBLAYERS}.items():
        assert counts[name] == n, name
    assert counts["tiled.gather"] == counts["tiled.scatter"] >= 1
    assert {r.block for r in recs} == {0}
    by_id = _depth_ok(recs)
    want_parent = {"engine.prologue": "engine.block",
                   "engine.local_updates": "engine.block",
                   "engine.combination": "engine.block",
                   "local.step": "engine.local_updates",
                   "local.forward": "local.step",
                   "local.backward": "local.step",
                   "local.update": "local.step",
                   "model.embed": "local.forward",
                   "model.ssm": "local.forward",
                   "model.attention": "local.forward",
                   "model.mlp": "local.forward",
                   "model.head_loss": "local.forward",
                   "model.layer.backward": "local.backward",
                   "model.attention.backward": "model.layer.backward",
                   "model.ssm.backward": "model.layer.backward",
                   "tiled.gather": "engine.combination",
                   "tiled.scatter": "engine.combination"}
    for r in recs:
        if r.name == "engine.block":
            assert r.parent is None
        else:
            assert by_id[r.parent].name == want_parent[r.name], r.name
    # every backward span lies under the local.backward that caused it
    for r in recs:
        if r.name.endswith(".backward") and r.name != "local.backward":
            assert "local.backward" in _ancestors(r, by_id)
    assert spans.totals()["local.forward"][0] == K * T


def test_a_traced_block_changes_nothing(store):
    eng, state, batch = _engine()
    plain, _ = _step(eng, copy.deepcopy(state), batch)
    (traced, _), _ = _traced(lambda: _step(eng, copy.deepcopy(state),
                                           batch))
    assert spans.records()
    for a, b in zip(tree_leaves(traced.params) + tree_leaves(
            traced.opt_state), tree_leaves(plain.params) + tree_leaves(
            plain.opt_state)):
        assert torch.equal(a, b)
    grad_fn = stacked_grad(_loss)
    batch_0 = tree_map(lambda x: x[0], batch)
    want = grad_fn(state.params, batch_0)
    got, _ = _traced(lambda: grad_fn(state.params, batch_0))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


def test_stored_spans_lie_at_their_profile_events(store):
    eng, state, batch = _engine()
    # the first range a process enters lags its profile event by the
    # profiler's one-off set-up; the run under test is the second session
    _traced(lambda: _step(eng, copy.deepcopy(state), batch))
    spans.reset()
    _, prof = _traced(lambda: _step(eng, state, batch))
    recs = spans.records()
    events = defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        events[ev.name()].append(ev.start_ns())
    mine = defaultdict(list)
    for r in recs:
        mine[r.name].append(r.start_ns)
    assert sum(map(len, mine.values())) == len(recs) > 50
    for name, starts in mine.items():
        assert len(events[name]) == len(starts), name
        for a, b in zip(sorted(starts), sorted(events[name])):
            assert abs(a - b) < 1_000_000, name


def test_a_span_opened_on_another_thread_links_to_its_cause(store):
    seen = {}

    def backward_thread():
        with spans.span("model.layer.backward"):
            with spans.span("model.ssm.backward"):
                pass
        seen["done"] = True

    def block():
        with spans.span("engine.block"):
            with spans.span("local.backward"):
                t = threading.Thread(target=backward_thread)
                t.start()
                t.join()

    _traced(block)
    assert seen["done"]
    by = {r.name: r for r in spans.records()}
    assert by["model.layer.backward"].parent == by["local.backward"].id
    assert by["model.ssm.backward"].parent == by["model.layer.backward"].id
    assert by["model.ssm.backward"].thread != by["local.backward"].thread
    assert {r.block for r in by.values()} == {0}


def test_the_store_is_bounded_and_counts_what_it_drops(store,
                                                      monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 3)

    def five():
        for _ in range(5):
            with spans.span("local.update"):
                pass

    _traced(five)
    assert len(spans.records()) == 3 and spans.dropped() == 2
    assert spans.totals()["local.update"][0] == 3
    spans.reset()
    assert spans.records() == [] and spans.dropped() == 0
