"""Port parity: the language-model training examples of
``repro_torch.examples`` (``train_lm``, ``train_federated_text``) against
the reference's ``examples/``.

Both reference examples parse their flags inside ``main``, so their
steps are rebuilt here with the calls they make.  Replay parity: the port
starts from the reference's initial parameters
(``repro_torch.models.convert.params_from_jax``), takes its block batch
as numpy and its realized mask (``metrics["active"]``, injected with
``active=``), and one block must reach the reference's jitted step's
parameters.  The partitioned corpus and its blocks are bit-equal, and a
port checkpoint reads back in ``repro.checkpoint``."""
import contextlib
import dataclasses
import io
import re

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import build as ref_build  # noqa: E402
from repro.api import spec as ref_spec_lib  # noqa: E402
from repro.checkpoint import load_checkpoint as ref_load  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.diffusion import DiffusionConfig as RefConfig  # noqa: E402
from repro.core.sharded import make_block_step as ref_block_step  # noqa: E402
from repro.data.synthetic import lm_token_batch as ref_lm_batch  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.optim import adam as ref_adam  # noqa: E402
from repro_torch.api import build  # noqa: E402
from repro_torch.examples import train_federated_text, train_lm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

CPU = torch.device("cpu")


def _printed(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue().splitlines()


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _assert_adam_replay(got, want, mu: float, T: int, blocks: int = 1):
    """tests/test_torch_engine.py's Adam gate and its witness: Adam's
    update m / (sqrt(v) + eps) is about +-1 for any gradient far above
    eps, so float32 noise in a near-zero gradient can move a weight by up
    to 2 mu in one step; every weight within 2 mu T blocks, 99.9 % within
    1e-5 (1 + |w|)."""
    bound = 2 * mu * T * blocks
    n_far = n = 0
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        d = np.abs(g - w)
        assert d.max() <= bound
        n_far += int((d > 1e-5 * (1 + np.abs(w))).sum())
        n += d.size
    assert n_far <= 1e-3 * n, (n_far, n)


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_train_lm():
    """``examples/train_lm.py``'s first block at its default flags."""
    K, T, B, S, lr = 4, 2, 4, 64, 3e-3
    cfg = ref_get_config("smollm-360m").smoke
    dcfg = RefConfig(num_agents=K, local_steps=T, step_size=lr,
                     topology="ring", participation=0.8)
    topo = dcfg.make_topology()
    opt = ref_adam()
    block_step = ref_block_step(
        lambda p, b, r: ref_tf.train_loss(p, cfg, b, remat=False), dcfg,
        jnp.asarray(topo.A, jnp.float32), mix="sparse",
        offsets=topo.neighbor_offsets_ring(), grad_transform=opt.update)
    key = jax.random.PRNGKey(0)
    params = jax.vmap(lambda k: ref_tf.init_params(k, cfg))(
        jax.random.split(key, K))
    state = block_step.init_state(params, opt.init(params))
    data = ref_lm_batch(jax.random.PRNGKey(9), (T, K, B, S), cfg.vocab_size)
    key, ks = jax.random.split(key)
    new, metrics = jax.jit(block_step)(state, data, ks)
    eval_loss = jax.vmap(lambda p, b: ref_tf.train_loss(p, cfg, b,
                                                        remat=False))
    return {"cfg": cfg, "params": jax.device_get(params),
            "data": jax.device_get(data), "new": jax.device_get(new),
            "active": np.array(metrics["active"]),
            "eval": np.asarray(eval_loss(new.params, jax.tree.map(
                lambda x: x[0], data)))}


def test_train_lm_one_block_replays_the_reference(ref_train_lm):
    ref = ref_train_lm
    args = train_lm.parser().parse_args(["--device", "cpu"])
    assert (args.arch, args.blocks, args.agents, args.local_steps,
            args.participation, args.seq, args.batch, args.lr,
            args.checkpoint) == ("smollm-360m", 100, 4, 2, 0.8, 64, 4,
                                 3e-3, "/tmp/repro_lm_ckpt.npz")
    cfg, block_step, opt = train_lm.make_step(args, CPU)
    assert type(block_step.pipeline.mixer).__name__ == "SparseCirculantMixer"
    params = params_from_jax(ref["params"], device="cpu")
    state = block_step.init_state(params, opt.init(params))
    new, metrics = block_step(state, _t(ref["data"]), None,
                              active=torch.from_numpy(ref["active"]))
    np.testing.assert_array_equal(metrics["active"].numpy(), ref["active"])
    _assert_adam_replay(new.params, ref["new"].params, args.lr, T=2)
    np.testing.assert_allclose(
        train_lm.eval_loss(new.params, cfg, tree_map(
            lambda x: x[0], _t(ref["data"]))).numpy(), ref["eval"],
        rtol=1e-4)


def test_train_lm_main_trains_and_its_checkpoint_reads_in_the_reference(
        ref_train_lm, tmp_path):
    path = str(tmp_path / "lm.npz")
    out, lines = _printed(train_lm.main, ["--device", "cpu", "--blocks",
                                          "11", "--checkpoint", path])
    assert len(lines) == 3
    for line, i in zip(lines, (0, 10)):
        assert re.fullmatch(
            rf"block {i:4d} active=[0-4]/4 loss={out['losses'][i]:.4f} "
            r"t=\d+\.\ds", line), line
    assert lines[2] == f"checkpoint saved to {path}"
    assert out["losses"][10] < out["losses"][0]
    tree, meta = ref_load(path, ref_train_lm["params"])
    assert meta["step"] == 11 and meta["arch"] == "smollm-360m"
    for a, b in zip(jax.tree.leaves(tree),
                    tree_leaves(out["state"].params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# train_federated_text
# ---------------------------------------------------------------------------

RECIPES = {"shards": [],
           "dirichlet_scale_free": ["--data", "dirichlet", "--alpha", "0.1",
                                    "--topology", "scale_free"]}


def _ref_spec(args):
    """``examples/train_federated_text.py``'s spec, with the reference."""
    r = ref_spec_lib
    spec = r.ExperimentSpec(
        topology=r.TopologySpec(kind=args.topology),
        participation=r.ParticipationSpec(q=args.participation),
        mixer=r.MixerSpec(kind="dense"),
        model=r.ModelSpec(kind="transformer", arch=args.arch, smoke=True),
        data=r.DataSpec(kind=args.data, alpha=args.alpha,
                        corpus_tokens=args.corpus_tokens),
        run=r.RunSpec(num_agents=args.agents, local_steps=args.local_steps,
                      step_size=args.lr, blocks=args.blocks,
                      batch=args.batch, seq=args.seq,
                      local_steps_mode=args.local_steps_mode))
    return spec.replace(optimizer=dataclasses.replace(spec.optimizer,
                                                      kind="adam"))


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_train_federated_text_data_and_one_block_equal_the_reference(
        recipe):
    args = train_federated_text.parser().parse_args(
        ["--device", "cpu", *RECIPES[recipe]])
    spec, ref_spec = train_federated_text.make_spec(args), _ref_spec(args)
    assert spec.to_json() == ref_spec.to_json()
    eng, ref_eng = build(spec, device="cpu"), ref_build(ref_spec)
    assert ([len(p) for p in eng.data.partitions]
            == [len(p) for p in ref_eng.data.partitions])
    for p, r in zip(eng.data.partitions, ref_eng.data.partitions):
        np.testing.assert_array_equal(p, r)
    for i in range(3):
        got, want = eng.data(i, None), ref_eng.data(i, jax.random.PRNGKey(i))
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
    # the reference's first block: kp, then (kb, ks) from the rest
    kp, key = jax.random.split(jax.random.PRNGKey(0))
    params = ref_eng.init_params(kp)
    state = ref_eng.init_state(params, ref_eng.optimizer.init(params))
    _, kb, ks = jax.random.split(key, 3)
    batch = ref_eng.data(0, kb)
    new, metrics = jax.jit(ref_eng.step)(state, batch, ks)
    port_params = params_from_jax(jax.device_get(params), device="cpu")
    port_state = eng.init_state(port_params,
                                eng.optimizer.init(port_params))
    got, _ = eng.step(port_state, _t(batch), None,
                      active=torch.from_numpy(np.array(metrics["active"])))
    _assert_adam_replay(got.params, new.params, args.lr, T=2)


def test_train_federated_text_main_prints_the_reference_lines():
    out, lines = _printed(train_federated_text.main,
                          ["--device", "cpu", "--blocks", "11"])
    sizes = [len(p) for p in out["engine"].data.partitions]
    assert lines[0] == (f"data: shards over 4 agents — windows/agent "
                        f"min={min(sizes)} max={max(sizes)}")
    assert len(lines) == 3
    for line, i in zip(lines[1:], (0, 10)):
        assert re.fullmatch(
            rf"block {i:4d} active=[0-4]/4 loss/agent="
            + re.escape(str([f"{l:.3f}" for l in out["losses"][i]]))
            + r" t=\d+\.\ds", line), line
    assert np.mean(out["losses"][10]) < np.mean(out["losses"][0])
    assert len(out["active"]) == 11


def test_train_federated_text_docstring_recipe_runs_in_degree_mode():
    out, lines = _printed(train_federated_text.main, [
        "--device", "cpu", "--blocks", "2", "--data", "dirichlet", "--alpha",
        "0.1", "--topology", "scale_free", "--local-steps-mode", "degree"])
    eng = out["engine"]
    assert eng.spec.run.local_steps_mode == "degree"
    assert eng.spec.topology.kind == "scale_free"
    assert lines[0].startswith("data: dirichlet over 4 agents")
    assert list(out["losses"]) == [0, 1]
    assert all(np.isfinite(out["losses"][i]).all() for i in (0, 1))
