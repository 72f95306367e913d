"""Port parity: the training forward and loss, and ``launch.train.main``.

``repro_torch.models.transformer.forward``/``train_loss`` and their
gradients against the reference's at the smoke config, with
``use_kernels`` off (streaming attention) and on (the attention op: the
reference's Pallas kernel in interpret mode, the port's plain version on
the CPU); the gates are those of ``tests/test_kernel_integration.py``.
Then ``repro_torch.launch.train.main`` on the CPU."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


@pytest.fixture(scope="module")
def model():
    """Seeded numpy weights at the reference's init scales and one batch
    of 2 x 128 tokens, in both packages."""
    ref_cfg = ref_get_config("smollm-360m").smoke
    rng = np.random.default_rng(0)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            w = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif "embed" in name:
            w = 0.02 * rng.standard_normal(s.shape)
        else:
            w = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
        return jnp.asarray(w, s.dtype)

    ref_params = jax.tree_util.tree_map_with_path(
        leaf, ref_tf.param_specs(ref_cfg))
    tok = rng.integers(0, ref_cfg.vocab_size, (2, 128)).astype(np.int32)
    lab = np.concatenate([tok[:, 1:], np.zeros_like(tok[:, :1])], -1)
    ref_batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    params = params_from_jax(jax.device_get(ref_params), device="cpu")
    return ref_cfg, ref_params, ref_batch, params, batch


def _cfgs(ref_cfg, use_kernels):
    return (dataclasses.replace(ref_cfg, use_kernels=use_kernels),
            dataclasses.replace(get_config("smollm-360m").smoke,
                                use_kernels=use_kernels))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_matches_reference(model, use_kernels):
    ref_cfg, ref_params, ref_batch, params, batch = model
    rc, c = _cfgs(ref_cfg, use_kernels)
    want, _, _ = jax.jit(lambda p, t: ref_tf.forward(p, rc, t, remat=False))(
        ref_params, ref_batch["tokens"])
    got, aux, n_prefix = tf.forward(params, c, batch["tokens"], remat=False)
    assert float(aux) == 0.0 and n_prefix == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_train_loss_and_gradients_match_reference(model, use_kernels):
    ref_cfg, ref_params, ref_batch, params, batch = model
    rc, c = _cfgs(ref_cfg, use_kernels)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p: ref_tf.train_loss(p, rc, ref_batch, remat=False)))(
            ref_params)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = tf.train_loss(params, c, batch, remat=False)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-3)
    for g, w in zip(grads, jax.tree.leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_remat_recomputes_the_same_loss_and_gradients(model):
    _, _, _, params, batch = model
    c = dataclasses.replace(get_config("smollm-360m").smoke, use_kernels=True)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    out = []
    for remat in (False, True):
        loss = tf.train_loss(params, c, batch, remat=remat)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    for p in leaves:
        p.requires_grad_(False)
    # the same arithmetic; only the order in which autograd accumulates
    # the tied embedding's gradients may differ
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_train_main_runs_on_the_cpu(use_kernels):
    """The default flags, cut to 2 blocks."""
    out = train.main(["--device", "cpu", "--blocks", "2"],
                     use_kernels=use_kernels)
    assert out["cfg"].use_kernels is use_kernels
    assert len(out["losses"]) == 2 and len(out["timings"]) == 2
    assert all(np.isfinite(x).all() for x in out["losses"])
    assert all(len(a) == 4 and set(a) <= {0.0, 1.0} for a in out["active"])
    state = out["state"]
    assert state.params["embed"].shape[0] == 4
    assert int(state.opt_state["t"]) == 4           # adam, T=2, 2 blocks


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m"])
def test_train_main_init_on_device_draws_from_the_run_seed(arch):
    """``init_on_device`` draws the initial stack from a fresh generator of
    the device seeded with ``--seed`` (on the CPU: the host generator's
    first draws), and leaves the host generator to the engine and data."""
    argv = ["--device", "cpu", "--blocks", "1", "--arch", arch, "--smoke",
            "--seed", "3", "--optimizer", "sgd", "--step-size", "0.05"]
    seen = {}
    out = train.main(argv, init_on_device=True, on_block=lambda i, before,
                     after, m: seen.update(p=before.params))
    want = train.init_stacked(torch.Generator().manual_seed(3),
                              out["cfg"], 4, torch.device("cpu"))
    for x, y in zip(tree_leaves(seen["p"]), tree_leaves(want)):
        assert torch.equal(x, y)
    assert np.isfinite(out["losses"]).all()


def test_train_main_is_reproducible_and_kernel_path_agrees():
    argv = ["--device", "cpu", "--blocks", "2", "--mix", "pallas",
            "--optimizer", "sgd", "--step-size", "0.05", "--seq", "32"]
    a = train.main(argv)
    b = train.main(argv, use_kernels=True)
    assert a["active"] == b["active"]
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
    for x, y in zip(tree_leaves(a["state"].params),
                    tree_leaves(b["state"].params)):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)


def test_train_main_byzantine_preset_on_the_cpu():
    """The reference's byzantine_robust_diffusion preset through
    train.main (smoke size, K = 12): the Byzantine agents ascend, the
    neighborhood trimmed mean keeps the honest ones finite, and the fused
    path (the kernel's plain version on the CPU) equals the gather table."""
    argv = ["--device", "cpu", "--agents", "12", "--blocks", "2",
            "--optimizer", "sgd", "--step-size", "0.05", "--seq", "16",
            "--batch", "1", "--mix", "trimmed_mean", "--trim", "1",
            "--robust-scope", "neighborhood", "--attack", "sign_flip",
            "--attack-num", "3", "--attack-scale", "3.0"]
    table = train.main(argv + ["--robust-gather", "table"])
    fused = train.main(argv + ["--robust-gather", "fused"])
    assert table["active"] == fused["active"]
    assert np.isfinite(table["losses"]).all()
    for x, y in zip(tree_leaves(table["state"].params),
                    tree_leaves(fused["state"].params)):
        assert torch.equal(x, y)
    # the noise adversary keeps its counter in the optimizer state
    noise = train.main(["--device", "cpu", "--agents", "4", "--blocks", "1",
                        "--optimizer", "sgd", "--seq", "16", "--batch", "1",
                        "--attack", "noise", "--attack-scale", "0.1",
                        "--mix", "gather"])
    assert int(noise["state"].opt_state["t"]) == 2          # T = 2 steps


def _ref_pipeline(compress, **kw):
    from repro.core import make_pipeline, make_topology
    return make_pipeline("dense", make_topology(kw.pop("topology", "ring"),
                                                4), compress=compress, **kw)


@pytest.mark.parametrize("flags,want", [
    # the reference's compressed_fedavg preset: FedAvg, int8 + EF, gamma 1
    (["--topology", "fedavg", "--mix", "pallas", "--compress", "int8",
      "--error-feedback"],
     dict(compress="int8", error_feedback=True, topology="fedavg")),
    # its compressed_diffusion preset: ring, top-k 0.1, EF dropped in diff
    (["--mix", "pallas", "--compress", "topk", "--error-feedback"],
     dict(compress="topk", compress_ratio=0.1, error_feedback=True)),
    (["--mix", "dense", "--compress", "gauss", "--compress-sigma", "0.1",
      "--comm-gamma", "0.3"],
     dict(compress="gauss", compress_ratio=0.1, sigma=0.1, gamma=0.3)),
    (["--mix", "sparse", "--compress", "randk", "--compress-ratio", "0.25",
      "--comm-gamma", "auto"],
     dict(compress="randk", compress_ratio=0.25, gamma="auto")),
])
def test_train_main_compression_flags(flags, want):
    """The compression flags with the reference's defaults (ratio 0.1):
    the ``comm:`` banner's compressor, mode, gamma and wire bytes are the
    reference pipeline's, the losses finite, and a stateful pipeline's
    memory is threaded through the blocks."""
    argv = ["--device", "cpu", "--blocks", "2", "--optimizer", "sgd",
            "--step-size", "0.05", "--seq", "16", "--batch", "1"] + flags
    out = train.main(argv)
    ref = _ref_pipeline(**want)
    comm = out["comm"]
    assert (comm["compressor"], comm["mode"], comm["gamma"]) == (
        ref.compressor.name, ref.mode, ref.gamma)
    ref_params = jax.tree.map(
        lambda s: jnp.zeros((4,) + s.shape, s.dtype),
        ref_tf.param_specs(ref_get_config("smollm-360m").smoke))
    assert comm["wire_bytes"] == ref.wire_bytes(ref_params)
    assert np.isfinite(out["losses"]).all()
    state = out["state"]
    assert (state.comm_state is None) == (not ref.stateful)
    if ref.mode == "diff":
        assert any(x.any() for x in tree_leaves(state.comm_state["ref"]))
    again = train.main(argv)
    for x, y in zip(tree_leaves(state.params),
                    tree_leaves(again["state"].params)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("flags,match", [
    (["--trim", "1"], "robust mixer"),
    (["--mix", "pallas", "--robust-scope", "neighborhood"], "robust mixer"),
    (["--mix", "gather", "--robust-gather=table"], "robust mixer"),
    (["--attack-num", "2"], "attack kind"),
    (["--attack", "none", "--attack-scale", "2.0"], "attack kind"),
])
def test_train_flag_guards_raise(flags, match):
    """The reference's guards (repro/api/cli.py): flags that the chosen
    mixer or attack would ignore raise ValueError."""
    with pytest.raises(ValueError, match=match):
        train.main(["--device", "cpu", "--blocks", "1"] + flags)


@pytest.mark.parametrize("flag,item", [
    pytest.param(["--arch", "llava-next-mistral-7b"], "img_embeds",
                 id="flag4-item 17"),
    pytest.param(["--arch", "musicgen-medium"], "tokens",
                 id="flag5-item 17"),
])
def test_unported_flags_name_their_roadmap_item(flag, item):
    """Both archs of item 17's rest now train at smoke size: finite
    losses, moved parameters, and the block carries the arch's own leaf
    (llava's float32 image stream, musicgen's (T, K, B, S, nq) tokens)."""
    out = train.main(["--device", "cpu", "--blocks", "2", "--smoke",
                      "--seq", "16"] + flag)
    cfg = out["cfg"]
    assert np.isfinite(out["losses"]).all() and out["blocks_done"] == 2
    block = out["provider"](0, torch.Generator().manual_seed(0))
    leaf = block[item]
    assert leaf.dtype == (torch.float32 if item == "img_embeds"
                          else torch.int32)
    assert leaf.shape[-1] == (tf.VISION_DIM if item == "img_embeds"
                              else cfg.num_codebooks)


@pytest.mark.parametrize("flag,error", [
    (["--ef-host-offload", "--compress", "int8", "--error-feedback"], None),
    (["--engine", "sharded"], None),
    (["--engine=sharded", "--mix", "pallas"], None),
    (["--ef-host-offload", "--engine", "async"], "ef_host_offload"),
    (["--ef-host-offload", "--engine", "stacked", "--compress", "int8",
      "--error-feedback"], "ef_host_offload"),
    (["--ef-host-offload"], "stateful pipeline"),
])
def test_sharded_engine_flags_run_and_misuse_raises(flag, error):
    """--engine sharded and --ef-host-offload run (the offload is the
    identity on the CPU); the offload with the stacked or async engine, or
    on a stateless pipeline, raises the reference's ValueError."""
    argv = ["--device", "cpu", "--blocks", "1", "--seq", "8"] + flag
    if error is not None:
        with pytest.raises(ValueError, match=error):
            train.main(argv)
        return
    out = train.main(argv)
    assert out["engine"].engine_kind == "sharded"
    assert out["blocks_done"] == 1
    assert all(torch.isfinite(x).all()
               for x in tree_leaves(out["state"].params))


def test_entry_points_without_device_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None means the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--blocks", "1"])
    from repro_torch.core.diffusion import DiffusionConfig, DiffusionEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionEngine(DiffusionConfig(num_agents=2), lambda p, b: 0.0)


def test_unknown_flag_is_an_argument_error():
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--no-such-flag"])
