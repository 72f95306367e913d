"""Port parity: the serving entry point on a stacked checkpoint written by
the reference, the device rule of the entry points, and the import
boundary (the port never loads ``jax`` or ``repro``)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import save_checkpoint as ref_save  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.serving import consensus_from_stacked as ref_consensus  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
K = 4


@pytest.fixture(scope="module")
def ref_stack_ckpt(tmp_path_factory):
    """A K=4 stacked smoke checkpoint written by the reference."""
    cfg = ref_get_config("smollm-360m").smoke
    rng = np.random.default_rng(10)
    stacked = jax.tree.map(
        lambda s: jax.numpy.asarray(
            rng.standard_normal((K,) + s.shape) / np.sqrt(s.shape[-1]),
            s.dtype),
        ref_tf.param_specs(cfg))
    path = str(tmp_path_factory.mktemp("ckpt") / "stack.npz")
    ref_save(path, stacked, step=5)
    return path, stacked


def _argv(path, *extra):
    return ["--smoke", "--agents", str(K), "--checkpoint", path,
            "--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--decode", "4", "--temperature", "0", *extra]


@pytest.mark.parametrize("mix", ["pallas", "dense", "auto"])
def test_serve_main_on_reference_checkpoint(ref_stack_ckpt, mix):
    path, stacked = ref_stack_ckpt
    out = serve.main(_argv(path, "--mix", mix))
    want = ref_consensus(stacked, K, "dense")
    for g, w in zip(tree_leaves(out["params"]), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    toks = out["tokens"]
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (2, 4)
    assert int(toks.min()) >= 0 and int(toks.max()) < 512
    assert set(out["timings"]) >= {"load_s", "consensus_s", "prefill_s",
                                   "decode_s"}


def test_serve_loops_agree_at_temperature_zero(ref_stack_ckpt):
    path, _ = ref_stack_ckpt
    fused = serve.main(_argv(path, "--mix", "pallas", "--decode-loop",
                             "fused"))
    py = serve.main(_argv(path, "--mix", "pallas", "--decode-loop", "py"))
    assert torch.equal(fused["tokens"], py["tokens"])


def test_serve_without_checkpoint_and_pending_paths(tmp_path):
    out = serve.main(["--device", "cpu", "--batch", "1", "--prompt-len",
                      "4", "--decode", "2"])
    assert tuple(out["tokens"].shape) == (1, 2)
    path = str(tmp_path / "spec.npz")
    save_checkpoint(path, {"w": torch.zeros(2)}, metadata={"spec": "{}"})
    with pytest.raises(NotImplementedError, match="API slice"):
        serve.main(["--device", "cpu", "--checkpoint", path])


def test_entry_points_without_device_refuse_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None means the card")
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--batch", "1", "--prompt-len", "4", "--decode", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(path, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": np.zeros(2, np.float32)})
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15
    # chip_smoke.py imports only the port, torch, numpy and the stdlib
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert not mods & {"jax", "repro"}, mods


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
