"""Port parity: ``repro_torch.examples.serve_lm`` against the reference's
``examples/serve_lm.py`` (loaded once; its ``__main__`` is guarded).

For the three smoke archs, the reference's weights (converted by
``repro_torch.models.convert.params_from_jax``) and its prompts: the
port's prefill logits lie within the model tests' ATOL 1e-4 of the
reference's and its 16 greedy tokens are the reference's."""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.examples import serve_lm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: tests/test_torch_transformer.py's and tests/test_torch_ssm_model.py's
ATOL = 1e-4


@pytest.fixture(scope="module")
def ref_serve_lm():
    spec = importlib.util.spec_from_file_location(
        "ref_examples_serve_lm", ROOT / "examples" / "serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _line_pattern(arch, family, prompt, decode):
    return (re.escape(f"{arch:20s} family={family:6s} prompt={prompt} "
                      f"decoded={decode} tokens in ")
            + r"\d+\.\d\ds" + re.escape(f" (cache pos {prompt + decode})"))


@pytest.mark.parametrize("arch", serve_lm.ARCHS)
def test_serve_lm_greedy_tokens_equal_the_reference(arch, ref_serve_lm):
    ref = ref_serve_lm
    assert (serve_lm.DECODE, serve_lm.PROMPT) == (ref.DECODE, ref.PROMPT)
    cfg = ref_get_config(arch).smoke
    # the reference example's serve(arch), its values kept
    key = jax.random.PRNGKey(0)
    params = ref_tf.init_params(key, cfg)
    shape = ((2, ref.PROMPT) if not cfg.num_codebooks
             else (2, ref.PROMPT, cfg.num_codebooks))
    prompts = jax.random.randint(key, shape, 0, cfg.vocab_size)
    logits, cache = jax.jit(lambda p, t: ref_tf.prefill(
        p, cfg, t, max_len=ref.PROMPT + ref.DECODE))(params, prompts)
    toks, _, cache = jax.jit(lambda c, lg: ref_tf.decode_loop(
        params, cfg, c, lg, None, ref.DECODE, temperature=0.0))(
            cache, logits[:, -1])

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = serve_lm.serve(
            arch, device="cpu",
            params=params_from_jax(jax.device_get(params), device="cpu"),
            prompts=torch.from_numpy(np.array(prompts)))
    np.testing.assert_allclose(got["prefill_logits"].numpy(),
                               np.asarray(logits), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(toks))
    assert got["cache_pos"] == int(cache.pos) == ref.PROMPT + ref.DECODE
    assert re.fullmatch(_line_pattern(arch, cfg.family, ref.PROMPT,
                                      ref.DECODE), out.getvalue().strip())


def test_serve_lm_main_prints_the_reference_lines():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = serve_lm.main(["--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert list(got) == list(serve_lm.ARCHS) == ["smollm-360m",
                                                 "mamba2-2.7b",
                                                 "musicgen-medium"]
    for line, arch in zip(lines, serve_lm.ARCHS):
        cfg = ref_get_config(arch).smoke
        assert re.fullmatch(_line_pattern(arch, cfg.family, 48, 16), line)
        r = got[arch]
        assert r["cache_pos"] == 64
        assert r["tokens"].shape == ((2, 16) if not cfg.num_codebooks
                                     else (2, 16, cfg.num_codebooks))
        assert r["tokens"].min() >= 0 and r["tokens"].max() < cfg.vocab_size
    assert len(lines) == 3
    # the weights and prompts come from one host generator: a second run
    # serves the same tokens
    with contextlib.redirect_stdout(io.StringIO()):
        again = serve_lm.serve("mamba2-2.7b", device="cpu")
    assert torch.equal(again["tokens"], got["mamba2-2.7b"]["tokens"])
