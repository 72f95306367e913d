"""Serving example: batched prefill + decode with a KV/SSM cache.

Demonstrates the serving path for three architecture families: dense
(sliding-window ring-buffer cache), SSM (O(1) recurrent state) and
multi-codebook audio.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

Counterpart of ``examples/serve_lm.py``.  The weights and then the prompts
come from one host generator (seed 0), so the card and the CPU serve the
same model the same prompts; greedy decoding runs
:func:`repro_torch.models.transformer.decode_loop` (tokens stay on the
device, no host sync per token), and the clock stops after a device
synchronize.  :func:`serve` returns what it prints and the tokens.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_map

__all__ = ["ARCHS", "DECODE", "PROMPT", "main", "serve"]

DECODE = 16
PROMPT = 48
ARCHS = ("smollm-360m", "mamba2-2.7b", "musicgen-medium")


def serve(arch: str, device=None, params=None, prompts=None) -> dict:
    """Prefill ``PROMPT`` tokens and decode ``DECODE`` greedily with
    ``arch``'s smoke config on ``device`` (``None`` means CUDA).  The
    weights and prompts are drawn from the seed-0 host generator unless
    given (a parameter tree and (B, PROMPT[, nq]) int32 prompts).  Returns
    the tokens (on the host), the prefill logits, the cache position and
    the seconds."""
    dev = resolve_device(device)
    cfg = get_config(arch).smoke
    key = torch.Generator().manual_seed(0)
    if params is None:
        params = tf.init_params(key, cfg)
    params = tree_map(lambda x: x.to(dev), params)
    B = 2
    shape = (B, PROMPT) if not cfg.num_codebooks else (B, PROMPT,
                                                       cfg.num_codebooks)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size, shape, generator=key,
                                dtype=torch.int32)
    prompts = prompts.to(dev)

    t0 = time.time()
    with torch.inference_mode():
        logits, cache = tf.prefill(params, cfg, prompts,
                                   max_len=PROMPT + DECODE)
        # sampling lives inside decode_loop: the greedy generation keeps
        # its tokens on the device
        toks, _, cache = tf.decode_loop(params, cfg, cache, logits[:, -1],
                                        None, DECODE, temperature=0.0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"{arch:20s} family={cfg.family:6s} prompt={PROMPT} "
          f"decoded={DECODE} tokens in {dt:.2f}s "
          f"(cache pos {int(cache.pos)})")
    return {"tokens": toks.cpu(), "prefill_logits": logits,
            "cache_pos": int(cache.pos), "seconds": dt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    args = ap.parse_args(argv)
    return {arch: serve(arch, args.device) for arch in ARCHS}


if __name__ == "__main__":
    main()
