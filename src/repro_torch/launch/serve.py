"""Batched serving driver: collapse an agent stack, prefill prompts, decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --full --agents 8 --checkpoint stack.npz --mix pallas \
      --batch 4 --prompt-len 128 --decode 32 --temperature 0
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --agents 4 --checkpoint stack.npz --mix trimmed_mean --trim 1 \
      --robust-scope neighborhood
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --full --agents 8 --checkpoint stack.npz --mix pallas \
      --consensus-quantize int8 --temperature 0
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --checkpoint ckpt.npz --batch 2 --prompt-len 16 --decode 4 \
      --temperature 0
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch musicgen-medium --smoke --watch ckpts/ --watch-ticks 20 \
      --temperature 0

Counterpart of ``repro.launch.serve``.  A checkpoint written by
``repro_torch.launch.train --checkpoint`` (or the reference's) embeds its
:class:`repro_torch.api.ExperimentSpec`, so ``--checkpoint`` alone is
enough: the engine is rebuilt from the stored spec
(:func:`repro_torch.api.build`), the iterate restored
(:func:`repro_torch.checkpoint.load_experiment`), and the consensus
extracted through the trained mixer over the training topology (the base
topology of a time-varying graph, with a warning).  For an async run the
agent clocks are restored too and the consensus is freshness-weighted by
the engine's age-discount law, ``discount(max t_local - t_local)``.  A
private run's ``epsilon_spent`` is printed beside the model.

Spec-less checkpoints take the flag path: ``--agents K`` marks an
agent-stacked checkpoint whose consensus (over the FedAvg base graph) is
extracted through ``--mix``; ``pallas`` (and ``auto`` on CUDA) runs the
fused eq.-20 kernel, ``gather`` the gather kernel, and
``trimmed_mean``/``median`` with ``--robust-scope neighborhood`` the fused
gather-sort kernel on CUDA.  ``--consensus-quantize int8`` collapses from
the int8-quantized stack (the training-side wire quantizer).  The spec
flags are the shared set of :mod:`repro_torch.api.cli`; ``--agents``
defaults to 1 here (a plain checkpoint is one model), so ``--preset``
needs an explicit ``--agents``.  ``--device`` defaults to CUDA and never
falls back to the CPU by itself; ``--device cpu`` runs the plain versions.

A codebook config (musicgen) takes prompts (B, P, nq) and decodes (B, n,
nq) tokens.  An image-prefix config (llava) draws an image prefix (B,
img_tokens, VISION_DIM), float32 normals times 0.02, from the prompts'
CPU stream after the prompts, and passes it to prefill; the cache is then
sized for the whole context, ``img_tokens + prompt_len + decode``
positions (the reference sizes it ``prompt_len + decode``, so that each
decoded token overwrites the oldest image position: ROADMAP.md queue 3).

``--watch DIR`` switches to the continuous-batching
:class:`repro_torch.launch.serving.ServeLoop` (``--batch`` slots, the
``--batch`` prompts as requests, chunks of ``min(8, --decode)`` tokens)
and re-extracts the consensus as training checkpoints stream into DIR
(double-buffered swap: in-flight decodes never see a torn update), every
``--watch-poll`` seconds, for ``--watch-ticks`` ticks (forever by
default).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import warnings

import torch

from repro_torch.api.cli import add_spec_args, spec_from_args
from repro_torch.checkpoint.store import load_checkpoint, load_spec
from repro_torch.configs import get_config
from repro_torch.core.serving import CONSENSUS_QUANTIZE, consensus_from_stacked
from repro_torch.device import resolve_device
from repro_torch.launch.serving import Request, ServeLoop, spec_consensus
from repro_torch.models import transformer as tf

__all__ = ["consensus_from_stacked", "load_params", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _load_spec_checkpoint(args, spec, device: torch.device, timings: dict,
                          num_layers: int | None = None):
    """(params, cfg, freshness weights or None) of a spec-embedding
    checkpoint: the engine rebuilt from the stored spec, the consensus of
    the restored stack (:func:`repro_torch.launch.serving.spec_consensus`),
    with the reference's report of it."""
    if getattr(args, "spec", None) or getattr(args, "preset", None):
        warnings.warn(
            "the checkpoint embeds its own ExperimentSpec, which takes "
            "precedence — the --spec/--preset flags are ignored for "
            "serving", stacklevel=3)
    if spec.graph.kind != "static":
        warnings.warn(
            f"checkpoint was trained on a time-varying graph "
            f"({spec.graph.kind!r}); consensus extraction uses the base "
            f"{spec.topology.kind!r} topology, not a realized draw",
            stacklevel=3)
    params, cfg, _, weights = spec_consensus(
        args.checkpoint, spec, quantize=args.consensus_quantize,
        device=device, timings=timings, report=True, num_layers=num_layers)
    return params, cfg, weights


def load_params(args, key: torch.Generator, device: torch.device,
                num_layers: int | None = None):
    """Resolve (params, cfg, timings, weights) from a spec checkpoint, the
    stacked-checkpoint path, a plain checkpoint, or fresh initialization
    from ``key``; ``weights`` are an async checkpoint's freshness weights
    (else None).  ``num_layers`` cuts the config's depth (widths kept), as
    ``train.main``'s knob of that name does for the checkpoints it
    writes."""
    timings = {}
    spec = load_spec(args.checkpoint) if args.checkpoint else None
    if spec is not None and spec.model.kind == "external":
        # an externally supplied loss (regression / theory workloads):
        # nothing to serve; fall back to the flag path
        print("checkpoint spec has model kind 'external' (nothing to "
              "serve); falling back to --arch/--agents/--mix flags")
        spec = None
    if spec is not None:
        params, cfg, weights = _load_spec_checkpoint(args, spec, device,
                                                     timings, num_layers)
        return params, cfg, timings, weights
    bundle = get_config(args.arch)
    cfg = bundle.smoke if args.smoke else bundle.model
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    if not args.checkpoint:
        return tf.init_params(key, cfg), cfg, timings, None
    K = args.agents
    like = tf.param_specs(cfg, num_agents=K if K > 1 else None)
    t0 = time.perf_counter()
    tree, meta = load_checkpoint(args.checkpoint, like, device=device)
    _sync(device)
    timings["load_s"] = time.perf_counter() - t0
    if K <= 1:
        print(f"loaded checkpoint (step={meta.get('step')})")
        return tree, cfg, timings, None
    print(f"loaded stacked checkpoint (K={K}, step={meta.get('step')}); "
          f"extracting consensus via --mix {args.mix}")
    t0 = time.perf_counter()
    params = consensus_from_stacked(tree, K, args.mix, trim=args.trim,
                                    scope=args.robust_scope,
                                    quantize=args.consensus_quantize)
    _sync(device)
    timings["consensus_s"] = time.perf_counter() - t0
    return params, cfg, timings, None


def _check_preset_shim(ap: argparse.ArgumentParser, args) -> None:
    """serve defaults --agents to 1 (a spec-less checkpoint is a plain
    single model), but a --preset factory is parameterized by
    K=args.agents, so the default would silently build a 1-agent variant
    of the preset: --preset on serve requires an explicit --agents, as in
    the reference."""
    if args.preset and "agents" not in getattr(args, "_explicit", set()):
        ap.error(
            "--preset on serve needs an explicit --agents K: serve's "
            "spec-less shim defaults --agents to 1 (a plain checkpoint "
            "is a single model), which would silently override the "
            "preset's agent count")


def main(argv=None, *, num_layers: int | None = None) -> dict:
    """Run the driver (``num_layers`` cuts the model's depth, keeping its
    widths, as ``train.main``'s knob does: a checkpoint trained at a cut
    depth serves at it); returns the consensus params, the prompts (and the
    image prefix, ``img_embeds``, else None), the generated tokens, the
    last-position prefill logits, the cache's positions (``max_len``), the
    timings (seconds) and an async checkpoint's freshness weights
    (``weights``, else None).  With ``--watch``: the params, the
    ServeLoop (``loop``) and its completions (``completions``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_spec_args(ap)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--checkpoint", default=None,
                    help="npz checkpoint (spec-embedding, agent-stacked, or "
                         "plain)")
    ap.add_argument("--decode-loop", choices=["fused", "py"], default="fused",
                    help="fused: sampling inside decode_loop; py: the "
                         "per-token loop written out here (token-parity "
                         "with fused at temperature 0)")
    ap.add_argument("--consensus-quantize", choices=list(CONSENSUS_QUANTIZE),
                    default="none",
                    help="collapse the agent stack from int8-quantized "
                         "leaves (Int8Stochastic, the training-side wire "
                         "quantizer) instead of the stored ones")
    ap.add_argument("--watch", default=None, metavar="DIR",
                    help="continuous mode: serve through the slot-batched "
                         "ServeLoop while re-extracting the consensus from "
                         "*.npz checkpoints streaming into DIR "
                         "(double-buffered param swap)")
    ap.add_argument("--watch-poll", type=float, default=2.0,
                    help="watch-mode poll interval, seconds")
    ap.add_argument("--watch-ticks", type=int, default=None,
                    help="stop watch mode after N ticks (default: forever)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    # a spec-less checkpoint is a plain single model unless --agents says
    # otherwise (spec checkpoints carry K themselves)
    ap.set_defaults(agents=1)
    args = ap.parse_args(argv)
    _check_preset_shim(ap, args)
    spec_from_args(args)      # validate the shared flags map onto a spec
    device = resolve_device(args.device)

    # separate streams for init, prompts and sampling, as the reference
    # splits its key (the streams themselves are torch's, not JAX's); the
    # prompts come from a CPU stream so every device serves the same ones
    kp, ks = (torch.Generator(device=device).manual_seed(args.seed + i)
              for i in (0, 2))
    kt = torch.Generator().manual_seed(args.seed + 1)
    params, cfg, timings, weights = load_params(args, kp, device,
                                                num_layers)

    shape = (args.batch, args.prompt_len) + (
        (cfg.num_codebooks,) if cfg.num_codebooks else ())
    prompts = torch.randint(0, cfg.vocab_size, shape, generator=kt)
    img = None
    if cfg.img_tokens:
        img = torch.randn((args.batch, cfg.img_tokens, tf.VISION_DIM),
                          generator=kt).mul_(0.02).to(device)
    prompts = prompts.to(device)
    # the cache holds the whole context: image prefix, prompt, decode
    max_len = (cfg.img_tokens if img is not None else 0) + (
        args.prompt_len + args.decode)

    if args.watch:
        loop = ServeLoop(cfg, params, slots=args.batch,
                         max_len=args.prompt_len + args.decode,
                         decode_loop=args.decode_loop,
                         temperature=args.temperature,
                         chunk=max(1, min(8, args.decode)), seed=args.seed)
        for i in range(args.batch):
            loop.submit(Request(uid=i, prompt=prompts[i].cpu().numpy(),
                                max_new_tokens=args.decode))
        done = loop.watch(args.watch, poll_s=args.watch_poll,
                          max_ticks=args.watch_ticks,
                          quantize=args.consensus_quantize)
        for c in sorted(done, key=lambda c: c.uid):
            print(f"request {c.uid}: {len(c.tokens)} tokens across "
                  f"{len(set(c.generations))} checkpoint generation(s)")
        return {"params": params, "cfg": cfg, "loop": loop,
                "completions": done, "timings": timings}

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = tf.prefill(params, cfg, prompts, img_embeds=img,
                                   max_len=max_len)
        logits = logits[:, -1]
        _sync(device)
        timings["prefill_s"] = time.perf_counter() - t0
        first_logits = logits

        greedy = args.temperature <= 0
        key = None if greedy else ks
        t0 = time.perf_counter()
        if args.decode_loop == "fused":
            gen, logits, cache = tf.decode_loop(
                params, cfg, cache, logits, key, args.decode,
                temperature=args.temperature)
        else:
            out_tokens = []
            for _ in range(args.decode):
                nxt = tf.sample_logits(logits, key, args.temperature)
                out_tokens.append(nxt)
                lg, cache = tf.decode_step(params, cfg, cache, nxt[:, None])
                logits = lg[:, 0]
            gen = (torch.stack(out_tokens, dim=1) if out_tokens else
                   torch.empty(shape[:1] + (0,) + shape[2:],
                               dtype=torch.int32, device=device))
        gen = gen.cpu()                   # device -> host inside the window
        timings["decode_s"] = time.perf_counter() - t0

    tok_s = args.decode * args.batch / max(timings["decode_s"], 1e-9)
    print(f"prefill: {args.batch}x{args.prompt_len} in "
          f"{timings['prefill_s']:.3f}s")
    print(f"decode:  {args.decode} steps ({args.decode_loop} loop) in "
          f"{timings['decode_s']:.3f}s ({tok_s:.1f} tok/s)")
    print("sample tokens[0,:16]:", gen[0, :16].tolist())
    return {"params": params, "cfg": cfg, "prompts": prompts,
            "img_embeds": img, "tokens": gen, "prefill_logits": first_logits,
            "max_len": max_len, "timings": timings, "tokens_per_s": tok_s,
            "weights": weights}


if __name__ == "__main__":
    main()
