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

``--watch`` needs ``ServeLoop``, still to be ported (ROADMAP.md queue 1
item 26).
"""
from __future__ import annotations

import argparse
import time
import warnings

import torch

from repro_torch.api import EngineState, TOPOLOGIES, build
from repro_torch.api.cli import add_spec_args, spec_from_args
from repro_torch.checkpoint.store import (load_checkpoint, load_experiment,
                                          load_spec)
from repro_torch.configs import get_config
from repro_torch.core.serving import CONSENSUS_QUANTIZE, consensus_from_stacked
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf

__all__ = ["consensus_from_stacked", "load_params", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _load_spec_checkpoint(args, spec, device: torch.device, timings: dict):
    """(params, cfg, freshness weights or None) of a spec-embedding
    checkpoint: the engine rebuilt from the stored spec, the consensus of
    the restored stack."""
    if getattr(args, "spec", None) or getattr(args, "preset", None):
        warnings.warn(
            "the checkpoint embeds its own ExperimentSpec, which takes "
            "precedence — the --spec/--preset flags are ignored for "
            "serving", stacklevel=3)
    eng = build(spec, device=device)
    K = spec.run.num_agents
    cfg = eng.model.cfg
    # meta tensors: the template gives shapes only, no K random models
    like = EngineState(tf.param_specs(cfg, num_agents=K))
    is_async = spec.asynchrony.enabled
    if is_async:
        # the clocks too: the consensus weights the stack by freshness
        like = like.replace(async_state={"t_local": torch.empty(
            (K,), dtype=torch.float32, device="meta")})
    t0 = time.perf_counter()
    state, meta = load_experiment(args.checkpoint, like, device=device)
    _sync(device)
    timings["load_s"] = time.perf_counter() - t0
    weights = None
    if is_async:
        t_local = state.async_state["t_local"]
        age = t_local.max() - t_local
        weights = eng._discount(age)
        a = spec.asynchrony
        print(f"async checkpoint: freshness-weighted consensus "
              f"(discount={a.discount}({a.discount_rate}); agent clock "
              f"ages max={float(age.max()):.1f})")
    if meta.get("epsilon_spent") is not None:
        print(f"privacy: checkpoint trained under "
              f"(epsilon={float(meta['epsilon_spent']):.3f}, "
              f"delta={meta.get('privacy_delta', spec.privacy.delta):g})"
              "-DP (RDP accountant at the realized participation rate)")
    # the consensus comes from the topology the agents trained on; a
    # time-varying graph is approximated by its base topology
    topo = (TOPOLOGIES.get(spec.topology.kind)(spec.topology, K)
            if K > 1 else None)
    if spec.graph.kind != "static":
        warnings.warn(
            f"checkpoint was trained on a time-varying graph "
            f"({spec.graph.kind!r}); consensus extraction uses the base "
            f"{spec.topology.kind!r} topology, not a realized draw",
            stacklevel=3)
    print(f"loaded spec checkpoint (K={K}, arch={spec.model.arch}, "
          f"step={meta.get('step')}); extracting consensus via "
          f"mix={spec.mixer.kind} over topology={spec.topology.kind}")
    t0 = time.perf_counter()
    params = consensus_from_stacked(
        state.params, K, spec.mixer.kind, trim=spec.mixer.trim,
        scope=spec.mixer.scope, topology=topo,
        quantize=args.consensus_quantize, weights=weights)
    _sync(device)
    timings["consensus_s"] = time.perf_counter() - t0
    del state
    return params, cfg, weights


def load_params(args, key: torch.Generator, device: torch.device):
    """Resolve (params, cfg, timings, weights) from a spec checkpoint, the
    stacked-checkpoint path, a plain checkpoint, or fresh initialization
    from ``key``; ``weights`` are an async checkpoint's freshness weights
    (else None)."""
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
                                                     timings)
        return params, cfg, timings, weights
    bundle = get_config(args.arch)
    cfg = bundle.smoke if args.smoke else bundle.model
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


def main(argv=None) -> dict:
    """Run the driver; returns the consensus params, the generated tokens,
    the last-position prefill logits, the timings (seconds) and an async
    checkpoint's freshness weights (``weights``, else None)."""
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
    params, cfg, timings, weights = load_params(args, kp, device)

    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=kt).to(device)
    max_len = args.prompt_len + args.decode

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = tf.prefill(params, cfg, prompts, max_len=max_len)
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
                   torch.empty((args.batch, 0), dtype=torch.int32,
                               device=device))
        gen = gen.cpu()                   # device -> host inside the window
        timings["decode_s"] = time.perf_counter() - t0

    tok_s = args.decode * args.batch / max(timings["decode_s"], 1e-9)
    print(f"prefill: {args.batch}x{args.prompt_len} in "
          f"{timings['prefill_s']:.3f}s")
    print(f"decode:  {args.decode} steps ({args.decode_loop} loop) in "
          f"{timings['decode_s']:.3f}s ({tok_s:.1f} tok/s)")
    print("sample tokens[0,:16]:", gen[0, :16].tolist())
    return {"params": params, "cfg": cfg, "tokens": gen,
            "prefill_logits": first_logits, "timings": timings,
            "tokens_per_s": tok_s, "weights": weights}


if __name__ == "__main__":
    main()
