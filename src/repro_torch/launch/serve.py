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

Counterpart of ``repro.launch.serve`` on its spec-less flag path.  Serving
a diffusion-trained model: ``--agents K`` marks an agent-stacked checkpoint
whose consensus (over the FedAvg base graph) is extracted through
``--mix``; ``pallas`` (and ``auto`` on CUDA) runs the fused eq.-20 kernel,
``gather`` the gather kernel, and ``trimmed_mean``/``median`` with
``--robust-scope neighborhood`` the fused gather-sort kernel on CUDA
(``--trim`` sets the trimmed mean's per-side trim).
``--consensus-quantize int8`` collapses from the int8-quantized stack
(the training-side wire quantizer).  ``--device`` defaults
to CUDA and never falls back to the CPU by itself; ``--device cpu`` runs
the plain versions.

Checkpoints with an embedded ExperimentSpec need the API slice, and
``--watch`` needs ``ServeLoop``: both are still to be ported (ROADMAP.md
queue 1 items 16 and 26).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.store import load_checkpoint, load_meta
from repro_torch.configs import get_config
from repro_torch.core.serving import CONSENSUS_QUANTIZE, consensus_from_stacked
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf

__all__ = ["FLAG_DEFAULTS", "check_robust_flags", "consensus_from_stacked",
           "load_params", "main"]

#: the reference's --mix choices
MIX_CHOICES = ["dense", "sparse", "pallas", "gather", "auto", "none",
               "trimmed_mean", "median", "adaptive_trim"]
ROBUST_MIX = ("trimmed_mean", "median", "adaptive_trim")


#: the robust and attack flags' defaults (the reference's); the parsers
#: leave them None, so that a flag given explicitly can be told apart
FLAG_DEFAULTS = {"trim": 1, "robust_scope": "global",
                 "robust_gather": "auto", "attack_num": 1,
                 "attack_scale": 1.0}


def check_robust_flags(args: argparse.Namespace) -> None:
    """The reference's flag guards (``repro.api.cli``): a robust flag
    given with a mixer that is not robust, or an attack sub-flag with
    ``--attack none``, would be silently ignored, so both raise
    ``ValueError``.  Then fills in the defaults of the flags not given."""
    def given(*dests):
        return ["--" + d.replace("_", "-") for d in dests
                if getattr(args, d, None) is not None]

    robust = given("trim", "robust_scope", "robust_gather")
    if robust and args.mix not in ROBUST_MIX:
        raise ValueError(
            f"{'/'.join(robust)} only applies to the robust mixer backends "
            f"(--mix {'|'.join(ROBUST_MIX)}); the {args.mix!r} mixer "
            "ignores it: drop the flag or pick a robust kind")
    atk = given("attack_num", "attack_scale")
    if atk and getattr(args, "attack", "none") == "none":
        raise ValueError(
            f"{'/'.join(atk)} configures a Byzantine adversary but the "
            'attack kind is "none": pass --attack sign_flip|noise|shift')
    for dest, value in FLAG_DEFAULTS.items():
        if hasattr(args, dest) and getattr(args, dest) is None:
            setattr(args, dest, value)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_params(args, key: torch.Generator, device: torch.device):
    """Resolve (params, cfg, timings) from the stacked-checkpoint path, a
    plain checkpoint, or fresh initialization from ``key``."""
    bundle = get_config(args.arch)
    cfg = bundle.smoke if args.smoke else bundle.model
    timings = {}
    if not args.checkpoint:
        return tf.init_params(key, cfg), cfg, timings
    if "spec" in load_meta(args.checkpoint):
        raise NotImplementedError(
            f"{args.checkpoint} embeds an ExperimentSpec; serving such a "
            "checkpoint needs the API slice (ROADMAP.md queue 1 item 16)")
    K = args.agents
    like = tf.param_specs(cfg, num_agents=K if K > 1 else None)
    t0 = time.perf_counter()
    tree, meta = load_checkpoint(args.checkpoint, like, device=device)
    _sync(device)
    timings["load_s"] = time.perf_counter() - t0
    if K <= 1:
        print(f"loaded checkpoint (step={meta.get('step')})")
        return tree, cfg, timings
    print(f"loaded stacked checkpoint (K={K}, step={meta.get('step')}); "
          f"extracting consensus via --mix {args.mix}")
    t0 = time.perf_counter()
    params = consensus_from_stacked(tree, K, args.mix, trim=args.trim,
                                    scope=args.robust_scope,
                                    quantize=args.consensus_quantize)
    _sync(device)
    timings["consensus_s"] = time.perf_counter() - t0
    return params, cfg, timings


def main(argv=None) -> dict:
    """Run the driver; returns the consensus params, the generated tokens,
    the last-position prefill logits and the timings (seconds)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced smoke config (default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="full-size model config")
    ap.add_argument("--agents", type=int, default=1,
                    help="K > 1 marks an agent-stacked checkpoint")
    ap.add_argument("--mix", default="dense", choices=MIX_CHOICES,
                    help="consensus-extraction backend")
    ap.add_argument("--trim", type=int, default=None,
                    help="per-side trim for --mix trimmed_mean; per-side cap "
                         "for --mix adaptive_trim (default 1)")
    ap.add_argument("--robust-scope", default=None,
                    choices=["global", "neighborhood"],
                    help="robust-aggregation scope: global (one aggregate "
                         "over the active set; the default) or neighborhood "
                         "(per agent over its realized neighborhood)")
    ap.add_argument("--consensus-quantize", choices=list(CONSENSUS_QUANTIZE),
                    default="none",
                    help="collapse the agent stack from int8-quantized "
                         "leaves (Int8Stochastic, the training-side wire "
                         "quantizer) instead of the stored ones")
    ap.add_argument("--checkpoint", default=None,
                    help="npz checkpoint (agent-stacked or plain)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--decode-loop", choices=["fused", "py"], default="fused",
                    help="fused: sampling inside decode_loop; py: the "
                         "per-token loop written out here (token-parity "
                         "with fused at temperature 0)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    args = ap.parse_args(argv)
    check_robust_flags(args)
    device = resolve_device(args.device)

    # separate streams for init, prompts and sampling, as the reference
    # splits its key (the streams themselves are torch's, not JAX's); the
    # prompts come from a CPU stream so every device serves the same ones
    kp, ks = (torch.Generator(device=device).manual_seed(args.seed + i)
              for i in (0, 2))
    kt = torch.Generator().manual_seed(args.seed + 1)
    params, cfg, timings = load_params(args, kp, device)

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
            "tokens_per_s": tok_s}


if __name__ == "__main__":
    main()
