#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is swallowed):

1. Kernel: build ``diffusion_mix`` from ``src/repro_torch/kernels/csrc`` and
   hold it against the plain version ``mix_ref`` on the card: K in
   {4, 12, 20, 64}, Metropolis and FedAvg matrices, all-zero, all-one and
   random masks, odd M; one K=8, M=3.0e8 case (K*M > 2^31); and the
   serving path's own shape (K=8, M = smollm-360m's parameter count), where
   the kernel, the plain version and ``A_eff.T @ W`` are timed.
   Tolerance: max |kernel - plain| <= 1e-5 * max(1, |plain|).
2. Serve, small: a K=4 stacked smoke checkpoint through
   ``repro_torch.launch.serve.main`` with ``--mix pallas``, on the card and
   on the CPU; the consensus must equal the agents' mean and the two
   devices must agree.
3. Serve, full width: a K=8 bf16 stack of smollm-360m (32 layers, random
   weights from a seed) collapsed through the kernel, then prefill of 4
   prompts of 128 tokens and 32 greedy decode steps.  The kernel's
   consensus must equal the ``--mix dense`` one within one bf16 ulp, two
   greedy runs must give the same tokens, and every token must be in the
   vocabulary.  The kernel's launch count is reset just before the first
   full-width run and read just after it.

The last lines are a JSON object of the kernels' numbers, the card's name
and power limit (``nvidia-smi``), and ``{"ok": true, "device": {...}}``.
Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.  Scratch files go to ``.repro_torch_build/`` in the
checkout and are removed at the end.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 5) -> float:
    import torch

    fn()                                            # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(out, ref) -> float:
    """max |out - ref| / max(1, |ref|), elementwise."""
    return ((out.float() - ref.float()).abs()
            / ref.float().abs().clamp(min=1.0)).max().item()


def full_width_M() -> int:
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    cfg = get_config("smollm-360m").model
    return sum(t.numel() for t in tree_leaves(tf.param_specs(cfg)))


def phase_kernel(card: str) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.participation import masked_combination
    from repro_torch.core.topology import averaging_matrix, make_topology
    from repro_torch.kernels import build
    from repro_torch.kernels import diffusion_mix as dm
    from repro_torch.kernels.ref import mix_ref

    t0 = time.perf_counter()
    dm.build()
    print(f"phase 1: built diffusion_mix in {time.perf_counter() - t0:.1f}s "
          f"[{card}]")
    for line in build.build_log("diffusion_mix").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def check(A_np, mask_np, M, label):
        K = A_np.shape[0]
        A = torch.as_tensor(A_np, dtype=torch.float32, device=dev)
        m = torch.as_tensor(mask_np, dtype=torch.float32, device=dev)
        W = torch.randn((K, M), generator=gen, device=dev)
        out = dm.diffusion_mix(A, m, W)
        ref = mix_ref(A, m, W)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        if not err <= TOL:
            raise AssertionError(f"diffusion_mix {label}: rel err {err:.3e} "
                                 f"> {TOL}")
        return err

    worst = 0.0
    for K in (4, 12, 20, 64):
        mats = {"metropolis": make_topology("erdos", K, seed=K).A,
                "fedavg": averaging_matrix(K)}
        masks = {"zeros": np.zeros(K), "ones": np.ones(K),
                 "random": (rng.random(K) < 0.6).astype(np.float64)}
        for an, A_np in mats.items():
            for mn, mask in masks.items():
                worst = max(worst, check(A_np, mask, 100_003,
                                         f"K={K} {an} mask={mn}"))
    big = check(make_topology("ring", 8).A,
                (rng.random(8) < 0.6).astype(np.float64), 300_000_000,
                "K=8 M=3.0e8")
    print(f"phase 1: 24 cases within {TOL} (worst {worst:.3e}); "
          f"K=8 M=3.0e8 (K*M > 2^31) rel err {big:.3e}")
    torch.cuda.empty_cache()

    # the serving path's shape: the fedavg collapse of K=8 full-width agents
    K, M = 8, full_width_M()
    A = torch.as_tensor(averaging_matrix(K), dtype=torch.float32, device=dev)
    m = torch.ones(K, device=dev)
    W = torch.randn((K, M), generator=gen, device=dev)
    out = dm.diffusion_mix(A, m, W)
    ref = mix_ref(A, m, W)
    torch.cuda.synchronize()
    max_abs = (out - ref).abs().max().item()
    err = rel_err(out, ref)
    if not err <= TOL:
        raise AssertionError(f"diffusion_mix at the serving shape: rel err "
                             f"{err:.3e} > {TOL}")
    del out, ref
    A_eff = masked_combination(A, m)
    ms = time_ms(lambda: dm.diffusion_mix(A, m, W))
    plain_ms = time_ms(lambda: mix_ref(A, m, W))
    library_ms = time_ms(lambda: A_eff.T @ W)
    del W
    torch.cuda.empty_cache()
    nbytes = 4 * (K * K + K + 2 * K * M)
    flops = 2 * K * K * M
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / FP32_FLOPS_PER_S * 1e3
    row = {"name": "diffusion_mix", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/diffusion_mix.cu",
           "replaces": "src/repro/kernels/diffusion_mix.py:99",
           "launches": None, "max_abs_err": max_abs, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "library_ms": library_ms, "torch_call_ms": library_ms,
           "bytes": nbytes, "shape": [K, M]}
    print(f"phase 1: K={K} M={M}: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, A_eff.T @ W {library_ms:.3f} ms, bound {row['bound_ms']:.3f}"
          f" ms ({row['bound_by']}) [{card}]")
    return row


def _stack_agents(cfg, K: int, seed: int):
    """K independently initialized agents stacked on a leading axis."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map

    agents = [tf.init_params(
        torch.Generator(device="cuda").manual_seed(seed + k), cfg)
        for k in range(K)]
    return tree_map(lambda *xs: torch.stack(xs), *agents)


def phase_small(scratch: Path) -> None:
    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.tree import tree_leaves

    cfg = get_config("smollm-360m").smoke
    stack = _stack_agents(cfg, 4, seed=100)
    path = str(scratch / "smoke_k4.npz")
    save_checkpoint(path, stack)
    argv = ["--arch", "smollm-360m", "--smoke", "--agents", "4", "--mix",
            "pallas", "--checkpoint", path, "--batch", "2", "--prompt-len",
            "32", "--decode", "8", "--temperature", "0"]
    gpu = serve.main(argv)
    cpu = serve.main(argv + ["--device", "cpu"])
    mean = [x.float().mean(0) for x in tree_leaves(stack)]
    for got, want, c in zip(tree_leaves(gpu["params"]), mean,
                            tree_leaves(cpu["params"])):
        if (got - want).abs().max().item() > 1e-6:
            raise AssertionError("smoke consensus differs from the mean")
        if (got.cpu() - c).abs().max().item() > 1e-6:
            raise AssertionError("smoke consensus differs between devices")
    lg_err = (gpu["prefill_logits"].cpu() - cpu["prefill_logits"]).abs().max()
    if not lg_err.item() <= 1e-4:
        raise AssertionError(f"smoke prefill logits: card vs CPU "
                             f"{lg_err.item():.3e} > 1e-4")
    toks = gpu["tokens"]
    if toks.shape != (2, 8) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"smoke tokens out of range: {toks}")
    print(f"phase 2: smoke K=4 consensus == mean, card == CPU "
          f"(logits {lg_err.item():.2e})")


def _bf16_ulp_check(a, b, floor: float) -> tuple[int, int, float]:
    """Compare two bf16 results of the same float32-accumulated sum.

    Returns (elements beyond one bf16 ulp of max(|a|, |b|), elements beyond
    that ulp plus ``floor``, the largest |a - b| in such ulps).  ``floor``
    is the float32 summation bound of two summation orders: where the K
    terms nearly cancel, the result is far smaller than its terms and both
    orders carry float32 rounding larger than the result's own ulp."""
    import torch

    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs())
    _, exp = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(mag), exp - 8)   # 8 significant bits
    diff = (a - b).abs()
    return (int((diff > ulp).sum()), int((diff > ulp + floor).sum()),
            (diff / ulp).max().item())


def phase_full(scratch: Path, card: str) -> tuple[int, dict]:
    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.kernels import diffusion_mix as dm
    from repro_torch.launch import serve
    from repro_torch.tree import tree_leaves

    cfg = get_config("smollm-360m").model
    K = 8
    t0 = time.perf_counter()
    stack = _stack_agents(cfg, K, seed=1000)
    path = str(scratch / "smollm360m_k8.npz")
    save_checkpoint(path, stack)
    # float32 summation bound of two orders over K terms, per leaf
    floors = [2 * (K - 1) * 2.0 ** -24 * x.abs().max().item()
              for x in tree_leaves(stack)]
    del stack
    torch.cuda.empty_cache()
    print(f"phase 3: wrote the K={K} bf16 stack in "
          f"{time.perf_counter() - t0:.1f}s [{card}]")
    argv = ["--arch", "smollm-360m", "--full", "--agents", str(K),
            "--checkpoint", path, "--batch", "4", "--prompt-len", "128",
            "--decode", "32", "--temperature", "0"]

    dm.diffusion_mix.launches = 0
    torch.cuda.reset_peak_memory_stats()
    first = serve.main(argv + ["--mix", "pallas"])
    launches = dm.diffusion_mix.launches
    if launches < 1:
        raise AssertionError("the serving path never launched diffusion_mix")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    second = serve.main(argv + ["--mix", "pallas"])
    dense = serve.main(argv + ["--mix", "dense"])
    if not torch.equal(first["tokens"], second["tokens"]):
        raise AssertionError("two greedy runs gave different tokens")
    n_ulp = n_bad = 0
    max_ulps = 0.0
    for a, b, floor in zip(tree_leaves(first["params"]),
                           tree_leaves(dense["params"]), floors):
        over, bad, worst = _bf16_ulp_check(a, b, floor)
        n_ulp, n_bad, max_ulps = n_ulp + over, n_bad + bad, max(max_ulps,
                                                                  worst)
    print(f"phase 3: kernel vs dense consensus: {n_ulp} elements beyond one "
          f"bf16 ulp of the result, {n_bad} beyond it plus the float32 "
          f"summation bound; largest difference {max_ulps:.2f} ulp")
    if n_bad:
        raise AssertionError("kernel consensus != dense consensus within "
                             "one bf16 ulp")
    toks = first["tokens"]
    if (toks.shape != (4, 32) or toks.min() < 0
            or toks.max() >= cfg.vocab_size):
        raise AssertionError(f"full-width tokens out of range: {toks}")
    if not torch.isfinite(first["prefill_logits"]).all():
        raise AssertionError("non-finite prefill logits")
    serve_row = {"phase": "serve", "arch": "smollm-360m", "agents": K,
                 "batch": 4, "prompt_len": 128, "decode": 32,
                 "first_run": first["timings"],
                 "second_run": second["timings"],
                 "tokens_per_s": [first["tokens_per_s"],
                                  second["tokens_per_s"]],
                 "peak_mem_gb": peak_gb, "card": card}
    print(json.dumps(serve_row))
    print(f"phase 3: kernel consensus == dense within 1 bf16 ulp; greedy "
          f"tokens repeat; diffusion_mix launched {launches}x on the path")
    return launches, serve_row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_info()
    scratch = ROOT / ".repro_torch_build" / "chip_smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    try:
        row = phase_kernel(card)
        phase_small(scratch)
        launches, _ = phase_full(scratch, card)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    row["launches"] = launches
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f}s [{card}]")
    print(json.dumps({"kernels": [row], "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
