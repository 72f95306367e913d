#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

  python3 chip_smoke.py

Every kernel source is built first, one ``nvcc`` per source, all started
together.  Phases (any failure exits non-zero; nothing is swallowed):

1. ``diffusion_mix`` against its plain version ``mix_ref`` on the card:
   K in {4, 12, 20, 64}, Metropolis and FedAvg matrices, all-zero, all-one
   and random masks, odd M; one K=8, M=3.0e8 case (K*M > 2^31); and each
   path's own shape, with M = smollm-360m's parameter count: training's
   K=4 ring under a partial mask and serving's K=8 FedAvg collapse, where
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
   vocabulary.
4. ``flash_attention`` against its plain version ``attention_ref``: every
   case of the reference's kernel tests (f32 and bf16, windows 32 and 96,
   S = 160 and 192, D = 32/64/128), a non-causal ragged pair of lengths,
   q past 2^31 elements, and the full-width training shape in f32 and
   bf16, where the kernel, the plain version and
   ``scaled_dot_product_attention`` are timed in bf16.  Tolerances: the
   reference's, 2e-5 (f32) and 2e-2 (bf16).
5. Train, full width: Algorithm 1 on smollm-360m through
   ``repro_torch.launch.train.main`` (K=4, T=2, B=2, S=1024, 3 blocks,
   Adam, ``--mix pallas``, ``use_kernels=True``); both kernels' launch
   counts, finite losses and parameters, the per-block split into local
   updates and combination, tokens/s and peak memory; then one local
   step's loss and gradients, kernel path against plain path.
6. Train, small: smoke training with SGD and with Adam on the card and on
   the CPU from one seed; the realized masks are equal and the losses and
   parameters agree within the stated gates.

Each path's launch counts are reset just before its first run and read
just after it (phases 3 and 5).  The last lines are a JSON object of the
kernels' numbers, the card's name and power limit (``nvidia-smi``), and
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.  Scratch files go
to ``.repro_torch_build/`` in the checkout and are removed at the end.
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
BF16_FLOPS_PER_S = 989e12        # H100 SXM, bf16 tensor cores, dense
# the reference's attention gates (tests/test_kernels.py), as allclose's
# atol = rtol
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (B, S, H, Kv, D) of one layer's attention on the full-width training path
TRAIN_ATTN_SHAPE = (2, 1024, 15, 5, 64)
# one full-width local step, kernel vs plain attention: the loss within
# 2e-3 relative; each gradient leaf within 5e-2 in relative Frobenius norm:
# the two forwards round the bf16 attention output (8 significant bits)
# differently, and 32 bf16 layers carry those roundings into the gradients
TRAIN_LOSS_TOL = 2e-3
TRAIN_GRAD_TOL = 5e-2


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


def ptxas_lines(name: str) -> list[str]:
    """``nvcc -Xptxas=-v``'s per-kernel lines: the function, its registers
    and its spills."""
    from repro_torch.kernels import build

    keep = ("Compiling entry function", "registers", "spill")
    return [line.strip() for line in build.build_log(name).splitlines()
            if any(k in line for k in keep)]


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
    from repro_torch.kernels import diffusion_mix as dm
    from repro_torch.kernels.ref import mix_ref

    dm.build()
    for line in ptxas_lines("diffusion_mix"):
        print("  ptxas:", line)

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

    def at_path_shape(A_np, mask_np, label):
        """Check and time the kernel at one path's shape: K agents of
        smollm-360m's M parameters."""
        K, M = A_np.shape[0], full_width_M()
        A = torch.as_tensor(A_np, dtype=torch.float32, device=dev)
        m = torch.as_tensor(mask_np, dtype=torch.float32, device=dev)
        W = torch.randn((K, M), generator=gen, device=dev)
        out = dm.diffusion_mix(A, m, W)
        ref = mix_ref(A, m, W)
        torch.cuda.synchronize()
        max_abs = (out - ref).abs().max().item()
        err = rel_err(out, ref)
        if not err <= TOL:
            raise AssertionError(f"diffusion_mix at the {label} shape: rel "
                                 f"err {err:.3e} > {TOL}")
        del out, ref
        A_eff = masked_combination(A, m)
        ms = time_ms(lambda: dm.diffusion_mix(A, m, W))
        plain_ms = time_ms(lambda: mix_ref(A, m, W))
        library_ms = time_ms(lambda: A_eff.T @ W)
        del W
        torch.cuda.empty_cache()
        nbytes = 4 * (K * K + K + 2 * K * M)
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = 2 * K * K * M / FP32_FLOPS_PER_S * 1e3
        row = {"shape": [K, M], "mask": [int(x) for x in mask_np],
               "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(bound_bytes, bound_ops),
               "bound_by": ("bytes" if bound_bytes >= bound_ops
                            else "operations"),
               "library_ms": library_ms, "bytes": nbytes}
        print(f"phase 1: {label} K={K} M={M} mask={row['mask']}: rel err "
              f"{err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"A_eff.T @ W {library_ms:.3f} ms, bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']}) [{card}]")
        return row

    # each path's own shape: the training path mixes K=4 agents on a ring
    # (Metropolis weights) under a partial mask; the serving path collapses
    # K=8 agents with FedAvg weights, all active
    by_path = {
        "train": at_path_shape(make_topology("ring", 4).A,
                               np.array([1.0, 0.0, 1.0, 1.0]), "training"),
        "serve": at_path_shape(averaging_matrix(8), np.ones(8), "serving")}
    train = by_path["train"]
    return {"name": "diffusion_mix", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/diffusion_mix.cu",
            "replaces": "src/repro/kernels/diffusion_mix.py:99",
            "launches": None, "max_abs_err": train["max_abs_err"],
            "ms": train["ms"], "plain_ms": train["plain_ms"],
            "bound_ms": train["bound_ms"], "bound_by": train["bound_by"],
            "library_ms": train["library_ms"], "bytes": train["bytes"],
            "shape": train["shape"], "by_path": by_path}


def _attention_close(out, ref) -> tuple[bool, float]:
    """The reference's gate, elementwise |out - ref| <= tol (1 + |ref|) with
    tol by dtype; returns (within, max |out - ref|)."""
    tol = ATTN_TOL[str(out.dtype).removeprefix("torch.")]
    diff = (out.float() - ref.float()).abs()
    return (bool((diff <= tol * (1 + ref.float().abs())).all()),
            diff.max().item())


def _attention_inputs(gen, B, Sq, Skv, H, Kv, D, dtype):
    import torch

    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((B, Sq, H, D), (B, Skv, Kv, D),
                               (B, Skv, Kv, D)))


def phase_attention(card: str) -> dict:
    """Phase 4: the flash-attention kernel against ``attention_ref``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref

    fa.build()
    ptxas = ptxas_lines("flash_attention")
    for line in ptxas:
        print("  ptxas:", line)
    gen = torch.Generator(device="cuda").manual_seed(4)
    f32, bf16 = torch.float32, torch.bfloat16
    # (B, Sq, Skv, H, Kv, D, dtype, causal, window): every case of the
    # reference's kernel tests, a non-causal ragged pair of lengths, and the
    # full-width training shape
    cases = [(B, S, S, H, Kv, D, dt, True, None)
             for B, S, H, Kv, D in ((1, 128, 4, 4, 64), (2, 256, 8, 2, 64),
                                    (1, 192, 6, 1, 32), (2, 128, 4, 2, 128))
             for dt in (f32, bf16)]
    cases += [(1, 256, 256, 4, 2, 32, f32, True, w) for w in (32, 96)]
    cases += [(2, 160, 160, 4, 2, 32, f32, True, None),
              (1, 300, 300, 4, 2, 128, bf16, True, 96)]
    cases += [(2, 200, 333, 4, 2, 64, dt, False, None) for dt in (f32, bf16)]
    cases += [(2, 1024, 1024, 15, 5, 64, dt, True, None)
              for dt in (f32, bf16)]
    worst = {f32: 0.0, bf16: 0.0}
    for B, Sq, Skv, H, Kv, D, dt, causal, window in cases:
        q, k, v = _attention_inputs(gen, B, Sq, Skv, H, Kv, D, dt)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        ref = attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ok, err = _attention_close(out, ref)
        if not ok:
            raise AssertionError(
                f"flash_attention {(B, Sq, Skv, H, Kv, D)} {dt} causal="
                f"{causal} window={window}: max |err| {err:.3e} beyond "
                f"{ATTN_TOL}")
        worst[dt] = max(worst[dt], err)
    print(f"phase 4: {len(cases)} cases within the reference's gates "
          f"{ATTN_TOL}: worst max |err| f32 {worst[f32]:.3e}, bf16 "
          f"{worst[bf16]:.3e}")

    # 64-bit offsets: q and out hold more than 2^31 elements; the last
    # batch entries sit past that offset
    B, S, H, Kv, D = 4100, 128, 32, 1, 128
    q, k, v = _attention_inputs(gen, B, S, S, H, Kv, D, bf16)
    out = fa.flash_attention(q, k, v)
    ref = attention_ref(q[-4:], k[-4:], v[-4:])
    ok, big = _attention_close(out[-4:], ref)
    if not ok:
        raise AssertionError(f"flash_attention past 2^31 elements: max |err| "
                             f"{big:.3e}")
    print(f"phase 4: q of {q.numel():,} elements (> 2^31): last batch "
          f"entries max |err| {big:.3e}")
    del q, k, v, out, ref
    torch.cuda.empty_cache()

    # the training shape: one layer's attention at full smollm-360m width
    B, S, H, Kv, D = TRAIN_ATTN_SHAPE
    q, k, v = _attention_inputs(gen, B, S, S, H, Kv, D, bf16)
    out = fa.flash_attention(q, k, v)
    ref = attention_ref(q, k, v)
    max_abs = (out.float() - ref.float()).abs().max().item()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = time_ms(lambda: fa.flash_attention(q, k, v), iters=20)
    plain_ms = time_ms(lambda: attention_ref(q, k, v), iters=20)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())   # q, k, v in, out written
    flops = 2 * 2 * B * H * S * S * D / 2           # causal: half the scores
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    # bf16 inputs: the card's bf16 tensor-core rate bounds the products (a
    # bf16 x bf16 product is exact in their float32 accumulation)
    bound_ops = flops / BF16_FLOPS_PER_S * 1e3
    # the kernel's own design: every product a float32 FMA, no tensor cores
    fma_ms = flops / FP32_FLOPS_PER_S * 1e3
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:79",
           "launches": None, "max_abs_err": max_abs, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "library_ms": library_ms, "fp32_fma_bound_ms": fma_ms,
           "bytes": nbytes, "flops": flops, "shape": [B, S, H, Kv, D],
           "dtype": "bfloat16", "ptxas": ptxas}
    print(f"phase 4: {TRAIN_ATTN_SHAPE} bf16 causal: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, SDPA {library_ms:.3f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {flops:.3e} "
          f"operations at the bf16 rate {BF16_FLOPS_PER_S:.3g}/s, {nbytes:,} "
          f"bytes at {HBM_BYTES_PER_S:.3g} B/s); the same operations as "
          f"float32 FMAs outside the tensor cores, as the kernel does them, "
          f"{fma_ms:.4f} ms [{card}]")
    del q, k, v, qt, kt, vt, out, ref
    torch.cuda.empty_cache()
    return row


def _grads_one_step(params, cfg, batch):
    """Loss and gradients of one agent's local step."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves, tree_unflatten

    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    loss = tf.train_loss(tree_unflatten(params, leaves), cfg, batch,
                         remat=False)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), grads


def _profile_block(state, cfg, K, T, B, S, steady_s: float,
                   card: str) -> dict:
    """One more block from ``state`` under ``torch.profiler``: the device
    time of its kernels (kernel events only: an operator's row repeats the
    time of the kernels it launched), their share of the steady unprofiled
    block ``steady_s``, and the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.diffusion import DiffusionConfig, DiffusionEngine
    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adam
    from repro_torch.tree import tree_map

    eng = DiffusionEngine(
        DiffusionConfig(num_agents=K, local_steps=T, step_size=1e-4,
                        participation=0.9, mix="pallas"),
        lambda p, b: tf.train_loss(p, cfg, b, remat=False), adam().update,
        device="cuda")
    gen = torch.Generator().manual_seed(11)
    batch = tree_map(lambda x: x.cuda(), lm_token_batch(
        gen, (T, K, B, S), cfg.vocab_size))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        new_state, _ = eng.step(state, batch, gen)
        wall = time.perf_counter() - t0
    del new_state
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda r: -r[1])[:8]
    out = {"profiled_wall_s": wall, "steady_block_s": steady_s,
           "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / 1e3 / steady_s if busy_ms else None,
           "device_launches": sum(n for _, _, n in kernels),
           "top_kernels": [{"name": n[:100], "ms": ms, "count": c}
                           for n, ms, c in top]}
    if not busy_ms:
        print("phase 5: the trace holds no device time: busy share not "
              "measured")
    else:
        print(f"phase 5: profiled block: kernels busy {busy_ms:.1f} ms = "
              f"{100 * out['device_busy_share']:.1f} % of the steady "
              f"{steady_s:.3f}s block ({out['device_launches']} kernel "
              f"launches; {wall:.3f}s on the host clock under the "
              f"profiler) [{card}]")
    for r in out["top_kernels"]:
        print(f"  {r['ms']:9.2f} ms  {r['count']:6d}x  {r['name']}")
    return out


def phase_train(card: str) -> tuple[dict, dict]:
    """Phase 5: Algorithm 1 on full-width smollm-360m through train.main,
    with both kernels on the path."""
    import dataclasses

    import torch

    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.kernels import diffusion_mix as dm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves, tree_map

    K, T, B, S, blocks = 4, 2, 2, 1024, 3
    argv = ["--full", "--agents", str(K), "--local-steps", str(T),
            "--batch", str(B), "--seq", str(S), "--blocks", str(blocks),
            "--mix", "pallas", "--optimizer", "adam", "--step-size", "1e-4"]
    torch.cuda.reset_peak_memory_stats()
    dm.diffusion_mix.launches = 0
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    out = train.main(argv, use_kernels=True)
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.flash_attention.launches,
                "diffusion_mix": dm.diffusion_mix.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = out["cfg"]
    # one launch per layer per agent per local step, plus the logging
    # forward of every agent after each block
    want = cfg.num_layers * K * (T * blocks + len(out["losses"]))
    if launches["flash_attention"] != want:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']}x on the training "
                             f"path, expected {want}")
    if launches["diffusion_mix"] < blocks:
        raise AssertionError(f"diffusion_mix launched "
                             f"{launches['diffusion_mix']}x in {blocks} blocks")
    losses = torch.tensor(out["losses"])
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite training losses {out['losses']}")
    state = out["state"]
    if not all(torch.isfinite(x).all() for x in tree_leaves(state.params)):
        raise AssertionError("non-finite parameters after training")
    for i, (t, tps) in enumerate(zip(out["timings"], out["tokens_per_s"])):
        print(f"phase 5: block {i}: {t['block_s']:.3f}s (local updates "
              f"{t['local_s']:.3f}s, combination {t['combine_s']:.3f}s), "
              f"{tps:.0f} tokens/s [{card}]")
    print(f"phase 5: {launches} launches on the training path; peak device "
          f"memory {peak_gb:.2f} GB; train.main took {wall:.1f}s [{card}]")
    steady_s = min(t["block_s"] for t in out["timings"][1:])
    profile = _profile_block(state, cfg, K, T, B, S, steady_s, card)

    # one local step at full width: the kernel path against the plain one
    params = tree_map(lambda x: x[0], state.params)
    batch = tree_map(lambda x: x.cuda(), lm_token_batch(
        torch.Generator().manual_seed(7), (B, S), cfg.vocab_size))
    loss_k, g_k = _grads_one_step(params, cfg, batch)
    loss_p, g_p = _grads_one_step(
        params, dataclasses.replace(cfg, use_kernels=False), batch)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = max(((a.float() - b.float()).norm() / b.float().norm()).item()
                   for a, b in zip(g_k, g_p))
    print(f"phase 5: one local step, kernel vs plain attention: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}, gate "
          f"{TRAIN_LOSS_TOL}); worst gradient leaf |g_k - g_p| / |g_p| = "
          f"{grad_rel:.2e} (gate {TRAIN_GRAD_TOL})")
    if not loss_rel <= TRAIN_LOSS_TOL:
        raise AssertionError("full-width loss: kernel path != plain path")
    if not grad_rel <= TRAIN_GRAD_TOL:
        raise AssertionError("full-width gradients: kernel path != plain")
    row = {"phase": "train", "arch": "smollm-360m", "agents": K,
           "local_steps": T, "batch": B, "seq": S, "blocks": blocks,
           "optimizer": "adam", "mix": "pallas", "timings": out["timings"],
           "tokens_per_s": out["tokens_per_s"], "losses": out["losses"],
           "launches": launches, "peak_mem_gb": peak_gb,
           "profile": profile, "loss_rel_kernel_vs_plain": loss_rel,
           "grad_rel_kernel_vs_plain": grad_rel, "card": card}
    print(json.dumps(row))
    del out, state, params, g_k, g_p
    torch.cuda.empty_cache()
    return launches, row


def phase_train_devices() -> None:
    """Phase 6: smoke training on the card and on the CPU, same seed."""
    import numpy as np
    import torch

    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    base = ["--agents", "4", "--local-steps", "2", "--blocks", "3", "--mix",
            "pallas", "--batch", "2", "--seq", "64"]
    for optimizer, mu in (("sgd", 0.05), ("adam", 1e-3)):
        argv = base + ["--optimizer", optimizer, "--step-size", str(mu)]
        gpu = train.main(argv, use_kernels=True)
        cpu = train.main(argv + ["--device", "cpu"], use_kernels=True)
        # every draw comes from one host generator: the same masks
        if gpu["active"] != cpu["active"]:
            raise AssertionError("card and CPU realized different masks")
        loss_rel = np.max(np.abs(np.subtract(gpu["losses"], cpu["losses"]))
                          / np.abs(cpu["losses"]))
        diffs = [(a.cpu() - b).abs() for a, b in
                 zip(tree_leaves(gpu["state"].params),
                     tree_leaves(cpu["state"].params))]
        worst = max(d.max().item() for d in diffs)
        if optimizer == "sgd":
            ok = loss_rel <= 1e-4 and worst <= 1e-4
            gate = "losses 1e-4 relative, parameters 1e-4"
        else:
            # Adam's update is about +-1 wherever |g| >> eps, so float32
            # noise in a near-zero gradient may move a weight by up to
            # 2 mu per step: all within 2 mu T blocks, 99.9 % within 1e-5
            bound = 2 * mu * 2 * 3
            far = sum(int((d > 1e-5).sum()) for d in diffs)
            total = sum(d.numel() for d in diffs)
            ok = loss_rel <= 1e-3 and worst <= bound and far <= 1e-3 * total
            gate = (f"losses 1e-3 relative, parameters within {bound:g} and "
                    f"99.9 % within 1e-5 ({far} of {total} beyond)")
        print(f"phase 6: smoke {optimizer}: card vs CPU losses rel "
              f"{loss_rel:.2e}, parameters max |diff| {worst:.2e} "
              f"(gate: {gate})")
        if not ok:
            raise AssertionError(f"smoke training ({optimizer}): card and "
                                 "CPU disagree")


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


def phase_full(scratch: Path, card: str) -> tuple[dict, dict]:
    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.kernels import diffusion_mix as dm
    from repro_torch.kernels import flash_attention as fa
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
    fa.flash_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    first = serve.main(argv + ["--mix", "pallas"])
    launches = {"diffusion_mix": dm.diffusion_mix.launches,
                "flash_attention": fa.flash_attention.launches}
    if launches["diffusion_mix"] < 1:
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
          f"tokens repeat; launches on the serving path {launches}")
    return launches, serve_row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_info()
    scratch = ROOT / ".repro_torch_build" / "chip_smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    built = build.build_all()
    print(f"built every kernel source, one nvcc each in parallel, in "
          f"{time.perf_counter() - t_start:.1f}s: "
          + ", ".join(f"{n} {s:.1f}s" for n, s in built.items()))
    try:
        mix_row = phase_kernel(card)
        phase_small(scratch)
        serve_launches, _ = phase_full(scratch, card)
        attn_row = phase_attention(card)
        train_launches, _ = phase_train(card)
        phase_train_devices()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    # each row's numbers are at the training path's shape; diffusion_mix's
    # "by_path" also gives the serving path's shape and times
    for row in (mix_row, attn_row):
        row["launches"] = train_launches[row["name"]]
        row["launches_by_path"] = {
            "serve": serve_launches[row["name"]],
            "train": train_launches[row["name"]]}
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f}s [{card}]")
    print(json.dumps({"kernels": [mix_row, attn_row], "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
