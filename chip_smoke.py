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
   the kernel, the plain version and ``A_eff.T @ W`` are timed; and
   mamba2-2.7b's training shape, K=2 with M past 2^31, full and partial
   mask, held against the plain version in column slices; the kernel is
   timed on the whole buffer, the plain version and ``A_eff.T @ W`` over
   contiguous slices of 2^28 elements.
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
   Skv = 333 with a window for each D in bf16, q past 2^31 elements,
   zamba2-1.2b's full-width shape (1, 1024, 32, 32, 64) in bf16, and the
   full-width training shape in f32 and bf16.  Tolerances: the
   reference's, 2e-5 (f32) and 2e-2 (bf16); every bf16 case (the
   tensor-core route) also within 2^-7 P|V| + one bf16 ulp of its rounding
   model ``attention_bf16p_ref``.  The ``ptxas`` lines of both routes and
   the count of HGMMA instructions in the built library (none fails).  At
   the training and zamba2 shapes in bf16 the kernel and
   ``scaled_dot_product_attention`` are timed by their device time
   (``torch.profiler``) and by CUDA events around a loop of calls (the
   wrapper's host time, where the host is slower), the plain version by
   CUDA events.
5. Train, full width: Algorithm 1 on smollm-360m through
   ``repro_torch.launch.train.main`` (K=4, T=2, B=2, S=1024, 3 blocks,
   Adam, ``--mix pallas``, ``use_kernels=True``); both kernels' launch
   counts, finite losses and parameters, the per-block split into local
   updates and combination, tokens/s and peak memory; then one local
   step's loss and gradients, kernel path against plain path.
6. Train, small: smoke training with SGD and with Adam on the card and on
   the CPU from one seed; the realized masks are equal and the losses and
   parameters agree within the stated gates.
7. ``ssd_intra_chunk`` against its plain version ``ssd_intra_chunk_ref``
   (Y_diag, states, dA_cumsum; max |kernel - plain| <= 2e-4 max(1,
   |plain|)) and ``ssd_op`` end to end against the sequential ``ssd_ref``
   at the reference's gates (2e-3 float32, 5e-2 bf16): the reference's
   sweep in float32 and bf16, an initial state, and the paths' own shapes
   (mamba2-2.7b: h = 80, p = 64, n = 128; zamba2-1.2b: h = 64, n = 64;
   s = 1024, chunk 128, B/C bf16 slices of xBC), where the kernel and the
   plain version are timed.
8. Train mamba2-2.7b at full width: Algorithm 1 through
   ``repro_torch.launch.train.main`` (64 layers, K=2, T=2, B=1, S=1024,
   3 blocks, SGD, ``--mix pallas``, ``use_kernels=True``); the launch
   counts, finite losses and parameters, block times, peak memory, a
   profiled block, and one local step's loss and gradients with the SSD
   kernel against the plain SSD, held against two witnesses: two plain
   forwards that differ only in float32 summation order (bf16), and the
   same step with float32 parameters.
9. The SSM paths on the card against the CPU: mamba2- and zamba2-smoke
   training with SGD and with Adam (phase 6's gates), smoke prefill and
   greedy decode of both (the same tokens), and one full-width
   zamba2-1.2b forward (B=1, S=1024) with the kernels on and off, the one
   path where ``flash_attention`` and ``ssd_intra_chunk`` run together.
10. ``gather_robust_mix`` and ``gather_mix`` against their plain versions
    ``gather_robust_mix_ref`` and ``gather_mix_ref``: K in {8, 12, 16,
    20, 1024}, D in {3, 5, 8, 12, 20} (ring, ring hops 2, grid, FedAvg;
    FedAvg at K=20 takes the kernels' one-target route, every other table
    the group route, and both must be covered), odd M, all-active,
    all-inactive and random masks, realized link drops on the base
    support (numpy), trimmed-mean and median slot weights; one
    K*M > 2^31 case; and each path's shapes (training: K=12 ring, D=3;
    serving: K=8 FedAvg, D=8): the column tile the mixers launch on
    (12 x 22,369,621 and 8 x 33,554,432) and the whole of smollm-360m's
    M, the kernel timed by a CUDA-event loop after two warm-up calls with
    the plan computed once as the mixers do, the plain versions and
    ``A_eff.T @ W`` in column slices, each beside its
    byte and operations bounds (the robust kernel's operations: one sort
    per distinct member set, min/max at half the float32 issue rate), its
    route, launch shape and achieved bytes/s; the ``ptxas`` summary.
    Tolerance: max |kernel - plain| <= 1e-5 * max(1, |plain|); inactive
    rows bit-equal.
11. Train smollm-360m at full width through ``train.main`` at K=12 (ring,
    T=2, q=0.9, B=1, S=1024, SGD mu=0.05, ``use_kernels=True``): (a) the
    reference's Byzantine preset (3 sign-flip adversaries of scale 3,
    per-neighborhood trimmed mean, ``--robust-gather fused``), 3 blocks,
    a profiled block, then one more combination of the trained stack with
    the kernel and with the plain gather table, within one bf16 ulp and
    inactive agents bit-equal; (b) ``--mix gather``, 2 blocks, then one
    combination against the dense mixer within one bf16 ulp; (c) the
    preset at smoke size on the card and on the CPU (phase 6's gates).
12. Robust and gather consensus at full width: phase 3's K=8 stack through
    ``serve.main`` with the neighborhood trimmed mean (kernel), the global
    median (plain) and the gather mixer (kernel), each within one bf16 ulp
    of a plain consensus, then prefill and 32 greedy decode steps.
13. ``diffusion_mix_int8`` against its plain version ``mix_int8_ref``:
    K in {4, 8, 12, 64, 240}, tile_m in {128, 512}, ``subtract_identity``
    on and off, all-zero, all-one and random masks.  Operands from the
    path's own quantizer (an all-zero tile, +-127, zero padding) take
    phase 1's tolerance; uniform int8 values times uniform scales up to 1,
    whose terms reach 127, are held against the float64 value within the
    float32 summation bound (``mix_int8_exact``), with cuBLAS's error
    beside the kernel's.  K in {1, 2, 3, 5, 9, 16, 17} at the edges of
    the kernel's routes; ``Wq`` at storage offsets 1, 2, 3 (the scalar
    route) and 8, bit-equal to the aligned ``Wq``; every route covered.
    One K*M > 2^31 case; and the training path's shape (K=8 FedAvg,
    smollm's M padded to the 512-column tile, one column tile at a time
    with its scales), where the kernel (rows route) and the same values
    at a 1-byte storage offset (the scalar route, the earlier one column
    a thread) are timed in turns by CUDA-event loops after two warm-up
    calls, per full tile (the launch the path makes) and per combination,
    beside the byte bound, GB/s and clocks, with the plain version and
    the composition (dequantize, then ``(A_eff - I).T @ C``); and K=64
    and 240 (M = 2^22, operations-bound), passes route against scalar
    route (no slower).  The ``ptxas`` summary (no spill) and the SASS memory
    instructions (a 16-byte evict-first store required).
14. Train smollm-360m at full width through ``train.main`` at K=8 (q=0.9,
    B=1, S=1024, SGD mu=0.05, ``--mix pallas``, ``use_kernels=True``):
    (a) the reference's compressed_fedavg preset (FedAvg, int8, error
    feedback, T=2), 3 blocks through ``diffusion_mix_int8``, a profiled
    block, then one more combination of the trained stack: the kernel's
    delta against the plain version's from the same uniforms within one
    bf16 ulp plus the summation bound and the messages bit-equal, one
    more under ``torch.profiler`` whose device time is printed by stage
    (the ``record_function`` ranges of ``core/mixing.py``: rounding
    draws, quantizer, int8 cast, kernel, messages, flatten copies, writes
    into leaves; a report), inactive agents' parameters and residual
    bit-equal, every active residual within 2 quantization steps of its
    (agent, tile); (b) the
    compressed_diffusion preset (ring, top-k 0.1, CHOCO's diff mode,
    gamma 0.5, T=1), 2 blocks through ``diffusion_mix``, then one more
    combination: the reference copy moves for active agents only, and
    the top-k selection of every leaf timed, the tie rule's mask against
    ``torch.topk`` alone; (c) both presets at smoke size, card against CPU
    block by block from the same state with the same injected draws:
    phase 6's gates, with every int8 rounding or top-k selection that
    lands differently at its threshold recorded (top-k: only in rows whose
    inputs differ, and the card's selection on the CPU's input is the
    CPU's), and the entries beyond them only where a flip reaches.
15. Int8 consensus: phase 3's K=8 stack through ``serve.main`` with
    ``--consensus-quantize int8 --mix pallas``: relative squared error
    against the stored stack's consensus below the reference's 1e-3, two
    runs bit-equal, prefill and 32 greedy steps.
16. Time-varying graphs and stateful availability: smollm-360m at full
    width through ``train.main`` (K=8 ring, T=2, q=0.9, B=1, S=1024, SGD
    mu=0.05, 2 blocks, ``use_kernels=True``): (a) ``--mix pallas --graph
    link_dropout --link-drop 0.3 --participation-process markov
    --markov-corr 0.5``: exact launch counts (``diffusion_mix`` one per
    tile a block, ``flash_attention`` by phase 11b's formula, the others
    0), every realized A_t symmetric, doubly stochastic and on the ring's
    support, a profiled block (the device's busy share), then one
    combination of the trained stack under a realized
    A_t with a dropped link, kernel against the dense mixer within phase
    11b's gate and inactive agents bit-equal; (b) ``--graph tv_erdos
    --graph-p 0.3 --mix auto --participation-process cyclic --num-groups
    2``: ``auto`` takes the kernel mixer (the same counts), the masks
    alternate the two groups; (c) at smoke size (K=6), card against CPU
    from one host generator (phase 6's SGD gates, the realized masks and
    matrices equal): link dropout with corr 0 and 0.6 and gossip under
    ``pallas``, ``sparse``, ``gather`` and the neighbourhood trimmed mean
    (fused kernel), tv_erdos under ``pallas``, with the i.i.d., Markov and
    cyclic processes in turn.
17. The paper's §VII regression at its published size (K=20, N=100, M=2,
    mu=0.01, rho=0.1, T=5, erdos, ``--mix pallas``: one ``diffusion_mix``
    launch a block) through the engine: (a) 100 blocks, card against CPU
    under the same host draws, within 1e-5 (1 + |w|) per entry; (b) Fig. 5:
    q ~ U(0.2, 0.95), 3 runs x 4,000 blocks, the steady MSD over the last
    1,000 within 20 % of the port's Theorem 5 (300 mask samples); (c) Fig.
    6: the steady MSD falls as q rises through 0.1, 0.5, 0.9 (T=1, 3 x
    2,500 blocks); (d) Theorem 5 over link dropout's matrix law (K=6 ring,
    drop 0.3, 3 x 2,500 blocks): the simulation within 15 % of it and
    closer than the static law.  Microseconds a block and the sim/theory
    ratios are printed, and 200 more Fig. 5 blocks are profiled (the
    device's busy share).
18. The privacy tier and the partitioned data: smollm-360m at full width
    through ``train.main`` (K=8 ring, T=2, q=0.9, B=1, S=1024, SGD
    mu=0.05, ``use_kernels=True``): (a) ``--mix pallas --privacy
    --privacy-epsilon 8 --privacy-delta 1e-5 --privacy-clip 1.0 --data
    dirichlet --data-alpha 0.3 --data-clusters 4``, 3 blocks unless the
    budget halt stops the run: exact launch counts for the blocks run,
    finite losses and parameters, the logged epsilon equal to the numpy
    accountant over the realized masks and never falling, the halt fired
    iff a block was projected past the budget, every block's tokens
    bit-equal to a CPU iterator's and inside each agent's partition, then
    one local step's gradients clipped at noise 0 (each agent's norm
    within clip (1 + 1e-5) before the bf16 rounding, (1 + 2^-8) after);
    (b) ``--privacy --privacy-epsilon 8 --privacy-secure-agg --data shards
    --data-shards 2``, 2 blocks: ``diffusion_mix`` not launched (the wire
    masks carry the combination), then one masked combination of the
    trained stack under the block's mask and under a partial one against
    the kernel mixer: within one bf16 ulp plus the summation bound, 5e-5
    on a float32 widening, inactive agents bit-equal, with its seconds,
    memory and mask tiles; (c) at smoke size, card against CPU: private
    training at noise 0 with and without the masks on the static ring and
    under link dropout 0.3 (phase 6's SGD gates), masked against unmasked
    within 5e-5 on each device, and the Dirichlet and shards blocks
    bit-equal; (d) the DP §VII regression (K=8, M=2, q=0.8, ring, T=2,
    mu=0.01, 2,000 blocks, ``--mix pallas``): masked against unmasked
    within 5e-5 on the static ring and under link dropout, the steady MSD
    falls as epsilon rises through 2, 8, 32 and stays above half the
    non-private floor, the realized epsilon within 0.7-1.3 of each target,
    the MSD at epsilon 32 within 0.25-4 of Theorem 5 with the injected DP
    variance; microseconds a block and 200 profiled blocks (the device's
    busy share).

The kernel mixers run over a column-tiled flatten, one launch per tile
(``repro_torch.core.mixing.num_tiles``): phases 3, 5, 8, 11, 12, 14, 15,
16 and 18 count tiles.  Each path's launch counts (all six kernels) are
set to 0 just before its first run and read just after it (phases 3, 5, 8,
9, 11, 12, 14, 15, 16, 17 and 18).  The last lines are a JSON object of the kernels' numbers, the card's name and power limit (``nvidia-smi``), and
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
# float32 instructions per second (an FMA counts 2 of FP32_FLOPS_PER_S), and
# min/max at half that rate (64 a clock per SM against 128: the CUDA
# programming guide's throughput table, compute capability 9.0)
FP32_ISSUE_PER_S = FP32_FLOPS_PER_S / 2
MINMAX_ISSUE_PER_S = FP32_ISSUE_PER_S / 2
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
TF32_FLOPS_PER_S = 495e12        # H100 SXM, TF32 tensor cores, dense
# the reference's SSD gates (tests/test_kernels.py), atol = rtol
SSD_TOL = {"float32": 2e-3, "bfloat16": 5e-2}
# the intra-chunk kernel against its plain version: at mamba2's shape each
# Y_diag entry gathers Q N = 16,384 products of terms up to about 10; the
# float32-FMA kernel this one replaced summed the same products in another
# order and on an H100 (80 GB HBM3, 700 W) was at most 7.3e-5 from the
# plain version (relative to max(1, |plain|)), so the gate is 2e-4.  The
# tensor-core kernel splits each product into three TF32 ones (missing
# only lo*lo, 2^-22); against a float64 reference it is as far off as the
# FMA kernel was
INTRA_TOL = 2e-4
# (b, s, h, p, n, chunk) of one mamba layer's SSD on each path
SSD_PATH_SHAPES = {"mamba2-2.7b": (1, 1024, 80, 64, 128, 128),
                   "zamba2-1.2b": (1, 1024, 64, 64, 64, 128)}
# one full-width mamba2 local step, SSD kernel vs plain SSD, and the
# full-width zamba2 forward, kernels on vs off: the loss within phase 5's
# 2e-3 relative
SSM_LOSS_TOL = 2e-3
# the step's gradients, worst leaf in relative Frobenius norm, are held
# against two witnesses taken in the same run.  In bf16 they may be at most
# SSM_GRAD_WITNESS_RATIO times the distance between two plain forwards that
# differ only in float32 summation order (plain SSD at chunk 128 against
# plain SSD at chunk 64): the noise floor of bf16 rounding carried through
# 64 layers.  With float32 parameters, where rounding is 2^16 times finer,
# every layer of every leaf within SSM_GRAD_TOL_F32 and the loss within
# SSM_LOSS_TOL_F32: a kernel fault of any size that shows in bf16 shows
# there far above rounding.  On an H100 (80 GB HBM3, 700 W) the kernel's
# worst bf16 leaf read 4.86e-2 against the witness's 4.89e-2, the float32
# worst layer 4.6e-5 and the float32 loss 8.6e-8.
SSM_GRAD_WITNESS_RATIO = 2.0
# the Byzantine preset (the reference's byzantine_robust_diffusion): K = 12
# ring, 3 evenly spaced sign-flip adversaries of scale 3, per-neighborhood
# trimmed mean with trim 1
BYZANTINE_FLAGS = ["--mix", "trimmed_mean", "--trim", "1", "--robust-scope",
                   "neighborhood", "--attack", "sign_flip", "--attack-num",
                   "3", "--attack-scale", "3.0"]
SSM_GRAD_TOL_F32 = 1e-3
SSM_LOSS_TOL_F32 = 1e-5


#: the stages of one fused int8 combination, by the record_function
#: ranges that core/mixing.py marks them with
INT8_STAGES = (("rounding draws", "mix_int8.draw"),
               ("quantizer passes", "mix_int8.quantize"),
               ("int8 cast, scale copy", "mix_int8.cast"),
               ("diffusion_mix_int8", "mix_int8.kernel"),
               ("messages (q * scale)", "mix_int8.messages"),
               ("tiled flatten copies", "tiled.gather"),
               ("writes into leaves", "tiled.scatter"))
RANGE_NAMES = {r for _, r in INT8_STAGES}


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def card_clocks() -> str:
    """The card's SM and memory clocks, temperature and power draw now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
         "power.draw", "--format=csv,noheader"],
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


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``: the summed durations of the kernels
    it launches, from ``torch.profiler``'s raw device events over
    ``iters`` calls after a warm-up.  Where the host takes longer per call
    than the device, :func:`time_ms` measures the host; this does not."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ns = sum(n for _, n in device_events(prof))
    if not ns:
        raise AssertionError("the profiler saw no device time")
    return ns / 1e6 / iters


def device_events(prof):
    """(name, nanoseconds) of each device activity in a ``torch.profiler``
    trace (kernels, copies, sets), without the device-side spans of
    ``record_function`` ranges, which repeat their kernels' time."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        annotation = getattr(e, "is_user_annotation", None)
        if annotation is not None and annotation():
            continue
        if annotation is None and e.name() in RANGE_NAMES:
            continue
        yield e.name(), e.duration_ns()


def sass_count(name: str, opcode: str) -> int:
    """How many instructions whose opcode starts with ``opcode``
    ``cuobjdump -sass`` finds in the library built for
    ``csrc/<name>.cu``."""
    return sum(sass_opcodes(name, (opcode,)).values())


def sass_opcodes(name: str, prefixes=("LDG", "STG", "LDS")) -> dict:
    """How many instructions of each opcode starting with one of
    ``prefixes`` (``STG.E.EF.128``, say) ``cuobjdump -sass`` finds in the
    library built for ``csrc/<name>.cu``."""
    import re
    from collections import Counter

    from repro_torch.kernels import build

    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build._lib_path(name))], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    ops = Counter()
    for line in sass.splitlines():
        m = re.search(r"\*/\s*(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)",
                      line)
        if m and m.group(1).startswith(tuple(prefixes)):
            ops[m.group(1)] += 1
    return dict(sorted(ops.items()))


def rel_err(out, ref) -> float:
    """max |out - ref| / max(1, |ref|), elementwise."""
    return ((out.float() - ref.float()).abs()
            / ref.float().abs().clamp(min=1.0)).max().item()


def ptxas_lines(name: str) -> list[str]:
    """``nvcc -Xptxas=-v``'s per-kernel lines: the function, its registers
    and its spills."""
    from repro_torch.kernels import build

    keep = ("Compiling entry function", "Used", "spill")
    return [line.strip() for line in build.build_log(name).splitlines()
            if any(k in line for k in keep)]


def num_tiles(K: int, M: int, int8: bool = False) -> int:
    """Launches of one tiled combination of a (K, M) stack (with ``int8``,
    of the fused int8 path)."""
    from repro_torch.core.mixing import num_tiles as tiles

    return tiles(K, M, int8)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0


def read_launches() -> dict:
    """Every kernel's launch count."""
    return {name: w.launches for name, w in kernel_wrappers().items()}


def kernel_wrappers() -> dict:
    from repro_torch.kernels import diffusion_mix as dm
    from repro_torch.kernels import diffusion_mix_int8 as dmi
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gather_mix as gm
    from repro_torch.kernels import gather_robust_mix as grm
    from repro_torch.kernels import ssd_scan

    return {"diffusion_mix": dm.diffusion_mix,
            "flash_attention": fa.flash_attention,
            "ssd_intra_chunk": ssd_scan.ssd_intra_chunk,
            "gather_mix": gm.gather_mix,
            "gather_robust_mix": grm.gather_robust_mix,
            "diffusion_mix_int8": dmi.diffusion_mix_int8}


def full_width_M(arch: str = "smollm-360m") -> int:
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch).model
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

    # mamba2-2.7b's training path: K=2 agents on a ring, M past 2^31, so the
    # column index itself leaves the int32 range.  The plain version's full
    # (K, M) result does not fit beside W and the kernel's, so it is held
    # against the kernel in column slices that cover every column.  With
    # K=2 a partial mask leaves A_eff = I (out = W exactly) and the full
    # mask mixes; both are checked.
    K, M = 2, full_width_M("mamba2-2.7b")
    A = torch.as_tensor(make_topology("ring", K).A, dtype=torch.float32,
                        device=dev)
    W = torch.randn((K, M), generator=gen, device=dev)
    tile = 1 << 28
    mamba = {"shape": [K, M], "slices_of_columns": tile}
    for mask_np in (np.ones(K), np.array([1.0, 0.0])):
        m = torch.as_tensor(mask_np, dtype=torch.float32, device=dev)
        out = dm.diffusion_mix(A, m, W)
        err = max_abs = 0.0
        for a in range(0, M, tile):
            # contiguous: cuBLAS takes no row stride past 2^31
            ref = mix_ref(A, m, W[:, a:a + tile].contiguous())
            err = max(err, rel_err(out[:, a:a + tile], ref))
            max_abs = max(max_abs,
                          (out[:, a:a + tile] - ref).abs().max().item())
            del ref
        del out
        label = f"mask={[int(x) for x in mask_np]}"
        if not err <= TOL:
            raise AssertionError(f"diffusion_mix at mamba2's shape K={K} "
                                 f"M={M} {label}: rel err {err:.3e} > {TOL}")
        mamba[label] = {"rel_err": err, "max_abs_err": max_abs}
    m = torch.ones(K, device=dev)
    mamba["ms"] = time_ms(lambda: dm.diffusion_mix(A, m, W), iters=3)
    nbytes = 4 * (K * K + K + 2 * K * M)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = 2 * K * K * M / FP32_FLOPS_PER_S * 1e3
    mamba.update(bound_ms=max(bound_bytes, bound_ops),
                 bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                 bytes=nbytes)
    # the plain version and A_eff.T @ W cannot take the whole buffer (cuBLAS
    # refuses a row stride past 2^31), so both are timed over contiguous
    # column slices of 2^28 elements, the mixers' tile size, summed
    width = (1 << 28) // K
    slices = [W[:, a:a + width].contiguous() for a in range(0, M, width)]
    del W
    A_eff = masked_combination(A, m)

    def over_slices(f):
        def run():
            for w in slices:
                f(w)
        return run

    mamba.update(
        plain_ms=time_ms(over_slices(lambda w: mix_ref(A, m, w)), iters=1),
        library_ms=time_ms(over_slices(lambda w: A_eff.T @ w), iters=1),
        column_slices=width)
    del slices
    torch.cuda.empty_cache()
    print(f"phase 1: mamba2 training shape K={K} M={M} (> 2^31 columns), "
          f"ring: every column within {TOL} of the plain version in slices of "
          f"{tile} columns: "
          + "; ".join(f"{k} rel err {v['rel_err']:.3e}"
                      for k, v in mamba.items() if k.startswith("mask"))
          + f"; kernel {mamba['ms']:.3f} ms on the whole buffer, plain "
          f"{mamba['plain_ms']:.3f} ms and A_eff.T @ W "
          f"{mamba['library_ms']:.3f} ms over contiguous slices of {width} "
          f"columns, bound {mamba['bound_ms']:.3f} ms ({mamba['bound_by']}) "
          f"[{card}]")
    by_path["train_mamba2"] = mamba
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
    route = ""
    for line in ptxas:
        if "Compiling entry function" in line:
            route = ("bf16 route (wgmma)" if "hopper" in line
                     else "float32 route (FMA)")
        print(f"  ptxas [{route}]:", line)
    hgmma = sass_count("flash_attention", "HGMMA")
    print(f"phase 4: {hgmma} HGMMA instructions in the built library "
          "(cuobjdump -sass)")
    if not hgmma:
        raise AssertionError("flash_attention's bf16 route has no HGMMA "
                             "instruction: it does not run on the tensor "
                             "cores")
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
    # zamba2-1.2b's shared attention at full width (phase 9's forward)
    cases += [(1, 1024, 1024, 32, 32, 64, bf16, True, None)]
    # Skv ragged against the 64-key tile, with a window, for every D
    cases += [(1, 333, 333, 3, 1, D, bf16, True, 50) for D in (32, 64, 128)]
    worst = {f32: 0.0, bf16: 0.0}
    worst_model = 0.0
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
        if dt == bf16:
            worst_model = max(worst_model, _bf16p_share(
                out, q, k, v, causal=causal, window=window,
                label=f"{(B, Sq, Skv, H, Kv, D)} window={window}"))
    print(f"phase 4: {len(cases)} cases within the reference's gates "
          f"{ATTN_TOL}: worst max |err| f32 {worst[f32]:.3e}, bf16 "
          f"{worst[bf16]:.3e}; every bf16 case within the rounding budget "
          f"of attention_bf16p_ref (2^-7 P|V| + 1 bf16 ulp), at "
          f"{worst_model:.3f} of it at worst")

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
    share = _bf16p_share(out[-4:], q[-4:], k[-4:], v[-4:],
                         label="past 2^31 elements")
    print(f"phase 4: q of {q.numel():,} elements (> 2^31): last batch "
          f"entries max |err| {big:.3e}, {share:.3f} of the bf16 rounding "
          f"budget")
    del q, k, v, out, ref
    torch.cuda.empty_cache()

    # the training shape: one layer's attention at full smollm-360m width
    B, S, H, Kv, D = TRAIN_ATTN_SHAPE
    q, k, v = _attention_inputs(gen, B, S, S, H, Kv, D, bf16)
    out = fa.flash_attention(q, k, v)
    ref = attention_ref(q, k, v)
    max_abs = (out.float() - ref.float()).abs().max().item()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def kernel():
        return fa.flash_attention(q, k, v)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    # the kernel's device time (profiler) and the loop time (CUDA events
    # around 20 calls, which at a few tens of microseconds is the wrapper's
    # host time), SDPA's the same two ways
    ms, library_ms = device_ms(kernel), device_ms(sdpa)
    loop_ms = time_ms(kernel, iters=20)
    plain_ms = time_ms(lambda: attention_ref(q, k, v), iters=20)
    library_loop_ms = time_ms(sdpa, iters=20)
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
           "library_ms": library_ms, "loop_ms": loop_ms,
           "library_loop_ms": library_loop_ms, "fp32_fma_bound_ms": fma_ms,
           "bytes": nbytes, "flops": flops, "shape": [B, S, H, Kv, D],
           "dtype": "bfloat16", "hgmma": hgmma,
           "bf16p_budget_share": worst_model, "ptxas": ptxas}
    print(f"phase 4: {TRAIN_ATTN_SHAPE} bf16 causal: kernel device "
          f"{ms:.4f} ms (profiler; loop {loop_ms:.4f} ms), SDPA device "
          f"{library_ms:.4f} ms (loop {library_loop_ms:.4f} ms), plain "
          f"{plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {flops:.3e} operations at the bf16 rate "
          f"{BF16_FLOPS_PER_S:.3g}/s, {nbytes:,} bytes at "
          f"{HBM_BYTES_PER_S:.3g} B/s; the kernel at "
          f"{100 * row['bound_ms'] / ms:.1f} % of it); the same operations "
          f"as float32 FMAs {fma_ms:.4f} ms [{card}]")
    del q, k, v, qt, kt, vt, out, ref
    torch.cuda.empty_cache()

    # zamba2-1.2b's shared attention (1, 1024, 32, 32, 64), timed alike
    q, k, v = _attention_inputs(gen, 1, 1024, 1024, 32, 32, 64, bf16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    z_ms = device_ms(lambda: fa.flash_attention(q, k, v))
    z_lib = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    z_loop = time_ms(lambda: fa.flash_attention(q, k, v), iters=20)
    row["zamba2"] = {"shape": [1, 1024, 32, 32, 64], "ms": z_ms,
                     "library_ms": z_lib, "loop_ms": z_loop}
    print(f"phase 4: zamba2 (1, 1024, 32, 32, 64) bf16 causal: kernel "
          f"device {z_ms:.4f} ms (loop {z_loop:.4f} ms), SDPA device "
          f"{z_lib:.4f} ms [{card}]")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def _bf16p_share(out, q, k, v, *, causal=True, window=None,
                 label="") -> float:
    """The bf16 kernel's largest distance from its rounding model
    ``attention_bf16p_ref`` as a share of ``attention_bf16p_budget``
    (2^-7 P|V| + one bf16 ulp: one p_j rounded to the neighbouring bf16
    value, and the final rounding); raises above 1."""
    from repro_torch.kernels.ref import (attention_bf16p_budget,
                                         attention_bf16p_ref)

    model = attention_bf16p_ref(q, k, v, causal=causal, window=window)
    budget = attention_bf16p_budget(q, k, v, model, causal=causal,
                                    window=window)
    share = ((out.float() - model.float()).abs()
             / budget.clamp(min=1e-30)).max().item()
    if not share <= 1.0:
        raise AssertionError(f"flash_attention {label}: {share:.3f} of the "
                             "bf16 rounding budget around "
                             "attention_bf16p_ref")
    return share


def _grads_one_step(params, cfg, batch, *, remat: bool = False):
    """Loss and gradients of one agent's local step."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves, tree_unflatten

    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    loss = tf.train_loss(tree_unflatten(params, leaves), cfg, batch,
                         remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), grads


def _profile_block(state, cfg, K, T, B, S, steady_s: float, card: str, *,
                   optimizer: str = "adam", mu: float = 1e-4,
                   label: str = "phase 5", mix: str = "pallas",
                   grad_transform=None, engine_kwargs=None,
                   config_kwargs=None) -> dict:
    """One more block from ``state`` under ``torch.profiler``: the device
    time of its kernels (device events only: an operator's row repeats the
    time of the kernels it launched), their share of the steady unprofiled
    block ``steady_s``, and the kernels that take the most device time.
    The device events are summed from the trace's raw events by name:
    ``key_averages()`` builds every host event too and took minutes at a
    few hundred thousand launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.diffusion import DiffusionConfig, DiffusionEngine
    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adam
    from repro_torch.tree import tree_map

    if grad_transform is None and optimizer == "adam":
        grad_transform = adam().update
    eng = DiffusionEngine(
        DiffusionConfig(num_agents=K, local_steps=T, step_size=mu,
                        participation=0.9, mix=mix, **(config_kwargs or {})),
        lambda p, b: tf.train_loss(p, cfg, b, remat=False),
        grad_transform, device="cuda", **(engine_kwargs or {}))
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
    by_name: dict = {}
    for name, ns in device_events(prof):
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + ns / 1e6, n + 1)
    kernels = [(name, ms, n) for name, (ms, n) in by_name.items()]
    busy_ms = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda r: -r[1])[:8]
    out = {"profiled_wall_s": wall, "steady_block_s": steady_s,
           "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / 1e3 / steady_s if busy_ms else None,
           "device_launches": sum(n for _, _, n in kernels),
           "top_kernels": [{"name": n[:100], "ms": ms, "count": c}
                           for n, ms, c in top]}
    if not busy_ms:
        print(f"{label}: the trace holds no device time: busy share not "
              "measured")
    else:
        print(f"{label}: profiled block: kernels busy {busy_ms:.1f} ms = "
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
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves, tree_map

    K, T, B, S, blocks = 4, 2, 2, 1024, 3
    argv = ["--full", "--agents", str(K), "--local-steps", str(T),
            "--batch", str(B), "--seq", str(S), "--blocks", str(blocks),
            "--mix", "pallas", "--optimizer", "adam", "--step-size", "1e-4"]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = train.main(argv, use_kernels=True)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = out["cfg"]
    # one launch per layer per agent per local step, plus the logging
    # forward of every agent after each block
    want = cfg.num_layers * K * (T * blocks + len(out["losses"]))
    if launches["flash_attention"] != want:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']}x on the training "
                             f"path, expected {want}")
    tiles = num_tiles(K, full_width_M())
    if launches["diffusion_mix"] != tiles * blocks:
        raise AssertionError(f"diffusion_mix launched "
                             f"{launches['diffusion_mix']}x in {blocks} blocks, "
                             f"expected {tiles} tiles each")
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


def phase_train_devices(arch: str = "smollm-360m",
                        label: str = "phase 6", agents: int = 4,
                        mix: tuple = ("--mix", "pallas"),
                        optimizers=(("sgd", 0.05), ("adam", 1e-3))) -> None:
    """Phase 6 (and 9, and the Byzantine preset's check): smoke training
    on the card and on the CPU, same seed."""
    import numpy as np
    import torch

    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    base = ["--arch", arch, "--agents", str(agents), "--local-steps", "2",
            "--blocks", "3", *mix, "--batch", "2", "--seq", "64"]
    for optimizer, mu in optimizers:
        argv = base + ["--optimizer", optimizer, "--step-size", str(mu)]
        gpu = train.main(argv, use_kernels=True)
        cpu = train.main(argv + ["--device", "cpu"], use_kernels=True)
        # every draw comes from one host generator: the same masks and
        # the same realized combination matrices
        if gpu["active"] != cpu["active"]:
            raise AssertionError("card and CPU realized different masks")
        if not all(torch.equal(a, b)
                   for a, b in zip(gpu["graphs"], cpu["graphs"])):
            raise AssertionError("card and CPU realized different graphs")
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
        print(f"{label}: {arch} smoke K={agents} {' '.join(mix)} "
              f"{optimizer}: card vs CPU losses rel "
              f"{loss_rel:.2e}, parameters max |diff| {worst:.2e} "
              f"(gate: {gate})")
        if not ok:
            raise AssertionError(f"{arch} smoke training ({optimizer}): "
                                 "card and CPU disagree")


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


def phase_full(scratch: Path, card: str) -> tuple[dict, dict, str]:
    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
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

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    first = serve.main(argv + ["--mix", "pallas"])
    launches = read_launches()
    # one combination of the (K, M) stack: one launch per column tile
    tiles = num_tiles(K, full_width_M())
    if launches["diffusion_mix"] != tiles:
        raise AssertionError(f"the serving path launched diffusion_mix "
                             f"{launches['diffusion_mix']}x, expected one "
                             f"launch per tile, {tiles}")
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
    return launches, serve_row, path


def _ssd_inputs(gen, b, s, h, p, n, dtype, conv_dim=None):
    """SSD inputs as the mixer makes them: x and B, C in ``dtype`` (with
    ``conv_dim``, B and C are strided slices of one xBC row), dt > 0 and
    A < 0 in float32."""
    import torch

    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device="cuda")) * 0.5
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda") * 0.3)
    if conv_dim is None:
        B = torch.randn((b, s, n), generator=gen, device="cuda").to(dtype)
        C = torch.randn((b, s, n), generator=gen, device="cuda").to(dtype)
    else:
        xBC = torch.randn((b, s, conv_dim), generator=gen,
                          device="cuda").to(dtype)
        B = xBC[..., conv_dim - 2 * n:conv_dim - n]
        C = xBC[..., conv_dim - n:]
    return x, dt, A, B, C


def _check_intra(x, dt, A, B, C, chunk, label) -> float:
    """The intra-chunk kernel against its plain version on s padded to the
    chunk; returns the largest |kernel - plain| of the three outputs."""
    import torch.nn.functional as F

    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ref import ssd_intra_chunk_ref

    pad = (-x.shape[1]) % chunk
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
    xd = x.float() * dt[..., None]
    dA = dt * A
    outs = ssd_scan.ssd_intra_chunk(xd, dA, B, C, chunk=chunk)
    refs = ssd_intra_chunk_ref(xd, dA, B, C, chunk=chunk)
    worst = 0.0
    for name, out, ref in zip(("Y_diag", "states", "dA_cumsum"), outs, refs):
        err = rel_err(out, ref)
        if not err <= INTRA_TOL:
            raise AssertionError(f"ssd_intra_chunk {label}: {name} rel err "
                                 f"{err:.3e} > {INTRA_TOL}")
        worst = max(worst, (out - ref).abs().max().item())
    return worst


def _check_ssd_op(x, dt, A, B, C, chunk, label, init=None) -> float:
    """``ssd_op`` against the sequential ``ssd_ref`` at the reference's
    gate for x's dtype; returns max |y - y_ref|."""
    from repro_torch.kernels.ops import ssd_op
    from repro_torch.kernels.ref import ssd_ref

    y, fin = ssd_op(x, dt, A, B, C, chunk=chunk, initial_state=init)
    yr, finr = ssd_ref(x, dt, A, B, C, initial_state=init)
    tol = SSD_TOL[str(x.dtype).removeprefix("torch.")]
    for name, a, b in (("y", y, yr), ("final state", fin, finr)):
        a, b = a.float(), b.float()
        if not bool(((a - b).abs() <= tol * (1 + b.abs())).all()):
            raise AssertionError(f"ssd_op {label}: {name} max |err| "
                                 f"{(a - b).abs().max().item():.3e} beyond "
                                 f"{tol}")
    return (y.float() - yr.float()).abs().max().item()


def phase_ssd(card: str) -> dict:
    """Phase 7: the SSD intra-chunk kernel against its plain version, and
    ``ssd_op`` against ``ssd_ref``."""
    import torch

    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ref import ssd_intra_chunk_ref
    from repro_torch.models.ssm import inter_chunk

    ssd_scan.build()
    ptxas = ptxas_lines("ssd_scan")
    for line in ptxas:
        print("  ptxas:", line)
    hgmma = sass_count("ssd_scan", "HGMMA")
    print(f"phase 7: {hgmma} HGMMA instructions in the built library "
          "(cuobjdump -sass)")
    if not hgmma:
        raise AssertionError("ssd_intra_chunk has no HGMMA instruction: it "
                             "does not run on the tensor cores")
    gen = torch.Generator(device="cuda").manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    worst_intra = worst_op = 0.0
    n_cases = 0
    # the reference's sweep (tests/test_kernels.py; s = 100 is padded)
    for b, s, h, p, n, chunk in ((1, 64, 2, 16, 8, 32),
                                 (2, 128, 4, 32, 16, 64),
                                 (1, 100, 3, 64, 32, 32)):
        for dt in (f32, bf16):
            args = _ssd_inputs(gen, b, s, h, p, n, dt)
            label = f"{(b, s, h, p, n, chunk)} {dt}"
            worst_intra = max(worst_intra, _check_intra(*args, chunk, label))
            worst_op = max(worst_op, _check_ssd_op(*args, chunk, label))
            n_cases += 1
    # an initial state (the reference's test)
    args = _ssd_inputs(gen, 1, 64, 2, 16, 8, f32)
    init = torch.randn((1, 2, 16, 8), generator=gen, device="cuda")
    worst_op = max(worst_op, _check_ssd_op(*args, 32, "initial state",
                                           init=init))
    print(f"phase 7: {n_cases} sweep cases and an initial state: intra-chunk "
          f"within {INTRA_TOL} of the plain version (max |err| "
          f"{worst_intra:.3e}), ssd_op within the reference's gates "
          f"{SSD_TOL} of ssd_ref (max |err| {worst_op:.3e})")

    rows = {}
    for arch, (b, s, h, p, n, chunk) in SSD_PATH_SHAPES.items():
        conv_dim = h * p + 2 * n
        x, dt, A, B, C = _ssd_inputs(gen, b, s, h, p, n, bf16,
                                     conv_dim=conv_dim)
        label = f"{arch} path shape {(b, s, h, p, n, chunk)}"
        max_abs = _check_intra(x, dt, A, B, C, chunk, label)
        op_err = _check_ssd_op(x, dt, A, B, C, chunk, label)
        xd = (x.float() * dt[..., None]).contiguous()
        dA = (dt * A).contiguous()

        def kernel():
            return ssd_scan.ssd_intra_chunk(xd, dA, B, C, chunk=chunk)

        # the kernel's device time (profiler) and the loop time (CUDA events
        # around 20 calls, which at a few tens of microseconds is the
        # wrapper's host time)
        ms = device_ms(kernel)
        loop_ms = time_ms(kernel, iters=20)
        plain_ms = time_ms(lambda: ssd_intra_chunk_ref(xd, dA, B, C,
                                                       chunk=chunk), iters=5)
        # what lies outside the kernel on the path: the inter-chunk
        # recurrence and Y_off (ssd_chunked_kernel), in plain PyTorch
        nc = s // chunk
        y_diag, states, dA_cs = kernel()
        Cc = C.float().reshape(b, nc, chunk, n)
        dA_c = dA_cs.reshape(b, nc, chunk, h)

        def outside():
            y_off, _ = inter_chunk(states, Cc, dA_c)
            return y_diag.reshape(b, nc, chunk, h, p) + y_off

        outside_ms = device_ms(outside)
        outside_loop_ms = time_ms(outside, iters=20)
        nbytes = (4 * (2 * b * s * h * p + 2 * b * s * h + b * nc * h * p * n)
                  + 2 * B.element_size() * b * s * n)
        tri = chunk * (chunk + 1) // 2      # the kept (j <= i) pairs
        # C B^T once per (batch, chunk): it does not depend on the head
        flops = (2 * b * nc * tri * n
                 + 2 * b * h * nc * (tri * p + chunk * p * n))
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = flops / TF32_FLOPS_PER_S * 1e3
        fma_ms = flops / FP32_FLOPS_PER_S * 1e3
        rows[arch] = {
            "shape": [b, s, h, p, n, chunk], "max_abs_err": max_abs,
            "ssd_op_max_abs_err": op_err, "ms": ms, "loop_ms": loop_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "fp32_fma_bound_ms": max(bound_bytes, fma_ms),
            "outside_ms": outside_ms, "outside_loop_ms": outside_loop_ms,
            "bytes": nbytes, "flops": flops}
        print(f"phase 7: {label}, B/C bf16: kernel device {ms:.4f} ms "
              f"(profiler; loop {loop_ms:.4f} ms), plain {plain_ms:.3f} ms, "
              f"bound {rows[arch]['bound_ms']:.4f} ms "
              f"({rows[arch]['bound_by']}: {nbytes:,} bytes at "
              f"{HBM_BYTES_PER_S:.3g} B/s; {flops:.4e} operations, C B^T "
              f"once per chunk, at the TF32 rate {TF32_FLOPS_PER_S:.3g}/s "
              f"{bound_ops:.4f} ms; the kernel at "
              f"{100 * rows[arch]['bound_ms'] / ms:.1f} % of it); the same "
              f"operations as float32 FMAs {fma_ms:.4f} ms; library ms: none "
              f"(no single PyTorch call computes this function); inter-chunk "
              f"recurrence + Y_off device {outside_ms:.4f} ms (loop "
              f"{outside_loop_ms:.4f} ms); max |err| intra {max_abs:.3e}, "
              f"ssd_op {op_err:.3e} [{card}]")
        del y_diag, states, dA_cs, Cc, dA_c
        del x, dt, A, B, C, xd, dA
    torch.cuda.empty_cache()
    main = rows["mamba2-2.7b"]
    return {"name": "ssd_intra_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:57",
            "launches": None, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "loop_ms": main["loop_ms"],
            "fp32_fma_bound_ms": main["fp32_fma_bound_ms"],
            "bytes": main["bytes"], "flops": main["flops"],
            "shape": main["shape"], "hgmma": hgmma, "by_path": rows,
            "ptxas": ptxas}


def phase_train_mamba(card: str) -> tuple[dict, dict]:
    """Phase 8: Algorithm 1 on full-width mamba2-2.7b through train.main,
    with the SSD kernel in every layer and the mix kernel once a block."""
    import torch

    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves, tree_map

    K, T, B, S, blocks, mu = 2, 2, 1, 1024, 3, 0.05
    argv = ["--arch", "mamba2-2.7b", "--full", "--agents", str(K),
            "--local-steps", str(T), "--batch", str(B), "--seq", str(S),
            "--blocks", str(blocks), "--optimizer", "sgd", "--step-size",
            str(mu), "--mix", "pallas"]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = train.main(argv, use_kernels=True)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = out["cfg"]
    # one launch per layer per agent per local step, plus the logging
    # forward of every agent after each block
    want = {"ssd_intra_chunk": cfg.num_layers * K * (T * blocks
                                                     + len(out["losses"])),
            "diffusion_mix": num_tiles(K, full_width_M("mamba2-2.7b"))
            * blocks, "flash_attention": 0, "gather_mix": 0,
            "gather_robust_mix": 0, "diffusion_mix_int8": 0}
    if launches != want:
        raise AssertionError(f"launches on the mamba2 training path "
                             f"{launches}, expected {want}")
    losses = torch.tensor(out["losses"])
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite training losses {out['losses']}")
    state = out["state"]
    if not all(torch.isfinite(x).all() for x in tree_leaves(state.params)):
        raise AssertionError("non-finite parameters after training")
    for i, (t, tps) in enumerate(zip(out["timings"], out["tokens_per_s"])):
        print(f"phase 8: block {i}: {t['block_s']:.3f}s (local updates "
              f"{t['local_s']:.3f}s, combination {t['combine_s']:.3f}s), "
              f"{tps:.0f} tokens/s [{card}]")
    print(f"phase 8: {launches} launches on the training path; losses "
          f"{out['losses']}; peak device memory {peak_gb:.2f} GB; train.main "
          f"took {wall:.1f}s [{card}]")
    steady_s = min(t["block_s"] for t in out["timings"][1:])
    profile = _profile_block(state, cfg, K, T, B, S, steady_s, card,
                             optimizer="sgd", mu=mu, label="phase 8")
    row = {"phase": "train", "arch": "mamba2-2.7b", "agents": K,
           "local_steps": T, "batch": B, "seq": S, "blocks": blocks,
           "optimizer": "sgd", "step_size": mu, "mix": "pallas",
           "timings": out["timings"], "tokens_per_s": out["tokens_per_s"],
           "losses": out["losses"], "launches": launches,
           "peak_mem_gb": peak_gb, "profile": profile, "card": card}
    params = tree_map(lambda x: x[0].clone(), state.params)
    del out, state
    torch.cuda.empty_cache()
    row.update(_mamba_step_check(params, cfg, B, S))
    print(json.dumps(row))
    return launches, row


def _grad_rels(params, g_a, g_b) -> tuple[dict, dict]:
    """|a - b| / |b| in Frobenius norm for every gradient leaf, and for
    every layer of the layer-stacked segment leaves."""
    from repro_torch.tree import tree_flatten_with_path

    def rel(a, b):
        return ((a.float() - b.float()).norm()
                / b.float().norm().clamp(min=1e-30)).item()

    leaf, layer = {}, {}
    for (path, _), a, b in zip(tree_flatten_with_path(params), g_a, g_b):
        name = "/".join(map(str, path))
        leaf[name] = rel(a, b)
        if path[0] == "segments":
            for i, (ai, bi) in enumerate(zip(a.unbind(0), b.unbind(0))):
                layer[f"{name}[{i}]"] = rel(ai, bi)
    return leaf, layer


def _summary(rels: dict) -> dict:
    worst = max(rels, key=rels.get)
    return {"worst": worst, "worst_rel": rels[worst],
            "median_rel": sorted(rels.values())[len(rels) // 2]}


def _mamba_step_check(params, cfg, B: int, S: int) -> dict:
    """One local step of one agent at full mamba2 width, SSD kernel
    against plain SSD, beside its two witnesses (see SSM_GRAD_*)."""
    import dataclasses

    import torch

    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.tree import tree_map

    batch = tree_map(lambda x: x.cuda(), lm_token_batch(
        torch.Generator().manual_seed(8), (B, S), cfg.vocab_size))
    plain = dataclasses.replace(cfg, use_kernels=False)
    loss_k, g_k = _grads_one_step(params, cfg, batch)
    loss_p, g_p = _grads_one_step(params, plain, batch)
    kernel, kernel_layers = _grad_rels(params, g_k, g_p)
    del g_k
    loss_w, g_w = _grads_one_step(
        params, dataclasses.replace(plain, ssm_chunk=64), batch)
    witness, witness_layers = _grad_rels(params, g_w, g_p)
    del g_w, g_p
    # float32 parameters; remat keeps the float32 activations to one layer
    p32 = tree_map(lambda x: x.float(), params)
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    loss_k32, g_k32 = _grads_one_step(p32, cfg32, batch, remat=True)
    loss_p32, g_p32 = _grads_one_step(
        p32, dataclasses.replace(cfg32, use_kernels=False), batch, remat=True)
    f32, f32_layers = _grad_rels(p32, g_k32, g_p32)
    del p32, g_k32, g_p32
    torch.cuda.empty_cache()

    res = {"loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_plain_chunk64": loss_w,
           "loss_rel_kernel_vs_plain": abs(loss_k - loss_p) / abs(loss_p),
           "loss_rel_f32": abs(loss_k32 - loss_p32) / abs(loss_p32),
           "grad_bf16_kernel_vs_plain": {"leaf": _summary(kernel),
                                         "layer": _summary(kernel_layers)},
           "grad_bf16_chunk64_vs_chunk128": {
               "leaf": _summary(witness), "layer": _summary(witness_layers)},
           "grad_f32_kernel_vs_plain": {"leaf": _summary(f32),
                                        "layer": _summary(f32_layers)}}
    for name in ("grad_bf16_kernel_vs_plain",
                 "grad_bf16_chunk64_vs_chunk128", "grad_f32_kernel_vs_plain"):
        for unit in ("leaf", "layer"):
            r = res[name][unit]
            print(f"phase 8: {name} per {unit}: worst {r['worst']} "
                  f"{r['worst_rel']:.3e}, median {r['median_rel']:.3e}")
    k_rel = res["grad_bf16_kernel_vs_plain"]["leaf"]["worst_rel"]
    w_rel = res["grad_bf16_chunk64_vs_chunk128"]["leaf"]["worst_rel"]
    f_rel = res["grad_f32_kernel_vs_plain"]["layer"]["worst_rel"]
    print(f"phase 8: one local step, SSD kernel vs plain SSD: bf16 loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel "
          f"{res['loss_rel_kernel_vs_plain']:.2e}, gate {SSM_LOSS_TOL}); "
          f"float32 loss rel {res['loss_rel_f32']:.2e} (gate "
          f"{SSM_LOSS_TOL_F32}); bf16 worst leaf {k_rel:.3e} against the "
          f"chunk-64 witness {w_rel:.3e} (gate {SSM_GRAD_WITNESS_RATIO}x the "
          f"witness); float32 worst layer {f_rel:.3e} (gate "
          f"{SSM_GRAD_TOL_F32})")
    if not res["loss_rel_kernel_vs_plain"] <= SSM_LOSS_TOL:
        raise AssertionError("full-width mamba2 loss: kernel path != plain")
    if not res["loss_rel_f32"] <= SSM_LOSS_TOL_F32:
        raise AssertionError("full-width mamba2 float32 loss: kernel != plain")
    if not k_rel <= SSM_GRAD_WITNESS_RATIO * w_rel:
        raise AssertionError("full-width mamba2 bf16 gradients: kernel vs "
                             "plain beyond the rounding witness")
    if not f_rel <= SSM_GRAD_TOL_F32:
        raise AssertionError("full-width mamba2 float32 gradients: kernel "
                             "!= plain")
    return res


def phase_ssm_devices(scratch: Path, card: str) -> dict:
    """Phase 9: the SSM paths on the card against the CPU, and the one
    full-width forward that runs both the SSD and the attention kernel."""
    import dataclasses

    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        phase_train_devices(arch, label="phase 9")
        # prefill + greedy decode from one checkpoint on both devices
        cfg = get_config(arch).smoke
        path = str(scratch / f"{arch}_smoke.npz")
        save_checkpoint(path, tf.init_params(
            torch.Generator().manual_seed(90), cfg))
        argv = ["--arch", arch, "--smoke", "--checkpoint", path, "--batch",
                "2", "--prompt-len", "40", "--decode", "8", "--temperature",
                "0"]
        gpu = serve.main(argv)
        cpu = serve.main(argv + ["--device", "cpu"])
        lg_err = (gpu["prefill_logits"].cpu()
                  - cpu["prefill_logits"]).abs().max().item()
        if not lg_err <= 1e-4:
            raise AssertionError(f"{arch} smoke prefill logits: card vs CPU "
                                 f"{lg_err:.3e} > 1e-4")
        if not torch.equal(gpu["tokens"], cpu["tokens"]):
            raise AssertionError(f"{arch} smoke greedy tokens differ: card "
                                 f"{gpu['tokens'].tolist()} vs CPU "
                                 f"{cpu['tokens'].tolist()}")
        print(f"phase 9: {arch} smoke prefill logits card vs CPU "
              f"{lg_err:.2e}; 8 greedy tokens equal")

    # full-width zamba2-1.2b: one forward, kernels on and off
    cfg = get_config("zamba2-1.2b").model
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(91),
                            cfg)
    batch = {k: v.cuda() for k, v in lm_token_batch(
        torch.Generator().manual_seed(92), (1, 1024), cfg.vocab_size).items()}
    reset_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        loss_k = tf.train_loss(params, dataclasses.replace(
            cfg, use_kernels=True), batch, remat=False).item()
        kernel_s = time.perf_counter() - t0
        launches = read_launches()
        loss_p = tf.train_loss(params, cfg, batch, remat=False).item()
    n_attn = sum(n for kind, n in cfg.segments() if kind == "attn")
    want = {"flash_attention": n_attn,
            "ssd_intra_chunk": cfg.num_layers - n_attn, "diffusion_mix": 0,
            "gather_mix": 0, "gather_robust_mix": 0, "diffusion_mix_int8": 0}
    if launches != want:
        raise AssertionError(f"zamba2 forward launches {launches}, expected "
                             f"{want}")
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"phase 9: zamba2-1.2b full width, B=1, S=1024: loss kernels on "
          f"{loss_k:.6f}, off {loss_p:.6f} (rel {loss_rel:.2e}, gate "
          f"{SSM_LOSS_TOL}); launches {launches}; kernel forward "
          f"{kernel_s:.3f}s [{card}]")
    if not (loss_rel <= SSM_LOSS_TOL and torch.isfinite(
            torch.tensor([loss_k, loss_p])).all()):
        raise AssertionError("zamba2 full-width forward: kernels on != off")
    del params
    torch.cuda.empty_cache()
    return launches


def _link_drop(topo, rng, drop: float = 0.3):
    """A realized matrix on the base support: every undirected base edge
    fails with probability ``drop`` (numpy draw), the survivors take
    Metropolis weights (the reference's link-dropout law)."""
    import numpy as np

    from repro_torch.core.topology import metropolis_weights

    K = topo.num_agents
    up = np.triu(rng.random((K, K)) >= drop, 1)
    adj = topo.adjacency & (up | up.T)
    return metropolis_weights(adj | np.eye(K, dtype=bool))


def _gather_operands(topo, A_np, mask_np, robust: str = "trimmed_mean"):
    """The (K, D) operands of both gather kernels for one realized draw,
    as the mixers compute them: ``(idx, gw)`` for ``gather_mix`` and
    ``(idx, member, wslot, active)`` for ``gather_robust_mix``."""
    import torch

    from repro_torch.core.mixing import _gather_weights, make_mixer
    from repro_torch.core.participation import masked_combination

    A = torch.as_tensor(A_np, dtype=torch.float32, device="cuda")
    m = torch.as_tensor(mask_np, dtype=torch.float32, device="cuda")
    mixer = make_mixer(robust, topo, trim=1, scope="neighborhood",
                       gather="table", device="cuda")
    idx, member, S = mixer._gather_members(m, A)
    idx_t, valid = mixer._table.on("cuda")
    gw = _gather_weights(masked_combination(A, m), idx_t, valid)
    return (idx, gw), (idx, member, mixer._slot_weights(S, idx.shape[1]), m)


def _hold_gather(fn, plain, ops, W, m, label, width=None):
    """Run a gather kernel on the whole (K, M) buffer and hold it against
    its plain version in column slices of ``width`` (every column); the
    inactive rows must come back bit-equal.  Returns (rel err, max |err|,
    the kernel's output)."""
    import torch

    out = fn(*ops, W)
    torch.cuda.synchronize()
    M = W.shape[1]
    width = width or M
    err = max_abs = 0.0
    for a in range(0, M, width):
        ref = plain(*ops, W[:, a:a + width])
        err = max(err, rel_err(out[:, a:a + width], ref))
        max_abs = max(max_abs, (out[:, a:a + width] - ref).abs().max().item())
        del ref
    if not err <= TOL:
        raise AssertionError(f"{label}: rel err {err:.3e} > {TOL}")
    dead = m == 0
    if not torch.equal(out[dead], W[dead]):
        raise AssertionError(f"{label}: an inactive row was not kept exactly")
    return err, max_abs, out


def _sort_networks() -> dict:
    """{width: compare-exchanges} of the robust kernel's sorting networks
    (``csrc/sort_networks.cuh``)."""
    import re

    text = (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
            / "sort_networks.cuh").read_text()
    return {int(P): int(N) for P, N in
            re.findall(r"^SORT_NET\((\d+), (\d+),", text, re.M)}


def _robust_ops(idx, member, wslot, active) -> tuple[int, int]:
    """(min/max, float32 multiply and add) operations per column of the
    robust function for this draw, whatever computes it: one sort per
    distinct member set of the active targets (the table's network for D,
    a min and a max per compare-exchange), and a multiply and an add per
    slot for each distinct (member set, weight row) among them."""
    import torch

    K, D = idx.shape
    nets = _sort_networks()
    exchanges = nets[min(P for P in nets if P >= D)]
    act = active.reshape(-1) > 0
    key = torch.where(member > 0, idx.long(), K).sort(dim=1).values[act]
    if not key.numel():
        return 0, 0
    weights = wslot.float().contiguous().view(torch.int32).long()[act]
    sets = torch.unique(key, dim=0).shape[0]
    results = torch.unique(torch.cat([key, weights], dim=1), dim=0).shape[0]
    return 2 * exchanges * sets, 2 * D * results


def _ptxas_summary(lines: list) -> dict:
    """Kernels, their register range and any spill, from ``ptxas`` lines."""
    import re

    regs = [int(m.group(1)) for line in lines
            for m in [re.search(r"Used (\d+) registers", line)] if m]
    spills = [line for line in lines if "spill" in line
              and "0 bytes spill stores, 0 bytes spill loads" not in line]
    return {"kernels": len(regs), "registers": [min(regs), max(regs)],
            "spills": spills}


def phase_gather_kernels(card: str) -> tuple[dict, dict]:
    """Phase 10: ``gather_robust_mix`` and ``gather_mix`` against their
    plain versions on the card, then each path's shape timed."""
    import numpy as np
    import torch

    from repro_torch.core.participation import masked_combination
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels import gather_mix as gm
    from repro_torch.kernels import gather_robust_mix as grm
    from repro_torch.kernels.ref import gather_mix_ref, gather_robust_mix_ref

    gm.build()
    grm.build()
    ptxas = {n: _ptxas_summary(ptxas_lines(n))
             for n in ("gather_mix", "gather_robust_mix")}
    for n, summary in ptxas.items():
        print(f"  ptxas ({n}): {summary['kernels']} kernels, "
              f"{summary['registers'][0]}-{summary['registers'][1]} "
              f"registers, spills: {summary['spills'] or 'none'}")
    gen = torch.Generator(device="cuda").manual_seed(10)
    rng = np.random.default_rng(10)
    # FedAvg at K = 20 takes the one-target route (no group stages its
    # D = 20 rows); every other table the group route
    topos = [(K, kind, kw) for K in (8, 12, 16, 1024)
             for kind, kw in (("ring", {}), ("ring", {"hops": 2}),
                              ("grid", {}), ("fedavg", {}))
             if not (kind == "grid" and K == 8)
             and not (kind == "fedavg" and K > 12)] + [(20, "fedavg", {})]
    n_cases, worst = 0, {"gather_mix": 0.0, "gather_robust_mix": 0.0}
    Ds, routes = set(), set()
    for K, kind, kw in topos:
        topo = make_topology(kind, K, **kw)
        Ds.add(topo.max_degree + 1)
        M = 100_003 if K <= 20 else 4_099          # odd M
        W = torch.randn((K, M), generator=gen, device="cuda")
        draws = [("ones", topo.A, np.ones(K)), ("zeros", topo.A, np.zeros(K)),
                 ("random", topo.A, (rng.random(K) < 0.6) * 1.0),
                 ("link drops", _link_drop(topo, rng),
                  (rng.random(K) < 0.8) * 1.0)]
        for mname, A_np, mask in draws:
            for robust in ("trimmed_mean", "median"):
                lin, rob = _gather_operands(topo, A_np, mask, robust)
                routes.add((K, kind, gm.stage_plan(lin[0]).route))
                label = f"{kind}{kw} K={K} D={topo.max_degree + 1} {mname}"
                err, _, out = _hold_gather(
                    grm.gather_robust_mix, gather_robust_mix_ref, rob, W,
                    rob[3], f"gather_robust_mix {label} {robust}")
                worst["gather_robust_mix"] = max(worst["gather_robust_mix"],
                                                 err)
                n_cases += 1
            err, _, out = _hold_gather(gm.gather_mix, gather_mix_ref, lin, W,
                                       rob[3], f"gather_mix {label}")
            worst["gather_mix"] = max(worst["gather_mix"], err)
            del out
        del W
    print(f"phase 10: {n_cases} robust cases (trimmed mean and median) and "
          f"{n_cases // 2} linear cases, K in (8, 12, 16, 20, 1024), D in "
          f"{sorted(Ds)}, odd M, masks all-active / all-inactive / random "
          f"and realized link drops: within {TOL} (worst gather_robust_mix "
          f"{worst['gather_robust_mix']:.3e}, gather_mix "
          f"{worst['gather_mix']:.3e}); inactive rows bit-equal; routes "
          + ", ".join(f"{kind} K={K}: {r}" for K, kind, r in sorted(routes)))
    if {r for _, _, r in routes} != {"group", "target"}:
        raise AssertionError("phase 10 did not cover both kernel routes")
    torch.cuda.empty_cache()

    # 64-bit offsets: idx * M + j passes 2^31
    K, M = 12, 190_000_001
    topo = make_topology("ring", K)
    mask = np.array([1.0, 0.0] * 6)
    lin, rob = _gather_operands(topo, topo.A, mask)
    W = torch.randn((K, M), generator=gen, device="cuda")
    big = {}
    for name, fn, plain, ops in (
            ("gather_robust_mix", grm.gather_robust_mix,
             gather_robust_mix_ref, rob),
            ("gather_mix", gm.gather_mix, gather_mix_ref, lin)):
        big[name], _, out = _hold_gather(fn, plain, ops, W, rob[3],
                                         f"{name} K={K} M={M}",
                                         width=1 << 24)
        del out
    del W
    torch.cuda.empty_cache()
    print(f"phase 10: K={K} ring, M={M} (K*M = {K * M:,} > 2^31): "
          f"gather_robust_mix rel err {big['gather_robust_mix']:.3e}, "
          f"gather_mix {big['gather_mix']:.3e}; inactive rows bit-equal")

    def at_path_shape(K, topo, mask, label, M):
        """Both kernels on a (K, M) buffer of one path: a column tile the
        mixers launch on, or the whole of smollm-360m's M parameters.  The
        plan is computed once, outside the timed calls, as the mixers do;
        the plain versions and ``A_eff.T @ W`` run in column slices (the
        plain gather's (K, D, M) intermediate does not fit)."""
        D = topo.max_degree + 1
        lin, rob = _gather_operands(topo, topo.A, mask)
        W = torch.randn((K, M), generator=gen, device="cuda")
        width = (1 << 28) // (K * D)
        rows = {}
        A_eff = masked_combination(
            torch.as_tensor(topo.A, dtype=torch.float32, device="cuda"),
            rob[3])
        plan = gm.stage_plan(lin[0])
        rplan = grm.share_sorts(plan, *rob)
        minmax, fp = _robust_ops(*rob)
        table_bytes = K * D * (4 + 4 + 4) + 4 * K
        for name, fn, plain, ops, p, lib, query in (
                ("gather_robust_mix", grm.gather_robust_mix,
                 gather_robust_mix_ref, rob, rplan, False,
                 grm.build().gather_robust_mix_shape),
                ("gather_mix", gm.gather_mix, gather_mix_ref, lin, plan,
                 True, gm.build().gather_mix_shape)):
            launch = gm.group_launch(query, p, D, K, M)
            err, max_abs, out = _hold_gather(fn, plain, ops, W, rob[3],
                                             f"{name} at the {label} shape",
                                             width=width)
            del out
            torch.cuda.empty_cache()
            # the first calls after the plain version's slices and
            # empty_cache ran slower on an H100: warm up first
            for _ in range(2):
                fn(*ops, W, p)
            ms = time_ms(lambda: fn(*ops, W, p), iters=5)
            clocks = card_clocks()

            def sliced(f):
                return lambda: [f(W[:, a:a + width])
                                for a in range(0, M, width)]

            plain_ms = time_ms(sliced(lambda w: plain(*ops, w)), iters=1)
            library_ms = (time_ms(sliced(lambda w: A_eff.T @ w), iters=1)
                          if lib else None)
            nbytes = 4 * 2 * K * M + table_bytes
            bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            if lib:
                ops_text = f"{2 * D * K * M:.3e} float32 operations"
                bound_ops = 2 * D * K * M / FP32_FLOPS_PER_S * 1e3
            else:
                # min/max share the float32 issue slots at half their rate
                ops_text = (f"{minmax * M:.3e} min/max and {fp * M:.3e} "
                            f"float32 operations")
                bound_ops = max((minmax + fp) * M / FP32_ISSUE_PER_S,
                                minmax * M / MINMAX_ISSUE_PER_S) * 1e3
            rows[name] = {
                "shape": [K, M], "D": D, "mask": [int(x) for x in mask],
                "route": p.route, "group": p.group,
                "staged_rows": p.staged_rows, "launch": launch,
                "rel_err": err, "max_abs_err": max_abs, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(bound_bytes, bound_ops),
                "bound_bytes_ms": bound_bytes, "bound_ops_ms": bound_ops,
                "bound_by": "bytes" if bound_bytes >= bound_ops
                else "operations", "bytes": nbytes,
                "bytes_per_s": nbytes / ms * 1e3, "column_slices": width,
                "clocks": clocks}
            print(f"phase 10: {name} at the {label} shape K={K} D={D} "
                  f"M={M}: {p.route} route (R={p.group}, U="
                  f"{p.staged_rows}, launch {launch}); rel err {err:.3e}; "
                  f"kernel {ms:.3f} ms ({nbytes / ms / 1e6:.1f} GB/s; SM "
                  f"and memory clocks, temperature, power after it: "
                  f"{clocks}), plain {plain_ms:.3f} "
                  f"ms and "
                  + (f"A_eff.T @ W {library_ms:.3f} ms" if lib else
                     "no library call")
                  + f" in slices of {width} columns; bound "
                  f"{rows[name]['bound_ms']:.3f} ms "
                  f"({rows[name]['bound_by']}: {nbytes:,} bytes in "
                  f"{bound_bytes:.3f} ms, {ops_text} in {bound_ops:.3f} ms),"
                  f" {rows[name]['bound_ms'] / ms:.1%} of it [{card}]")
        del W
        torch.cuda.empty_cache()
        return rows

    from repro_torch.core.mixing import tile_columns

    M = full_width_M()
    train_mask = np.array([1.0] * 5 + [0.0] + [1.0] * 5 + [0.0])
    shapes = {}
    for label, K, kind, mask in (("training", 12, "ring", train_mask),
                                 ("serving", 8, "fedavg", np.ones(8))):
        topo = make_topology(kind, K)
        # the launch the path makes (one column tile) and, as before, the
        # whole buffer
        shapes[label] = at_path_shape(K, topo, mask, f"{label} tile",
                                      tile_columns(K))
        shapes[f"{label} whole"] = at_path_shape(K, topo, mask,
                                                 f"{label} whole-buffer", M)
    out = []
    for name, line in (("gather_robust_mix", 280), ("gather_mix", 245)):
        row = shapes["training"][name]
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/diffusion_mix.py:{line}",
            "launches": None, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "bytes": row["bytes"],
            "shape": row["shape"], "D": row["D"],
            "by_path": {"train_tile": row,
                        "serve_tile": shapes["serving"][name],
                        "train": shapes["training whole"][name],
                        "serve": shapes["serving whole"][name]},
            "ptxas": ptxas[name]})
    return tuple(out)


def _ulp_gate(label: str, pairs) -> dict:
    """Hold bf16 results within one bf16 ulp plus the float32 summation
    bound (phase 3's gate); ``pairs`` yields (result, plain result, bound)
    leaf by leaf."""
    n_ulp = n_bad = 0
    max_ulps = 0.0
    for a, b, floor in pairs:
        over, bad, worst = _bf16_ulp_check(a, b, floor)
        n_ulp, n_bad = n_ulp + over, n_bad + bad
        max_ulps = max(max_ulps, worst)
    print(f"{label}: {n_ulp} elements beyond one bf16 ulp, {n_bad} beyond "
          f"it plus the float32 summation bound; largest difference "
          f"{max_ulps:.2f} ulp")
    if n_bad:
        raise AssertionError(f"{label}: beyond one bf16 ulp")
    return {"beyond_ulp": n_ulp, "beyond_gate": n_bad, "max_ulps": max_ulps}


#: elements per slice of the bf16 checks (a stacked layer leaf at K = 12
#: is 1.9e9 elements; the check's float32 temporaries stay near 2 GB)
CHECK_SLICE = 1 << 26


def _sliced(got, want, floors):
    """(result, plain result, bound) over flat slices of every leaf pair,
    for :func:`_ulp_gate`."""
    from repro_torch.tree import tree_leaves

    for a, b, floor in zip(tree_leaves(got), tree_leaves(want), floors):
        a, b = a.reshape(-1), b.reshape(-1)
        for i in range(0, a.numel(), CHECK_SLICE):
            yield a[i:i + CHECK_SLICE], b[i:i + CHECK_SLICE], floor


def _sum_floors(tree, terms: int) -> list:
    """Per leaf, the float32 summation bound of two orders over ``terms``
    terms of the leaf's largest magnitude."""
    from repro_torch.tree import tree_leaves

    return [2 * max(terms - 1, 1) * 2.0 ** -24 * x.abs().max().item()
            for x in tree_leaves(tree)]


def _frozen_equal(got, params, active) -> bool:
    """Inactive agents came back bit-equal."""
    import torch

    from repro_torch.tree import tree_leaves

    dead = active == 0
    return all(torch.equal(a[dead], b[dead])
               for a, b in zip(tree_leaves(got), tree_leaves(params)))


def _train_full(card: str, label: str, flags: list, blocks: int,
                want_fn, K: int = 12, T: int = 2) -> tuple[dict, dict]:
    """Algorithm 1 on full-width smollm-360m at K agents (12 unless given)
    through train.main (ring unless ``flags`` say otherwise, T local steps,
    q = 0.9, B = 1, S = 1024, SGD mu = 0.05, ``use_kernels=True``) with
    ``flags``; the launch counts against ``want_fn(cfg, n_logged)``, finite
    honest losses and parameters, the block split, tokens/s and peak
    memory."""
    import torch

    from repro_torch.core.attacks import byzantine_mask
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    B, S, mu = 1, 1024, 0.05
    argv = ["--full", "--agents", str(K), "--local-steps", str(T),
            "--batch", str(B), "--seq", str(S), "--blocks", str(blocks),
            "--optimizer", "sgd", "--step-size", str(mu), "--participation",
            "0.9", *flags]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = train.main(argv, use_kernels=True)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = out["cfg"]
    want = want_fn(cfg, len(out["losses"]))
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    n_bad = (int(flags[flags.index("--attack-num") + 1])
             if "--attack-num" in flags else 0)
    honest = torch.as_tensor(byzantine_mask(K, n_bad)) == 0
    losses = torch.tensor(out["losses"])
    if not torch.isfinite(losses[:, honest]).all():
        raise AssertionError(f"{label}: non-finite honest losses "
                             f"{out['losses']}")
    state = out["state"]
    if not all(torch.isfinite(x[honest.cuda()]).all()
               for x in tree_leaves(state.params)):
        raise AssertionError(f"{label}: non-finite honest parameters")
    for i, (t, tps) in enumerate(zip(out["timings"], out["tokens_per_s"])):
        print(f"{label}: block {i}: {t['block_s']:.3f}s (local updates "
              f"{t['local_s']:.3f}s, combination {t['combine_s']:.3f}s), "
              f"{tps:.0f} tokens/s [{card}]")
    print(f"{label}: launches {launches}; losses {out['losses']}; peak "
          f"device memory {peak_gb:.2f} GB; train.main took {wall:.1f}s "
          f"[{card}]")
    row = {"arch": "smollm-360m", "agents": K, "local_steps": T, "batch": B,
           "seq": S, "blocks": blocks, "optimizer": "sgd", "step_size": mu,
           "flags": flags, "timings": out["timings"],
           "tokens_per_s": out["tokens_per_s"], "losses": out["losses"],
           "active": out["active"], "launches": launches,
           "peak_mem_gb": peak_gb, "card": card}
    return out, row


def phase_train_robust(card: str) -> tuple[dict, dict]:
    """Phase 11a: the Byzantine preset at full smollm-360m width, the
    robust combination through ``gather_robust_mix``; then one more
    combination of the trained stack, kernel against the plain gather-table
    path on the card."""
    import torch

    from repro_torch.core.attacks import make_attack
    from repro_torch.core.mixing import make_mixer
    from repro_torch.core.topology import make_topology

    K, blocks = 12, 3
    M = full_width_M()

    def want(cfg, n_logged):
        return {"gather_robust_mix": num_tiles(K, M) * blocks,
                "flash_attention": cfg.num_layers * K * (2 * blocks
                                                         + n_logged),
                "diffusion_mix": 0, "gather_mix": 0, "ssd_intra_chunk": 0,
                "diffusion_mix_int8": 0}

    out, row = _train_full(card, "phase 11a",
                           BYZANTINE_FLAGS + ["--robust-gather", "fused"],
                           blocks, want)
    state, cfg = out["state"], out["cfg"]
    steady_s = min(t["block_s"] for t in out["timings"][1:])
    row["profile"] = _profile_block(
        state, cfg, K, 2, 1, 1024, steady_s, card, optimizer="sgd", mu=0.05,
        label="phase 11a", mix="trimmed_mean",
        grad_transform=make_attack("sign_flip", K, num_byzantine=3,
                                   scale=3.0).update,
        engine_kwargs={"trim": 1, "scope": "neighborhood",
                       "gather": "fused"})
    params = state.params
    del out, state
    torch.cuda.empty_cache()

    topo = make_topology("ring", K)
    A = torch.as_tensor(topo.A, dtype=torch.float32, device="cuda")
    active = torch.tensor([1.0] * 5 + [0.0] + [1.0] * 3 + [0.0, 1.0, 1.0],
                          device="cuda")
    kw = dict(trim=1, scope="neighborhood", device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    got = make_mixer("trimmed_mean", topo, gather="fused", **kw)(
        params, active, A)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    n = read_launches()["gather_robust_mix"]
    if n != num_tiles(K, M):
        raise AssertionError(f"phase 11a: one combination launched "
                             f"gather_robust_mix {n}x")
    t0 = time.perf_counter()
    want_p = make_mixer("trimmed_mean", topo, gather="table", **kw)(
        params, active, A)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    row["combine_kernel_vs_table"] = _ulp_gate(
        "phase 11a: one more combination, kernel vs plain gather table",
        _sliced(got, want_p, _sum_floors(params, 3)))
    if not _frozen_equal(got, params, active):
        raise AssertionError("phase 11a: inactive agents not kept exactly")
    row.update(combine_kernel_s=kernel_s, combine_table_s=plain_s)
    print(f"phase 11a: inactive agents bit-equal; that combination took "
          f"{kernel_s:.3f}s with the kernel ({n} launches), {plain_s:.3f}s "
          f"on the plain gather table [{card}]")
    print(json.dumps({"phase": "11a", **row}))
    del params, got, want_p
    torch.cuda.empty_cache()
    return row["launches"], row


def phase_train_gather(card: str) -> tuple[dict, dict]:
    """Phase 11b: the same model with ``--mix gather``, the combination
    through ``gather_mix``; then one combination of the trained stack
    against the dense mixer."""
    import torch

    from repro_torch.core.mixing import DenseMixer, make_mixer
    from repro_torch.core.topology import make_topology
    from repro_torch.tree import tree_leaves

    K, blocks = 12, 2
    M = full_width_M()

    def want(cfg, n_logged):
        return {"gather_mix": num_tiles(K, M) * blocks,
                "flash_attention": cfg.num_layers * K * (2 * blocks
                                                         + n_logged),
                "diffusion_mix": 0, "gather_robust_mix": 0,
                "ssd_intra_chunk": 0, "diffusion_mix_int8": 0}

    out, row = _train_full(card, "phase 11b",
                           ["--mix", "gather", "--attack", "none"], blocks,
                           want)
    params = out["state"].params
    del out
    torch.cuda.empty_cache()
    print(f"phase 11b: {torch.cuda.memory_allocated() / 1e9:.2f} GB live "
          f"before the combination check (the stack: "
          f"{sum(x.numel() * x.element_size() for x in tree_leaves(params)) / 1e9:.2f} GB)")
    topo = make_topology("ring", K)
    A = torch.as_tensor(topo.A, dtype=torch.float32, device="cuda")
    active = torch.tensor([1.0, 0.0] + [1.0] * 7 + [0.0, 1.0, 1.0],
                          device="cuda")
    got = make_mixer("gather", topo, device="cuda")(params, active, A)

    def dense():
        # the dense mixer on bf16 leaves first rounds the weights to bf16
        # (1/3 is not a bf16 number), so it runs on the float32 widening
        # and rounds once at the end, as the kernel does; in column slices
        # of each leaf, since the widened stack would not fit beside the
        # two bf16 ones
        width = CHECK_SLICE // K
        for g, p, floor in zip(tree_leaves(got), tree_leaves(params),
                               _sum_floors(params, 3)):
            g, p = g.reshape(K, -1), p.reshape(K, -1)
            for a in range(0, p.shape[1], width):
                want = DenseMixer()({"x": p[:, a:a + width].float()},
                                    active, A)["x"]
                yield g[:, a:a + width], want.to(torch.bfloat16), floor

    row["combine_gather_vs_dense"] = _ulp_gate(
        "phase 11b: one combination, gather kernel vs dense", dense())
    if not _frozen_equal(got, params, active):
        raise AssertionError("phase 11b: inactive agents not kept exactly")
    print(json.dumps({"phase": "11b", **row}))
    del params, got
    torch.cuda.empty_cache()
    return row["launches"], row


def phase_consensus_robust(path: str, card: str) -> dict:
    """Phase 12: phase 3's K = 8 bf16 stack collapsed through serve.main
    with the neighborhood trimmed mean (kernel), the global median (plain)
    and the gather mixer (kernel), each held against a plain consensus;
    then prefill and greedy decode from each."""
    import torch

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.mixing import make_mixer
    from repro_torch.core.serving import consensus_from_stacked
    from repro_torch.core.topology import make_topology
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map

    cfg = get_config("smollm-360m").model
    K, M = 8, full_width_M()
    argv = ["--arch", "smollm-360m", "--full", "--agents", str(K),
            "--checkpoint", path, "--batch", "4", "--prompt-len", "128",
            "--decode", "32", "--temperature", "0"]
    stack, _ = load_checkpoint(path, tf.param_specs(cfg, num_agents=K),
                               device="cuda")
    floors = _sum_floors(stack, K)
    fedavg = make_topology("fedavg", K)

    def median(x):          # the median of 8: the mean of sorted 4th, 5th
        srt = x.float().sort(dim=0).values
        return ((srt[3] + srt[4]) * 0.5).to(x.dtype)

    runs = {
        "trimmed_mean": (["--mix", "trimmed_mean", "--robust-scope",
                          "neighborhood"], "gather_robust_mix",
                         lambda: consensus_from_stacked(stack, K, make_mixer(
                             "trimmed_mean", fedavg, trim=1,
                             scope="neighborhood", gather="table",
                             device="cuda"))),
        "median": (["--mix", "median"], None,
                   lambda: tree_map(median, stack)),
        "gather": (["--mix", "gather"], "gather_mix",
                   lambda: consensus_from_stacked(stack, K, "dense"))}
    rows = {}
    for mix, (flags, kernel, plain) in runs.items():
        reset_launches()
        res = serve.main(argv + flags)
        launches = read_launches()
        want = {n: 0 for n in launches}
        if kernel:
            want[kernel] = num_tiles(K, M)
        if launches != want:
            raise AssertionError(f"phase 12 --mix {mix}: launches "
                                 f"{launches}, expected {want}")
        gate = _ulp_gate(f"phase 12 --mix {mix}: consensus vs plain",
                         _sliced(res["params"], plain(), floors))
        toks = res["tokens"]
        if (toks.shape != (4, 32) or toks.min() < 0
                or toks.max() >= cfg.vocab_size
                or not torch.isfinite(res["prefill_logits"]).all()):
            raise AssertionError(f"phase 12 --mix {mix}: bad tokens {toks}")
        rows[mix] = {"launches": launches, "timings": res["timings"],
                     "tokens_per_s": res["tokens_per_s"], **gate}
        print(f"phase 12: --mix {mix} {' '.join(flags[2:])}: consensus "
              f"{res['timings']['consensus_s']:.3f}s, prefill "
              f"{res['timings']['prefill_s']:.3f}s, decode "
              f"{res['tokens_per_s']:.1f} tokens/s; launches {launches}; "
              f"tokens in the vocabulary [{card}]")
        del res
        torch.cuda.empty_cache()
    del stack
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "12", "card": card, **rows}))
    return {mix: r["launches"] for mix, r in rows.items()}

def _int8_operands(gen, K: int, M: int, tile_m: int):
    """The operands the fused path hands the kernel: a (K, M) standard
    normal stack quantized per (agent, tile) by the path's quantizer, with
    agent 0's first tile all zero (scale 1.0) and the last 77 columns zero,
    as padding leaves them; every other tile's largest value lands on
    +-127.  Returns (int8 Wq, float32 scales (K, M / tile_m))."""
    import torch

    from repro_torch.core.compression import quantize_int8

    x = torch.randn((K, M // tile_m, tile_m), generator=gen, device="cuda")
    x[0, 0] = 0.0
    x.view(K, M)[:, M - 77:] = 0.0
    u = torch.rand(x.shape, generator=gen, device="cuda")
    q, scale = quantize_int8(x, axis=2, u=u)
    del x, u
    return q.to(torch.int8).view(K, M), scale[:, :, 0].contiguous()


def _uniform_int8_operands(gen, K: int, M: int, tile_m: int):
    """Int8 values uniform in [-127, 127] times scales uniform in (0, 1]:
    terms up to 127, some 30x larger than the quantizer's on normal data,
    with agent 0's first tile all zero (scale 1.0).  Returns (int8 Wq,
    float32 scales (K, M / tile_m))."""
    import torch

    Wq = torch.randint(-127, 128, (K, M), generator=gen, device="cuda",
                       dtype=torch.int8)
    scales = 1.0 - torch.rand((K, M // tile_m), generator=gen, device="cuda")
    Wq[0, :tile_m] = 0
    scales[0, 0] = 1.0
    return Wq, scales


def _at_offset(Wq, offset: int):
    """A contiguous copy of ``Wq`` whose data pointer lies ``offset`` bytes
    past a 16-byte boundary: a view at a storage offset, as a caller may
    hand the kernel."""
    import torch

    buf = torch.empty(Wq.numel() + 16, dtype=torch.int8, device=Wq.device)
    out = buf[offset:offset + Wq.numel()].view(Wq.shape)
    out.copy_(Wq)
    return out


def phase_int8_kernel(card: str) -> dict:
    """Phase 13: ``diffusion_mix_int8`` against its plain version
    ``mix_int8_ref`` on the card, every route covered, then the training
    path's shape and two operations-bound shapes timed, the redesigned
    routes against the scalar route (the earlier design) in turns."""
    import numpy as np
    import torch

    from repro_torch.core.mixing import int8_layout
    from repro_torch.core.participation import masked_combination
    from repro_torch.core.topology import averaging_matrix, make_topology
    from repro_torch.kernels import diffusion_mix_int8 as dmi
    from repro_torch.kernels.ref import mix_int8_exact, mix_int8_ref

    dmi.build()
    ptxas = ptxas_lines("diffusion_mix_int8")
    for line in ptxas:
        print("  ptxas:", line)
    ptxas_sum = _ptxas_summary(ptxas)
    sass = sass_opcodes("diffusion_mix_int8")
    wide = {op: n for op, n in sass.items()
            if op.startswith("STG") and op.endswith(".128")}
    print(f"phase 13: ptxas: {ptxas_sum['kernels']} kernels, "
          f"{ptxas_sum['registers'][0]}-{ptxas_sum['registers'][1]} "
          f"registers, spills: {ptxas_sum['spills'] or 'none'}; SASS memory "
          f"instructions {sass}")
    if ptxas_sum["spills"] or not any(".EF." in op for op in wide):
        raise AssertionError("phase 13: the kernel spills or has no 16-byte "
                             f"evict-first store ({wide})")
    gen = torch.Generator(device="cuda").manual_seed(13)
    rng = np.random.default_rng(13)

    def hold(A, m, Wq, scales, tile_m, sub, label):
        out = dmi.diffusion_mix_int8(A, m, Wq, scales, tile_m=tile_m,
                                     subtract_identity=sub)
        ref = mix_int8_ref(A, m, Wq, scales, tile_m=tile_m,
                           subtract_identity=sub)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        max_abs = (out - ref).abs().max().item()
        if not err <= TOL:
            raise AssertionError(f"diffusion_mix_int8 {label}: rel err "
                                 f"{err:.3e} > {TOL}")
        if sub and out[m == 0].any():
            raise AssertionError(f"diffusion_mix_int8 {label}: an inactive "
                                 "agent's delta is not 0")
        return err, max_abs

    def witness(A, m, Wq, scales, tile_m, sub, label):
        """Kernel and plain (cuBLAS) against the float64 value: the kernel
        must lie within the float32 summation bound of mix_int8_exact,
        elementwise.  Returns the kernel's reading against the plain
        version (the 1e-5 relative gate's), both errors against float64
        and their largest share of the bound."""
        out = dmi.diffusion_mix_int8(A, m, Wq, scales, tile_m=tile_m,
                                     subtract_identity=sub)
        ref = mix_int8_ref(A, m, Wq, scales, tile_m=tile_m,
                           subtract_identity=sub)
        exact, bound = mix_int8_exact(A, m, Wq, scales, tile_m=tile_m,
                                      subtract_identity=sub)
        err_k = (out.double() - exact).abs()
        err_p = (ref.double() - exact).abs()
        floor = bound.clamp(min=1e-300)
        r = {"rel_vs_plain": rel_err(out, ref),
             "kernel_f64": err_k.max().item(),
             "plain_f64": err_p.max().item(),
             "kernel_share": (err_k / floor).max().item(),
             "plain_share": (err_p / floor).max().item()}
        if not bool((err_k <= bound).all()):
            raise AssertionError(f"diffusion_mix_int8 {label}: off the "
                                 f"float64 value by more than the float32 "
                                 f"summation bound ({r})")
        if sub and out[m == 0].any():
            raise AssertionError(f"diffusion_mix_int8 {label}: an inactive "
                                 "agent's delta is not 0")
        return r

    n_cases, worst = 0, 0.0
    uni = {"cases": 0, "rel_vs_plain": 0.0, "kernel_f64": 0.0,
           "plain_f64": 0.0, "kernel_share": 0.0, "plain_share": 0.0,
           "kernel_not_worse": 0}
    for K in (4, 8, 12, 64, 240):
        A = torch.as_tensor(make_topology("erdos", K, seed=K).A,
                            dtype=torch.float32, device="cuda")
        for tile_m in (128, 512):
            M = tile_m * 201                       # an odd count of tiles
            for kind in ("normal", "uniform"):
                if kind == "normal":
                    Wq, scales = _int8_operands(gen, K, M, tile_m)
                else:
                    Wq, scales = _uniform_int8_operands(gen, K, M, tile_m)
                for mname, mask in (("zeros", np.zeros(K)),
                                    ("ones", np.ones(K)),
                                    ("random", (rng.random(K) < 0.6) * 1.0)):
                    m = torch.as_tensor(mask, dtype=torch.float32,
                                        device="cuda")
                    for sub in (False, True):
                        label = (f"K={K} tile_m={tile_m} {kind} "
                                 f"mask={mname} subtract_identity={sub}")
                        if kind == "normal":
                            err, _ = hold(A, m, Wq, scales, tile_m, sub,
                                          label)
                            worst = max(worst, err)
                            n_cases += 1
                            continue
                        r = witness(A, m, Wq, scales, tile_m, sub, label)
                        for k in ("rel_vs_plain", "kernel_f64", "plain_f64",
                                  "kernel_share", "plain_share"):
                            uni[k] = max(uni[k], r[k])
                        uni["kernel_not_worse"] += int(
                            r["kernel_f64"] <= r["plain_f64"])
                        uni["cases"] += 1
                del Wq, scales
    print(f"phase 13: {n_cases} cases on the quantizer's operands (K in 4, "
          f"8, 12, 64, 240; tile_m 128 and 512; all-zero, all-one and "
          f"random masks; subtract_identity on and off; an all-zero tile, "
          f"+-127, zero padding) within {TOL} (worst {worst:.3e}); inactive "
          f"deltas exactly 0")
    print(f"phase 13: {uni['cases']} cases on uniform int8 times uniform "
          f"scales, against float64: kernel max |err| "
          f"{uni['kernel_f64']:.3e} ({uni['kernel_share']:.3f} of the float32 "
          f"summation bound at most), plain (cuBLAS) {uni['plain_f64']:.3e} "
          f"({uni['plain_share']:.3f}); the kernel no worse than cuBLAS in "
          f"{uni['kernel_not_worse']} of {uni['cases']}; kernel vs plain "
          f"{uni['rel_vs_plain']:.3e} relative to max(1, |plain|) [{card}]")
    # the routes' edges (rows up to K = 16, passes past it) on the
    # quantizer's operands, an odd count of 512-column tiles
    routes, n_edge, edge_worst = {}, 0, 0.0
    for K in (1, 2, 3, 5, 9, 16, 17):
        A = torch.as_tensor(make_topology("erdos", K, seed=K).A,
                            dtype=torch.float32, device="cuda")
        Wq, scales = _int8_operands(gen, K, 512 * 201, 512)
        m = torch.as_tensor((rng.random(K) < 0.6) * 1.0,
                            dtype=torch.float32, device="cuda")
        for sub in (False, True):
            err, _ = hold(A, m, Wq, scales, 512, sub,
                          f"K={K} route edge subtract_identity={sub}")
            edge_worst = max(edge_worst, err)
            n_edge += 1
        routes.setdefault(dmi.route(Wq, 512), []).append(K)
        del Wq, scales
    # Wq at storage offsets 1, 2, 3 (the scalar route) and 8 (4-byte but
    # not 16-byte aligned: a vector route): bit-equal to the aligned Wq
    n_offset = 0
    for K in (8, 20):
        A = torch.as_tensor(make_topology("erdos", K, seed=K).A,
                            dtype=torch.float32, device="cuda")
        Wq, scales = _int8_operands(gen, K, 512 * 201, 512)
        m = torch.as_tensor((rng.random(K) < 0.6) * 1.0,
                            dtype=torch.float32, device="cuda")
        want = dmi.diffusion_mix_int8(A, m, Wq, scales, tile_m=512,
                                      subtract_identity=True)
        for off in (1, 2, 3, 8):
            Wm = _at_offset(Wq, off)
            label = f"K={K} Wq at storage offset {off}"
            hold(A, m, Wm, scales, 512, True, label)
            got = dmi.diffusion_mix_int8(A, m, Wm, scales, tile_m=512,
                                         subtract_identity=True)
            if not torch.equal(got, want):
                raise AssertionError(f"diffusion_mix_int8 {label}: differs "
                                     "from the aligned Wq's result")
            routes.setdefault(dmi.route(Wm, 512), []).append(f"{K}@{off}")
            n_offset += 1
        del Wq, scales, Wm, want, got
    if set(routes) != set(dmi.ROUTES):
        raise AssertionError(f"phase 13 did not cover every route: {routes}")
    print(f"phase 13: {n_edge} cases at the routes' edges (K in 1, 2, 3, 5, "
          f"9, 16, 17) within {TOL} (worst {edge_worst:.3e}); {n_offset} Wq "
          f"at storage offsets 1, 2, 3, 8 bit-equal to the aligned Wq; "
          f"routes taken: {routes}")
    # 64-bit offsets: l * M + j passes 2^31
    K, M = 8, (1 << 28) + 512
    A = torch.as_tensor(make_topology("ring", K).A, dtype=torch.float32,
                        device="cuda")
    m = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.0, 1.0], device="cuda")
    Wq, scales = _int8_operands(gen, K, M, 512)
    big, _ = hold(A, m, Wq, scales, 512, True, f"K={K} M={M}")
    del Wq, scales
    torch.cuda.empty_cache()
    print(f"phase 13: K={K} M={M} (K*M = {K * M:,} > 2^31): rel err "
          f"{big:.3e}")

    def turns(fn_new, fn_old, iters):
        """CUDA-event loops of both after two warm-up calls each, in the
        order new, old, old, new; the mean of each one's two readings."""
        for fn in (fn_new, fn_old):
            for _ in range(2):
                fn()
        a = time_ms(fn_new, iters)
        b = time_ms(fn_old, iters)
        b2 = time_ms(fn_old, iters)
        a2 = time_ms(fn_new, iters)
        return (a + a2) / 2, (b + b2) / 2, [a, a2], [b, b2]

    def mix(A, m, tile, sub=True):
        return lambda w, sc: dmi.diffusion_mix_int8(
            A, m, w, sc, tile_m=tile, subtract_identity=sub)

    # the training path's shape: K = 8 FedAvg, smollm-360m's M padded to
    # the 512-column tile, one column tile of the fused path at a time
    # with its own scales, as PallasFusedMixer.mix_int8 launches it; the
    # same values at a storage offset of 1 byte take the scalar route, the
    # one-column-a-thread design the vector routes replaced
    K, M_real = 8, full_width_M()
    tile, M, cols = int8_layout(K, M_real)
    A = torch.as_tensor(averaging_matrix(K), dtype=torch.float32,
                        device="cuda")
    m = torch.tensor([1.0] * 6 + [0.0, 1.0], device="cuda")
    tiles = [_int8_operands(gen, K, min(cols, M - a), tile)
             for a in range(0, M, cols)]
    err = max_abs = 0.0
    for Wq, sc in tiles:
        e, a = hold(A, m, Wq, sc, tile, True, f"training shape tile "
                    f"{tuple(Wq.shape)}")
        err, max_abs = max(err, e), max(max_abs, a)
    scalar = [(_at_offset(Wq, 1), sc) for Wq, sc in tiles]
    path_routes = (dmi.route(tiles[0][0], tile), dmi.route(scalar[0][0],
                                                           tile))
    if path_routes != ("rows", "scalar"):
        raise AssertionError(f"phase 13: the path tile took {path_routes}")
    f = mix(A, m, tile)
    if not torch.equal(f(*tiles[0]), f(*scalar[0])):
        raise AssertionError("phase 13: the path tile's rows and scalar "
                             "routes differ")
    torch.cuda.empty_cache()
    A_sub = masked_combination(A, m) - torch.eye(K, device="cuda")

    def combination(g, ops):
        def run():
            for Wq, sc in ops:
                g(Wq, sc)
        return run

    def composition(Wq, sc):
        C = (Wq.float().view(K, -1, tile) * sc[:, :, None]).view(K, -1)
        return A_sub.T @ C

    tile_ms, tile_scalar_ms, tile_reads, tile_scalar_reads = turns(
        lambda: f(*tiles[0]), lambda: f(*scalar[0]), 20)
    clocks = card_clocks()
    ms, scalar_ms, reads, scalar_reads = turns(
        combination(f, tiles), combination(f, scalar), 5)
    plain_tile_ms = time_ms(lambda: mix_int8_ref(
        A, m, *tiles[0], tile_m=tile, subtract_identity=True), iters=3)
    plain_ms = time_ms(combination(lambda w, sc: mix_int8_ref(
        A, m, w, sc, tile_m=tile, subtract_identity=True), tiles), iters=1)
    library_tile_ms = time_ms(lambda: composition(*tiles[0]), iters=3)
    library_ms = time_ms(combination(composition, tiles), iters=1)
    del scalar
    nbytes = K * M + 4 * K * (M // tile) + 4 * K * M + 4 * (K * K + K)
    flops = 2 * K * K * M + K * M
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / FP32_FLOPS_PER_S * 1e3
    w0 = tiles[0][0].shape[1]
    tile_bytes = 5 * K * w0 + 4 * K * (w0 // tile) + 4 * (K * K + K)
    tile_bound = tile_bytes / HBM_BYTES_PER_S * 1e3
    combo = {"ms": ms, "reads": reads, "scalar_route_ms": scalar_ms,
             "scalar_route_reads": scalar_reads, "plain_ms": plain_ms,
             "composition_ms": library_ms,
             "bound_ms": max(bound_bytes, bound_ops),
             "bound_by": ("bytes" if bound_bytes >= bound_ops
                          else "operations"),
             "share_of_bound": max(bound_bytes, bound_ops) / ms,
             "bytes": nbytes, "flops": flops,
             "bytes_per_s": nbytes / ms * 1e3}
    print(f"phase 13: training shape K={K} FedAvg, M={M_real} padded to {M} "
          f"(tile {tile}), {len(tiles)} column tiles of {cols} columns: rel "
          f"err {err:.3e}; the same values at a 1-byte storage offset take "
          f"the scalar route (one column a thread), bit-equal [{card}]")
    print(f"phase 13: one full tile ({K} x {w0}, the launch the path "
          f"makes): rows route {tile_ms:.3f} ms ({tile_reads[0]:.3f}, "
          f"{tile_reads[1]:.3f}; {tile_bytes / tile_ms / 1e6:.1f} GB/s), "
          f"{tile_bound / tile_ms:.1%} of its {tile_bound:.3f} ms byte "
          f"bound; scalar route {tile_scalar_ms:.3f} ms "
          f"({tile_scalar_reads[0]:.3f}, {tile_scalar_reads[1]:.3f}; "
          f"{tile_bound / tile_scalar_ms:.1%}); plain {plain_tile_ms:.3f} "
          f"ms, dequantize then (A_eff - I).T @ C {library_tile_ms:.3f} ms; "
          f"SM and memory clocks, temperature, power after it: {clocks} "
          f"[{card}]")
    print(f"phase 13: one combination ({len(tiles)} tiles): rows route "
          f"{ms:.3f} ms ({reads[0]:.3f}, {reads[1]:.3f}; "
          f"{combo['bytes_per_s'] / 1e9:.1f} GB/s), {combo['share_of_bound']:.1%} "
          f"of its {combo['bound_ms']:.3f} ms bound ({combo['bound_by']}: "
          f"{nbytes:,} bytes, {flops:.3e} float32 operations); scalar route "
          f"{scalar_ms:.3f} ms ({scalar_reads[0]:.3f}, {scalar_reads[1]:.3f});"
          f" plain {plain_ms:.3f} ms, dequantize then (A_eff - I).T @ C "
          f"{library_ms:.3f} ms [{card}]")
    K_path, n_tiles = K, len(tiles)
    del tiles
    torch.cuda.empty_cache()

    # where the float32 operations bound it: K = 64 and 240, M = 2^22, the
    # passes route against the scalar route on the same values
    ops_cases = {}
    for K in (64, 240):
        M = 1 << 22
        A = torch.as_tensor(make_topology("erdos", K, seed=K).A,
                            dtype=torch.float32, device="cuda")
        m = torch.as_tensor((rng.random(K) < 0.8) * 1.0,
                            dtype=torch.float32, device="cuda")
        Wq, sc = _uniform_int8_operands(gen, K, M, 512)
        Wm = _at_offset(Wq, 1)
        f = mix(A, m, 512)
        if (dmi.route(Wq, 512), dmi.route(Wm, 512)) != ("passes",
                                                        "scalar"):
            raise AssertionError(f"phase 13: K={K} took the wrong routes")
        if not torch.equal(f(Wq, sc), f(Wm, sc)):
            raise AssertionError(f"phase 13: K={K} M={M}: the passes and "
                                 "scalar routes differ")
        k_ms, s_ms, k_reads, s_reads = turns(lambda: f(Wq, sc),
                                             lambda: f(Wm, sc), 5)
        c_bytes = 5 * K * M + 4 * K * (M // 512)
        c_flops = 2 * K * K * M + K * M
        b_bytes = c_bytes / HBM_BYTES_PER_S * 1e3
        b_ops = c_flops / FP32_FLOPS_PER_S * 1e3
        bound = max(b_bytes, b_ops)
        ops_cases[K] = {"shape": [K, M], "ms": k_ms, "reads": k_reads,
                        "scalar_route_ms": s_ms, "scalar_route_reads": s_reads,
                        "bound_ms": bound, "bound_bytes_ms": b_bytes,
                        "bound_ops_ms": b_ops,
                        "bound_by": "bytes" if b_bytes >= b_ops
                        else "operations", "speedup": s_ms / k_ms}
        print(f"phase 13: K={K} M={M}: passes route {k_ms:.3f} ms "
              f"({k_reads[0]:.3f}, {k_reads[1]:.3f}), scalar route "
              f"{s_ms:.3f} ms ({s_reads[0]:.3f}, {s_reads[1]:.3f}): "
              f"{s_ms / k_ms:.2f}x; bound {bound:.3f} ms "
              f"({ops_cases[K]['bound_by']}: {c_flops:.3e} float32 "
              f"operations in {b_ops:.3f} ms, {c_bytes:,} bytes in "
              f"{b_bytes:.3f} ms), {bound / k_ms:.1%} of it [{card}]")
        if not k_ms <= s_ms:
            raise AssertionError(f"phase 13: K={K}: the passes route is "
                                 "slower than the scalar route")
        del Wq, sc, Wm
        torch.cuda.empty_cache()
    row = {"name": "diffusion_mix_int8", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/diffusion_mix_int8.cu",
           "replaces": "src/repro/kernels/diffusion_mix.py:132",
           "launches": None, "max_abs_err": max_abs,
           "ms_of": f"one full column tile ({K_path} x {w0}), the launch "
                    "the path makes",
           "ms": tile_ms, "plain_ms": plain_tile_ms, "bound_ms": tile_bound,
           "bound_by": "bytes", "library_ms": None,
           "composition_ms": library_tile_ms, "bytes": tile_bytes,
           "shape": [K_path, w0], "real_columns": M_real, "tile_m": tile,
           "column_tiles": n_tiles, "one_tile_ms": tile_ms,
           "one_tile_bound_ms": tile_bound,
           "scalar_route_ms": tile_scalar_ms, "combination": combo,
           "clocks": clocks, "ops_bound_cases": ops_cases,
           "rel_err": err, "cases": n_cases, "worst_rel_err": worst,
           "edge_cases": n_edge, "routes": routes, "big_rel_err": big,
           "uniform_witness": uni, "ptxas": ptxas,
           "ptxas_summary": ptxas_sum, "sass": sass}
    return row


def _tile_maxima(tree) -> "torch.Tensor":
    """max |x| per (agent, tile) of the fused int8 layout of ``tree``: the
    leaves concatenated and zero-padded to a multiple of the int8 tile."""
    import torch

    from repro_torch.core import mixing
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(tree)
    K = leaves[0].shape[0]
    M = sum(x[0].numel() for x in leaves)
    tile, width, cols = mixing.int8_layout(K, M)
    out = []

    def fn(x, start):
        out.append(x.view(K, -1, tile).abs().amax(dim=2))
        return ()

    mixing._tiled(leaves, fn, cols=cols, width=width, outputs=0)
    return torch.cat(out, dim=1)


#: the reference's compressed_fedavg preset (variants.compressed_fedavg):
#: FedAvg, int8 with error feedback, gamma 1 (the direct mode's default)
COMPRESSED_FEDAVG_FLAGS = ["--topology", "fedavg", "--compress", "int8",
                           "--error-feedback"]
#: its compressed_diffusion preset (variants.compressed_diffusion): ring,
#: top-k 0.1 with error feedback asked for, which diff mode drops (the
#: reference copy is the feedback), gamma 0.5 (top-k's default), T = 1
COMPRESSED_DIFFUSION_FLAGS = ["--topology", "ring", "--compress", "topk",
                              "--compress-ratio", "0.1", "--error-feedback"]




def _trace_stages(fn, stages) -> dict:
    """Run ``fn()`` once under ``torch.profiler`` (CPU and CUDA): the host
    seconds of the call (ending in a device sync), the device time and
    count of all its device events, and for each ``(stage, range)`` the
    device time of the kernels launched inside the ``record_function``
    range, summed over the range's occurrences; and the six operators of
    largest self host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [ns for _, ns in device_events(prof)]
    stage_of = {r: name for name, r in stages}
    out = {name: {"ms": 0.0, "ranges": 0} for name, _ in stages}
    for e in prof.events():
        # the range's host event: its device time sums the kernels
        # launched inside it (the device-side annotation repeats the span)
        name = stage_of.get(e.name)
        if name is not None and e.device_type == DeviceType.CPU:
            us = getattr(e, "device_time_total", None)
            out[name]["ms"] += (e.cuda_time_total if us is None else us) / 1e3
            out[name]["ranges"] += 1
    busy = sum(device) / 1e6
    # where the host time goes: the operators of largest self host time
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return {"host_s": wall, "device_ms": busy, "device_events": len(device),
            "stages": out,
            "other_ms": busy - sum(r["ms"] for r in out.values()),
            "host_top": [{"name": a.key[:60], "self_ms":
                          a.self_cpu_time_total / 1e3, "count": a.count}
                         for a in ops[:6]]}


def phase_train_int8(card: str) -> tuple[dict, dict]:
    """Phase 14a: the compressed_fedavg preset at full smollm-360m width
    through train.main with --mix pallas (every combination through
    diffusion_mix_int8), then one more combination of the trained stack:
    kernel against its plain version on the same uniforms, the eq.-20
    invariants and the EF residual's bound."""
    import torch

    from repro_torch.core import mixing
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels import diffusion_mix_int8 as dmi
    from repro_torch.kernels.ref import mix_int8_ref
    from repro_torch.tree import tree_leaves, tree_map

    K, blocks = 8, 3
    M = full_width_M()
    tiles = num_tiles(K, M, int8=True)

    def want(cfg, n_logged):
        return {"diffusion_mix_int8": tiles * blocks,
                "flash_attention": cfg.num_layers * K * (2 * blocks
                                                         + n_logged),
                "diffusion_mix": 0, "gather_mix": 0, "gather_robust_mix": 0,
                "ssd_intra_chunk": 0}

    out, row = _train_full(card, "phase 14a", ["--mix", "pallas",
                                               *COMPRESSED_FEDAVG_FLAGS],
                           blocks, want, K=K)
    state, cfg = out["state"], out["cfg"]
    row["comm"] = out["comm"]
    steady_s = min(t["block_s"] for t in out["timings"][1:])
    row["profile"] = _profile_block(
        state, cfg, K, 2, 1, 1024, steady_s, card, optimizer="sgd", mu=0.05,
        label="phase 14a", mix="pallas",
        config_kwargs={"topology": "fedavg", "compress": "int8",
                       "error_feedback": True})
    params, resid = state.params, state.comm_state
    del out, state
    torch.cuda.empty_cache()

    topo = make_topology("fedavg", K)
    A = torch.as_tensor(topo.A, dtype=torch.float32, device="cuda")
    active = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 1.0],
                          device="cuda")
    pipe = mixing.make_pipeline("pallas", topo, compress="int8",
                                error_feedback=True, device="cuda")
    target = tree_map(lambda p, e: p + e, params, resid)

    def seeded():
        return torch.Generator(device="cuda").manual_seed(1414)

    # the combination's delta and messages, kernel and plain version, from
    # the same uniforms (one seeded generator each, the same tile cut)
    reset_launches()
    t0 = time.perf_counter()
    d_k, c_k = pipe.mixer.mix_int8(target, active, A, seeded(),
                                   want_messages=True)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    n = read_launches()["diffusion_mix_int8"]
    if n != tiles:
        raise AssertionError(f"phase 14a: one combination launched "
                             f"diffusion_mix_int8 {n}x, expected {tiles}")

    def plain(A_, act, Wq, scales, *, tile_m, subtract_identity):
        return mix_int8_ref(A_, act, Wq, scales, tile_m=tile_m,
                            subtract_identity=subtract_identity)

    real = dmi.diffusion_mix_int8
    dmi.diffusion_mix_int8 = plain
    try:
        t0 = time.perf_counter()
        d_p, c_p = pipe.mixer.mix_int8(target, active, A, seeded(),
                                       want_messages=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        dmi.diffusion_mix_int8 = real
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(c_k),
                                                 tree_leaves(c_p))):
        raise AssertionError("phase 14a: the messages differ between the "
                             "kernel and the plain path")
    del c_k, c_p
    row["combine_delta_kernel_vs_plain"] = _ulp_gate(
        "phase 14a: one more combination's delta, kernel vs plain version "
        "(the same uniforms)", _sliced(d_k, d_p, _sum_floors(target, K)))
    del d_k, d_p
    torch.cuda.empty_cache()

    # one more combination under the profiler: its device time by stage
    # (a report, not a gate)
    trace = _trace_stages(lambda: pipe.mixer.mix_int8(
        target, active, A, seeded(), want_messages=True), INT8_STAGES)
    torch.cuda.empty_cache()
    kern_ms = trace["stages"]["diffusion_mix_int8"]["ms"]
    trace.update(untraced_host_s=kernel_s,
                 kernel_share_of_device=(kern_ms / trace["device_ms"]
                                         if trace["device_ms"] else None),
                 kernel_share_of_host=kern_ms / 1e3 / kernel_s)
    row["trace"] = trace
    print(f"phase 14a: one more mix_int8 traced: {trace['host_s']:.3f}s on "
          f"the host under the profiler ({kernel_s:.3f}s untraced), device "
          f"busy {trace['device_ms']:.3f} ms in {trace['device_events']} "
          f"device events [{card}]")
    for name, r in trace["stages"].items():
        print(f"  {r['ms']:9.3f} ms  {r['ranges']:5d} ranges  {name}")
    print(f"  {trace['other_ms']:9.3f} ms                outside the ranges")
    print(f"phase 14a: the device idles {1 - trace['device_ms'] / 1e3 / trace['host_s']:.1%} "
          f"of the traced call; largest self host time: "
          + "; ".join(f"{r['name']} {r['self_ms']:.1f} ms ({r['count']}x)"
                      for r in trace["host_top"]))
    if trace["device_ms"]:
        print(f"phase 14a: diffusion_mix_int8 {kern_ms:.3f} ms: "
              f"{trace['kernel_share_of_device']:.1%} of the call's device "
              f"time, {trace['kernel_share_of_host']:.1%} of its untraced "
              f"{kernel_s:.3f}s host time")
    else:
        print("phase 14a: the trace holds no device time: shares not "
              "measured")

    # the whole pipeline once: inactive agents keep parameters and residual
    # bit-equal; every active residual within 2 steps of its (agent, tile)
    t0 = time.perf_counter()
    new_params, new_resid = pipe(params, active, A, resid, seeded())
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    if not (_frozen_equal(new_params, params, active)
            and _frozen_equal(new_resid, resid, active)):
        raise AssertionError("phase 14a: inactive agents' parameters or "
                             "residual moved")
    del new_params
    # (inactive agents keep the residual of an earlier target)
    live = active > 0
    steps = _tile_maxima(target)[live]
    steps = torch.where(steps > 0, steps / 127.0, torch.ones_like(steps))
    ratio = (_tile_maxima(new_resid)[live] / steps).max().item()
    if not ratio <= 2.0:
        raise AssertionError(f"phase 14a: EF residual {ratio:.3f} "
                             "quantization steps of its tile > 2")
    row.update(combine_kernel_s=kernel_s, combine_plain_s=plain_s,
               pipeline_s=pipe_s, residual_max_steps=ratio)
    print(f"phase 14a: messages bit-equal kernel vs plain; inactive agents' "
          f"parameters and EF residual bit-equal; active agents' EF residual "
          f"at most {ratio:.3f} quantization steps of its (agent, tile) "
          f"(gate 2); "
          f"mix_int8 {kernel_s:.3f}s with the kernel ({n} launches), "
          f"{plain_s:.3f}s plain; the whole pipeline {pipe_s:.3f}s [{card}]")
    print(json.dumps({"phase": "14a", **row}))
    del params, resid, new_resid, target
    torch.cuda.empty_cache()
    return row["launches"], row


def phase_train_diff(card: str) -> tuple[dict, dict]:
    """Phase 14b: the compressed_diffusion preset at full width (ring,
    top-k 0.1, CHOCO's diff mode, gamma 0.5) through train.main with --mix
    pallas, 2 blocks; then one more combination: the reference copy moves
    for active agents only."""
    import torch

    from repro_torch.core import mixing
    from repro_torch.core.topology import make_topology
    from repro_torch.tree import tree_leaves

    K, blocks = 8, 2
    M = full_width_M()

    def want(cfg, n_logged):
        return {"diffusion_mix": num_tiles(K, M) * blocks,
                "flash_attention": cfg.num_layers * K * (blocks + n_logged),
                "diffusion_mix_int8": 0, "gather_mix": 0,
                "gather_robust_mix": 0, "ssd_intra_chunk": 0}

    out, row = _train_full(card, "phase 14b", ["--mix", "pallas",
                                               *COMPRESSED_DIFFUSION_FLAGS],
                           blocks, want, K=K, T=1)
    row["comm"] = out["comm"]
    if (out["comm"]["mode"], out["comm"]["gamma"]) != ("diff", 0.5):
        raise AssertionError(f"phase 14b: pipeline {out['comm']}")
    params, ref = out["state"].params, out["state"].comm_state
    del out
    torch.cuda.empty_cache()
    topo = make_topology("ring", K)
    pipe = mixing.make_pipeline("pallas", topo, compress="topk",
                                compress_ratio=0.1, error_feedback=True,
                                device="cuda")
    A = torch.as_tensor(topo.A, dtype=torch.float32, device="cuda")
    active = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.0, 1.0],
                          device="cuda")
    t0 = time.perf_counter()
    new_params, new_ref = pipe(params, active, A, ref)
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    if not (_frozen_equal(new_params, params, active)
            and _frozen_equal(new_ref["ref"], ref["ref"], active)):
        raise AssertionError("phase 14b: inactive agents' parameters or "
                             "reference copy moved")
    live = active > 0
    moved = [int((a[live] != b[live]).sum()) for a, b in
             zip(tree_leaves(new_ref["ref"]), tree_leaves(ref["ref"]))]
    if not all(moved):
        raise AssertionError(f"phase 14b: an active reference copy did not "
                             f"move: {moved}")
    row.update(pipeline_s=pipe_s, ref_moved_elements=sum(moved))
    print(f"phase 14b: one more combination in {pipe_s:.3f}s: the reference "
          f"copy moved at {sum(moved):,} active elements and not at all for "
          f"the inactive agents, whose parameters are bit-equal [{card}]")
    # the top-k selection of every leaf at full width: the tie rule's mask
    # (the threshold from torch.topk, then the cumsum) against torch.topk
    # alone, whose selection breaks ties in no fixed order
    from repro_torch.core.compression import _num_kept, _top_k_mask

    rule_ms = topk_ms = 0.0
    for leaf in tree_leaves(new_params):
        flat = leaf.reshape(K, -1).abs().float()
        k = _num_kept(flat.shape[1], 0.1)
        rule_ms += time_ms(lambda: _top_k_mask(flat, k), iters=3)
        topk_ms += time_ms(lambda: torch.topk(flat, k, dim=1, sorted=False),
                           iters=3)
        del flat
    row.update(topk_rule_ms=rule_ms, topk_ms=topk_ms)
    print(f"phase 14b: top-k selection of every leaf (K={K}, ratio 0.1): "
          f"the tie rule's mask {rule_ms:.3f} ms, torch.topk alone "
          f"{topk_ms:.3f} ms [{card}]")
    print(json.dumps({"phase": "14b", **row}))
    del params, ref, new_params, new_ref
    torch.cuda.empty_cache()
    return row["launches"], row


class _CompressorRecord:
    """While entered, appends each call of the port's compressor to
    ``self.calls`` (swap in a fresh list per run): (input, q, scale,
    uniforms) of every int8 quantization, (input, message) of every top-k
    leaf."""

    def __init__(self, kind: str):
        from repro_torch.core import compression

        self.kind, self.mod, self.calls = kind, compression, []

    def __enter__(self):
        mod, rec = self.mod, self
        if self.kind == "int8":
            self.real = mod.quantize_int8

            def quantize(x, axis=-1, u=None):
                q, scale = rec.real(x, axis=axis, u=u)
                rec.calls.append(tuple(t.detach().to("cpu", copy=True)
                                       for t in (x, q, scale, u)))
                return q, scale

            mod.quantize_int8 = quantize
        else:
            self.real = mod.TopK._leaf

            def leaf(comp, x):
                out = rec.real(comp, x)
                rec.calls.append((x.detach().to("cpu", copy=True),
                                  out.detach().to("cpu", copy=True)))
                return out

            mod.TopK._leaf = leaf
        return self

    def __exit__(self, *exc):
        if self.kind == "int8":
            self.mod.quantize_int8 = self.real
        else:
            self.mod.TopK._leaf = self.real


def _threshold_flips(kind, card_calls, cpu_calls, sizes, ratio, tol):
    """The coordinates where the card's message and the CPU's differ
    because a rounding (int8) or a selection (top-k) sits at its threshold
    and the inputs differ there.

    Holds the compressor inputs within ``tol``; for int8, the rounded
    values x / scale + u within a hundredth of a step of each other
    everywhere (so a flip is one step, at an integer, with the same
    uniforms); for top-k, the card's selection on the CPU's own input is
    the CPU's (ties break alike), no flip in a row whose inputs are equal,
    as many coordinates leaving each row's selection as entering it, each
    at a magnitude within twice the row's input difference of the row's
    k-th largest; the messages off the flips within ``tol``.  Returns the (K, n) flip masks per leaf (the fused
    layout's column tiles joined and split at ``sizes``), the largest
    message difference at a flip, and the largest input difference."""
    import torch

    from repro_torch.core.compression import _num_kept, _top_k_mask

    if len(card_calls) != len(cpu_calls):
        raise AssertionError("the card and the CPU compressed a different "
                             "number of times")
    masks, dc, dx = [], 0.0, 0.0
    for got, want in zip(card_calls, cpu_calls):
        K = got[0].shape[0]
        xg, xc = (t[0].reshape(K, -1).double() for t in (got, want))
        dx = max(dx, (xg - xc).abs().max().item())
        if kind == "int8":
            vg, vc = ((t[0].double() / t[2].double() + t[3].double())
                      .reshape(K, -1) for t in (got, want))
            if not (vg - vc).abs().max().item() <= 1e-2:
                raise AssertionError("the rounded int8 values differ by "
                                     "more than 1e-2 step")
            flip = got[1].reshape(K, -1) != want[1].reshape(K, -1)
            cg, cc = ((t[1] * t[2]).reshape(K, -1).double()
                      for t in (got, want))
        else:
            cg, cc = (t[1].reshape(K, -1).double() for t in (got, want))
            flip = (cg != 0) != (cc != 0)
            k = _num_kept(xc.shape[1], ratio)
            # ties break alike on both devices: the card's selection on the
            # CPU's input is the CPU's, and a row whose inputs are equal
            # flips nowhere
            x0 = want[0].reshape(K, -1)
            own = _top_k_mask(x0.cuda().abs().float(), k).cpu()
            if not torch.equal(x0 * own.to(x0.dtype), want[1].reshape(K, -1)):
                raise AssertionError("the card's top-k on the CPU's input "
                                     "differs from the CPU's")
            if bool(flip[(xg == xc).all(1)].any()):
                raise AssertionError("a top-k flip in a row whose inputs "
                                     "are equal")
            thr = xc.abs().topk(k, dim=1).values[:, -1:]
            room = 2 * (xg - xc).abs().amax(dim=1, keepdim=True)
            if not bool(((xc.abs() - thr).abs() <= room + 1e-12)[flip]
                        .all()):
                raise AssertionError("a top-k flip away from the threshold")
            if not torch.equal((flip & (cg != 0)).sum(1),
                               (flip & (cc != 0)).sum(1)):
                raise AssertionError("top-k kept different counts")
        d = (cg - cc).abs()
        if not d[~flip].max().item() <= tol:
            raise AssertionError(f"messages off the flips differ by "
                                 f"{d[~flip].max().item():.3e}")
        if flip.any():
            dc = max(dc, d[flip].max().item())
        masks.append(flip)
    if kind == "int8" and len(masks) != len(sizes):  # the fused layout
        joined = torch.cat(masks, dim=1)[:, :sum(sizes)]
        masks = list(torch.split(joined, sizes, dim=1))
    if not dx <= tol:
        raise AssertionError(f"compressor inputs differ by {dx:.3e} > {tol}")
    return masks, dc, dx


def _lockstep_compressed(name: str, preset: dict, K: int = 8,
                         blocks: int = 3, T: int = 2, mu: float = 0.05,
                         tol: float = 1e-4) -> dict:
    """One compressed preset at smoke size, card against CPU, block by
    block from the CPU's state: the engine as train.main builds it (SGD,
    q = 0.9, ``use_kernels=True``, --mix pallas), every block's batch and
    mask from one host generator, the fused path's rounding uniforms drawn
    on the host from a second one and injected into both.

    Both devices' compressor calls are recorded and every threshold flip
    accounted for (:func:`_threshold_flips`).  Gate, phase 6's: every
    parameter and state entry within ``tol`` of the CPU's, except at a
    flipped coordinate of its own or a neighbor's message, where it is
    within 2 gamma times the largest message difference at a flip plus
    ``tol``; the per-agent losses within 1e-4 relative in a block without
    a flip, and in a block with one, once the flip-reached coordinates take
    the CPU's values."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.compression import Draws
    from repro_torch.core.diffusion import DiffusionConfig, DiffusionEngine
    from repro_torch.core.mixing import int8_layout
    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.launch.train import init_stacked
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    cfg = dataclasses.replace(get_config("smollm-360m").smoke,
                              use_kernels=True)
    kind = preset["compress"]

    def loss(p, b):
        return tf.train_loss(p, cfg, b, remat=False)

    def agent_losses(p, batch):
        with torch.no_grad():
            return [loss(tree_map(lambda x, k=k: x[k], p),
                         tree_map(lambda x, k=k: x[0, k], batch)).item()
                    for k in range(K)]

    dcfg = DiffusionConfig(num_agents=K, local_steps=T, step_size=mu,
                           participation=0.9, mix="pallas", **preset)
    eng = {dev: DiffusionEngine(dcfg, loss, device=dev)
           for dev in ("cpu", "cuda")}
    gamma = eng["cpu"].pipeline.gamma
    sup = ((torch.as_tensor(eng["cpu"].topology.A) != 0)
           | torch.eye(K, dtype=torch.bool)).double()
    key = torch.Generator().manual_seed(0)
    draw = torch.Generator().manual_seed(1)
    params = init_stacked(key, cfg, K, torch.device("cpu"))
    sizes = [x[0].numel() for x in tree_leaves(params)]
    width = int8_layout(K, sum(sizes))[1]
    state = eng["cpu"].init_state(params, None, key=key)
    out = {"flips": 0, "reached": 0, "far": 0, "max_abs": 0.0,
           "max_input_diff": 0.0, "loss_rel_no_flip": 0.0,
           "loss_rel_flip_raw": 0.0, "loss_rel_flip_patched": 0.0,
           "blocks_with_flips": 0, "blocks": blocks,
           "flips_by_leaf": [0] * len(sizes)}
    for _ in range(blocks):
        batch = lm_token_batch(key, (T, K, 2, 64), cfg.vocab_size)
        draws = (Draws(u=torch.rand((K, width), generator=draw))
                 if kind == "int8" else None)
        start = state.replace(params=tree_map(
            lambda x: x.to("cuda"), state.params), comm_state=tree_map(
            lambda x: x.to("cuda"), state.comm_state))
        with _CompressorRecord(kind) as rec:
            state, met = eng["cpu"].step(state, batch, key, comm_key=draws)
            cpu_calls, rec.calls = rec.calls, []
            card, _ = eng["cuda"].step(
                start, tree_map(lambda x: x.to("cuda"), batch),
                torch.Generator(), active=met["active"], comm_key=draws)
            card_calls = rec.calls
        masks, dc, dx = _threshold_flips(
            kind, card_calls, cpu_calls, sizes,
            preset.get("compress_ratio", 1.0), tol)
        reach = [(sup.T @ f.double()) > 0 for f in masks]
        n_flips = sum(int(f.sum()) for f in masks)
        for i, f in enumerate(masks):
            out["flips_by_leaf"][i] += int(f.sum())
        got = tree_leaves(card.params) + tree_leaves(card.comm_state)
        want = tree_leaves(state.params) + tree_leaves(state.comm_state)
        if len(got) != len(want) or len(want) % len(masks):
            raise AssertionError(f"phase 14c {name}: the states differ in "
                                 "structure")
        patched = []
        for j, (g, w) in enumerate(zip(got, want)):
            g = g.cpu()
            near = reach[j % len(masks)].reshape(g.shape)
            d = (g.double() - w.double()).abs()
            far = d > tol
            stray = int((far & ~near).sum())
            if stray:
                raise AssertionError(f"phase 14c {name}: {stray} entries "
                                     f"beyond {tol} away from every flip")
            if not d.max().item() <= 2 * gamma * dc + tol:
                raise AssertionError(f"phase 14c {name}: an entry moved "
                                     f"{d.max().item():.3e} > 2 gamma "
                                     f"{dc:.3e} + {tol}")
            out["far"] += int(far.sum())
            out["max_abs"] = max(out["max_abs"], d.max().item())
            if j < len(masks):
                patched.append(torch.where(near, w, g))
            out["reached"] += int(near.sum()) if j < len(masks) else 0
        losses_cpu = agent_losses(state.params, batch)
        raw = float(np.max(np.abs(np.subtract(
            agent_losses(card.params, tree_map(lambda x: x.to("cuda"),
                                               batch)), losses_cpu))
            / np.abs(losses_cpu)))
        out["flips"] += n_flips
        out["max_input_diff"] = max(out["max_input_diff"], dx)
        if n_flips:
            fixed = tree_map(lambda x: x.to("cuda"),
                             tree_unflatten(state.params, patched))
            rel = float(np.max(np.abs(np.subtract(agent_losses(
                fixed, tree_map(lambda x: x.to("cuda"), batch)),
                losses_cpu)) / np.abs(losses_cpu)))
            out["blocks_with_flips"] += 1
            out["loss_rel_flip_raw"] = max(out["loss_rel_flip_raw"], raw)
            out["loss_rel_flip_patched"] = max(
                out["loss_rel_flip_patched"], rel)
        else:
            rel = raw
            out["loss_rel_no_flip"] = max(out["loss_rel_no_flip"], raw)
        if not rel <= 1e-4:
            raise AssertionError(f"phase 14c {name}: losses {rel:.3e} "
                                 "relative > 1e-4")
        del card, start
    return out


def phase_compressed_devices() -> dict:
    """Phase 14c: both presets at smoke size (K = 8), card against CPU
    block by block with the same injected draws, every threshold flip
    accounted for (:func:`_lockstep_compressed`)."""
    presets = {"compressed_fedavg": {"topology": "fedavg",
                                     "compress": "int8",
                                     "error_feedback": True},
               "compressed_diffusion": {"topology": "ring",
                                        "compress": "topk",
                                        "compress_ratio": 0.1,
                                        "error_feedback": True}}
    rows = {}
    for name, preset in presets.items():
        T = 2 if preset["compress"] == "int8" else 1
        r = _lockstep_compressed(name, preset, T=T)
        print(f"phase 14c: {name} smoke K=8, {r['blocks']} blocks, card vs "
              f"CPU from the same state: {r['flips']} threshold flips in "
              f"{r['blocks_with_flips']} blocks reaching {r['reached']} "
              f"weights; {r['far']} entries beyond 1e-4, all at those; max "
              f"|diff| {r['max_abs']:.2e}; compressor inputs within "
              f"{r['max_input_diff']:.2e}; losses rel "
              f"{r['loss_rel_no_flip']:.2e} in blocks without a flip, "
              f"{r['loss_rel_flip_raw']:.2e} "
              f"with one ({r['loss_rel_flip_patched']:.2e} once the reached "
              f"weights take the CPU's values; gate 1e-4)")
        print(f"phase 14c: {name} flips by leaf (leaf: count): "
              + ", ".join(f"{i}: {n}" for i, n in
                          enumerate(r["flips_by_leaf"]) if n))
        rows[name] = r
    return rows


def phase_consensus_int8(path: str, card: str) -> dict:
    """Phase 15: phase 3's K = 8 bf16 stack collapsed through serve.main
    with --consensus-quantize int8 and --mix pallas: the reference's gate
    against the float32-path consensus, two runs bit-equal, then prefill
    and 32 greedy decode steps."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.tree import tree_leaves

    cfg = get_config("smollm-360m").model
    K, M = 8, full_width_M()
    argv = ["--arch", "smollm-360m", "--full", "--agents", str(K),
            "--checkpoint", path, "--batch", "4", "--prompt-len", "128",
            "--decode", "32", "--temperature", "0", "--mix", "pallas"]
    plain = serve.main(argv)
    reset_launches()
    first = serve.main(argv + ["--consensus-quantize", "int8"])
    launches = read_launches()
    want = {n: 0 for n in launches}
    want["diffusion_mix"] = num_tiles(K, M)
    if launches != want:
        raise AssertionError(f"phase 15: launches {launches}, expected "
                             f"{want}")
    second = serve.main(argv + ["--consensus-quantize", "int8"])
    if not all(torch.equal(a, b) for a, b in
               zip(tree_leaves(first["params"]),
                   tree_leaves(second["params"]))):
        raise AssertionError("phase 15: two int8 runs with one seed differ")
    sq_err = sq_ref = 0.0
    for a, b in zip(tree_leaves(plain["params"]),
                    tree_leaves(first["params"])):
        a, b = a.double(), b.double()
        sq_err += float(((a - b) ** 2).sum())
        sq_ref += float((a ** 2).sum())
    rel = sq_err / sq_ref
    if not rel < 1e-3:
        raise AssertionError(f"phase 15: int8 consensus relative squared "
                             f"error {rel:.3e} >= 1e-3")
    toks = first["tokens"]
    if (toks.shape != (4, 32) or toks.min() < 0
            or toks.max() >= cfg.vocab_size
            or not torch.isfinite(first["prefill_logits"]).all()
            or not torch.equal(toks, second["tokens"])):
        raise AssertionError(f"phase 15: bad tokens {toks}")
    row = {"launches": launches, "rel_sq_err": rel,
           "timings": first["timings"], "timings_again": second["timings"],
           "timings_float": plain["timings"],
           "tokens_per_s": first["tokens_per_s"], "card": card}
    print(f"phase 15: --consensus-quantize int8 --mix pallas: relative "
          f"squared error against the stored-stack consensus {rel:.3e} "
          f"(gate 1e-3); two runs bit-equal; consensus "
          f"{first['timings']['consensus_s']:.3f}s (stored stack "
          f"{plain['timings']['consensus_s']:.3f}s), prefill "
          f"{first['timings']['prefill_s']:.3f}s, decode "
          f"{first['tokens_per_s']:.1f} tokens/s; launches {launches}; "
          f"tokens in the vocabulary [{card}]")
    print(json.dumps({"phase": "15", **row}))
    del plain, first, second
    torch.cuda.empty_cache()
    return launches


#: phase 16's full-width runs: the time-varying graph and the availability
#: process of each
LINK_DROPOUT_MARKOV_FLAGS = ["--mix", "pallas", "--graph", "link_dropout",
                             "--link-drop", "0.3", "--participation-process",
                             "markov", "--markov-corr", "0.5"]
TV_ERDOS_CYCLIC_FLAGS = ["--graph", "tv_erdos", "--graph-p", "0.3", "--mix",
                         "auto", "--participation-process", "cyclic",
                         "--num-groups", "2"]


def _check_graphs(label: str, graphs, topo=None) -> None:
    """Every realized A_t is symmetric, doubly stochastic and nonnegative
    (within 1e-6), and zero off the base support when ``topo`` is given."""
    import numpy as np

    for i, A in enumerate(graphs):
        A = A.double().numpy()
        ok = (np.abs(A - A.T).max() <= 1e-6
              and np.abs(A.sum(axis=0) - 1.0).max() <= 1e-6
              and A.min() >= 0.0)
        if topo is not None:
            ok = ok and not A[~topo.adjacency].any()
        if not ok:
            raise AssertionError(f"{label}: the realized A_t of block {i} is "
                                 f"not a valid combination matrix: {A}")


def _graph_launches(K: int, M: int, blocks: int):
    """Launch counts of a full-width run whose combination goes through
    ``diffusion_mix``, for :func:`_train_full`."""
    def want(cfg, n_logged):
        return {"diffusion_mix": num_tiles(K, M) * blocks,
                "flash_attention": cfg.num_layers * K * (2 * blocks
                                                         + n_logged),
                "gather_mix": 0, "gather_robust_mix": 0,
                "ssd_intra_chunk": 0, "diffusion_mix_int8": 0}
    return want


def phase_train_link_dropout(card: str) -> tuple[dict, dict]:
    """Phase 16a: full-width smollm-360m, K = 8 ring, under link dropout
    and Markov availability, every combination through ``diffusion_mix``;
    a profiled block; then one combination of the trained stack under a realized A_t with a
    dropped link, kernel against the dense mixer."""
    import torch

    from repro_torch.core.graphs import LinkDropout
    from repro_torch.core.mixing import DenseMixer, make_mixer
    from repro_torch.core.schedules import MarkovAvailability
    from repro_torch.core.topology import make_topology
    from repro_torch.tree import tree_leaves

    K, blocks = 8, 2
    M = full_width_M()
    out, row = _train_full(card, "phase 16a", LINK_DROPOUT_MARKOV_FLAGS,
                           blocks, _graph_launches(K, M, blocks), K=K)
    row["profile"] = _profile_block(
        out["state"], out["cfg"], K, 2, 1, 1024,
        min(t["block_s"] for t in out["timings"][1:]), card,
        optimizer="sgd", mu=0.05, label="phase 16a",
        config_kwargs={"graph": "link_dropout",
                       "graph_kwargs": (("drop", 0.3),)},
        engine_kwargs={"participation": MarkovAvailability(
            0.9, 0.5, num_agents=K)})
    topo = make_topology("ring", K)
    _check_graphs("phase 16a", out["graphs"], topo)
    edges = int((topo.adjacency & ~torch.eye(K, dtype=bool).numpy()).sum())

    def live(A):
        return int(((A > 0) & ~torch.eye(K, dtype=bool)).sum())

    dropped = [A for A in out["graphs"] if live(A) < edges]
    key = torch.Generator().manual_seed(1)
    while not dropped:
        A, _ = LinkDropout(topo, 0.3).sample((), key)
        dropped = [A] if live(A) < edges else []
    A_t = dropped[0].cuda()
    row["realized_links"] = [live(A) // 2 for A in out["graphs"]]
    params = out["state"].params
    del out
    torch.cuda.empty_cache()
    active = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 1.0],
                          device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    got = make_mixer("pallas", topo, device="cuda")(params, active, A_t)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    n = read_launches()["diffusion_mix"]
    if n != num_tiles(K, M):
        raise AssertionError(f"phase 16a: one combination launched "
                             f"diffusion_mix {n}x")

    def dense():
        # the float32 widening in column slices, rounded once (phase 11b)
        width = CHECK_SLICE // K
        for g, p, floor in zip(tree_leaves(got), tree_leaves(params),
                               _sum_floors(params, 3)):
            g, p = g.reshape(K, -1), p.reshape(K, -1)
            for a in range(0, p.shape[1], width):
                want = DenseMixer()({"x": p[:, a:a + width].float()},
                                    active, A_t)["x"]
                yield g[:, a:a + width], want.to(torch.bfloat16), floor

    row["combine_kernel_vs_dense"] = _ulp_gate(
        "phase 16a: one combination under a realized A_t with "
        f"{edges // 2 - live(A_t.cpu()) // 2} dropped link(s), kernel vs "
        "dense", dense())
    if not _frozen_equal(got, params, active):
        raise AssertionError("phase 16a: inactive agents not kept exactly")
    row["combine_kernel_s"] = kernel_s
    print(f"phase 16a: inactive agents bit-equal; realized links per block "
          f"{row['realized_links']} of {edges // 2}; that combination took "
          f"{kernel_s:.3f}s ({n} launches) [{card}]")
    print(json.dumps({"phase": "16a", **row}))
    del params, got
    torch.cuda.empty_cache()
    return row["launches"], row


def phase_train_tv_erdos(card: str) -> tuple[dict, dict]:
    """Phase 16b: the same model under a fresh Erdős–Rényi graph a block
    and cyclic availability, ``--mix auto`` (the kernel mixer on CUDA)."""
    import torch

    K, blocks = 8, 2
    M = full_width_M()
    out, row = _train_full(card, "phase 16b", TV_ERDOS_CYCLIC_FLAGS, blocks,
                           _graph_launches(K, M, blocks), K=K)
    _check_graphs("phase 16b", out["graphs"])
    groups = [[float(k % 2 == g) for k in range(K)] for g in (0, 1)]
    want = [groups[i % 2] for i in range(blocks)]
    if out["active"] != want:
        raise AssertionError(f"phase 16b: cyclic masks {out['active']}, "
                             f"expected {want}")
    row["realized_links"] = [
        int(((A > 0) & ~torch.eye(K, dtype=bool)).sum()) // 2
        for A in out["graphs"]]
    print(f"phase 16b: masks alternate the two groups; realized links per "
          f"block {row['realized_links']} of {K * (K - 1) // 2} [{card}]")
    print(json.dumps({"phase": "16b", **row}))
    del out
    torch.cuda.empty_cache()
    return row["launches"], row


#: phase 16c: (graph flags, mixer flags) at smoke size, card against CPU,
#: each under the availability process beside it
_ON_SUPPORT_MIXERS = (["--mix", "pallas"], ["--mix", "sparse"],
                      ["--mix", "gather"],
                      ["--mix", "trimmed_mean", "--trim", "1",
                       "--robust-scope", "neighborhood", "--robust-gather",
                       "fused"])
_PROCESSES = ([], ["--participation-process", "markov", "--markov-corr",
                   "0.5"],
              ["--participation-process", "cyclic", "--num-groups", "2"])
GRAPH_DEVICE_CASES = [
    (graph, mixer, _PROCESSES[(i + j) % 3])
    for i, graph in enumerate((["--graph", "link_dropout", "--link-drop",
                                "0.3"],
                               ["--graph", "link_dropout", "--link-drop",
                                "0.3", "--graph-corr", "0.6"],
                               ["--graph", "gossip"]))
    for j, mixer in enumerate(_ON_SUPPORT_MIXERS)] + [
    (["--graph", "tv_erdos", "--graph-p", "0.3"], ["--mix", "pallas"],
     _PROCESSES[1]),
    (["--graph", "tv_erdos", "--graph-p", "0.3"], ["--mix", "pallas"],
     _PROCESSES[2])]


def phase_graph_devices() -> None:
    """Phase 16c: every graph kind, mixer and process at smoke size, card
    against CPU from one host generator (phase 6's gates, the realized
    masks and matrices equal)."""
    for graph, mixer, process in GRAPH_DEVICE_CASES:
        phase_train_devices(label="phase 16c", agents=6,
                            mix=tuple(graph + mixer + process),
                            optimizers=(("sgd", 0.05),))


def _regression_engine(data, cfg, device):
    from repro_torch.core.diffusion import DiffusionEngine

    return DiffusionEngine(cfg, data.loss_fn(), device=device,
                           grad_fn=data.grad_fn())


def _steady_msd(data, cfg, w_opt, blocks: int, tail: int, reps: int,
                device: str) -> tuple[float, float, dict]:
    """Algorithm 1 on the regression through the engine's ``run`` (the
    draws from one host generator a repetition, seeds 0..reps-1): the mean
    over repetitions of the MSD averaged over the last ``tail`` blocks,
    microseconds per block, and the launch counts of the runs."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import make_block_sampler

    eng = _regression_engine(data, cfg, device)
    sampler = make_block_sampler(data, T=cfg.local_steps, batch=1,
                                 device=device)
    w_star = torch.as_tensor(w_opt, dtype=torch.float32, device=device)
    msds = []
    reset_launches()
    t0 = time.perf_counter()
    for rep in range(reps):
        _, _, hist = eng.run(torch.zeros(cfg.num_agents, 2, device=device),
                             sampler, blocks, seed=rep, w_star=w_star)
        msds.append(float(np.mean(hist[-tail:])))
    us = (time.perf_counter() - t0) / (reps * blocks) * 1e6
    return float(np.mean(msds)), us, read_launches()


def _profile_regression(data, cfg, blocks: int, card: str, *, eng=None,
                        opt_init=None, label: str = "phase 17b") -> dict:
    """``blocks`` blocks of the regression on the card under
    ``torch.profiler`` (through ``eng``, whose optimizer state
    ``opt_init(params)`` makes, if given): the device time of their kernels
    against the host clock around them (the device's busy share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import make_block_sampler

    if eng is None:
        eng = _regression_engine(data, cfg, "cuda")
    sampler = make_block_sampler(data, T=cfg.local_steps, device="cuda")
    key = torch.Generator().manual_seed(9)
    w0 = torch.zeros(cfg.num_agents, 2, device="cuda")
    state = eng.init_state(w0, None if opt_init is None else opt_init(w0))
    state, _ = eng.step(state, sampler(key), key)          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(blocks):
            state, _ = eng.step(state, sampler(key), key)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = list(device_events(prof))
    busy = sum(ns for _, ns in events) / 1e9
    out = {"blocks": blocks, "wall_s": wall, "device_busy_s": busy,
           "device_busy_share": busy / wall,
           "device_events_per_block": len(events) / blocks}
    print(f"{label}: {blocks} profiled blocks: kernels busy "
          f"{1e3 * busy:.2f} ms of {1e3 * wall:.2f} ms on the host clock "
          f"({100 * busy / wall:.1f} % busy), {len(events) / blocks:.0f} "
          f"device events a block [{card}]")
    return out


def _want_mix(device: str, n: int) -> dict:
    counts = dict.fromkeys(kernel_wrappers(), 0)
    counts["diffusion_mix"] = n if device == "cuda" else 0
    return counts


def phase_regression(card: str, device: str = "cuda") -> tuple[dict, dict]:
    """Phase 17: the paper's §VII regression at its published size (K =
    20, N = 100, M = 2, mu = 0.01, rho = 0.1, T = 5, erdos) with ``--mix
    pallas``: one ``diffusion_mix`` launch a block.  (a) card against CPU;
    (b) Fig. 5, the steady MSD against Theorem 5; (c) Fig. 6's ordering
    in q; (d) the dynamic-graph law under link dropout."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import paper_regression as paper
    from repro_torch.core import msd
    from repro_torch.core.diffusion import DiffusionConfig
    from repro_torch.core.graphs import make_graph_process
    from repro_torch.data.synthetic import (make_block_sampler,
                                            make_regression_problem)

    row = {"card": card}
    data = make_regression_problem(K=paper.K, N=paper.N, M=paper.M,
                                   rho=paper.RHO, seed=0)
    # (a) 100 blocks, card against CPU under the same host draws
    blocks = 100
    cfg = dataclasses.replace(paper.diffusion_config(), mix="pallas")
    runs = []                     # (engine, sampler, generator, state)
    for dev in (device, "cpu"):
        eng = _regression_engine(data, cfg, dev)
        runs.append([eng, make_block_sampler(data, T=paper.T, device=dev),
                     torch.Generator().manual_seed(5),
                     eng.init_state(torch.zeros(paper.K, paper.M,
                                                device=dev))])
    worst = 0.0
    reset_launches()
    for i in range(blocks):
        for run in runs:
            eng, sampler, key, state = run
            run[3], _ = eng.step(state, sampler(key), key)
        want = runs[1][3].params
        got = runs[0][3].params.cpu()
        worst = max(worst, ((got - want).abs() / (1 + want.abs()))
                    .max().item())
    launches = read_launches()
    if launches != _want_mix(device, blocks):
        raise AssertionError(f"phase 17a: launches {launches}")
    if not worst <= TOL:
        raise AssertionError(f"phase 17a: card vs CPU {worst:.3e} > "
                             f"{TOL:g} (1 + |w|)")
    row["replay"] = {"blocks": blocks, "worst": worst, "launches": launches}
    print(f"phase 17a: {blocks} blocks, card vs CPU within {worst:.2e} "
          f"(1 + |w|) (gate {TOL:g}); launches {launches}")
    del runs

    # (b) Fig. 5: random q, Theorem 5 with 300 mask samples
    q = np.random.default_rng(1).uniform(0.2, 0.95, paper.K)
    cfg5 = DiffusionConfig(num_agents=paper.K, local_steps=paper.T,
                           step_size=paper.MU, topology="erdos",
                           participation=tuple(q), mix="pallas")
    t0 = time.perf_counter()
    th = msd.theoretical_msd(data.problem(), A=cfg5.make_topology().A, q=q,
                             mu=paper.MU, T=paper.T, num_mask_samples=300)
    theory_s = time.perf_counter() - t0
    reps, blocks = 3, 4000
    sim, us, launches = _steady_msd(data, cfg5, th["w_opt"], blocks,
                                    blocks // 4, reps, device)
    ratio = sim / th["msd"]
    if launches != _want_mix(device, reps * blocks):
        raise AssertionError(f"phase 17b: launches {launches}")
    row["fig5"] = {"sim": sim, "theory": th["msd"], "ratio": ratio,
                   "us_per_block": us, "rho_EFF": th["rho_EFF"],
                   "theory_s": theory_s, "reps": reps, "blocks": blocks,
                   "launches": launches}
    print(f"phase 17b: Fig. 5, {reps} x {blocks} blocks ({us:.1f} us a "
          f"block): steady MSD {sim:.4e}, Theorem 5 {th['msd']:.4e} "
          f"({theory_s:.1f}s), sim/theory {ratio:.3f} (band 0.8-1.2); "
          f"launches {launches}")
    if not abs(ratio - 1.0) < 0.20:
        raise AssertionError("phase 17b: simulation outside 20 % of "
                             "Theorem 5")
    if device == "cuda":
        row["fig5"]["profile"] = _profile_regression(data, cfg5, 200, card)

    # (c) Fig. 6: higher activation probability, smaller MSD (T = 1)
    fig6 = {}
    reps, blocks = 3, 2500
    for qv in (0.1, 0.5, 0.9):
        cfg6 = DiffusionConfig(num_agents=paper.K, local_steps=1,
                               step_size=paper.MU, topology="erdos",
                               participation=qv, mix="pallas")
        qq = np.full(paper.K, qv)
        w_o = data.problem().w_opt(qq)
        sim6, us6, launches = _steady_msd(data, cfg6, w_o, blocks,
                                          blocks // 4, reps, device)
        if launches != _want_mix(device, reps * blocks):
            raise AssertionError(f"phase 17c: launches {launches}")
        th6 = msd.theoretical_msd(data.problem(), A=cfg6.make_topology().A,
                                  q=qq, mu=paper.MU, T=1,
                                  num_mask_samples=200)["msd"]
        fig6[qv] = {"sim": sim6, "theory": th6, "ratio": sim6 / th6,
                    "us_per_block": us6}
        print(f"phase 17c: Fig. 6, q = {qv}: steady MSD {sim6:.4e}, "
              f"Theorem 5 {th6:.4e}, sim/theory {sim6 / th6:.3f} "
              f"({us6:.1f} us a block)")
    row["fig6"] = fig6
    if not fig6[0.1]["sim"] > fig6[0.5]["sim"] > fig6[0.9]["sim"]:
        raise AssertionError("phase 17c: the steady MSD does not fall as q "
                             "rises")

    # (d) Theorem 5 over the realized-matrix law of link dropout
    K, T, mu, drop = 6, 2, 0.01, 0.3
    dyn = make_regression_problem(K=K, N=80, M=2, rho=0.1, seed=7)
    cfgd = DiffusionConfig(num_agents=K, local_steps=T, step_size=mu,
                           topology="ring", participation=0.9,
                           graph="link_dropout",
                           graph_kwargs=(("drop", drop),), mix="pallas")
    topo = cfgd.make_topology()
    qd = np.full(K, 0.9)
    g = make_graph_process("link_dropout", topo, drop=drop)
    th_dyn = msd.theoretical_msd(dyn.problem(), graph=g, q=qd, mu=mu, T=T)
    th_sta = msd.theoretical_msd(dyn.problem(), A=topo.A, q=qd, mu=mu, T=T)
    reps, blocks = 3, 2500
    simd, usd, launches = _steady_msd(dyn, cfgd, th_dyn["w_opt"], blocks,
                                      600, reps, device)
    if launches != _want_mix(device, reps * blocks):
        raise AssertionError(f"phase 17d: launches {launches}")
    rel_dyn = abs(simd - th_dyn["msd"]) / simd
    rel_sta = abs(simd - th_sta["msd"]) / simd
    row["dynamic"] = {"sim": simd, "theory_dynamic": th_dyn["msd"],
                      "theory_static": th_sta["msd"], "rel_dynamic": rel_dyn,
                      "rel_static": rel_sta, "us_per_block": usd,
                      "launches": launches}
    print(f"phase 17d: link dropout 0.3, K = 6 ring, {reps} x {blocks} "
          f"blocks ({usd:.1f} us a block): steady MSD {simd:.4e}, dynamic "
          f"law {th_dyn['msd']:.4e} (off {rel_dyn:.3f}, band 0.15), static "
          f"law {th_sta['msd']:.4e} (off {rel_sta:.3f})")
    if not (rel_dyn < 0.15 and rel_dyn < rel_sta):
        raise AssertionError("phase 17d: the dynamic law misses the "
                             "simulation")
    print(json.dumps({"phase": "17", **row}))
    return row["fig5"]["launches"], row


PRIVATE_DIRICHLET_FLAGS = ["--mix", "pallas", "--privacy", "--privacy-epsilon",
                           "8", "--privacy-delta", "1e-5", "--privacy-clip",
                           "1.0", "--data", "dirichlet", "--data-alpha", "0.3",
                           "--data-clusters", "4"]
PRIVATE_SECURE_AGG_FLAGS = ["--mix", "pallas", "--privacy",
                            "--privacy-epsilon", "8", "--privacy-secure-agg",
                            "--data", "shards", "--data-shards", "2"]
#: a bound on |eta| over every mask a full-width combination draws (2.3e10
#: standard normals; P(|N(0,1)| > 8) = 1.2e-15)
MASK_BOUND = 8.0


def _private_launches(K: int, M: int, mixed: bool):
    """Launch counts of a full-width private run of ``n_logged`` blocks
    (every block is logged; the budget halt may stop the run early):
    ``diffusion_mix`` one per tile a block unless the secure-agg stage
    takes the combination."""
    def want(cfg, n_logged):
        return {"diffusion_mix": num_tiles(K, M) * n_logged if mixed else 0,
                "flash_attention": cfg.num_layers * K * 3 * n_logged,
                "gather_mix": 0, "gather_robust_mix": 0,
                "ssd_intra_chunk": 0, "diffusion_mix_int8": 0}
    return want


def _check_accountant(label: str, out: dict, blocks: int) -> dict:
    """The logged epsilon against the numpy twins over the realized masks
    (T x the increment a block), never falling; and the budget halt: a run
    shorter than ``blocks`` is one whose next block the stationary rate
    projected past the budget, and a full run never was."""
    import numpy as np

    from repro_torch.core.privacy import epsilon_from_rdp_np, rdp_increment_np

    p = out["privacy"]
    rdp = np.zeros(len(p.orders))
    want = []
    for active in out["active"]:
        rdp = rdp + p.steps_per_block * rdp_increment_np(
            float(np.mean(active)), p.noise_multiplier, p.orders)
        want.append(epsilon_from_rdp_np(rdp, p.delta, p.orders))
    got = out["epsilon"]
    # the reference's gate for the float32 accountant
    if len(got) != out["blocks_done"] or any(
            abs(g - w) > 1e-6 + 2e-4 * abs(w) for g, w in zip(got, want)):
        raise AssertionError(f"{label}: logged epsilon {got}, the realized "
                             f"masks give {want}")
    if any(b < a for a, b in zip(got, got[1:])):
        raise AssertionError(f"{label}: epsilon fell: {got}")
    # the halt: each block run was projected (the stationary rate's
    # increment on the spend before it) within the budget, and a run cut
    # short stopped at a block projected past it
    inc_bar = p.steps_per_block * rdp_increment_np(0.9, p.noise_multiplier,
                                                   p.orders)
    rdp = np.zeros(len(p.orders))
    projected = []
    for active in out["active"] + [None]:
        projected.append(epsilon_from_rdp_np(rdp + inc_bar, p.delta,
                                             p.orders))
        if active is not None:
            rdp = rdp + p.steps_per_block * rdp_increment_np(
                float(np.mean(active)), p.noise_multiplier, p.orders)
    ran = out["blocks_done"]
    if (any(x > p.epsilon_budget for x in projected[:ran])
            or (ran < blocks and projected[ran] <= p.epsilon_budget
                and want[-1] < p.epsilon_budget)):
        raise AssertionError(f"{label}: {ran} of {blocks} blocks run, "
                             f"projections {projected} against the budget "
                             f"{p.epsilon_budget}")
    projected = projected[ran]
    print(f"{label}: sigma {p.noise_multiplier:.6f} (calibrated to epsilon "
          f"{p.epsilon_budget:g} over {blocks} x {p.steps_per_block} "
          f"invocations at q = 0.9); realized rates "
          f"{[float(np.mean(a)) for a in out['active']]}; epsilon "
          f"{[round(e, 4) for e in got]} against the numpy twins "
          f"{[round(e, 4) for e in want]}; {out['blocks_done']} of {blocks} "
          f"blocks run (the next projected to {projected:.3f})")
    return {"noise_multiplier": p.noise_multiplier, "epsilon": got,
            "epsilon_numpy": want, "blocks_done": out["blocks_done"],
            "projected_next": projected}


def _check_blocks(label: str, out: dict, provider_kwargs: dict) -> None:
    """Every block run, re-derived from the run's own index-replayable
    provider on the card, is bit-equal to a CPU provider's block of the
    same index, and each agent's windows lie in its partition."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import make_block_provider

    cpu = make_block_provider(cfg=out["cfg"], device="cpu",
                              **provider_kwargs)
    it, ds = cpu.iterator, cpu.dataset
    for i in range(out["blocks_done"]):
        tokens = out["provider"](i, None)["tokens"].cpu()
        if not torch.equal(tokens, cpu(i, None)["tokens"]):
            raise AssertionError(f"{label}: block {i} differs from the CPU "
                                 "iterator's")
        for k, draw in enumerate(it.windows(i)):
            if not np.isin(draw, cpu.partitions[k]).all():
                raise AssertionError(f"{label}: block {i} agent {k} drew "
                                     "outside its partition")
            for t in range(draw.shape[0]):
                for b in range(draw.shape[1]):
                    x, _ = ds.window(int(draw[t, b]))
                    if not np.array_equal(tokens[t, k, b].numpy(), x):
                        raise AssertionError(f"{label}: block {i} agent {k} "
                                             "is not its windows")
    sizes = [len(p) for p in cpu.partitions]
    print(f"{label}: {out['blocks_done']} blocks bit-equal to the CPU "
          f"iterator's, every window in its agent's partition "
          f"(windows per agent {sizes})")


def phase_train_private(card: str) -> tuple[dict, dict]:
    """Phase 18a: full-width smollm-360m, K = 8 ring, differentially
    private (epsilon 8, delta 1e-5, clip 1) on a Dirichlet partition of
    the seeded corpus, every combination through ``diffusion_mix``."""
    import torch

    from repro_torch.core.diffusion import stacked_grad
    from repro_torch.core.privacy import clip_and_noise
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves, tree_map

    K, blocks = 8, 3
    M = full_width_M()
    out, row = _train_full(card, "phase 18a", PRIVATE_DIRICHLET_FLAGS, blocks,
                           _private_launches(K, M, True), K=K)
    row["privacy"] = _check_accountant("phase 18a", out, blocks)
    _check_blocks("phase 18a", out, dict(
        kind="dirichlet", num_agents=K, local_steps=2, batch=1, seq=1024,
        alpha=0.3, clusters=4, seed=0, corpus_tokens=65536))
    # one local step with noise 0: the clip alone
    cfg, params = out["cfg"], out["state"].params
    batch = tree_map(lambda x: x[0], out["provider"](0, None))
    del out
    torch.cuda.empty_cache()
    grads = stacked_grad(lambda p, b: tf.train_loss(p, cfg, b, remat=False))(
        params, batch)
    sq64 = sum(g.double().reshape(K, -1).square().sum(1)
               for g in tree_leaves(grads))
    # the float32 norm over the leaves in order, and min(1, clip / norm)
    sq32 = torch.zeros((K,), dtype=torch.float32, device="cuda")
    for g in tree_leaves(grads):
        sq32 = sq32 + g.float().reshape(K, -1).square().sum(1)
    scale32 = torch.clamp(1.0 / torch.sqrt(sq32), max=1.0)
    clipped = clip_and_noise(grads, None, clip=1.0, noise_multiplier=0.0)
    # the port's output, bit for bit: each leaf times that scale rounded
    # to the leaf's dtype
    exact = all(torch.equal(
        c, g * scale32.reshape((K,) + (1,) * (g.ndim - 1)).to(g.dtype))
        for c, g in zip(tree_leaves(clipped), tree_leaves(grads)))
    del grads
    norm = sum(g.double().reshape(K, -1).square().sum(1)
               for g in tree_leaves(clipped)).sqrt()
    del clipped
    before = sq64.sqrt() * scale32.double()
    row["clip"] = {"raw_norms": sq64.sqrt().tolist(),
                   "scaled_norms_f32_scale": before.tolist(),
                   "clipped_norms": norm.tolist(), "bit_equal": exact}
    print(f"phase 18a: one local step, noise 0: raw gradient norms "
          f"{[round(x, 4) for x in sq64.sqrt().tolist()]}; times the float32 "
          f"scale {[f'{x:.7f}' for x in before.tolist()]} (gate 1 + 1e-5); "
          f"clip_and_noise's leaves bit-equal to each gradient times that "
          f"scale in its dtype: {exact}; their norms in bf16 "
          f"{[f'{x:.7f}' for x in norm.tolist()]} (gate 1 + 2^-8: the scale "
          f"and each product round to bf16) [{card}]")
    if not exact:
        raise AssertionError("phase 18a: clip_and_noise is not the gradient "
                             "times min(1, clip / its float32 norm)")
    if not (before <= 1.0 + 1e-5).all() or not (norm <= 1.0 + 2 ** -8).all():
        raise AssertionError("phase 18a: a clipped gradient above the clip")
    print(json.dumps({"phase": "18a", **row}))
    del params, batch
    torch.cuda.empty_cache()
    return row["launches"], row


def phase_train_secure_agg(card: str) -> tuple[dict, dict]:
    """Phase 18b: the private_diffusion preset's privacy (secure-agg wire
    masks) on shards, full width: the stage takes every combination, so
    ``diffusion_mix`` is not launched; then one masked combination of the
    trained stack against the kernel mixer."""
    import torch

    from repro_torch.core.mixing import make_mixer
    from repro_torch.core.privacy import make_secure_agg, mask_tiles
    from repro_torch.core.topology import make_topology
    from repro_torch.tree import tree_leaves

    # epsilon 8 calibrated over 3 blocks: a first block at full
    # participation projects the second within the budget (over 2 it would
    # not), so the masks' epoch is carried past block 0 at full width
    K, blocks = 8, 3
    M = full_width_M()
    out, row = _train_full(card, "phase 18b", PRIVATE_SECURE_AGG_FLAGS,
                           blocks, _private_launches(K, M, False), K=K)
    row["privacy"] = _check_accountant("phase 18b", out, blocks)
    epoch = int(out["state"].comm_state["t"])
    if out["blocks_done"] < 2 or epoch != out["blocks_done"]:
        raise AssertionError(f"phase 18b: {out['blocks_done']} blocks run, "
                             f"the masks' epoch at {epoch}")
    row["mask_epoch"] = epoch
    _check_blocks("phase 18b", out, dict(
        kind="shards", num_agents=K, local_steps=2, batch=1, seq=1024,
        shards_per_agent=2, seed=0, corpus_tokens=65536))
    row["combine_masked_s"] = [t["combine_s"] for t in out["timings"]]
    params = out["state"].params
    A_t = out["graphs"][-1].cuda()
    block_active = torch.tensor(out["active"][-1], device="cuda")
    del out
    torch.cuda.empty_cache()
    topo = make_topology("ring", K)
    stage = make_secure_agg(K, seed=0)
    kernel = make_mixer("pallas", topo, device="cuda")
    partial = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 1.0],
                           device="cuda")
    floors = [f + 2 * 2 * K * 2.0 ** -24 * 2 * MASK_BOUND
              for f in _sum_floors(params, 3)]
    for name, active in (("the block's mask", block_active),
                         ("a mask with agents 2, 6 inactive", partial)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        got = stage(params, active, A_t, 7)
        torch.cuda.synchronize()
        masked_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        if read_launches()["diffusion_mix"]:
            raise AssertionError("phase 18b: the masked combination "
                                 "launched diffusion_mix")
        want = kernel(params, active, A_t)
        gate = _ulp_gate(f"phase 18b: one combination through the masks, "
                         f"{name}, against the kernel mixer",
                         ((a, b, f) for a, b, f in zip(
                             tree_leaves(got), tree_leaves(want), floors)))
        # the reference's own mask-exactness gate, absolute, on a float32
        # widening of 2^24 columns of the stack (16 mask tiles)
        x = {"x": tree_leaves(params)[0].reshape(K, -1)[:, :1 << 24]
             .float()}
        gate["max_abs"] = (stage(x, active, A_t, 8)["x"]
                           - kernel(x, active, A_t)["x"]).abs().max().item()
        del x
        if not gate["max_abs"] <= 5e-5:
            raise AssertionError("phase 18b: masked combination beyond "
                                 "5e-5 of the kernel's")
        if not _frozen_equal(got, params, active):
            raise AssertionError("phase 18b: inactive agents not kept "
                                 "exactly")
        row.setdefault("combinations", []).append(
            {"mask": active.tolist(), "masked_s": masked_s,
             "extra_peak_gb": peak, "mask_tiles": mask_tiles(K, M), **gate})
        print(f"phase 18b: {name}: masked combination {masked_s:.3f}s "
              f"({mask_tiles(K, M)} mask tiles of {K}x{K}x"
              f"{(1 << 26) // (K * K)}; {peak:.2f} GB above the stack); "
              f"float32, 2^24 columns: max |masked - kernel| "
              f"{gate['max_abs']:.2e} (gate 5e-5); "
              f"inactive agents bit-equal [{card}]")
        del got, want
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "18b", **row}))
    del params
    torch.cuda.empty_cache()
    return row["launches"], row


def _private_smoke(device: str, *, secure_agg: bool, graph: tuple,
                   blocks: int = 3) -> dict:
    """Smoke smollm-360m, K = 4 ring, T = 2, SGD, ``--mix pallas``,
    private at noise 0: the transform clips only (its noise multiplier
    0), the accountant runs at sigma 1, and with ``secure_agg`` the masks
    carry the combination.  Every draw but the masks from one host
    generator."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.diffusion import DiffusionConfig, DiffusionEngine
    from repro_torch.core.privacy import Privacy, PrivateGradients
    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.launch.train import init_stacked
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map

    cfg = get_config("smollm-360m").smoke
    K, T, B, S = 4, 2, 2, 64

    def loss(p, b):
        return tf.train_loss(p, cfg, b, remat=False)

    transform = PrivateGradients(1.0, 0.0)
    eng = DiffusionEngine(
        DiffusionConfig(num_agents=K, local_steps=T, step_size=0.05,
                        participation=0.9, mix="pallas", graph=graph[0],
                        graph_kwargs=graph[1]),
        loss, transform.update, device=device,
        privacy=Privacy(num_agents=K, clip=1.0, noise_multiplier=1.0,
                        delta=1e-5, secure_agg=secure_agg,
                        steps_per_block=T))
    key = torch.Generator().manual_seed(0)
    params = init_stacked(key, cfg, K, device)
    state = eng.init_state(params, transform.init(params), key=key)
    active, graphs, eps = [], [], []
    for _ in range(blocks):
        batch = tree_map(lambda x: x.to(device), lm_token_batch(
            key, (T, K, B, S), cfg.vocab_size))
        state, m = eng.step(state, batch, key)
        active.append(m["active"].cpu())
        graphs.append(m["A_t"].cpu())
        eps.append(float(m["epsilon"]))
    with torch.no_grad():
        losses = torch.stack([loss(tree_map(lambda x, k=k: x[k],
                                            state.params),
                                   tree_map(lambda x, k=k: x[0, k], batch))
                              for k in range(K)]).cpu()
    return {"params": tree_map(lambda x: x.cpu(), state.params),
            "active": active, "graphs": graphs, "epsilon": eps,
            "losses": losses}


def phase_private_devices() -> dict:
    """Phase 18c: at smoke size, card against CPU: private training at
    noise 0 with and without the masks, static ring and link dropout 0.3
    (phase 6's SGD gates, the same masks and matrices), the masked run
    against the unmasked one within 5e-5 on each device; and the
    Dirichlet and shards providers' blocks, bit-equal."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_block_provider
    from repro_torch.tree import tree_leaves

    def worst(a, b):
        return max((x - y).abs().max().item()
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    row = {}
    for gname, graph in (("static", ("static", ())),
                         ("link_dropout", ("link_dropout",
                                           (("drop", 0.3),)))):
        runs = {(dev, sa): _private_smoke(dev, secure_agg=sa, graph=graph)
                for dev in ("cuda", "cpu") for sa in (False, True)}
        for sa in (False, True):
            gpu, cpu = runs[("cuda", sa)], runs[("cpu", sa)]
            if not all(torch.equal(a, b) for a, b in
                       zip(gpu["active"] + gpu["graphs"],
                           cpu["active"] + cpu["graphs"])):
                raise AssertionError("phase 18c: card and CPU realized "
                                     "different masks or graphs")
            loss_rel = ((gpu["losses"] - cpu["losses"]).abs()
                        / cpu["losses"].abs()).max().item()
            w = worst(gpu["params"], cpu["params"])
            e = max(abs(a - b) / b for a, b in zip(gpu["epsilon"],
                                                   cpu["epsilon"]))
            row[f"{gname}_secure_agg_{sa}"] = {"loss_rel": loss_rel,
                                               "params": w, "epsilon_rel": e}
            print(f"phase 18c: {gname}, secure-agg {sa}, noise 0: card vs "
                  f"CPU losses rel {loss_rel:.2e}, parameters max |diff| "
                  f"{w:.2e} (gate 1e-4, 1e-4), epsilon rel {e:.1e} (2e-4)")
            if not (loss_rel <= 1e-4 and w <= 1e-4 and e <= 2e-4):
                raise AssertionError("phase 18c: card and CPU disagree")
        for dev in ("cuda", "cpu"):
            w = worst(runs[(dev, True)]["params"], runs[(dev, False)]["params"])
            row[f"{gname}_masked_vs_unmasked_{dev}"] = w
            print(f"phase 18c: {gname}, {dev}: masked against unmasked "
                  f"within {w:.2e} (gate 5e-5)")
            if not w <= 5e-5:
                raise AssertionError("phase 18c: the masks do not cancel")
    for arch_cfg, seq in ((get_config("smollm-360m").smoke, 64),
                          (get_config("smollm-360m").model, 1024)):
        for kind, kw in (("dirichlet", {"alpha": 0.3, "clusters": 4}),
                         ("shards", {"shards_per_agent": 2})):
            pv = {dev: make_block_provider(
                kind, arch_cfg, num_agents=8, local_steps=2, batch=1,
                seq=seq, device=dev, seed=3, **kw) for dev in ("cuda", "cpu")}
            for i in (0, 1, 7, 1000):
                a, b = pv["cuda"](i, None), pv["cpu"](i, None)
                if not all(torch.equal(a[n].cpu(), b[n]) for n in a):
                    raise AssertionError(f"phase 18c: {kind} block {i} "
                                         "differs between card and CPU")
    print("phase 18c: dirichlet and shards blocks 0, 1, 7, 1000 bit-equal "
          "on the card and the CPU (smoke and full width)")
    return row


def _private_regression_engine(data, cfg, privacy, device):
    from repro_torch.core.diffusion import DiffusionEngine
    from repro_torch.optim import sgd

    transform = privacy.wrap(sgd()) if privacy is not None else None
    eng = DiffusionEngine(cfg, data.loss_fn(),
                          None if transform is None else transform.update,
                          device=device, grad_fn=data.grad_fn(),
                          privacy=privacy)
    return eng, (transform.init if transform is not None
                 else (lambda p: None))


def phase_private_regression(card: str,
                             device: str = "cuda") -> tuple[dict, dict]:
    """Phase 18d: the DP §VII regression (the recipe of the reference's
    ``bench_privacy``: K = 8, M = 2, q = 0.8, ring, T = 2, mu = 0.01, 2,000
    blocks, ``--mix pallas``): mask exactness on the static ring and under
    link dropout; the MSD-epsilon frontier for epsilon in {2, 8, 32}
    against the non-private floor; the realized epsilon against each
    target; Theorem 5 with the injected DP variance at epsilon 32."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import msd
    from repro_torch.core.diffusion import DiffusionConfig, network_msd
    from repro_torch.core.privacy import Privacy, compile_privacy
    from repro_torch.core.topology import make_topology
    from repro_torch.data.synthetic import (make_block_sampler,
                                            make_regression_problem)

    K, M, q, T, mu, blocks = 8, 2, 0.8, 2, 0.01, 2000
    data = make_regression_problem(K=K, N=100, M=M, rho=0.1, seed=11)
    prob = data.problem()
    qv = np.full(K, q)
    w_o = torch.as_tensor(prob.w_opt(qv), dtype=torch.float32, device=device)
    sampler = make_block_sampler(data, T=T, batch=1, device=device)
    base = DiffusionConfig(num_agents=K, local_steps=T, step_size=mu,
                           topology="ring", participation=q, mix="pallas")
    row = {"card": card}

    # (1) mask exactness: the same noise stream with and without masks
    p0 = torch.as_tensor(np.random.default_rng(3).normal(size=(K, M)) * 0.5,
                         dtype=torch.float32, device=device)
    diffs = {}
    for gname, graph in (("static", ("static", ())),
                         ("link_dropout", ("link_dropout",
                                           (("drop", 0.3),)))):
        cfg = dataclasses.replace(base, graph=graph[0],
                                  graph_kwargs=graph[1])
        finals = []
        for sa in (True, False):
            eng, opt_init = _private_regression_engine(
                data, cfg, Privacy(num_agents=K, clip=1.0,
                                   noise_multiplier=0.8, delta=1e-5,
                                   secure_agg=sa, steps_per_block=T),
                device)
            key = torch.Generator().manual_seed(5)
            st = eng.init_state(p0.clone(), opt_init(p0), key=key)
            for _ in range(6):
                st, _ = eng.step(st, sampler(key), key)
            finals.append(st.params)
        diffs[gname] = (finals[0] - finals[1]).abs().max().item()
    row["mask_exact"] = diffs
    print(f"phase 18d: masked against unmasked over 6 blocks: static "
          f"{diffs['static']:.2e}, link dropout {diffs['link_dropout']:.2e} "
          f"(gate 5e-5)")
    if not all(d < 5e-5 for d in diffs.values()):
        raise AssertionError("phase 18d: the masks do not cancel")

    # (2) the MSD-epsilon frontier
    topo = make_topology("ring", K)

    def steady(privacy):
        eng, opt_init = _private_regression_engine(data, base, privacy,
                                                   device)
        z = torch.zeros(K, M, device=device)
        key = torch.Generator().manual_seed(0)
        st = eng.init_state(z, opt_init(z), key=key)
        hist, spent = [], None
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(blocks):
            st, m = eng.step(st, sampler(key), key)
            hist.append(float(network_msd(st.params, w_o)))
        us = (time.perf_counter() - t0) / blocks * 1e6
        if privacy is not None:
            spent = float(m["epsilon"])
        launches = read_launches()
        if launches != _want_mix(device, blocks):
            raise AssertionError(f"phase 18d: launches {launches}")
        row["launches"] = launches
        return float(np.mean(hist[-blocks // 4:])), spent, us, eng

    floor, _, us_floor, _ = steady(None)
    frontier = {}
    for eps in (2.0, 8.0, 32.0):
        privacy = compile_privacy(K, qv, blocks=blocks, local_steps=T,
                                  epsilon=eps, delta=1e-5, clip=1.0)
        sim, spent, us, eng = steady(privacy)
        nm = privacy.noise_multiplier
        theory = msd.theoretical_msd(
            prob, A=topo.A, q=qv, mu=mu, T=T,
            injected_variance=msd.dp_injected_variance(1.0, nm))["msd"]
        frontier[eps] = {"msd": sim, "noise_multiplier": nm,
                         "epsilon_spent": spent, "theory": theory,
                         "ratio": sim / theory, "us_per_block": us}
        print(f"phase 18d: epsilon {eps:g}: sigma {nm:.4f}, steady MSD "
              f"{sim:.4e}, Theorem 5 with the DP variance {theory:.4e} "
              f"(ratio {sim / theory:.3f}), realized epsilon {spent:.3f} "
              f"({us:.1f} us a block)")
    row["floor"] = {"msd": floor, "us_per_block": us_floor}
    row["frontier"] = frontier
    msds = [frontier[e]["msd"] for e in (2.0, 8.0, 32.0)]
    cal = [frontier[e]["epsilon_spent"] / e for e in (2.0, 8.0, 32.0)]
    ratio = frontier[32.0]["ratio"]
    print(f"phase 18d: non-private floor {floor:.4e} ({us_floor:.1f} us a "
          f"block); frontier {msds} (falls as epsilon grows, above half "
          f"the floor); realized/target epsilon {cal} (0.7-1.3); MSD over "
          f"Theorem 5 at epsilon 32 {ratio:.3f} (0.25-4)")
    if not msds[0] > msds[1] > msds[2] > 0.5 * floor:
        raise AssertionError("phase 18d: the frontier does not fall as "
                             "epsilon grows")
    if not all(0.7 <= c <= 1.3 for c in cal):
        raise AssertionError("phase 18d: realized epsilon off its target")
    if not 0.25 <= ratio <= 4.0:
        raise AssertionError("phase 18d: Theorem 5 misses at epsilon 32")
    if device == "cuda":
        privacy = compile_privacy(K, qv, blocks=blocks, local_steps=T,
                                  epsilon=32.0, delta=1e-5, clip=1.0)
        eng, opt_init = _private_regression_engine(data, base, privacy,
                                                   device)
        row["profile"] = _profile_regression(
            data, base, 200, card, eng=eng, opt_init=opt_init,
            label="phase 18d")
    print(json.dumps({"phase": "18d", **row}))
    return row["launches"], row


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
    seconds = {}

    def timed(phase, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[phase] = time.perf_counter() - t0
        print(f"chip_smoke: {phase} took {seconds[phase]:.1f}s")
        return out

    try:
        mix_row = timed("phase 1", phase_kernel, card)
        timed("phase 2", phase_small, scratch)
        serve_launches, _, stack_path = timed("phase 3", phase_full, scratch,
                                              card)
        attn_row = timed("phase 4", phase_attention, card)
        train_launches, _ = timed("phase 5", phase_train, card)
        timed("phase 6", phase_train_devices)
        ssd_row = timed("phase 7", phase_ssd, card)
        mamba_launches, _ = timed("phase 8", phase_train_mamba, card)
        zamba_launches = timed("phase 9", phase_ssm_devices, scratch, card)
        robust_row, gather_row = timed("phase 10", phase_gather_kernels,
                                       card)
        robust_launches, _ = timed("phase 11a", phase_train_robust, card)
        gather_launches, _ = timed("phase 11b", phase_train_gather, card)
        # the Byzantine preset at smoke size, card against CPU
        timed("phase 11c", phase_train_devices, label="phase 11c",
              agents=12, mix=tuple(BYZANTINE_FLAGS),
              optimizers=(("sgd", 0.05),))
        consensus_launches = timed("phase 12", phase_consensus_robust,
                                   stack_path, card)
        int8_row = timed("phase 13", phase_int8_kernel, card)
        int8_launches, _ = timed("phase 14a", phase_train_int8, card)
        diff_launches, _ = timed("phase 14b", phase_train_diff, card)
        timed("phase 14c", phase_compressed_devices)
        quantized_launches = timed("phase 15", phase_consensus_int8,
                                   stack_path, card)
        link_drop_launches, _ = timed("phase 16a", phase_train_link_dropout,
                                      card)
        tv_erdos_launches, _ = timed("phase 16b", phase_train_tv_erdos, card)
        timed("phase 16c", phase_graph_devices)
        regression_launches, _ = timed("phase 17", phase_regression, card)
        private_launches, _ = timed("phase 18a", phase_train_private, card)
        secure_agg_launches, _ = timed("phase 18b", phase_train_secure_agg,
                                       card)
        timed("phase 18c", phase_private_devices)
        frontier_launches, _ = timed("phase 18d", phase_private_regression,
                                     card)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    # each row's numbers are at its own training path's shape (smollm for
    # the mix, attention and gather kernels, mamba2 for the SSD kernel);
    # "launches_by_path" gives every path's counts
    by_path = {"serve_smollm": serve_launches,
               "train_smollm": train_launches,
               "train_mamba2": mamba_launches,
               "forward_zamba2": zamba_launches,
               "train_smollm_byzantine": robust_launches,
               "train_smollm_gather": gather_launches,
               **{f"serve_smollm_{mix}": counts
                  for mix, counts in consensus_launches.items()},
               "train_smollm_compressed_fedavg": int8_launches,
               "train_smollm_compressed_diffusion": diff_launches,
               "serve_smollm_int8": quantized_launches,
               "train_smollm_link_dropout_markov": link_drop_launches,
               "train_smollm_tv_erdos_cyclic": tv_erdos_launches,
               "regression_paper_fig5": regression_launches,
               "train_smollm_private_dirichlet": private_launches,
               "train_smollm_private_secure_agg": secure_agg_launches,
               "regression_private_frontier": frontier_launches}
    rows = ((mix_row, "train_smollm"), (attn_row, "train_smollm"),
            (ssd_row, "train_mamba2"),
            (gather_row, "train_smollm_gather"),
            (robust_row, "train_smollm_byzantine"),
            (int8_row, "train_smollm_compressed_fedavg"))
    for row, main_path in rows:
        row["launches"] = by_path[main_path][row["name"]]
        row["launches_by_path"] = {name: counts[row["name"]]
                                   for name, counts in by_path.items()}
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f}s [{card}]")
    print(json.dumps({"phase_seconds": seconds, "card": card}))
    print(json.dumps({"kernels": [row for row, _ in rows], "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
