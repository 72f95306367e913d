#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

  python3 chip_smoke.py

Every kernel source is built at the start, one ``nvcc`` per source, all
started together; phases 1-6, which run only ``diffusion_mix`` and
``flash_attention``, start once those two are built, and every build has
ended before phase 7.  Phases (any failure exits non-zero; nothing is
swallowed):

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
   full-width training shape in f32 and bf16; head dim 112 (kimi-k2's,
   which the bf16 route runs in its 128 layout, TMA filling columns
   112..127 with zeros) causal, windowed, at a ragged S and non-causal,
   in f32 and bf16.  Tolerances: the
   reference's, 2e-5 (f32) and 2e-2 (bf16); every bf16 case (the
   tensor-core route) also within 2^-7 P|V| + one bf16 ulp of its rounding
   model ``attention_bf16p_ref``.  The ``ptxas`` lines of both routes and
   the count of HGMMA instructions in the built library (none fails).  At
   the training and zamba2 shapes in bf16 the kernel and
   ``scaled_dot_product_attention`` are timed by their device time
   (``torch.profiler``) and by CUDA events around a loop of calls (the
   wrapper's host time, where the host is slower), the plain version by
   CUDA events; likewise, each held to the same gates and beside its
   bound, the attention of each phase-21c arch at its shape: chatglm3's
   (1, 1024, 32, 2, 128), starcoder2's (1, 8192, 48, 4, 128) past its
   4,096-key window, qwen3's (1, 1024, 64, 8, 128), kimi-k2's (1, 1024,
   64, 8, 112); and phase 22's: llava's (1, 3904, 32, 8, 128) (2,880
   image positions and 1,024 tokens, ragged against the 128-query tiles)
   and musicgen's (1, 1024, 24, 24, 64).
4b. The bf16 attention backward kernel (``flash_attention_backward``) at
   the training cells' shapes, mistral-7b's (1, 4096, 32, 8, 128) and
   llava's (1, 3904, 32, 8, 128), causal, on the forward kernel's own
   output and log-sum-exp: the same bits on two runs; dq, dk and dv
   within 2^-8 (relative Frobenius norm) of its plain model
   ``attention_bf16_backward_ref`` and within 2^-7 of the plain float32
   backward (autograd through
   ``flash_attention_jnp``); the ``ptxas`` lines of its kernels; its
   device time (profiler) beside its bound (five products over the kept
   pairs at the bf16 rate, or its bytes), the plain backward's time and,
   as the library's yardstick only, the backward of
   ``scaled_dot_product_attention`` with the kv heads repeated (which the
   port never calls).
5. Train, full width: Algorithm 1 on smollm-360m through
   ``repro_torch.launch.train.main`` (K=4, T=2, B=2, S=1024, 3 blocks,
   Adam, ``--mix pallas``, ``use_kernels=True``); both kernels' launch
   counts and the bf16 attention backward kernel's (once per training
   forward; every training phase's launch gate counts it too, in the
   kernels line as ``flash_attention_backward``), finite losses and
   parameters, the per-block split into local
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
   ``repro_torch.launch.train.main`` (32 of its 64 layers, K=2, T=2, B=1,
   S=1024, 3 blocks, SGD, ``--mix pallas``, ``use_kernels=True``); the launch
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
11. Train smollm-360m at full width, cut to 8 of its 32 layers
    (``CUT_LAYERS``, as in phases 14, 16 and 18), through ``train.main``
    at K=12 (ring, T=2, q=0.9, B=1, S=1024, SGD mu=0.05,
    ``use_kernels=True``): (a) the
    reference's Byzantine preset (3 sign-flip adversaries of scale 3,
    per-neighborhood trimmed mean, ``--robust-gather fused``), 3 blocks,
    a profiled block, then one more combination of the trained stack with
    the kernel and with the plain gather table, within one bf16 ulp and
    inactive agents bit-equal; (b) ``--mix gather``, 2 blocks, then one
    combination against the dense mixer within one bf16 ulp; (c) the
    preset at smoke size on the card and on the CPU (phase 6's gates).
12. Robust and gather consensus at full width: phase 3's K=8 stack (read
    from disk once by phase 3's first serving run and kept in pinned host
    memory for phases 3, 12 and 15: ``SharedStack``) through
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
14. Train smollm-360m at full width (8 layers) through ``train.main`` at
    K=8 (q=0.9,
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
    width (8 layers) through ``train.main`` (K=8 ring, T=2, q=0.9, B=1, S=1024, SGD
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
    cyclic processes in turn (but link dropout 0.3 under ``pallas`` and
    the i.i.d. process, which 19c's link_dropout_diffusion preset holds).
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
    (8 layers) through ``train.main`` (K=8 ring, T=2, q=0.9, B=1, S=1024, SGD
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
19. The experiment API and the async engine: (a) smollm-360m at full
    width, 8 of its 32 layers (``CUT_LAYERS``), through ``train.main`` (K=8 ring, q=0.9, T=2,
    SGD mu=0.05, B=1, S=1024, 3 blocks, ``use_kernels=True``) with
    ``--engine async`` (lognormal rates, sigma 0.5, seed 0, tau_max 4,
    exp discount 0.1, ``--mix auto``) and ``--checkpoint``: each block's
    non-fired agents bit-equal, slot ages exact, combination rows summing
    to 1 within 1e-6; the clocks equal the fires times the delays (rtol
    1e-5); a block with 0 < fires < K; ``flash_attention`` launches only
    (the buffer's combination is a plain batched product); block times,
    tokens/s, peak memory, the checkpoint's size and write time; (b) that
    checkpoint through ``serve.main`` with no spec flag, twice: the
    engine rebuilt from the stored spec, the freshness-weighted consensus
    within one bf16 ulp plus the float32 summation bound of a float64 sum
    over the loaded stack, the same greedy tokens; (c) each of the 13
    presets at smoke size through ``--preset`` (K=8, ``--mix pallas``
    overlaid on all but the robust one): exact launch counts, the same
    spec JSON as the preset written out in flags, card against CPU under
    phase 6's gates (compressed_diffusion block by block with injected
    draws, compressed_fedavg in 14c's lockstep on the same configuration,
    the private one at noise 0); ``--engine auto`` builds the sharded
    engine, bit-equal to ``--engine sharded``; (d) exact diffusion on the
    recipe of the reference's test (K=8 ring, mu 0.01, 1,200 blocks, mean
    over the last 600): closer to w° than vanilla diffusion, card against
    CPU within 1e-5 relative.
20. The sharded engine, the reference's default training path (every
    ``train.main`` phase above runs it at world 1 too): (a) smollm-360m at
    full width, 8 of its 32 layers, through ``train.main`` with ``--engine
    auto`` and no process group (K=8 ring, q=0.9, T=2, SGD mu=0.05, B=1,
    S=1024, ``--mix pallas``, 3 blocks): the engine built is the sharded
    one, the launch counts exact, and one stacked-engine step from block
    0's input state with its realized mask and batch gives parameters
    bit-equal to the sharded block; (c) the compressed_fedavg run (int8 +
    EF, the fused int8 path) at 8 layers, 2 blocks, ``--engine
    sharded`` without and with ``--ef-host-offload``: parameters
    bit-equal, the pipeline memory pinned CPU tensors between blocks, the
    peak device memory lower by at least three quarters of it, the block
    time the copies cost; (b) that run with the offload on two ranks of a
    gloo group on the one card (two spawned processes, a ``file://``
    rendezvous in the scratch directory, four agents a rank): the
    gathered parameters bit-equal to (c)'s (sha256 of every leaf), the
    bytes each combination's gathers moved (int8 codes and float32
    scales, exactly) against the float32 stack's, each rank's launches,
    peak memory and block seconds.  19a's and 20a's stacks are drawn on
    the card (``train.main(..., init_on_device=True)``).
21. The MoE FFN and the other text archs: (a) granite-moe-1b-a400m at
    full width (24 layers, 32 experts top 8, M = 1,334,628,352 an agent)
    through ``train.main`` with ``--engine auto`` (sharded, world 1), K =
    4 ring, q 0.9, T = 2, SGD mu 0.05, B = 1 x 1024, ``--mix pallas``, 2
    blocks, the stack drawn on the card, ``--checkpoint``: the launch
    counts exact (``diffusion_mix`` 20 tiles a block), the float32 router
    kept, block 0 bit-equal to one stacked-engine step from its input
    state; one local step of agent 0, kernel against plain attention,
    both routed as the plain route routes (``moe.Routing``'s replay):
    the loss within 2e-3 relative with float32 parameters and in bf16,
    every float32 gradient leaf within MOE_GRAD_TOL_F32, every bf16 leaf
    within MOE_GRAD_WITNESS_RATIO times the same leaf's witness taken in
    the same run (a forward whose attention is the kernel's rounding
    model), the assignments the kernel route would have chosen otherwise
    counted; (b) that checkpoint through ``serve.main`` with no
    spec flag: the consensus through ``diffusion_mix`` within one bf16
    ulp plus the summation bound of a float64 mean, the router float32,
    prefill of 4 x 128 and 32 greedy steps; (c) chatglm3-6b (28 layers),
    starcoder2-15b (40 layers, S = 8192 past its 4,096-key window),
    qwen3-32b (16 of 64 layers) and kimi-k2 (1 of 61 layers; head dim
    112) at full width, weights drawn on the card, one forward each at K
    = 1, B = 1 with the attention kernel and with the plain version: one
    launch a layer, the loss within 2e-3 relative, the logits' relative
    error and kimi's routing flips printed.
22. The two modalities: (a) musicgen-medium at full width (all 48
    layers, 4 codebooks of 2,048, M = 1,384,269,312 an agent) through
    ``train.main`` with ``--engine auto`` (sharded, world 1), K = 4 ring,
    q 0.9, T = 2, SGD mu 0.05, B = 1 x 1024 x 4, ``--mix pallas``, 2
    blocks, ``--checkpoint``: the launch counts exact (``diffusion_mix``
    21 tiles a block), block 0 bit-equal to one stacked-engine step; (b)
    that checkpoint through ``serve.main`` with no spec flag: prompts (4,
    128, 4), 32 greedy steps, tokens (4, 32, 4), a second greedy run
    equal, the consensus through ``diffusion_mix`` within one bf16 ulp
    plus the summation bound of the dense mixer's over the same stack;
    (c) llava-next-mistral-7b at full width, 8 of its 32 layers
    (``LLAVA_CUT_LAYERS``), K = 2, the same recipe with the 2,880-token
    float32 image stream (B = 1 x (2,880 + 1,024)): the launch counts
    exact (15 tiles a block), block 0 bit-equal to a stacked step; its
    checkpoint through ``serve.main(..., num_layers=8)``: 4 prompts of
    128 after the image prefix, 32 greedy steps, a cache of 2,880 + 128 +
    32 positions, and on the served consensus in float32 the first 8
    decode steps within the reference's 5e-3 gate of the uncached forward
    over the same context (the reference's sizing, 128 + 32 positions,
    printed beside it); (d) one forward each of llava (all 32 layers, S =
    2,880 + 1,024) and musicgen (all 48) at K = 1, B = 1, kernel against
    plain attention as in 21c.
23. The continuous-batching ServeLoop: at smoke size in float32, 5
    requests on 2 slots equal single-request serving, and under a swap a
    tick the card's tokens and tags equal the CPU's and every completion
    replays on the card; at full width over 22b's consensus (bf16), 4
    slots, chunk 8, max_len 256, six requests of 64-160 prompt tokens x 4
    codebooks and 32 new tokens, 22a's checkpoint ingested after the
    first tick (``ingest_checkpoint``, the watch path: its consensus
    through ``diffusion_mix``) and a perturbed copy swapped in after the
    third: every completion replays at the loop's width (the decode of
    ``replay_completion(..., slots=4)``), and the tokens batch-1 serving
    would choose otherwise under the same schedule are counted, each
    completion's first such token within twice the batch-vs-single logit
    difference of its top two.
24. The dry run (``repro_torch.launch.dryrun``) against the card: (a)
    ``python -m repro_torch.launch.dryrun --all`` as a subprocess with the
    card hidden (``CUDA_VISIBLE_DEVICES=""``): 80 ``OK`` lines (10 archs x
    4 shapes x 2 meshes) and 80 JSON files, exit 0; (b) its prediction on
    the port's own mesh at world 1 against the allocator: smollm-360m's
    train_4k state (K = 16 agents of the full width, SGD with no optimizer
    state, as the reference's dry-run step holds none) built through
    ``api.build`` with one block from the iid provider and no step run:
    ``torch.cuda.memory_allocated``'s growth equals
    ``argument_size_in_bytes`` less the 8-byte key, within the allocator's
    rounding of 512 B a tensor; (c) the same for the long_500k decode
    cache (window 8,192) from ``init_cache``; (d) the card path of
    ``load_checkpoint``: an archive whose member spans four 64 MiB pieces
    loads bit-equal, and one flipped byte in its data or in its .npy
    header raises ``zipfile.BadZipFile``.  Phases 3, 21b, 22b, 22c and 26
    print each checkpoint load's GB/s (every member's CRC-32 checked).
25. The six examples of ``repro_torch.examples`` on the card, in process
    through their functions at the reference's sizes, each one's own
    check holding: quickstart (3,000 blocks) with sim/theory inside
    QUICKSTART_BAND, federated_comparison (15,500 blocks) ``bounded``,
    custom_graph (2 x 400 blocks) ``CUSTOM_GRAPH_OK`` with the hub index
    at 400, train_lm (100 blocks) with its last printed loss below its
    first and its checkpoint read back bit-equal, train_federated_text
    (40 blocks) with its mean loss falling, serve_lm's three smoke archs
    at cache position 64, card == CPU (logits within 1e-4, the same
    greedy tokens); no kernel launched (the plain mixers and smoke
    configs of the reference's defaults), each example's seconds.
26. mamba2-2.7b at full width (all 64 layers, M = 2,702,579,200 an agent)
    served from a K = 2 bf16 stacked checkpoint of random weights drawn
    on the card through ``serve.main --mix pallas`` (4 prompts of 128, 32
    greedy steps): ``diffusion_mix`` launched once a column tile (21)
    and nothing else, the consensus within one bf16 ulp plus the
    summation bound of the dense mixer's, a second greedy run equal,
    tokens in the vocabulary; every decode step within DECODE_TOL of the
    uncached forward over the same context with float32 weights, and
    within MAMBA_DECODE_WITNESS_RATIO times the bf16 forward's own
    rounding (plus DECODE_TOL) in bf16; the write and load GB/s,
    consensus, prefill, decode tokens/s and the peak printed.

Every full-width training phase (5, 8, 11, 14, 16, 18, 19a, 20, 21a, 22a,
22c) draws its stack on the card (``train.main(..., init_on_device=True)``);
phase 6 keeps the host draw its card-against-CPU check needs.  The kernel
mixers run over a column-tiled flatten, one launch per tile
(``repro_torch.core.mixing.num_tiles``): phases 3, 5, 8, 11, 12, 14, 15,
16, 18, 19, 20, 21, 22, 23 and 26 count tiles.  Each path's launch counts
(all six kernels) are set to 0 just before its first run and read just
after it (phases 3, 5, 8, 9, 11, 12, 14, 15, 16, 17, 18, 19, 20, 21, 22,
23, 25 and 26; 20b counts in each rank).  The last lines are a
JSON object of the kernels' numbers, the card's name and power limit
(``nvidia-smi``), and ``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.  Scratch files go
to ``.repro_torch_build/`` in the checkout and are removed at the end.
"""
from __future__ import annotations

import contextlib
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
# (B, S, H, Kv, D) of one layer's attention backward in phase 4b: the
# mistral-7b training cell's, and llava's 2,880 image positions and 1,024
# tokens
ATTN_BWD_SHAPES = {"mistral-7b": (1, 4096, 32, 8, 128),
                   "llava-next-mistral-7b": (1, 3904, 32, 8, 128)}
# the backward kernel against its plain model and against the plain
# float32 backward, relative Frobenius norm of dq, dk and dv
# (tests/test_torch_attention_backward.py states why)
ATTN_BWD_MODEL_TOL = 2.0 ** -8
ATTN_BWD_EXACT_TOL = 2.0 ** -7
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


def load_rate(label: str, nbytes: int, load_s: float, card: str) -> None:
    """A checkpoint load's rate: the archive's bytes over the load's
    seconds, every member's CRC-32 checked."""
    print(f"{label}: load {nbytes / 1e9:.2f} GB in {load_s:.2f}s = "
          f"{nbytes / load_s / 1e9:.2f} GB/s, every member's CRC-32 checked "
          f"[{card}]")


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
    return _device_ms_of(fn, "", iters)[0]


def _device_ms_of(fn, name: str, iters: int = 20) -> tuple[float, float]:
    """:func:`device_ms` of ``fn``, and the part of it in device events
    whose name contains ``name``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the profiler has now and then come back empty from a window of
    # launches that ran: profile the window again, up to three times
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = list(device_events(prof))
        total = sum(n for _, n in events)
        if total:
            break
        print(f"the profiler saw no device time in window {attempt} of 3")
    else:
        raise AssertionError("the profiler saw no device time in 3 windows")
    part = sum(n for e, n in events if name in e)
    return total / 1e6 / iters, part / 1e6 / iters


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
            "diffusion_mix_int8": dmi.diffusion_mix_int8,
            "flash_attention_backward": fa.flash_attention_backward}


def with_backward(want: dict, cfg, trained: int) -> dict:
    """``want`` with ``flash_attention_backward``'s launches: one for each
    of the ``trained`` attention forwards that took a gradient, where the
    model is bf16 (the backward kernel's route; float32 keeps the plain
    backward, which launches no kernel)."""
    import torch

    want["flash_attention_backward"] = (
        trained if cfg.param_dtype == torch.bfloat16 else 0)
    return want


def full_width_M(arch: str = "smollm-360m", layers: int | None = None) -> int:
    """One agent's parameter count at full width (``layers`` cuts the
    depth)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch).model
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
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
    # head dim 112 (kimi-k2's; the bf16 route runs its D = 128 layout, TMA
    # filling columns 112..127 with zeros): causal, windowed, ragged,
    # non-causal with ragged lengths, in both dtypes
    cases += [c for dt in (f32, bf16) for c in (
        (1, 256, 256, 8, 1, 112, dt, True, None),
        (1, 256, 256, 4, 2, 112, dt, True, 96),
        (1, 333, 333, 3, 1, 112, dt, True, 50),
        (2, 200, 333, 4, 2, 112, dt, False, None))]
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
    # phase 21c's attention, one layer of each arch as its forward calls
    # it: chatglm3's (1, 1024, 32, 2, 128), starcoder2's (1, 8192, 48, 4,
    # 128) past its 4,096-key window, qwen3's (1, 1024, 64, 8, 128) and
    # kimi-k2's (1, 1024, 64, 8, 112)
    from repro_torch.configs import get_config

    for arch, S, _ in ARCH_FORWARDS:
        c = get_config(arch).model
        row[arch] = _time_attention(
            gen, (1, S, c.num_heads, c.num_kv_heads, c.head_dim), card,
            window=c.attention_window)
    # phase 22's: llava's (1, 3904, 32, 8, 128), its 2,880 image positions
    # and 1,024 tokens (ragged against the 128-query tiles), and
    # musicgen's (1, 1024, 24, 24, 64), no GQA
    for arch, S, _ in MODALITY_FORWARDS:
        c = get_config(arch).model
        row[arch] = _time_attention(
            gen, (1, S + c.img_tokens, c.num_heads, c.num_kv_heads,
                  c.head_dim), card, window=c.attention_window)
    return row


def _time_attention(gen, shape, card: str, window=None) -> dict:
    """One bf16 causal attention at ``shape`` (B, S, H, Kv, D): the kernel
    against its plain version (phase 4's gates and the bf16 rounding
    budget), the kernel's and SDPA's device times (profiler), the plain
    version's (CUDA events) and the bound of its bytes and of the
    operations of the unmasked scores."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref

    B, S, H, Kv, D = shape
    q, k, v = _attention_inputs(gen, B, S, S, H, Kv, D, torch.bfloat16)
    out = fa.flash_attention(q, k, v, window=window)
    ref = attention_ref(q, k, v, window=window)
    ok, err = _attention_close(out, ref)
    if not ok:
        raise AssertionError(f"flash_attention {shape} window={window} "
                             f"bf16: max |err| {err:.3e} beyond {ATTN_TOL}")
    share = _bf16p_share(out, q, k, v, window=window,
                         label=f"{shape} window={window}")
    del ref
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms, kernel_ms = _device_ms_of(
        lambda: fa.flash_attention(q, k, v, window=window),
        "flash_attention")
    if window is None:
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    else:
        # SDPA takes a window only as a mask, which its flash route refuses
        pos = torch.arange(S, device=q.device)
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
    loop_ms = time_ms(lambda: fa.flash_attention(q, k, v, window=window),
                      iters=20)
    plain_ms = time_ms(lambda: attention_ref(q, k, v, window=window),
                       iters=5)
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    # the (query, key) pairs the causal window keeps
    w = S if window is None else min(window, S)
    pairs = w * (w + 1) // 2 + (S - w) * w
    flops = 2 * 2 * B * H * pairs * D
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / BF16_FLOPS_PER_S * 1e3
    res = {"shape": list(shape), "window": window, "dtype": "bfloat16",
           "ms": ms, "kernel_only_ms": kernel_ms, "library_ms": library_ms,
           "loop_ms": loop_ms,
           "plain_ms": plain_ms, "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": ("bytes" if bound_bytes >= bound_ops
                        else "operations"),
           "max_abs_err": err, "bf16p_budget_share": share}
    print(f"phase 4: {tuple(shape)} window={window} bf16 causal: kernel "
          f"device {ms:.4f} ms (the attention kernel alone {kernel_ms:.4f} "
          f"ms; loop {loop_ms:.4f} ms), SDPA device {library_ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {res['bound_ms']:.4f} ms "
          f"({res['bound_by']}; the kernel at "
          f"{100 * res['bound_ms'] / ms:.1f} % of it); max |err| {err:.3e}, "
          f"{share:.3f} of the bf16 rounding budget [{card}]")
    del q, k, v, qt, kt, vt, out
    torch.cuda.empty_cache()
    return res


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


def _frobenius_rel(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm()).item()


def phase_attention_backward(card: str) -> dict:
    """Phase 4b: the bf16 attention backward kernel at the training
    shapes, against its plain model and the plain float32 backward, and
    timed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_bf16_backward_ref
    from repro_torch.models.layers import flash_attention_jnp

    fa.build()
    ptxas = ptxas_lines("flash_attention")
    for line in ptxas:
        print("  ptxas:", line)
    gen = torch.Generator(device="cuda").manual_seed(41)
    row = {"name": "flash_attention_backward", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "none: the reference differentiates the plain "
                       "streaming attention (src/repro/kernels/ops.py:49)",
           "dtype": "bfloat16", "ptxas": ptxas}
    for arch, (B, S, H, Kv, D) in ATTN_BWD_SHAPES.items():
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((B, S, Kv, D), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        g = torch.randn((B, S, H, D), generator=gen, device="cuda").bfloat16()
        out, lse = fa.flash_attention_lse(q, k, v)
        got = fa.flash_attention_backward(q, k, v, out, g, lse)
        again = fa.flash_attention_backward(q, k, v, out, g, lse)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_backward {arch}: two runs "
                                 f"on the same operands differ")
        del again
        model = attention_bf16_backward_ref(q, k, v, out, g, lse)

        def plain():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = flash_attention_jnp(*leaves, causal=True)
            return torch.autograd.grad(o, leaves, g)

        errs = {}
        for name, a, m, pl in zip(("dq", "dk", "dv"), got, model, plain()):
            errs[name] = {"model": _frobenius_rel(a, m),
                          "plain": _frobenius_rel(a, pl)}
            if not (errs[name]["model"] <= ATTN_BWD_MODEL_TOL
                    and errs[name]["plain"] <= ATTN_BWD_EXACT_TOL):
                raise AssertionError(
                    f"flash_attention_backward {arch} {name}: "
                    f"{errs[name]} beyond {ATTN_BWD_MODEL_TOL} (model) or "
                    f"{ATTN_BWD_EXACT_TOL} (plain)")
        del got, model
        torch.cuda.empty_cache()

        def kernel():
            return fa.flash_attention_backward(q, k, v, out, g, lse)

        ms, kernel_ms = _device_ms_of(kernel, "flash_attention_bf16_backward")
        main_ms = _device_ms_of(kernel,
                                "flash_attention_bf16_backward_kernel")[1]
        loop_ms = time_ms(kernel, iters=20)
        plain_ms = time_ms(plain, iters=3)
        # the library's yardstick: SDPA's backward with the kv heads
        # repeated to H (its flash route takes no GQA)
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt, vt = (x.repeat_interleave(H // Kv, dim=2).transpose(1, 2)
                  .detach().requires_grad_() for x in (k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        gt = g.transpose(1, 2)
        library_ms = device_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), gt, retain_graph=True))
        del qt, kt, vt, ot, gt
        pairs = S * (S + 1) // 2
        flops = 5 * 2 * B * H * pairs * D
        nbytes = 2 * (4 * q.numel() + 4 * k.numel())
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = flops / BF16_FLOPS_PER_S * 1e3
        bound = max(bound_bytes, bound_ops)
        res = {"shape": [B, S, H, Kv, D], "ms": ms,
               "kernel_only_ms": kernel_ms, "main_kernel_ms": main_ms,
               "loop_ms": loop_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound,
               "bound_by": ("bytes" if bound_bytes >= bound_ops
                            else "operations"),
               "roofline_pct": 100 * bound / kernel_ms, "flops": flops,
               "bytes": nbytes, "rel_err": errs}
        row[arch] = res
        print(f"phase 4b: {arch} {(B, S, H, Kv, D)} bf16 causal backward: "
              f"kernels device {kernel_ms:.4f} ms (main "
              f"{main_ms:.4f} ms; all device work {ms:.4f} ms; loop "
              f"{loop_ms:.4f} ms), bound {bound:.4f} ms "
              f"({res['bound_by']}: {flops:.3e} operations at "
              f"{BF16_FLOPS_PER_S:.3g}/s; the kernels at "
              f"{res['roofline_pct']:.1f} % of it), plain float32 backward "
              f"{plain_ms:.3f} ms, SDPA backward device {library_ms:.4f} ms; "
              f"relative error vs model "
              + ", ".join(f"{n} {e['model']:.2e}" for n, e in errs.items())
              + "; vs plain "
              + ", ".join(f"{n} {e['plain']:.2e}" for n, e in errs.items())
              + f" [{card}]")
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()
    return row


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
    out = train.main(argv, use_kernels=True, init_on_device=True)
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
    # the bf16 backward kernel once per training forward, none for the
    # logging forwards
    want = with_backward({}, cfg, cfg.num_layers * K * T * blocks)
    if launches["flash_attention_backward"] != want[
            "flash_attention_backward"]:
        raise AssertionError(f"flash_attention_backward launched "
                             f"{launches['flash_attention_backward']}x on "
                             f"the training path, expected {want}")
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


class SharedStack:
    """Phase 3's K = 8 stack, read from its checkpoint once and shared by
    the serving runs of phases 3, 12 and 15.  Inside ``with
    SharedStack():`` the serving driver's ``load_checkpoint`` reads a path
    from disk the first time (the load every earlier script timed) and
    keeps the leaves in pinned host memory; later loads of that path copy
    them to the card (``load_s`` is then that copy).  ``clear()`` frees
    the host copy."""

    cache: dict = {}
    read_s: dict = {}          # path -> seconds of the read from disk

    def __enter__(self):
        from repro_torch.checkpoint import store
        from repro_torch.launch import serve

        self._serve, self._real = serve, serve.load_checkpoint
        serve.load_checkpoint = self.load
        self._store_load = store.load_checkpoint
        return self

    def __exit__(self, *exc):
        self._serve.load_checkpoint = self._real
        return False

    def load(self, path, like, *, device=None):
        import torch

        from repro_torch.tree import tree_map

        key = str(path)
        if key not in self.cache:
            t0 = time.perf_counter()
            tree, meta = self._store_load(path, like, device=device)
            torch.cuda.synchronize()
            self.read_s[key] = time.perf_counter() - t0
            self.cache[key] = (tree_map(lambda t: torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True).copy_(t), tree),
                meta)
            return tree, meta
        host, meta = self.cache[key]
        tree = tree_map(lambda t: t.to(device or "cuda", non_blocking=True),
                        host)
        torch.cuda.synchronize()
        return tree, dict(meta)

    @classmethod
    def clear(cls) -> None:
        cls.cache.clear()
        cls.read_s.clear()


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
    with SharedStack():
        # the first run reads the checkpoint from disk; the others, and
        # phases 12 and 15, copy the stack it kept in pinned host memory
        first = serve.main(argv + ["--mix", "pallas"])
        launches = read_launches()
        # the read alone: the first run's load_s also keeps a pinned copy
        load_rate("phase 3", Path(path).stat().st_size,
                  SharedStack.read_s[path], card)
        # one combination of the (K, M) stack: one launch per column tile
        tiles = num_tiles(K, full_width_M())
        if launches["diffusion_mix"] != tiles:
            raise AssertionError(f"the serving path launched diffusion_mix "
                                 f"{launches['diffusion_mix']}x, expected "
                                 f"one launch per tile, {tiles}")
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
    """Phase 8: Algorithm 1 on full-width mamba2-2.7b, cut to
    ``MAMBA_CUT_LAYERS`` of its 64 layers, through train.main, with the
    SSD kernel in every layer and the mix kernel once a block."""
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
    out = train.main(argv, use_kernels=True, num_layers=MAMBA_CUT_LAYERS,
                     init_on_device=True)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = out["cfg"]
    # one launch per layer per agent per local step, plus the logging
    # forward of every agent after each block
    M = full_width_M("mamba2-2.7b", layers=MAMBA_CUT_LAYERS)
    want = {"ssd_intra_chunk": cfg.num_layers * K * (T * blocks
                                                     + len(out["losses"])),
            "diffusion_mix": num_tiles(K, M) * blocks, "flash_attention": 0, "gather_mix": 0,
            "gather_robust_mix": 0, "diffusion_mix_int8": 0,
            "flash_attention_backward": 0}
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
    row = {"phase": "train", "arch": "mamba2-2.7b",
           "layers": cfg.num_layers, "agents": K, "local_steps": T,
           "batch": B, "seq": S, "blocks": blocks, "optimizer": "sgd",
           "step_size": mu, "mix": "pallas",
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
            "gather_mix": 0, "gather_robust_mix": 0, "diffusion_mix_int8": 0,
            "flash_attention_backward": 0}
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


#: the depth of the full-width smollm-360m training phases 11a, 11b, 14a,
#: 14b, 16a, 16b, 18a, 18b, 19a, 20a, 20b and 20c: 8 of its 32 layers at
#: its full width (the cut that keeps the whole script well within its
#: time on a slower host, and 19a's checkpoint near 8 GB; phase 5 trains
#: all 32)
CUT_LAYERS = 8

#: the depth of phase 22c's full-width llava-next-mistral-7b training: 8
#: of its 32 layers at its full width (memory: at 32 layers K = 2 holds
#: two 14.5 GB agents, block 0's two kept stacks and the gradients; M =
#: 2,011,242,496 an agent, 15 column tiles at K = 2); phase 22d runs all 32
LLAVA_CUT_LAYERS = 8

#: the depth of phase 8's full-width mamba2-2.7b: 32 of its 64 layers
#: (K M still past 2^31 at K = 2)
MAMBA_CUT_LAYERS = 32

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
                want_fn, K: int = 12, T: int = 2,
                layers: int | None = None, on_block=None,
                arch: str = "smollm-360m") -> tuple[dict, dict]:
    """Algorithm 1 on full-width ``arch`` (smollm-360m unless given) at K
    agents (12 unless given) through train.main (ring unless ``flags`` say
    otherwise, T local steps, q = 0.9, B = 1, S = 1024, SGD mu = 0.05,
    ``use_kernels=True``; the depth cut to ``layers`` when given) with
    ``flags``; the launch counts against ``want_fn(cfg, n_logged)``,
    finite honest losses and parameters, the block split, tokens/s and
    peak memory.  The stack is drawn on the card
    (``init_on_device=True``); ``on_block`` goes to train.main."""
    import torch

    from repro_torch.core.attacks import byzantine_mask
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    B, S, mu = 1, 1024, 0.05
    argv = ["--full", "--arch", arch, "--agents", str(K), "--local-steps",
            str(T), "--batch", str(B), "--seq", str(S), "--blocks",
            str(blocks), "--optimizer", "sgd", "--step-size", str(mu),
            "--participation", "0.9", *flags]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = train.main(argv, use_kernels=True, num_layers=layers,
                     on_block=on_block, init_on_device=True)
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
    row = {"arch": arch, "layers": cfg.num_layers, "agents": K,
           "local_steps": T, "batch": B, "seq": S, "blocks": blocks,
           "optimizer": "sgd", "step_size": mu,
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
    M = full_width_M(layers=CUT_LAYERS)

    def want(cfg, n_logged):
        return with_backward(
            {"gather_robust_mix": num_tiles(K, M) * blocks,
             "flash_attention": cfg.num_layers * K * (2 * blocks + n_logged),
             "diffusion_mix": 0, "gather_mix": 0, "ssd_intra_chunk": 0,
             "diffusion_mix_int8": 0}, cfg, cfg.num_layers * K * 2 * blocks)

    out, row = _train_full(card, "phase 11a",
                           BYZANTINE_FLAGS + ["--robust-gather", "fused"],
                           blocks, want, layers=CUT_LAYERS)
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
    M = full_width_M(layers=CUT_LAYERS)

    def want(cfg, n_logged):
        return with_backward(
            {"gather_mix": num_tiles(K, M) * blocks,
             "flash_attention": cfg.num_layers * K * (2 * blocks + n_logged),
             "diffusion_mix": 0, "gather_robust_mix": 0,
             "ssd_intra_chunk": 0, "diffusion_mix_int8": 0},
            cfg, cfg.num_layers * K * 2 * blocks)

    out, row = _train_full(card, "phase 11b",
                           ["--mix", "gather", "--attack", "none"], blocks,
                           want, layers=CUT_LAYERS)
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
    with SharedStack() as shared:
        stack, _ = shared.load(path, tf.param_specs(cfg, num_agents=K),
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
        with SharedStack():
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
    M = full_width_M(layers=CUT_LAYERS)
    tiles = num_tiles(K, M, int8=True)

    def want(cfg, n_logged):
        return with_backward(
            {"diffusion_mix_int8": tiles * blocks,
             "flash_attention": cfg.num_layers * K * (2 * blocks + n_logged),
             "diffusion_mix": 0, "gather_mix": 0, "gather_robust_mix": 0,
             "ssd_intra_chunk": 0}, cfg, cfg.num_layers * K * 2 * blocks)

    out, row = _train_full(card, "phase 14a", ["--mix", "pallas",
                                               *COMPRESSED_FEDAVG_FLAGS],
                           blocks, want, K=K, layers=CUT_LAYERS)
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
    M = full_width_M(layers=CUT_LAYERS)

    def want(cfg, n_logged):
        return with_backward(
            {"diffusion_mix": num_tiles(K, M) * blocks,
             "flash_attention": cfg.num_layers * K * (blocks + n_logged),
             "diffusion_mix_int8": 0, "gather_mix": 0,
             "gather_robust_mix": 0, "ssd_intra_chunk": 0},
            cfg, cfg.num_layers * K * blocks)

    out, row = _train_full(card, "phase 14b", ["--mix", "pallas",
                                               *COMPRESSED_DIFFUSION_FLAGS],
                           blocks, want, K=K, T=1, layers=CUT_LAYERS)
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
                         tol: float = 1e-4, spec=None) -> dict:
    """One compressed preset at smoke size, card against CPU, block by
    block from the CPU's state: the engine as train.main builds it (SGD,
    q = 0.9, ``use_kernels=True``, --mix pallas; or, given ``spec``, the
    engine ``repro_torch.api.build`` makes of it, with its K, T and mu),
    every block's batch and mask from one host generator, the fused path's
    rounding uniforms drawn on the host from a second one and injected
    into both.

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
    if spec is not None:
        K, T = spec.run.num_agents, spec.run.local_steps
        preset = {"compress": spec.compression.kind,
                  "compress_ratio": spec.compression.ratio}
    kind = preset["compress"]

    def loss(p, b):
        return tf.train_loss(p, cfg, b, remat=False)

    def agent_losses(p, batch):
        with torch.no_grad():
            return [loss(tree_map(lambda x, k=k: x[k], p),
                         tree_map(lambda x, k=k: x[0, k], batch)).item()
                    for k in range(K)]

    if spec is None:
        dcfg = DiffusionConfig(num_agents=K, local_steps=T, step_size=mu,
                               participation=0.9, mix="pallas", **preset)
        eng = {dev: DiffusionEngine(dcfg, loss, device=dev)
               for dev in ("cpu", "cuda")}
    else:
        from repro_torch.api import build
        eng = {dev: build(spec, loss, engine="stacked", device=dev)
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


#: phase 14c's two compressed presets at smoke size (K = 8, SGD mu 0.05, q
#: 0.9, --mix pallas; T = 2 for int8, 1 for top-k)
COMPRESSED_SMOKE = {"compressed_fedavg": {"topology": "fedavg",
                                          "compress": "int8",
                                          "error_feedback": True},
                    "compressed_diffusion": {"topology": "ring",
                                             "compress": "topk",
                                             "compress_ratio": 0.1,
                                             "error_feedback": True}}


def phase_compressed_devices() -> dict:
    """Phase 14c: both presets at smoke size (K = 8), card against CPU
    block by block with the same injected draws, every threshold flip
    accounted for (:func:`_lockstep_compressed`)."""
    rows = {}
    for name, preset in COMPRESSED_SMOKE.items():
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
    with SharedStack():
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
        return with_backward(
            {"diffusion_mix": num_tiles(K, M) * blocks,
             "flash_attention": cfg.num_layers * K * (2 * blocks + n_logged),
             "gather_mix": 0, "gather_robust_mix": 0,
             "ssd_intra_chunk": 0, "diffusion_mix_int8": 0},
            cfg, cfg.num_layers * K * 2 * blocks)
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
    M = full_width_M(layers=CUT_LAYERS)
    out, row = _train_full(card, "phase 16a", LINK_DROPOUT_MARKOV_FLAGS,
                           blocks, _graph_launches(K, M, blocks), K=K,
                           layers=CUT_LAYERS)
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
    M = full_width_M(layers=CUT_LAYERS)
    out, row = _train_full(card, "phase 16b", TV_ERDOS_CYCLIC_FLAGS, blocks,
                           _graph_launches(K, M, blocks), K=K,
                           layers=CUT_LAYERS)
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
#: every graph kind x mixer x process but link dropout 0.3 under
#: ``pallas`` and the i.i.d. process, which phase 19c's
#: link_dropout_diffusion preset holds card against CPU at K = 8 under the
#: same gates
GRAPH_DEVICE_CASES = [
    (graph, mixer, _PROCESSES[(i + j) % 3])
    for i, graph in enumerate((["--graph", "link_dropout", "--link-drop",
                                "0.3"],
                               ["--graph", "link_dropout", "--link-drop",
                                "0.3", "--graph-corr", "0.6"],
                               ["--graph", "gossip"]))
    for j, mixer in enumerate(_ON_SUPPORT_MIXERS) if i + j] + [
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
        return with_backward(
            {"diffusion_mix": num_tiles(K, M) * n_logged if mixed else 0,
             "flash_attention": cfg.num_layers * K * 3 * n_logged,
             "gather_mix": 0, "gather_robust_mix": 0,
             "ssd_intra_chunk": 0, "diffusion_mix_int8": 0},
            cfg, cfg.num_layers * K * 2 * n_logged)
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
    M = full_width_M(layers=CUT_LAYERS)
    out, row = _train_full(card, "phase 18a", PRIVATE_DIRICHLET_FLAGS, blocks,
                           _private_launches(K, M, True), K=K,
                           layers=CUT_LAYERS)
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
    M = full_width_M(layers=CUT_LAYERS)
    out, row = _train_full(card, "phase 18b", PRIVATE_SECURE_AGG_FLAGS,
                           blocks, _private_launches(K, M, False), K=K,
                           layers=CUT_LAYERS)
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


# ---------------------------------------------------------------------------
# phase 19: the experiment API and the async engine
# ---------------------------------------------------------------------------

#: phase 19a's run: the event-driven engine at full width
ASYNC_FLAGS = ["--engine", "async", "--async-rate-dist", "lognormal",
               "--async-rate-sigma", "0.5", "--async-rate-seed", "0",
               "--async-tau-max", "4", "--async-discount", "exp",
               "--async-discount-rate", "0.1", "--mix", "auto"]


class _Tee:
    """Copy what is printed into a buffer while still printing it."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def phase_train_async(card: str, scratch: Path) -> tuple[dict, dict, str]:
    """Phase 19a: full-width smollm-360m (``CUT_LAYERS`` of its 32 layers,
    for the checkpoint's bytes), K = 8 ring, q = 0.9,
    T = 2, SGD mu = 0.05, B = 1 x 1024, 3 blocks through ``train.main``
    with ``--engine async`` (lognormal rates, sigma 0.5, seed 0; tau_max
    4; exp discount 0.1; ``--mix auto``) and ``--checkpoint``.  Each block:
    non-fired agents bit-equal, every slot's age reset on a fired source
    and one older otherwise, every combination row summing to 1 within
    1e-6; then the clocks equal the fires times the delays (rtol 1e-5), a
    block with 0 < fires < K, the launch counts (``flash_attention`` only:
    the staleness-buffer combination is a plain batched product)."""
    import os

    import numpy as np
    import torch

    from repro_torch.core.topology import make_topology
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    K, T, B, S, blocks, mu = 8, 2, 1, 1024, 3, 0.05
    path = str(scratch / "async_k8.npz")
    argv = ["--full", "--agents", str(K), "--local-steps", str(T),
            "--batch", str(B), "--seq", str(S), "--blocks", str(blocks),
            "--optimizer", "sgd", "--step-size", str(mu), "--participation",
            "0.9", *ASYNC_FLAGS, "--checkpoint", path]
    idx = torch.as_tensor(make_topology("ring", K).neighbor_table()[0],
                          dtype=torch.long, device="cuda")
    checks = []

    def on_block(i, before, after, metrics):
        fire = metrics["active"]
        dead = fire == 0
        kept = all(torch.equal(a[dead], b[dead]) for a, b in
                   zip(tree_leaves(after.params), tree_leaves(before.params)))
        want_ages = torch.where(fire[idx] > 0, 0,
                                before.async_state["ages"] + 1).int()
        ages = torch.equal(after.async_state["ages"], want_ages)
        row_err = (metrics["weights"].double().sum(1) - 1.0).abs().max()
        checks.append({"fires": int(fire.sum()), "kept": kept,
                       "ages": ages, "row_sum_err": row_err.item()})
        if not (kept and ages and row_err.item() <= 1e-6):
            raise AssertionError(f"phase 19a: block {i}: {checks[-1]}")

    saved = {}
    save = train.save_experiment

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        save(*args, **kwargs)
        saved["s"] = time.perf_counter() - t0

    free_gb = shutil.disk_usage(scratch).free / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    train.save_experiment = timed_save
    try:
        t0 = time.perf_counter()
        out = train.main(argv, use_kernels=True, on_block=on_block,
                         init_on_device=True, num_layers=CUT_LAYERS)
        wall = time.perf_counter() - t0
    finally:
        train.save_experiment = save
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, eng, state = out["cfg"], out["engine"], out["state"]
    n_logged = len(out["losses"])
    want = with_backward(
        {"flash_attention": cfg.num_layers * K * (T * blocks + n_logged),
         "diffusion_mix": 0, "gather_mix": 0, "gather_robust_mix": 0,
         "ssd_intra_chunk": 0, "diffusion_mix_int8": 0},
        cfg, cfg.num_layers * K * T * blocks)
    if launches != want:
        raise AssertionError(f"phase 19a: launches {launches}, expected "
                             f"{want}")
    if eng.engine_kind != "async" or len(checks) != blocks:
        raise AssertionError("phase 19a: the async engine did not run "
                             "every block")
    fires = np.sum(out["active"], axis=0)
    t_local = state.async_state["t_local"].double().cpu().numpy()
    if not np.allclose(t_local, fires * eng.delays, rtol=1e-5, atol=0):
        raise AssertionError(f"phase 19a: clocks {t_local} != fires "
                             f"{fires} x delays {eng.delays}")
    mixed = [0 < sum(a) < K for a in out["active"]]
    print(f"phase 19a: rates {np.round(eng.rates, 4).tolist()} (delays "
          f"{np.round(eng.delays, 4).tolist()} s); realized fire masks "
          f"{out['active']}")
    if not any(mixed):
        raise AssertionError("phase 19a: no block with 0 < fires < K at "
                             "this seed: raise K or the blocks")
    losses = torch.tensor(out["losses"])
    if not torch.isfinite(losses).all() or not all(
            torch.isfinite(x).all() for x in tree_leaves(state.params)):
        raise AssertionError("phase 19a: non-finite losses or parameters")
    for i, (t, tps) in enumerate(zip(out["timings"], out["tokens_per_s"])):
        print(f"phase 19a: block {i}: {t['block_s']:.3f}s (local updates "
              f"{t['local_s']:.3f}s, receive + combination "
              f"{t['combine_s']:.3f}s), {tps:.0f} tokens/s, fires "
              f"{checks[i]['fires']}/{K}, row sums within "
              f"{checks[i]['row_sum_err']:.1e} of 1 [{card}]")
    buf_gb = sum(x.numel() * x.element_size() for x in
                 tree_leaves(state.async_state["buffer"])) / 1e9
    size_gb = os.path.getsize(path) / 1e9
    print(f"phase 19a: non-fired agents bit-equal and ages exact in every "
          f"block; clocks = fires x delays; launches {launches}; peak "
          f"device memory {peak_gb:.2f} GB (the staleness buffer "
          f"{buf_gb:.2f} GB); checkpoint {size_gb:.2f} GB written in "
          f"{saved['s']:.1f}s ({free_gb:.0f} GB free before); train.main "
          f"took {wall:.1f}s [{card}]")
    row = {"arch": "smollm-360m", "layers": cfg.num_layers, "agents": K,
           "local_steps": T, "batch": B, "seq": S, "blocks": blocks,
           "flags": ASYNC_FLAGS, "timings": out["timings"],
           "tokens_per_s": out["tokens_per_s"], "losses": out["losses"],
           "fire_masks": out["active"], "rates": eng.rates.tolist(),
           "t_wall": out["t_wall"], "checks": checks, "launches": launches,
           "peak_mem_gb": peak_gb, "buffer_gb": buf_gb,
           "checkpoint_gb": size_gb, "save_s": saved["s"], "card": card}
    print(json.dumps({"phase": "19a", **row}))
    del out, state, eng
    torch.cuda.empty_cache()
    return launches, row, path


def phase_serve_async(path: str, card: str) -> tuple[dict, dict]:
    """Phase 19b: 19a's checkpoint through ``serve.main`` with no spec
    flag: the engine rebuilt from the stored spec, the freshness-weighted
    consensus (held against a float64 sum over the loaded stack within one
    bf16 ulp plus the float32 summation bound), prefill of 4 prompts of
    128 and 32 greedy steps, twice (the same tokens)."""
    import contextlib
    import dataclasses

    import torch

    from repro_torch.api import EngineState
    from repro_torch.checkpoint import load_experiment, load_spec
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    argv = ["--checkpoint", path, "--batch", "4", "--prompt-len", "128",
            "--decode", "32", "--temperature", "0"]
    tee = _Tee(sys.stdout)
    reset_launches()
    with contextlib.redirect_stdout(tee):
        first = serve.main(argv, num_layers=CUT_LAYERS)
    launches = read_launches()
    second = serve.main(argv, num_layers=CUT_LAYERS)
    printed = "".join(tee.text)
    if "async checkpoint: freshness-weighted consensus" not in printed:
        raise AssertionError("phase 19b: serve did not weight the "
                             "consensus by freshness")
    if any(launches.values()):
        raise AssertionError(f"phase 19b: launches {launches}: the "
                             "weighted consensus is a plain product")
    if not torch.equal(first["tokens"], second["tokens"]):
        raise AssertionError("phase 19b: two greedy runs differ")
    spec = load_spec(path)
    K, bundle = spec.run.num_agents, get_config(spec.model.arch)
    cfg = dataclasses.replace(bundle.smoke if spec.model.smoke
                              else bundle.model, num_layers=CUT_LAYERS)
    toks = first["tokens"]
    if (tuple(toks.shape) != (4, 32) or toks.min() < 0
            or toks.max() >= cfg.vocab_size):
        raise AssertionError(f"phase 19b: tokens out of range {toks}")
    stack, _ = load_experiment(path, EngineState(tf.param_specs(
        cfg, num_agents=K)), device="cuda")
    w = first["weights"].double()
    w = w / w.sum()

    def exact():
        # float64 sum_k w_k x_k / sum_k w_k in column slices of each leaf
        width = CHECK_SLICE // K
        for got, x, floor in zip(tree_leaves(first["params"]),
                                 tree_leaves(stack.params),
                                 _sum_floors(stack.params, 2 * K)):
            got, x = got.reshape(-1), x.reshape(K, -1)
            for a in range(0, x.shape[1], width):
                want = torch.tensordot(w, x[:, a:a + width].double(), dims=1)
                yield got[a:a + width], want, floor

    gate = _ulp_gate("phase 19b: freshness-weighted consensus vs float64",
                     exact())
    t = first["timings"]
    weights = [round(x, 5) for x in first["weights"].tolist()]
    print(f"phase 19b: weights {weights}; load {t['load_s']:.2f}s, "
          f"consensus {t['consensus_s']:.3f}s, prefill {t['prefill_s']:.3f}s, decode {t['decode_s']:.3f}s "
          f"({first['tokens_per_s']:.1f} tokens/s); second run: load "
          f"{second['timings']['load_s']:.2f}s, consensus "
          f"{second['timings']['consensus_s']:.3f}s; greedy tokens repeat "
          f"[{card}]")
    row = {"weights": first["weights"].tolist(), "first_run": t,
           "second_run": second["timings"],
           "tokens_per_s": [first["tokens_per_s"], second["tokens_per_s"]],
           "consensus_vs_float64": gate, "launches": launches, "card": card}
    print(json.dumps({"phase": "19b", **row}))
    del first, second, stack
    torch.cuda.empty_cache()
    return launches, row


#: phase 19c: shared flags of every preset's smoke run (K = 8)
PRESET_COMMON = ["--agents", "8", "--local-steps", "2", "--step-size",
                 "0.05", "--participation", "0.9", "--blocks", "3",
                 "--batch", "2", "--seq", "64"]

#: each preset written out in hand-written flags over PRESET_COMMON: the
#: same ExperimentSpec (``--optimizer sgd --compress-ratio 1.0`` restore
#: the presets' defaults where the bare flags' differ)
PRESET_FLAGS = {
    "fedavg_full": ["--topology", "fedavg", "--participation", "1.0"],
    "fedavg_partial_uniform": ["--topology", "fedavg"],
    "vanilla_diffusion": ["--local-steps", "1", "--participation", "1.0"],
    "asynchronous_diffusion": ["--local-steps", "1"],
    "decentralized_fedavg": ["--participation", "1.0"],
    "cyclic_fedavg": ["--topology", "fedavg", "--participation-process",
                      "cyclic", "--num-groups", "2", "--participation",
                      "0.5"],
    "markov_asynchronous_diffusion": ["--local-steps", "1",
                                      "--participation-process", "markov",
                                      "--markov-corr", "0.5"],
    "link_dropout_diffusion": ["--graph", "link_dropout", "--link-drop",
                               "0.3", "--graph-corr", "0.0"],
    "compressed_diffusion": ["--compress", "topk", "--compress-ratio", "0.1",
                             "--error-feedback"],
    "compressed_fedavg": ["--topology", "fedavg", "--compress", "int8",
                          "--error-feedback"],
    "byzantine_robust_diffusion": ["--mix", "trimmed_mean", "--trim", "1",
                                   "--robust-scope", "neighborhood",
                                   "--attack", "sign_flip", "--attack-num",
                                   "1", "--attack-scale", "3.0"],
    "private_diffusion": ["--privacy", "--privacy-epsilon", "8",
                          "--privacy-delta", "1e-5", "--privacy-clip", "1.0",
                          "--privacy-secure-agg"],
    "heterogeneous_diffusion": ["--topology", "scale_free",
                                "--local-steps-mode", "degree", "--data",
                                "dirichlet", "--data-alpha", "0.1",
                                "--data-clusters", "4"],
}


def preset_argvs(name: str) -> tuple[list, list]:
    """(``--preset`` argv, hand-written argv) of one preset's phase-19c
    run: ``--mix pallas`` overlaid on every preset but the robust one,
    which keeps its trimmed mean."""
    mix = [] if name == "byzantine_robust_diffusion" else ["--mix", "pallas"]
    by_flags = [*PRESET_COMMON, "--optimizer", "sgd", "--compress-ratio",
                "1.0", *PRESET_FLAGS[name], *mix]
    return ["--preset", name, *PRESET_COMMON, *mix], by_flags


def _preset_launches(spec, cfg, out) -> dict:
    """The launch counts a preset's smoke run must make."""
    from repro_torch.tree import tree_leaves

    K, T = spec.run.num_agents, spec.run.local_steps
    n, logged = out["blocks_done"], len(out["losses"])
    M = sum(x[0].numel() for x in tree_leaves(out["state"].params))
    want = dict.fromkeys(kernel_wrappers(), 0)
    want["flash_attention"] = cfg.num_layers * K * (T * n + logged)
    with_backward(want, cfg, cfg.num_layers * K * T * n)
    if (spec.mixer.kind in ("trimmed_mean", "median")
            and spec.mixer.scope == "neighborhood"):
        # the neighborhood trimmed mean and median fuse on CUDA ("auto")
        want["gather_robust_mix"] = num_tiles(K, M) * n
    elif spec.privacy.enabled and spec.privacy.secure_agg:
        pass                      # the wire masks carry the combination
    elif spec.compression.kind == "int8":
        want["diffusion_mix_int8"] = num_tiles(K, M, int8=True) * n
    elif spec.mixer.kind == "pallas":
        want["diffusion_mix"] = num_tiles(K, M) * n
    return want


def _card_vs_cpu(label: str, card_out: dict, cpu_out: dict) -> dict:
    """Phase 6's SGD gates: the same masks and realized matrices, losses
    within 1e-4 relative, parameters within 1e-4."""
    import numpy as np
    import torch

    from repro_torch.tree import tree_leaves

    if card_out["active"] != cpu_out["active"]:
        raise AssertionError(f"{label}: card and CPU realized different "
                             "masks")
    if not all(torch.equal(a, b) for a, b in zip(card_out["graphs"],
                                                 cpu_out["graphs"])):
        raise AssertionError(f"{label}: card and CPU realized different "
                             "graphs")
    loss_rel = float(np.max(np.abs(np.subtract(card_out["losses"],
                                               cpu_out["losses"]))
                            / np.abs(cpu_out["losses"])))
    worst = max((a.cpu().float() - b.float()).abs().max().item()
                for a, b in zip(tree_leaves(card_out["state"].params),
                                tree_leaves(cpu_out["state"].params)))
    if not (loss_rel <= 1e-4 and worst <= 1e-4):
        raise AssertionError(f"{label}: card vs CPU losses {loss_rel:.2e}, "
                             f"parameters {worst:.2e} (gates 1e-4)")
    return {"loss_rel": loss_rel, "param_max_abs": worst}


class _ClipOnly:
    """Within it, the privacy tier's clip-and-noise transform clips only
    (noise multiplier 0) while the accountant keeps its calibrated sigma:
    the card and the CPU draw their noise from their own device streams,
    so they are compared at noise 0, as phase 18c does."""

    def __enter__(self):
        from repro_torch.core import privacy

        self.wrap = privacy.Privacy.wrap

        def clip_only(tier, inner):
            return privacy.PrivateGradients(
                tier.clip, 0.0, seed=tier.seed, inner=inner).as_transform()

        privacy.Privacy.wrap = clip_only
        return self

    def __exit__(self, *exc):
        from repro_torch.core import privacy

        privacy.Privacy.wrap = self.wrap
        return False


def phase_presets(card: str) -> dict:
    """Phase 19c: each of the 13 presets through ``train.main(["--preset",
    name, ...])`` at smoke size (K = 8, T = 2 unless the preset fixes it,
    q = 0.9, B = 2, S = 64, 3 blocks, SGD mu = 0.05; ``--mix pallas``
    overlaid on all but the robust one): its exact launch counts; the
    hand-written flags of :data:`PRESET_FLAGS` parse to the same spec JSON
    (``train.main`` runs the spec, so a second run from those flags would
    repeat the first); and the card against the CPU under phase 6's gates
    (the compressed presets block by block with injected draws,
    :func:`_lockstep_compressed`, but compressed_fedavg, whose lockstep
    phase 14c runs on the same configuration; the private one at noise 0,
    :class:`_ClipOnly`).  Then ``--engine auto`` on a transformer spec
    builds the sharded engine, as the reference's does, and ``--engine
    sharded`` trains."""
    import contextlib
    import io

    import torch

    from repro_torch.api.cli import spec_from_args
    from repro_torch.core.diffusion import DiffusionConfig
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    rows, totals = {}, dict.fromkeys(kernel_wrappers(), 0)
    for name in sorted(PRESET_FLAGS):
        by_preset, by_flags = preset_argvs(name)
        ap = train._parser()
        spec = spec_from_args(ap.parse_args(by_preset))
        if spec.to_json() != spec_from_args(ap.parse_args(
                by_flags)).to_json():
            raise AssertionError(f"phase 19c: {name}: the hand-written "
                                 "flags denote another spec")
        reset_launches()
        t0 = time.perf_counter()
        a = train.main(by_preset, use_kernels=True)
        preset_s = time.perf_counter() - t0
        launches = read_launches()
        want = _preset_launches(spec, a["cfg"], a)
        if launches != want:
            raise AssertionError(f"phase 19c: {name}: launches {launches}, "
                                 f"expected {want}")
        if name == "compressed_fedavg":
            # phase 14c ran this very configuration card against CPU in
            # lockstep; a second lockstep would repeat it
            want_cfg = DiffusionConfig(
                num_agents=8, local_steps=2, step_size=0.05,
                participation=0.9, mix="pallas", **COMPRESSED_SMOKE[name])
            if spec.to_diffusion_config() != want_cfg:
                raise AssertionError(f"phase 19c: {name} is not phase "
                                     "14c's configuration")
            gate = {"lockstep": "phase 14c, the same configuration"}
        elif spec.compression.kind != "none":
            r = _lockstep_compressed(name, None, spec=a["spec"])
            gate = {"lockstep": r}
        elif spec.privacy.enabled:
            with _ClipOnly():
                on_card = train.main(by_preset, use_kernels=True)
                on_cpu = train.main(by_preset + ["--device", "cpu"],
                                    use_kernels=True)
            gate = _card_vs_cpu(f"phase 19c: {name} (noise 0)", on_card,
                                on_cpu)
            eps_rel = max(abs(x - y) / y for x, y in zip(
                on_card["epsilon"], on_cpu["epsilon"]))
            if not eps_rel <= 1e-6:
                raise AssertionError(f"phase 19c: {name}: epsilon card vs "
                                     f"CPU {eps_rel:.2e}")
            gate["epsilon_rel"] = eps_rel
        else:
            gate = _card_vs_cpu(f"phase 19c: {name}", a, train.main(
                by_preset + ["--device", "cpu"], use_kernels=True))
        for k, v in launches.items():
            totals[k] += v
        rows[name] = {"launches": launches, "blocks_done": a["blocks_done"],
                      "preset_s": preset_s, "card_vs_cpu": gate}
        print(f"phase 19c: {name}: {a['blocks_done']} blocks in "
              f"{preset_s:.2f}s, launches "
              f"{ {k: v for k, v in launches.items() if v} }; --preset == "
              f"hand-written flags (one spec JSON); card vs CPU {gate} "
              f"[{card}]")
        del a
    argv = ["--agents", "2", "--blocks", "1", "--batch", "1", "--seq", "16"]
    with contextlib.redirect_stdout(io.StringIO()):
        auto = train.main(argv, use_kernels=True)
        sharded = train.main(argv + ["--engine", "sharded"],
                             use_kernels=True)
    if (auto["engine"].engine_kind != "sharded"
            or sharded["engine"].engine_kind != "sharded"
            or not all(torch.equal(x, y) for x, y in zip(
                tree_leaves(auto["state"].params),
                tree_leaves(sharded["state"].params)))):
        raise AssertionError("phase 19c: --engine auto did not build the "
                             "sharded engine --engine sharded builds")
    print(f"phase 19c: all 13 presets passed; --engine auto builds the "
          f"sharded engine (== --engine sharded, bit-equal); launches over "
          f"the presets {totals} [{card}]")
    print(json.dumps({"phase": "19c", "presets": rows, "card": card},
                     default=str))
    return totals


def _exact_diffusion_means(device: str, dtype: str = "float32",
                           blocks: int = 1200, tail: int = 600) -> dict:
    """The recipe of the reference's tests/test_extensions.py: K = 8 ring,
    heterogeneous regression, mu 0.01, batches of 8 from one host
    generator; vanilla diffusion through the engine and exact diffusion
    through ``ExactDiffusionEngine``, in ``dtype``, each's network mean
    averaged over the last ``tail`` blocks, and microseconds a block."""
    import numpy as np
    import torch

    from repro_torch.core import variants
    from repro_torch.core.diffusion import DiffusionEngine
    from repro_torch.data.synthetic import (make_block_sampler,
                                            make_regression_problem)

    K = 8
    data = make_regression_problem(K=K, N=100, M=2, rho=0.1, seed=5,
                                   mean_scale=1.5, noise_low=0.01,
                                   noise_high=0.05, w_star_spread=0.5)
    spec = variants.vanilla_diffusion(K, mu=0.01, topology="ring")
    draw = make_block_sampler(data, T=1, batch=8, device=device)
    dt = getattr(torch, dtype)

    def sampler(key):
        return tuple(x.to(dt) for x in draw(key))

    std = DiffusionEngine(spec.to_diffusion_config(), data.loss_fn(),
                          device=device, grad_fn=data.grad_fn())
    ed = variants.ExactDiffusionEngine(spec, data.loss_fn(), device=device,
                                       grad_fn=data.grad_fn())
    out = {"w_opt": data.problem().w_opt(None)}
    t0 = time.perf_counter()
    key = torch.Generator().manual_seed(0)
    state = std.init_state(torch.zeros((K, 2), dtype=dt, device=device),
                           key=key)
    acc = torch.zeros(2, dtype=torch.float64, device=device)
    for i in range(blocks):
        state, _ = std.step(state, sampler(key), key)
        if i >= blocks - tail:
            acc += state.params.double().mean(0)
    out["std"] = (acc / tail).cpu().numpy()
    t1 = time.perf_counter()
    key = torch.Generator().manual_seed(0)
    w = psi = torch.zeros((K, 2), dtype=dt, device=device)
    acc = torch.zeros(2, dtype=torch.float64, device=device)
    for i in range(blocks):
        w, psi = ed.step(w, psi, tuple(x[0] for x in sampler(key)))
        if i >= blocks - tail:
            acc += w.double().mean(0)
    out["exact"] = (acc / tail).cpu().numpy()
    t2 = time.perf_counter()
    out["us_std"] = (t1 - t0) / blocks * 1e6
    out["us_exact"] = (t2 - t1) / blocks * 1e6
    for k in ("std", "exact"):
        out[f"d_{k}"] = float(np.linalg.norm(out[k] - out["w_opt"]))
    return out


def phase_exact_diffusion(card: str) -> dict:
    """Phase 19d: exact diffusion on the card: its time-averaged network
    mean lies closer to w° than vanilla diffusion's (the reference's gate,
    d_ed < d_std, in float32); the same runs in float64 agree with the
    CPU's within 1e-5 relative.  In float32 the two devices drift apart
    along exact diffusion's network mean, which its correction step does
    not contract: the float32 card-vs-CPU difference is printed beside the
    CPU's own float32-vs-float64 difference (a witness of that drift)."""
    import numpy as np

    def rel(a, b):
        return max(float(np.max(np.abs(a[k] - b[k]) / np.abs(b[k])))
                   for k in ("std", "exact"))

    reset_launches()
    gpu = _exact_diffusion_means("cuda")
    launches = read_launches()
    cpu = _exact_diffusion_means("cpu")
    gpu64 = _exact_diffusion_means("cuda", "float64")
    cpu64 = _exact_diffusion_means("cpu", "float64")
    row = {"d_exact": gpu["d_exact"], "d_std": gpu["d_std"],
           "card_vs_cpu_rel_f64": rel(gpu64, cpu64),
           "card_vs_cpu_rel_f32": rel(gpu, cpu),
           "cpu_f32_vs_f64_rel": rel(cpu, cpu64),
           "us_exact": gpu["us_exact"], "us_std": gpu["us_std"],
           "cpu_us_exact": cpu["us_exact"], "cpu_us_std": cpu["us_std"],
           "card": card}
    print(f"phase 19d: distance to w°: exact diffusion {gpu['d_exact']:.4e}, "
          f"vanilla {gpu['d_std']:.4e} (gate: exact closer); card vs CPU "
          f"means in float64 within {row['card_vs_cpu_rel_f64']:.2e} "
          f"relative (gate 1e-5); in float32 "
          f"{row['card_vs_cpu_rel_f32']:.2e} (the CPU's float32 vs float64: "
          f"{row['cpu_f32_vs_f64_rel']:.2e}); {gpu['us_exact']:.0f} µs an "
          f"exact block, {gpu['us_std']:.0f} µs a vanilla one (CPU "
          f"{cpu['us_exact']:.0f}, {cpu['us_std']:.0f}) [{card}]")
    if not gpu["d_exact"] < gpu["d_std"]:
        raise AssertionError("phase 19d: exact diffusion is not closer to "
                             "w° than vanilla diffusion")
    if not row["card_vs_cpu_rel_f64"] <= 1e-5:
        raise AssertionError("phase 19d: card and CPU disagree")
    if any(launches.values()):
        raise AssertionError(f"phase 19d: launches {launches}")
    print(json.dumps({"phase": "19d", **row}))
    return launches


# ---------------------------------------------------------------------------
# phase 20: the sharded engine (the reference's default training path)
# ---------------------------------------------------------------------------

#: phase 20b/20c's run: the compressed_fedavg preset (int8 + EF through the
#: fused int8 path) on the sharded engine, ``CUT_LAYERS`` layers, 2 blocks
SHARDED_INT8_FLAGS = ["--mix", "pallas", *COMPRESSED_FEDAVG_FLAGS,
                      "--engine", "sharded"]
#: the seconds phase 20b waits for its two ranks
RANK_TIMEOUT_S = 420


def _digests(tree) -> list:
    """sha256 of every leaf's bytes (bit-equality across processes)."""
    import hashlib

    import torch

    from repro_torch.tree import tree_leaves

    out = []
    for x in tree_leaves(tree):
        h = hashlib.sha256()
        flat = x.detach().reshape(-1)
        if x.dtype == torch.bfloat16:
            flat = flat.view(torch.int16)
        for i in range(0, flat.numel(), 1 << 27):
            h.update(flat[i:i + (1 << 27)].cpu().numpy().tobytes())
        out.append(h.hexdigest())
    return out


def phase_train_sharded(card: str) -> tuple[dict, dict]:
    """Phase 20a: the reference's default training path, world 1:
    ``train.main`` with ``--engine auto`` (no process group) builds the
    sharded engine for the transformer spec; K = 8 ring, q 0.9, T = 2, SGD
    mu 0.05, B = 1 x 1024, ``--mix pallas``, ``CUT_LAYERS`` of its 32
    layers, 3 blocks.
    Gate: one stacked-engine step from block 0's input state, with block
    0's realized mask and batch (the static ring draws no graph), gives
    parameters bit-equal to the sharded block."""
    import torch

    from repro_torch.api import build
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    K, blocks = 8, 3
    tiles = num_tiles(K, full_width_M(layers=CUT_LAYERS))
    keep = {}

    def on_block(i, before, after, metrics):
        if i == 0:
            keep.update(before=before.params, after=after.params,
                        active=metrics["active"], batch=metrics["batch"])

    def want(cfg, n_logged):
        return with_backward(
            {"diffusion_mix": tiles * blocks,
             "flash_attention": cfg.num_layers * K * (2 * blocks + n_logged),
             "diffusion_mix_int8": 0, "gather_mix": 0,
             "gather_robust_mix": 0, "ssd_intra_chunk": 0},
            cfg, cfg.num_layers * K * 2 * blocks)

    out, row = _train_full(card, "phase 20a", ["--engine", "auto", "--mix",
                                               "pallas"], blocks, want, K=K,
                           on_block=on_block, layers=CUT_LAYERS)
    eng = out["engine"]
    if eng.engine_kind != "sharded" or eng.shard is not None:
        raise AssertionError(f"phase 20a: --engine auto built "
                             f"{eng.engine_kind} (shard {eng.shard})")
    cfg, spec = out["cfg"], out["spec"]
    del out
    torch.cuda.empty_cache()

    def loss(p, b):
        return tf.train_loss(p, cfg, b, remat=False)

    stacked = build(spec, loss, engine="stacked", device="cuda")
    state, _ = stacked.step(stacked.init_state(keep["before"]),
                            keep["batch"], None, active=keep["active"])
    equal = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state.params), tree_leaves(keep["after"])))
    if not equal:
        raise AssertionError("phase 20a: the sharded block != one stacked "
                             "step from its input state")
    row["stacked_bit_equal"] = True
    print(f"phase 20a: engine sharded (auto, world 1); block 0 bit-equal "
          f"to one stacked-engine step from its input state with its mask "
          f"{keep['active'].int().tolist()} [{card}]")
    print(json.dumps({"phase": "20a", **row}))
    del keep, state
    torch.cuda.empty_cache()
    return row["launches"], row


def _int8_launches(K: int, M: int, blocks: int, agents: int | None = None):
    """Launches of phase 20b/20c's run (``agents``: the rank's rows)."""
    def want(cfg, n_logged):
        return with_backward(
            {"diffusion_mix_int8": num_tiles(K, M, int8=True) * blocks,
             "flash_attention": cfg.num_layers * (agents or K)
             * (2 * blocks + n_logged),
             "diffusion_mix": 0, "gather_mix": 0, "gather_robust_mix": 0,
             "ssd_intra_chunk": 0},
            cfg, cfg.num_layers * (agents or K) * 2 * blocks)
    return want


def phase_offload(card: str) -> tuple[dict, dict]:
    """Phase 20c: the compressed_fedavg run on the sharded engine at world
    1 (``CUT_LAYERS`` layers, 2 blocks), without and with
    ``--ef-host-offload``.
    Gates: parameters bit-equal; between blocks the pipeline memory's
    leaves are pinned CPU tensors; the peak device memory falls by at
    least three quarters of the pipeline memory (the EF residual, in the
    leaves' bf16: the step fetches it after the local updates, where the
    block peaks).  Prints the block-time cost of the copies."""
    import torch

    from repro_torch.tree import tree_leaves

    K, blocks = 8, 2
    M = full_width_M(layers=CUT_LAYERS)
    want = _int8_launches(K, M, blocks)
    pinned = []

    def on_block(i, before, after, metrics):
        pinned.append([(x.device.type, x.is_pinned())
                       for x in tree_leaves(after.comm_state)])

    off, row_off = _train_full(card, "phase 20c (no offload)",
                               SHARDED_INT8_FLAGS, blocks, want, K=K,
                               layers=CUT_LAYERS)
    # the run's parameters wait on the host, off the second run's peak
    params = [x.cpu() for x in tree_leaves(off["state"].params)]
    resid = off["state"].comm_state
    resid_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(resid))
    dtypes = sorted({str(x.dtype) for x in tree_leaves(resid)})
    del off, resid
    torch.cuda.empty_cache()
    on, row_on = _train_full(card, "phase 20c (--ef-host-offload)",
                             SHARDED_INT8_FLAGS + ["--ef-host-offload"],
                             blocks, want, K=K, layers=CUT_LAYERS,
                             on_block=on_block)
    if not all(torch.equal(a, b.cpu()) for a, b in zip(
            params, tree_leaves(on["state"].params))):
        raise AssertionError("phase 20c: parameters differ with the offload")
    if not pinned or not all(all(d == "cpu" and p for d, p in leaves)
                             for leaves in pinned):
        raise AssertionError(f"phase 20c: offloaded leaves not pinned CPU "
                             f"tensors: {pinned[:1]}")
    drop_gb = row_off["peak_mem_gb"] - row_on["peak_mem_gb"]
    if not drop_gb >= 0.75 * resid_bytes / 1e9:
        raise AssertionError(f"phase 20c: peak fell {drop_gb:.2f} GB, the "
                             f"pipeline memory is {resid_bytes / 1e9:.2f} GB")
    cost = [b["block_s"] - a["block_s"] for a, b in
            zip(row_off["timings"], row_on["timings"])]
    digests = _digests(params)
    row = {"off": row_off, "on": row_on, "resid_gb": resid_bytes / 1e9,
           "resid_dtypes": dtypes, "peak_drop_gb": drop_gb,
           "block_cost_s": cost, "card": card}
    print(f"phase 20c: offload on == off (bit-equal); offloaded leaves "
          f"pinned CPU tensors after every block; pipeline memory "
          f"{resid_bytes / 1e9:.3f} GB {dtypes}; peak device memory "
          f"{row_off['peak_mem_gb']:.2f} -> {row_on['peak_mem_gb']:.2f} GB "
          f"({drop_gb:.2f} GB); block time with the copies minus without "
          f"{[round(c, 3) for c in cost]} s [{card}]")
    print(json.dumps({"phase": "20c", **row}))
    del on, params
    torch.cuda.empty_cache()
    return row_on["launches"], row, digests


def _sharded_rank(rank: int, world: int, store: str, out: str, argv: list,
                  layers: int) -> None:
    """One rank of phase 20b (a spawned process on the same card): join the
    gloo group, train through ``train.main``, and write this rank's
    launches, peak memory, timings, the bytes its gathers moved by dtype
    and (rank 0) the digests of the gathered parameters."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train

    mesh_lib.init_agent_group("gloo", init_method=f"file://{store}",
                              rank=rank, world_size=world, timeout_s=300)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.main(argv, use_kernels=True, num_layers=layers,
                     init_on_device=True)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shard = res["engine"].shard
    wire = dict(shard.wire)
    row = {"rank": rank, "launches": launches, "peak_mem_gb": peak_gb,
           "timings": res["timings"], "wall_s": wall, "wire": wire,
           "n_logged": len(res["losses"]),
           "rows": [shard.rows.start, shard.rows.stop],
           "backend": shard.backend, "comm": res["comm"]}
    whole = shard.gather_tree(res["state"].params)
    if rank == 0:
        row["digests"] = _digests(whole)
    del whole
    Path(out, f"rank{rank}.json").write_text(json.dumps(row, default=str))
    dist.barrier()
    dist.destroy_process_group()


def phase_train_two_ranks(card: str, scratch: Path,
                          world1_digests: list) -> tuple[dict, dict]:
    """Phase 20b: phase 20c's run with ``--ef-host-offload`` on two ranks
    of a gloo group, both on ``cuda:0`` (spawned processes, a ``file://``
    rendezvous under the scratch directory): four agents a rank, each
    combination's tiles gathered as int8 codes and float32 scales.  Gate:
    the gathered parameters are bit-equal to 20c's world 1.  Prints the
    bytes each combination's gathers moved against the float32 stack's,
    the launches, peak memory and block seconds of each rank."""
    import torch
    import torch.multiprocessing as mp

    from repro_torch.core.mixing import int8_layout

    K, blocks, world = 8, 2, 2
    M = full_width_M(layers=CUT_LAYERS)
    run_dir = scratch / "phase20b"
    run_dir.mkdir(parents=True, exist_ok=True)
    argv = ["--full", "--agents", str(K), "--local-steps", "2", "--batch",
            "1", "--seq", "1024", "--blocks", str(blocks), "--optimizer",
            "sgd", "--step-size", "0.05", "--participation", "0.9",
            *SHARDED_INT8_FLAGS, "--ef-host-offload"]
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        _sharded_rank, args=(world, str(run_dir / "store"), str(run_dir),
                             argv, CUT_LAYERS),
        nprocs=world, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=2.0):
            if time.perf_counter() - t0 > RANK_TIMEOUT_S:
                raise AssertionError(f"phase 20b: the ranks did not finish "
                                     f"in {RANK_TIMEOUT_S}s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    wall = time.perf_counter() - t0
    ranks = [json.loads((run_dir / f"rank{r}.json").read_text())
             for r in range(world)]
    if ranks[0]["digests"] != world1_digests:
        raise AssertionError("phase 20b: world 2's gathered parameters != "
                             "world 1's (phase 20c)")
    tile, width, _ = int8_layout(K, M)
    float32_bytes = K * M * 4
    for r in ranks:
        # each rank trains the full (bf16) config's CUT_LAYERS layers
        want = _int8_launches(K, M, blocks, agents=K // world)(
            type("C", (), {"num_layers": CUT_LAYERS,
                           "param_dtype": torch.bfloat16}), r["n_logged"])
        if r["launches"] != want:
            raise AssertionError(f"phase 20b: rank {r['rank']} launches "
                                 f"{r['launches']}, expected {want}")
        # per block: the int8 codes and float32 scales of every tile, and
        # the K agents' float32 losses of the logged block
        want_wire = {"int8": blocks * K * width,
                     "float32": blocks * K * (width // tile) * 4
                     + r["n_logged"] * K * 4}
        if r["wire"] != want_wire:
            raise AssertionError(f"phase 20b: rank {r['rank']} gathered "
                                 f"{r['wire']}, expected {want_wire}")
    per_comb = {"int8": K * width, "float32": K * (width // tile) * 4}
    moved = per_comb["int8"] + per_comb["float32"]
    print(f"phase 20b: world 2 over gloo on one card == world 1 (phase 20c) "
          f"bit for bit; each combination's gathers moved {moved:,} bytes "
          f"(int8 codes {per_comb['int8']:,} + float32 scales "
          f"{per_comb['float32']:,}) against {float32_bytes:,} for the "
          f"float32 stack ({moved / float32_bytes:.4f}) [{card}]")
    for r in ranks:
        print(f"phase 20b: rank {r['rank']} (agents {r['rows']}, "
              f"{r['backend']}): launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }; peak "
              f"device memory {r['peak_mem_gb']:.2f} GB; blocks "
              f"{[round(t['block_s'], 3) for t in r['timings']]} s "
              f"(combination "
              f"{[round(t['combine_s'], 3) for t in r['timings']]} s); "
              f"train.main {r['wall_s']:.1f} s [{card}]")
    row = {"ranks": ranks, "wire_per_combination": per_comb,
           "float32_bytes": float32_bytes, "wire_ratio": moved / float32_bytes,
           "wall_s": wall, "card": card}
    for r in ranks:
        r.pop("digests", None)
    print(json.dumps({"phase": "20b", **row}, default=str))
    shutil.rmtree(run_dir, ignore_errors=True)
    totals = dict.fromkeys(kernel_wrappers(), 0)
    for r in ranks:
        for k, v in r["launches"].items():
            totals[k] += v
    return totals, row


#: phase 21: the MoE path and the other text archs
GRANITE = "granite-moe-1b-a400m"
# one full-width granite local step, kernel against plain attention, each
# route routed as the plain route routes (moe.Routing's replay).  Routing
# is discontinuous: where two routes round a bf16 attention output
# differently, a token's k-th expert can change or an assignment fall past
# capacity, and the gradients move by more than rounding there.  With the
# routing held, the gradients are continuous in the attention's output and
# each leaf can be held on its own.  With float32 parameters the loss
# within TRAIN_LOSS_TOL and every gradient leaf, in relative Frobenius
# norm, within MOE_GRAD_TOL_F32 (ROADMAP's gradient gate).  In bf16 the
# loss within TRAIN_LOSS_TOL and every gradient leaf within
# MOE_GRAD_WITNESS_RATIO times the same leaf's witness, taken in the same
# run: the distance from the plain route of a step whose attention is
# the kernels' rounding models (attention_bf16p_ref forward,
# attention_bf16_backward_ref backward).  The ratio is the
# triangle inequality, |kernel - plain| <= |kernel - model| + |model -
# plain|, with the kernel no farther from its model than the model from
# the plain version (phases 4 and 4b hold the kernels within their
# rounding budgets of the models; kernel against model is printed).  The
# token-expert assignments the kernel route would have chosen otherwise,
# layer by layer at the held routing, are counted and printed
MOE_GRAD_TOL_F32 = 1e-4
MOE_GRAD_WITNESS_RATIO = 2.0
#: phase 21c: (arch, tokens, layers run or None for all) of each
#: full-width forward, kernel against plain attention; phase 4 holds and
#: times each arch's attention at its shape
ARCH_FORWARDS = (("chatglm3-6b", 1024, None), ("starcoder2-15b", 8192, None),
                 ("qwen3-32b", 1024, 16), ("kimi-k2-1t-a32b", 1024, 1))
MUSICGEN = "musicgen-medium"
LLAVA = "llava-next-mistral-7b"
#: phase 22d: the two modalities at full depth (tokens after llava's
#: 2,880-token image prefix), as ARCH_FORWARDS
MODALITY_FORWARDS = ((LLAVA, 1024, None), (MUSICGEN, 1024, None))
#: the reference's decode gate (tests/test_arch_smoke.py): decode logits
#: against the uncached forward, atol = rtol
DECODE_TOL = 5e-3
#: phase 23's full-width ServeLoop: slots, chunk, cache positions, and its
#: six requests' prompt lengths (more requests than slots) and new tokens
SERVELOOP = dict(slots=4, chunk=8, max_len=256)
SERVELOOP_PROMPTS = (64, 83, 102, 121, 140, 160)
SERVELOOP_NEW = 32


def _routing_flips(a: list, b: list, E: int) -> int:
    """Token-expert assignments one route chose and the other did not."""
    import torch

    n = 0
    for x, y in zip(a, b):
        sx = torch.zeros(x.shape[0], E, device=x.device).scatter_(1, x, 1.0)
        sy = torch.zeros(y.shape[0], E, device=y.device).scatter_(1, y, 1.0)
        n += int((sx != sy).sum().item()) // 2
    return n


def _moe_grads(params, cfg, batch, replay=None):
    """Loss, gradients and the router's own choices (``moe.Routing``) of
    one agent's local step, routed by ``replay`` where given."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves, tree_unflatten

    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    with moe.Routing(replay) as routing:
        loss = tf.train_loss(tree_unflatten(params, leaves), cfg, batch,
                             remat=False)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), grads, routing.ids


@contextlib.contextmanager
def _kernel_model():
    """The kernel path with the bf16 kernels' rounding models in the
    kernels' places: ``attention_bf16p_ref`` forward (with
    ``attention_lse_ref`` where the backward kernel needs the log-sum-exp)
    and ``attention_bf16_backward_ref`` backward."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (attention_bf16_backward_ref,
                                         attention_bf16p_ref,
                                         attention_lse_ref)

    def forward(q, k, v, causal=True, window=None):
        return attention_bf16p_ref(q, k, v, causal=causal, window=window)

    def forward_lse(q, k, v, causal=True, window=None):
        return (forward(q, k, v, causal, window),
                attention_lse_ref(q, k, causal=causal, window=window))

    orig = (ops.flash_attention, ops.flash_attention_lse,
            ops.flash_attention_backward)
    ops.flash_attention, ops.flash_attention_lse = forward, forward_lse
    ops.flash_attention_backward = attention_bf16_backward_ref
    try:
        yield
    finally:
        (ops.flash_attention, ops.flash_attention_lse,
         ops.flash_attention_backward) = orig


def _granite_step_check(params, cfg, card: str) -> dict:
    """One local step of one agent at full granite width (B = 1 x 1024),
    kernel against plain attention at the plain route's routing, in bf16
    beside the rounding model's witness and in float32 (see
    MOE_GRAD_WITNESS_RATIO)."""
    import dataclasses

    import torch

    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.tree import tree_map

    E = cfg.num_experts
    batch = tree_map(lambda x: x.cuda(), lm_token_batch(
        torch.Generator().manual_seed(21), (1, 1024), cfg.vocab_size))
    kern = dataclasses.replace(cfg, use_kernels=True)
    plain = dataclasses.replace(cfg, use_kernels=False)
    loss_p, g_p, r_p = _moe_grads(params, plain, batch)
    loss_k, g_k, r_k = _moe_grads(params, kern, batch, r_p)
    with _kernel_model():
        loss_m, g_m, _ = _moe_grads(params, kern, batch, r_p)
    kernel, kernel_layers = _grad_rels(params, g_k, g_p)
    model, model_layers = _grad_rels(params, g_m, g_p)
    k_vs_m, _ = _grad_rels(params, g_k, g_m)
    del g_k, g_m, g_p
    p32 = tree_map(lambda x: x.float(), params)
    cfg32 = dataclasses.replace(plain, dtype="float32")
    loss_p32, g_p32, r_p32 = _moe_grads(p32, cfg32, batch)
    loss_k32, g_k32, r_k32 = _moe_grads(
        p32, dataclasses.replace(cfg32, use_kernels=True), batch, r_p32)
    f32, f32_layers = _grad_rels(p32, g_k32, g_p32)
    del p32, g_k32, g_p32
    torch.cuda.empty_cache()
    ratio = {n: kernel[n] / max(model[n], 1e-30) for n in kernel}
    n_assign = len(r_p) * r_p[0].numel()
    res = {"loss_kernel": loss_k, "loss_plain": loss_p, "loss_model": loss_m,
           "loss_rel_kernel_vs_plain": abs(loss_k - loss_p) / abs(loss_p),
           "loss_rel_f32": abs(loss_k32 - loss_p32) / abs(loss_p32),
           "assignments": n_assign,
           "routing_flips_bf16": _routing_flips(r_k, r_p, E),
           "routing_flips_f32": _routing_flips(r_k32, r_p32, E),
           "grad_bf16_kernel_vs_plain": {"leaf": _summary(kernel),
                                         "layer": _summary(kernel_layers)},
           "grad_bf16_model_vs_plain": {"leaf": _summary(model),
                                        "layer": _summary(model_layers)},
           "grad_bf16_kernel_vs_model": {"leaf": _summary(k_vs_m)},
           "grad_bf16_ratio_to_witness": _summary(ratio),
           "grad_f32_kernel_vs_plain": {"leaf": _summary(f32),
                                        "layer": _summary(f32_layers)}}
    for name in ("grad_bf16_kernel_vs_plain", "grad_bf16_model_vs_plain",
                 "grad_bf16_kernel_vs_model", "grad_f32_kernel_vs_plain"):
        for unit, r in res[name].items():
            print(f"phase 21a: {name} per {unit}: worst {r['worst']} "
                  f"{r['worst_rel']:.3e}, median {r['median_rel']:.3e}")
    worst = res["grad_bf16_ratio_to_witness"]
    f32_worst = res["grad_f32_kernel_vs_plain"]["leaf"]["worst_rel"]
    print(f"phase 21a: one local step at the plain route's routing, kernel "
          f"vs plain attention: bf16 loss {loss_k:.6f} vs {loss_p:.6f} (rel "
          f"{res['loss_rel_kernel_vs_plain']:.2e}), float32 loss rel "
          f"{res['loss_rel_f32']:.2e} (gate {TRAIN_LOSS_TOL}); float32 "
          f"worst gradient leaf {f32_worst:.3e} (gate {MOE_GRAD_TOL_F32}); "
          f"bf16 gradient "
          f"leaves at most {worst['worst_rel']:.3f} times their witness "
          f"({worst['worst']}; median {worst['median_rel']:.3f}; gate "
          f"{MOE_GRAD_WITNESS_RATIO}); token-expert assignments of "
          f"{n_assign:,} the kernel route would have chosen otherwise: "
          f"{res['routing_flips_bf16']} (bf16), {res['routing_flips_f32']} "
          f"(float32) [{card}]")
    if not (res["loss_rel_f32"] <= TRAIN_LOSS_TOL
            and res["loss_rel_kernel_vs_plain"] <= TRAIN_LOSS_TOL):
        raise AssertionError("phase 21a: full-width granite loss: kernel "
                             "path != plain")
    over = [n for n, r in f32.items() if not r <= MOE_GRAD_TOL_F32]
    if over:
        raise AssertionError(f"phase 21a: full-width granite float32 "
                             f"gradients beyond {MOE_GRAD_TOL_F32}: {over}")
    over = [n for n in kernel
            if not kernel[n] <= MOE_GRAD_WITNESS_RATIO * model[n]]
    if over:
        raise AssertionError(f"phase 21a: full-width granite bf16 gradients "
                             f"beyond {MOE_GRAD_WITNESS_RATIO} times their "
                             f"witness: {over}")
    return res


def _block0_keeper():
    """(keep, on_block): ``on_block`` for train.main that keeps block 0's
    input and output stacks, realized mask and batch in ``keep``."""
    keep = {}

    def on_block(i, before, after, metrics):
        if i == 0:
            keep.update(before=before.params, after=after.params,
                        active=metrics["active"], batch=metrics["batch"])

    return keep, on_block


def _train_launches(K: int, tiles: int, blocks: int, T: int = 2):
    """``want_fn`` of a full-width run through ``--mix pallas``: one
    ``diffusion_mix`` launch a tile a block, one ``flash_attention`` a
    layer a local step an agent plus the logging forwards, no other."""
    def want(cfg, n_logged):
        return with_backward(
            {"diffusion_mix": tiles * blocks,
             "flash_attention": cfg.num_layers * K * (T * blocks + n_logged),
             "diffusion_mix_int8": 0, "gather_mix": 0,
             "gather_robust_mix": 0, "ssd_intra_chunk": 0},
            cfg, cfg.num_layers * K * T * blocks)
    return want


def _check_sharded_world1(label: str, eng) -> None:
    if eng.engine_kind != "sharded" or eng.shard is not None:
        raise AssertionError(f"{label}: --engine auto built "
                             f"{eng.engine_kind} (shard {eng.shard})")


def _check_stacked_step(label: str, spec, cfg, keep: dict) -> None:
    """One stacked-engine step from block 0's input state, under its
    realized mask and batch, bit-equal to the sharded block (``keep`` from
    :func:`_block0_keeper`)."""
    import torch

    from repro_torch.api import build
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    def loss(p, b):
        return tf.train_loss(p, cfg, b, remat=False)

    stacked = build(spec, loss, engine="stacked", device="cuda")
    state, _ = stacked.step(stacked.init_state(keep["before"]),
                            keep["batch"], None, active=keep["active"])
    equal = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state.params), tree_leaves(keep["after"])))
    if not equal:
        raise AssertionError(f"{label}: the sharded block != one stacked "
                             "step from its input state")
    del state, stacked
    torch.cuda.empty_cache()


def phase_train_granite(card: str, scratch: Path) -> tuple[dict, dict, str]:
    """Phase 21a: granite-moe-1b-a400m at full width (24 layers, 32
    experts top 8), through ``train.main`` with ``--engine auto`` (the
    sharded engine, world 1), K = 4 ring, q 0.9, T = 2, SGD mu 0.05, B = 1
    x 1024, ``--mix pallas``, 2 blocks, the stack drawn on the card, and
    ``--checkpoint``: the launch counts exact, block 0 bit-equal to one
    stacked-engine step from its input state, then one local step of
    agent 0, kernel against plain attention (``_granite_step_check``)."""
    import torch

    from repro_torch.tree import tree_leaves, tree_map

    K, blocks = 4, 2
    M = full_width_M(GRANITE)
    tiles = num_tiles(K, M)
    path = str(scratch / "granite_k4.npz")
    keep, on_block = _block0_keeper()
    out, row = _train_full(card, "phase 21a",
                           ["--engine", "auto", "--mix", "pallas",
                            "--checkpoint", path], blocks,
                           _train_launches(K, tiles, blocks), K=K,
                           on_block=on_block, arch=GRANITE)
    _check_sharded_world1("phase 21a", out["engine"])
    cfg, spec = out["cfg"], out["spec"]
    routers = [x for x in tree_leaves(out["state"].params)
               if x.dtype == torch.float32]
    if len(routers) != 1 or routers[0].shape[1:] != (
            cfg.num_layers, cfg.d_model, cfg.num_experts):
        raise AssertionError("phase 21a: the trained stack's float32 "
                             "leaves are not the router")
    del out
    torch.cuda.empty_cache()
    ckpt_bytes = Path(path).stat().st_size
    ckpt_gb = ckpt_bytes / 1e9
    _check_stacked_step("phase 21a", spec, cfg, keep)
    agent = tree_map(lambda x: x[0].clone(), keep["before"])
    keep.clear()
    torch.cuda.empty_cache()
    step = _granite_step_check(agent, cfg, card)
    del agent
    torch.cuda.empty_cache()
    row.update(M=M, tiles=tiles, stacked_bit_equal=True, step_check=step,
               checkpoint_gb=ckpt_gb)
    print(f"phase 21a: {GRANITE} M = {M:,} an agent ({tiles} column tiles "
          f"at K = {K}); block 0 bit-equal to one stacked-engine step; "
          f"checkpoint {ckpt_gb:.2f} GB [{card}]")
    print(json.dumps({"phase": "21a", **row}))
    return row["launches"], row, path


def phase_serve_granite(path: str, card: str) -> tuple[dict, dict]:
    """Phase 21b: 21a's checkpoint through ``serve.main`` with no spec
    flag: the consensus through ``diffusion_mix`` (the exact mean, held
    against a float64 mean of the loaded stack within one bf16 ulp plus
    the float32 summation bound; the router stays float32), prefill of 4
    prompts of 128 and 32 greedy steps (decode sends B = 4 tokens through
    each MoE layer: capacity max(ceil(4 8 / 32 1.25), 8) = 8)."""
    import torch

    from repro_torch.api import EngineState
    from repro_torch.checkpoint import load_experiment, load_spec
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_flatten_with_path, tree_leaves

    argv = ["--checkpoint", path, "--batch", "4", "--prompt-len", "128",
            "--decode", "32", "--temperature", "0"]
    spec = load_spec(path)
    K = spec.run.num_agents
    reset_launches()
    out = serve.main(argv)
    launches = read_launches()
    cfg = out["cfg"]
    want = {"diffusion_mix": num_tiles(K, full_width_M(GRANITE)),
            "flash_attention": 0, "diffusion_mix_int8": 0, "gather_mix": 0,
            "gather_robust_mix": 0, "ssd_intra_chunk": 0,
            "flash_attention_backward": 0}
    if launches != want:
        raise AssertionError(f"phase 21b: launches {launches}, expected "
                             f"{want}")
    toks = out["tokens"]
    if (tuple(toks.shape) != (4, 32) or toks.min() < 0
            or toks.max() >= cfg.vocab_size):
        raise AssertionError(f"phase 21b: tokens out of range {toks}")
    for p, x in tree_flatten_with_path(out["params"]):
        if (x.dtype == torch.float32) != (p[-1] == "router"):
            raise AssertionError(f"phase 21b: consensus leaf {p} is "
                                 f"{x.dtype}")
    stack, _ = load_experiment(path, EngineState(tf.param_specs(
        cfg, num_agents=K)), device="cuda")

    def exact():
        width = CHECK_SLICE // K
        for got, x, floor in zip(tree_leaves(out["params"]),
                                 tree_leaves(stack.params),
                                 _sum_floors(stack.params, 2 * K)):
            got, x = got.reshape(-1), x.reshape(K, -1)
            for a in range(0, x.shape[1], width):
                yield got[a:a + width], x[:, a:a + width].double().mean(0), \
                    floor

    gate = _ulp_gate("phase 21b: consensus vs float64 mean", exact())
    t = out["timings"]
    load_rate("phase 21b", Path(path).stat().st_size, t["load_s"], card)
    print(f"phase 21b: load {t['load_s']:.2f}s, consensus "
          f"{t['consensus_s']:.3f}s ({want['diffusion_mix']} diffusion_mix "
          f"launches), prefill 4 x 128 {t['prefill_s']:.3f}s, decode 32 "
          f"steps {t['decode_s']:.3f}s ({out['tokens_per_s']:.1f} "
          f"tokens/s) [{card}]")
    row = {"timings": t, "tokens_per_s": out["tokens_per_s"],
           "consensus_vs_float64": gate, "launches": launches,
           "card": card}
    print(json.dumps({"phase": "21b", **row}))
    del out, stack
    torch.cuda.empty_cache()
    return launches, row


def _forward_batch(cfg, S: int, seed: int) -> dict:
    """One next-token batch of B = 1 on the card: tokens (1, S), or (1, S,
    nq) with codebooks, from a seeded host generator, and for an
    image-prefix config its prefix (1, img_tokens, VISION_DIM), float32
    normals times 0.02, from the same generator."""
    import torch

    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.models import transformer as tf

    gen = torch.Generator().manual_seed(seed)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    batch = lm_token_batch(gen, (1, S) + cb, cfg.vocab_size)
    if cfg.img_tokens:
        batch["img_embeds"] = torch.randn(
            (1, cfg.img_tokens, tf.VISION_DIM), generator=gen).mul_(0.02)
    return {k: v.cuda() for k, v in batch.items()}


def phase_arch_forwards(card: str, forwards=ARCH_FORWARDS,
                        label: str = "phase 21c", seed: int = 210) -> dict:
    """Phase 21c (and 22d with MODALITY_FORWARDS): each arch of
    ``forwards`` at full width (its depth there), weights drawn on the card
    from a seed, ``train_loss`` at K = 1, B = 1 (llava's image prefix in
    front of its tokens, musicgen's four codebooks), kernel against plain
    attention: one ``flash_attention`` launch a layer (kimi's at head dim
    112), the loss within TRAIN_LOSS_TOL relative; the logits' relative
    error (a second forward of each route) and, for kimi, the routing
    flips printed.  Phase 4 holds each arch's attention call at its
    shape."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    launches_by, rows = {}, {}
    for i, (arch, S, layers) in enumerate(forwards):
        cfg = get_config(arch).model
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = tf.init_params(
            torch.Generator(device="cuda").manual_seed(seed + i), cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        size_gb = sum(x.numel() * x.element_size()
                      for x in tree_leaves(params)) / 1e9
        batch = _forward_batch(cfg, S, seed + 10 + i)
        img = batch.get("img_embeds")
        kern = dataclasses.replace(cfg, use_kernels=True)
        reset_launches()
        with torch.no_grad():
            t0 = time.perf_counter()
            loss_k = tf.train_loss(params, kern, batch, remat=False).item()
            kernel_s = time.perf_counter() - t0
        launches = read_launches()
        with torch.no_grad():
            loss_p = tf.train_loss(params, cfg, batch, remat=False).item()
            with moe.Routing() as r_k:
                logits_k = tf.forward(params, kern, batch["tokens"],
                                      img_embeds=img, remat=False)[0]
            with moe.Routing() as r_p:
                logits_p = tf.forward(params, cfg, batch["tokens"],
                                      img_embeds=img, remat=False)[0]
        want = {"flash_attention": cfg.num_layers, "diffusion_mix": 0,
                "diffusion_mix_int8": 0, "gather_mix": 0,
                "gather_robust_mix": 0, "ssd_intra_chunk": 0,
                "flash_attention_backward": 0}
        if launches != want:
            raise AssertionError(f"{label}: {arch} launches {launches}, "
                                 f"expected {want}")
        a, b = logits_k.float()[0], logits_p.float()[0]
        logits_rel = ((a - b).norm() / b.norm()).item()
        flips = same_rel = kept_rel = dropped = None
        if cfg.num_experts:
            E = cfg.num_experts
            flips = _routing_flips(r_k.ids, r_p.ids, E)
            # the logits of the tokens both routes sent to the same
            # experts in every layer, and of those whose kept (not
            # dropped past capacity) experts are the same too: a flip
            # moves the queue positions of later tokens in two experts
            cap = moe.moe_capacity(S, E, cfg.num_experts_per_token,
                                   cfg.capacity_factor)
            same = torch.ones(S, dtype=torch.bool, device=a.device)
            kept = same.clone()
            n_drop = 0
            for x, y in zip(r_k.ids, r_p.ids):
                same &= (x.sort(-1).values == y.sort(-1).values).all(-1)
                kx, ky = (moe.assignment_positions(z.reshape(-1), E)[3]
                          .reshape(z.shape) < cap for z in (x, y))
                kept &= (torch.where(kx, x, -1).sort(-1).values
                         == torch.where(ky, y, -1).sort(-1).values).all(-1)
                n_drop += int((~ky).sum())
            kept &= same
            dropped = n_drop / (len(r_p.ids) * r_p.ids[0].numel())
            same_rel = ((a[same] - b[same]).norm()
                        / b[same].norm()).item()
            kept_rel = ((a[kept] - b[kept]).norm()
                        / b[kept].norm()).item()
        del a, b, logits_k, logits_p
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        peak = torch.cuda.max_memory_allocated() / 1e9
        row = {"layers": cfg.num_layers, "of_layers":
               get_config(arch).model.num_layers, "tokens": S,
               "img_tokens": cfg.img_tokens,
               "codebooks": cfg.num_codebooks,
               "head_dim": cfg.head_dim, "size_gb": size_gb,
               "init_s": init_s, "kernel_forward_s": kernel_s,
               "loss_kernel": loss_k, "loss_plain": loss_p,
               "loss_rel": loss_rel, "logits_rel": logits_rel,
               "routing_flips": flips,
               "logits_rel_same_routing": same_rel,
               "logits_rel_same_routing_and_drops": kept_rel,
               "dropped_share": dropped, "peak_mem_gb": peak,
               "launches": launches}
        extra = (f" after a {cfg.img_tokens}-token image prefix"
                 if cfg.img_tokens else
                 f" x {cfg.num_codebooks} codebooks" if cfg.num_codebooks
                 else "")
        print(f"{label}: {arch} full width, {cfg.num_layers} of "
              f"{row['of_layers']} layers ({size_gb:.1f} GB bf16, drawn in "
              f"{init_s:.1f}s), B=1, S={S}{extra}, head dim "
              f"{cfg.head_dim}: loss "
              f"kernel {loss_k:.6f}, plain {loss_p:.6f} (rel "
              f"{loss_rel:.2e}, gate {TRAIN_LOSS_TOL}), logits rel "
              f"{logits_rel:.2e}"
              + (f", routing flips {flips} of "
                 f"{len(r_p.ids) * r_p.ids[0].numel():,} ({dropped:.1%} of "
                 f"the assignments dropped past capacity); logits rel "
                 f"{same_rel:.2e} over the tokens routed alike, "
                 f"{kept_rel:.2e} over those whose kept experts match too"
                 if flips is not None else "")
              + f"; kernel forward {kernel_s:.3f}s, peak {peak:.1f} GB "
              f"[{card}]")
        if not (loss_rel <= TRAIN_LOSS_TOL
                and torch.isfinite(torch.tensor([loss_k, loss_p])).all()):
            raise AssertionError(f"{label}: {arch}: kernel forward != "
                                 "plain")
        rows[arch] = row
        launches_by[arch] = launches
        del params, batch, img, r_k, r_p
    print(json.dumps({"phase": label.removeprefix("phase "), "archs": rows,
                      "card": card}))
    torch.cuda.empty_cache()
    return launches_by


def phase_train_musicgen(card: str, scratch: Path):
    """Phase 22a: musicgen-medium at full width, all 48 layers (d 1,536,
    24/24 heads of 64, d_ff 6,144 gelu, 4 codebooks of 2,048), through
    ``train.main`` with ``--engine auto`` (the sharded engine, world 1),
    K = 4 ring, q 0.9, T = 2, SGD mu 0.05, B = 1 x 1024 x 4 codebooks,
    ``--mix pallas``, 2 blocks, the stack drawn on the card, and
    ``--checkpoint``: the launch counts exact, the blocks' (T, K, B, S, 4)
    tokens, block 0 bit-equal to one stacked-engine step from its input
    state.  Returns the launches, the row, the checkpoint's path and the
    final stack (phase 22b's dense consensus reads it)."""
    import torch

    K, blocks = 4, 2
    M = full_width_M(MUSICGEN)
    tiles = num_tiles(K, M)
    path = str(scratch / "musicgen_k4.npz")
    keep, on_block = _block0_keeper()
    out, row = _train_full(card, "phase 22a",
                           ["--engine", "auto", "--mix", "pallas",
                            "--checkpoint", path], blocks,
                           _train_launches(K, tiles, blocks), K=K,
                           on_block=on_block, arch=MUSICGEN)
    _check_sharded_world1("phase 22a", out["engine"])
    cfg, spec = out["cfg"], out["spec"]
    shape = tuple(keep["batch"]["tokens"].shape)
    if shape != (2, K, 1, 1024, cfg.num_codebooks):
        raise AssertionError(f"phase 22a: block tokens {shape}")
    stack = out["state"].params
    del out
    torch.cuda.empty_cache()
    ckpt_bytes = Path(path).stat().st_size
    ckpt_gb = ckpt_bytes / 1e9
    _check_stacked_step("phase 22a", spec, cfg, keep)
    keep.clear()
    torch.cuda.empty_cache()
    row.update(M=M, tiles=tiles, stacked_bit_equal=True,
               checkpoint_gb=ckpt_gb, block_tokens_shape=list(shape))
    print(f"phase 22a: {MUSICGEN} M = {M:,} an agent ({2 * M / 1e9:.2f} GB "
          f"bf16; {tiles} column tiles at K = {K}); block 0 bit-equal to "
          f"one stacked-engine step; checkpoint {ckpt_gb:.2f} GB [{card}]")
    print(json.dumps({"phase": "22a", **row}))
    return row["launches"], row, path, stack


def phase_serve_musicgen(path: str, stack, card: str):
    """Phase 22b: 22a's checkpoint through ``serve.main`` with no spec
    flag: the consensus through ``diffusion_mix`` within one bf16 ulp
    (plus the float32 summation bound) of the dense mixer's over the same
    stack, prompts (4, 128, 4) and 32 greedy steps, tokens (4, 32, 4) in
    the vocabulary, a second greedy run from the same consensus equal.
    Returns the launches, the row and the served consensus (phase 23's
    first generation)."""
    import torch

    from repro_torch.api import TOPOLOGIES
    from repro_torch.checkpoint import load_spec
    from repro_torch.core.serving import consensus_from_stacked
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    spec = load_spec(path)
    K = spec.run.num_agents
    argv = ["--checkpoint", path, "--batch", "4", "--prompt-len", "128",
            "--decode", "32", "--temperature", "0"]
    reset_launches()
    out = serve.main(argv)
    launches = read_launches()
    cfg = out["cfg"]
    want = {"diffusion_mix": num_tiles(K, full_width_M(MUSICGEN)),
            "flash_attention": 0, "diffusion_mix_int8": 0, "gather_mix": 0,
            "gather_robust_mix": 0, "ssd_intra_chunk": 0,
            "flash_attention_backward": 0}
    if launches != want:
        raise AssertionError(f"phase 22b: launches {launches}, expected "
                             f"{want}")
    toks = out["tokens"]
    if (tuple(toks.shape) != (4, 32, cfg.num_codebooks) or toks.min() < 0
            or toks.max() >= cfg.vocab_size):
        raise AssertionError(f"phase 22b: tokens {tuple(toks.shape)} out of "
                             "range")
    with torch.inference_mode():
        lg, cache = tf.prefill(out["params"], cfg, out["prompts"],
                               max_len=out["max_len"])
        again, _, _ = tf.decode_loop(out["params"], cfg, cache, lg[:, -1],
                                     None, 32, temperature=0.0)
    if not torch.equal(again.cpu(), toks):
        raise AssertionError("phase 22b: two greedy runs gave different "
                             "tokens")
    del lg, cache, again
    topo = TOPOLOGIES.get(spec.topology.kind)(spec.topology, K)
    t0 = time.perf_counter()
    dense = consensus_from_stacked(stack, K, "dense", topology=topo)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    gate = _ulp_gate("phase 22b: kernel vs dense consensus",
                     _sliced(out["params"], dense, _sum_floors(stack, K)))
    del dense
    torch.cuda.empty_cache()
    t = out["timings"]
    load_rate("phase 22b", Path(path).stat().st_size, t["load_s"], card)
    print(f"phase 22b: load {t['load_s']:.2f}s, consensus "
          f"{t['consensus_s']:.3f}s ({want['diffusion_mix']} diffusion_mix "
          f"launches; the dense mixer {dense_s:.3f}s), prefill 4 x 128 x "
          f"{cfg.num_codebooks} {t['prefill_s']:.3f}s, decode 32 steps "
          f"{t['decode_s']:.3f}s ({out['tokens_per_s']:.1f} tokens/s, "
          f"each {cfg.num_codebooks} codebooks); greedy tokens repeat "
          f"[{card}]")
    row = {"timings": t, "tokens_per_s": out["tokens_per_s"],
           "dense_consensus_s": dense_s, "consensus_vs_dense": gate,
           "tokens_shape": list(toks.shape), "launches": launches,
           "card": card}
    print(json.dumps({"phase": "22b", **row}))
    return launches, row, out["params"], cfg


def _serveloop_smoke(card: str) -> dict:
    """Phase 23, smoke: musicgen's smoke config in float32, 5 requests on
    2 slots (chunk 3), on the card and on the CPU from the same weights:
    without swaps every request's tokens equal single-request serving on
    the card; with a swap after every tick, the card's tokens and tags
    equal the CPU's and every completion replays on the card."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serving import (Request, ServeLoop,
                                            replay_completion)
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map

    cfg = get_config(MUSICGEN).smoke
    base = tf.init_params(torch.Generator().manual_seed(230), cfg)
    rng = np.random.default_rng(231)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (7 + 3 * i, 4)
                                    ).astype(np.int32), 6 + i)
            for i in range(5)]

    def drain(params, swap):
        loop = ServeLoop(cfg, params, slots=2, max_len=48, chunk=3)
        for r in reqs:
            loop.submit(r)
        by_gen, done = {0: params}, []
        while loop._queue or loop.active:
            done.extend(loop.step())
            if swap:
                g = loop.store.generation + 1
                newp = tree_map(lambda x, s=g: x * (1.0 + 0.03 * s), params)
                by_gen[loop.store.swap(newp)] = newp
        return sorted(done, key=lambda c: c.uid), by_gen

    card_p = tree_map(lambda x: x.cuda(), base)
    plain, _ = drain(card_p, swap=False)
    for c in plain:
        with torch.no_grad():
            lg, cache = tf.prefill(card_p, cfg, torch.as_tensor(
                reqs[c.uid].prompt, device="cuda")[None], max_len=48)
            want, _, _ = tf.decode_loop(card_p, cfg, cache, lg[:, -1], None,
                                        reqs[c.uid].max_new_tokens)
        if c.tokens != want[0].tolist():
            raise AssertionError(f"phase 23: smoke request {c.uid} != "
                                 "single-request serving")
    swapped, by_gen = drain(card_p, swap=True)
    on_cpu, _ = drain(base, swap=True)
    for a, b in zip(swapped, on_cpu):
        if a.tokens != b.tokens or a.generations != b.generations:
            raise AssertionError(f"phase 23: smoke request {a.uid}: card "
                                 "!= CPU")
    spans = [replay_completion(cfg, by_gen, c, max_len=48) for c in swapped]
    if max(spans) < 2:
        raise AssertionError("phase 23: no smoke swap landed mid-request")
    print(f"phase 23: smoke (float32): 5 requests on 2 slots equal "
          f"single-request serving; under {len(by_gen) - 1} swaps card == "
          f"CPU and every completion replays on the card (spans up to "
          f"{max(spans)} generations) [{card}]")
    return {"requests": 5, "swaps": len(by_gen) - 1,
            "max_generations_spanned": max(spans)}


def _replay_logits(cfg, by_gen, c, max_len: int, slots: int) -> list:
    """The logits (row 0, float32, on the host) each of completion ``c``'s
    tokens was chosen from, decoded teacher-forced under its generations
    as :func:`replay_completion` decodes it, alone (``slots=1``) or at the
    loop's width."""
    import numpy as np
    import torch

    from repro_torch.launch.serving import _write_slot
    from repro_torch.models import transformer as tf

    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    out = []
    with torch.no_grad():
        p0 = by_gen[c.generations[0]]
        lg, cache = tf.prefill(p0, cfg, torch.as_tensor(
            c.prompt, device="cuda")[None], max_len=max_len)
        if slots > 1:
            small = cache
            cache = tf.init_cache(cfg, slots, max_len, per_slot=True,
                                  device="cuda")
            for s in range(slots):
                _write_slot(cache, small, s)
        logits = lg[:1, -1]
        for i, t in enumerate(c.tokens):
            out.append(logits[0].float().cpu())
            if i + 1 == len(c.tokens):
                break
            tok = torch.as_tensor(np.asarray(t, np.int32),
                                  device="cuda").reshape((1, 1) + cb)
            lg, cache = tf.decode_step(by_gen[c.generations[i + 1]], cfg,
                                       cache, tok.expand((slots, 1) + cb))
            logits = lg[:1, 0]
    return out


def phase_serveloop(path: str, params, cfg, card: str):
    """Phase 23: the continuous-batching ServeLoop.  Smoke
    (``_serveloop_smoke``), then at full width over 22b's consensus
    (bf16): 4 slots, chunk 8, max_len 256, six requests of 64-160 prompt
    tokens x 4 codebooks and 32 new tokens; after the first tick 22a's
    checkpoint is ingested (``ingest_checkpoint``: the watch path, its
    consensus through ``diffusion_mix``), after the third a perturbed copy
    is swapped in, both while decodes are in flight.  Every completion
    replays at the loop's width (``_replay_logits(..., slots=4)``, the
    decode of ``replay_completion(..., slots=4)`` with its logits kept:
    every token their argmax).  The same replay alone (batch 1,
    single-request serving under the same schedule) is reported: the tokens it would choose otherwise, and for
    each completion's first such token the top-two gap of its batch-1
    logits against twice the largest batch-4-vs-batch-1 logit difference
    there (the most two logits can move apart: a larger gap fails)."""
    import numpy as np
    import torch

    from repro_torch.launch.serving import Request, ServeLoop
    from repro_torch.tree import tree_map

    smoke = _serveloop_smoke(card)
    loop = ServeLoop(cfg, params, **SERVELOOP)
    rng = np.random.default_rng(232)
    nq = cfg.num_codebooks
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n, nq)).astype(
        np.int32), SERVELOOP_NEW) for i, n in enumerate(SERVELOOP_PROMPTS)]
    for r in reqs:
        loop.submit(r)
    by_gen, done, ticks = {0: params}, [], 0
    reset_launches()
    t0 = time.perf_counter()
    tick_s = []
    while loop._queue or loop.active:
        t1 = time.perf_counter()
        done.extend(loop.step())
        tick_s.append(time.perf_counter() - t1)
        ticks += 1
        if ticks == 1:
            g = loop.ingest_checkpoint(path)
            by_gen[g] = loop.store.snapshot()[0]
        elif ticks == 3:
            newp = tree_map(lambda x: (x.float() * 1.01).to(x.dtype), params)
            by_gen[loop.store.swap(newp)] = newp
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {"diffusion_mix": num_tiles(4, full_width_M(MUSICGEN)),
            "flash_attention": 0, "diffusion_mix_int8": 0, "gather_mix": 0,
            "gather_robust_mix": 0, "ssd_intra_chunk": 0,
            "flash_attention_backward": 0}
    if launches != want:
        raise AssertionError(f"phase 23: launches {launches}, expected "
                             f"{want}")
    done.sort(key=lambda c: c.uid)
    if sorted(c.uid for c in done) != [r.uid for r in reqs]:
        raise AssertionError("phase 23: not every request completed")
    n_tok = n_diff = 0
    firsts, spans = [], []
    for c in done:
        # the replay at the loop's width (replay_completion(..., slots=4)'s
        # decode), its logits kept for the divergence gate below
        wide = _replay_logits(cfg, by_gen, c, SERVELOOP["max_len"],
                              SERVELOOP["slots"])
        for i, (w, t) in enumerate(zip(wide, c.tokens)):
            if not torch.equal(w.argmax(-1), torch.as_tensor(t)):
                raise AssertionError(f"phase 23: uid {c.uid} token {i}: the "
                                     "loop-width replay disagrees (torn or "
                                     "mis-tagged update)")
        spans.append(len(set(c.generations)))
        alone = _replay_logits(cfg, by_gen, c, SERVELOOP["max_len"], 1)
        first = None
        for i, (a, t) in enumerate(zip(alone, c.tokens)):
            t = torch.as_tensor(t)
            differs = a.argmax(-1) != t
            n_tok += t.numel()
            n_diff += int(differs.sum())
            if first is None and bool(differs.any()):
                top2 = a.topk(2, dim=-1).values
                gap = float((top2[..., 0] - top2[..., 1])[differs].max())
                delta = float((wide[i] - a).abs().max())
                first = {"uid": c.uid, "token": i, "top_two_gap": gap,
                         "batch_vs_single_max_diff": delta}
                firsts.append(first)
                if gap > 2 * delta:
                    raise AssertionError(
                        f"phase 23: uid {c.uid} token {i}: batch-1 serving "
                        f"picks otherwise at a top-two gap {gap:.4g} above "
                        f"twice the batch-vs-single difference {delta:.4g}")
    if loop.store.generation != 2 or max(spans) < 2:
        raise AssertionError(f"phase 23: generations {loop.store.generation}"
                             f", spans {spans}: no swap landed mid-request")
    decode_steps = ticks * SERVELOOP["chunk"]
    row = {"smoke": smoke, "requests": len(reqs),
           "prompt_lens": list(SERVELOOP_PROMPTS), **SERVELOOP,
           "new_tokens": SERVELOOP_NEW, "ticks": ticks, "wall_s": wall,
           "tick_s": tick_s, "generations": loop.store.generation,
           "spans": spans, "tokens": n_tok,
           "tokens_differing_from_single_request": n_diff,
           "first_divergences": firsts, "launches": launches, "card": card}
    print(f"phase 23: ServeLoop at full width (bf16): {len(reqs)} requests "
          f"on {SERVELOOP['slots']} slots in {ticks} ticks of "
          f"{SERVELOOP['chunk']} ({decode_steps} decode steps) in "
          f"{wall:.2f}s incl. the ingest ({np.median(tick_s):.3f}s median "
          f"tick); {loop.store.generation} swaps in flight, completions "
          f"span up to {max(spans)} generations, every one replays at the "
          f"loop's width; {n_diff} of {n_tok} codebook tokens differ from "
          f"single-request serving under the same schedule"
          + (f" (first divergences: {firsts})" if firsts else "")
          + f"; launches {launches} [{card}]")
    print(json.dumps({"phase": "23", **row}))
    return launches, row


def _llava_decode_check(served: dict, card: str) -> dict:
    """Phase 22c's decode gate on the served consensus, in float32 (the
    reference's gate is a float32 one): prefill of the image prefix and
    the 4 prompts into a cache of prefix + 128 + 32 positions, then the
    first 8 generated tokens decoded, each step's logits within DECODE_TOL
    of the uncached forward over the same context; the reference's serve
    sizing (128 + 32 positions, so decode overwrites the oldest image
    positions) is run too and its drift printed."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map

    n = 8
    cfg = served["cfg"]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda x: x.float(), served["params"])
    img, prompts = served["img_embeds"], served["prompts"]
    gen = served["tokens"][:, :n].to(prompts.device, prompts.dtype)
    P, S = cfg.img_tokens, prompts.shape[1]
    with torch.no_grad():
        full, _, _ = tf.forward(p32, cfg32, torch.cat([prompts, gen], 1),
                                img_embeds=img, remat=False)
        full = full[:, P + S - 1:]
        worst = {}
        for label, max_len in (("port", served["max_len"]),
                               ("reference sizing", S + 32)):
            lg, cache = tf.prefill(p32, cfg32, prompts, img_embeds=img,
                                   max_len=max_len)
            errs = [(lg[:, -1] - full[:, 0]).abs().max().item()]
            bad = not torch.allclose(lg[:, -1], full[:, 0], atol=2e-3,
                                     rtol=2e-3)
            for t in range(n):
                lg, cache = tf.decode_step(p32, cfg32, cache, gen[:, t:t + 1])
                errs.append((lg[:, 0] - full[:, t + 1]).abs().max().item())
                bad |= not torch.allclose(lg[:, 0], full[:, t + 1],
                                          atol=DECODE_TOL, rtol=DECODE_TOL)
            worst[label] = {"cache_positions": cache.slot_pos.shape[0],
                            "max_abs": errs, "beyond_gate": bad}
            del lg, cache
    del p32, full
    torch.cuda.empty_cache()
    print(f"phase 22c: decode vs the uncached forward (float32 weights, "
          f"{P} + {S} context, 8 steps): cache of "
          f"{worst['port']['cache_positions']} positions, max |diff| "
          f"{max(worst['port']['max_abs']):.3e} (gate {DECODE_TOL}); the "
          f"reference's sizing ({worst['reference sizing']['cache_positions']}"
          f" positions, decode evicting image positions) "
          f"{max(worst['reference sizing']['max_abs']):.3e} [{card}]")
    if worst["port"]["beyond_gate"]:
        raise AssertionError("phase 22c: cached decode beyond the 5e-3 "
                             "gate of the uncached forward")
    return worst


def phase_llava(card: str, scratch: Path):
    """Phase 22c: llava-next-mistral-7b at full width, cut to
    LLAVA_CUT_LAYERS of its 32 layers, through ``train.main`` with
    ``--engine auto`` (sharded, world 1), K = 2 ring, q 0.9, T = 2, SGD mu
    0.05, B = 1 x (2,880 image positions + 1,024 tokens), ``--mix
    pallas``, 2 blocks, the stack drawn on the card, ``--checkpoint``: the
    launch counts exact, the blocks' float32 image stream, block 0
    bit-equal to one stacked-engine step; then the checkpoint through
    ``serve.main(..., num_layers=LLAVA_CUT_LAYERS)`` with no spec flag:
    the consensus through ``diffusion_mix``, 4 prompts of 128 after the
    image prefix, 32 greedy steps, a cache of 2,880 + 128 + 32 positions,
    and ``_llava_decode_check``.  Returns the training and serving
    launches and the row."""
    import torch

    from repro_torch.launch import serve

    K, blocks, layers = 2, 2, LLAVA_CUT_LAYERS
    M = full_width_M(LLAVA, layers)
    tiles = num_tiles(K, M)
    path = str(scratch / "llava_k2.npz")
    keep, on_block = _block0_keeper()
    out, row = _train_full(card, "phase 22c",
                           ["--engine", "auto", "--mix", "pallas",
                            "--checkpoint", path], blocks,
                           _train_launches(K, tiles, blocks), K=K,
                           layers=layers, on_block=on_block, arch=LLAVA)
    _check_sharded_world1("phase 22c", out["engine"])
    cfg, spec = out["cfg"], out["spec"]
    img = keep["batch"]["img_embeds"]
    if (tuple(img.shape) != (2, K, 1, cfg.img_tokens, 1024)
            or img.dtype != torch.float32):
        raise AssertionError(f"phase 22c: image stream {tuple(img.shape)} "
                             f"{img.dtype}")
    del out
    torch.cuda.empty_cache()
    ckpt_bytes = Path(path).stat().st_size
    ckpt_gb = ckpt_bytes / 1e9
    _check_stacked_step("phase 22c", spec, cfg, keep)
    keep.clear()
    torch.cuda.empty_cache()
    print(f"phase 22c: {LLAVA} M = {M:,} an agent at {layers} of 32 layers "
          f"({tiles} column tiles at K = {K}); block 0 bit-equal to one "
          f"stacked-engine step; checkpoint {ckpt_gb:.2f} GB [{card}]")
    train_launches = row["launches"]

    argv = ["--checkpoint", path, "--batch", "4", "--prompt-len", "128",
            "--decode", "32", "--temperature", "0"]
    reset_launches()
    served = serve.main(argv, num_layers=layers)
    serve_launches = read_launches()
    Path(path).unlink()
    want = {"diffusion_mix": tiles, "flash_attention": 0,
            "diffusion_mix_int8": 0, "gather_mix": 0,
            "gather_robust_mix": 0, "ssd_intra_chunk": 0,
            "flash_attention_backward": 0}
    if serve_launches != want:
        raise AssertionError(f"phase 22c: serving launches "
                             f"{serve_launches}, expected {want}")
    toks = served["tokens"]
    if (tuple(toks.shape) != (4, 32) or toks.min() < 0
            or toks.max() >= cfg.vocab_size
            or served["max_len"] != cfg.img_tokens + 128 + 32):
        raise AssertionError(f"phase 22c: tokens {tuple(toks.shape)}, "
                             f"cache {served['max_len']}")
    t = served["timings"]
    load_rate("phase 22c", ckpt_bytes, t["load_s"], card)
    print(f"phase 22c: serve load {t['load_s']:.2f}s, consensus "
          f"{t['consensus_s']:.3f}s, prefill 4 x ({cfg.img_tokens} + 128) "
          f"{t['prefill_s']:.3f}s, decode 32 steps {t['decode_s']:.3f}s "
          f"({served['tokens_per_s']:.1f} tokens/s) [{card}]")
    decode = _llava_decode_check(served, card)
    del served
    torch.cuda.empty_cache()
    row.update(M=M, tiles=tiles, stacked_bit_equal=True,
               checkpoint_gb=ckpt_gb, serve_timings=t,
               serve_launches=serve_launches, decode_check=decode)
    print(json.dumps({"phase": "22c", **row}))
    return train_launches, serve_launches, row


def _allocated() -> tuple[int, int]:
    """The allocator's (allocated, requested) bytes once the card is
    idle: ``memory_allocated`` counts each block as rounded, the requested
    bytes as asked for."""
    import torch

    torch.cuda.synchronize()
    return (torch.cuda.memory_allocated(),
            torch.cuda.memory_stats().get("requested_bytes.all.current", 0))


def _hold_allocator(label: str, want: int, base: tuple, tensors: list,
                    card: str, what: str) -> dict:
    """The dry run's bytes against the card's: ``tensors`` hold exactly
    ``want`` bytes, and ``memory_allocated`` grew from ``base`` by that
    plus the allocator's rounding, at most 512 B a tensor."""
    now = _allocated()
    grown, requested = now[0] - base[0], now[1] - base[1]
    exact, n = sum(t.numel() * t.element_size() for t in tensors), len(tensors)
    if exact != want or not 0 <= grown - want <= 512 * n:
        raise AssertionError(f"{label}: the dry run predicts {want:,} B, the "
                             f"{n} tensors hold {exact:,} B and the "
                             f"allocator grew {grown:,} B")
    print(f"{label}: {what}: the dry run predicts {want:,} B; {n} tensors "
          f"hold {exact:,} B; memory_allocated grew {grown:,} B "
          f"(+{grown - want} B, at most 512 B a tensor), the requested "
          f"bytes {requested:,} B [{card}]")
    return {"predicted": want, "tensor_bytes": exact, "grown": grown,
            "requested": requested, "tensors": n}


def phase_dryrun(card: str, scratch: Path) -> dict:
    """Phase 24: the dry run's sweep with the card hidden, its argument
    bytes against the card's allocator for smollm-360m's train_4k state
    and long_500k cache at world 1, and the CRC check of the card's
    checkpoint load (the module docstring's item 24)."""
    import argparse
    import dataclasses
    import os
    import struct
    import zipfile

    import torch

    from repro_torch.api import build
    from repro_torch.api.cli import add_spec_args, spec_from_args
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    arch = "smollm-360m"
    out_dir = scratch / "dryrun"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--out", str(out_dir)], capture_output=True, text=True, cwd=ROOT,
        timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                          "CUDA_VISIBLE_DEVICES": ""})
    sweep_s = time.perf_counter() - t0
    ok = [line for line in proc.stdout.splitlines()
          if line.startswith("OK   ")]
    files = sorted(out_dir.glob("*.json"))
    if proc.returncode or len(ok) != 80 or len(files) != 80:
        raise AssertionError(f"phase 24a: exit {proc.returncode}, {len(ok)} "
                             f"OK lines, {len(files)} files:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    train = json.loads((out_dir / "smollm_360m_train_4k_single_dense.json")
                       .read_text())
    print(f"phase 24a: the dry run with the card hidden: 80 OK lines and 80 "
          f"JSON files in {sweep_s:.1f}s (its process start included); "
          f"smollm-360m train_4k on the 16 x 16 mesh "
          f"{train['memory']['argument_size_in_bytes']:,} B a device, "
          f"{train['collectives']['total_bytes']:,} B gathered a block "
          f"[{card}]")

    # (b) the train state and one block on the port's mesh at world 1
    world1 = dryrun.MeshShape({"data": 1, "model": 1})
    bundle, shape = get_config(arch), INPUT_SHAPES["train_4k"]
    K, _ = dryrun.agent_count(bundle, multi_pod=False)
    T, B = bundle.parallel.local_steps, shape.global_batch // K
    pred = dryrun.dryrun_one(arch, "train_4k", "single", mesh=world1)
    mem = pred["memory"]
    ap = argparse.ArgumentParser()
    add_spec_args(ap)
    spec = spec_from_args(ap.parse_args(
        ["--arch", arch, "--full", "--agents", str(K), "--local-steps",
         str(T), "--batch", str(B), "--seq", str(shape.seq_len),
         "--optimizer", "sgd"]))
    torch.cuda.empty_cache()
    eng = build(spec, engine="sharded", device="cuda")
    base = _allocated()
    key = torch.Generator().manual_seed(0)
    params = eng.init_params(torch.Generator(device="cuda").manual_seed(0))
    state = eng.init_state(params, eng.optimizer.init(params), key=key)
    del params
    batch = eng.data(0, key)
    held = [t for t in tree_leaves(
        [getattr(state, f.name) for f in dataclasses.fields(state)]
        + [batch]) if isinstance(t, torch.Tensor)]
    row = {"train": _hold_allocator(
        "phase 24b", mem["argument_size_in_bytes"]
        - mem["argument_parts"]["key"], base, held, card,
        f"{arch} train_4k at world 1 (K = {K}, T = {T}, B = {B} x "
        f"{shape.seq_len}, SGD): the state and one block")}
    del state, batch, held, eng
    torch.cuda.empty_cache()

    # (c) the long_500k decode cache
    cfg, shape = bundle.model, INPUT_SHAPES["long_500k"]
    window = dryrun.serve_window(cfg, shape)
    pred = dryrun.dryrun_one(arch, "long_500k", "single", mesh=world1)
    base = _allocated()
    cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                          window=window, device="cuda")
    # the reference's whole-batch pos is a () int32 argument; the port's
    # is the int 0, on no device
    row["cache"] = _hold_allocator(
        "phase 24c", pred["memory"]["argument_parts"]["cache"] - 4, base,
        tree_leaves(list(cache.segments)) + [cache.slot_pos], card,
        f"{arch} long_500k cache (batch {shape.global_batch}, window "
        f"{window})")
    del cache

    # (d) the card's checkpoint load checks each member's CRC-32
    gen = torch.Generator(device="cuda").manual_seed(24)
    tree = {"big": torch.randn(50 << 20, generator=gen, device="cuda")}
    path, bad = scratch / "crc.npz", scratch / "crc_bad.npz"
    save_checkpoint(str(path), tree)
    got, _ = load_checkpoint(str(path), tree, device="cuda")
    if not torch.equal(got["big"], tree["big"]):
        raise AssertionError("phase 24d: the intact archive did not load "
                             "bit-equal")
    del got
    with zipfile.ZipFile(path) as z:
        info = z.getinfo("big.npy")
    raw = path.read_bytes()
    name_len, extra_len = struct.unpack(
        "<HH", raw[info.header_offset + 26:info.header_offset + 30])
    start = info.header_offset + 30 + name_len + extra_len
    raised = []
    for at in (start + info.file_size - 8, start + 20):
        flipped = bytearray(raw)
        flipped[at] ^= 0x10
        bad.write_bytes(flipped)
        try:
            load_checkpoint(str(bad), tree, device="cuda")
        except zipfile.BadZipFile as e:
            raised.append(str(e))
        else:
            raise AssertionError(f"phase 24d: a flipped byte at {at} loaded")
    path.unlink()
    bad.unlink()
    del tree
    torch.cuda.empty_cache()
    print(f"phase 24d: an archive of four 64 MiB pieces loads bit-equal on "
          f"the card; a flipped data byte and a flipped .npy header byte "
          f"each raise BadZipFile ({raised[0]}) [{card}]")
    row.update(sweep_s=sweep_s, crc_errors=raised, card=card)
    print(json.dumps({"phase": "24", **row}))
    return row


#: phase 25's band for the quickstart example's sim/theory (its seed-0
#: run, 3,000 blocks, the last 800): the port's mean 1.0150 +- 4 standard
#: deviations (0.0478) over seeds 0-63 on an H100, rounded outward
#: (tools/quickstart_band.py; PERF.md); the reference's mean over seeds
#: 0-15 on a CPU, 1.0213, lies inside
QUICKSTART_BAND = (0.8239, 1.2062)

MAMBA2 = "mamba2-2.7b"

#: phase 26's bf16 decode gate: each step's logits within this many times
#: the bf16 model's own rounding witness (the uncached bf16 forward's
#: distance from the float32 one over the same context), plus the float32
#: gate DECODE_TOL, of the float32 uncached forward
MAMBA_DECODE_WITNESS_RATIO = 2.0


def phase_examples(card: str, scratch: Path) -> dict:
    """Phase 25: the six examples of ``repro_torch.examples`` on the card,
    in process through their functions at the reference's sizes, each
    example's own check holding: quickstart's sim/theory inside
    QUICKSTART_BAND, federated_comparison's ``bounded=True``,
    custom_graph's ``CUSTOM_GRAPH_OK`` with the hub index at the block
    count, train_lm's last printed eval loss below its first and its
    checkpoint read back bit-equal through ``load_checkpoint``,
    train_federated_text's mean loss falling, serve_lm's cache at position
    64 on all three archs with the card's prefill logits within 1e-4 and
    greedy tokens equal to the CPU's.  The examples run the plain mixers
    (dense, sparse) and smoke configs without kernels, as the reference's
    defaults do: no kernel launches."""
    import torch

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.examples import (custom_graph, federated_comparison,
                                      quickstart, serve_lm,
                                      train_federated_text, train_lm)
    from repro_torch.tree import tree_leaves

    secs, row = {}, {"card": card}

    def clock(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    reset_launches()
    qs = clock("quickstart", quickstart.run)
    lo, hi = QUICKSTART_BAND
    row["quickstart"] = {"theory": qs["theory"], "sim": qs["sim"],
                         "ratio": qs["ratio"], "band": [lo, hi]}
    if not lo <= qs["ratio"] <= hi:
        raise AssertionError(f"phase 25: quickstart sim/theory "
                             f"{qs['ratio']:.4f} outside {QUICKSTART_BAND}")
    fc = clock("federated_comparison", federated_comparison.run)
    row["federated_comparison"] = {
        "degradation": fc["part2"]["degradation"],
        "bounded": fc["part2"]["bounded"],
        "bytes_per_block": {n: r["bytes_per_block"] for n, r in
                            fc["part2"]["schemes"].items()},
        "steady": {n: r["msd"] for n, r in fc["part1"].items()}}
    if fc["part2"]["bounded"] is not True:
        raise AssertionError("phase 25: federated_comparison not bounded")
    cg = clock("custom_graph", custom_graph.run)
    row["custom_graph"] = {"steady": cg["steady"],
                           "hub_index": cg["hub_index"]}
    if cg["hub_index"] != custom_graph.BLOCKS:
        raise AssertionError(f"phase 25: hub index {cg['hub_index']}")
    path = str(scratch / "train_lm.npz")
    lm = clock("train_lm", train_lm.main, ["--checkpoint", path])
    losses = lm["losses"]
    first, last = losses[min(losses)], losses[max(losses)]
    back, meta = load_checkpoint(path, lm["state"].params, device="cuda")
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(back), tree_leaves(lm["state"].params)))
    Path(path).unlink()
    row["train_lm"] = {"losses": losses, "checkpoint_bit_equal": same,
                       "step": meta["step"]}
    if not (last < first and same and meta["step"] == 100):
        raise AssertionError(f"phase 25: train_lm losses {first} -> {last},"
                             f" checkpoint bit-equal {same}")
    ft = clock("train_federated_text", train_federated_text.main, [])
    means = {i: sum(v) / len(v) for i, v in ft["losses"].items()}
    row["train_federated_text"] = {"mean_losses": means}
    if not means[max(means)] < means[min(means)]:
        raise AssertionError(f"phase 25: train_federated_text mean loss "
                             f"{means}")
    served = clock("serve_lm", serve_lm.main, [])
    launches = read_launches()
    row["serve_lm"] = {}
    for arch, card_out in served.items():
        cpu = serve_lm.serve(arch, device="cpu")
        err = (card_out["prefill_logits"].cpu().float()
               - cpu["prefill_logits"].float()).abs().max().item()
        same = torch.equal(card_out["tokens"], cpu["tokens"])
        row["serve_lm"][arch] = {"cache_pos": card_out["cache_pos"],
                                 "prefill_logits_vs_cpu": err,
                                 "tokens_equal_cpu": same}
        if not (card_out["cache_pos"] == cpu["cache_pos"] == 64
                and err <= 1e-4 and same):
            raise AssertionError(f"phase 25: serve_lm {arch}: cache "
                                 f"{card_out['cache_pos']}, logits vs CPU "
                                 f"{err:.3e}, tokens equal {same}")
    want = dict.fromkeys(kernel_wrappers(), 0)
    if launches != want:
        raise AssertionError(f"phase 25: launches {launches}, expected "
                             f"{want}")
    row["seconds"], row["launches"] = secs, launches
    print(f"phase 25: the six examples on the card, each one's own check "
          f"held: quickstart sim/theory {qs['ratio']:.4f} (band "
          f"{lo:.4f}-{hi:.4f}), federated_comparison bounded (max "
          f"degradation {fc['part2']['degradation']:.2f}x), custom_graph "
          f"hub index {cg['hub_index']}, train_lm loss {first:.4f} -> "
          f"{last:.4f} (checkpoint bit-equal), train_federated_text mean "
          f"loss {means[min(means)]:.3f} -> {means[max(means)]:.3f}, "
          f"serve_lm cache 64 and card == CPU on all three archs; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
          + f" [{card}]")
    print(json.dumps({"phase": "25", **row}, default=str))
    return launches


def _decode_logits(params, cfg, prompts, gen, max_len: int):
    """Prefill's last-position logits then one decode step per token of
    ``gen`` (B, n), teacher-forced: (B, n + 1, V); and the uncached
    forward's logits over the same contexts, (B, n + 1, V)."""
    import torch

    from repro_torch.models import transformer as tf

    S, n = prompts.shape[1], gen.shape[1]
    with torch.no_grad():
        full, _, _ = tf.forward(params, cfg, torch.cat([prompts, gen], 1),
                                remat=False)
        full = full[:, S - 1:].float()
        lg, cache = tf.prefill(params, cfg, prompts, max_len=max_len)
        steps = [lg[:, -1].float()]
        for t in range(n):
            lg, cache = tf.decode_step(params, cfg, cache, gen[:, t:t + 1])
            steps.append(lg[:, 0].float())
        del cache
    return torch.stack(steps, 1), full


def _mamba_decode_check(served: dict, card: str) -> dict:
    """Phase 26's decode gates on the served consensus: in float32
    (weights upcast), every one of the 32 decode steps within the
    reference's DECODE_TOL of the uncached forward over the prompt and
    the tokens decoded so far (prefill's last position within 2e-3, as
    22c); in bf16 (as served), every step within
    MAMBA_DECODE_WITNESS_RATIO times the bf16 forward's own distance from
    the float32 forward, plus DECODE_TOL, of the float32 forward."""
    import dataclasses

    import torch

    from repro_torch.tree import tree_map

    cfg, prompts = served["cfg"], served["prompts"]
    gen = served["tokens"].to(prompts.device, prompts.dtype)
    max_len = served["max_len"]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda x: x.float(), served["params"])
    dec32, full32 = _decode_logits(p32, cfg32, prompts, gen, max_len)
    del p32
    torch.cuda.empty_cache()
    err32 = (dec32 - full32).abs().amax(dim=(0, 2)).tolist()
    ok32 = (torch.allclose(dec32[:, 0], full32[:, 0], atol=2e-3, rtol=2e-3)
            and torch.allclose(dec32[:, 1:], full32[:, 1:], atol=DECODE_TOL,
                               rtol=DECODE_TOL))
    dec16, full16 = _decode_logits(served["params"], cfg, prompts, gen,
                                   max_len)
    # the bf16 replay is a second greedy run: prefill, then one decode
    # step a token, each token the argmax of the step before
    if not torch.equal(dec16[:, :-1].argmax(-1).cpu(),
                       served["tokens"].long()):
        raise AssertionError("phase 26: two greedy runs gave different "
                             "tokens")
    drift16 = (dec16 - full32).abs().max().item()
    witness = (full16 - full32).abs().max().item()
    self16 = (dec16 - full16).abs().max().item()
    gate16 = MAMBA_DECODE_WITNESS_RATIO * witness + DECODE_TOL
    out = {"float32_max_abs_by_step": err32, "float32_ok": ok32,
           "bf16_decode_vs_float32_forward": drift16,
           "bf16_forward_vs_float32_forward": witness,
           "bf16_decode_vs_bf16_forward": self16, "bf16_gate": gate16,
           "logit_scale": full32.abs().max().item()}
    print(f"phase 26: decode vs the uncached forward ({prompts.shape[1]} + "
          f"{gen.shape[1]} context, every step): float32 max |diff| "
          f"{max(err32):.3e} (gate {DECODE_TOL}); bf16 decode vs float32 "
          f"forward {drift16:.3e}, the bf16 forward's own {witness:.3e} "
          f"(gate {gate16:.3e}), bf16 decode vs bf16 forward {self16:.3e}; "
          f"logits up to {out['logit_scale']:.2f} [{card}]")
    if not ok32:
        raise AssertionError("phase 26: float32 cached decode beyond the "
                             "5e-3 gate of the uncached forward")
    if not drift16 <= gate16:
        raise AssertionError("phase 26: bf16 decode beyond its witnessed "
                             "gate")
    return out


def phase_serve_mamba2(card: str, scratch: Path) -> tuple[dict, dict]:
    """Phase 26: mamba2-2.7b at full width (all 64 layers) served from a
    K = 2 stacked bf16 checkpoint of seeded random weights drawn on the
    card, through ``serve.main`` with ``--mix pallas`` (4 prompts of 128,
    32 greedy steps): the consensus through ``diffusion_mix`` (one launch
    a column tile, nothing else launched) within one bf16 ulp plus the
    float32 summation bound of the dense mixer's over the same stack,
    every token in the vocabulary, and ``_mamba_decode_check`` (whose bf16
    replay is the second greedy run).  Prints the write and load
    GB/s, consensus, prefill and decode seconds, tokens/s and the peak."""
    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.serving import consensus_from_stacked
    from repro_torch.launch import serve

    K = 2
    cfg = get_config(MAMBA2).model
    M = full_width_M(MAMBA2)
    tiles = num_tiles(K, M)
    stack = _stack_agents(cfg, K, seed=2600)
    path = str(scratch / "mamba2_k2.npz")
    t0 = time.perf_counter()
    save_checkpoint(path, stack)
    write_s = time.perf_counter() - t0
    nbytes = Path(path).stat().st_size
    floors = _sum_floors(stack, K)
    t0 = time.perf_counter()
    dense = consensus_from_stacked(stack, K, "dense")
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    del stack
    torch.cuda.empty_cache()
    print(f"phase 26: {MAMBA2} M = {M:,} an agent, all {cfg.num_layers} "
          f"layers, K = {K} ({tiles} column tiles); wrote {nbytes / 1e9:.2f}"
          f" GB in {write_s:.2f}s = {nbytes / write_s / 1e9:.2f} GB/s "
          f"[{card}]")
    argv = ["--arch", MAMBA2, "--full", "--agents", str(K), "--checkpoint",
            path, "--batch", "4", "--prompt-len", "128", "--decode", "32",
            "--temperature", "0", "--mix", "pallas"]
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = serve.main(argv)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    Path(path).unlink()
    want = dict.fromkeys(kernel_wrappers(), 0)
    want["diffusion_mix"] = tiles
    if launches != want:
        raise AssertionError(f"phase 26: launches {launches}, expected "
                             f"{want}")
    gate = _ulp_gate("phase 26: kernel vs dense consensus",
                     _sliced(out["params"], dense, floors))
    del dense
    torch.cuda.empty_cache()
    toks = out["tokens"]
    if (tuple(toks.shape) != (4, 32) or toks.min() < 0
            or toks.max() >= cfg.vocab_size
            or not torch.isfinite(out["prefill_logits"]).all()):
        raise AssertionError(f"phase 26: tokens {tuple(toks.shape)} out of "
                             "range or non-finite logits")
    decode = _mamba_decode_check(out, card)
    t = out["timings"]
    load_rate("phase 26", nbytes, t["load_s"], card)
    print(f"phase 26: load {t['load_s']:.2f}s, consensus "
          f"{t['consensus_s']:.3f}s ({tiles} diffusion_mix launches; the "
          f"dense mixer {dense_s:.3f}s), prefill 4 x 128 {t['prefill_s']:.3f}"
          f"s, decode 32 steps {t['decode_s']:.3f}s "
          f"({out['tokens_per_s']:.1f} tokens/s); peak device memory "
          f"{peak_gb:.2f} GB (with the dense consensus kept for the check, "
          f"{M * 2 / 1e9:.2f} GB); greedy tokens repeat [{card}]")
    row = {"M": M, "tiles": tiles, "checkpoint_gb": nbytes / 1e9,
           "write_s": write_s, "timings": t,
           "tokens_per_s": out["tokens_per_s"], "dense_consensus_s": dense_s,
           "consensus_vs_dense": gate, "peak_mem_gb": peak_gb,
           "decode_check": decode, "launches": launches, "card": card}
    print(json.dumps({"phase": "26", **row}))
    del out
    torch.cuda.empty_cache()
    return launches, row


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
    # one nvcc per source, all started together; phases 1-6 need only the
    # two kernels that build in seconds, so they run while the others
    # compile, and every build is waited for before phase 7
    builds = build.start_builds()
    for name in ("diffusion_mix", "flash_attention"):
        builds[name].result()
    print(f"built diffusion_mix and flash_attention in "
          f"{time.perf_counter() - t_start:.1f}s; the other sources go on "
          f"compiling through phases 1-6")
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
        attn_bwd_row = timed("phase 4b", phase_attention_backward, card)
        train_launches, _ = timed("phase 5", phase_train, card)
        timed("phase 6", phase_train_devices)
        built = {n: f.result() for n, f in builds.items()}
        print(f"built every kernel source, one nvcc each in parallel: "
              + ", ".join(f"{n} {s:.1f}s" for n, s in built.items())
              + f"; all done {time.perf_counter() - t_start:.1f}s after "
              f"the start")
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
        Path(stack_path).unlink()       # phase 19a's checkpoint needs room
        SharedStack.clear()
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
        async_launches, _, async_path = timed("phase 19a", phase_train_async,
                                              card, scratch)
        async_serve_launches, _ = timed("phase 19b", phase_serve_async,
                                        async_path, card)
        Path(async_path).unlink()
        preset_launches = timed("phase 19c", phase_presets, card)
        exact_launches = timed("phase 19d", phase_exact_diffusion, card)
        sharded_launches, _ = timed("phase 20a", phase_train_sharded, card)
        offload_launches, _, world1 = timed("phase 20c", phase_offload, card)
        ranks_launches, _ = timed("phase 20b", phase_train_two_ranks, card,
                                  scratch, world1)
        granite_launches, _, granite_path = timed(
            "phase 21a", phase_train_granite, card, scratch)
        granite_serve_launches, _ = timed("phase 21b", phase_serve_granite,
                                          granite_path, card)
        Path(granite_path).unlink()
        forward_launches = timed("phase 21c", phase_arch_forwards, card)
        musicgen_launches, _, musicgen_path, stack = timed(
            "phase 22a", phase_train_musicgen, card, scratch)
        musicgen_serve_launches, _, consensus, musicgen_cfg = timed(
            "phase 22b", phase_serve_musicgen, musicgen_path, stack, card)
        del stack
        # phase 23 runs on 22b's consensus and ingests 22a's checkpoint
        serveloop_launches, _ = timed("phase 23", phase_serveloop,
                                      musicgen_path, consensus,
                                      musicgen_cfg, card)
        del consensus
        Path(musicgen_path).unlink()
        torch.cuda.empty_cache()
        llava_launches, llava_serve_launches, _ = timed(
            "phase 22c", phase_llava, card, scratch)
        modality_launches = timed(
            "phase 22d", phase_arch_forwards, card, MODALITY_FORWARDS,
            "phase 22d", 240)
        torch.cuda.empty_cache()
        timed("phase 24", phase_dryrun, card, scratch)
        examples_launches = timed("phase 25", phase_examples, card, scratch)
        mamba_serve_launches, _ = timed("phase 26", phase_serve_mamba2,
                                        card, scratch)
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
               "regression_private_frontier": frontier_launches,
               "train_smollm_async": async_launches,
               "serve_smollm_async": async_serve_launches,
               "presets_smoke": preset_launches,
               "regression_exact_diffusion": exact_launches,
               "train_smollm_sharded_default": sharded_launches,
               "train_smollm_sharded_offload": offload_launches,
               "train_smollm_sharded_two_ranks": ranks_launches,
               "train_granite_moe": granite_launches,
               "serve_granite_moe": granite_serve_launches,
               **{f"forward_{arch}": counts
                  for arch, counts in forward_launches.items()},
               "train_musicgen": musicgen_launches,
               "serve_musicgen": musicgen_serve_launches,
               "serveloop_musicgen": serveloop_launches,
               "train_llava": llava_launches,
               "serve_llava": llava_serve_launches,
               **{f"forward_{arch}": counts
                  for arch, counts in modality_launches.items()},
               "examples": examples_launches,
               "serve_mamba2": mamba_serve_launches}
    rows = ((mix_row, "train_smollm"), (attn_row, "train_smollm"),
            (attn_bwd_row, "train_smollm"), (ssd_row, "train_mamba2"),
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
