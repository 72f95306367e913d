"""Section IV in action: one engine, four known algorithms — plus the
compressed-communication frontier.

Part 1 runs FedAvg (full + partial), vanilla diffusion, and decentralized
FedAvg as *configurations* of Algorithm 1 on the same non-IID regression
problem and compares their steady-state errors — reproducing the paper's
claim that its MSD analysis covers all of them.

Part 2 swaps the combination step for the compressed CommPipeline
(core/compression.py) and traces the MSD-vs-bytes-on-the-wire curve: each
scheme is sampled at several points along training, positioned by its
*cumulative communicated bytes* rather than its block count.  With error
feedback on, the sparsified/quantized schemes reach (near-)dense MSD at a
fraction of the bytes — the whole point of compressed diffusion learning.

    PYTHONPATH=src python -m repro_torch.examples.federated_comparison \
        [--device cpu]

Counterpart of ``examples/federated_comparison.py``.  Every engine takes
the loss and its closed-form gradient (``grad_fn=data.grad_fn()``), and
each run draws from one host generator seeded with 0, so the card and the
CPU realize the same runs.  :func:`part1` and :func:`part2` return the
numbers they print; :func:`run` runs both at the reference's sizes.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.api import build
from repro_torch.core import variants
from repro_torch.data.synthetic import (make_block_sampler,
                                        make_regression_problem)
from repro_torch.device import resolve_device

__all__ = ["ALGO_BLOCKS", "ALGO_TAIL", "BLOCKS", "CHECKPOINTS", "K", "M2",
           "Q", "SCHEMES", "STEADY_TAIL", "algorithms", "main", "part1",
           "part2", "run", "scheme_spec"]

K = 12
ALGO_BLOCKS, ALGO_TAIL = 1500, 300

# 20-dim problem so ratio-0.1 sparsification is meaningful (2 of 20 coords)
M2 = 20
SCHEMES = {
    # int8 runs the direct exchange with the classic EF residual; the
    # sparsifiers run the CHOCO-style diff exchange, whose reference copy
    # IS the (implicit) error-feedback memory
    "dense-f32":  dict(compress="none", ratio=1.0, error_feedback=False),
    "int8+EF":    dict(compress="int8", ratio=1.0, error_feedback=True),
    "topk0.1":    dict(compress="topk", ratio=0.1, error_feedback=False),
    "randk0.25":  dict(compress="randk", ratio=0.25, error_feedback=False),
}
BLOCKS = 2000
CHECKPOINTS = (100, 400, 1000, BLOCKS)
STEADY_TAIL = 400
Q = 0.7


def algorithms(K: int = K) -> dict:
    """Part 1's five specs, by the reference's printed names."""
    return {
        "fedavg_full(T=5)": variants.fedavg_full(K, T=5, mu=0.01),
        "fedavg_partial(q=0.5,T=5)": variants.fedavg_partial_uniform(
            K, T=5, mu=0.01, q=0.5),
        "vanilla_diffusion(ring)": variants.vanilla_diffusion(K, mu=0.01),
        "async_diffusion(q=0.5)": variants.asynchronous_diffusion(
            K, mu=0.01, q=0.5),
        "decentralized_fedavg(T=5)": variants.decentralized_fedavg(
            K, T=5, mu=0.01),
    }


def scheme_spec(name: str, K: int = K):
    """Part 2's spec of the scheme ``name`` (a key of :data:`SCHEMES`)."""
    kw = SCHEMES[name]
    return variants.compressed_diffusion(
        K, mu=0.01, topology="ring", T=1, q=Q, compress=kw["compress"],
        ratio=kw["ratio"], error_feedback=kw["error_feedback"])


def part1(blocks: int = ALGO_BLOCKS, device=None) -> dict:
    """Each algorithm for ``blocks`` blocks: its steady MSD (the mean of
    the last :data:`ALGO_TAIL`) and the distance of its mean iterate from
    w_orig, by name."""
    dev = resolve_device(device)
    data = make_regression_problem(K=K, N=100, M=2, rho=0.1, seed=0)
    prob = data.problem()
    w_orig = prob.w_opt(None)
    rows = {}
    print(f"{'algorithm':30s} {'steady MSD':>12s}  {'vs w_orig':>10s}")
    for name, spec in algorithms().items():
        eng = build(spec, data.loss_fn(), device=dev, grad_fn=data.grad_fn())
        w_star = prob.w_opt(spec.q_vector())
        sampler = make_block_sampler(data, T=spec.run.local_steps, batch=1,
                                     device=dev)
        params = torch.zeros((K, 2), device=dev)
        params, _, hist = eng.run(
            params, sampler, blocks, seed=0,
            w_star=torch.as_tensor(w_star, dtype=torch.float32, device=dev))
        msd = float(np.mean(hist[-ALGO_TAIL:]))
        d = float(np.linalg.norm(params.cpu().numpy().mean(0) - w_orig))
        rows[name] = {"msd": msd, "vs_w_orig": d, "history": hist}
        print(f"{name:30s} {msd:12.4e}  {d:10.4f}")
    return rows


def part2(blocks: int = BLOCKS, device=None) -> dict:
    """Part 2: each scheme for ``blocks`` blocks, its bytes a combination
    (``bytes_per_block``), the MSD at each checkpoint (the reference's,
    those past ``blocks`` replaced by ``blocks``) and its steady MSD (the
    mean of the last :data:`STEADY_TAIL`); ``degradation`` is the largest
    steady MSD over dense-f32's and ``bounded`` whether it is below 10."""
    dev = resolve_device(device)
    data2 = make_regression_problem(K=K, N=100, M=M2, rho=0.1, seed=0)
    prob2 = data2.problem()
    checkpoints = tuple(c for c in CHECKPOINTS if c < blocks) + (blocks,)
    print("\nMSD vs bytes-on-wire (async diffusion, ring, q=0.7; int8 uses "
          "the\nEF residual, the sparsifiers diff-mode implicit feedback):")
    print(f"{'scheme':12s} {'B/block':>8s}  "
          + "  ".join(f"{'MSD@' + str(c):>16s}" for c in checkpoints)
          + f"  {'steady MSD':>12s}")
    rows, steady = {}, {}
    for name in SCHEMES:
        spec = scheme_spec(name)
        eng = build(spec, data2.loss_fn(), device=dev,
                    grad_fn=data2.grad_fn())
        w_star = prob2.w_opt(spec.q_vector())
        sampler = make_block_sampler(data2, T=1, batch=1, device=dev)
        params = torch.zeros((K, M2), device=dev)
        bytes_per_block = eng.pipeline.wire_bytes(params)
        _, _, hist = eng.run(
            params, sampler, blocks, seed=0,
            w_star=torch.as_tensor(w_star, dtype=torch.float32, device=dev))
        steady[name] = float(np.mean(hist[-STEADY_TAIL:]))
        # the MSD-vs-bytes curve: each checkpoint positioned by cumulative
        # bytes
        pts = "  ".join(f"{hist[c - 1]:.2e}@{c * bytes_per_block / 1e3:.0f}kB"
                        for c in checkpoints)
        rows[name] = {"bytes_per_block": bytes_per_block,
                      "msd_at": {c: hist[c - 1] for c in checkpoints},
                      "steady": steady[name], "history": hist}
        print(f"{name:12s} {bytes_per_block:8d}  {pts}  {steady[name]:12.4e}")
    degr = max(v / steady["dense-f32"] for v in steady.values())
    print(f"\nmax steady-MSD degradation vs dense: {degr:.2f}x "
          f"(bounded={degr < 10.0}) — compressed feedback schemes hold a "
          "near-dense error floor at 2-10x fewer bytes per combination step")
    return {"schemes": rows, "degradation": degr, "bounded": degr < 10.0}


def run(algo_blocks: int = ALGO_BLOCKS, blocks: int = BLOCKS,
        device=None) -> dict:
    """Both parts (the reference's sizes by default)."""
    return {"part1": part1(algo_blocks, device),
            "part2": part2(blocks, device)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
