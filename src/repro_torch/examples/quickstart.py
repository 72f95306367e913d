"""Quickstart: diffusion learning with local updates + partial participation
on the paper's linear-regression setting (§VII), validated against the
closed-form Theorem 5 MSD.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Counterpart of ``examples/quickstart.py``.  The engine takes the loss and
its closed-form gradient (``grad_fn=data.grad_fn()``: a few batched
operations a local step instead of K autograd graphs); the draws come from
one host generator seeded with ``seed``, so the card and the CPU realize
the same run.  :func:`run` returns the numbers :func:`main` prints.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.diffusion import DiffusionConfig, DiffusionEngine
from repro_torch.core.msd import theoretical_msd
from repro_torch.data.synthetic import (make_block_sampler,
                                        make_regression_problem)
from repro_torch.device import resolve_device

__all__ = ["BLOCKS", "K", "MU", "T", "TAIL", "main", "run"]

K, T, MU = 10, 5, 0.01
BLOCKS = 3000
TAIL = 800                 # the steady-state window: the last 800 blocks


def run(blocks: int = BLOCKS, device=None, seed: int = 0) -> dict:
    """Theorem 5's MSD, then ``blocks`` blocks of Algorithm 1 on
    ``device`` (``None`` means CUDA) from the host generator ``seed``,
    printing the reference's lines.  Returns ``theory`` (the MSD),
    ``w_opt``, ``sim`` (the mean MSD over the last :data:`TAIL` blocks),
    ``ratio`` (sim / theory), ``history`` (the MSD after every block) and
    ``params``."""
    dev = resolve_device(device)
    # 1. non-IID data across K agents (paper eq. 80-81)
    data = make_regression_problem(K=K, N=100, M=2, rho=0.1, seed=0)

    # 2. Algorithm 1 configuration: ring network, 5 local steps, random q_k
    rng = np.random.default_rng(1)
    q = rng.uniform(0.3, 0.9, K)
    cfg = DiffusionConfig(num_agents=K, local_steps=T, step_size=MU,
                          topology="ring", participation=tuple(q))

    # 3. theory first: Theorem 5 closed-form steady-state MSD
    topo = cfg.make_topology()
    theory = theoretical_msd(data.problem(), A=topo.A, q=q, mu=MU, T=T)
    print(f"theoretical MSD (eq. 77): {theory['msd']:.4e}")

    # 4. run the algorithm
    engine = DiffusionEngine(cfg, data.loss_fn(), device=dev,
                             grad_fn=data.grad_fn())
    sampler = make_block_sampler(data, T=T, batch=1, device=dev)
    params = torch.zeros((K, 2), device=dev)
    params, _, hist = engine.run(
        params, sampler, num_blocks=blocks, seed=seed,
        w_star=torch.as_tensor(theory["w_opt"], dtype=torch.float32,
                               device=dev))
    sim = float(np.mean(hist[-TAIL:]))
    every = max(1, blocks // 10)
    print(f"simulated MSD:            {sim:.4e}")
    print(f"sim / theory:             {sim / theory['msd']:.3f}")
    print(f"learning curve (every {every} blocks): "
          f"{[f'{hist[i]:.1e}' for i in range(0, blocks, every)]}")
    return {"theory": theory["msd"], "w_opt": theory["w_opt"], "sim": sim,
            "ratio": sim / theory["msd"], "history": hist, "params": params}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
