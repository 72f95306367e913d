#!/usr/bin/env python3
"""The spread of the quickstart example's sim/theory over seeds.

  python3 tools/quickstart_band.py --package port --seeds 64 --workers 8
  JAX_PLATFORMS=cpu python3 tools/quickstart_band.py --package reference \
      --seeds 16 --workers 4

Runs ``examples/quickstart.py``'s recipe (K = 10 ring, T = 5, mu 0.01, q ~
U(0.3, 0.9) from ``default_rng(1)``, 3,000 blocks, the steady MSD over
the last 800) once a seed, ``--seeds`` seeds from ``--start``, and prints
each seed's sim/theory and then one JSON line: the count, mean, standard
deviation, extremes and the band mean +- 4 standard deviations.
``--package port`` runs :func:`repro_torch.examples.quickstart.run` on
``--device`` (default: the card; its draws come from one host generator
a seed, so the device changes no draw); ``--package reference`` runs the
JAX reference's engine on the CPU with ``jax.random.PRNGKey(seed)``.
Seeds are dealt to ``--workers`` spawned processes.  ``chip_smoke.py``
phase 25 holds the port's seed-0 run inside the port's band.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import multiprocessing
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _port(seeds: list, device: str | None) -> list:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.examples import quickstart

    torch.set_num_threads(1)
    out = []
    for s in seeds:
        with contextlib.redirect_stdout(io.StringIO()):
            r = quickstart.run(device=device, seed=s)
        out.append((s, r["ratio"]))
    return out


def _reference(seeds: list, device: str | None) -> list:
    del device                       # the reference runs on the CPU here
    sys.path.insert(0, str(ROOT / "src"))
    import jax.numpy as jnp
    import numpy as np

    from repro.core.diffusion import DiffusionConfig, DiffusionEngine
    from repro.core.msd import theoretical_msd
    from repro.data.synthetic import (make_block_sampler,
                                      make_regression_problem)

    K, T, MU = 10, 5, 0.01
    data = make_regression_problem(K=K, N=100, M=2, rho=0.1, seed=0)
    q = np.random.default_rng(1).uniform(0.3, 0.9, K)
    cfg = DiffusionConfig(num_agents=K, local_steps=T, step_size=MU,
                          topology="ring", participation=tuple(q))
    theory = theoretical_msd(data.problem(), A=cfg.make_topology().A, q=q,
                             mu=MU, T=T)
    engine = DiffusionEngine(cfg, data.loss_fn())
    sampler = make_block_sampler(data, T=T, batch=1)
    out = []
    for s in seeds:
        _, _, hist = engine.run(jnp.zeros((K, 2)), sampler, num_blocks=3000,
                                seed=s, w_star=jnp.asarray(theory["w_opt"]))
        out.append((s, float(np.mean(hist[-800:])) / theory["msd"]))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=["port", "reference"],
                    required=True)
    ap.add_argument("--seeds", type=int, default=64)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="the port's device (default: cuda)")
    args = ap.parse_args(argv)
    import numpy as np

    seeds = list(range(args.start, args.start + args.seeds))
    parts = [seeds[i::args.workers] for i in range(args.workers)]
    fn = _port if args.package == "port" else _reference
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(args.workers) as pool:
        done = [pool.apply_async(fn, (p, args.device)) for p in parts if p]
        ratios = sorted(r for d in done for r in d.get())
    for s, r in ratios:
        print(f"seed {s}: sim/theory {r:.6f}")
    x = np.array([r for _, r in ratios])
    mean, std = float(x.mean()), float(x.std(ddof=1))
    row = {"package": args.package, "device": args.device, "seeds": len(x),
           "start": args.start, "mean": mean, "std": std,
           "sem": std / np.sqrt(len(x)), "min": float(x.min()),
           "max": float(x.max()), "band": [mean - 4 * std, mean + 4 * std],
           "seconds": time.perf_counter() - t0}
    if args.package == "port" and args.device in (None, "cuda"):
        import torch
        row["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
