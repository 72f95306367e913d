"""Federated-style text training with a real data pipeline.

Non-IID corpus partitioning + Algorithm 1 with partial participation and
local updates, end to end, on the declarative spec path:

    ExperimentSpec (DataSpec shards/dirichlet) -> build() -> engine + an
    index-replayable block provider -> T local steps -> eq.(20) masked
    combination -> loss tracking.

    PYTHONPATH=src python -m repro_torch.examples.train_federated_text \
        --blocks 40 [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_federated_text \
        --data dirichlet --alpha 0.1 --topology scale_free

The provider is a pure function of (DataSpec.seed, block_index, agent),
so any block can be replayed from its index — checkpoint-resume needs no
data-state files.

Counterpart of ``examples/train_federated_text.py``, with its flags and
defaults and ``--device`` (default CUDA, never a fallback).  The
reference's key becomes one host generator (seed 0): the K agents'
initial parameters, then each block's draws, so the card and the CPU
train the same run.  The step runs eagerly.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.api import build
from repro_torch.api.spec import (DataSpec, ExperimentSpec, MixerSpec,
                                  ModelSpec, ParticipationSpec, RunSpec,
                                  TopologySpec)
from repro_torch.device import resolve_device
from repro_torch.examples.train_lm import eval_loss
from repro_torch.tree import tree_map

__all__ = ["main", "make_spec", "parser"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--participation", type=float, default=0.8)
    ap.add_argument("--blocks", type=int, default=40)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--corpus-tokens", type=int, default=200_000)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--data", default="shards",
                    choices=["iid", "shards", "dirichlet"],
                    help="per-agent distribution: shards = contiguous "
                         "document-locality regions (the classic federated "
                         "text setting), dirichlet = cluster skew at "
                         "--alpha, iid = the synthetic stream")
    ap.add_argument("--alpha", type=float, default=0.5,
                    help="dirichlet concentration (DataSpec.alpha)")
    ap.add_argument("--topology", default="ring",
                    help="base combination graph (e.g. ring, scale_free)")
    ap.add_argument("--local-steps-mode", default="uniform",
                    choices=["uniform", "degree"],
                    help="degree: hubs run fewer eq.-17 steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    return ap


def make_spec(args) -> ExperimentSpec:
    """The experiment the flags ``args`` describe."""
    spec = ExperimentSpec(
        topology=TopologySpec(kind=args.topology),
        participation=ParticipationSpec(q=args.participation),
        mixer=MixerSpec(kind="dense"),
        model=ModelSpec(kind="transformer", arch=args.arch, smoke=True),
        data=DataSpec(kind=args.data, alpha=args.alpha,
                      corpus_tokens=args.corpus_tokens),
        run=RunSpec(num_agents=args.agents, local_steps=args.local_steps,
                    step_size=args.lr, blocks=args.blocks,
                    batch=args.batch, seq=args.seq,
                    local_steps_mode=args.local_steps_mode))
    # the default optimizer spec is adam — the engine threads it through
    # the shared local-update scan
    return spec.replace(optimizer=dataclasses.replace(
        spec.optimizer, kind="adam"))


def main(argv=None) -> dict:
    """Train; returns the engine, the final state, each printed block's
    per-agent losses (``losses``) and every block's realized mask
    (``active``)."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    spec = make_spec(args)

    eng = build(spec, device=dev)
    K, cfg = args.agents, eng.model.cfg
    if args.data != "iid":
        sizes = [len(p) for p in eng.data.partitions]
        print(f"data: {args.data} over {K} agents — windows/agent "
              f"min={min(sizes)} max={max(sizes)}")

    key = torch.Generator().manual_seed(0)
    params = eng.init_params(key)
    state = eng.init_state(params, eng.optimizer.init(params))
    losses, active = {}, []
    t0 = time.time()
    for i in range(args.blocks):
        batch = eng.data(i, key)
        state, metrics = eng.step(state, batch, key)
        active.append(metrics["active"].cpu())
        if i % 10 == 0 or i == args.blocks - 1:
            per_agent = eval_loss(state.params, cfg,
                                  tree_map(lambda x: x[0], batch))
            losses[i] = per_agent.tolist()
            print(f"block {i:4d} active={int(metrics['active'].sum())}/{K} "
                  f"loss/agent={[f'{l:.3f}' for l in losses[i]]} "
                  f"t={time.time() - t0:.1f}s")
    return {"engine": eng, "state": state, "losses": losses,
            "active": active}


if __name__ == "__main__":
    main()
