"""One block of the sharded engine at smoke size, for the dry run's gather
count: run at world W in the gloo process groups that
``test_torch_dryrun.py`` spawns.  This module imports torch and the port
only, so a spawned rank starts quickly.

Each case is the train driver's argv (a transformer spec); one block runs
through :func:`repro_torch.api.build`'s sharded engine, and the rank
reports its row split's ``AgentShard.wire`` and how many gathers the block
made.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import torch

#: name -> the spec's flags (K = 4 smoke smollm, 2 local steps)
CASES = {
    "pallas": ["--mix", "pallas"],
    "dense": ["--mix", "dense"],
    "int8_ef": ["--mix", "pallas", "--topology", "fedavg", "--compress",
                "int8", "--error-feedback"],
    "int8_generic": ["--mix", "dense", "--compress", "int8"],
    "topk_diff": ["--mix", "pallas", "--compress", "topk",
                  "--compress-ratio", "0.25"],
}


def spec_of(name: str):
    from repro_torch.api.cli import add_spec_args, spec_from_args

    ap = argparse.ArgumentParser()
    add_spec_args(ap)
    return spec_from_args(ap.parse_args(
        ["--agents", "4", "--batch", "1", "--seq", "8", "--optimizer",
         "sgd", "--step-size", "0.05", *CASES[name]]))


def one_block(name: str, mesh=None) -> dict:
    """One block of case ``name`` on the CPU: the row split's wire bytes by
    dtype and its gather count."""
    from repro_torch.api import build

    spec = spec_of(name)
    eng = build(spec, engine="sharded", device="cpu", mesh=mesh)
    key = torch.Generator().manual_seed(0)
    params = eng.init_params(key)
    state = eng.init_state(params, eng.optimizer.init(params), key=key)
    batch = eng.data(0, key)
    shard, calls = eng.shard, [0]
    gather = shard.gather

    def counting(t):
        calls[0] += 1
        return gather(t)

    shard.gather = counting
    eng.step(state, batch, key)
    return {"wire": dict(shard.wire), "count": calls[0],
            "sharded": shard.sharded}


def worker(rank: int, world: int, store: str, out: str, names: list) -> None:
    """One rank of a spawned gloo group: one block of every case in
    ``names``; rank 0 saves the results to ``out/results.pt``."""
    torch.set_num_threads(1)
    os.environ.pop("WORLD_SIZE", None)
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.init_agent_group("gloo", init_method=f"file://{store}",
                              rank=rank, world_size=world, timeout_s=60)
    mesh = mesh_lib.make_production_mesh()
    results = {name: one_block(name, mesh) for name in names}
    if rank == 0:
        torch.save(results, Path(out) / "results.pt")
    dist.barrier()
    dist.destroy_process_group()
