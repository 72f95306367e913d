"""Cases of the agent-sharded engine, run at world 1 in the test process
and at world W in the gloo process groups that ``test_torch_sharded.py``
spawns.  This module imports torch, numpy and the port only, so a spawned
rank starts quickly.

Each case is the §VII regression (K agents, M = 3) through
:class:`repro_torch.core.sharded.ShardedEngine`, 2 blocks from one seeded
host generator and an index-replayable sampler; :func:`run_case` returns
the whole final state (gathered from every rank) as numpy arrays.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import attacks, privacy as privacy_lib
from repro_torch.core.diffusion import DiffusionConfig
from repro_torch.core.schedules import MarkovAvailability
from repro_torch.core.sharded import ShardedEngine
from repro_torch.data.synthetic import (make_indexed_block_sampler,
                                        make_regression_problem)
from repro_torch.optim import sgd
from repro_torch.tree import tree_leaves

#: name -> the case's knobs (K agents; the engine's mixer and pipeline)
CASES = {
    "pallas": dict(K=8, mix="pallas"),
    "dense": dict(K=8, mix="dense"),
    "gather": dict(K=8, mix="gather"),
    "trimmed_mean": dict(K=8, mix="trimmed_mean", robust_scope="neighborhood"),
    "int8_ef": dict(K=8, mix="pallas", topology="fedavg", compress="int8",
                    error_feedback=True),
    "int8_ef_generic": dict(K=8, mix="dense", compress="int8",
                            error_feedback=True),
    "topk_diff": dict(K=8, mix="pallas", compress="topk",
                      compress_ratio=0.34),
    "secure_agg": dict(K=8, mix="pallas", privacy=0.5),
    "noise_attack": dict(K=8, mix="trimmed_mean",
                         robust_scope="neighborhood", attack="noise"),
    "markov_link_dropout": dict(K=8, mix="dense", markov=True,
                                graph="link_dropout",
                                graph_kwargs=(("corr", 0.5), ("drop", 0.3))),
    "replicated": dict(K=5, mix="pallas"),
}


def build_case(name: str, mesh=None):
    """(engine, gradient transform or None, data) of one case."""
    c = CASES[name]
    K = c["K"]
    data = make_regression_problem(K=K, N=40, M=3, rho=0.1, seed=2)
    cfg = DiffusionConfig(num_agents=K, local_steps=2, step_size=0.02,
                          topology=c.get("topology", "ring"),
                          participation=0.7, graph=c.get("graph", "static"),
                          graph_kwargs=c.get("graph_kwargs", ()))
    loss = data.loss_fn()
    transform = priv = None
    if "privacy" in c:
        priv = privacy_lib.compile_privacy(
            K, cfg.q_vector(), blocks=2, local_steps=2, enabled=True,
            noise_multiplier=c["privacy"], clip=1.0, secure_agg=True)
        transform = priv.wrap(sgd())
    if c.get("attack"):
        transform = attacks.make_attack(c["attack"], K, num_byzantine=2,
                                        scale=1.0, seed=3)
    eng = ShardedEngine(
        lambda p, b, rng: loss(p, b), cfg, topology=cfg.make_topology(),
        mix=c["mix"], trim=1, robust_scope=c.get("robust_scope", "global"),
        compress=c.get("compress"), compress_ratio=c.get("compress_ratio"),
        error_feedback=c.get("error_feedback"),
        participation=(MarkovAvailability(0.7, 0.5, num_agents=K)
                       if c.get("markov") else None),
        grad_transform=None if transform is None else transform.update,
        privacy=priv, mesh=mesh, device="cpu")
    return eng, transform, data


def run_case(name: str, mesh=None, blocks: int = 2,
             after_steps=None) -> dict:
    """The case's whole state after ``blocks`` blocks, as numpy arrays:
    ``params``, the pipeline memory's leaves (``comm``), the masks.
    ``after_steps()`` is called between the last block and the gather of
    the state."""
    from repro_torch.launch.train import gather_state

    eng, transform, data = build_case(name, mesh)
    K = eng.config.num_agents
    w0 = np.random.default_rng(0).standard_normal((K, 3)).astype(np.float32)
    params = torch.from_numpy(w0)
    if eng.shard is not None:
        params = eng.shard.local(params).clone()
    opt = transform.init(params) if transform is not None else None
    key = torch.Generator().manual_seed(11)
    state = eng.init_state(params, opt, key=key)
    sampler = make_indexed_block_sampler(data, T=2, seed=4, device="cpu")
    masks = []
    for i in range(blocks):
        state, m = eng.step(state, sampler(i), key)
        masks.append(m["active"].numpy())
    if after_steps is not None:
        after_steps()
    whole = gather_state(state, eng.shard)
    comm = ([] if whole.comm_state is None else
            [x.numpy() for x in tree_leaves(whole.comm_state)])
    return {"params": whole.params.numpy(), "comm": comm,
            "active": np.stack(masks),
            "sharded": eng.shard is not None}


def worker(rank: int, world: int, store: str, out: str, names: list,
           checkpoint_argv: list | None) -> None:
    """One rank of a spawned gloo group: every case in ``names``, each
    all-gather's input (dtype, shape) recorded by a wrapper of
    ``torch.distributed.all_gather``, then (with ``checkpoint_argv``) the
    train driver.  Rank 0 saves the results to ``out/results.pt``."""
    torch.set_num_threads(1)
    os.environ.pop("WORLD_SIZE", None)
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train

    mesh_lib.init_agent_group("gloo", init_method=f"file://{store}",
                              rank=rank, world_size=world, timeout_s=60)
    mesh = mesh_lib.make_production_mesh()
    seen: list = []
    on = [True]
    all_gather = dist.all_gather

    def recording(tensor_list, tensor, group=None, async_op=False):
        if on[0]:
            seen.append((str(tensor.dtype).removeprefix("torch."),
                         tuple(tensor.shape)))
        return all_gather(tensor_list, tensor, group=group,
                          async_op=async_op)

    dist.all_gather = recording
    results = {}
    for name in names:
        seen.clear()
        on[0] = True
        res = run_case(name, mesh, after_steps=lambda: on.__setitem__(0,
                                                                     False))
        res["wire"] = sorted(set(seen))
        results[name] = res
    if checkpoint_argv is not None:
        seen.clear()
        on[0] = True
        train.main(checkpoint_argv)
        results["train_wire"] = sorted(set(seen))
    dist.all_gather = all_gather
    if rank == 0:
        torch.save(results, Path(out) / "results.pt")
    dist.barrier()
    dist.destroy_process_group()
