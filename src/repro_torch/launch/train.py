"""Training entry point: diffusion learning (Algorithm 1) of a transformer
on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --blocks 2
  PYTHONPATH=src python -m repro_torch.launch.train --full --agents 4 \
      --local-steps 2 --batch 2 --seq 1024 --blocks 3 --mix pallas \
      --optimizer adam --step-size 1e-4
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \
      --full --agents 2 --local-steps 2 --batch 1 --seq 1024 --blocks 3 \
      --mix pallas --optimizer sgd --step-size 0.05
  PYTHONPATH=src python -m repro_torch.launch.train --full --agents 12 \
      --local-steps 2 --batch 1 --seq 1024 --blocks 3 --optimizer sgd \
      --step-size 0.05 --mix trimmed_mean --trim 1 \
      --robust-scope neighborhood --robust-gather fused \
      --attack sign_flip --attack-num 3 --attack-scale 3.0

  PYTHONPATH=src python -m repro_torch.launch.train --full --agents 8 \
      --local-steps 2 --batch 1 --seq 1024 --blocks 3 --optimizer sgd \
      --step-size 0.05 --topology fedavg --mix pallas --compress int8 \
      --error-feedback
  PYTHONPATH=src python -m repro_torch.launch.train --full --agents 8 \
      --local-steps 2 --batch 1 --seq 1024 --blocks 2 --optimizer sgd \
      --step-size 0.05 --mix pallas --graph link_dropout --link-drop 0.3 \
      --participation-process markov --markov-corr 0.5
  PYTHONPATH=src python -m repro_torch.launch.train --full --agents 8 \
      --local-steps 2 --batch 1 --seq 1024 --blocks 3 --optimizer sgd \
      --step-size 0.05 --mix pallas --privacy --privacy-epsilon 8 \
      --privacy-delta 1e-5 --privacy-clip 1.0 --data dirichlet \
      --data-alpha 0.3 --data-clusters 4

The experiment is one :class:`repro_torch.api.ExperimentSpec`, built from
the shared CLI front end (:mod:`repro_torch.api.cli`, the reference's flag
set) and materialized by :func:`repro_torch.api.build`, as
``repro.launch.train`` does:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --spec experiment.json
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --preset compressed_fedavg --agents 8 --step-size 0.01
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --engine async --async-rate-dist lognormal --async-rate-sigma 0.5 \
      --async-tau-max 4 --checkpoint ckpt.npz

The K = 12 run is the reference's ``byzantine_robust_diffusion`` preset
written out in flags (``--attack`` corrupts the Byzantine agents' raw
gradients before the optimizer sees them); of the K = 8 runs, the first is
its ``compressed_fedavg`` (int8 with error feedback through the fused
dequantize+mix kernel), the second a time-varying graph under bursty
availability, the third differentially private training (``--privacy``:
clip and Gaussian noise at every local step, the RDP accountant, a halt
before a block projected past ``--privacy-epsilon``) on a Dirichlet-skewed
partition of a seeded Zipf corpus.  ``--engine async`` runs the
event-driven :class:`~repro_torch.core.async_engine.AsyncEngine`
(per-agent clocks, a staleness buffer, age-discounted weights).  A flag
that the chosen kind would ignore raises ``ValueError``, as in the
reference.  ``--checkpoint`` saves the final ``EngineState`` with the spec
embedded (:func:`repro_torch.checkpoint.save_experiment`), so ``serve
--checkpoint`` rebuilds the engine with no other flag.

``--engine auto`` (the default) resolves as the reference's: the sharded
engine (:class:`~repro_torch.core.sharded.ShardedEngine`) for a
transformer spec.  Without a process group it runs on one device.  Under
``torchrun --nproc-per-node W`` (or with a group already initialized by
the caller) the agent rows split over the W ranks
(:func:`repro_torch.launch.mesh.init_agent_group` picks NCCL when each rank
has its own card and gloo when ranks share one or run on the CPU): every
rank draws the same weights, masks and blocks from the one seeded
generator and keeps its rows, rank 0 alone prints, and ``--checkpoint``
gathers the rows to rank 0, which writes the one file world 1 writes.
``--ef-host-offload`` parks the pipeline memory (the EF residual or the
diff-mode reference) in pinned host memory on a card, outside each
block's combination; on the CPU it is the identity.  ``--device`` defaults to CUDA and never falls
back to the CPU by itself.

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
      --agents 8 --blocks 2 --engine sharded --compress int8 \
      --error-feedback --topology fedavg --mix pallas

Every random draw (initial weights, batches, activation masks, graphs,
clock ticks) comes from one host generator seeded with ``--seed``, so the
card and the CPU realize the same run.  The kernels of the local updates
are chosen by ``cfg.use_kernels``, as in the reference: ``main(...,
use_kernels=True)`` applies ``dataclasses.replace(cfg, use_kernels=True)``,
which runs the flash-attention kernel in attention layers and the SSD
intra-chunk kernel in mamba layers.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.api import build
from repro_torch.api.build import resolve_engine
from repro_torch.api.cli import add_spec_args, spec_from_args
from repro_torch.checkpoint import save_experiment
from repro_torch.configs import get_config
from repro_torch.core.compression import dense_wire_bytes
from repro_torch.core.privacy import epsilon_from_rdp_np, rdp_increment_np
from repro_torch.core.sharded import ef_host_sharding
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["main", "init_stacked", "gather_state"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_spec_args(ap)
    ap.add_argument("--checkpoint", default=None,
                    help="save the final EngineState (+ embedded spec) here")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    return ap


def init_stacked(key: torch.Generator, cfg, num_agents: int,
                 device: torch.device, rows=None):
    """K agents initialized one after another from ``key`` and stacked on a
    leading axis on ``device``; with ``rows`` (an agent-sharded rank's
    agents) every agent is still drawn, so the generator advances as at
    world 1, and only those rows are kept."""
    rows = range(num_agents) if rows is None else rows
    agents = []
    for k in range(num_agents):
        p = tf.init_params(key, cfg)
        if k in rows:
            agents.append(tree_map(lambda x: x.to(device), p))
        del p
    return tree_map(lambda *xs: torch.stack(xs), *agents)


def gather_state(state, shard):
    """The whole state of an agent-sharded run on every rank: the leaves
    of ``params``, ``opt_state`` and ``comm_state`` with the local (K/W,
    ...) agent axis are all-gathered; the rest (the whole masks, graph and
    accountant states, shared counters) is the same on every rank."""
    if shard is None or not shard.sharded:
        return state
    n = shard.rows.stop - shard.rows.start

    def whole(tree):
        if tree is None:
            return tree
        return tree_unflatten(tree, [
            shard.gather(x) if (isinstance(x, torch.Tensor) and x.ndim >= 1
                                and x.shape[0] == n) else x
            for x in tree_leaves(tree)])

    return state.replace(params=whole(state.params),
                         opt_state=whole(state.opt_state),
                         comm_state=whole(state.comm_state))


def _comm_banner(pipeline, params, spec) -> dict | None:
    """The reference's ``comm:`` line: the compressor that runs, its mode
    and gamma, and the payload bytes per combination against dense
    float32 (``params``: the whole stack, or its meta template).  Returns
    them, or None without compression."""
    if spec.compression.kind == "none":
        return None
    wire = pipeline.wire_bytes(params)
    info = {"compressor": pipeline.compressor.name, "mode": pipeline.mode,
            "gamma": pipeline.gamma, "wire_bytes": wire,
            "dense_wire_bytes": dense_wire_bytes(params)}
    if wire == 0:
        print("comm: single agent: mixing disabled, compression inert")
    else:
        print(f"comm: {info['compressor']} "
              f"ratio={spec.compression.ratio} mode={pipeline.mode} "
              f"gamma={pipeline.gamma}  {wire / 1e6:.2f} MB/combination "
              f"on the wire ({info['dense_wire_bytes'] / wire:.1f}x below "
              "dense f32)")
    return info


def _privacy_banner(privacy, budget: float) -> None:
    agg = ("secure-agg wire masks on" if privacy.secure_agg
           else "wire unmasked")
    btxt = f"budget epsilon={budget:g}" if budget else "no epsilon budget"
    print(f"privacy: clip={privacy.clip:g} "
          f"noise_multiplier={privacy.noise_multiplier:.4g} "
          f"delta={privacy.delta:g}  {btxt}  {agg}  "
          "(RDP accountant advances at the realized participation "
          f"rate x {privacy.steps_per_block} local steps/block; the "
          "run halts before a block projected to overshoot the budget)")


def _async_banner(eng, spec) -> None:
    """Straggler simulation: the per-agent event delays, fixed for the
    run."""
    d, a = eng.delays, spec.asynchrony
    print(f"async: {a.rate_dist} rates (sigma={a.rate_sigma}, "
          f"seed={a.rate_seed}) — per-event delays min={d.min():.3f}s "
          f"median={float(np.median(d)):.3f}s max={d.max():.3f}s; "
          f"tau_max={a.tau_max} discount={a.discount}({a.discount_rate}); "
          "a synchronous block would pay the max every time")


def main(argv=None, *, use_kernels: bool = False,
         num_layers: int | None = None, on_block=None,
         init_on_device: bool = False) -> dict:
    """Train (see :func:`_main`).  Under a process group of several ranks,
    every rank but 0 runs with its standard output silenced.  torchrun's
    ranks join their group here (gloo when ``--device cpu``)."""
    device = _parser().parse_known_args(argv)[0].device
    mesh_lib.init_agent_group(
        "gloo" if device is not None and torch.device(device).type == "cpu"
        else None)
    import torch.distributed as dist

    quiet = dist.is_initialized() and dist.get_rank() != 0
    with (contextlib.redirect_stdout(open(os.devnull, "w")) if quiet
          else contextlib.nullcontext()):
        return _main(argv, use_kernels=use_kernels, num_layers=num_layers,
                     on_block=on_block, init_on_device=init_on_device)


def _main(argv=None, *, use_kernels: bool = False,
          num_layers: int | None = None, on_block=None,
          init_on_device: bool = False) -> dict:
    """Train.  ``num_layers`` cuts the arch's depth, keeping its widths (a
    smoke run's knob; ``None`` keeps the config's depth); ``on_block(i,
    before, after, metrics)`` is called after each block with the states
    around it (``before``'s optimizer state and async buffer are advanced
    in place by the step; ``metrics["batch"]`` is the block as fed).
    ``init_on_device`` draws the initial parameters from a generator of
    the run's device seeded with ``--seed`` instead of the host generator
    (a full-width stack on a card in a fraction of the host's time; other
    values than the host's, which then feeds only the engine and the
    data).

    Returns the final ``EngineState`` (``state``), the spec (``spec``),
    the engine (``engine``), the config (``cfg``), and per logged block the
    agents' losses on local step 0's batch (``losses``), the realized masks
    (``active``; the fire masks on the async engine) and, with
    ``--privacy``, the spent epsilon (``epsilon``); per block the seconds
    (``timings``: ``block_s``, ``local_s``, ``combine_s``),
    ``tokens_per_s`` (K T B S over the block's seconds), the realized (K,
    K) graph matrix (``graphs``, on the CPU) and, on the async engine, the
    makespan (``t_wall``); the ``comm:`` banner's numbers (``comm``, None
    without compression), the blocks run (``blocks_done``: fewer than
    ``--blocks`` when the privacy budget halts the run), the privacy tier
    (``privacy``, None without it) and the block provider (``provider``,
    index-replayable: ``provider(i, key)`` is block ``i`` as fed)."""
    ap = _parser()
    args = ap.parse_args(argv)
    spec = spec_from_args(args)
    device = resolve_device(args.device)
    if spec.model.kind != "transformer":
        raise ValueError(
            f"the train driver trains a transformer spec; model kind "
            f"{spec.model.kind!r} needs a loss_fn: call "
            "repro_torch.api.build(spec, loss_fn) yourself")
    bundle = get_config(spec.model.arch)
    cfg = bundle.smoke if spec.model.smoke else bundle.model
    if use_kernels:
        cfg = dataclasses.replace(cfg, use_kernels=True)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)

    def loss(p, b):
        return tf.train_loss(p, cfg, b, remat=False)

    def loss_rng(p, b, rng):
        del rng                   # deterministic loss (the reference's)
        return loss(p, b)

    kind = resolve_engine(spec, args.engine)
    mesh = mesh_lib.make_production_mesh() if kind == "sharded" else None
    eng = build(spec, loss_rng if kind == "sharded" else loss, engine=kind,
                device=device, mesh=mesh)
    shard = getattr(eng, "shard", None)
    if shard is not None:
        print(f"engine: sharded over {shard.world} ranks "
              f"({shard.backend}), {len(shard.local_agents)} agents a rank")
    run = spec.run
    K, T = run.num_agents, run.local_steps
    is_async = eng.engine_kind == "async"
    if spec.graph.kind != "static":
        print(f"graph: {spec.graph.kind}: the combination matrix is "
              f"resampled every block ({eng.graph!r}); "
              f"stateful={bool(eng.graph.stateful)}")
    privacy = eng.privacy
    budget = (privacy.epsilon_budget or 0.0) if privacy is not None else 0.0
    if privacy is not None:
        _privacy_banner(privacy, budget)
    if is_async:
        _async_banner(eng, spec)
    key = torch.Generator().manual_seed(run.seed)
    init_key = (torch.Generator(device=device).manual_seed(run.seed)
                if init_on_device else key)
    params = init_stacked(init_key, cfg, K, device,
                          None if shard is None else shard.local_agents)
    state = eng.init_state(params, eng.optimizer.init(params), key=key)
    comm = None if is_async else _comm_banner(
        eng.pipeline, tf.param_specs(cfg, num_agents=K), spec)
    del params
    fetch = getattr(eng, "fetch", lambda s: s)
    if getattr(eng, "ef_host_offload", False):
        # parked once here; each step fetches it for its combination only
        print("comm: the pipeline memory parks in pinned host memory "
              "outside the combination" if ef_host_sharding(device)
              is not None else
              "comm: --ef-host-offload requested, but the CPU has no "
              "pinned host space of its own: the offload is the identity")
        state = eng.offload(state)
    if eng.step_mask is not None:
        t_k = eng.step_mask.sum(dim=0).long()
        print(f"local steps: degree-aware T_k in [{int(t_k.min())}, "
              f"{int(t_k.max())}] (uniform T={T})")
    provider = eng.data
    if spec.data.kind != "iid":
        sizes = [len(p) for p in provider.partitions]
        print(f"data: {spec.data.kind} partition over {K} agents "
              f"(alpha={spec.data.alpha:g}, seed={spec.data.seed}) — "
              f"windows/agent min={min(sizes)} max={max(sizes)}; blocks "
              "are index-replayable (resume re-derives every batch)")

    if budget:
        # one stationary-rate block of RDP: projecting the next block's
        # spend from the host mirror of the accountant halts the run
        # before the crossing block; the check after each block backstops
        # a realized rate above the stationary one
        inc_bar = privacy.steps_per_block * rdp_increment_np(
            float(spec.q_vector().mean()), privacy.noise_multiplier,
            privacy.orders)
    eps_spent = host_rdp = None
    if budget:
        host_rdp = np.zeros(len(privacy.orders), np.float64)
        eps_spent = epsilon_from_rdp_np(host_rdp, privacy.delta,
                                        privacy.orders)

    out = {"spec": spec, "engine": eng, "cfg": cfg, "losses": [],
           "active": [], "timings": [], "tokens_per_s": [], "comm": comm,
           "graphs": [], "epsilon": [], "t_wall": [], "privacy": privacy,
           "provider": provider, "blocks_done": 0}
    tokens = K * T * run.batch * run.seq
    t_start = time.perf_counter()
    for i in range(run.blocks):
        if budget:
            projected = epsilon_from_rdp_np(host_rdp + inc_bar,
                                            privacy.delta, privacy.orders)
            if projected > budget:
                print(f"privacy budget: epsilon={eps_spent:.3f} spent, "
                      f"next block projects to {projected:.3f} > "
                      f"{budget:g} — halting after {out['blocks_done']} "
                      "blocks")
                break
        batch = provider(i, key)
        t0 = time.perf_counter()
        before = state
        state, metrics = eng.step(before, batch, key)
        block_s = time.perf_counter() - t0
        if on_block is not None:
            on_block(i, before, state, {**metrics, "batch": batch})
        del before
        out["blocks_done"] = i + 1
        out["timings"].append({"block_s": block_s,
                               "local_s": metrics["local_s"],
                               "combine_s": metrics["combine_s"]})
        out["tokens_per_s"].append(tokens / block_s)
        out["graphs"].append(metrics["A_t"].cpu())
        if is_async:
            out["t_wall"].append(float(metrics["t_wall"]))
        log_block = i % args.log_every == 0
        if privacy is not None and (budget or log_block):
            # read the accountant only when the value is used
            host_rdp = state.privacy_state["rdp"].cpu().double().numpy()
            eps_spent = epsilon_from_rdp_np(host_rdp, privacy.delta,
                                            privacy.orders)
        if log_block:
            active = metrics["active"]
            rows = (range(K) if shard is None else shard.local_agents)
            with torch.no_grad():
                losses = torch.stack([
                    loss(tree_map(lambda x, j=j: x[j], state.params),
                         tree_map(lambda x, k=k: x[0, k], batch))
                    for j, k in enumerate(rows)])
            if shard is not None:
                losses = shard.gather(losses)
            losses = losses.cpu()
            out["losses"].append(losses.tolist())
            out["active"].append(active.cpu().tolist())
            wall = (f"  sim_wall={float(metrics['t_wall']):.1f}s"
                    if is_async else "")
            eps = ""
            if eps_spent is not None:
                out["epsilon"].append(eps_spent)
                eps = f"  epsilon={eps_spent:.3f}"
            print(f"block {i:4d}  active={int(active.sum())}/{K}  "
                  f"mean_loss={float(losses.mean()):.4f}  "
                  f"spread={float(losses.max() - losses.min()):.4f}  "
                  f"t={time.perf_counter() - t_start:.1f}s{wall}{eps}")
        if budget and eps_spent >= budget:
            print(f"privacy budget spent: epsilon={eps_spent:.3f} >= "
                  f"{budget:g} after {out['blocks_done']} blocks — halting")
            break
    out["state"] = state
    if args.checkpoint:
        import torch.distributed as dist

        whole = gather_state(fetch(state), shard)
        if not dist.is_initialized() or dist.get_rank() == 0:
            _save(args.checkpoint, whole, spec, privacy, out["blocks_done"])
        del whole
    return out


def _save(path, state, spec, privacy, blocks_done: int) -> None:
    """Write the whole state with the spec embedded (one file)."""
    metadata = {"arch": spec.model.arch}
    if privacy is not None:
        # the guarantee the saved iterate carries; serve --checkpoint
        # reports it next to the model
        metadata["epsilon_spent"] = privacy.epsilon_np(
            state.privacy_state)
        metadata["privacy_delta"] = spec.privacy.delta
    save_experiment(path, state, spec=spec, step=blocks_done,
                    metadata=metadata)
    print("saved", path)


if __name__ == "__main__":
    main()
