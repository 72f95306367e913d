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

The third is the reference's ``byzantine_robust_diffusion`` preset (K = 12
ring, 3 evenly spaced sign-flip adversaries, per-neighborhood trimmed
mean): ``--attack`` corrupts the Byzantine agents' raw gradients before
the optimizer sees them (:func:`repro_torch.core.attacks.make_attack`).
The fourth is its ``compressed_fedavg`` preset: FedAvg, int8 with error
feedback, every combination through the fused dequantize+mix kernel;
``--compress topk|randk|gauss`` runs CHOCO's reference-difference mode.
The last resamples the combination matrix every block (``--graph
static|link_dropout|gossip|tv_erdos``, with ``--link-drop``,
``--graph-corr`` and ``--graph-p``) under bursty availability
(``--participation-process iid|markov|cyclic``, with ``--markov-corr`` and
``--num-groups``); a graph sub-flag given with a kind that does not use
it raises ``ValueError``, as in the reference.  The one after it is
differentially private (``--privacy``: per-agent clip and Gaussian noise
at every local step, the RDP accountant, the noise multiplier calibrated
to ``--privacy-epsilon`` over the run, a halt before a block projected to
overshoot that budget; ``--privacy-secure-agg`` runs the combination
through pairwise-canceling wire masks) on a Dirichlet-skewed partition of
a seeded Zipf corpus (``--data dirichlet|shards``; every block replayable
from its index).  A privacy sub-flag without ``--privacy``, or a data
sub-flag its kind does not read, raises ``ValueError``.

Counterpart of ``repro.launch.train`` on the stacked engine (on one device
the reference's ``engine="auto"`` sharded engine equals it).  The flags are
the ported subset of the reference's shared flag set, with its defaults;
a reference flag outside the subset raises ``NotImplementedError`` naming
the ROADMAP item that brings it.  ``--device`` defaults to CUDA and never
falls back to the CPU by itself.

Every random draw (initial weights, batches, activation masks, graphs)
comes from one host generator seeded with ``--seed``, so the card and the
CPU realize the same run.  The kernels of the local updates are chosen by
``cfg.use_kernels``, as in the reference: ``main(..., use_kernels=True)``
applies ``dataclasses.replace(cfg, use_kernels=True)``, which runs the
flash-attention kernel in attention layers and the SSD intra-chunk kernel
in mamba layers.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.attacks import ATTACK_KINDS, make_attack
from repro_torch.core.compression import dense_wire_bytes
from repro_torch.core.diffusion import DiffusionConfig, DiffusionEngine
from repro_torch.core.privacy import (compile_privacy, epsilon_from_rdp_np,
                                      rdp_increment_np)
from repro_torch.core.schedules import CyclicGroups, MarkovAvailability
from repro_torch.data.pipeline import DATA_KINDS, make_block_provider
from repro_torch.device import resolve_device
from repro_torch.launch.serve import MIX_CHOICES, check_robust_flags
from repro_torch.models import transformer as tf
from repro_torch.optim import adam, momentum, sgd
from repro_torch.tree import tree_map

__all__ = ["main", "init_stacked"]

_OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adam": adam}

#: reference flags the port does not take yet -> the ROADMAP.md queue-1
#: item that brings them (prefix match)
_PENDING_FLAGS = {
    "--spec": 16, "--preset": 16, "--checkpoint": 16, "--engine": 16,
    "--topology-": 16, "--async-": 24, "--ef-host-offload": 25,
}


#: the reference's --compress choices
COMPRESS_CHOICES = ["none", "topk", "randk", "int8", "gauss"]

#: graph sub-flag -> (the flag, the kinds that use it, its default)
_GRAPH_FLAGS = {"link_drop": ("--link-drop", ("link_dropout",), 0.3),
                "graph_corr": ("--graph-corr", ("link_dropout",), 0.0),
                "graph_p": ("--graph-p", ("tv_erdos",), 0.3)}


#: privacy sub-flag -> (the flag, its default): each needs --privacy
_PRIVACY_FLAGS = {"privacy_epsilon": ("--privacy-epsilon", 0.0),
                  "privacy_delta": ("--privacy-delta", 1e-5),
                  "privacy_clip": ("--privacy-clip", 1.0),
                  "privacy_noise": ("--privacy-noise", 0.0),
                  "privacy_secure_agg": ("--privacy-secure-agg", False),
                  "privacy_allow_gauss": ("--privacy-allow-gauss", False)}

#: data sub-flag -> (the flag, the kinds that read it, its default)
_DATA_FLAGS = {"data_alpha": ("--data-alpha", ("dirichlet",), 1.0),
               "data_clusters": ("--data-clusters", ("dirichlet",), 4),
               "data_shards": ("--data-shards", ("shards",), 1),
               "data_corpus_tokens": ("--data-corpus-tokens",
                                      ("dirichlet", "shards"), 65536)}


def _gamma_arg(s: str):
    """--comm-gamma takes a float or the literal "auto"."""
    return s if s == "auto" else float(s)


def _reject_unported(ap: argparse.ArgumentParser, extra: list[str]) -> None:
    for tok in extra:
        name = tok.split("=")[0]
        for prefix, item in _PENDING_FLAGS.items():
            if name.startswith(prefix):
                raise NotImplementedError(
                    f"{name} is not ported yet: see ROADMAP.md queue 1 item "
                    f"{item}")
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")


def check_graph_flags(args: argparse.Namespace) -> None:
    """The reference's guard: each graph sub-flag is used by one kind, and
    given with another kind it would be silently ignored, so it raises
    ``ValueError``.  Then fills in the defaults of the flags not given."""
    for dest, (flag, kinds, default) in _GRAPH_FLAGS.items():
        if getattr(args, dest) is None:
            setattr(args, dest, default)
        elif args.graph not in kinds:
            raise ValueError(
                f"{flag} only applies to --graph {'|'.join(kinds)}; the "
                f"{args.graph!r} graph process ignores it: drop the flag or "
                "pick the matching kind")


def check_privacy_flags(args: argparse.Namespace) -> None:
    """The reference's guard: a privacy sub-flag without ``--privacy``
    would tune an accountant that never runs (a false privacy claim), so
    it raises ``ValueError``.  Then fills in the defaults."""
    given = [flag for dest, (flag, _) in _PRIVACY_FLAGS.items()
             if getattr(args, dest) is not None]
    if given and not args.privacy:
        raise ValueError(
            f"{'/'.join(given)} configures the differential-privacy tier "
            "but privacy is not enabled — pass --privacy (or a preset/"
            "spec with privacy.enabled)")
    for dest, (_, default) in _PRIVACY_FLAGS.items():
        if getattr(args, dest) is None:
            setattr(args, dest, default)


def check_data_flags(args: argparse.Namespace) -> None:
    """The reference's guard: each data sub-flag is read by its kinds
    only, and given with another kind it would be silently ignored, so it
    raises ``ValueError``.  Then fills in the defaults."""
    for dest, (flag, kinds, default) in _DATA_FLAGS.items():
        if getattr(args, dest) is None:
            setattr(args, dest, default)
        elif args.data not in kinds:
            raise ValueError(
                f"{flag} only applies to --data {'|'.join(kinds)}; the "
                f"{args.data!r} data kind ignores it — drop the flag or "
                "pick the matching kind")


def make_provider(args: argparse.Namespace, cfg, device):
    """The block provider the data flags denote (``provider(i, key)``)."""
    kind_kwargs = {
        "iid": {},
        "dirichlet": {"alpha": args.data_alpha,
                      "clusters": args.data_clusters},
        "shards": {"shards_per_agent": args.data_shards}}[args.data]
    if args.data != "iid":
        kind_kwargs.update(seed=args.data_seed,
                           corpus_tokens=args.data_corpus_tokens)
    return make_block_provider(
        args.data, cfg, num_agents=args.agents, local_steps=args.local_steps,
        batch=args.batch, seq=args.seq, device=device, **kind_kwargs)


def graph_kwargs(args: argparse.Namespace) -> tuple:
    """The graph-process kwargs the flags denote, as sorted (k, v) pairs:
    only those the kind uses, as the reference's ``graph_kwargs``."""
    if args.graph == "link_dropout":
        return (("corr", args.graph_corr), ("drop", args.link_drop))
    if args.graph == "tv_erdos":
        return (("p", args.graph_p),)
    return ()


def make_participation(args: argparse.Namespace, num_agents: int):
    """The availability process the flags denote (``None``: i.i.d.
    Bernoulli with ``--participation``, the engine's default)."""
    if args.participation_process == "markov":
        return MarkovAvailability(args.participation, args.markov_corr,
                                  num_agents=num_agents)
    if args.participation_process == "cyclic":
        return CyclicGroups(num_agents, args.num_groups)
    return None


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced smoke config (default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="full-size model config")
    ap.add_argument("--agents", type=int, default=4, help="K")
    ap.add_argument("--local-steps", type=int, default=2, help="T")
    ap.add_argument("--step-size", type=float, default=0.5, help="mu")
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--graph", default="static",
                    help="time variation of the combination graph: "
                         "static|link_dropout|gossip|tv_erdos")
    ap.add_argument("--link-drop", type=float, default=None,
                    help="link_dropout: per-block edge failure probability "
                         "(default 0.3)")
    ap.add_argument("--graph-corr", type=float, default=None,
                    help="link_dropout: link-outage autocorrelation "
                         "(default 0.0)")
    ap.add_argument("--graph-p", type=float, default=None,
                    help="tv_erdos: per-block edge probability (default "
                         "0.3)")
    ap.add_argument("--participation", type=float, default=0.9,
                    help="activation probability q")
    ap.add_argument("--participation-process", default="iid",
                    choices=["iid", "markov", "cyclic"],
                    help="agent-availability model")
    ap.add_argument("--markov-corr", type=float, default=0.5,
                    help="availability autocorrelation (markov)")
    ap.add_argument("--num-groups", type=int, default=2,
                    help="round-robin groups (cyclic)")
    ap.add_argument("--drift-correction", action="store_true", default=False,
                    help="eq. (31) mu/q_k step sizes")
    ap.add_argument("--local-steps-mode", default="uniform",
                    choices=["uniform", "degree"])
    ap.add_argument("--optimizer", default="adam", choices=list(_OPTIMIZERS))
    ap.add_argument("--mix", default="dense", choices=MIX_CHOICES,
                    help="combination-step backend")
    ap.add_argument("--trim", type=int, default=None,
                    help="per-side trim for --mix trimmed_mean; per-side cap "
                         "for --mix adaptive_trim (default 1)")
    ap.add_argument("--robust-scope", default=None,
                    choices=["global", "neighborhood"],
                    help="robust-aggregation scope (default global)")
    ap.add_argument("--robust-gather", default=None,
                    choices=["auto", "table", "fused", "off"],
                    help="bounded-degree policy of the neighborhood scope: "
                         "auto (the default: fused kernel on CUDA, table "
                         "elsewhere), table, fused, off (all-slots sort)")
    ap.add_argument("--attack", default="none", choices=list(ATTACK_KINDS),
                    help="Byzantine gradient adversary")
    ap.add_argument("--attack-num", type=int, default=None,
                    help="Byzantine agent count, evenly spaced (default 1)")
    ap.add_argument("--attack-scale", type=float, default=None,
                    help="attack magnitude (default 1.0)")
    ap.add_argument("--compress", default="none", choices=COMPRESS_CHOICES,
                    help="communication compressor")
    ap.add_argument("--compress-ratio", type=float, default=0.1,
                    help="kept coordinate fraction (topk/randk/gauss)")
    ap.add_argument("--compress-sigma", type=float, default=0.0,
                    help="Gaussian-mask noise scale (gauss)")
    ap.add_argument("--error-feedback", action="store_true", default=False,
                    help="error-feedback residual memory")
    ap.add_argument("--comm-gamma", type=_gamma_arg, default=None,
                    help="consensus step of the compressed exchange: a "
                         "float, or 'auto' (diff mode: the CHOCO floor from "
                         "the topology's spectral gap, annealed from the "
                         "observed contraction)")
    ap.add_argument("--privacy", action="store_true", default=False,
                    help="differential privacy: per-agent clip + Gaussian "
                         "noise on local gradients and an RDP accountant "
                         "in EngineState.privacy_state")
    ap.add_argument("--privacy-epsilon", type=float, default=None,
                    help="epsilon budget: with --privacy-noise 0 the noise "
                         "multiplier is calibrated to spend it over blocks "
                         "x local steps invocations; otherwise a halt "
                         "budget (default 0: none)")
    ap.add_argument("--privacy-delta", type=float, default=None,
                    help="delta of the (epsilon, delta) guarantee (default "
                         "1e-5)")
    ap.add_argument("--privacy-clip", type=float, default=None,
                    help="per-agent gradient L2 clip norm (default 1.0)")
    ap.add_argument("--privacy-noise", type=float, default=None,
                    help="noise multiplier sigma; 0 derives it from "
                         "--privacy-epsilon (default 0)")
    ap.add_argument("--privacy-secure-agg", action="store_const",
                    const=True, default=None,
                    help="pairwise-canceling secure-agg wire masks on the "
                         "combination step")
    ap.add_argument("--privacy-allow-gauss", action="store_const",
                    const=True, default=None,
                    help="opt in to stacking the DP tier with --compress "
                         "gauss (double noise, refused by default)")
    ap.add_argument("--data", default="iid", choices=list(DATA_KINDS),
                    help="per-agent data: iid (fresh synthetic tokens a "
                         "block) | dirichlet | shards (a partitioned "
                         "seeded Zipf corpus)")
    ap.add_argument("--data-alpha", type=float, default=None,
                    help="dirichlet: concentration over latent classes "
                         "(default 1.0)")
    ap.add_argument("--data-shards", type=int, default=None,
                    help="shards: contiguous shards per agent (default 1)")
    ap.add_argument("--data-clusters", type=int, default=None,
                    help="dirichlet: latent class count (default 4)")
    ap.add_argument("--data-seed", type=int, default=0,
                    help="partition + block-replay seed")
    ap.add_argument("--data-corpus-tokens", type=int, default=None,
                    help="partitioned kinds: synthetic corpus length "
                         "(default 65536)")
    ap.add_argument("--blocks", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2, help="per-agent batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    return ap


def init_stacked(key: torch.Generator, cfg, num_agents: int,
                 device: torch.device):
    """K agents initialized one after another from ``key`` and stacked on a
    leading axis on ``device``."""
    agents = [tree_map(lambda x: x.to(device), tf.init_params(key, cfg))
              for _ in range(num_agents)]
    return tree_map(lambda *xs: torch.stack(xs), *agents)


def _comm_banner(pipeline, params, args) -> dict | None:
    """The reference's ``comm:`` line: the compressor that runs, its mode
    and gamma, and the payload bytes per combination against dense
    float32.  Returns them, or None without compression."""
    if args.compress == "none":
        return None
    wire = pipeline.wire_bytes(params)
    info = {"compressor": pipeline.compressor.name, "mode": pipeline.mode,
            "gamma": pipeline.gamma, "wire_bytes": wire,
            "dense_wire_bytes": dense_wire_bytes(params)}
    if wire == 0:
        print("comm: single agent: mixing disabled, compression inert")
    else:
        print(f"comm: {info['compressor']} ratio={args.compress_ratio} "
              f"mode={pipeline.mode} gamma={pipeline.gamma}  "
              f"{wire / 1e6:.2f} MB/combination on the wire "
              f"({info['dense_wire_bytes'] / wire:.1f}x below dense f32)")
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


def main(argv=None, *, use_kernels: bool = False) -> dict:
    """Train.  Returns the final ``EngineState`` (``state``), the
    config (``cfg``), and per logged block the agents' losses on local step
    0's batch (``losses``), the realized masks (``active``) and, with
    ``--privacy``, the spent epsilon (``epsilon``); per block the seconds
    (``timings``: ``block_s``, ``local_s``, ``combine_s``),
    ``tokens_per_s`` (K T B S over the block's seconds) and the realized
    (K, K) combination matrix (``graphs``, on the CPU); the ``comm:``
    banner's numbers (``comm``, None without compression), the blocks run
    (``blocks_done``: fewer than ``--blocks`` when the privacy budget halts
    the run), the privacy tier (``privacy``, None without it) and the block
    provider (``provider``, index-replayable: ``provider(i, key)`` is block
    ``i`` as fed)."""
    ap = _parser()
    args, extra = ap.parse_known_args(argv)
    _reject_unported(ap, extra)
    check_robust_flags(args)
    check_graph_flags(args)
    check_privacy_flags(args)
    check_data_flags(args)
    device = resolve_device(args.device)
    bundle = get_config(args.arch)
    cfg = bundle.smoke if args.smoke else bundle.model
    if use_kernels:
        cfg = dataclasses.replace(cfg, use_kernels=True)
    K, T = args.agents, args.local_steps
    process = make_participation(args, K)
    dcfg = DiffusionConfig(
        num_agents=K, local_steps=T, step_size=args.step_size,
        topology=args.topology, graph=args.graph,
        graph_kwargs=graph_kwargs(args),
        participation=(args.participation if process is None
                       else tuple(process.q_vector())),
        drift_correction=args.drift_correction, mix=args.mix,
        compress=args.compress, compress_ratio=args.compress_ratio,
        compress_sigma=args.compress_sigma,
        error_feedback=args.error_feedback, comm_gamma=args.comm_gamma,
        local_steps_mode=args.local_steps_mode)
    privacy = compile_privacy(
        K, dcfg.q_vector(), blocks=args.blocks, local_steps=T,
        enabled=args.privacy, epsilon=args.privacy_epsilon,
        delta=args.privacy_delta, clip=args.privacy_clip,
        noise_multiplier=args.privacy_noise,
        secure_agg=args.privacy_secure_agg, seed=args.seed)
    optimizer = _OPTIMIZERS[args.optimizer]()
    if privacy is not None:
        if args.compress == "gauss" and not args.privacy_allow_gauss:
            raise ValueError(
                "spec.privacy with GaussianMask compression double-noises "
                "the exchange: the compressor's sigma is NOT counted by "
                "the accountant, so it is silent utility loss with no "
                "epsilon credit — set PrivacySpec.allow_gauss=True "
                "(--privacy-allow-gauss) to opt in deliberately, or drop "
                "one of the noise sources")
        # raw gradients -> attack -> clip + noise -> optimizer, as the
        # reference composes them: privacy wraps the optimizer first, so
        # the attack lands outermost
        optimizer = privacy.wrap(optimizer)
    if args.attack != "none":
        optimizer = make_attack(args.attack, K,
                                num_byzantine=args.attack_num,
                                scale=args.attack_scale, seed=args.seed,
                                inner=optimizer)
    plain_sgd = (args.optimizer == "sgd" and args.attack == "none"
                 and privacy is None)

    def loss(p, b):
        return tf.train_loss(p, cfg, b, remat=False)

    eng = DiffusionEngine(
        dcfg, loss, None if plain_sgd else optimizer.update, device=device,
        participation=process, trim=args.trim, scope=args.robust_scope,
        gather=args.robust_gather, privacy=privacy)
    if args.graph != "static":
        print(f"graph: {args.graph}: the combination matrix is resampled "
              f"every block ({eng.graph!r}); "
              f"stateful={bool(eng.graph.stateful)}")
    budget = (privacy.epsilon_budget or 0.0) if privacy is not None else 0.0
    if privacy is not None:
        _privacy_banner(privacy, budget)
    key = torch.Generator().manual_seed(args.seed)
    params = init_stacked(key, cfg, K, device)
    state = eng.init_state(params, optimizer.init(params), key=key)
    comm = _comm_banner(eng.pipeline, params, args)
    del params
    if eng.step_mask is not None:
        t_k = eng.step_mask.sum(dim=0).long()
        print(f"local steps: degree-aware T_k in [{int(t_k.min())}, "
              f"{int(t_k.max())}] (uniform T={T})")
    provider = make_provider(args, cfg, device)
    if args.data != "iid":
        sizes = [len(p) for p in provider.partitions]
        print(f"data: {args.data} partition over {K} agents "
              f"(alpha={args.data_alpha:g}, seed={args.data_seed}) — "
              f"windows/agent min={min(sizes)} max={max(sizes)}; blocks "
              "are index-replayable (resume re-derives every batch)")

    if budget:
        # one stationary-rate block of RDP: projecting the next block's
        # spend from the host mirror of the accountant halts the run
        # before the crossing block; the check after each block backstops
        # a realized rate above the stationary one
        inc_bar = privacy.steps_per_block * rdp_increment_np(
            float(dcfg.q_vector().mean()), privacy.noise_multiplier,
            privacy.orders)
    eps_spent = host_rdp = None
    if budget:
        host_rdp = np.zeros(len(privacy.orders), np.float64)
        eps_spent = epsilon_from_rdp_np(host_rdp, privacy.delta,
                                        privacy.orders)

    out = {"cfg": cfg, "losses": [], "active": [], "timings": [],
           "tokens_per_s": [], "comm": comm, "graphs": [],
           "epsilon": [], "privacy": privacy, "provider": provider,
           "blocks_done": 0}
    tokens = K * T * args.batch * args.seq
    t_start = time.perf_counter()
    for i in range(args.blocks):
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
        state, metrics = eng.step(state, batch, key)
        block_s = time.perf_counter() - t0
        out["blocks_done"] = i + 1
        out["timings"].append({"block_s": block_s,
                               "local_s": metrics["local_s"],
                               "combine_s": metrics["combine_s"]})
        out["tokens_per_s"].append(tokens / block_s)
        out["graphs"].append(metrics["A_t"].cpu())
        log_block = i % args.log_every == 0
        if privacy is not None and (budget or log_block):
            # read the accountant only when the value is used
            host_rdp = state.privacy_state["rdp"].cpu().double().numpy()
            eps_spent = epsilon_from_rdp_np(host_rdp, privacy.delta,
                                            privacy.orders)
        if log_block:
            active = metrics["active"]
            with torch.no_grad():
                losses = torch.stack([
                    loss(tree_map(lambda x, k=k: x[k], state.params),
                         tree_map(lambda x, k=k: x[0, k], batch))
                    for k in range(K)]).cpu()
            out["losses"].append(losses.tolist())
            out["active"].append(active.cpu().tolist())
            eps = ""
            if eps_spent is not None:
                out["epsilon"].append(eps_spent)
                eps = f"  epsilon={eps_spent:.3f}"
            print(f"block {i:4d}  active={int(active.sum())}/{K}  "
                  f"mean_loss={float(losses.mean()):.4f}  "
                  f"spread={float(losses.max() - losses.min()):.4f}  "
                  f"t={time.perf_counter() - t_start:.1f}s{eps}")
        if budget and eps_spent >= budget:
            print(f"privacy budget spent: epsilon={eps_spent:.3f} >= "
                  f"{budget:g} after {out['blocks_done']} blocks — halting")
            break
    out["state"] = state
    return out


if __name__ == "__main__":
    main()
