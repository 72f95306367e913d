"""The shared CLI front end of the launch drivers.

Counterpart of ``repro.api.cli``: the same flags, defaults, choices,
guards and preset overlay, so the same argv gives byte-equal spec JSON in
the port and in the reference (``tests/test_torch_api.py``).  The port's
launchers (``repro_torch.launch.train``, ``repro_torch.launch.serve``)
build their experiment description through this one module:

    ap = argparse.ArgumentParser()
    add_spec_args(ap)              # the shared, spec-mapped flag set
    ap.add_argument(...)           # driver-specific flags only
    spec = spec_from_args(ap.parse_args())

so the flag names, choices, and defaults cannot drift between drivers.
Three ways to an :class:`ExperimentSpec`, in precedence order:

* ``--spec path.json``    — load a spec verbatim (the JSON ``to_json``
  emits; what checkpoints embed);
* ``--preset <variant>``  — a Section-IV variants factory
  (``repro_torch.core.variants``), parameterized by ``--agents`` /
  ``--local-steps`` / ``--step-size`` / ``--participation`` etc.; the
  driver fields (``--blocks``/``--batch``/``--seq``/``--seed``/``--arch``)
  and any *explicitly passed* structural flags (``--mix``, ``--compress``,
  ``--compress-ratio``, ...) are overlaid on top of the preset, so
  ``--preset compressed_fedavg --mix pallas`` means exactly what it says;
* bare flags              — every flag maps onto one spec field.

One guard is stricter than the reference's: ``--trim``/``--robust-scope``/
``--robust-gather`` with ``--mix gather`` raise, as with every other
non-robust builtin mixer (the gather mixer reads none of them; the
reference lets them pass unused).
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.api.spec import (AsyncSpec, AttackSpec, CompressionSpec,
                                  DataSpec, ExperimentSpec, GraphSpec,
                                  MixerSpec, ModelSpec, OptimizerSpec,
                                  ParticipationSpec, PrivacySpec, RunSpec,
                                  TopologySpec)

__all__ = ["add_spec_args", "spec_from_args", "get_preset", "preset_names"]

_MIX_CHOICES = ["dense", "sparse", "pallas", "gather", "auto", "none",
                "trimmed_mean", "median", "adaptive_trim"]
_ROBUST_MIX_KINDS = ("trimmed_mean", "median", "adaptive_trim")
_COMPRESS_CHOICES = ["none", "topk", "randk", "int8", "gauss"]
_ATTACK_CHOICES = ["none", "sign_flip", "noise", "shift"]


def _gamma_arg(s: str):
    """--comm-gamma accepts a float or the literal "auto" (spectral-gap
    floor + observed-contraction anneal, see core/mixing.CommPipeline)."""
    if s == "auto":
        return s
    return float(s)


class _Track(argparse.Action):
    """Store the value AND record that the flag was explicitly passed, so
    the --preset path can overlay exactly what the user asked for (a flag
    left at its default must not override the preset's choice)."""

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, values)
        namespace._explicit.add(self.dest)


class _TrackTrue(argparse.Action):
    def __init__(self, option_strings, dest, **kwargs):
        kwargs.update(nargs=0)
        super().__init__(option_strings, dest, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, True)
        namespace._explicit.add(self.dest)


def get_preset(name: str):
    """Resolve a preset factory by name (imports the variants module so the
    built-in presets are registered)."""
    from repro_torch.api.spec import PRESETS
    from repro_torch.core import variants  # noqa: F401 — populates PRESETS
    return PRESETS.get(name)


def preset_names() -> tuple:
    from repro_torch.api.spec import PRESETS
    from repro_torch.core import variants  # noqa: F401 — populates PRESETS
    return PRESETS.names()


def add_spec_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Register the shared spec-mapped flags (one source of truth)."""
    ap.set_defaults(_explicit=set())
    g = ap.add_argument_group("experiment spec",
                              "shared across train/dryrun/serve; every flag "
                              "maps onto one ExperimentSpec field")
    g.add_argument("--spec", default=None, metavar="PATH",
                   help="load the full ExperimentSpec from a JSON file "
                        "(overrides every other spec flag)")
    g.add_argument("--preset", default=None, metavar="VARIANT",
                   help="a repro_torch.core.variants preset (e.g. "
                        "fedavg_full, "
                        "compressed_diffusion); parameterized by --agents/"
                        "--local-steps/--step-size/--participation")
    g.add_argument("--arch", default="smollm-360m",
                   help="model architecture (ModelSpec.arch)")
    g.add_argument("--smoke", action="store_true", default=True,
                   help="reduced smoke config (default)")
    g.add_argument("--full", dest="smoke", action="store_false",
                   help="full-size model config")
    g.add_argument("--agents", type=int, default=4, action=_Track,
                   help="K (RunSpec.num_agents)")
    g.add_argument("--local-steps", type=int, default=2,
                   help="T (RunSpec.local_steps)")
    g.add_argument("--step-size", type=float, default=0.5,
                   help="mu (RunSpec.step_size)")
    g.add_argument("--topology", default="ring", action=_Track,
                   help="base combination graph (TopologySpec.kind)")
    g.add_argument("--topology-hops", type=int, default=None, action=_Track,
                   help="ring: neighbors per side (TopologySpec.kwargs)")
    g.add_argument("--topology-p", type=float, default=None, action=_Track,
                   help="erdos: edge probability (TopologySpec.kwargs)")
    g.add_argument("--topology-seed", type=int, default=None, action=_Track,
                   help="erdos: graph seed (TopologySpec.kwargs)")
    g.add_argument("--topology-rows", type=int, default=None, action=_Track,
                   help="grid: row count (TopologySpec.kwargs)")
    g.add_argument("--topology-m", type=int, default=None, action=_Track,
                   help="scale_free: edges each arriving node attaches "
                        "(Barabasi-Albert m; TopologySpec.kwargs)")
    g.add_argument("--topology-rewire", type=float, default=None,
                   action=_Track,
                   help="small_world: per-edge rewiring probability "
                        "(Watts-Strogatz beta; TopologySpec.kwargs)")
    g.add_argument("--local-steps-mode", default="uniform", action=_Track,
                   choices=["uniform", "degree"],
                   help="per-agent local-update counts "
                        "(RunSpec.local_steps_mode): uniform (every agent "
                        "runs T eq.-17 steps) or degree (T_k = max(1, "
                        "round(T*d_min/d_k)) — hubs do less local work, "
                        "freezing early inside the shared scan)")
    g.add_argument("--data", default="iid", action=_Track,
                   help="per-agent data distribution (DataSpec.kind): iid "
                        "(legacy synthetic stream, bit-identical) | "
                        "dirichlet | shards | <registered>")
    g.add_argument("--data-alpha", type=float, default=1.0, action=_Track,
                   help="dirichlet: concentration over latent classes "
                        "(DataSpec.alpha); inf-like -> IID mixing, "
                        "near-0 -> one-class agents")
    g.add_argument("--data-shards", type=int, default=1, action=_Track,
                   help="shards: contiguous shards per agent "
                        "(DataSpec.shards_per_agent)")
    g.add_argument("--data-clusters", type=int, default=4, action=_Track,
                   help="dirichlet: latent class count (DataSpec.clusters)")
    g.add_argument("--data-seed", type=int, default=0, action=_Track,
                   help="partition + block-replay seed (DataSpec.seed)")
    g.add_argument("--data-corpus-tokens", type=int, default=65536,
                   action=_Track,
                   help="partitioned kinds: synthetic corpus length "
                        "(DataSpec.corpus_tokens)")
    g.add_argument("--graph", default="static", action=_Track,
                   help="time variation of the combination graph "
                        "(GraphSpec.kind): static|link_dropout|gossip|"
                        "tv_erdos|<registered>")
    g.add_argument("--link-drop", type=float, default=0.3, action=_Track,
                   help="link_dropout: per-block edge failure probability "
                        "(GraphSpec.drop)")
    g.add_argument("--graph-corr", type=float, default=0.0, action=_Track,
                   help="link_dropout: link-outage autocorrelation "
                        "(GraphSpec.corr)")
    g.add_argument("--graph-p", type=float, default=0.3, action=_Track,
                   help="tv_erdos: per-block edge probability (GraphSpec.p)")
    g.add_argument("--participation", type=float, default=0.9,
                   help="activation probability q (ParticipationSpec.q)")
    g.add_argument("--participation-process", default="iid", action=_Track,
                   choices=["iid", "markov", "cyclic"],
                   help="agent-availability model (ParticipationSpec.kind)")
    g.add_argument("--markov-corr", type=float, default=0.5,
                   help="availability autocorrelation "
                        "(ParticipationSpec.corr)")
    g.add_argument("--num-groups", type=int, default=2,
                   help="round-robin groups (ParticipationSpec.num_groups)")
    g.add_argument("--drift-correction", action=_TrackTrue, default=False,
                   help="eq. (31) mu/q_k step sizes "
                        "(RunSpec.drift_correction)")
    g.add_argument("--optimizer", default="adam", action=_Track,
                   choices=["sgd", "momentum", "adam"],
                   help="local-update gradient transform "
                        "(OptimizerSpec.kind)")
    g.add_argument("--mix", default="dense", choices=_MIX_CHOICES,
                   action=_Track,
                   help="combination-step backend (MixerSpec.kind)")
    g.add_argument("--trim", type=int, default=1, action=_Track,
                   help="per-side trim for --mix trimmed_mean; per-side "
                        "CAP for --mix adaptive_trim (MixerSpec.trim)")
    g.add_argument("--robust-scope", default="global", action=_Track,
                   choices=["global", "neighborhood"],
                   help="robust-aggregation scope (MixerSpec.scope): "
                        "global (SLSGD server aggregate over the active "
                        "set) or neighborhood (per-agent over the realized "
                        "A_t support)")
    g.add_argument("--robust-gather", default="auto", action=_Track,
                   choices=["auto", "table", "fused", "off"],
                   help="bounded-degree policy for the neighborhood scope "
                        "(MixerSpec.gather): auto (table when the graph "
                        "stays on base support; fused kernel on CUDA), "
                        "table (gathered plain torch), fused (the "
                        "gather-sort kernel), off (all-slots sort)")
    g.add_argument("--attack", default="none", choices=_ATTACK_CHOICES,
                   action=_Track,
                   help="Byzantine gradient adversary (AttackSpec.kind)")
    g.add_argument("--attack-num", type=int, default=1, action=_Track,
                   help="Byzantine agent count, evenly spaced "
                        "(AttackSpec.num_byzantine)")
    g.add_argument("--attack-scale", type=float, default=1.0, action=_Track,
                   help="attack magnitude (AttackSpec.scale)")
    g.add_argument("--compress", default="none", choices=_COMPRESS_CHOICES,
                   action=_Track,
                   help="communication compressor (CompressionSpec.kind)")
    g.add_argument("--compress-ratio", type=float, default=0.1,
                   action=_Track,
                   help="kept coordinate fraction (CompressionSpec.ratio)")
    g.add_argument("--compress-sigma", type=float, default=0.0,
                   action=_Track,
                   help="Gaussian-mask noise scale (CompressionSpec.sigma)")
    g.add_argument("--error-feedback", action=_TrackTrue, default=False,
                   help="EF residual memory (CompressionSpec.error_feedback)")
    g.add_argument("--ef-host-offload", action=_TrackTrue, default=False,
                   help="park the between-block pipeline memory (EF "
                        "residual / diff-mode reference) in pinned host "
                        "RAM (CompressionSpec.ef_host_offload; sharded "
                        "engine; the identity on the CPU, which has no "
                        "pinned host space of its own)")
    g.add_argument("--comm-gamma", type=_gamma_arg, default=None,
                   action=_Track,
                   help="consensus step of the compressed exchange "
                        "(CompressionSpec.gamma): a float, or 'auto' to "
                        "derive the CHOCO floor from the topology's "
                        "spectral gap and anneal from the observed "
                        "contraction (diff-mode pipelines, i.e. the "
                        "sparsifying compressors; other modes keep the "
                        "fixed default and warn)")
    g.add_argument("--engine", default="auto", action=_Track,
                   choices=["auto", "stacked", "sharded", "async"],
                   help="execution engine (repro_torch.api.build): stacked "
                        "(exact Algorithm 1), sharded (agent rows split "
                        "over a torch.distributed group under torchrun; "
                        "one device without one), async (event-driven "
                        "per-agent clocks + staleness buffer; sets "
                        "AsyncSpec.enabled), auto (async for an async "
                        "spec, else sharded for a transformer spec)")
    g.add_argument("--async-rate-dist", default="uniform", action=_Track,
                   choices=["uniform", "lognormal"],
                   help="per-agent event-rate model (AsyncSpec.rate_dist): "
                        "lognormal simulates stragglers — delay_k ~ "
                        "LogNormal(0, sigma), rate_k = 1/delay_k")
    g.add_argument("--async-rate", type=float, default=1.0, action=_Track,
                   help="uniform event rate (AsyncSpec.rates)")
    g.add_argument("--async-rate-sigma", type=float, default=0.0,
                   action=_Track,
                   help="lognormal delay log-std (AsyncSpec.rate_sigma)")
    g.add_argument("--async-rate-seed", type=int, default=0, action=_Track,
                   help="lognormal delay-draw seed (AsyncSpec.rate_seed)")
    g.add_argument("--async-tau-max", type=int, default=16, action=_Track,
                   help="staleness cap in blocks (AsyncSpec.tau_max): "
                        "buffered neighbor iterates older than this get "
                        "zero combination weight")
    g.add_argument("--async-discount", default="exp", action=_Track,
                   choices=["none", "exp", "poly"],
                   help="age-discount law (AsyncSpec.discount)")
    g.add_argument("--async-discount-rate", type=float, default=0.1,
                   action=_Track,
                   help="discount strength (AsyncSpec.discount_rate): "
                        "exp e^(-rate*age), poly (1+age)^-rate")
    g.add_argument("--privacy", action=_TrackTrue, default=False,
                   help="enable the differential-privacy tier "
                        "(PrivacySpec.enabled): per-agent clip + Gaussian "
                        "noise on local gradients plus an RDP accountant "
                        "threaded through EngineState.privacy_state")
    g.add_argument("--privacy-epsilon", type=float, default=0.0,
                   action=_Track,
                   help="epsilon budget (PrivacySpec.epsilon): with "
                        "--privacy-noise 0 the noise multiplier is "
                        "CALIBRATED to spend this over RunSpec.blocks x "
                        "local_steps mechanism invocations; with an "
                        "explicit noise multiplier it is a halt budget "
                        "for launch.train")
    g.add_argument("--privacy-delta", type=float, default=1e-5,
                   action=_Track,
                   help="delta of the (epsilon, delta) guarantee "
                        "(PrivacySpec.delta)")
    g.add_argument("--privacy-clip", type=float, default=1.0, action=_Track,
                   help="per-agent gradient L2 clip norm "
                        "(PrivacySpec.clip)")
    g.add_argument("--privacy-noise", type=float, default=0.0, action=_Track,
                   help="Gaussian noise multiplier sigma "
                        "(PrivacySpec.noise_multiplier); 0 derives it "
                        "from --privacy-epsilon")
    g.add_argument("--privacy-secure-agg", action=_TrackTrue, default=False,
                   help="pairwise-canceling secure-agg wire masks on the "
                        "combination step (PrivacySpec.secure_agg); "
                        "synchronous engines only")
    g.add_argument("--privacy-allow-gauss", action=_TrackTrue, default=False,
                   help="opt in to stacking the DP tier with the "
                        "GaussianMask compressor (PrivacySpec.allow_gauss) "
                        "— double noise injection, rejected by default")
    g.add_argument("--blocks", type=int, default=20,
                   help="block iterations (RunSpec.blocks)")
    g.add_argument("--batch", type=int, default=2,
                   help="per-agent batch (RunSpec.batch)")
    g.add_argument("--seq", type=int, default=64,
                   help="sequence length (RunSpec.seq)")
    g.add_argument("--seed", type=int, default=0, help="RunSpec.seed")
    return ap


#: flags whose EXPLICIT use overrides the corresponding preset field:
#: dest -> (sub-spec attribute, field name)
_PRESET_OVERRIDES = {
    "topology": ("topology", "kind"),
    "graph": ("graph", "kind"),
    "link_drop": ("graph", "drop"),
    "graph_corr": ("graph", "corr"),
    "graph_p": ("graph", "p"),
    "mix": ("mixer", "kind"),
    "trim": ("mixer", "trim"),
    "robust_scope": ("mixer", "scope"),
    "robust_gather": ("mixer", "gather"),
    "attack": ("attack", "kind"),
    "attack_num": ("attack", "num_byzantine"),
    "attack_scale": ("attack", "scale"),
    "compress": ("compression", "kind"),
    "compress_ratio": ("compression", "ratio"),
    "compress_sigma": ("compression", "sigma"),
    "error_feedback": ("compression", "error_feedback"),
    "ef_host_offload": ("compression", "ef_host_offload"),
    "comm_gamma": ("compression", "gamma"),
    "optimizer": ("optimizer", "kind"),
    "drift_correction": ("run", "drift_correction"),
    "local_steps_mode": ("run", "local_steps_mode"),
    "data": ("data", "kind"),
    "data_alpha": ("data", "alpha"),
    "data_shards": ("data", "shards_per_agent"),
    "data_clusters": ("data", "clusters"),
    "data_seed": ("data", "seed"),
    "data_corpus_tokens": ("data", "corpus_tokens"),
    "async_rate_dist": ("asynchrony", "rate_dist"),
    "async_rate": ("asynchrony", "rates"),
    "async_rate_sigma": ("asynchrony", "rate_sigma"),
    "async_rate_seed": ("asynchrony", "rate_seed"),
    "async_tau_max": ("asynchrony", "tau_max"),
    "async_discount": ("asynchrony", "discount"),
    "async_discount_rate": ("asynchrony", "discount_rate"),
    "privacy": ("privacy", "enabled"),
    "privacy_epsilon": ("privacy", "epsilon"),
    "privacy_delta": ("privacy", "delta"),
    "privacy_clip": ("privacy", "clip"),
    "privacy_noise": ("privacy", "noise_multiplier"),
    "privacy_secure_agg": ("privacy", "secure_agg"),
    "privacy_allow_gauss": ("privacy", "allow_gauss"),
}


#: --topology-<k> flags that merge into TopologySpec.kwargs (satellite fix:
#: spec_from_args used to forward only the kind, so hops/p/seed/rows were
#: unreachable from the launchers)
_TOPOLOGY_KWARG_FLAGS = {"topology_hops": "hops", "topology_p": "p",
                         "topology_seed": "seed", "topology_rows": "rows",
                         "topology_m": "m", "topology_rewire": "rewire"}


def _topology_kwargs(args, base: tuple = (),
                     explicit_only: bool = False) -> tuple:
    """TopologySpec.kwargs from the --topology-* flags, merged over
    ``base`` and returned as sorted (k, v) pairs."""
    kwargs = dict(base)
    explicit = getattr(args, "_explicit", set())
    for dest, name in _TOPOLOGY_KWARG_FLAGS.items():
        value = getattr(args, dest, None)
        if value is None or (explicit_only and dest not in explicit):
            continue
        kwargs[name] = value
    return tuple(sorted(kwargs.items()))


def _run_overlay(spec: ExperimentSpec, args) -> ExperimentSpec:
    """Overlay the driver fields (model + run extras) and any explicitly
    passed structural flags onto a preset spec — a flag the user typed
    wins over the preset's default, a flag left untouched does not."""
    run = dataclasses.replace(spec.run, blocks=args.blocks, batch=args.batch,
                              seq=args.seq, seed=args.seed)
    model = ModelSpec(kind="transformer", arch=args.arch, smoke=args.smoke)
    spec = spec.replace(run=run, model=model)
    explicit = getattr(args, "_explicit", set())
    for dest, (sub, field) in _PRESET_OVERRIDES.items():
        if dest in explicit:
            spec = spec.replace(**{sub: dataclasses.replace(
                getattr(spec, sub), **{field: getattr(args, dest)})})
    kwargs = _topology_kwargs(args, base=spec.topology.kwargs,
                              explicit_only=True)
    if kwargs != tuple(spec.topology.kwargs):
        spec = spec.replace(topology=dataclasses.replace(
            spec.topology, kwargs=kwargs))
    if "participation_process" in explicit:
        spec = spec.replace(participation=ParticipationSpec(
            kind=args.participation_process, q=args.participation,
            corr=args.markov_corr, num_groups=args.num_groups))
    if getattr(args, "engine", "auto") == "async":
        spec = spec.replace(asynchrony=dataclasses.replace(
            spec.asynchrony, enabled=True))
    return spec


def _check_robust_flags(args, spec: ExperimentSpec) -> ExperimentSpec:
    """--trim / --robust-scope configure the robust mixer backends only:
    explicitly passing them with a non-robust builtin kind used to be
    silently swallowed (the value was stored on the spec and ignored) —
    now it is an error.  Custom registered kinds are left alone (they may
    consume the fields)."""
    explicit = getattr(args, "_explicit", set())
    offenders = [flag for dest, flag in (("trim", "--trim"),
                                         ("robust_scope", "--robust-scope"),
                                         ("robust_gather", "--robust-gather"))
                 if dest in explicit]
    builtin_nonrobust = spec.mixer.kind in ("dense", "sparse", "pallas",
                                            "gather", "auto", "none")
    if offenders and builtin_nonrobust:
        raise ValueError(
            f"{'/'.join(offenders)} only applies to the robust mixer "
            f"backends (--mix {'|'.join(_ROBUST_MIX_KINDS)}); the "
            f"{spec.mixer.kind!r} mixer ignores it — drop the flag or "
            "pick a robust kind")
    # the same silent-swallow class on the attack sub-flags: tuning an
    # adversary that is never built would report an honest network as
    # an attacked experiment
    atk = [flag for dest, flag in (("attack_num", "--attack-num"),
                                   ("attack_scale", "--attack-scale"))
           if dest in explicit]
    if atk and spec.attack.kind == "none":
        raise ValueError(
            f"{'/'.join(atk)} configures a Byzantine adversary but the "
            'attack kind is "none" — pass --attack '
            "sign_flip|noise|shift (or a preset that selects one)")
    # ... and on the graph sub-flags: each is consumed by exactly one
    # builtin kind (custom registered kinds receive every field and are
    # exempt — spec.graph_kwargs() forwards them all)
    consumers = {"link_drop": ("--link-drop", ("link_dropout",)),
                 "graph_corr": ("--graph-corr", ("link_dropout",)),
                 "graph_p": ("--graph-p", ("tv_erdos",))}
    builtin_graphs = ("static", "link_dropout", "gossip", "tv_erdos")
    if spec.graph.kind in builtin_graphs:
        for dest, (flag, kinds) in consumers.items():
            if dest in explicit and spec.graph.kind not in kinds:
                raise ValueError(
                    f"{flag} only applies to --graph {'|'.join(kinds)}; "
                    f"the {spec.graph.kind!r} graph process ignores it — "
                    "drop the flag or pick the matching kind")
    # ... and on the async sub-flags: tuning clocks/staleness for an
    # engine that never runs event-driven would silently report a
    # bulk-synchronous run as an async experiment
    asyn = [flag for dest, flag in
            (("async_rate_dist", "--async-rate-dist"),
             ("async_rate", "--async-rate"),
             ("async_rate_sigma", "--async-rate-sigma"),
             ("async_rate_seed", "--async-rate-seed"),
             ("async_tau_max", "--async-tau-max"),
             ("async_discount", "--async-discount"),
             ("async_discount_rate", "--async-discount-rate"))
            if dest in explicit]
    if asyn and not spec.asynchrony.enabled:
        raise ValueError(
            f"{'/'.join(asyn)} configures the event-driven engine but "
            "the run is bulk-synchronous — pass --engine async (or a "
            "spec with asynchrony.enabled)")
    # ... and on the privacy sub-flags: tuning an accountant that never
    # runs would report a non-private run as an (epsilon, delta) one —
    # the worst kind of silent swallow, a false privacy claim
    priv = [flag for dest, flag in
            (("privacy_epsilon", "--privacy-epsilon"),
             ("privacy_delta", "--privacy-delta"),
             ("privacy_clip", "--privacy-clip"),
             ("privacy_noise", "--privacy-noise"),
             ("privacy_secure_agg", "--privacy-secure-agg"),
             ("privacy_allow_gauss", "--privacy-allow-gauss"))
            if dest in explicit]
    if priv and not spec.privacy.enabled:
        raise ValueError(
            f"{'/'.join(priv)} configures the differential-privacy tier "
            "but privacy is not enabled — pass --privacy (or a preset/"
            "spec with privacy.enabled)")
    # ... and on the data sub-flags: each is consumed by exactly one
    # builtin partition kind — tuning a skew dial the selected kind never
    # reads would report a heterogeneity experiment that never ran
    dcons = {"data_alpha": ("--data-alpha", ("dirichlet",)),
             "data_clusters": ("--data-clusters", ("dirichlet",)),
             "data_shards": ("--data-shards", ("shards",)),
             "data_corpus_tokens": ("--data-corpus-tokens",
                                    ("dirichlet", "shards"))}
    if spec.data.kind in ("iid", "dirichlet", "shards"):
        for dest, (flag, kinds) in dcons.items():
            if dest in explicit and spec.data.kind not in kinds:
                raise ValueError(
                    f"{flag} only applies to --data {'|'.join(kinds)}; "
                    f"the {spec.data.kind!r} data kind ignores it — drop "
                    "the flag or pick the matching kind")
    return spec


def spec_from_args(args) -> ExperimentSpec:
    """Build the ExperimentSpec from parsed shared flags.

    Precedence: ``--spec`` (verbatim) > ``--preset`` (+ driver overlay) >
    bare flags.
    """
    if getattr(args, "spec", None):
        with open(args.spec) as f:
            return ExperimentSpec.from_json(f.read())
    if getattr(args, "preset", None):
        factory = get_preset(args.preset)
        spec = factory(K=args.agents, T=args.local_steps, mu=args.step_size,
                       q=args.participation, corr=args.markov_corr,
                       num_groups=args.num_groups)
        return _check_robust_flags(args, _run_overlay(spec, args))
    return _check_robust_flags(args, ExperimentSpec(
        topology=TopologySpec(kind=args.topology,
                              kwargs=_topology_kwargs(args)),
        graph=GraphSpec(kind=args.graph, drop=args.link_drop,
                        corr=args.graph_corr, p=args.graph_p),
        participation=ParticipationSpec(
            kind=args.participation_process, q=args.participation,
            corr=args.markov_corr, num_groups=args.num_groups),
        mixer=MixerSpec(kind=args.mix, trim=args.trim,
                        scope=args.robust_scope,
                        gather=args.robust_gather),
        compression=CompressionSpec(
            kind=args.compress, ratio=args.compress_ratio,
            sigma=args.compress_sigma, error_feedback=args.error_feedback,
            gamma=args.comm_gamma,
            ef_host_offload=args.ef_host_offload),
        attack=AttackSpec(kind=args.attack, num_byzantine=args.attack_num,
                          scale=args.attack_scale),
        optimizer=OptimizerSpec(kind=args.optimizer),
        model=ModelSpec(kind="transformer", arch=args.arch,
                        smoke=args.smoke),
        privacy=PrivacySpec(
            enabled=args.privacy, epsilon=args.privacy_epsilon,
            delta=args.privacy_delta, clip=args.privacy_clip,
            noise_multiplier=args.privacy_noise,
            secure_agg=args.privacy_secure_agg,
            allow_gauss=args.privacy_allow_gauss),
        asynchrony=AsyncSpec(
            enabled=args.engine == "async", rates=args.async_rate,
            rate_dist=args.async_rate_dist,
            rate_sigma=args.async_rate_sigma,
            rate_seed=args.async_rate_seed, tau_max=args.async_tau_max,
            discount=args.async_discount,
            discount_rate=args.async_discount_rate),
        run=RunSpec(num_agents=args.agents, local_steps=args.local_steps,
                    step_size=args.step_size,
                    drift_correction=args.drift_correction,
                    blocks=args.blocks, batch=args.batch, seq=args.seq,
                    seed=args.seed,
                    local_steps_mode=args.local_steps_mode),
        data=DataSpec(kind=args.data, alpha=args.data_alpha,
                      shards_per_agent=args.data_shards,
                      seed=args.data_seed, clusters=args.data_clusters,
                      corpus_tokens=args.data_corpus_tokens)))
