"""Dry run: every (arch x input shape x mesh) step described on the
``meta`` device, with no card and no allocation.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each combination against placeholder devices and reads XLA's memory and
cost analyses and the collectives in the HLO.  The port has no compiler to
ask; it reports what the shapes and the partition rules fix exactly, for
the reference's production meshes (:func:`production_mesh`):

* ``memory.argument_size_in_bytes``: the bytes one device holds as the
  step's arguments (the agent-stacked parameters, the communication, graph
  and async state, the block and the key; or the parameters, the tokens
  and the cache), from the port's partition specs
  (:mod:`repro_torch.sharding.rules`), equal byte for byte to the sum of
  ``shard_shape`` times the itemsize over the reference's arguments;
  ``memory.argument_parts`` splits it by component;
* ``model_params_total`` / ``model_params_active``: the reference's counts
  (:meth:`repro_torch.configs.base.ModelConfig.total_params`);
* ``analytic_flops`` / ``model_flops``: the reference's roofline formulas
  (:func:`analytic_flops`);
* ``collectives``: the agent-axis all-gathers one block of the port's
  sharded engine makes on one device, as
  :attr:`repro_torch.sharding.agents.AgentShard.wire` counts them
  (:func:`agent_gathers`).  The port's mesh is (W, 1): it has no tensor
  parallelism, so no TP all-reduce is counted.

Nothing is compiled, so there is no HLO: ``--save-hlo`` raises, and XLA's
other memory fields, its cost analysis and the reference's HLO parsers
have no counterpart.  Every tensor is built on ``meta``, so the largest
arch (kimi-k2, 1.04e12 parameters) takes no memory.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --out experiments/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.api.build import train_block_struct
from repro_torch.api.cli import add_spec_args, spec_from_args
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import ArchBundle, InputShape, ModelConfig
from repro_torch.core import compression as comp_lib
from repro_torch.core import mixing
from repro_torch.core.diffusion import DiffusionConfig
from repro_torch.core.sharded import make_block_step
from repro_torch.core.state import EngineState
from repro_torch.models import transformer as tf
from repro_torch.sharding import rules
from repro_torch.sharding.rules import PartitionSpec as P
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

__all__ = ["Arg", "MeshShape", "production_mesh", "agent_count",
           "serve_window", "input_specs", "build_train_step",
           "build_prefill_step", "build_decode_step", "agent_gathers",
           "analytic_flops", "argument_bytes", "dryrun_one", "main"]

#: what ``collectives`` says of tensor parallelism
NO_TP = ("none: the port's mesh is (W, 1), with no tensor parallelism, so "
         "no TP all-reduce is counted")


# ---------------------------------------------------------------------------
# meshes and arguments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh by its axis sizes: all the partition rules read of one
    (:func:`repro_torch.sharding.rules.axis_sizes`)."""

    shape: Mapping[str, int]


def production_mesh(multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh shapes (``repro.launch.mesh``):
    16 x 16 over ("data", "model"), or 2 x 16 x 16 over ("pod", "data",
    "model"); no device and no process group."""
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16})
    return MeshShape({"data": 16, "model": 16})


def _devices(mesh) -> int:
    return math.prod(rules.axis_sizes(mesh).values())


@dataclasses.dataclass(frozen=True)
class Arg:
    """One leaf of a step's arguments: a ``meta`` tensor of its shape and
    dtype, and its partition spec."""

    meta: torch.Tensor
    spec: P

    def shard_shape(self, mesh) -> tuple:
        """The shape one device of ``mesh`` holds (``NamedSharding.
        shard_shape``); a sharded dim the axes do not divide raises."""
        sizes = rules.axis_sizes(mesh)
        shape = list(self.meta.shape)
        for d, entry in enumerate(self.spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            n = math.prod(sizes[a] for a in names if a is not None)
            if shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(self.meta.shape)} does "
                                 f"not divide {entry!r} ({n})")
            shape[d] //= n
        return tuple(shape)

    def device_bytes(self, mesh) -> int:
        return math.prod(self.shard_shape(mesh)) * self.meta.element_size()


def _arg(shape, dtype: torch.dtype, spec: P) -> Arg:
    return Arg(torch.empty(tuple(shape), dtype=dtype, device="meta"), spec)


def _args(tree) -> list:
    """The :class:`Arg` leaves of an argument tree (its dataclasses, such
    as :class:`EngineState`, taken field by field)."""
    if isinstance(tree, Arg):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [a for x in tree for a in _args(x)]
    if tree is None:
        return []
    raise TypeError(f"not an argument leaf: {type(tree).__name__}")


def argument_bytes(tree, mesh) -> int:
    """Bytes one device of ``mesh`` holds of an argument tree."""
    return sum(a.device_bytes(mesh) for a in _args(tree))


# ---------------------------------------------------------------------------
# input specs (meta tensors; zero allocation)
# ---------------------------------------------------------------------------

def agent_count(bundle: ArchBundle, multi_pod: bool) -> tuple[int, str | None]:
    pc = bundle.parallel
    if multi_pod:
        k, ax = pc.num_agents_multi, pc.agent_axis_multi
    else:
        k, ax = pc.num_agents_single, pc.agent_axis_single
    return k, (ax if k > 1 else None)


def serve_window(cfg: ModelConfig, shape: InputShape) -> int | None:
    """Attention window for serving: long context takes the sliding-window
    variant on attention archs, as in the reference."""
    if shape.name == "long_500k":
        return cfg.long_context_window if cfg.family != "ssm" else None
    return cfg.attention_window


def input_specs(arch: str, shape_name: str, *, multi_pod: bool = False,
                mesh=None, tp: bool | None = None) -> dict:
    """:class:`Arg` stand-ins for every model input of this combination.

    ``mesh`` is any object whose ``shape`` maps axis names to sizes (a
    :class:`MeshShape`, a ``jax.sharding.Mesh``); default the production
    mesh.  Train: ``{"batch", "key"}``, the key described as the
    reference's (2,) uint32 (the port's is a ``torch.Generator``).
    Prefill: ``{"tokens"[, "img_embeds"]}``.  Decode: ``{"cache",
    "tokens"}``, the cache as ``{"segments", "pos", "slot_pos"}`` with the
    whole-batch ``pos`` (the port's int 0) as the reference's () int32.
    """
    bundle = get_config(arch)
    tp = bundle.parallel.tp if tp is None else tp
    cfg = bundle.model
    shape = INPUT_SHAPES[shape_name]
    mesh = production_mesh(multi_pod) if mesh is None else mesh
    K, agent_axis = agent_count(bundle, multi_pod)

    if shape.kind == "train":
        B_a = shape.global_batch // K
        struct = train_block_struct(cfg, T=bundle.parallel.local_steps, K=K,
                                    batch=B_a, seq=shape.seq_len,
                                    img_dtype=torch.bfloat16)
        batch = {name: _arg(s, dtype, rules.batch_pspec(
            mesh, agent_axis=agent_axis, ndim=len(s), tp=tp, batch=B_a))
            for name, (s, dtype) in struct.items()}
        return {"batch": batch, "key": _arg((2,), torch.uint32, P())}

    B = shape.global_batch
    if shape.kind == "prefill":
        tok_shape = (B, shape.seq_len) + ((cfg.num_codebooks,)
                                          if cfg.num_codebooks else ())
        out = {"tokens": _arg(tok_shape, torch.int32, rules.serve_batch_pspec(
            mesh, B, len(tok_shape)))}
        if cfg.img_tokens:
            out["img_embeds"] = _arg((B, cfg.img_tokens, tf.VISION_DIM),
                                     torch.bfloat16,
                                     rules.serve_batch_pspec(mesh, B, 3))
        return out

    # decode: ONE new token against a seq_len cache
    cache = tf.cache_specs(cfg, B, shape.seq_len,
                           window=serve_window(cfg, shape))
    tree = {"segments": cache.segments,
            "pos": torch.empty((), dtype=torch.int32, device="meta"),
            "slot_pos": cache.slot_pos}
    tok_shape = (B, 1) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    return {"cache": tree_map(Arg, tree, rules.cache_pspecs(tree, mesh, B)),
            "tokens": _arg(tok_shape, torch.int32,
                           rules.serve_batch_pspec(mesh, B, len(tok_shape)))}


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def _agent_world(mesh, agent_axis: str | None, K: int) -> int:
    """Ranks the agent rows split over (1 where the rule replicates)."""
    spec = rules.agent_stack_pspec(mesh, agent_axis, num_agents=K)
    return rules.axis_sizes(mesh)[agent_axis] if spec[0] is not None else 1


def _no_gathers() -> dict:
    return {"count": 0, "bytes": 0, "by_dtype": {}}


def build_train_step(bundle: ArchBundle, shape: InputShape, mesh,
                     multi_pod: bool, mix_override: str | None = None,
                     tp: bool | None = None, compress: str | None = None,
                     compress_ratio: float = 0.1, compress_sigma: float = 0.0,
                     error_feedback: bool = False, graph: str = "static",
                     graph_kwargs: tuple = (), trim: int = 1,
                     robust_scope: str = "global",
                     robust_gather: str = "auto", asynchrony=None):
    """The train step's arguments ``(state, key, batch)`` as :class:`Arg`
    trees, the state an :class:`EngineState` as the reference's dry-run
    step holds it (no optimizer or participation state), and the agent
    gathers of one block (:func:`agent_gathers`)."""
    cfg, pc = bundle.model, bundle.parallel
    tp = pc.tp if tp is None else tp
    K, agent_axis = agent_count(bundle, multi_pod)
    topo_cfg = DiffusionConfig(
        num_agents=K, local_steps=pc.local_steps, step_size=1e-3,
        topology=pc.topology if K > 2 else "full",
        graph=graph if K > 1 else "static", graph_kwargs=graph_kwargs,
        participation=pc.participation)
    topo = topo_cfg.make_topology() if K > 1 else None
    A = topo.A if topo is not None else np.eye(1, dtype=np.float32)
    mix = mix_override or (pc.mix_path if K > 1 else "none")

    pspec = rules.add_agent_axis(
        rules.param_pspecs(tf.param_specs(cfg), mesh, fsdp=pc.fsdp, tp=tp),
        agent_axis)
    stacked = tf.param_specs(cfg, num_agents=K)
    params = tree_map(Arg, stacked, pspec)
    specs = input_specs(cfg.name, shape.name, multi_pod=multi_pod,
                        mesh=mesh, tp=tp)

    if asynchrony is not None and asynchrony.enabled:
        return _build_async_train_step(cfg, pc, topo_cfg, asynchrony, K,
                                       params, specs)

    def loss_fn(agent_params, agent_batch, rng):
        return tf.train_loss(agent_params, cfg, agent_batch, rng,
                             remat=pc.remat)

    # the mixer the card would build ("auto" takes the fused kernel there)
    mixer = mixing.make_mixer(mix, topo, A=A, num_agents=K, trim=trim,
                              scope=robust_scope, gather=robust_gather,
                              device="cuda")
    block_step = make_block_step(
        loss_fn, topo_cfg, A, mix=mixer, topology=topo, compress=compress,
        compress_ratio=compress_ratio, compress_sigma=compress_sigma,
        error_feedback=error_feedback, trim=trim, robust_scope=robust_scope,
        robust_gather=robust_gather, device="meta")

    comm = None
    if block_step.pipeline.stateful:
        # params-shaped leaves (EF residual, diff-mode reference) lie like
        # the param they mirror, in flatten order; scalars replicate
        state = block_step.pipeline.init_state(stacked)
        leaves, p_specs = tree_leaves(state), iter(tree_leaves(pspec))
        if sum(1 for x in leaves if x.ndim >= 1) != len(tree_leaves(pspec)):
            raise ValueError("comm state != params layout")
        comm = tree_unflatten(state, [Arg(x, next(p_specs) if x.ndim >= 1
                                          else P()) for x in leaves])
    state = EngineState(params, None, None, comm,
                        _graph_state(block_step.graph, K))
    gathers = agent_gathers(block_step.pipeline, tf.param_specs(cfg), K,
                            _agent_world(mesh, agent_axis, K))
    return (state, specs["key"], specs["batch"]), gathers


def _graph_state(graph, K: int):
    """A stateful graph's state (the (K, K) link mask), replicated."""
    if graph is None or not graph.stateful:
        return None
    state = graph.init_state(None, u=torch.empty((K, K), device="meta"))
    return tree_map(lambda x: Arg(x, P()), state)


def _build_async_train_step(cfg, pc, topo_cfg, asynchrony, K, params,
                            specs):
    """``--engine async``: the staleness buffer (K, D, ...) lies like the
    params it mirrors with the neighbor-slot axis replicated; the clocks
    and ages replicate.  The port's async engine is not agent-sharded, so
    a block gathers nothing."""
    from repro_torch.core.async_engine import AsyncEngine

    if K < 2:
        raise ValueError("--engine async needs a multi-agent arch (K >= 2)")

    def loss_fn(agent_params, agent_batch):
        return tf.train_loss(agent_params, cfg, agent_batch, remat=pc.remat)

    eng = AsyncEngine(topo_cfg, loss_fn, async_spec=asynchrony,
                      device="meta")
    D = int(eng._idx.shape[1])

    def buffer(a: Arg) -> Arg:
        spec = tuple(a.spec)
        return _arg((K, D) + tuple(a.meta.shape[1:]), a.meta.dtype,
                    P(spec[0] if spec else None, None, *spec[1:]))

    async_state = {"t_local": _arg((K,), torch.float32, P()),
                   "ages": _arg((K, D), torch.int32, P()),
                   "buffer": tree_map(buffer, params)}
    state = EngineState(params, None, None, None, _graph_state(eng.graph, K),
                        async_state)
    return (state, specs["key"], specs["batch"]), _no_gathers()


def _serve_params(bundle: ArchBundle, mesh):
    specs = tf.param_specs(bundle.model)
    return tree_map(Arg, specs, rules.param_pspecs(
        specs, mesh, fsdp=bundle.parallel.fsdp))


def build_prefill_step(bundle: ArchBundle, shape: InputShape, mesh,
                       multi_pod: bool):
    """``(params, tokens[, img_embeds])`` and no agent gathers."""
    cfg = bundle.model
    specs = input_specs(cfg.name, shape.name, multi_pod=multi_pod, mesh=mesh)
    args = (_serve_params(bundle, mesh), specs["tokens"])
    if cfg.img_tokens:
        args = args + (specs["img_embeds"],)
    return args, _no_gathers()


def build_decode_step(bundle: ArchBundle, shape: InputShape, mesh,
                      multi_pod: bool):
    """``(params, cache, tokens)`` and no agent gathers."""
    specs = input_specs(bundle.model.name, shape.name, multi_pod=multi_pod,
                        mesh=mesh)
    return ((_serve_params(bundle, mesh), specs["cache"], specs["tokens"]),
            _no_gathers())


# ---------------------------------------------------------------------------
# the agent axis's gathers
# ---------------------------------------------------------------------------

def _tiled(mixer: mixing.Mixer) -> bool:
    """Whether the mixer runs the column-tiled flatten on a card (float32
    tiles, each gathered whole), not a gather a leaf at a time."""
    if isinstance(mixer, mixing.PallasFusedMixer):
        return True
    if isinstance(mixer, mixing.NeighborGatherMixer):
        return mixer.fused is not False
    if isinstance(mixer, mixing.FusedNeighborhoodMixer):
        return mixer.use_kernel is not False and mixer.inner._table is not None
    return False


def agent_gathers(pipeline: mixing.CommPipeline, param_specs: PyTree,
                  num_agents: int, world: int) -> dict:
    """The all-gathers one block's combination makes on each rank when the
    K agent rows split over ``world`` ranks, counted as
    :meth:`repro_torch.sharding.agents.AgentShard.gather` counts them into
    ``AgentShard.wire``: each gather's whole (K, ...) result, in its dtype.

    ``param_specs``: one agent's parameter tree (anything with ``numel``
    and ``dtype``); the mixers run as on a card.  Returns ``{"count",
    "bytes", "by_dtype"}``; nothing is gathered where ``world`` is 1 or
    does not divide K (the rows replicate) or the mixer is the identity.
    """
    K, out = int(num_agents), _no_gathers()
    mixer = pipeline.mixer
    if world <= 1 or K % world or isinstance(mixer, mixing.NullMixer):
        return out
    if pipeline.secure_agg is not None:
        raise ValueError("the secure-agg stage's gathers are not modelled")

    def add(dtype: str, count: int, nbytes: int) -> None:
        out["count"] += count
        out["bytes"] += nbytes
        out["by_dtype"][dtype] = out["by_dtype"].get(dtype, 0) + nbytes

    leaves = [(x.numel(), str(x.dtype).removeprefix("torch."),
               x.element_size()) for x in tree_leaves(param_specs)]
    M = sum(n for n, _, _ in leaves)

    def per_leaf() -> None:
        for n, dtype, size in leaves:
            add(dtype, 1, K * n * size)

    def mix() -> None:
        if _tiled(mixer):
            add("float32", mixing.num_tiles(K, M), K * M * 4)
        else:
            per_leaf()

    base = pipeline._base()
    if pipeline.mode == "identity":
        mix()
    elif pipeline.mode == "diff":
        mix()                             # the reference copies' combination
        if pipeline.adaptive:             # the contraction's two norms
            per_leaf()
            per_leaf()
    elif (isinstance(base, comp_lib.Int8Stochastic)
          and isinstance(mixer, mixing.PallasFusedMixer)):
        # the fused int8 path: each column tile's codes and scales
        tile, width, cols = mixing.int8_layout(K, M)
        tiles = -(-width // cols)
        add("int8", tiles, K * width)
        add("float32", tiles, K * (width // tile) * 4)
    elif isinstance(base, comp_lib.Int8Stochastic):
        for n, _, _ in leaves:            # codes and (K, 1) scales a leaf
            add("int8", 1, K * n)
            add("float32", 1, K * 4)
    else:
        mix()                             # the messages, in the leaves' dtypes
    return out


# ---------------------------------------------------------------------------
# analytic flops (the reference's benchmarks/roofline.py formulas)
# ---------------------------------------------------------------------------

def analytic_flops(arch: str, shape_name: str) -> dict:
    """Global useful FLOPs per step (train: one block iteration), as the
    reference's ``benchmarks.roofline.analytic_flops`` counts them."""
    bundle = get_config(arch)
    cfg = bundle.model
    shape = INPUT_SHAPES[shape_name]
    T = bundle.parallel.local_steps
    L_attn = sum(1 for t in cfg.block_types() if t in ("attn", "moe"))
    L_mamba = sum(1 for t in cfg.block_types() if t == "mamba")
    N_active = cfg.active_params()

    H, Dh = cfg.num_heads, cfg.head_dim
    if shape.kind in ("train", "prefill"):
        c = 6 if shape.kind == "train" else 2
        tokens = shape.global_batch * shape.seq_len      # per local step
        W = min(shape.seq_len, cfg.attention_window or shape.seq_len)
        dense = c * N_active * tokens
        attn = c * L_attn * shape.global_batch * H * Dh * shape.seq_len * W
        ssm = c * L_mamba * tokens * (2 * cfg.ssm_expand * cfg.d_model) * (
            cfg.ssm_chunk + cfg.ssm_state) // max(cfg.ssm_head_dim, 1) \
            if L_mamba else 0
        steps = T if shape.kind == "train" else 1
        total = steps * (dense + attn + ssm)
        model_flops = steps * c * N_active * tokens
    else:  # decode: ONE token per sequence
        B = shape.global_batch
        if shape.name == "long_500k" and cfg.family != "ssm":
            C = min(cfg.long_context_window, shape.seq_len)
        elif cfg.attention_window:
            C = min(cfg.attention_window, shape.seq_len)
        else:
            C = shape.seq_len
        dense = 2 * N_active * B
        attn = 4 * L_attn * B * H * Dh * C
        ssm = 6 * L_mamba * B * (cfg.ssm_expand * cfg.d_model) * cfg.ssm_state
        total = dense + attn + ssm
        model_flops = 2 * N_active * B
    return {"analytic_flops": float(total), "model_flops": float(model_flops)}


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _components(kind: str, args: tuple) -> dict:
    """The step's arguments by component name."""
    if kind == "train":
        state, key, batch = args
        parts = {f.name: getattr(state, f.name)
                 for f in dataclasses.fields(state)
                 if getattr(state, f.name) is not None}
        return {**parts, "key": key, "batch": batch}
    names = (("params", "tokens", "img_embeds") if kind == "prefill"
             else ("params", "cache", "tokens"))
    return dict(zip(names, args))


def dryrun_one(arch: str, shape_name: str, mesh_kind: str,
               mix_override: str | None = None,
               save_hlo: str | None = None,
               tp: bool | None = None, compress: str | None = None,
               compress_ratio: float = 0.1, compress_sigma: float = 0.0,
               error_feedback: bool = False, graph: str = "static",
               graph_kwargs: tuple = (), trim: int = 1,
               robust_scope: str = "global",
               robust_gather: str = "auto", asynchrony=None,
               mesh=None) -> dict:
    """One combination's record, under the reference's JSON keys where
    they keep their meaning.  ``mesh`` (default: the production mesh of
    ``mesh_kind``) is any object whose ``shape`` maps axis names to
    sizes."""
    if save_hlo:
        raise ValueError("--save-hlo has no counterpart in the port: the "
                         "dry run compiles nothing, so there is no HLO")
    multi_pod = mesh_kind == "multi"
    mesh = production_mesh(multi_pod) if mesh is None else mesh
    bundle = get_config(arch)
    shape = INPUT_SHAPES[shape_name]

    t0 = time.perf_counter()
    if shape.kind == "train":
        args, gathers = build_train_step(
            bundle, shape, mesh, multi_pod, mix_override, tp=tp,
            compress=compress, compress_ratio=compress_ratio,
            compress_sigma=compress_sigma, error_feedback=error_feedback,
            graph=graph, graph_kwargs=graph_kwargs, trim=trim,
            robust_scope=robust_scope, robust_gather=robust_gather,
            asynchrony=asynchrony)
    elif shape.kind == "prefill":
        args, gathers = build_prefill_step(bundle, shape, mesh, multi_pod)
    else:
        args, gathers = build_decode_step(bundle, shape, mesh, multi_pod)
    parts = {name: argument_bytes(x, mesh)
             for name, x in _components(shape.kind, args).items()}
    t1 = time.perf_counter()

    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "mix": mix_override or "default",
        "engine": ("async" if asynchrony is not None and asynchrony.enabled
                   else "sharded"),
        "graph": graph,
        "compress": compress or "none",
        "compress_ratio": compress_ratio,
        "error_feedback": error_feedback,
        "tp": tp if tp is not None else bundle.parallel.tp,
        "devices": _devices(mesh),
        "build_seconds": round(t1 - t0, 4),
        **analytic_flops(arch, shape_name),
        "collectives": {"all-gather": gathers,
                        "total_bytes": gathers["bytes"],
                        "tensor_parallel": NO_TP},
        "memory": {"argument_size_in_bytes": sum(parts.values()),
                   "argument_parts": parts},
        "model_params_total": bundle.model.total_params(),
        "model_params_active": bundle.model.active_params(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # the spec-mapped flags are the shared set train and serve use
    # (repro_torch/api/cli.py); the dry run's own knobs stay here
    add_spec_args(ap)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--arch-default-mix", action="store_true",
                    help="use the arch bundle's production mix path instead "
                         "of the shared --mix flag")
    ap.add_argument("--no-tp", action="store_true",
                    help="replicate params over the model axis (pure DP)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--save-hlo", default=None,
                    help="the reference's HLO dump; the port compiles "
                         "nothing, so giving it raises")
    args = ap.parse_args(argv)
    if args.save_hlo is not None:
        raise ValueError("--save-hlo has no counterpart in the port: the "
                         "dry run compiles nothing, so there is no HLO")
    spec = spec_from_args(args)
    mix = None if args.arch_default_mix else spec.mixer.kind
    compress = spec.compression.kind

    os.makedirs(args.out, exist_ok=True)
    combos = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in INPUT_SHAPES:
                for mesh_kind in ("single", "multi"):
                    combos.append((arch, shape, mesh_kind))
    else:
        combos.append((spec.model.arch, args.shape, args.mesh))

    failures = 0
    for arch, shape, mesh_kind in combos:
        tag = (f"{arch}_{shape}_{mesh_kind}"
               + (f"_{mix}" if mix else "")
               + ("_async" if spec.asynchrony.enabled else "")
               + (f"_{spec.graph.kind}" if spec.graph.kind != "static"
                  else "")
               + (f"_{compress}" if compress != "none" else "")
               + ("_ef" if spec.compression.error_feedback else "")
               + ("_notp" if args.no_tp else ""))
        out_path = os.path.join(args.out, tag + ".json")
        try:
            res = dryrun_one(arch, shape, mesh_kind, mix_override=mix,
                             tp=False if args.no_tp else None,
                             compress=compress,
                             compress_ratio=spec.compression.ratio,
                             compress_sigma=spec.compression.sigma,
                             error_feedback=spec.compression.error_feedback,
                             graph=spec.graph.kind,
                             graph_kwargs=spec.graph_kwargs(),
                             trim=spec.mixer.trim,
                             robust_scope=spec.mixer.scope,
                             robust_gather=spec.mixer.gather,
                             asynchrony=spec.asynchrony)
            with open(out_path, "w") as f:
                json.dump(res, f, indent=1)
            print(f"OK   {tag}: args="
                  f"{res['memory']['argument_size_in_bytes']:.4e}B/device "
                  f"flops={res['analytic_flops']:.3e} "
                  f"coll={res['collectives']['total_bytes']:.3e}B")
        except Exception as e:  # noqa: BLE001 — report, continue the sweep
            failures += 1
            print(f"FAIL {tag}: {e}")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} dry-run combinations failed")


if __name__ == "__main__":
    main()
