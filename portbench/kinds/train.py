"""Traffic kind ``train``: Algorithm 1 through the port's sharded engine
at world 1, one block after another (a closed loop).

Set-up builds the engine with ``repro_torch.api.build(spec, loss,
engine="auto")`` (the sharded engine, the default for a transformer
spec), draws the weights on the device, and drives the engine's block
step through the first ``checked_blocks`` blocks: those blocks warm every
shape the window uses, and what they produce is what the reference
checks.  The window then runs the same step on fresh blocks for
``--seconds``; with ``--trace 1`` a few more blocks run under the
profiler.  Once the window's numbers are read and the engine is freed,
the plain reference follows the checked blocks from the same inputs.

Each block: ``engine.step(state, batch, key, active=mask)``, the kernels
on (``use_kernels=True``), the mixer the traffic names (``pallas``: the
``diffusion_mix`` kernel over the column-tiled flatten).
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from portbench import compare, counts
from portbench import trace as trace_lib
from portbench import traffic as traffic_lib
from portbench.reference import common, family as ref_family

__all__ = ["run", "readings", "launch_ranges", "launches_off"]

#: blocks the reference checks; they run in set-up and warm every shape
CHECKED_BLOCKS = 3
#: blocks run under the profiler after the window with --trace 1
TRACED_BLOCKS = 2
#: rows of the participation sequence drawn (more blocks than a run of
#: the longest window and the traced blocks reach)
MASK_ROWS = 10_000
#: the port's kernel wrappers whose launch counters are read
KERNELS = {"diffusion_mix": "repro_torch.kernels.diffusion_mix",
           "flash_attention": "repro_torch.kernels.flash_attention",
           "ssd_intra_chunk": "repro_torch.kernels.ssd_scan",
           "gather_mix": "repro_torch.kernels.gather_mix",
           "gather_robust_mix": "repro_torch.kernels.gather_robust_mix",
           "diffusion_mix_int8": "repro_torch.kernels.diffusion_mix_int8"}


def _log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _counter(name: str):
    import importlib

    return getattr(importlib.import_module(KERNELS[name]), name)


def read_launches() -> dict:
    return {name: _counter(name).launches for name in KERNELS}


def launch_ranges(model: dict, traffic: dict, masks: np.ndarray) -> dict:
    """{kernel: (least, most)} launches over the blocks whose activation
    masks are ``masks`` (blocks, K), so that the cell's path is known to
    have run without fixing how the program lays its work into launches.
    The attention or SSD kernel: at least once per layer and local step of
    a block with an active agent, at most once per layer, agent and local
    step.  ``diffusion_mix``: at least once in each block whose realized
    matrix is not the identity, with no most.  Every kernel off the
    cell's path: never."""
    K, T, L = traffic["agents"], traffic["local_steps"], model["num_layers"]
    blocks = len(masks)
    busy = sum(1 for m in masks if m.any())
    want = dict.fromkeys(KERNELS, (0, 0))
    per_step = (L * T * busy, L * K * T * blocks)
    if model.get("num_heads"):
        want["flash_attention"] = per_step
    if model.get("ssm_state"):
        want["ssd_intra_chunk"] = per_step
    if traffic["mixer"] == "pallas":
        A = common.ring_matrix(K)    # the reference's only topology
        mixed = sum(1 for m in masks if not np.array_equal(
            common.realized_matrix(A, m), np.eye(K)))
        want["diffusion_mix"] = (mixed, None)
    return want


def launches_off(launches: dict, ranges: dict) -> int:
    """How many kernels launched outside their range."""
    return sum(1 for n, (lo, hi) in ranges.items()
               if launches[n] < lo or (hi is not None and launches[n] > hi))


def _at(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _nested(flat: dict) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        keys = path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return out


def _tensor_bytes(obj, seen: set) -> int:
    if isinstance(obj, torch.Tensor):
        key = (obj.device, obj.untyped_storage().data_ptr())
        if key in seen:
            return 0
        seen.add(key)
        return obj.untyped_storage().nbytes()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_tensor_bytes(getattr(obj, f.name), seen)
                   for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(v, seen) for v in obj)
    return 0


class _Recorder:
    """The loss the engine is built with: the port's ``train_loss`` (looked
    up at each call), keeping each loss it returns while ``on``, and, for
    the first ``hook_calls`` calls, the norm of the gradient that reaches
    each of the agent's leaves."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.on = False
        self.losses: list = []
        self.hook_calls = 0
        self.grad_norms: list = []

    def __call__(self, params, batch, rng):
        from repro_torch.models import transformer as tf
        from repro_torch.tree import tree_flatten_with_path

        loss = tf.train_loss(params, self.cfg, batch, remat=False)
        if self.on:
            self.losses.append(loss.detach())
            if self.hook_calls:
                self.hook_calls -= 1
                norms: dict = {}
                self.grad_norms.append(norms)
                for path, leaf in tree_flatten_with_path(params):
                    if leaf.requires_grad:
                        leaf.register_hook(self._hook(norms, "/".join(path)))
        return loss

    @staticmethod
    def _hook(norms: dict, path: str):
        def hook(grad):
            norms[path] = torch.linalg.vector_norm(grad, dtype=torch.float32)
        return hook


def _build(cell: dict, device, recorder):
    from repro_torch.api import build
    from repro_torch.api.spec import (ExperimentSpec, MixerSpec, ModelSpec,
                                      OptimizerSpec, ParticipationSpec,
                                      RunSpec, TopologySpec)

    config, traffic = cell["config"], cell["traffic"]
    spec = ExperimentSpec(
        topology=TopologySpec(kind=traffic["topology"]),
        participation=ParticipationSpec(kind="iid",
                                        q=traffic["participation"]),
        mixer=MixerSpec(kind=traffic["mixer"]),
        optimizer=OptimizerSpec(kind=traffic["optimizer"]),
        model=ModelSpec(kind="transformer", arch=config["port_arch"],
                        smoke=False),
        run=RunSpec(num_agents=traffic["agents"],
                    local_steps=traffic["local_steps"],
                    step_size=traffic["step_size"], batch=traffic["batch"],
                    seq=traffic["seq"], blocks=1))
    eng = build(spec, recorder, engine="auto", device=device)
    if eng.engine_kind != "sharded":
        raise RuntimeError(f"engine auto built {eng.engine_kind!r}, not the "
                           "sharded engine")
    return eng


def _setup(cell: dict, seed: int, device, t_start: float) -> dict:
    """Build the engine, draw the weights and drive the checked blocks:
    the program's readings of them, its launches and its state."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels.build import load_library

    config = cell["config"]
    model = config["model"]
    cuda = device.type == "cuda"
    ref = ref_family(config["family"])
    layout = ref.layout(model)
    traffic = dict(cell["traffic"], params_per_agent=counts.param_count(
        layout))
    K = traffic["agents"]
    cfg = ModelConfig(**model, use_kernels=True)
    vocab = model["vocab_size"]

    if cuda:
        for source in config["kernels"]:
            load_library(source)
        for name in KERNELS:
            _counter(name).launches = 0
        torch.cuda.reset_peak_memory_stats(device)
    _log(f"kernels loaded at {time.perf_counter() - t_start:.2f} s")
    recorder = _Recorder(cfg)
    eng = _build(cell, device, recorder)
    key = torch.Generator().manual_seed(
        traffic_lib.derive_seed(seed, "engine") % 2 ** 62)
    params = _nested(traffic_lib.draw_weights(layout, seed, device,
                                              agents=K))
    state = eng.init_state(params, eng.optimizer.init(params), key=key)
    del params
    if cuda:
        torch.cuda.synchronize(device)
    _log(f"engine built, weights drawn at {time.perf_counter() - t_start:.2f}"
         " s")
    masks = traffic_lib.masks(traffic, MASK_ROWS)

    def block(i, st):
        batch = traffic_lib.block_batch(traffic, vocab, seed, i, device)
        return eng.step(st, batch, key, active=masks[i])

    # the checked blocks: losses of every local step, the gradient of
    # local step 0 in block 0, the parameters' change after the last
    recorder.on = True
    recorder.hook_calls = K
    for i in range(CHECKED_BLOCKS):
        state, m = block(i, state)
        _log(f"checked block {i}: local {m['local_s']:.3f} s, combination "
             f"{m['combine_s']:.3f} s")
    recorder.on = False
    _log(f"checked blocks done at {time.perf_counter() - t_start:.2f} s")
    prog = {"loss": torch.stack(recorder.losses).double().cpu().numpy()
            .reshape(CHECKED_BLOCKS, traffic["local_steps"], K),
            "grad0": {p: np.array([float(n[p]) for n in
                                   recorder.grad_norms])
                      for p in recorder.grad_norms[0]},
            "change": _change_norms(state.params, layout, seed, device)}
    recorder.losses.clear()
    return {"eng": eng, "state": state, "block": block, "prog": prog,
            "launches": read_launches() if cuda else None, "ref": ref,
            "layout": layout, "traffic": traffic, "model": model,
            "masks": masks}


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of a ``train`` cell; returns what the metric readers and
    the result line read (see :mod:`portbench.harness`)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    s = _setup(cell, seed, device, t_start)
    state, block = s.pop("state"), s["block"]
    traffic, model = s["traffic"], s["model"]
    state_bytes = _tensor_bytes(state, set())

    # the window
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    ends, local_s, combine_s = [], [], []
    i = CHECKED_BLOCKS
    while True:
        state, m = block(i, state)
        t = time.perf_counter() - t0
        i += 1
        ends.append(t)
        local_s.append(m["local_s"])
        combine_s.append(m["combine_s"])
        if t >= seconds:
            break
    whole = max(1, sum(1 for t in ends if t <= seconds))
    window = {"blocks": whole, "seconds": ends[whole - 1],
              "blocks_run": len(ends),
              "tokens_per_s": whole * traffic_lib.tokens_per_block(traffic)
              / ends[whole - 1],
              "local_s": float(np.mean(local_s[:whole])),
              "combine_s": float(np.mean(combine_s[:whole])),
              "block_s": [ends[0]] + [b - a for a, b in zip(ends, ends[1:])]}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    _log(f"window: {whole} whole blocks of {len(ends)} in "
         f"{window['seconds']:.3f} s, {window['tokens_per_s']:.1f} "
         f"tokens/s; set-up {setup_s:.2f} s; peak {peak / 2**30:.2f} GiB; "
         f"blocks {' '.join(f'{b:.3f}' for b in window['block_s'])}")

    traced = None
    if trace:
        traced = trace_lib.profile_blocks(
            lambda j, st: block(i + j, st), state, TRACED_BLOCKS, device)
        state = traced.pop("state")
        _log(f"traced {TRACED_BLOCKS} blocks in {traced['window_s']:.3f} "
             f"s, busy {traced['busy_s']:.3f} s; one block with the host's "
             f"operations {traced['host_traced_block_s']:.3f} s; read in "
             f"{traced['read_s']:.1f} s")

    # the program's state is freed before the reference runs
    del state, m, block, s["eng"], s["block"]
    _free(device)
    t_ref = time.perf_counter()
    reading = _reference(s["ref"], model, traffic, seed, s["layout"],
                         s["masks"], device)
    _log(f"reference followed {CHECKED_BLOCKS} blocks in "
         f"{time.perf_counter() - t_ref:.2f} s")
    checks = compare.compare(s["prog"], reading, cell["limits"])
    if cuda:
        checks["launches_off"] = {
            "value": float(launches_off(s["launches"], launch_ranges(
                model, traffic, s["masks"][:CHECKED_BLOCKS]))),
            "limit": cell["limits"]["launches_off"]}
    return {"traffic": traffic, "model": model, "device": device.type,
            "setup_s": setup_s, "window": window, "peak_bytes": peak,
            "state_bytes": state_bytes, "trace": traced,
            "block_flops": counts.block_flops(model, traffic),
            "checks": checks, "attempted": window["blocks"]}


def readings(cell: dict, seed: int, device, *, controls: bool = False
             ) -> dict:
    """The numbers :func:`run` compares, on ``seed``, without a window:
    ``{"program": {name: value}}`` and, with ``controls``, the same
    numbers of the control (the reference in fp8) and of the faults
    planted in the reference (``half_batch``, ``no_exchange``), each
    against the clean reference."""
    device = torch.device(device)
    s = _setup(cell, seed, device, time.perf_counter())
    del s["state"], s["eng"], s["block"]
    _free(device)
    args = (s["ref"], s["model"], s["traffic"], seed, s["layout"],
            s["masks"], device)
    clean = _reference(*args)
    limits = dict.fromkeys(("loss_gap", "grad_gap", "change_gap"), 0.0)

    def numbers(prog):
        return {n: c["value"] for n, c in
                compare.compare(prog, clean, limits).items()}

    out = {"program": numbers(s["prog"])}
    if controls:
        out["control_fp8"] = numbers(_reference(*args, precision="fp8"))
        for fault in ("half_batch", "no_exchange"):
            out[fault] = numbers(_reference(*args, fault=fault))
    return out


def _change_norms(params, layout, seed: int, device) -> dict:
    """{path: (K,) norms of each agent's change from the drawn weights},
    one layer of a stacked leaf at a time."""
    out = {}
    for path, shape, dtype, init in layout:
        w0 = traffic_lib.draw_leaf(seed, path, shape, dtype, init, device)
        leaf = _at(params, path)
        sq = torch.zeros(leaf.shape[0], dtype=torch.float64, device=device)
        slices = range(shape[0]) if path.startswith("segments/") else [None]
        for j in slices:
            a = leaf if j is None else leaf[:, j]
            b = w0 if j is None else w0[j]
            sq += torch.stack([torch.linalg.vector_norm(
                a[k].float() - b.float(), dtype=torch.float64) ** 2
                for k in range(leaf.shape[0])])
        out[path] = sq.sqrt().cpu().numpy()
        del w0
    return out


def _reference(ref, model, traffic, seed, layout, masks, device,
               precision: str = "stated", fault: str | None = None) -> dict:
    """The plain reference over the checked blocks from the same inputs:
    {"loss", "grad0", "change"} as the program's readings."""
    common.set_exact_float32()
    weights = traffic_lib.draw_weights(layout, seed, device)
    blocks = [traffic_lib.block_batch(traffic, model["vocab_size"], seed, i,
                                      device)
              for i in range(CHECKED_BLOCKS)]
    out = common.run_blocks(
        ref, model, weights, traffic["agents"], blocks,
        masks[:CHECKED_BLOCKS], topology=traffic["topology"],
        step_size=traffic["step_size"], local_steps=traffic["local_steps"],
        precision=common.Precision(precision), device=device, fault=fault)
    change = {}
    for p, w0 in weights.items():
        W = out["weights"][p]
        change[p] = np.array([torch.linalg.vector_norm(
            W[k].float() - w0.float(), dtype=torch.float64).item()
            for k in range(W.shape[0])])
    return {"loss": out["loss"], "grad0": out["grad0"], "change": change}
