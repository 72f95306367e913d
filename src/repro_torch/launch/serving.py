"""Continuous-batching consensus server: request queue, slot-based
batching, and watch-mode checkpoint swaps.

Counterpart of ``repro.launch.serving``.  :class:`ServeLoop` serves
requests of different prompt lengths from one per-slot decode cache
(``transformer.init_cache(..., per_slot=True)``: each batch row is an
independent request at its own position).  A new request is admitted the
moment a slot frees (a batch-1 prefill written into the slot, no global
barrier), and decode runs in ``chunk``-token ticks through
:func:`repro_torch.models.transformer.decode_loop` (``"fused"``: sampling
inside the loop, tokens kept on the device for the chunk) or the
per-token loop written out here (``"py"``, token-parity with fused at
temperature 0).  Greedy decoding (``temperature <= 0``) needs no
generator in either.

Watch mode (:meth:`ServeLoop.watch`) re-extracts the consensus as
training checkpoints stream into a directory and publishes each through
the double-buffered :class:`repro_torch.core.serving.ParamStore`: an
in-flight decode never sees a torn update, and every emitted token is
tagged with the generation of the parameters that produced its logits
(:attr:`Completion.generations`).  :func:`replay_completion` replays a
greedy completion under its recorded schedule and fails on any token that
did not come from exactly one generation.

The decode cache is updated in place (the port's ``decode_step``); the
parameters are never written, so a snapshot taken for a tick keeps its
checkpoint.  A request carries tokens only: an image-prefix config is
served text-only here, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.serving import ParamStore, consensus_from_stacked
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves

__all__ = ["Request", "Completion", "ServeLoop", "load_consensus",
           "spec_consensus", "replay_completion"]


@dataclass(frozen=True)
class Request:
    uid: int
    prompt: np.ndarray            # (P,) int32, or (P, nq) multi-codebook
    max_new_tokens: int


@dataclass(frozen=True)
class Completion:
    uid: int
    prompt: np.ndarray
    tokens: list                  # per-token int, or per-token [nq] list
    generations: list = field(default_factory=list)
    # generations[i] = ParamStore generation of the params that produced
    # the logits tokens[i] was sampled from (exactly one per token — the
    # double-buffer contract replay_completion verifies)


def _write_slot(big: tf.Cache, small: tf.Cache, slot: int) -> None:
    """Write a batch-1 prefill cache into row ``slot`` of a per-slot cache,
    in place.  Every segment leaf has the batch at axis 1 (KV rings and
    SSM states alike), so one pass over the leaves covers every block
    type; ``pos``/``slot_pos`` move from the whole-batch layout (an int,
    (C,)) into the slot's row."""
    for b, s in zip(tree_leaves(list(big.segments)),
                    tree_leaves(list(small.segments))):
        b[:, slot] = s[:, 0]
    big.pos[slot] = small.pos
    big.slot_pos[slot] = small.slot_pos


class ServeLoop:
    """Slot-batched continuous decode over a double-buffered param store.

    One tick (:meth:`step`) = snapshot the params -> admit queued requests
    into free slots (a batch-1 prefill each) -> decode ``chunk`` tokens
    for the whole batch -> emit tokens (tagged with their generation) and
    retire finished slots.  Free slots decode junk that is discarded:
    admission overwrites the slot's row wholesale, so a retired slot needs
    no reset.

    ``decode_loop="py"`` swaps the fused chunk for the per-token loop
    (same tick structure, same tagging).  The cache and the carried
    logits (float32) live on the device of ``params``; ``seed`` seeds the
    sampling generator there (unused when greedy).
    """

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 128,
                 decode_loop: str = "fused", temperature: float = 0.0,
                 chunk: int = 4, seed: int = 0):
        if decode_loop not in ("fused", "py"):
            raise ValueError(f"decode_loop={decode_loop!r} not in "
                             "('fused', 'py')")
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.decode_loop = decode_loop
        self.temperature = temperature
        self.chunk = chunk
        self.store = ParamStore(params)
        self.device = tree_leaves(params)[0].device
        self._greedy = temperature <= 0
        self._key = (None if self._greedy else
                     torch.Generator(device=self.device).manual_seed(seed))
        self._queue: deque[Request] = deque()
        self._requests: list[Request | None] = [None] * slots
        self._emitted: list[list] = [[] for _ in range(slots)]
        self._gens: list[list] = [[] for _ in range(slots)]
        self._lg_gen = [0] * slots
        self._ticks = 0
        self._cache = tf.init_cache(cfg, slots, max_len, per_slot=True,
                                    device=self.device)
        lg_shape = ((slots, cfg.num_codebooks, cfg.vocab_size)
                    if cfg.num_codebooks else (slots, cfg.vocab_size))
        self._logits = torch.zeros(lg_shape, dtype=torch.float32,
                                   device=self.device)

    @property
    def active(self) -> int:
        return sum(r is not None for r in self._requests)

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds the "
                f"serve cache budget max_len={self.max_len}")
        self._queue.append(req)

    def ingest_checkpoint(self, path, *, quantize: str | None = None) -> int:
        """Extract the consensus of a training checkpoint and publish it as
        the next param generation.  Returns the new generation."""
        params, _cfg, _meta = load_consensus(path, quantize=quantize,
                                             device=self.device)
        return self.store.swap(params)

    def _admit(self, params, gen: int) -> None:
        for s in range(self.slots):
            if self._requests[s] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            prompt = torch.as_tensor(np.asarray(req.prompt),
                                     device=self.device)[None]
            lg, small = tf.prefill(params, self.cfg, prompt,
                                   max_len=self.max_len)
            _write_slot(self._cache, small, s)
            self._logits[s] = lg[0, -1].float()
            self._requests[s] = req
            self._emitted[s] = []
            self._gens[s] = []
            self._lg_gen[s] = gen

    def step(self) -> list[Completion]:
        """One serving tick; returns the completions retired this tick."""
        params, gen = self.store.snapshot()
        with torch.no_grad():
            self._admit(params, gen)
            if self.active == 0:
                return []
            if self.decode_loop == "fused":
                toks, lg, _ = tf.decode_loop(
                    params, self.cfg, self._cache, self._logits, self._key,
                    self.chunk, temperature=self.temperature)
            else:
                toks, lg = self._py_chunk(params, self._logits)
            self._logits = lg.float()
            toks = toks.cpu().numpy()              # (slots, chunk[, nq])
        done = []
        for s, req in enumerate(self._requests):
            if req is None:
                continue
            # the first token of the tick was sampled from logits carried
            # in from the previous tick's params (or the admission
            # prefill); the rest were produced under this tick's snapshot
            gens = [self._lg_gen[s]] + [gen] * (self.chunk - 1)
            take = min(self.chunk,
                       req.max_new_tokens - len(self._emitted[s]))
            self._emitted[s].extend(toks[s, :take].tolist())
            self._gens[s].extend(gens[:take])
            self._lg_gen[s] = gen
            if len(self._emitted[s]) >= req.max_new_tokens:
                done.append(Completion(req.uid, req.prompt, self._emitted[s],
                                       self._gens[s]))
                self._requests[s] = None
        self._ticks += 1
        return done

    def run(self, *, max_ticks: int = 100_000) -> list[Completion]:
        """Drain the queue: tick until every request has completed."""
        out = []
        for _ in range(max_ticks):
            if not self._queue and self.active == 0:
                return out
            out.extend(self.step())
        raise RuntimeError(f"serve loop did not drain in {max_ticks} ticks")

    def watch(self, ckpt_dir, *, poll_s: float = 0.5,
              max_ticks: int | None = None,
              quantize: str | None = None) -> list[Completion]:
        """Serve while re-extracting the consensus from checkpoints
        streaming into ``ckpt_dir``.

        Each poll picks up ``*.npz`` files that are new or rewritten (name
        and mtime) and publishes their consensus via
        :meth:`ingest_checkpoint`; decode ticks run between polls.  Writers
        should write, then rename, so that a poll never reads a
        half-written archive.  Runs ``max_ticks`` ticks (forever when
        ``None``, the CLI's default); returns the completions retired
        while watching.
        """
        seen: dict[str, int] = {}
        out = []
        ticks = 0
        while max_ticks is None or ticks < max_ticks:
            for p in sorted(Path(ckpt_dir).glob("*.npz")):
                stamp = p.stat().st_mtime_ns
                if seen.get(p.name) != stamp:
                    seen[p.name] = stamp
                    gen = self.ingest_checkpoint(p, quantize=quantize)
                    print(f"[watch] {p.name} -> generation {gen}")
            if self._queue or self.active:
                out.extend(self.step())
            else:
                time.sleep(poll_s)
            ticks += 1
        return out

    def _py_chunk(self, params, logits):
        """The per-token loop over one chunk (``decode_loop="py"``): the
        same params snapshot for the whole tick, so the generation tagging
        of :meth:`step` holds in both modes."""
        toks = []
        for _ in range(self.chunk):
            nxt = tf.sample_logits(logits, self._key, self.temperature)
            lg, _ = tf.decode_step(params, self.cfg, self._cache,
                                   nxt[:, None])
            logits = lg[:, 0].float()
            toks.append(nxt)
        return torch.stack(toks, dim=1), logits


def spec_consensus(path, spec, *, quantize: str | None = None, device=None,
                   timings: dict | None = None, report: bool = False,
                   num_layers: int | None = None):
    """(consensus params, model cfg, meta, freshness weights or None) of a
    spec-embedding checkpoint whose spec is ``spec``: the engine rebuilt
    from it, the iterate restored onto ``device``, the agent clocks too
    for an async run (the consensus then weighted by the engine's
    age-discount law, ``discount(max t_local - t_local)``), and the
    consensus extracted through the trained mixer over the training
    topology (the base topology of a time-varying graph).  ``timings``
    receives ``load_s`` and ``consensus_s``; ``report`` prints the serve
    driver's lines (the async clocks, the privacy guarantee, the mixer);
    ``num_layers`` cuts the config's depth (a checkpoint trained at a cut
    depth)."""
    from repro_torch.api import EngineState, TOPOLOGIES, build
    from repro_torch.checkpoint.store import load_experiment

    timings = {} if timings is None else timings
    eng = build(spec, device=device)
    K = spec.run.num_agents
    cfg = eng.model.cfg
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    # meta tensors: the template gives shapes only, no K random models
    like = EngineState(tf.param_specs(cfg, num_agents=K))
    if spec.asynchrony.enabled:
        like = like.replace(async_state={"t_local": torch.empty(
            (K,), dtype=torch.float32, device="meta")})
    t0 = time.perf_counter()
    state, meta = load_experiment(str(path), like, device=device)
    _sync(device)
    timings["load_s"] = time.perf_counter() - t0
    weights = None
    if spec.asynchrony.enabled:
        t_local = state.async_state["t_local"]
        age = t_local.max() - t_local
        weights = eng._discount(age)
        if report:
            a = spec.asynchrony
            print(f"async checkpoint: freshness-weighted consensus "
                  f"(discount={a.discount}({a.discount_rate}); agent clock "
                  f"ages max={float(age.max()):.1f})")
    if report and meta.get("epsilon_spent") is not None:
        print(f"privacy: checkpoint trained under "
              f"(epsilon={float(meta['epsilon_spent']):.3f}, "
              f"delta={meta.get('privacy_delta', spec.privacy.delta):g})"
              "-DP (RDP accountant at the realized participation rate)")
    topo = (TOPOLOGIES.get(spec.topology.kind)(spec.topology, K)
            if K > 1 else None)
    if report:
        print(f"loaded spec checkpoint (K={K}, arch={spec.model.arch}, "
              f"step={meta.get('step')}); extracting consensus via "
              f"mix={spec.mixer.kind} over topology={spec.topology.kind}")
    t0 = time.perf_counter()
    params = consensus_from_stacked(
        state.params, K, spec.mixer.kind, trim=spec.mixer.trim,
        scope=spec.mixer.scope, topology=topo, quantize=quantize,
        weights=weights)
    _sync(device)
    timings["consensus_s"] = time.perf_counter() - t0
    return params, cfg, meta, weights


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def load_consensus(path, *, quantize: str | None = None, device=None):
    """(consensus params, model cfg, meta) of a spec-embedding training
    checkpoint, on ``device`` (``None`` means CUDA): the watch-mode ingest
    path.  The checkpoint's own ``ExperimentSpec`` decides the agent
    count, architecture, mixer and topology; ``quantize="int8"`` collapses
    from int8-quantized leaves."""
    from repro_torch.checkpoint.store import load_spec
    from repro_torch.device import resolve_device

    path = str(path)
    spec = load_spec(path)
    if spec is None:
        raise ValueError(
            f"{path}: not a spec-embedding checkpoint; watch-mode ingest "
            "needs checkpoints written by repro_torch.launch.train (use "
            "launch/serve.py --agents/--mix for legacy stacked archives)")
    if spec.model.kind == "external":
        raise ValueError(f"{path}: checkpoint spec has model kind "
                         "'external' — nothing servable")
    params, cfg, meta, _ = spec_consensus(path, spec, quantize=quantize,
                                          device=resolve_device(device))
    return params, cfg, meta


def replay_completion(cfg, params_by_gen, completion: Completion, *,
                      max_len: int, slots: int = 1) -> int:
    """Replay a greedy completion against its recorded generation schedule.

    Re-runs prefill and per-token greedy decode, switching to
    ``params_by_gen[g]`` exactly where ``completion.generations`` says a
    new generation took over, and asserts that every token equals the
    replay's.  A torn param update (a token computed from a mix of two
    checkpoints) matches no single-generation schedule, so this is the
    no-torn-update gate.  Returns the number of distinct generations the
    completion spanned.

    ``slots=1`` (the reference's) decodes the request alone.  ``slots=S``
    decodes it as the loop did: its batch-1 prefill written into every
    row of an S-row per-slot cache, each step's token fed to every row.
    The products then have the loop's shapes, and a product's rows do not
    depend on each other's values, so in bf16 the replay rounds as the
    loop's row did (alone, a batch-1 product may round otherwise).
    """
    gens, toks = completion.generations, completion.tokens
    assert len(gens) == len(toks) > 0
    device = tree_leaves(params_by_gen[gens[0]])[0].device
    prompt = torch.as_tensor(np.asarray(completion.prompt),
                             device=device)[None]
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    with torch.no_grad():
        lg, cache = tf.prefill(params_by_gen[gens[0]], cfg, prompt,
                               max_len=max_len)
        if slots > 1:
            small = cache
            cache = tf.init_cache(cfg, slots, max_len, per_slot=True,
                                  device=device)
            for s in range(slots):
                _write_slot(cache, small, s)
            del small
        logits = lg[:, -1]
        for i, (t, g) in enumerate(zip(toks, gens)):
            want = tf.sample_logits(logits, None, 0.0)[0].cpu().numpy()
            assert np.array_equal(want, np.asarray(t, want.dtype)), (
                f"uid {completion.uid} token {i}: emitted {t} but "
                f"generation {g} params produce {want.tolist()} — torn or "
                "mis-tagged param update")
            if i + 1 == len(toks):
                break
            tok = torch.as_tensor(np.asarray(t, np.int32),
                                  device=device).reshape((1, 1) + cb)
            # the logits for token i+1 were produced under gens[i+1]
            lg, cache = tf.decode_step(params_by_gen[gens[i + 1]], cfg,
                                       cache,
                                       tok.expand((slots, 1) + cb))
            logits = lg[:1, 0]
    return len(set(gens))
