"""Decoder assembly for serving: parameters, ring-buffer cache, prefill and
decode.

Counterpart of ``repro.models.transformer`` for the serving slice.  Layers
are grouped into *segments* (runs of one block type) whose per-layer
parameters are stacked on a leading axis, under the reference's segment keys
(``"00.attn.032"``), and segments run in sorted key order.  This slice runs
``attn`` segments; ``mamba``, ``moe`` and ``shared_attn`` segments, the
image prefix and multi-codebook embeddings raise ``NotImplementedError``
(ROADMAP.md queue 1 item 17), and ``forward``/``train_loss`` come with the
training slice (item 15).

The cache is the reference's whole-batch ring buffer: position p lives in
slot p % C, ``slot_pos`` records the absolute position held by each slot
(-1 = empty), and decode masks by validity and the sliding window.  Unlike
the JAX version, :func:`decode_step` writes the new K/V into the cache
tensors in place (one slot per layer instead of a copy of the cache) and
returns the same :class:`Cache`; ``pos`` is a Python int.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

PyTree = Any

__all__ = ["init_params", "param_specs", "Cache", "init_cache", "prefill",
           "decode_step", "sample_logits", "decode_loop"]


def _seg_key(index: int, kind: str, n: int) -> str:
    return f"{index:02d}.{kind}.{n:03d}"


def _seg_items(segments: dict):
    """Yield (kind, n, seg_params) in layer order."""
    for key in sorted(segments):
        _, kind, n = key.split(".")
        yield kind, int(n), segments[key]


def _adims(cfg: ModelConfig) -> L.AttnDims:
    return L.AttnDims(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)


def _check_supported(cfg: ModelConfig) -> None:
    kinds = {kind for kind, _ in cfg.segments()}
    if kinds != {"attn"} or cfg.shared_attention:
        raise NotImplementedError(
            f"{cfg.name}: block types {sorted(kinds)} (shared attention "
            f"{cfg.shared_attention}) are not ported yet — this slice runs "
            "attention segments only; see ROADMAP.md queue 1 item 17")
    if cfg.num_codebooks or cfg.img_tokens:
        raise NotImplementedError(
            f"{cfg.name}: multi-codebook / image-prefix embeddings are not "
            "ported yet; see ROADMAP.md queue 1 item 17")


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def _block_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    return {"ln1": L.init_rms_norm(cfg.d_model, dtype, gen.device),
            "attn": L.init_attention(gen, cfg.d_model, _adims(cfg),
                                     cfg.qk_norm, dtype),
            "ln2": L.init_rms_norm(cfg.d_model, dtype, gen.device),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype)}


def _stack(trees: list) -> dict:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees, dim=0)


def init_params(key: torch.Generator, cfg: ModelConfig) -> PyTree:
    """Random parameters drawn from ``key``, on the generator's device.

    The shapes and distributions are the reference's; the values are not
    (torch cannot replay JAX's random streams — carry reference weights
    across with :func:`repro_torch.models.convert.params_from_jax`).
    """
    _check_supported(cfg)
    dtype = cfg.param_dtype
    p: dict = {"embed": L._normal(key, (cfg.vocab_size, cfg.d_model), 0.02,
                                  dtype)}
    segs = {}
    for si, (kind, n) in enumerate(cfg.segments()):
        segs[_seg_key(si, kind, n)] = _stack(
            [_block_init(key, cfg, dtype) for _ in range(n)])
    p["segments"] = segs
    p["final_norm"] = L.init_rms_norm(cfg.d_model, dtype, key.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = L._normal(key, (cfg.d_model, cfg.vocab_size),
                                 1.0 / np.sqrt(cfg.d_model), dtype)
    return p


def param_specs(cfg: ModelConfig, *, num_agents: int | None = None) -> PyTree:
    """Tree of ``meta``-device tensors matching :func:`init_params` — shapes
    and dtypes with zero allocation (a template for
    :func:`repro_torch.checkpoint.load_checkpoint`).  ``num_agents`` adds a
    leading agent axis."""
    _check_supported(cfg)
    lead = () if num_agents is None else (num_agents,)

    def spec(*shape):
        return torch.empty(lead + shape, dtype=cfg.param_dtype, device="meta")

    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, Kv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p: dict = {"embed": spec(V, D)}
    segs = {}
    for si, (kind, n) in enumerate(cfg.segments()):
        attn = {"wq": spec(n, D, H * Dh), "wk": spec(n, D, Kv * Dh),
                "wv": spec(n, D, Kv * Dh), "wo": spec(n, H * Dh, D)}
        if cfg.qk_norm:
            attn["q_norm"] = {"scale": spec(n, Dh)}
            attn["k_norm"] = {"scale": spec(n, Dh)}
        mlp = ({"w_gate": spec(n, D, F), "w_up": spec(n, D, F),
                "w_down": spec(n, F, D)} if cfg.mlp_act == "silu"
               else {"w_up": spec(n, D, F), "w_down": spec(n, F, D)})
        segs[_seg_key(si, kind, n)] = {
            "ln1": {"scale": spec(n, D)}, "attn": attn,
            "ln2": {"scale": spec(n, D)}, "mlp": mlp}
    p["segments"] = segs
    p["final_norm"] = {"scale": spec(D)}
    if not cfg.tie_embeddings:
        p["lm_head"] = spec(D, V)
    return p


def _layer(seg_params: dict, j: int) -> dict:
    """Layer ``j`` of a stacked segment (views, no copy)."""
    return {k: _layer(v, j) if isinstance(v, dict) else v[j]
            for k, v in seg_params.items()}


def _embed_inputs(params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]               # (B, S, D)


def _lm_logits(params: PyTree, cfg: ModelConfig,
               x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


# ---------------------------------------------------------------------------
# serving: cache + prefill + decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cache:
    """Decode cache.  ``segments`` mirrors ``params['segments']`` order; each
    entry holds ``k``/``v`` of shape (n, B, C, Kv, Dh).  ``pos`` is the next
    write position (whole batch), ``slot_pos`` (C,) int32 the absolute
    position stored in each ring slot."""
    segments: tuple
    pos: int
    slot_pos: torch.Tensor


def _cache_len(cfg: ModelConfig, max_seq: int, window: int | None) -> int:
    w = window if window is not None else cfg.attention_window
    return min(max_seq, w) if w else max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               window: int | None = None, device=None) -> Cache:
    _check_supported(cfg)
    dev = resolve_device(device)
    C = _cache_len(cfg, max_seq, window)
    Kv, Dh = cfg.num_kv_heads, cfg.head_dim
    segs = tuple(
        {"k": torch.zeros((n, batch, C, Kv, Dh), dtype=cfg.param_dtype,
                          device=dev),
         "v": torch.zeros((n, batch, C, Kv, Dh), dtype=cfg.param_dtype,
                          device=dev)}
        for _, n in cfg.segments())
    return Cache(segments=segs, pos=0,
                 slot_pos=torch.full((C,), -1, dtype=torch.int32, device=dev))


def _attn_block_decode(cfg: ModelConfig, bp: dict, x: torch.Tensor,
                       kc: torch.Tensor, vc: torch.Tensor,
                       positions: torch.Tensor, slot: int,
                       valid: torch.Tensor) -> torch.Tensor:
    """One attention block for a single new token; writes its K/V into ring
    slot ``slot`` of ``kc``/``vc`` in place and attends over ``valid``."""
    B = x.shape[0]
    h = L.rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
    q, k, v = L.qkv_project(bp["attn"], h, _adims(cfg), positions=positions,
                            rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta,
                            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps)
    kc[:, slot] = k[:, 0]
    vc[:, slot] = v[:, 0]
    o = L.decode_attention_jnp(q, kc, vc, valid)
    x = x + o.reshape(B, 1, -1) @ bp["attn"]["wo"]
    h = L.rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps)
    return x + L.mlp_forward(bp["mlp"], h, cfg.mlp_act)


def decode_step(params: PyTree, cfg: ModelConfig, cache: Cache,
                tokens: torch.Tensor, *, window: int | None = None):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache).

    The cache is updated in place and returned.  Every layer shares the
    ring geometry, so the slot and the validity mask (written, not past
    ``pos``, inside the window) are computed once per step.
    """
    window = window if window is not None else cfg.attention_window
    x = _embed_inputs(params, tokens)
    pos = cache.pos
    slot = pos % cache.slot_pos.shape[0]
    cache.slot_pos[slot] = pos
    valid = (cache.slot_pos >= 0) & (cache.slot_pos <= pos)
    if window:
        valid = valid & (cache.slot_pos > pos - window)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    for (_, n, seg_params), seg_cache in zip(_seg_items(params["segments"]),
                                             cache.segments):
        for j in range(n):
            x = _attn_block_decode(cfg, _layer(seg_params, j), x,
                                   seg_cache["k"][j], seg_cache["v"][j],
                                   positions, slot, valid)
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    cache.pos = pos + 1
    return _lm_logits(params, cfg, x), cache


def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, *,
            window: int | None = None, max_len: int | None = None,
            q_chunk: int = 512, kv_chunk: int = 512):
    """Process a prompt, returning (logits, cache) for subsequent decode.

    A full forward that also captures per-layer K/V into a ring-buffer
    cache sized for ``max_len`` total positions (default: prompt length).
    """
    _check_supported(cfg)
    window = window if window is not None else cfg.attention_window
    x = _embed_inputs(params, tokens)
    B, S = x.shape[:2]
    dev = x.device
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    C = _cache_len(cfg, max(max_len or S, S), window)

    new_segs = []
    for _, n, seg_params in _seg_items(params["segments"]):
        kcs = torch.empty((n, B, C, cfg.num_kv_heads, cfg.head_dim),
                          dtype=x.dtype, device=dev)
        vcs = torch.empty_like(kcs)
        for j in range(n):
            x, (kcs[j], vcs[j]) = _attn_block_prefill(
                cfg, _layer(seg_params, j), x, positions, window, q_chunk,
                kv_chunk, C)
        new_segs.append({"k": kcs, "v": vcs})

    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = _lm_logits(params, cfg, x)
    return logits, Cache(segments=tuple(new_segs), pos=S,
                         slot_pos=_prefill_slot_positions(S, C, dev))


def _prefill_slot_positions(S: int, C: int, device=None) -> torch.Tensor:
    """Absolute position stored in each ring slot after prefilling S tokens."""
    j = torch.arange(C, dtype=torch.int32, device=device)
    if C >= S:
        return torch.where(j < S, j, -1).to(torch.int32)
    # slot j holds the largest p < S with p % C == j
    last = S - 1
    return (last - torch.remainder(last - j, C)).to(torch.int32)


def _attn_block_prefill(cfg: ModelConfig, bp: dict, x: torch.Tensor,
                        positions: torch.Tensor, window: int | None,
                        q_chunk: int, kv_chunk: int, C: int):
    B, S = x.shape[:2]
    h = L.rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
    q, k, v = L.qkv_project(bp["attn"], h, _adims(cfg), positions=positions,
                            rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta,
                            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps)
    o = L.flash_attention_jnp(q, k, v, causal=True, window=window,
                              q_chunk=q_chunk, kv_chunk=kv_chunk)
    x = x + o.reshape(B, S, -1) @ bp["attn"]["wo"]
    h = L.rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps)
    x = x + L.mlp_forward(bp["mlp"], h, cfg.mlp_act)
    # ring-buffer the last C positions
    if C >= S:
        pad = (0, 0, 0, 0, 0, C - S)
        kc = torch.nn.functional.pad(k, pad)
        vc = torch.nn.functional.pad(v, pad)
    else:
        kc = _ring_scatter(k, C)
        vc = _ring_scatter(v, C)
    return x, (kc, vc)


def _ring_scatter(k: torch.Tensor, C: int) -> torch.Tensor:
    """Scatter a (B, S, ...) sequence into its (B, C, ...) ring buffer."""
    S = k.shape[1]
    tail = k[:, S - C:]                        # last C tokens, positions S-C..S-1
    return torch.roll(tail, shifts=(S - C) % C, dims=1)


# ---------------------------------------------------------------------------
# serving: decode loop
# ---------------------------------------------------------------------------

def sample_logits(logits: torch.Tensor, key: torch.Generator | None,
                  temperature: float) -> torch.Tensor:
    """Next-token sampling from last-position logits (in float32).

    ``temperature <= 0`` is greedy argmax and consumes no generator (``key``
    may be ``None``); otherwise a categorical draw at the given temperature
    from ``key`` (its stream is not JAX's).

    logits: (B, V) -> (B,) int32.
    """
    lg = logits.float()
    if temperature <= 0:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    probs = torch.softmax(lg / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=key)[:, 0].to(torch.int32)


def decode_loop(params: PyTree, cfg: ModelConfig, cache: Cache,
                first_logits: torch.Tensor, key: torch.Generator | None,
                n: int, *, temperature: float = 0.0,
                window: int | None = None):
    """n-token generation with sampling inside the loop: tokens stay on the
    device, with no host sync per token.

    Args:
      first_logits: the last-position logits from :func:`prefill` (B, V).
      key: generator for sampled decoding; unused at ``temperature <= 0``.
      n: number of tokens to generate.

    Returns ``(tokens, last_logits, cache)`` with ``tokens`` int32 (B, n)
    and ``last_logits`` the logits the (n+1)-th token would be sampled from.
    """
    lg = first_logits
    toks = []
    for _ in range(n):
        nxt = sample_logits(lg, key, temperature)
        toks.append(nxt)
        new_lg, cache = decode_step(params, cfg, cache, nxt[:, None],
                                    window=window)
        lg = new_lg[:, 0]
    B = first_logits.shape[0]
    tokens = (torch.stack(toks, dim=1) if toks else
              torch.empty((B, 0), dtype=torch.int32, device=lg.device))
    return tokens, lg, cache
