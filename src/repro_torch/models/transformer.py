"""Decoder assembly: parameters, the training forward and loss, the
ring-buffer cache, prefill and decode.

Counterpart of ``repro.models.transformer``.  Layers are grouped into
*segments* (runs of one block type) whose per-layer parameters are stacked
on a leading axis, under the reference's segment keys (``"00.attn.032"``),
and segments run in sorted key order; where the reference scans a segment,
the port loops over its layers.  The port runs ``attn``, ``mamba`` (the
Mamba2 mixer, :mod:`repro_torch.models.ssm`) and ``shared_attn`` segments:
zamba2's shared attention block is stored once, at ``params["shared_attn"]``,
each of its segments is an empty dict, and the block is applied at every
slot of the segment.  ``moe`` segments, the image prefix and multi-codebook
embeddings raise ``NotImplementedError`` (ROADMAP.md queue 1 item 17).

``cfg.use_kernels`` selects the kernels of :func:`forward` as the reference
does: attention through the flash-attention kernel
(:func:`repro_torch.kernels.ops.attention_op`), else the streaming
:func:`repro_torch.models.layers.flash_attention_jnp`; the SSD through the
intra-chunk kernel (:func:`repro_torch.kernels.ops.ssd_op`), else the plain
:func:`repro_torch.models.ssm.ssd_chunked`.  Prefill always takes the plain
versions, as the reference's does.

The cache is the reference's whole-batch ring buffer: position p lives in
slot p % C, ``slot_pos`` records the absolute position held by each slot
(-1 = empty), and decode masks by validity and the sliding window.  Unlike
the JAX version, :func:`decode_step` writes the new K/V (and the new SSM
and conv states) into the cache tensors in place (one slot per layer
instead of a copy of the cache) and returns the same :class:`Cache`;
``pos`` is a Python int.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import attention_op
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib

PyTree = Any

__all__ = ["init_params", "param_specs", "forward", "train_loss", "Cache",
           "init_cache", "prefill", "decode_step", "sample_logits",
           "decode_loop"]


def _seg_key(index: int, kind: str, n: int) -> str:
    return f"{index:02d}.{kind}.{n:03d}"


def _seg_items(segments: dict):
    """Yield (kind, n, seg_params) in layer order."""
    for key in sorted(segments):
        _, kind, n = key.split(".")
        yield kind, int(n), segments[key]


def _adims(cfg: ModelConfig) -> L.AttnDims:
    return L.AttnDims(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)


def _ssm_kw(cfg: ModelConfig) -> dict:
    return dict(expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                state=cfg.ssm_state, conv_kernel=cfg.conv_kernel)


def _check_supported(cfg: ModelConfig) -> None:
    kinds = {kind for kind, _ in cfg.segments()}
    if not kinds <= {"attn", "mamba"}:
        raise NotImplementedError(
            f"{cfg.name}: block types {sorted(kinds - {'attn', 'mamba'})} "
            "are not ported yet — the port runs attention, mamba and shared "
            "attention segments; see ROADMAP.md queue 1 item 17")
    if cfg.num_codebooks or cfg.img_tokens:
        raise NotImplementedError(
            f"{cfg.name}: multi-codebook / image-prefix embeddings are not "
            "ported yet; see ROADMAP.md queue 1 item 17")


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def _block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
                dtype) -> dict:
    if kind == "mamba":
        return {"ln1": L.init_rms_norm(cfg.d_model, dtype, gen.device),
                "ssm": ssm_lib.init_ssm(gen, cfg.d_model, dtype=dtype,
                                        **_ssm_kw(cfg))}
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
        if kind == "attn" and cfg.shared_attention:
            segs[_seg_key(si, "shared_attn", n)] = {}
            continue
        segs[_seg_key(si, kind, n)] = _stack(
            [_block_init(key, cfg, kind, dtype) for _ in range(n)])
    p["segments"] = segs
    if cfg.shared_attention:
        p["shared_attn"] = _block_init(key, cfg, "attn", dtype)
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

    def block(kind, *n):
        if kind == "mamba":
            return {"ln1": {"scale": spec(*n, D)},
                    "ssm": ssm_lib.ssm_specs(D, dtype=cfg.param_dtype,
                                             lead=lead + n, **_ssm_kw(cfg))}
        attn = {"wq": spec(*n, D, H * Dh), "wk": spec(*n, D, Kv * Dh),
                "wv": spec(*n, D, Kv * Dh), "wo": spec(*n, H * Dh, D)}
        if cfg.qk_norm:
            attn["q_norm"] = {"scale": spec(*n, Dh)}
            attn["k_norm"] = {"scale": spec(*n, Dh)}
        mlp = ({"w_gate": spec(*n, D, F), "w_up": spec(*n, D, F),
                "w_down": spec(*n, F, D)} if cfg.mlp_act == "silu"
               else {"w_up": spec(*n, D, F), "w_down": spec(*n, F, D)})
        return {"ln1": {"scale": spec(*n, D)}, "attn": attn,
                "ln2": {"scale": spec(*n, D)}, "mlp": mlp}

    p: dict = {"embed": spec(V, D)}
    segs = {}
    for si, (kind, n) in enumerate(cfg.segments()):
        if kind == "attn" and cfg.shared_attention:
            segs[_seg_key(si, "shared_attn", n)] = {}
        else:
            segs[_seg_key(si, kind, n)] = block(kind, n)
    p["segments"] = segs
    if cfg.shared_attention:
        p["shared_attn"] = block("attn")
    p["final_norm"] = {"scale": spec(D)}
    if not cfg.tie_embeddings:
        p["lm_head"] = spec(D, V)
    return p


def _layers(seg_params: dict, n: int) -> list:
    """The ``n`` layers of a stacked segment (views, no copy), each leaf
    unbound once: the backward of one ``unbind`` stacks the n layers'
    gradients in one pass, where n separate selects would each fill and
    add a gradient of the whole stacked leaf."""
    per_key = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
               for k, v in seg_params.items()}
    return [{k: per_key[k][j] for k in seg_params} for j in range(n)]


def _embed_inputs(params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]               # (B, S, D)


def _lm_logits(params: PyTree, cfg: ModelConfig,
               x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


# ---------------------------------------------------------------------------
# block application (no cache: the training / loss path)
# ---------------------------------------------------------------------------

def _apply_block(cfg: ModelConfig, kind: str, bp: dict, x: torch.Tensor,
                 positions: torch.Tensor, window: int | None, q_chunk: int,
                 kv_chunk: int) -> torch.Tensor:
    """One block, residual: a ``mamba`` block is the Mamba2 mixer; an
    ``attn`` block is attention then the dense MLP."""
    h = L.rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
    if kind == "mamba":
        return x + ssm_lib.ssm_forward(bp["ssm"], h, chunk=cfg.ssm_chunk,
                                       norm_eps=cfg.norm_eps,
                                       use_kernel=cfg.use_kernels,
                                       **_ssm_kw(cfg))
    q, k, v = L.qkv_project(bp["attn"], h, _adims(cfg), positions=positions,
                            rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta,
                            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps)
    if cfg.use_kernels:
        o = attention_op(q, k, v, causal=True, window=window)
    else:
        o = L.flash_attention_jnp(q, k, v, causal=True, window=window,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk)
    B, S = x.shape[:2]
    x = x + o.reshape(B, S, -1) @ bp["attn"]["wo"]
    h = L.rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps)
    return x + L.mlp_forward(bp["mlp"], h, cfg.mlp_act)


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, *,
            img_embeds: torch.Tensor | None = None,
            window: int | None = None, remat: bool = True,
            q_chunk: int = 512, kv_chunk: int = 512):
    """Full-sequence forward.  Returns (logits, aux_loss, n_prefix), as the
    reference does; ``aux_loss`` is 0 and ``n_prefix`` 0 for the ported
    (MoE-free, text-only) configs.

    tokens: (B, S) integer.  ``remat`` recomputes each block's activations
    in the backward pass (``torch.utils.checkpoint``, non-reentrant), as
    the reference's ``jax.checkpoint`` of the scan body does.
    """
    _check_supported(cfg)
    if img_embeds is not None:
        raise NotImplementedError(
            "image-prefix embeddings are not ported yet; see ROADMAP.md "
            "queue 1 item 17")
    window = window if window is not None else cfg.attention_window
    x = _embed_inputs(params, tokens)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    for kind, n, seg_params in _seg_items(params["segments"]):
        for bp in _layers(seg_params, n):
            if kind == "shared_attn":
                kind_j, bp = "attn", params["shared_attn"]
            else:
                kind_j = kind
            args = (cfg, kind_j, bp, x, positions, window, q_chunk, kv_chunk)
            x = (checkpoint(_apply_block, *args, use_reentrant=False)
                 if remat else _apply_block(*args))
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _lm_logits(params, cfg, x), aux, 0


def train_loss(params: PyTree, cfg: ModelConfig, batch: dict,
               rng=None, *, remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy in float32.  batch: ``tokens``/``labels``
    (B, S).  ``rng`` is unused, as in the reference."""
    del rng
    logits, _, _ = forward(params, cfg, batch["tokens"],
                           img_embeds=batch.get("img_embeds"), remat=remat)
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = batch["labels"].long()
    return -logp.gather(-1, labels[..., None])[..., 0].mean()


# ---------------------------------------------------------------------------
# serving: cache + prefill + decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cache:
    """Decode cache.  ``segments`` mirrors ``params['segments']`` order; an
    attention or shared-attention entry holds ``k``/``v`` of shape
    (n, B, C, Kv, Dh), a mamba entry ``ssm`` (n, B, H, P, N) float32 and
    ``conv`` (n, B, k - 1, conv_dim) in the parameter dtype.  ``pos`` is
    the next write position (whole batch), ``slot_pos`` (C,) int32 the
    absolute position stored in each ring slot."""
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

    def zeros(shape, dtype=cfg.param_dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    segs = []
    for kind, n in cfg.segments():
        if kind == "mamba":
            s_shape, c_shape = ssm_lib.ssm_state_shapes(batch, cfg.d_model,
                                                        **_ssm_kw(cfg))
            segs.append({"ssm": zeros((n,) + s_shape, torch.float32),
                         "conv": zeros((n,) + c_shape)})
        else:
            segs.append({"k": zeros((n, batch, C, Kv, Dh)),
                         "v": zeros((n, batch, C, Kv, Dh))})
    return Cache(segments=tuple(segs), pos=0,
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
    for (kind, n, seg_params), seg_cache in zip(
            _seg_items(params["segments"]), cache.segments):
        for j, bp in enumerate(_layers(seg_params, n)):
            if kind == "mamba":
                h = L.rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
                o, st, cv = ssm_lib.ssm_decode_step(
                    bp["ssm"], h, seg_cache["ssm"][j], seg_cache["conv"][j],
                    norm_eps=cfg.norm_eps, **_ssm_kw(cfg))
                seg_cache["ssm"][j] = st
                seg_cache["conv"][j] = cv
                x = x + o
                continue
            if kind == "shared_attn":
                bp = params["shared_attn"]
            x = _attn_block_decode(cfg, bp, x, seg_cache["k"][j],
                                   seg_cache["v"][j], positions, slot, valid)
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    cache.pos = pos + 1
    return _lm_logits(params, cfg, x), cache


def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, *,
            window: int | None = None, max_len: int | None = None,
            q_chunk: int = 512, kv_chunk: int = 512):
    """Process a prompt, returning (logits, cache) for subsequent decode.

    A full forward that also captures per-layer K/V into a ring-buffer
    cache sized for ``max_len`` total positions (default: prompt length),
    and each mamba layer's final SSM and conv states.
    """
    _check_supported(cfg)
    window = window if window is not None else cfg.attention_window
    x = _embed_inputs(params, tokens)
    B, S = x.shape[:2]
    dev = x.device
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    C = _cache_len(cfg, max(max_len or S, S), window)

    new_segs = []
    for kind, n, seg_params in _seg_items(params["segments"]):
        if kind == "mamba":
            sts, cvs = [], []
            for bp in _layers(seg_params, n):
                h = L.rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
                o, (st, cv) = ssm_lib.ssm_forward(
                    bp["ssm"], h, chunk=cfg.ssm_chunk, norm_eps=cfg.norm_eps,
                    return_state=True, **_ssm_kw(cfg))
                x = x + o
                sts.append(st)
                cvs.append(cv.to(cfg.param_dtype))
            new_segs.append({"ssm": torch.stack(sts),
                             "conv": torch.stack(cvs)})
            continue
        kcs = torch.empty((n, B, C, cfg.num_kv_heads, cfg.head_dim),
                          dtype=x.dtype, device=dev)
        vcs = torch.empty_like(kcs)
        for j, bp in enumerate(_layers(seg_params, n)):
            if kind == "shared_attn":
                bp = params["shared_attn"]
            x, (kcs[j], vcs[j]) = _attn_block_prefill(
                cfg, bp, x, positions, window, q_chunk, kv_chunk, C)
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
