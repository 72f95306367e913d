"""Decoder assembly: parameters, the training forward and loss, the
ring-buffer cache, prefill and decode.

Counterpart of ``repro.models.transformer``.  Layers are grouped into
*segments* (runs of one block type) whose per-layer parameters are stacked
on a leading axis, under the reference's segment keys (``"00.attn.032"``),
and segments run in sorted key order; where the reference scans a segment,
the port loops over its layers.  The port runs ``attn``, ``moe``
(attention then the MoE FFN, :mod:`repro_torch.models.moe`), ``mamba`` (the
Mamba2 mixer, :mod:`repro_torch.models.ssm`) and ``shared_attn`` segments:
zamba2's shared attention block is stored once, at ``params["shared_attn"]``,
each of its segments is an empty dict, and the block is applied at every
slot of the segment.  Two modalities ride on the decoder as in the
reference: musicgen's ``num_codebooks`` parallel token streams (tokens
``(B, S, nq)``, an ``(nq, V, D)`` embedding whose per-codebook rows are
summed, an ``(nq, D, V)`` head giving ``(B, S, nq, V)`` logits) and
llava's image prefix (``img_embeds`` ``(B, img_tokens, VISION_DIM)``
float32 through the ``projector`` ``{"w": (VISION_DIM, D), "b": (D,)}``,
concatenated in front of the token embeddings; the loss drops the
prefix's logits).  The projector runs in float32 with its weights upcast,
then casts to the parameter dtype, as JAX's promotion of float32
embeddings against bf16 weights does.

A segment's stacked leaves are allocated once, in their own dtype, and
each layer's draw is copied into its slot (a one-layer segment is a view
of its draw): init holds a segment once plus one layer, not twice.

``cfg.use_kernels`` selects the kernels of :func:`forward` as the reference
does: attention through the flash-attention kernel
(:func:`repro_torch.kernels.ops.attention_op`), else the streaming
:func:`repro_torch.models.layers.flash_attention_jnp`; the SSD through the
intra-chunk kernel (:func:`repro_torch.kernels.ops.ssd_op`), else the plain
:func:`repro_torch.models.ssm.ssd_chunked`.  Prefill always takes the plain
versions, as the reference's does.

The cache is the reference's ring buffer: position p lives in slot p % C,
``slot_pos`` records the absolute position held by each slot (-1 = empty),
and decode masks by validity and the sliding window.  It comes in the
reference's two layouts: whole-batch (``pos`` a Python int, ``slot_pos``
(C,)), where every row sits at one position, and per-slot
(``init_cache(..., per_slot=True)``: ``pos`` (B,) and ``slot_pos`` (B, C)
int32 tensors), where each row is a request of its own at its own
position (the continuous-batching :mod:`repro_torch.launch.serving`).
Unlike the JAX version, :func:`decode_step` writes the new K/V (and the
new SSM and conv states) into the cache tensors in place (one slot per
layer and row instead of a copy of the cache) and returns the same
:class:`Cache`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import attention_op
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["init_params", "param_specs", "forward", "train_loss", "Cache",
           "init_cache", "cache_specs", "prefill", "decode_step",
           "sample_logits", "decode_loop", "VISION_DIM"]

#: the stubbed vision encoder's output width (CLIP-large), the reference's
VISION_DIM = 1024


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


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def _block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
                dtype) -> dict:
    if kind == "mamba":
        return {"ln1": L.init_rms_norm(cfg.d_model, dtype, gen.device),
                "ssm": ssm_lib.init_ssm(gen, cfg.d_model, dtype=dtype,
                                        **_ssm_kw(cfg))}
    p = {"ln1": L.init_rms_norm(cfg.d_model, dtype, gen.device),
         "attn": L.init_attention(gen, cfg.d_model, _adims(cfg),
                                  cfg.qk_norm, dtype),
         "ln2": L.init_rms_norm(cfg.d_model, dtype, gen.device)}
    if kind == "moe":
        p["moe"] = moe_lib.init_moe(gen, cfg.d_model, cfg.moe_d_ff,
                                    cfg.num_experts, dtype)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype)
    return p


def _init_segment(gen: torch.Generator, cfg: ModelConfig, kind: str,
                  dtype, n: int) -> dict:
    """The n layers of a segment drawn one after another, stacked on a
    leading axis.  Each stacked leaf is allocated once in its own dtype and
    layer j's draw is copied into slot j, then dropped; one layer alone is
    a view of its draw.  (A stack of the n draws would hold the segment
    twice: past 80 GB for one full-width kimi-k2 layer.)"""
    layer = _block_init(gen, cfg, kind, dtype)
    if n == 1:
        return tree_map(lambda x: x.unsqueeze(0), layer)
    out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), layer)
    for j in range(n):
        if j:
            layer = _block_init(gen, cfg, kind, dtype)
        for o, x in zip(tree_leaves(out), tree_leaves(layer)):
            o[j].copy_(x)
        layer = None                  # freed before the next draw
    return out


def init_params(key: torch.Generator, cfg: ModelConfig) -> PyTree:
    """Random parameters drawn from ``key``, on the generator's device.

    The shapes and distributions are the reference's; the values are not
    (torch cannot replay JAX's random streams — carry reference weights
    across with :func:`repro_torch.models.convert.params_from_jax`).
    """
    dtype = cfg.param_dtype
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    p: dict = {"embed": L._normal(key, cb + (cfg.vocab_size, cfg.d_model),
                                  0.02, dtype)}
    if cfg.img_tokens:
        p["projector"] = {
            "w": L._normal(key, (VISION_DIM, cfg.d_model),
                           1.0 / np.sqrt(VISION_DIM), dtype),
            "b": torch.zeros((cfg.d_model,), dtype=dtype,
                             device=key.device)}
    segs = {}
    for si, (kind, n) in enumerate(cfg.segments()):
        if kind == "attn" and cfg.shared_attention:
            segs[_seg_key(si, "shared_attn", n)] = {}
            continue
        segs[_seg_key(si, kind, n)] = _init_segment(key, cfg, kind, dtype,
                                                    n)
    p["segments"] = segs
    if cfg.shared_attention:
        p["shared_attn"] = _block_init(key, cfg, "attn", dtype)
    p["final_norm"] = L.init_rms_norm(cfg.d_model, dtype, key.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = L._normal(key, cb + (cfg.d_model, cfg.vocab_size),
                                 1.0 / np.sqrt(cfg.d_model), dtype)
    return p


def param_specs(cfg: ModelConfig, *, num_agents: int | None = None) -> PyTree:
    """Tree of ``meta``-device tensors matching :func:`init_params` — shapes
    and dtypes with zero allocation (a template for
    :func:`repro_torch.checkpoint.load_checkpoint`).  ``num_agents`` adds a
    leading agent axis."""
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
        p = {"ln1": {"scale": spec(*n, D)}, "attn": attn,
             "ln2": {"scale": spec(*n, D)}}
        if kind == "moe":
            p["moe"] = moe_lib.moe_specs(D, cfg.moe_d_ff, cfg.num_experts,
                                         cfg.param_dtype, lead=lead + n)
        elif cfg.mlp_act == "silu":
            p["mlp"] = {"w_gate": spec(*n, D, F), "w_up": spec(*n, D, F),
                        "w_down": spec(*n, F, D)}
        else:
            p["mlp"] = {"w_up": spec(*n, D, F), "w_down": spec(*n, F, D)}
        return p

    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    p: dict = {"embed": spec(*cb, V, D)}
    if cfg.img_tokens:
        p["projector"] = {"w": spec(VISION_DIM, D), "b": spec(D)}
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
        p["lm_head"] = spec(*cb, D, V)
    return p


def _layers(seg_params: dict, n: int) -> list:
    """The ``n`` layers of a stacked segment (views, no copy), each leaf
    unbound once: the backward of one ``unbind`` stacks the n layers'
    gradients in one pass, where n separate selects would each fill and
    add a gradient of the whole stacked leaf."""
    per_key = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
               for k, v in seg_params.items()}
    return [{k: per_key[k][j] for k in seg_params} for j in range(n)]


def _embed_inputs(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                  img_embeds: torch.Tensor | None):
    """Token (+ codebook / + image-prefix) embedding: returns (x (B, S', D),
    n_prefix).  Codebook tokens (B, S, nq) take the sum of their
    per-codebook rows; an image prefix (B, P, VISION_DIM) is projected in
    float32 (the weights upcast, as JAX promotes float32 embeddings
    against bf16 weights), cast to the parameter dtype and put in front."""
    emb = params["embed"]
    if cfg.num_codebooks:
        q = torch.arange(cfg.num_codebooks, device=tokens.device)
        x = emb[q, tokens.long()].sum(dim=-2)            # (B, S, D)
    else:
        x = emb[tokens.long()]                           # (B, S, D)
    if not (cfg.img_tokens and img_embeds is not None):
        return x, 0
    pj = params["projector"]
    proj = img_embeds.float() @ pj["w"].float() + pj["b"].float()
    return torch.cat([proj.to(x.dtype), x], dim=1), img_embeds.shape[1]


def _lm_logits(params: PyTree, cfg: ModelConfig,
               x: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits, or (B, S, nq, V) with codebooks."""
    if cfg.tie_embeddings:
        W = params["embed"]
        if cfg.num_codebooks:
            return torch.einsum("bsd,qvd->bsqv", x, W)
        return x @ W.T
    W = params["lm_head"]
    if cfg.num_codebooks:
        return torch.einsum("bsd,qdv->bsqv", x, W)
    return x @ W


# ---------------------------------------------------------------------------
# block application (no cache: the training / loss path)
# ---------------------------------------------------------------------------

def _ffn(cfg: ModelConfig, kind: str, bp: dict, x: torch.Tensor):
    """The block's FFN on its residual stream: (x + ffn(ln2(x)), aux), the
    MoE FFN for a ``moe`` block (capacity from x's B S tokens), else the
    dense MLP with aux 0."""
    h = L.rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps)
    if kind == "moe":
        y, aux = moe_lib.moe_forward(bp["moe"], h,
                                     top_k=cfg.num_experts_per_token,
                                     capacity_factor=cfg.capacity_factor,
                                     cap_shard_axis=cfg.moe_cap_shard)
        return x + y, aux
    return x + L.mlp_forward(bp["mlp"], h, cfg.mlp_act), None


def _apply_block(cfg: ModelConfig, kind: str, bp: dict, x: torch.Tensor,
                 positions: torch.Tensor, window: int | None, q_chunk: int,
                 kv_chunk: int):
    """One block, residual: a ``mamba`` block is the Mamba2 mixer; an
    ``attn`` block is attention then the dense MLP, a ``moe`` block
    attention then the MoE FFN.  Returns (x, aux), aux the MoE's
    load-balance loss or None."""
    if kind == "mamba":
        with spans.span("model.ssm"):
            h = L.rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
            return x + ssm_lib.ssm_forward(
                bp["ssm"], h, chunk=cfg.ssm_chunk, norm_eps=cfg.norm_eps,
                use_kernel=cfg.use_kernels, **_ssm_kw(cfg)), None
    with spans.span("model.attention"):
        h = L.rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
        q, k, v = L.qkv_project(bp["attn"], h, _adims(cfg),
                                positions=positions,
                                rotary_pct=cfg.rotary_pct,
                                theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                                norm_eps=cfg.norm_eps)
        if cfg.use_kernels:
            o = attention_op(q, k, v, causal=True, window=window)
        else:
            o = L.flash_attention_jnp(q, k, v, causal=True, window=window,
                                      q_chunk=q_chunk, kv_chunk=kv_chunk)
        B, S = x.shape[:2]
        x = x + o.reshape(B, S, -1) @ bp["attn"]["wo"]
    with spans.span("model.moe" if kind == "moe" else "model.mlp"):
        return _ffn(cfg, kind, bp, x)


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, *,
            img_embeds: torch.Tensor | None = None,
            window: int | None = None, remat: bool = True,
            q_chunk: int = 512, kv_chunk: int = 512):
    """Full-sequence forward.  Returns (logits, aux_loss, n_prefix), as the
    reference does: ``aux_loss`` the float32 sum of the MoE layers'
    load-balance losses (0 without experts), ``n_prefix`` the image
    prefix's length (0 without one; its positions lead the logits).

    tokens: (B, S) integer, or (B, S, nq) for multi-codebook audio;
    ``img_embeds`` (B, P, VISION_DIM) for an image-prefix config.
    ``remat`` recomputes each block's activations in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``jax.checkpoint`` of the scan body does.
    """
    x, aux, n_prefix = _hidden(params, cfg, tokens, img_embeds=img_embeds,
                               window=window, remat=remat, q_chunk=q_chunk,
                               kv_chunk=kv_chunk)
    return _head(params, cfg, x), aux, n_prefix


def _hidden(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, *,
            img_embeds: torch.Tensor | None = None,
            window: int | None = None, remat: bool = True,
            q_chunk: int = 512, kv_chunk: int = 512):
    """:func:`forward` up to the final norm: (x, aux_loss, n_prefix).
    While a profiler runs, each layer's backward is marked as a span."""
    window = window if window is not None else cfg.attention_window
    with spans.span("model.embed"):
        x, n_prefix = _embed_inputs(params, cfg, tokens, img_embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, n, seg_params in _seg_items(params["segments"]):
        for bp in _layers(seg_params, n):
            if kind == "shared_attn":
                kind_j, bp = "attn", params["shared_attn"]
            else:
                kind_j = kind
            x, slot = spans.mark_layer_input(x)
            args = (cfg, kind_j, bp, x, positions, window, q_chunk, kv_chunk)
            x, a = (checkpoint(_apply_block, *args, use_reentrant=False)
                    if remat else _apply_block(*args))
            x = spans.mark_layer_output(x, slot)
            if a is not None:
                aux = aux + a
    return x, aux, n_prefix


def _head(params: PyTree, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the head: the logits."""
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return _lm_logits(params, cfg, x)


def train_loss(params: PyTree, cfg: ModelConfig, batch: dict,
               rng=None, *, remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy in float32, plus ``aux_loss_coef`` times
    the MoE load-balance loss when the config has experts.  batch:
    ``tokens``/``labels`` (B, S) or (B, S, nq), and ``img_embeds`` for an
    image-prefix config, whose prefix logits are dropped.  ``rng`` is
    unused, as in the reference."""
    del rng
    x, aux, n_prefix = _hidden(params, cfg, batch["tokens"],
                               img_embeds=batch.get("img_embeds"),
                               remat=remat)
    with spans.span("model.head_loss"):
        logits = _head(params, cfg, x)
        if n_prefix:
            logits = logits[:, n_prefix:]
        logp = torch.log_softmax(logits.float(), dim=-1)
        labels = batch["labels"].long()
        loss = -logp.gather(-1, labels[..., None])[..., 0].mean()
        if cfg.num_experts:
            loss = loss + cfg.aux_loss_coef * aux
        return loss


# ---------------------------------------------------------------------------
# serving: cache + prefill + decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cache:
    """Decode cache.  ``segments`` mirrors ``params['segments']`` order; an
    attention or shared-attention entry holds ``k``/``v`` of shape
    (n, B, C, Kv, Dh), a mamba entry ``ssm`` (n, B, H, P, N) float32 and
    ``conv`` (n, B, k - 1, conv_dim) in the parameter dtype: the batch is
    axis 1 of every leaf.  Whole-batch layout: ``pos`` the next write
    position (an int), ``slot_pos`` (C,) int32 the absolute position
    stored in each ring slot.  Per-slot layout: ``pos`` (B,) and
    ``slot_pos`` (B, C) int32 tensors, one request a row."""
    segments: tuple
    pos: int | torch.Tensor
    slot_pos: torch.Tensor

    @property
    def per_slot(self) -> bool:
        return self.slot_pos.ndim == 2


def _cache_len(cfg: ModelConfig, max_seq: int, window: int | None) -> int:
    w = window if window is not None else cfg.attention_window
    return min(max_seq, w) if w else max_seq


def _cache(cfg: ModelConfig, batch: int, C: int, per_slot: bool,
           make) -> Cache:
    """The cache's leaves, each from ``make(shape, dtype, fill)``: the one
    place the layout is written down (:func:`init_cache` allocates it,
    :func:`cache_specs` describes it on ``meta``)."""
    Kv, Dh = cfg.num_kv_heads, cfg.head_dim
    segs = []
    for kind, n in cfg.segments():
        if kind == "mamba":
            s_shape, c_shape = ssm_lib.ssm_state_shapes(batch, cfg.d_model,
                                                        **_ssm_kw(cfg))
            segs.append({"ssm": make((n,) + s_shape, torch.float32, 0),
                         "conv": make((n,) + c_shape, cfg.param_dtype, 0)})
        else:
            segs.append({"k": make((n, batch, C, Kv, Dh), cfg.param_dtype, 0),
                         "v": make((n, batch, C, Kv, Dh), cfg.param_dtype,
                                   0)})
    if per_slot:
        return Cache(segments=tuple(segs),
                     pos=make((batch,), torch.int32, 0),
                     slot_pos=make((batch, C), torch.int32, -1))
    return Cache(segments=tuple(segs), pos=0,
                 slot_pos=make((C,), torch.int32, -1))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               window: int | None = None, per_slot: bool = False,
               device=None) -> Cache:
    """An empty cache for ``batch`` rows and ``max_seq`` positions, in the
    whole-batch layout or (``per_slot=True``) the per-slot one."""
    dev = resolve_device(device)
    return _cache(cfg, batch, _cache_len(cfg, max_seq, window), per_slot,
                  lambda shape, dtype, fill: torch.full(
                      shape, fill, dtype=dtype, device=dev))


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int, *,
                window: int | None = None, per_slot: bool = False) -> Cache:
    """:func:`init_cache`'s cache as ``meta`` tensors of its shapes and
    dtypes (zero allocation); the whole-batch ``pos`` is the int 0, as
    there."""
    return _cache(cfg, batch, _cache_len(cfg, max_seq, window), per_slot,
                  lambda shape, dtype, fill: torch.empty(
                      shape, dtype=dtype, device="meta"))


def _attn_block_decode(cfg: ModelConfig, kind: str, bp: dict,
                       x: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                       positions: torch.Tensor, where: tuple,
                       valid: torch.Tensor) -> torch.Tensor:
    """One attention (or ``moe``) block for a single new token; writes its
    K/V into ``kc[where]``/``vc[where]`` in place (``where`` is ``(:,
    slot)`` for the whole batch, ``(rows, slots)`` per slot) and attends
    over ``valid``.  A ``moe`` block's capacity comes from the B tokens of
    the step, as in the reference."""
    B = x.shape[0]
    h = L.rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
    q, k, v = L.qkv_project(bp["attn"], h, _adims(cfg), positions=positions,
                            rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta,
                            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps)
    kc[where] = k[:, 0]
    vc[where] = v[:, 0]
    o = L.decode_attention_jnp(q, kc, vc, valid)
    x = x + o.reshape(B, 1, -1) @ bp["attn"]["wo"]
    return _ffn(cfg, kind, bp, x)[0]


def _decode_geometry(cache: Cache, B: int, window: int | None, device):
    """Write the step's positions into ``slot_pos`` (in place) and return
    (RoPE positions (B, 1), the K/V write index, validity (C,) or (B, C)).
    Every layer shares the ring geometry, so this runs once a step."""
    pos, sp = cache.pos, cache.slot_pos
    C = sp.shape[-1]
    if cache.per_slot:
        rows = torch.arange(B, device=sp.device)
        slots = torch.remainder(pos, C).long()
        sp[rows, slots] = pos
        valid = (sp >= 0) & (sp <= pos[:, None])
        if window:
            valid = valid & (sp > (pos - window)[:, None])
        return pos[:, None], (rows, slots), valid
    slot = pos % C
    sp[slot] = pos
    valid = (sp >= 0) & (sp <= pos)
    if window:
        valid = valid & (sp > pos - window)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=device)
    return positions, (slice(None), slot), valid


def decode_step(params: PyTree, cfg: ModelConfig, cache: Cache,
                tokens: torch.Tensor, *, window: int | None = None):
    """One decode step: tokens (B, 1), or (B, 1, nq) with codebooks ->
    (logits (B, 1, V) or (B, 1, nq, V), cache).

    The cache is updated in place and returned, in either layout: the
    whole batch at one position, or each row at its own (per slot).
    """
    window = window if window is not None else cfg.attention_window
    x, _ = _embed_inputs(params, cfg, tokens, None)
    positions, where, valid = _decode_geometry(cache, x.shape[0], window,
                                               x.device)
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
            x = _attn_block_decode(cfg, kind, bp, x, seg_cache["k"][j],
                                   seg_cache["v"][j], positions, where, valid)
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    cache.pos = cache.pos + 1
    return _lm_logits(params, cfg, x), cache


def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, *,
            img_embeds: torch.Tensor | None = None,
            window: int | None = None, max_len: int | None = None,
            q_chunk: int = 512, kv_chunk: int = 512):
    """Process a prompt, returning (logits, cache) for subsequent decode.

    A full forward that also captures per-layer K/V into a whole-batch
    ring-buffer cache and each mamba layer's final SSM and conv states.
    The cache is sized for ``max_len`` total positions (default: the
    prompt's length), counted over the whole context: an image prefix's
    positions come first, so pass prefix + prompt + decode budget, or the
    decoded tokens overwrite the oldest prefix positions.
    """
    window = window if window is not None else cfg.attention_window
    x, _ = _embed_inputs(params, cfg, tokens, img_embeds)
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
                cfg, kind, bp, x, positions, window, q_chunk, kv_chunk, C)
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


def _attn_block_prefill(cfg: ModelConfig, kind: str, bp: dict,
                        x: torch.Tensor, positions: torch.Tensor,
                        window: int | None, q_chunk: int, kv_chunk: int,
                        C: int):
    """One attention (or ``moe``: capacity from the B S prompt tokens)
    block over the prompt; returns (x, its ring-buffered (k, v))."""
    B, S = x.shape[:2]
    h = L.rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
    q, k, v = L.qkv_project(bp["attn"], h, _adims(cfg), positions=positions,
                            rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta,
                            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps)
    o = L.flash_attention_jnp(q, k, v, causal=True, window=window,
                              q_chunk=q_chunk, kv_chunk=kv_chunk)
    x = x + o.reshape(B, S, -1) @ bp["attn"]["wo"]
    x = _ffn(cfg, kind, bp, x)[0]
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

    logits: (B, V) or (B, nq, V) -> (B,) / (B, nq) int32.
    """
    lg = logits.float()
    if temperature <= 0:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    probs = torch.softmax(lg / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=key)[:, 0].reshape(
        probs.shape[:-1]).to(torch.int32)


def decode_loop(params: PyTree, cfg: ModelConfig, cache: Cache,
                first_logits: torch.Tensor, key: torch.Generator | None,
                n: int, *, temperature: float = 0.0,
                window: int | None = None):
    """n-token generation with sampling inside the loop: tokens stay on the
    device, with no host sync per token.

    Args:
      first_logits: the last-position logits from :func:`prefill`, (B, V)
        or (B, nq, V) with codebooks.
      key: generator for sampled decoding; unused at ``temperature <= 0``.
      n: number of tokens to generate.

    Returns ``(tokens, last_logits, cache)`` with ``tokens`` int32 (B, n)
    or (B, n, nq) and ``last_logits`` the logits the (n+1)-th token would
    be sampled from (carry them into the next call to continue the
    generation, as the serve loop's chunks do).
    """
    lg = first_logits
    toks = []
    for _ in range(n):
        nxt = sample_logits(lg, key, temperature)        # (B,) or (B, nq)
        toks.append(nxt)
        new_lg, cache = decode_step(params, cfg, cache, nxt[:, None],
                                    window=window)
        lg = new_lg[:, 0]
    shape = (first_logits.shape[0], 0) + tuple(first_logits.shape[1:-1])
    tokens = (torch.stack(toks, dim=1) if toks else
              torch.empty(shape, dtype=torch.int32, device=lg.device))
    return tokens, lg, cache
