"""Mixture-of-Experts FFN: a top-k router and capacity-dropping sorted
dispatch, in plain PyTorch.

Counterpart of ``repro.models.moe``, step for step:

  1. the router in float32 (its leaf is float32 whatever the model dtype)
     and a softmax over the experts;
  2. top-k in ``jax.lax.top_k``'s order: values descending, ties to the
     lower expert index.  ``torch.topk`` follows no tie rule, so the port
     takes a stable descending sort sliced to k;
  3. the weights renormalised (sum clamped at 1e-9), a *stable* sort of
     the flat (N k,) assignment vector, the experts' segment starts and
     counts, and each assignment's position in its expert;
  4. the (E, capacity, D) dispatch buffer filled by a gather (slot (e, c)
     takes sorted assignment starts[e] + c when c < counts[e]); the
     assignments past the capacity are dropped;
  5. SwiGLU experts as batched products, and the combine: each
     assignment's expert output weighted by ``where(keep, w, 0)`` and
     summed over the k slots in token order.

Which assignments are dropped depends on the order of the sort, so the tie
rule and the stability decide the output, not only its rounding.  The
switch-style load-balance loss counts the assignments before any drop.

The reference has two dispatch implementations (``impl="gather"`` and
``"scatter"``) with one semantics; the port has one and accepts both names.
The expert products are plain batched matrix products, as the reference
leaves them to XLA: no kernel of the TPU package runs here.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal

__all__ = ["init_moe", "moe_specs", "moe_forward", "moe_capacity",
           "top_k_ordered", "assignment_positions", "Routing"]

_IMPLS = ("gather", "scatter")


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots per expert: ceil(N k / E * factor), at least k."""
    cap = int(np.ceil(num_tokens * top_k / num_experts * capacity_factor))
    return max(cap, top_k)


def init_moe(gen: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, dtype=torch.float32) -> dict:
    """Random MoE parameters drawn from ``gen``, on its device, at the
    reference's shapes and scales; the router is float32 in any model
    dtype."""
    s_in, s_out = 1.0 / np.sqrt(d_model), 1.0 / np.sqrt(d_ff)
    E = num_experts
    return {
        "router": _normal(gen, (d_model, E), s_in, torch.float32),
        "w_gate": _normal(gen, (E, d_model, d_ff), s_in, dtype),
        "w_up": _normal(gen, (E, d_model, d_ff), s_in, dtype),
        "w_down": _normal(gen, (E, d_ff, d_model), s_out, dtype),
    }


def moe_specs(d_model: int, d_ff: int, num_experts: int, dtype,
              lead: tuple = ()) -> dict:
    """``meta``-device tensors matching :func:`init_moe`, each with the
    leading dims ``lead``."""
    E = num_experts

    def spec(shape, dt=dtype):
        return torch.empty(lead + shape, dtype=dt, device="meta")

    return {"router": spec((d_model, E), torch.float32),
            "w_gate": spec((E, d_model, d_ff)),
            "w_up": spec((E, d_model, d_ff)),
            "w_down": spec((E, d_ff, d_model))}


def top_k_ordered(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values in
    descending order, equal values in ascending index order.  Returns
    (values, indices)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing:
    """While entered, records the experts each :func:`moe_forward` call
    chooses: ``ids`` holds one (N, k) tensor a call, in call order.  Given
    ``replay`` (the ``ids`` of an earlier run of the same calls), call i
    routes by ``replay[i]`` instead, at the router's own probabilities, so
    two runs can be compared at one routing; ``ids`` still records the
    router's own choice.  A remat recompute is a call of its own."""

    active = None

    def __init__(self, replay: list | None = None):
        self.ids, self.replay = [], replay

    def __enter__(self):
        Routing.active = self
        return self

    def __exit__(self, *exc):
        Routing.active = None
        return False

    def route(self, probs, vals, ids):
        self.ids.append(ids.detach())
        if self.replay is None:
            return vals, ids
        ids = self.replay[len(self.ids) - 1].to(probs.device)
        return probs.gather(-1, ids), ids


def assignment_positions(flat_e: torch.Tensor, num_experts: int):
    """The stable sort of the flat (N k,) expert assignments.  Returns
    (order, counts, starts, pos): the sorting permutation, the experts'
    assignment counts and segment starts, and each assignment's position
    in its expert, in token order (``pos < capacity`` is kept)."""
    sorted_e, order = torch.sort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = (torch.arange(flat_e.numel(), device=flat_e.device)
                  - starts[sorted_e])
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    return order, counts, starts, pos


def moe_forward(params: dict, x: torch.Tensor, *, top_k: int,
                capacity_factor: float = 1.25, impl: str = "gather",
                cap_shard_axis=None):
    """Apply the MoE FFN.

    Args:
      x: (B, S, D) hidden states.
      impl: ``"gather"`` or ``"scatter"``, the reference's two names for
        one semantics; both run the same code here.
      cap_shard_axis: the reference's layout hint for the dispatch buffer
        under GSPMD; accepted and ignored (the port shards agents, not
        experts).
    Returns:
      (y, aux) with y (B, S, D) in x's dtype and aux the float32
      load-balance loss (a scalar).
    """
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    del cap_shard_axis
    B, S, D = x.shape
    E = params["router"].shape[1]
    N = B * S
    NK = N * top_k
    xf = x.reshape(N, D)
    dev = x.device

    logits = xf.float() @ params["router"].float()                # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_e = top_k_ordered(probs, top_k)                  # (N, k)
    if Routing.active is not None:
        gate_w, gate_e = Routing.active.route(probs, gate_w, gate_e)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    cap = moe_capacity(N, E, top_k, capacity_factor)
    flat_e = gate_e.reshape(-1)                                   # (N k,)
    order, counts, starts, pos = assignment_positions(flat_e, E)
    keep = pos < cap

    # load balance (Switch): E * sum_e mean(probs)_e * counts_e / (N k)
    me = probs.mean(dim=0)
    aux = E * torch.sum(me * counts.float() / NK)

    # dispatch as a gather: slot (e, c) holds sorted assignment
    # starts[e] + c when c < counts[e]
    c = torch.arange(cap, device=dev)
    slot_src = torch.clamp(starts[:, None] + c[None, :], 0, NK - 1)
    slot_valid = c[None, :] < counts[:, None]                     # (E, cap)
    tok_for_slot = order[slot_src] // top_k
    buf = torch.where(slot_valid[..., None], xf[tok_for_slot],
                      torch.zeros((), dtype=x.dtype, device=dev))

    # the experts: SwiGLU as batched products over (E, cap, .)
    h = F.silu(torch.bmm(buf, params["w_gate"]))
    h = h * torch.bmm(buf, params["w_up"])
    out = torch.bmm(h, params["w_down"]).to(x.dtype)              # (E, cap, D)

    # combine: each assignment's output, weighted, summed over its token's
    # k slots in slot order
    back = out[flat_e, torch.clamp(pos, max=cap - 1)]             # (N k, D)
    w = torch.where(keep, gate_w.reshape(-1), 0.0).to(back.dtype)
    y = (back * w[:, None]).reshape(N, top_k, D).sum(dim=1)
    return y.to(x.dtype).reshape(B, S, D), aux
