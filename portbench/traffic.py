"""The benchmark's one generator of inputs, driven by a traffic file's
parameters and the run's seed.

* Participation masks come from the traffic's own ``mask_seed``, so every
  run and both sides of a comparison see the same sequence: row i is
  block i's Bernoulli(q) draw for each agent.
* Token batches and the image stream come from ``--seed`` and the block
  index, drawn on the run's device: tokens uniform over the vocabulary,
  labels the tokens shifted left by one with a final 0 (the port's
  ``data.synthetic.lm_token_batch``), the image features float32 normals
  times 0.02 (its ``data.pipeline._img_embeds``).
* Weights are drawn leaf by leaf, each leaf from its own generator seeded
  from ``--seed`` and the leaf's path, in the leaf's own dtype on the
  device (:func:`draw_weights`); every agent starts from the same draw.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

__all__ = ["derive_seed", "masks", "block_batch", "draw_leaf",
           "draw_weights", "tokens_per_block"]


def derive_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one stream of the run ``seed``, named by
    ``parts``."""
    text = "/".join(str(p) for p in (int(seed),) + parts)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def masks(traffic: dict, count: int) -> np.ndarray:
    """(count, K) float32 activation masks of blocks 0..count-1."""
    rng = np.random.Generator(np.random.PCG64(traffic["mask_seed"]))
    K, q = traffic["agents"], traffic["participation"]
    return (rng.random((count, K)) < q).astype(np.float32)


def tokens_per_block(traffic: dict) -> int:
    """K T B positions through the decoder (image positions included)."""
    return (traffic["agents"] * traffic["local_steps"] * traffic["batch"]
            * (traffic["seq"] + traffic.get("image_positions", 0)))


def block_batch(traffic: dict, vocab: int, seed: int, index: int,
                device, vision_dim: int = 1024) -> dict:
    """Block ``index``'s inputs, leaves (T, K, B, ...): ``tokens`` and
    ``labels`` (T, K, B, S) int32 and, with image positions, ``img_embeds``
    (T, K, B, P, vision_dim) float32."""
    T, K, B, S = (traffic["local_steps"], traffic["agents"],
                  traffic["batch"], traffic["seq"])
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "block", index))
    tokens = torch.randint(0, vocab, (T, K, B, S), generator=gen,
                           device=device, dtype=torch.int32)
    labels = torch.cat([tokens[..., 1:], torch.zeros_like(tokens[..., :1])],
                       dim=-1)
    out = {"tokens": tokens, "labels": labels}
    P = traffic.get("image_positions", 0)
    if P:
        out["img_embeds"] = torch.randn((T, K, B, P, vision_dim),
                                        generator=gen,
                                        device=device).mul_(0.02)
    return out


def draw_leaf(seed: int, path: str, shape: tuple, dtype, init: tuple,
              device, out: torch.Tensor | None = None) -> torch.Tensor:
    """One parameter leaf of the weights ``seed`` names (see the reference
    families' ``layout`` for ``init``), drawn on ``device`` in ``dtype``
    (into ``out`` when given)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "weights", path))
    kind = init[0]
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    if kind == "normal":
        torch.randn(shape, generator=gen, out=out)
        out.mul_(init[1])
    elif kind == "ones":
        out.fill_(1)
    elif kind == "zeros":
        out.zero_()
    elif kind == "a_log":
        # A_h = -(h + 1) for the heads of each layer
        heads = shape[-1]
        out.copy_(torch.log(torch.arange(1, heads + 1, dtype=torch.float32,
                                         device=device)).expand(shape))
    elif kind == "dt_bias":
        # dt log-uniform in [1e-3, 0.1], stored through softplus's inverse
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001))
        out.copy_(dt + torch.log(-torch.expm1(-dt)))
    else:
        raise ValueError(f"unknown init {init!r} for {path}")
    return out


def draw_weights(layout: list, seed: int, device, agents: int | None = None
                 ) -> dict:
    """{path: leaf} of the weights ``seed`` names; with ``agents`` each
    leaf has a leading (agents,) axis, every agent the same draw."""
    out = {}
    for path, shape, dtype, init in layout:
        if agents is None:
            out[path] = draw_leaf(seed, path, shape, dtype, init, device)
            continue
        leaf = torch.empty((agents,) + tuple(shape), dtype=dtype,
                           device=device)
        draw_leaf(seed, path, shape, dtype, init, device, out=leaf[0])
        if agents > 1:
            leaf[1:].copy_(leaf[0].expand((agents - 1,) + tuple(shape)))
        out[path] = leaf
    return out
